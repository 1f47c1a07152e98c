"""The session's host staging per profiled request in the closed loop: the
median over the traced requests of ``session.stage_in`` (the request into
the pinned buffer, the tail padded) plus ``session.stage_out`` (the answers
copied out of the pinned buffers), the program's own ranges
(``core/spans.py``)."""

from benchmark.core.spans import STAGE, median_unit_ms

LAYER = "session"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_samples_per_s"


def read(ctx):
    return median_unit_ms(ctx, STAGE)
