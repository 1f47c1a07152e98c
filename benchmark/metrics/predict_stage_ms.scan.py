"""predict_stage_ms of the open loop: the median over the traced requests of
``session.stage_in`` plus ``session.stage_out`` (``core/spans.py``)."""

from benchmark.core.spans import STAGE, median_unit_ms

LAYER = "session"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "serve_p50_ms"


def read(ctx):
    return median_unit_ms(ctx, STAGE)
