"""The share of the computed slices that are real: 100 x the session's
``session.slices`` over ``session.slices_computed`` (the request padded to
whole chunks) over the run, from the program's counters (``core/spans.py``).
It moves only where the padding changes."""

from benchmark.core.spans import counter_share

LAYER = "session"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "serve_samples_per_s"


def read(ctx):
    return counter_share(ctx, "session.slices", "session.slices_computed")
