"""The median time of ``InferenceSession.predict`` per request in an
open-loop window below the knee (the session's own service time, without
the queue's wait), by the host's clock around each call: the most of a
scan's latency there."""

import statistics

LAYER = "session"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "serve_p50_ms"


def read(ctx):
    if ctx.kind != "serve" or not ctx.predict_s:
        return None
    return 1e3 * statistics.median(ctx.predict_s)
