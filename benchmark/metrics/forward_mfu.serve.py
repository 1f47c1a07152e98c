"""The model forward's share of the card's peak while serving: one
forward's analytic operations per real slice answered in the window (the
tail chunk's padding counts as no work), over the summed time requests spent
inside ``predict`` and the peak of the configuration's operand precision,
so that it moves when service gets faster and not with the offered rate."""

from benchmark.core import counts

LAYER = "model forward"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "serve_samples_per_s"


def read(ctx):
    if ctx.kind != "serve" or not ctx.predict_s or not ctx.peaks:
        return None
    flops = counts.forward_flops(ctx.model) * sum(ctx.predict_slices)
    return 100.0 * flops / (sum(ctx.predict_s) * ctx.peaks[0])
