"""The readers of the MedNeXt training cell's per-layer metrics: the whole
step's share of the peak, the forward's depthwise moment convs' share of
their roofline (``core/counts_mednext3d.py``) and the device time of the
blocks recomputed in the backward.

The forward's ``mednext.dwconv`` spans are read as ``core/readers_swin3d.py``
reads the Swin spans: placed on the device from the profiled step's
forward by their ``device_start_ms``. A block recomputed in the backward
runs in autograd's thread, where its ``mednext.block`` span has no parent:
it is told from the forward's by its host interval, which lies inside the
step's ``train.backward``, and read by its own device time. A program
without such spans leaves nothing to read, and each reader then returns
None.
"""

from benchmark.core import counts_mednext3d
from benchmark.core.readers_swin3d import span_device_ms
from benchmark.core.spans import PHASES, _tracing, profiled_roots


def step_mfu(ctx):
    """The whole training step's share of the card's peak: three forwards'
    analytic operations per trained volume
    (``counts_mednext3d.train_step_flops``), times the volumes trained in the
    window, over the window's time and the peak of the configuration's
    operand precision."""
    if ctx.kind != "train" or not ctx.peaks:
        return None
    flops = counts_mednext3d.train_step_flops(ctx.model, ctx.samples)
    return 100.0 * flops / (ctx.window_s * ctx.peaks[0])


def dwconv_roofline(ctx):
    """The forward depthwise moment convs' share of their roofline: their
    least time (per conv the larger of its operations over the peak and its
    bytes over the bandwidth; ``counts_mednext3d.dwconv_bound_s``) over the
    device time inside the profiled steps' forward ``mednext.dwconv`` spans,
    whatever kernels compute them."""
    if not ctx.peaks:
        return None
    per_step = span_device_ms(ctx, "mednext.dwconv")
    if not per_step:
        return None
    bound = counts_mednext3d.dwconv_bound_s(ctx.model, *ctx.peaks) * ctx.stretch_samples
    return 100.0 * bound / (1e-3 * per_step * ctx.stretch.units)


def _recomputed_ms(recs, roots, name):
    """Per root, the device ms of the ``name`` records whose host interval
    lies inside its ``train.backward``'s."""
    backward = {r["root"]: r for r in recs if r["name"] == PHASES[1] and r["root"] in roots}
    out = {}
    for root in roots:
        b = backward.get(root)
        if b is None:
            return None
        inside = [r["device_ms"] for r in recs if r["name"] == name
                  and b["start_ns"] <= r["start_ns"] and r["end_ns"] <= b["end_ns"]]
        if not inside or None in inside:
            return None
        out[root] = sum(inside)
    return out


def recompute_device_ms(ctx):
    """The device time in ms per profiled step of the ``mednext.block``
    spans that lie in ``train.backward``: the blocks recomputed there."""
    tracing = _tracing()
    st = ctx.stretch
    if ctx.kind != "train" or tracing is None or st is None or not st.units:
        return None
    recs = tracing.records()
    roots = profiled_roots(recs, st)
    if roots is None:
        return None
    per_root = _recomputed_ms(recs, roots, "mednext.block")
    if per_root is None:
        return None
    return sum(per_root.values()) / st.units
