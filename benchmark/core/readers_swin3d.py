"""The readers of the Swin UNETR training cell's per-layer metrics: the
device time inside the program's own device-timed spans nested in a step's
forward (``swin.encoder``, ``swin.attention``, ``unetr.cnn``), the whole
step's share of the peak and the attention's share of its roofline
(``core/counts_swin3d.py``).

A span's device interval: the profiled step's forward starts on the device
when its host range starts, or when the work before it ends if that is
later (``core/spans.py:device_ms``); the span's record gives its start on
the device after that (``device_start_ms``, from the CUDA event of the
outermost device-timed span around it, ``train.forward``) and its length
(``device_ms``). The device records inside those intervals are the span's
work. A program whose records lack ``device_start_ms`` leaves nothing to
read, and each reader then returns None.
"""

from benchmark.core import counts_swin3d
from benchmark.core.spans import PHASES, _tracing, profiled_roots


def _forward_spans(recs, roots, name):
    """Per root, ``(start_ms, length_ms)`` of its ``name`` records that lie
    inside its ``train.forward`` (a span recomputed in the backward does
    not count)."""
    by_id = {r["id"]: r for r in recs}
    out = {root: [] for root in roots}
    for r in recs:
        if r["name"] != name or r["root"] not in out:
            continue
        if r.get("device_start_ms") is None or r["device_ms"] is None:
            return None
        up = by_id.get(r["parent"])
        while up is not None and up["name"] != PHASES[0]:
            up = by_id.get(up["parent"])
        if up is not None:
            out[r["root"]].append((r["device_start_ms"], r["device_ms"]))
    return out if any(out.values()) else None


def span_device_ms(ctx, name):
    """The device's busy time in ms per profiled step inside the intervals of
    the forward's ``name`` spans."""
    tracing = _tracing()
    st = ctx.stretch
    if ctx.kind != "train" or tracing is None or st is None or not st.device or not st.units:
        return None
    recs = tracing.records()
    roots = profiled_roots(recs, st)
    if roots is None:
        return None
    spans = _forward_spans(recs, roots, name)
    if spans is None:
        return None
    starts = sorted(s for n, s, _ in st.host if n == PHASES[0])
    busy = 0.0
    for root, h in zip(roots, starts):
        a = max([h] + [e for _, s, e in st.device if s < h])
        busy += st.busy_us([(a + 1e3 * off, a + 1e3 * (off + ms)) for off, ms in spans[root]])
    return 1e-3 * busy / st.units


def step_mfu(ctx):
    """The whole training step's share of the card's peak: three forwards'
    analytic operations per trained volume (``counts_swin3d.train_step_flops``),
    times the volumes trained in the window, over the window's time and the
    peak of the configuration's operand precision."""
    if ctx.kind != "train" or not ctx.peaks:
        return None
    flops = counts_swin3d.train_step_flops(ctx.model, ctx.samples)
    return 100.0 * flops / (ctx.window_s * ctx.peaks[0])


def attention_roofline(ctx):
    """The forward attention's share of its roofline: the least time of the
    profiled steps' forward attention (per block the larger of its
    operations over the peak and its bytes over the bandwidth;
    ``counts_swin3d.attention_bound_s``) over the device time inside their
    ``swin.attention`` spans, whatever kernels compute it."""
    if not ctx.peaks:
        return None
    per_step = span_device_ms(ctx, "swin.attention")
    if not per_step:
        return None
    bound = counts_swin3d.attention_bound_s(ctx.model, *ctx.peaks) * ctx.stretch_samples
    return 100.0 * bound / (1e-3 * per_step * ctx.stretch.units)
