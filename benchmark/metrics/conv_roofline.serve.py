"""The convolutions' share of their roofline in serving: the least time of
the forward convolutions of the real slices of the profiled requests (the
tail chunk's padding counts as no work; ``core/counts.py:
forward_conv_bound_s``) over the device time of every kernel in the
convolution categories (kernel 1, cuDNN, the GEMMs)."""

from benchmark.core import counts

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_samples_per_s"
CONV = ("vdp_conv (kernel 1)", "cuDNN convolutions", "matmuls (1x1 head, unpool conv)")


def read(ctx):
    if ctx.kind != "serve" or ctx.stretch is None or not ctx.peaks:
        return None
    busy = ctx.stretch.device_time_us(CONV) * 1e-6
    if busy <= 0:
        return None
    bound = counts.forward_conv_bound_s(ctx.model, *ctx.peaks) * ctx.stretch_samples
    return 100.0 * bound / busy
