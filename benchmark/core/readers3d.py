"""The readers of the 3-D training cells' per-layer metrics that count the
work (``core/counts3d.py``); the device's idle share, its operations per
step and the phases' device times are read as in every training cell
(``core/readers.py``, ``core/spans.py``)."""

from benchmark.core import counts3d
from benchmark.core.readers import CONV


def step_mfu(ctx):
    """The whole training step's share of the card's peak: three forwards'
    analytic operations per trained volume (``counts3d.train_step_flops``),
    times the volumes trained in the window, over the window's time and the
    peak of the configuration's operand precision: the cell's rate times a
    constant of the configuration."""
    if ctx.kind != "train" or not ctx.peaks:
        return None
    flops = counts3d.train_step_flops(ctx.model, ctx.samples)
    return 100.0 * flops / (ctx.window_s * ctx.peaks[0])


def conv3d_roofline(ctx):
    """The convolutions' share of their roofline in a 3-D training step: the
    least time of all the convolution work of the profiled steps (forward,
    input and filter gradients; ``counts3d.train_conv_bound_s``) over the
    device time of every kernel in the convolution categories (cuDNN's
    ``conv3d`` and the GEMMs of the unpool convs and the head)."""
    if ctx.kind != "train" or ctx.stretch is None or not ctx.peaks:
        return None
    busy = ctx.stretch.device_time_us(CONV) * 1e-6
    if busy <= 0:
        return None
    bound = counts3d.train_conv_bound_s(ctx.model, *ctx.peaks) * ctx.stretch_samples
    return 100.0 * bound / busy
