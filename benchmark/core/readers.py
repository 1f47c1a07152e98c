"""The readers of the training cells' per-layer metrics, one function per
quantity. Each ``metrics/<quantity>.train.<config>.py`` names one of them
as its ``read``: the quantity is read alike in every training cell, and
split by configuration only because each configuration's rate has a bound
of its own."""

from benchmark.core import counts

CONV = ("vdp_conv (kernel 1)", "cuDNN convolutions", "matmuls (1x1 head, unpool conv)")


def step_mfu(ctx):
    """The whole training step's share of the card's peak: three forwards'
    analytic operations per trained image (``core/counts.py``), times the images
    trained in the window, over the window's time and the peak of the
    configuration's operand precision. From the same window and clock as the
    cell's rate, it is that rate times a constant of the configuration: it
    says how far the step is from the card's peak, and a later PR that takes a
    kernel off the path can claim a gain only while it still bounds that
    kernel's roofline."""
    if ctx.kind != "train" or not ctx.peaks:
        return None
    flops = counts.train_step_flops(ctx.model, ctx.samples)
    return 100.0 * flops / (ctx.window_s * ctx.peaks[0])


def device_ops_per_step(ctx):
    """Device operations (kernels, copies, fills) per training step in the
    profiled stretch: what the host dispatches for the moment ops and their
    autograd."""
    if ctx.kind != "train" or ctx.stretch is None or not ctx.stretch.device:
        return None
    return len(ctx.stretch.device) / ctx.stretch.units


def conv_roofline(ctx):
    """The convolutions' share of their roofline in a training step: the least
    time of all the convolution work of the profiled steps (forward, input and
    filter gradients; ``core/counts.py:train_conv_bound_s``) over the device
    time of every kernel in the convolution categories (kernel 1 and its
    split-K reduce, cuDNN, the GEMMs), so that work moved between kernel 1 and
    cuDNN cannot lift it above 100%."""
    if ctx.kind != "train" or ctx.stretch is None or not ctx.peaks:
        return None
    busy = ctx.stretch.device_time_us(CONV) * 1e-6
    if busy <= 0:
        return None
    bound = counts.train_conv_bound_s(ctx.model, *ctx.peaks) * ctx.stretch_samples
    return 100.0 * bound / busy


def device_idle(ctx):
    """The device's idle share of a training step: 1 - the device's busy time
    per profiled step (the union of its kernels, copies and fills) over the
    untraced step time of the same run's window (never the traced step's)."""
    if ctx.kind != "train" or ctx.stretch is None or not ctx.stretch.device:
        return None
    busy = ctx.stretch.busy_us() * 1e-6 / ctx.stretch.units
    return 100.0 * (1.0 - busy / ctx.step_s)
