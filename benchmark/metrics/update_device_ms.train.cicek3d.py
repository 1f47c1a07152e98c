"""The update's device time per profiled step of the cicek3d training cells:
the device's busy time inside the interval that the program's
``train.update`` span (the per-tensor clip, Adam's step and the cleared
gradients) marks on the device (``core/spans.py``)."""

from benchmark.core.spans import device_ms

LAYER = "train step"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"


def read(ctx):
    if ctx.kind != "train":
        return None
    return device_ms(ctx, "train.update")
