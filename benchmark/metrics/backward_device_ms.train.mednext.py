"""The backward's device time per profiled step of the mednext training
cell: the device's busy time inside the interval that the program's
``train.backward`` span marks on the device (``core/spans.py``), the
recomputed blocks included."""

from benchmark.core.spans import device_ms

LAYER = "moment ops and autograd"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"


def read(ctx):
    if ctx.kind != "train":
        return None
    return device_ms(ctx, "train.backward")
