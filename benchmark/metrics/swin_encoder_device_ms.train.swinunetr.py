"""The Swin encoder's device time per profiled step of the swinunetr
training cell: the device's busy time inside the interval that the
program's ``swin.encoder`` span (the patch embedding through the last
hidden state's norm, in the forward) marks on the device
(``core/readers_swin3d.py:span_device_ms``)."""

from benchmark.core.readers_swin3d import span_device_ms

LAYER = "model forward"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"


def read(ctx):
    return span_device_ms(ctx, "swin.encoder")
