"""conv_roofline of the brats training cells (``core/readers.py:conv_roofline``)."""

from benchmark.core.readers import conv_roofline as read  # noqa: F401

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"
