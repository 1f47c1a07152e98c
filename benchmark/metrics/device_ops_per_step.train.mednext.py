"""device_ops_per_step of the mednext training cell (``core/readers.py:device_ops_per_step``)."""

from benchmark.core.readers import device_ops_per_step as read  # noqa: F401

LAYER = "moment ops and autograd"
UNIT = "ops/step"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"
