"""device_idle of the mednext training cell (``core/readers.py:device_idle``)."""

from benchmark.core.readers import device_idle as read  # noqa: F401

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"
