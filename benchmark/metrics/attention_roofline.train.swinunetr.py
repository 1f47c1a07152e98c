"""attention_roofline of the swinunetr training cell (``core/readers_swin3d.py:attention_roofline``)."""

from benchmark.core.readers_swin3d import attention_roofline as read  # noqa: F401

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"
