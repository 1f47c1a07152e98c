"""step_mfu of the swinunetr training cell (``core/readers_swin3d.py:step_mfu``)."""

from benchmark.core.readers_swin3d import step_mfu as read  # noqa: F401

LAYER = "train step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_samples_per_s.brats"
