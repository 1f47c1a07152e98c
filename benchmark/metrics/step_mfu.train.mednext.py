"""step_mfu of the mednext training cell (``core/readers_mednext3d.py:step_mfu``)."""

from benchmark.core.readers_mednext3d import step_mfu as read  # noqa: F401

LAYER = "train step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_samples_per_s.brats"
