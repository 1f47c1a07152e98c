"""step_mfu of the brats training cells (``core/readers.py:step_mfu``)."""

from benchmark.core.readers import step_mfu as read  # noqa: F401

LAYER = "train step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_samples_per_s.brats"
