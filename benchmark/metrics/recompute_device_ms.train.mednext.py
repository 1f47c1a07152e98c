"""What recomputation costs in the mednext training cell: the device time
per profiled step of the ``mednext.block`` spans whose host intervals lie
in ``train.backward``'s, each span's own CUDA events
(``core/readers_mednext3d.py:recompute_device_ms``)."""

from benchmark.core.readers_mednext3d import recompute_device_ms as read  # noqa: F401

LAYER = "moment ops and autograd"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_samples_per_s.brats"
