"""dwconv_roofline of the mednext training cell: the forward depthwise moment
convs' least time over the device time inside their ``mednext.dwconv``
spans (``core/readers_mednext3d.py:dwconv_roofline``)."""

from benchmark.core.readers_mednext3d import dwconv_roofline as read  # noqa: F401

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"
