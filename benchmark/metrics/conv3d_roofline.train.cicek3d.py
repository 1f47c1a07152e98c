"""conv3d_roofline of the cicek3d training cells
(``core/readers3d.py:conv3d_roofline``): the roofline share of the cuDNN
``conv3d`` work and the GEMMs of a 3-D step."""

from benchmark.core.readers3d import conv3d_roofline as read  # noqa: F401

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_samples_per_s.brats"
