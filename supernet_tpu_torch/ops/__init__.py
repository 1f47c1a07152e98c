"""VDP moment ops of the port (see ``ops/moments.py``) and its kernels
(``ops/kernels``)."""

from supernet_tpu_torch.ops.moments import (
    chan_sum,
    crop_center,
    crop_to_match,
    get_mxu_precision,
    scale_sw,
    set_mxu_precision,
    vconv,
    vconv_input,
    vconv_input_relu,
    vconv_relu,
    vcrop_concat,
    vmaxpool,
    vpad,
    vrelu,
    vsoftmax,
    vunpool,
    vunpool_conv2,
)

__all__ = [
    "chan_sum",
    "crop_center",
    "crop_to_match",
    "get_mxu_precision",
    "scale_sw",
    "set_mxu_precision",
    "vconv",
    "vconv_input",
    "vconv_input_relu",
    "vconv_relu",
    "vcrop_concat",
    "vmaxpool",
    "vpad",
    "vrelu",
    "vsoftmax",
    "vunpool",
    "vunpool_conv2",
]
