"""The VDP U-Net of the port: the 2-D model (``models/unet.py``), the
volumetric one (``models/unet3d.py``) and 2-D -> 3-D inflation
(``models/inflate.py``)."""

from supernet_tpu_torch.models.unet import (
    VDPUNet,
    forward,
    forward_images,
    forward_sampled,
    init_params,
    kl_regularizer,
    layer_names,
    sample_weights,
)
from supernet_tpu_torch.models.unet3d import (
    forward3d,
    forward_sampled3d,
    init_params3d,
    kl_regularizer3d,
    layer_names3d,
)
from supernet_tpu_torch.models.inflate import (  # noqa: E402
    inflate_params3d,
    softplus_inverse,
)

__all__ = [
    "VDPUNet",
    "forward",
    "forward3d",
    "forward_images",
    "forward_sampled",
    "forward_sampled3d",
    "inflate_params3d",
    "init_params",
    "init_params3d",
    "kl_regularizer",
    "kl_regularizer3d",
    "layer_names",
    "layer_names3d",
    "sample_weights",
    "softplus_inverse",
]
