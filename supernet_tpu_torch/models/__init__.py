"""The VDP U-Net of the port (2-D)."""

from supernet_tpu_torch.models.unet import (
    VDPUNet,
    forward,
    forward_images,
    init_params,
    kl_regularizer,
    layer_names,
)

__all__ = [
    "VDPUNet",
    "forward",
    "forward_images",
    "init_params",
    "kl_regularizer",
    "layer_names",
]
