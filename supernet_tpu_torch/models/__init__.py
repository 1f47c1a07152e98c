"""The VDP U-Net of the port (2-D)."""

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

__all__ = [
    "VDPUNet",
    "forward",
    "forward_images",
    "forward_sampled",
    "init_params",
    "kl_regularizer",
    "layer_names",
    "sample_weights",
]
