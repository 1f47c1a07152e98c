"""2-D -> 3-D parameter inflation: the counterpart of
``supernet_tpu/models/inflate.py``.

A trained 2-D slice model initializes the volumetric one (the "inflated
convolution" of I3D, made Bayesian):

- mean kernel: ``w_mu3[d] = w_mu2 / k`` for each of the ``k`` depth taps, so
  on a depth-constant input the depth taps sum to the 2-D response;
- raw variance: ``softplus(s3) = softplus(s2) / k``, so the variance of the
  ``k`` independent depth taps sums to the 2-D weight variance.

Both families derive their layer lists from one ``ModelConfig``
(``models.unet.layer_names`` / ``models.unet3d.layer_names3d``) and both
concatenate skips decoder channels first, so the mapping is name for name.
What is exact and what is not is in the JAX module's docstring: inflation is
a transfer initialization, not a function-preserving rewrite.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from supernet_tpu_torch.configs import ModelConfig
from supernet_tpu_torch.models.unet import Params, layer_names
from supernet_tpu_torch.models.unet3d import layer_names3d


def softplus_inverse(y) -> torch.Tensor:
    """x with softplus(x) = y, for y > 0, in float32: ``y + log(-expm1(-y))``
    (the stable form of ``log(expm1(y))``)."""
    y = torch.as_tensor(y, dtype=torch.float32)
    return y + torch.log(-torch.expm1(-y))


def _f32_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def inflate_params3d(params2d, cfg: ModelConfig) -> Params:
    """Inflate a 2-D parameter dict (tensors, numpy or JAX arrays) into the
    3-D model's structure for the same ``cfg``; tensors stay on their
    device, arrays come out on the CPU.

    Raises if the 2-D dict does not match the config's 2-D layer map:
    inflating a mismatched checkpoint would silently mis-initialize."""
    names2 = {n: (k, ci, co) for n, k, ci, co in layer_names(cfg)}
    out: Params = {}
    for name, k, cin, cout in layer_names3d(cfg):
        if name not in params2d or name not in names2:
            raise ValueError(
                f"layer {name!r} missing from the 2-D checkpoint; "
                "inflation needs a checkpoint trained with the same "
                "ModelConfig (depth/base_kernels/channels)"
            )
        if names2[name] != (k, cin, cout):
            raise ValueError(
                f"layer {name!r}: 2-D layer map {names2[name]} disagrees "
                f"with the 3-D map ({k}, {cin}, {cout})"
            )
        w2 = _f32_tensor(params2d[name]["w_mu"])
        s2 = _f32_tensor(params2d[name]["w_sigma"])
        if tuple(w2.shape) != (k, k, cin, cout) or tuple(s2.shape) != (cout,):
            raise ValueError(
                f"layer {name!r}: 2-D kernel {tuple(w2.shape)} / sigma "
                f"{tuple(s2.shape)} do not match the config's "
                f"({k}, {k}, {cin}, {cout}) / ({cout},)"
            )
        w3 = (w2[None] / k).repeat(k, 1, 1, 1, 1)
        s3 = softplus_inverse(F.softplus(s2) / k)
        out[name] = {"w_mu": w3, "w_sigma": s3}
    return out
