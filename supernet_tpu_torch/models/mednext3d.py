"""MedNeXt as a VDP network: the ``mednext`` layer plan of the 3-D family
(:class:`MedNeXtConfig`), reached through ``models/unet3d.py``'s
``forward3d``, ``init_params3d``, ``layer_names3d`` and ``stage_shapes3d``.

Source: Roy, Koehler, Ulrich, Baumgartner, Petersen, Isensee, Jaeger,
Maier-Hein, "MedNeXt: Transformer-driven Scaling of ConvNets for Medical
Image Segmentation" (MICCAI 2023, arXiv:2303.09975), as
``create_mednext_v1`` of MIC-DKFZ/MedNeXt builds it, layer for layer
(``do_res`` and ``do_res_up_down`` on, ``norm_type='group'``, no GRN, no
deep supervision):

- ``stem``: a 1^3 conv, ``in_channels`` -> n (``n_channels``);
- a MedNeXt block at C channels, ratio R: the depthwise k^3 conv (SAME),
  GroupNorm(C, C) (each channel of each volume over D*H*W, with a gamma
  and beta per channel), a 1^3 conv C -> R C, GELU, a 1^3 conv R C -> C,
  plus the block's input;
- encoder level i (C = n 2^i): ``block_counts[i]`` blocks of ratio
  ``exp_r[i]``, kept as skip i, then the down block: the block with a
  stride-2 depthwise conv, its last conv to 2C and no inner residual, plus
  a stride-2 1^3 conv C -> 2C of the input (ratio ``exp_r[i + 1]``);
- the bottleneck's ``block_counts[4]`` blocks at 16 n;
- decoder level l = 3 .. 0: the up block (C = n 2^(l + 1) -> C / 2, ratio
  ``exp_r[8 - l]``): the block with the stride-2 transposed depthwise conv
  (side s -> 2 s - 1), its last conv to C / 2 and no inner residual, padded
  (1, 0) on every spatial axis to 2 s, plus the stride-2 1^3 transposed conv
  of the input padded the same way; then skip l added (means and
  variances), then ``block_counts[8 - l]`` blocks;
- ``out``: a 1^3 conv n -> ``n_classes`` (MedNeXt's 1^3 transposed conv),
  the softmax moments.

Layers with weights are VDP layers without biases (``{"w_mu": [k, k, k,
Cin, Cout], "w_sigma": [Cout]}``); a depthwise conv's ``w_mu`` is the
grouped conv's DHWIO, [k, k, k, 1, C], so that every consumer of a 5-D
kernel (the KL's strength k^3, the counts) reads it as it is. GroupNorm's
gamma and beta (``{"gamma", "beta"}`` under ``<block>_norm``) are point
parameters: they act on the mean, carry no variance and no KL term, and
Adam trains them.

With ``cfg.remat`` and gradients on, every block (the down and up blocks
too) runs under a non-reentrant ``torch.utils.checkpoint``: its body is
recomputed in the backward, as the published L model runs
(``checkpoint_style='outside_block'``).

Spans and counters (``tracing``): ``mednext.block`` (device-timed) around
each block, ``mednext.dwconv`` (device-timed) around each depthwise conv;
``mednext.blocks`` counts the block bodies run (62 a forward at the
published block counts, 124 a training step with recomputation). A body
recomputed in the backward runs in autograd's thread, where its spans have
no parent; their host intervals lie inside ``train.backward``'s. Each layer with weights runs
under its own name's span, as in ``models/unet3d.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from supernet_tpu_torch import tracing
from supernet_tpu_torch.configs import MedNeXtConfig
from supernet_tpu_torch.models.unet import _block_helpers
from supernet_tpu_torch.ops.moments3d import (
    vconv3d,
    vconv3d_input,
    vconv3d_transpose_1x1,
    vdwconv3d,
    vdwconv3d_transpose,
    vsoftmax3d,
)
from supernet_tpu_torch.ops.moments_swin import vadd, vgelu, vnorm

Tensor = torch.Tensor
Params = Dict[str, Dict[str, Tensor]]

# the standard deviation of a unit normal cut at +-2
_TRUNC2_STD = 0.8796256610342398
LEVELS = 4


def blocks(cfg: MedNeXtConfig) -> List[Tuple[str, str, int, int, int]]:
    """``(name, kind, C, ratio, C_out)`` of every block in forward order;
    ``kind`` is ``block``, ``down`` or ``up``."""
    n, r, bc = cfg.n_channels, cfg.exp_r, cfg.block_counts
    out = []
    for i in range(LEVELS):
        c = n * 2 ** i
        out += [(f"enc{i}_block{j}", "block", c, r[i], c) for j in range(bc[i])]
        out.append((f"down{i}", "down", c, r[i + 1], 2 * c))
    c = n * 2 ** LEVELS
    out += [(f"bottleneck_block{j}", "block", c, r[LEVELS], c) for j in range(bc[LEVELS])]
    for lvl in reversed(range(LEVELS)):
        stage = 2 * LEVELS - lvl
        c = n * 2 ** (lvl + 1)
        out.append((f"up{lvl}", "up", c, r[stage], c // 2))
        out += [(f"dec{lvl}_block{j}", "block", c // 2, r[stage], c // 2)
                for j in range(bc[stage])]
    return out


def layer_names_mednext(cfg: MedNeXtConfig) -> List[Tuple[str, int, int, int]]:
    """``(name, k, cin, cout)`` of every layer with Gaussian weights, in the
    order the forward runs them (a depthwise conv ``cin`` 1, a 1^3 conv or
    the head k = 1)."""
    k = cfg.kernel_size
    out = [("stem", 1, cfg.in_channels, cfg.n_channels)]
    for name, kind, c, r, c_out in blocks(cfg):
        out += [(f"{name}_dw", k, 1, c), (f"{name}_expand", 1, c, r * c),
                (f"{name}_project", 1, r * c, c_out)]
        if kind != "block":
            out.append((f"{name}_res", 1, c, c_out))
    out.append(("out", 1, cfg.n_channels, cfg.n_classes))
    return out


def point_params_mednext(cfg: MedNeXtConfig) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """``(entry, key, shape)`` of every point parameter: each block's
    GroupNorm gamma and beta."""
    out = []
    for name, _, c, _, _ in blocks(cfg):
        out += [(f"{name}_norm", "gamma", (c,)), (f"{name}_norm", "beta", (c,))]
    return out


def param_shapes(cfg: MedNeXtConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """The parameter tree's shapes: the Gaussian layers then the point
    parameters, each group in forward order (``stem`` first)."""
    tree: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for name, k, cin, cout in layer_names_mednext(cfg):
        tree[name] = {"w_mu": (k, k, k, cin, cout), "w_sigma": (cout,)}
    for entry, key, shape in point_params_mednext(cfg):
        tree.setdefault(entry, {})[key] = shape
    return tree


def init_params_mednext(generator: torch.Generator, cfg: MedNeXtConfig,
                        device="cuda") -> Params:
    """He-scale ``w_mu`` (std sqrt(2 / fan_in), fan_in k^3 Cin with Cin 1
    for a depthwise conv, cut at 2 std and scaled so that std is the drawn
    weights' own), ``w_sigma`` uniform on the config's ranges (the tighter
    one on the head alone), gamma 1 and beta 0. Drawn on the CPU from
    ``generator``, then moved to ``device``."""
    params: Params = {}
    for name, k, cin, cout in layer_names_mednext(cfg):
        std = math.sqrt(2.0 / (k ** 3 * cin)) / _TRUNC2_STD
        w_mu = torch.empty((k, k, k, cin, cout))
        nn.init.trunc_normal_(w_mu, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        lo, hi = ((cfg.tight_sigma_min, cfg.tight_sigma_max) if name == "out"
                  else (cfg.sigma_min, cfg.sigma_max))
        w_sigma = torch.empty((cout,)).uniform_(lo, hi, generator=generator)
        params[name] = {"w_mu": w_mu.to(device), "w_sigma": w_sigma.to(device)}
    for entry, key, shape in point_params_mednext(cfg):
        t = torch.ones(shape) if key == "gamma" else torch.zeros(shape)
        params.setdefault(entry, {})[key] = t.to(device)
    return params


def _pad_lo(m: Tensor, s: Tensor) -> Tuple[Tensor, Tensor]:
    """(1, 0) on every spatial axis, mean and variance 0 in the pad."""
    pad = (0, 0, 1, 0, 1, 0, 1, 0)
    return F.pad(m, pad), F.pad(s, pad)


def forward_mednext(params: Params, x: Tensor, cfg: MedNeXtConfig,
                    tap=None) -> Tuple[Tensor, Tensor]:
    """Volume [B, S, S, S, Cin] -> (probs, sigma), both [B, S^3, n_classes]
    (S a multiple of 16). ``tap(stage_name, shape)`` sees the stem, each
    skip (``enc0`` .. ``enc3``), the bottleneck, each decoder level
    (``dec3`` .. ``dec0``) and the head."""
    if x.dim() != 5:
        raise NotImplementedError("the MedNeXt plan takes one model: no member axis")
    _tap, block = _block_helpers(cfg, tap)
    kinds = {name: kind for name, kind, *_ in blocks(cfg)}

    def layer(fn, name: str, *args):
        p = params[name]
        with tracing.span(name):
            return fn(*args, p["w_mu"], p["w_sigma"])

    def dw(name: str, m: Tensor, s: Tensor):
        fn = {"block": vdwconv3d, "up": vdwconv3d_transpose,
              "down": lambda *a: vdwconv3d(*a, stride=2)}[kinds[name]]
        with tracing.span("mednext.dwconv", device=True):
            return layer(fn, f"{name}_dw", m, s)

    def body(name: str, m: Tensor, s: Tensor):
        tracing.count("mednext.blocks")
        with tracing.span("mednext.block", device=True):
            norm = params[f"{name}_norm"]
            h = vnorm(*dw(name, m, s), (1, 2, 3), norm["gamma"], norm["beta"])
            h = layer(vconv3d, f"{name}_expand", *h)
            h = layer(vconv3d, f"{name}_project", *vgelu(*h))
            kind = kinds[name]
            if kind == "block":
                return vadd((m, s), h)
            if kind == "down":
                return vadd(h, layer(lambda *a: vconv3d(*a, stride=2), f"{name}_res", m, s))
            return vadd(_pad_lo(*h), layer(vconv3d_transpose_1x1, f"{name}_res", m, s))

    bc = cfg.block_counts
    m, s = layer(vconv3d_input, "stem", x)
    _tap("stem", m)
    skips = []
    for i in range(LEVELS):
        for j in range(bc[i]):
            m, s = block(body, f"enc{i}_block{j}", m, s)
        skips.append((m, s))
        _tap(f"enc{i}", m)
        m, s = block(body, f"down{i}", m, s)
    for j in range(bc[LEVELS]):
        m, s = block(body, f"bottleneck_block{j}", m, s)
    _tap("bottleneck", m)
    for lvl in reversed(range(LEVELS)):
        m, s = vadd(block(body, f"up{lvl}", m, s), skips[lvl])
        for j in range(bc[2 * LEVELS - lvl]):
            m, s = block(body, f"dec{lvl}_block{j}", m, s)
        _tap(f"dec{lvl}", m)
    m, s = layer(vconv3d, "out", m, s)
    _tap("out", m)
    return vsoftmax3d(m, s)
