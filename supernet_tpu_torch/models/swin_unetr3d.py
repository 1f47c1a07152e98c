"""Swin UNETR as a VDP network: the ``swinunetr`` layer plan of the 3-D
family (:class:`SwinUNETRConfig`), reached through ``models/unet3d.py``'s
``forward3d``, ``init_params3d`` and ``layer_names3d``.

Source: Hatamizadeh et al., "Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images" (arXiv:2201.01266), as
``monai.networks.nets.SwinUNETR`` (v1) builds it, layer for layer:

- ``patch_embed``: a 2^3 stride-2 conv, ``in_channels`` -> F (F the feature
  size); four stages of ``depths[i]`` Swin blocks at F 2^i channels, each
  stage followed by its patch merge (eight 2^3 sub-grids, LayerNorm(8C), a
  linear 8C -> 2C); the five hidden states (after the embedding and after
  each merge) normalised over channels without affine;
- a Swin block: ``x + proj(attn(LN1(x)))``, then ``x + fc2(gelu(fc1(LN2(x))))``;
  windows of ``window_size``^3 tokens (a side that fits in one window is the
  window), the second block of each pair cyclically shifted by half a
  window with the region mask; ``num_heads[i]`` heads; the tokens
  zero-padded at the high end to whole windows;
- ``encoder1`` on the volume, ``encoder2/3/4`` on hidden states 0-2,
  ``encoder10`` on hidden state 4: UnetResBlocks (3^3 SAME conv, InstanceNorm,
  LeakyReLU(0.01), 3^3 SAME conv, InstanceNorm, plus the input or its 1^3
  conv and InstanceNorm where the channels change, LeakyReLU);
- ``decoder5..1``: the stride-2 2^3 transposed conv (``vunpool3d_conv2``),
  the skip concatenated after it (hidden state 3 for ``decoder5``), a
  UnetResBlock 2 Cout -> Cout; the 1^3 head F -> ``n_classes``; the softmax
  moments.

Layers with weights are VDP layers without biases (``{"w_mu": [k, k, k,
Cin, Cout], "w_sigma": [Cout]}``; a linear is k = 1). LayerNorm's gamma and
beta (``{"gamma", "beta"}``) and the relative-position bias tables
(``{"bias_table": [(2 window - 1)^3, heads]}``) are point parameters: they
act on the mean, carry no variance and no KL term, and Adam trains them.

Spans (``tracing``): ``swin.encoder`` (device-timed) from the embedding to
the last hidden state's norm, in it ``swin.attention`` (device-timed) around
each block's qkv linear, window attention and proj; ``unetr.cnn``
(device-timed) around ``encoder1`` through ``decoder1``. Each layer with
weights runs under its own name's span, as in ``models/unet3d.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from supernet_tpu_torch import tracing
from supernet_tpu_torch.configs import SwinUNETRConfig
from supernet_tpu_torch.models.unet import _block_helpers
from supernet_tpu_torch.ops.moments3d import (
    vconv3d,
    vconv3d_input,
    vpad3d,
    vsoftmax3d,
    vunpool3d_conv2,
)
from supernet_tpu_torch.ops.moments_swin import (
    patch_grids,
    vadd,
    vgelu,
    vinstance_norm3d,
    vlayer_norm,
    vleaky_relu,
    window_attention,
)

Tensor = torch.Tensor
Params = Dict[str, Dict[str, Tensor]]

# the standard deviation of a unit normal cut at +-2
_TRUNC2_STD = 0.8796256610342398
BIAS_TABLE_STD = 0.02  # the bias tables' init (MONAI's trunc_normal_)


def _res_block(name: str, k_in: int, cin: int, cout: int):
    """A UnetResBlock's convs: two 3^3, and the 1^3 residual conv where the
    channels change (``k_in`` is the first conv's size)."""
    out = [(f"{name}_conv1", k_in, cin, cout), (f"{name}_conv2", 3, cout, cout)]
    if cin != cout:
        out.append((f"{name}_conv3", 1, cin, cout))
    return out


def _decoders(cfg: SwinUNETRConfig):
    """``(name, cin, cout)`` of ``decoder5`` .. ``decoder1``."""
    f = cfg.feature_size
    return [("decoder5", 16 * f, 8 * f), ("decoder4", 8 * f, 4 * f),
            ("decoder3", 4 * f, 2 * f), ("decoder2", 2 * f, f), ("decoder1", f, f)]


def _encoders(cfg: SwinUNETRConfig):
    """``(name, channels)`` of the UnetResBlocks on hidden states 0, 1, 2, 4."""
    f = cfg.feature_size
    return [("encoder2", f), ("encoder3", 2 * f), ("encoder4", 4 * f), ("encoder10", 16 * f)]


def layer_names_swin(cfg: SwinUNETRConfig) -> List[Tuple[str, int, int, int]]:
    """``(name, k, cin, cout)`` of every layer with Gaussian weights, in the
    order the forward runs them."""
    f, r = cfg.feature_size, cfg.mlp_ratio
    out = [("patch_embed", cfg.patch_size, cfg.in_channels, f)]
    for i, depth in enumerate(cfg.depths):
        c = f * 2 ** i
        for j in range(depth):
            pre = f"stage{i}_block{j}"
            out += [(f"{pre}_qkv", 1, c, 3 * c), (f"{pre}_proj", 1, c, c),
                    (f"{pre}_fc1", 1, c, r * c), (f"{pre}_fc2", 1, r * c, c)]
        out.append((f"stage{i}_merge", 1, 8 * c, 2 * c))
    out += _res_block("encoder1", 3, cfg.in_channels, f)
    for name, c in _encoders(cfg):
        out += _res_block(name, 3, c, c)
    for name, cin, cout in _decoders(cfg):
        out.append((f"{name}_up", 2, cin, cout))
        out += _res_block(name, 3, 2 * cout, cout)
    out.append(("out", 1, f, cfg.n_classes))
    return out


def point_params_swin(cfg: SwinUNETRConfig) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """``(entry, key, shape)`` of every point parameter."""
    f = cfg.feature_size
    rows = (2 * cfg.window_size - 1) ** 3
    out = []
    for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        c = f * 2 ** i
        for j in range(depth):
            pre = f"stage{i}_block{j}"
            out += [(f"{pre}_norm1", "gamma", (c,)), (f"{pre}_norm1", "beta", (c,)),
                    (f"{pre}_attn", "bias_table", (rows, heads)),
                    (f"{pre}_norm2", "gamma", (c,)), (f"{pre}_norm2", "beta", (c,))]
        out += [(f"stage{i}_merge_norm", "gamma", (8 * c,)),
                (f"stage{i}_merge_norm", "beta", (8 * c,))]
    return out


def _tight(cfg: SwinUNETRConfig) -> set:
    """The layers on the tighter ``w_sigma`` range: the first
    ``tight_upconvs`` up-convs and the head."""
    ups = [f"{name}_up" for name, _, _ in _decoders(cfg)][: cfg.tight_upconvs]
    return set(ups) | {"out"}


def param_shapes(cfg: SwinUNETRConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """The parameter tree's shapes: the Gaussian layers then the point
    parameters, each group in forward order (``patch_embed`` first)."""
    tree: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for name, k, cin, cout in layer_names_swin(cfg):
        tree[name] = {"w_mu": (k, k, k, cin, cout), "w_sigma": (cout,)}
    for entry, key, shape in point_params_swin(cfg):
        tree.setdefault(entry, {})[key] = shape
    return tree


def init_params_swin(generator: torch.Generator, cfg: SwinUNETRConfig, device="cuda") -> Params:
    """He-scale ``w_mu`` (std sqrt(2 / fan_in), cut at 2 std and scaled so
    that std is the drawn weights' own), ``w_sigma`` uniform on the config's
    ranges (the tighter one on ``_tight``'s layers), LayerNorm's gamma 1 and
    beta 0, the bias tables a normal of std 0.02 cut at 2 std. Drawn on the
    CPU from ``generator``, then moved to ``device``."""
    tight = _tight(cfg)
    params: Params = {}
    for name, k, cin, cout in layer_names_swin(cfg):
        std = math.sqrt(2.0 / (k ** 3 * cin)) / _TRUNC2_STD
        w_mu = torch.empty((k, k, k, cin, cout))
        nn.init.trunc_normal_(w_mu, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        lo, hi = ((cfg.tight_sigma_min, cfg.tight_sigma_max) if name in tight
                  else (cfg.sigma_min, cfg.sigma_max))
        w_sigma = torch.empty((cout,)).uniform_(lo, hi, generator=generator)
        params[name] = {"w_mu": w_mu.to(device), "w_sigma": w_sigma.to(device)}
    for entry, key, shape in point_params_swin(cfg):
        if key == "bias_table":
            t = torch.empty(shape)
            s = BIAS_TABLE_STD
            nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)
        else:
            t = torch.ones(shape) if key == "gamma" else torch.zeros(shape)
        params.setdefault(entry, {})[key] = t.to(device)
    return params


def forward_swin(params: Params, x: Tensor, cfg: SwinUNETRConfig, tap=None) -> Tuple[Tensor, Tensor]:
    """Volume [B, S, S, S, Cin] -> (probs, sigma), both [B, S^3, n_classes].
    ``tap(stage_name, shape)`` sees the embedding, every hidden state and
    the head; with ``cfg.remat`` and gradients on, every Swin block and
    every UnetResBlock runs under ``torch.utils.checkpoint``."""
    if x.dim() != 5:
        raise NotImplementedError("the Swin UNETR plan takes one model: no member axis")
    _tap, block = _block_helpers(cfg, tap)
    fill = cfg.sigma_fill

    def layer(fn, name: str, *args):
        p = params[name]
        with tracing.span(name):
            return fn(*args, p["w_mu"], p["w_sigma"])

    def norm(entry: str, m: Tensor, s: Tensor):
        return vlayer_norm(m, s, params[entry]["gamma"], params[entry]["beta"])

    def swin_block(idx, m, s):
        i, j = idx
        pre = f"stage{i}_block{j}"
        shift = cfg.window_size // 2 if j % 2 else 0
        with tracing.span("swin.attention", device=True):
            a = layer(vconv3d, f"{pre}_qkv", *norm(f"{pre}_norm1", m, s))
            a = window_attention(*a, cfg.num_heads[i], cfg.window_size, shift,
                                 params[f"{pre}_attn"]["bias_table"])
            a = layer(vconv3d, f"{pre}_proj", *a)
        m, s = vadd((m, s), a)
        h = layer(vconv3d, f"{pre}_fc1", *norm(f"{pre}_norm2", m, s))
        h = layer(vconv3d, f"{pre}_fc2", *vgelu(*h))
        return vadd((m, s), h)

    def res_block(name, m, s=None):
        """A UnetResBlock; ``s`` None: ``m`` is the deterministic volume."""
        conv, inputs = (vconv3d_input, (m,)) if s is None else (vconv3d, (m, s))
        padded = (F.pad(m, (0, 0) + (1, 1) * 3),) if s is None else vpad3d(m, s, (1, 1), fill)
        h = vleaky_relu(*vinstance_norm3d(*layer(conv, f"{name}_conv1", *padded)))
        h = vinstance_norm3d(*layer(vconv3d, f"{name}_conv2", *vpad3d(*h, (1, 1), fill)))
        r = inputs
        if f"{name}_conv3" in params:
            r = vinstance_norm3d(*layer(conv, f"{name}_conv3", *inputs))
        return vleaky_relu(*vadd(h, r))

    hidden: List[Tuple[Tensor, Tensor]] = []
    with tracing.span("swin.encoder", device=True):
        m, s = layer(lambda v, w, ws: vconv3d_input(v, w, ws, stride=cfg.patch_size),
                     "patch_embed", x)
        _tap("patch_embed", m)
        hidden.append(vlayer_norm(m, s))
        for i, depth in enumerate(cfg.depths):
            for j in range(depth):
                m, s = block(swin_block, (i, j), m, s)
            m, s = layer(vconv3d, f"stage{i}_merge",
                         *norm(f"stage{i}_merge_norm", *patch_grids(m, s)))
            hidden.append(vlayer_norm(m, s))
            _tap(f"hidden{i + 1}", m)

    with tracing.span("unetr.cnn", device=True):
        skips = [block(res_block, "encoder1", x)]
        for (name, _), h in zip(_encoders(cfg), (hidden[0], hidden[1], hidden[2], hidden[4])):
            skips.append(block(res_block, name, *h))
        m, s = skips.pop()
        skips.append(hidden[3])  # decoder5's skip: hidden state 3 itself
        for (name, _, _), skip in zip(_decoders(cfg), reversed(skips)):
            up = layer(vunpool3d_conv2, f"{name}_up", m, s)
            cat = (torch.cat([up[0], skip[0]], -1), torch.cat([up[1], skip[1]], -1))
            m, s = block(res_block, name, *cat)
    m, s = layer(vconv3d, "out", m, s)
    _tap("out", m)
    return vsoftmax3d(m, s)
