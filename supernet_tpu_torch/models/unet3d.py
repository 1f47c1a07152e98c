"""The volumetric (3-D) VDP U-Net in PyTorch: the counterpart of
``supernet_tpu/models/unet3d.py``.

The 2-D architecture one rank up, on whole sub-volumes: VALID k^3 convs,
ReLU, the 2x2x2 moment max-pool, the fused zero-interleave unpool + 2^3
conv, the [3,3]/[2,2] pad choreography, crop-concat skips (decoder channels
first) and the softmax-moment head. Parameters are ``{layer: {"w_mu":
[k,k,k,Cin,Cout], "w_sigma": [Cout]}}`` under the 2-D layer names, in the
JAX package's layouts, so a JAX checkpoint maps 1:1
(``checkpoint.params_from_jax``). ``ModelConfig.image_size`` is the cube
side; the output cube side follows from the geometry (64 -> 54 at depth 3,
``train3d.derive_out_size3d``). The flattened [B, D*H*W, C] outputs feed the
2-D loss head unchanged.

A second layer plan runs through the same functions: :class:`CicekConfig`,
the 3D U-Net of Cicek et al. (MICCAI 2016, arXiv:1606.06650, Fig. 1) as a
VDP network. Its encoder's second conv doubles the channels, its up-convs
keep them, and it pads nowhere: 132^3 -> 44^3 at depth 4, base 32
(:data:`CICEK3D`, 18 convs, 19,067,616 ``w_mu`` elements).

A third plan, :class:`SwinUNETRConfig` (:data:`SWINUNETR`), is Swin UNETR;
``forward3d``, ``init_params3d``, ``layer_names3d`` and ``stage_shapes3d``
hand it to ``models/swin_unetr3d.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from supernet_tpu_torch import tracing
from supernet_tpu_torch.configs import (
    CICEK3D,
    SWINUNETR,
    CicekConfig,
    ModelConfig,
    SwinUNETRConfig,
)
from supernet_tpu_torch.models import swin_unetr3d as swin
from supernet_tpu_torch.models.unet import _block_helpers, _identity, _tight_layers
from supernet_tpu_torch.ops import moments3d as M3
from supernet_tpu_torch.ops.moments import _per_member, glue_fold_active, lowering
from supernet_tpu_torch.ops.moments3d import (
    crop_center3d,
    vconv3d,
    vconv3d_input_relu,
    vconv3d_relu,
    vcrop_concat3d,
    vglue_conv3d_relu,
    vpad3d,
    vsoftmax3d,
    vunpool3d_conv2,
)

Tensor = torch.Tensor
Params = Dict[str, Dict[str, Tensor]]


def is_cicek(cfg: ModelConfig) -> bool:
    return isinstance(cfg, CicekConfig)


def is_swin(cfg: ModelConfig) -> bool:
    return isinstance(cfg, SwinUNETRConfig)


# the standard deviation of a unit normal cut at +-2
_TRUNC2_STD = 0.8796256610342398

# the experiments of the 3-D layer plans, by name (every 3-D command's
# ``--config`` offers them), and the config class of each plan
EXPERIMENTS3D = {CICEK3D.name: CICEK3D, SWINUNETR.name: SWINUNETR}
PLANS3D = {"supernet": ModelConfig, "cicek": CicekConfig, "swinunetr": SwinUNETRConfig}


def _cicek_layers(cfg: ModelConfig) -> List[Tuple[str, int, int, int]]:
    b, depth = cfg.base_kernels, cfg.depth
    names = [("conv_input", 3, cfg.in_channels, b), ("conv1", 3, b, 2 * b)]
    for i in range(1, depth):
        c = b * 2 ** i
        names += [(f"conv{2 * i}", 3, c, c), (f"conv{2 * i + 1}", 3, c, 2 * c)]
    ch = b * 2 ** depth
    for j in range(1, depth):
        c = b * 2 ** (depth - j)
        names += [(f"up{j}_conv2x2", 2, ch, ch), (f"up{j}_conv1", 3, ch + c, c),
                  (f"up{j}_conv2", 3, c, c)]
        ch = c
    names.append(("conv_final", 1, ch, cfg.n_classes))
    return names


def _decoder_pads(cfg: ModelConfig):
    """The pads before a decoder block's two convs: SUPER-Net's (3,3) and
    (2,2), none under the Cicek plan."""
    return (None, None) if is_cicek(cfg) else ((3, 3), (2, 2))


def layer_names3d(cfg: ModelConfig) -> List[Tuple[str, int, int, int]]:
    """Ordered (name, k, cin, cout) of every conv layer: the 2-D naming
    scheme with k^3 kernels, under the config's layer plan (under the Swin
    UNETR plan its layers with Gaussian weights, a linear k = 1)."""
    if is_swin(cfg):
        return swin.layer_names_swin(cfg)
    if is_cicek(cfg):
        return _cicek_layers(cfg)
    enc = [cfg.base_kernels * (2 ** i) for i in range(cfg.depth)]
    dec = [cfg.base_kernels * (2 ** (cfg.depth - 2 - j))
           for j in range(cfg.depth - 1)]
    names: List[Tuple[str, int, int, int]] = [
        ("conv_input", 3, cfg.in_channels, enc[0]),
        ("conv1", 3, enc[0], enc[0]),
    ]
    for i in range(1, cfg.depth):
        names.append((f"conv{2 * i}", 3, enc[i - 1], enc[i]))
        names.append((f"conv{2 * i + 1}", 3, enc[i], enc[i]))
    ch = enc[cfg.depth - 1]
    for j in range(1, cfg.depth):
        up = dec[j - 1]
        names.append((f"up{j}_conv2x2", 2, ch, up))
        names.append((f"up{j}_conv1", 3, up + enc[cfg.depth - 1 - j], up))
        names.append((f"up{j}_conv2", 3, up, up))
        ch = up
    names.append(("conv_final", 1, ch, cfg.n_classes))
    return names


def init_params3d(
    generator: torch.Generator, cfg: ModelConfig, device="cuda"
) -> Params:
    """The 2-D init scheme (``models.unet.init_params``) with k^3 kernels:
    TruncatedNormal(mean_mu, mean_sigma) cut at 2 std for w_mu, Uniform on
    the raw w_sigma (the tighter range on the leading decoder 2^3 convs and
    the head). Drawn on the CPU from ``generator``, then moved to
    ``device``; ``torch.Generator`` streams differ from ``jax.random``, so
    compare with the JAX init by distribution.

    Under the Cicek plan w_mu is the U-Net family's He init instead
    (Ronneberger et al. 2015, section 3: a Gaussian of std sqrt(2 / fan_in)),
    cut at 2 std and scaled so that std is the drawn weights' own;
    ``mean_mu`` and ``mean_sigma`` are then unused. The Swin UNETR plan
    takes ``models/swin_unetr3d.py:init_params_swin``."""
    if is_swin(cfg):
        return swin.init_params_swin(generator, cfg, device)
    params: Params = {}
    tight = _tight_layers(cfg)
    for name, k, cin, cout in layer_names3d(cfg):
        w_mu = torch.empty((k, k, k, cin, cout), dtype=torch.float32)
        mean, std = cfg.mean_mu, cfg.mean_sigma
        if is_cicek(cfg):
            mean, std = 0.0, math.sqrt(2.0 / (k ** 3 * cin)) / _TRUNC2_STD
        nn.init.trunc_normal_(
            w_mu, mean=mean, std=std, a=mean - 2.0 * std, b=mean + 2.0 * std,
            generator=generator,
        )
        lo, hi = (
            (cfg.tight_sigma_min, cfg.tight_sigma_max)
            if name in tight
            else (cfg.sigma_min, cfg.sigma_max)
        )
        w_sigma = torch.empty((cout,), dtype=torch.float32).uniform_(
            lo, hi, generator=generator
        )
        params[name] = {"w_mu": w_mu.to(device), "w_sigma": w_sigma.to(device)}
    return params


def kl_regularizer3d(params: Params) -> Tensor:
    """``models.unet.kl_regularizer`` with the KL strength equal to the
    kernel's spatial size, k^3:

      sum(w_mu^2) - k^3 * mean(1 + log softplus(ws) - softplus(ws))

    Member-stacked parameters (``w_mu`` [K,k,k,k,Cin,Cout]) give the K
    members' sums, [K]. Point parameters (entries without ``w_mu``: the
    Swin UNETR plan's norms and bias tables) have no KL term.
    """
    total = None
    for p in params.values():
        if "w_mu" not in p:
            continue
        w_mu, w_sigma = p["w_mu"], p["w_sigma"]
        strength = math.prod(w_mu.shape[-5:-2])
        f_s = F.softplus(w_sigma)
        if w_mu.dim() == 6:
            term = ((w_mu * w_mu).flatten(1).sum(1)
                    - strength * (1.0 + torch.log(f_s) - f_s).mean(-1))
        else:
            term = (w_mu * w_mu).sum() - strength * (1.0 + torch.log(f_s) - f_s).mean()
        total = term if total is None else total + term
    return total


def forward3d(
    params: Params, x: Tensor, cfg: ModelConfig, tap=None, constrain=None
) -> Tuple[Tensor, Tensor]:
    """Volume [B, S, S, S, Cin] -> (probs, sigma), both
    [B, out_size^3, n_classes].

    ``tap(stage_name, shape)`` is called with every stage's shape under the
    JAX forward's stage names; each conv runs under
    ``tracing.span(layer_name)``. ``constrain(m, s)`` is
    applied to the moment pair after ``conv1``, every encoder block, every
    pool and every decoder block, as in ``supernet_tpu/models/unet3d.py``.
    With ``cfg.remat`` and gradients enabled every encoder block after the
    first and every decoder block runs under ``torch.utils.checkpoint``
    (the 2-D forward's scheme).

    Deep ensembles: member-stacked ``params`` (every leaf [K, ...]) and ``x``
    [K,B,S,S,S,Cin] (``x.expand(K, *x.shape)`` for one shared batch) give
    [K, B, out^3, n_classes]. Each conv layer runs its members one after the
    other through cuDNN (the family has no hand-written kernel to take a
    member axis); the pools, pads, crops and the softmax see the members as
    part of the batch [K*B, ...].

    Under ``set_glue_fold("fold")`` the pre-padded bottleneck conv (where
    the config has one) and both convs of every decoder block run as
    ``ops.moments3d.vglue_conv3d_relu`` under their layer names and taps
    (``supernet_tpu/models/unet3d.py:118-175``); the naive backend ignores
    the fold (``unet3d.py:119``). Under the Cicek plan, which pads nowhere,
    the fold takes each decoder block's first conv with its skip (the
    crop-concatenation as a split of the kernel) and leaves the second
    conv as it is. The Swin UNETR plan runs
    ``models/swin_unetr3d.py:forward_swin`` (``tap`` but no ``constrain``)."""
    if is_swin(cfg):
        return swin.forward_swin(params, x, cfg, tap)
    depth = cfg.depth
    fill = cfg.sigma_fill
    glue_fold = glue_fold_active()
    if constrain is None:
        constrain = _identity
    _tap, block = _block_helpers(cfg, tap)

    def folded(pad, with_skip: bool = False):
        """The conv of ``layer`` as ``vglue_conv3d_relu`` after a ``pad``
        (and the crop-concatenation of the skip moments)."""
        if with_skip:
            return lambda m, s, m_e, s_e, w_mu, w_sigma: vglue_conv3d_relu(
                m, s, w_mu, w_sigma, pad, fill, m_e, s_e)
        return lambda m, s, w_mu, w_sigma: vglue_conv3d_relu(m, s, w_mu, w_sigma, pad, fill)

    def layer(fn, name: str, *moments):
        p = params[name]
        with tracing.span(name):
            if p["w_mu"].dim() == 6:
                m, s = _per_member(fn, moments, p["w_mu"], p["w_sigma"])
            else:
                m, s = fn(*moments, p["w_mu"], p["w_sigma"])
        _tap(name, m)
        return m, s

    def encoder_block(i: int, m: Tensor, s: Tensor) -> Tuple[Tensor, Tensor]:
        if i == depth - 1 and cfg.bottleneck_pre_pad is not None:
            if glue_fold:
                m, s = layer(folded(cfg.bottleneck_pre_pad), f"conv{2 * i}", m, s)
                return layer(vconv3d_relu, f"conv{2 * i + 1}", m, s)
            m, s = vpad3d(m, s, cfg.bottleneck_pre_pad, fill)
            _tap("pre_pad", m)
        m, s = layer(vconv3d_relu, f"conv{2 * i}", m, s)
        return layer(vconv3d_relu, f"conv{2 * i + 1}", m, s)

    pad1, pad2 = _decoder_pads(cfg)

    def decoder_block(j, m, s, m_e, s_e) -> Tuple[Tensor, Tensor]:
        m, s = layer(vunpool3d_conv2, f"up{j}_conv2x2", m, s)
        if glue_fold:
            m, s = layer(folded(pad1 or (0, 0), True), f"up{j}_conv1", m, s, m_e, s_e)
            if pad2 is None:
                return layer(vconv3d_relu, f"up{j}_conv2", m, s)
            return layer(folded(pad2), f"up{j}_conv2", m, s)
        if pad1 is not None:
            m, s = vpad3d(m, s, pad1, fill)
        m, s = vcrop_concat3d(m, s, m_e, s_e)
        _tap(f"up{j}_concat", m)
        m, s = layer(vconv3d_relu, f"up{j}_conv1", m, s)
        if pad2 is not None:
            m, s = vpad3d(m, s, pad2, fill)
        return layer(vconv3d_relu, f"up{j}_conv2", m, s)

    skips: List[Tuple[Tensor, Tensor]] = []
    m, s = layer(vconv3d_input_relu, "conv_input", x)
    m, s = layer(vconv3d_relu, "conv1", m, s)
    m, s = constrain(m, s)
    for i in range(depth):
        if i > 0:
            m, s = block(encoder_block, i, m, s)
            m, s = constrain(m, s)
        if i < depth - 1:
            skips.append((m, s))
            # through the module attribute: the replay seam of moments3d
            m, s = M3.vmaxpool3d(m, s)
            _tap(f"pool{i}", m)
            m, s = constrain(m, s)

    for j in range(1, depth):
        m_e, s_e = skips[depth - 1 - j]
        m, s = block(decoder_block, j, m, s, m_e, s_e)
        m, s = constrain(m, s)

    m, s = layer(vconv3d, "conv_final", m, s)
    probs, sigma = vsoftmax3d(m, s)
    if x.dim() == 6:
        return probs.unflatten(0, x.shape[:2]), sigma.unflatten(0, x.shape[:2])
    return probs, sigma


def forward_sampled3d(
    weights: Dict[str, Tensor], x: Tensor, cfg: ModelConfig
) -> Tensor:
    """Deterministic twin of :func:`forward3d`: one ordinary 3-D U-Net pass
    with concrete DHWIO kernels (``models.sample_weights`` draws them);
    returns the softmax probabilities [B, out_size^3, n_classes]. Mapped
    over N weight draws it is the Monte-Carlo ensemble whose (mean,
    variance) the propagated moments approximate. The pool is the max over
    SAME-padded 2x2x2 windows. Either layer plan."""
    depth = cfg.depth

    def conv(name: str, h: Tensor) -> Tensor:
        return M3._conv3d_valid(h, weights[name])

    def conv_relu(name: str, h: Tensor) -> Tensor:
        return F.relu(conv(name, h))

    def pad(h: Tensor, p) -> Tensor:
        lo, hi = (p, p) if isinstance(p, int) else p
        return F.pad(h, (0, 0, lo, hi, lo, hi, lo, hi))

    def pool(h: Tensor) -> Tensor:
        h, _ = M3._pad_even(h, h)
        return M3._pool_view(h).amax(dim=(2, 4, 6))

    skips: List[Tensor] = []
    h = conv_relu("conv_input", x)
    h = conv_relu("conv1", h)
    for i in range(depth):
        if i > 0:
            if i == depth - 1 and cfg.bottleneck_pre_pad is not None:
                h = pad(h, cfg.bottleneck_pre_pad)
            h = conv_relu(f"conv{2 * i}", h)
            h = conv_relu(f"conv{2 * i + 1}", h)
        if i < depth - 1:
            skips.append(h)
            h = pool(h)
    pad1, pad2 = _decoder_pads(cfg)
    for j in range(1, depth):
        h = conv(f"up{j}_conv2x2", M3._unpool3d_one(h))
        if pad1 is not None:
            h = pad(h, pad1)
        enc = skips[depth - 1 - j]
        d, hh, w = h.shape[1:4]
        h = torch.cat([h, crop_center3d(enc, d, hh, w)], dim=-1)
        h = conv_relu(f"up{j}_conv1", h)
        if pad2 is not None:
            h = pad(h, pad2)
        h = conv_relu(f"up{j}_conv2", h)
    h = conv("conv_final", h)
    b, c = h.shape[0], h.shape[-1]
    return torch.softmax(h.reshape(b, -1, c), dim=-1)


def stage_shapes3d(cfg: ModelConfig) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """``(stage name, output shape)`` (batch 1) of every stage of one
    :func:`forward3d`, in order: the forward run on the ``meta`` device,
    which computes shapes and no values (the JAX package traces
    ``jax.eval_shape``), with the decoder glue explicit. Raises where the
    geometry collapses."""
    import dataclasses

    cfg = dataclasses.replace(cfg, remat=False)
    if is_swin(cfg):
        shapes = swin.param_shapes(cfg)
    else:
        shapes = {name: {"w_mu": (k, k, k, cin, cout), "w_sigma": (cout,)}
                  for name, k, cin, cout in layer_names3d(cfg)}
    params = {name: {key: torch.empty(shape, device="meta") for key, shape in p.items()}
              for name, p in shapes.items()}
    s = cfg.image_size
    x = torch.empty((1, s, s, s, cfg.in_channels), device="meta")
    stages = []
    with torch.no_grad(), lowering(glue_fold="none"):
        forward3d(params, x, cfg, tap=lambda name, shape: stages.append((name, shape)))
    return tuple(stages)
