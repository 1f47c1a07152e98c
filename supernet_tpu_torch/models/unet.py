"""The VDP U-Net in PyTorch, parameterized over depth: the counterpart of
``supernet_tpu/models/unet.py``.

Parameters are a flat dict ``{layer: {"w_mu": [k,k,Cin,Cout], "w_sigma":
[Cout]}}`` with the reference's layer names, in the JAX package's layouts,
so a JAX checkpoint maps 1:1 (``checkpoint.params_from_jax``). ``forward``
is a plain function of (params, x); ``VDPUNet`` is the ``nn.Module`` that
holds the same tensors.

Block choreography (`Hippocampus.py:373-421`, `Brats.py:323-457`):
  encoder block i:  [pre-pad?] conv3+relu -> conv3+relu -> [pool if i<d]
  decoder block j:  unpool+conv2 -> pad(3,3) -> concat(skip) ->
                    conv3+relu -> pad(2,2) -> conv3+relu
  head:             conv1x1 -> vsoftmax  (flattened [B, H*W, C] outputs)
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from supernet_tpu_torch import tracing
from supernet_tpu_torch.configs import ModelConfig
from supernet_tpu_torch.ops import (
    crop_center,
    vconv,
    vconv_input_relu,
    vconv_relu,
    vcrop_concat,
    vglue_conv_relu,
    vmaxpool,
    vpad,
    vsoftmax,
    vunpool_conv2,
)
from supernet_tpu_torch.ops.moments import _unpool_one, glue_fold_active

Tensor = torch.Tensor
Params = Dict[str, Dict[str, Tensor]]


def layer_names(cfg: ModelConfig) -> List[Tuple[str, int, int, int]]:
    """Ordered (name, ksize, c_in, c_out) of every conv layer: encoder
    ``conv_input, conv1, conv2, ...`` (two per block), decoder
    ``up{j}_conv2x2 / up{j}_conv1 / up{j}_conv2``, head ``conv_final``."""
    enc = [cfg.base_kernels * (2 ** i) for i in range(cfg.depth)]
    dec = [cfg.base_kernels * (2 ** (cfg.depth - 2 - j))
           for j in range(cfg.depth - 1)]
    out: List[Tuple[str, int, int, int]] = []
    c_prev = cfg.in_channels
    for i, c in enumerate(enc):
        out.append(("conv_input" if i == 0 else f"conv{2 * i}", 3, c_prev, c))
        out.append((f"conv{2 * i + 1}", 3, c, c))
        c_prev = c
    for j, c in enumerate(dec, start=1):
        out.append((f"up{j}_conv2x2", 2, c_prev, c))
        out.append((f"up{j}_conv1", 3, 2 * c, c))  # after the skip concat
        out.append((f"up{j}_conv2", 3, c, c))
        c_prev = c
    out.append(("conv_final", 1, c_prev, cfg.n_classes))
    return out


def _tight_layers(cfg: ModelConfig) -> set:
    """Layers whose raw w_sigma is drawn from the tighter range: the first
    ``tight_upconvs`` decoder 2x2 convs and the 1x1 head."""
    names = {f"up{j}_conv2x2" for j in range(1, cfg.tight_upconvs + 1)}
    names.add("conv_final")
    return names


def init_params(
    generator: torch.Generator, cfg: ModelConfig, device="cuda"
) -> Params:
    """TruncatedNormal(mean_mu, mean_sigma), cut at 2 std, for w_mu and
    Uniform on the raw w_sigma (`Hippocampus.py:109-123`).

    Values are drawn on the CPU from ``generator`` (a CPU generator) and
    then moved to ``device``, so one seed gives the same weights on every
    device. ``torch.Generator`` streams differ from ``jax.random``: compare
    with the JAX init by distribution, not value.
    """
    params: Params = {}
    tight = _tight_layers(cfg)
    for name, k, cin, cout in layer_names(cfg):
        w_mu = torch.empty((k, k, cin, cout), dtype=torch.float32)
        nn.init.trunc_normal_(
            w_mu,
            mean=cfg.mean_mu,
            std=cfg.mean_sigma,
            a=cfg.mean_mu - 2.0 * cfg.mean_sigma,
            b=cfg.mean_mu + 2.0 * cfg.mean_sigma,
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


def kl_regularizer(params: Params) -> Tensor:
    """Sum of the per-layer weight regularizers (the reference's
    ``tf.math.add_n(model.losses)``):

      l2:  sum(w_mu^2);   KL:  -k^2 * mean(1 + log softplus(ws) - softplus(ws))

    Member-stacked parameters (``w_mu`` [K,k,k,Cin,Cout]) give the K
    members' sums, [K]."""
    total = None
    for p in params.values():
        w_mu, w_sigma = p["w_mu"], p["w_sigma"]
        k = w_mu.shape[-3]
        f_s = torch.nn.functional.softplus(w_sigma)
        if w_mu.dim() == 5:
            term = ((w_mu * w_mu).flatten(1).sum(1)
                    - (k * k) * (1.0 + torch.log(f_s) - f_s).mean(-1))
        else:
            term = (w_mu * w_mu).sum() - (k * k) * (1.0 + torch.log(f_s) - f_s).mean()
        total = term if total is None else total + term
    return total


def forward(
    params: Params, x: Tensor, cfg: ModelConfig, tap=None, constrain=None
) -> Tuple[Tensor, Tensor]:
    """Full VDP forward pass: image [B,H,W,Cin] -> (probs, sigma), both
    flattened to [B, H_out*W_out, n_classes].

    Deep ensembles: with member-stacked ``params`` (every leaf [K, ...]) and
    ``x`` [K,B,H,W,Cin] (``x.expand(K, *x.shape)`` for one batch that every
    member reads) the K members run together, every kernel once per layer
    for all of them, and the outputs are [K, B, H_out*W_out, n_classes]: the
    counterpart of ``jax.vmap(forward)`` over a stacked tree.

    ``tap(stage_name, shape)``, when given, is called with every
    intermediate's shape, under the JAX forward's stage names. Each conv
    runs under ``tracing.span(layer_name)``.

    ``constrain(m, s) -> (m, s)``, when given, is applied to the moment pair
    after ``conv1``, after every encoder block, every pool and every decoder
    block: the call sites of the JAX forward's hook
    (``supernet_tpu/models/unet.py:146-273``), where a spatially sharded
    forward re-pins its layout.

    With ``cfg.remat`` and gradients enabled, every encoder block after the
    first and every decoder block runs under a non-reentrant
    ``torch.utils.checkpoint``: only the block's inputs stay live and the
    backward pass runs the block's forward again (its forward kernels are
    launched twice per step). ``tap`` is called in the first pass only.

    Under ``set_glue_fold("fold")`` the BraTS bottleneck's pre-padded conv
    and both convs of every decoder block run as ``vglue_conv_relu`` (the
    pad, crop and concatenation computed inside PyTorch's convs), under
    their layer names and taps, as ``supernet_tpu/models/unet.py:166-240``
    dispatches them; kernel 1 then runs only the other k=3 convs. The naive
    backend (``ops.set_backend("naive")``) ignores the fold, as
    ``supernet_tpu/models/unet.py:170`` does.
    """
    depth = cfg.depth
    fill = cfg.sigma_fill
    glue_fold = glue_fold_active()
    if constrain is None:
        constrain = _identity
    _tap, block = _block_helpers(cfg, tap)

    def layer(fn, name: str, *moments):
        p = params[name]
        with tracing.span(name):
            m, s = fn(*moments, p["w_mu"], p["w_sigma"])
        _tap(name, m)
        return m, s

    def folded(pad, with_skip: bool = False):
        """The conv of ``layer`` as ``vglue_conv_relu`` after a ``pad``
        (and the crop-concatenation of the skip moments)."""
        if with_skip:
            return lambda m, s, m_e, s_e, w_mu, w_sigma: vglue_conv_relu(
                m, s, w_mu, w_sigma, pad, fill, m_e, s_e)
        return lambda m, s, w_mu, w_sigma: vglue_conv_relu(m, s, w_mu, w_sigma, pad, fill)

    def encoder_block(i: int, m: Tensor, s: Tensor) -> Tuple[Tensor, Tensor]:
        if i == depth - 1 and cfg.bottleneck_pre_pad is not None:
            if glue_fold:
                m, s = layer(folded(cfg.bottleneck_pre_pad), f"conv{2 * i}", m, s)
                return layer(vconv_relu, f"conv{2 * i + 1}", m, s)
            m, s = vpad(m, s, cfg.bottleneck_pre_pad, fill)
            _tap("pre_pad", m)
        m, s = layer(vconv_relu, f"conv{2 * i}", m, s)
        return layer(vconv_relu, f"conv{2 * i + 1}", m, s)

    def decoder_block(j, m, s, m_e, s_e) -> Tuple[Tensor, Tensor]:
        m, s = layer(vunpool_conv2, f"up{j}_conv2x2", m, s)
        if glue_fold:
            m, s = layer(folded((3, 3), True), f"up{j}_conv1", m, s, m_e, s_e)
            return layer(folded((2, 2)), f"up{j}_conv2", m, s)
        m, s = vpad(m, s, (3, 3), fill)
        _tap(f"up{j}_pad", m)
        m, s = vcrop_concat(m, s, m_e, s_e)
        _tap(f"up{j}_concat", m)
        m, s = layer(vconv_relu, f"up{j}_conv1", m, s)
        m, s = vpad(m, s, (2, 2), fill)
        _tap(f"up{j}_pad2", m)
        return layer(vconv_relu, f"up{j}_conv2", m, s)

    skips: List[Tuple[Tensor, Tensor]] = []
    m, s = layer(vconv_input_relu, "conv_input", x)
    m, s = layer(vconv_relu, "conv1", m, s)
    m, s = constrain(m, s)
    for i in range(depth):
        if i > 0:
            m, s = block(encoder_block, i, m, s)
            m, s = constrain(m, s)
        if i < depth - 1:
            skips.append((m, s))
            m, s = vmaxpool(m, s)
            _tap(f"pool{i}", m)
            m, s = constrain(m, s)

    for j in range(1, depth):
        m_e, s_e = skips[depth - 1 - j]
        m, s = block(decoder_block, j, m, s, m_e, s_e)
        m, s = constrain(m, s)

    m, s = layer(vconv, "conv_final", m, s)
    probs, sigma = vsoftmax(m, s)
    if x.dim() == 5:
        return probs.unflatten(0, x.shape[:2]), sigma.unflatten(0, x.shape[:2])
    return probs, sigma


def _identity(m: Tensor, s: Tensor) -> Tuple[Tensor, Tensor]:
    return m, s


def _block_helpers(cfg: ModelConfig, tap):
    """``(_tap, block)`` of a forward: ``_tap(name, m)`` reports a stage's
    shape to ``tap`` in the first pass only; ``block(fn, idx, *moments)``
    runs ``fn`` under a non-reentrant ``torch.utils.checkpoint`` when
    ``cfg.remat`` is on and gradients are enabled."""
    remat = cfg.remat and torch.is_grad_enabled()
    recomputing = [False]

    def _tap(name: str, m: Tensor) -> None:
        if tap is not None and not recomputing[0]:
            tap(name, tuple(m.shape))

    def block(fn, idx: int, *moments):
        if not remat:
            return fn(idx, *moments)
        passes = []

        def run(*ms):
            recomputing[0] = bool(passes)
            passes.append(None)
            try:
                return fn(idx, *ms)
            finally:
                recomputing[0] = False

        return checkpoint(
            run, *moments, use_reentrant=False, preserve_rng_state=False
        )

    return _tap, block


def sample_weights(params: Params, generator: torch.Generator) -> Dict[str, Tensor]:
    """One draw from the weight posterior: ``w ~ N(w_mu, softplus(w_sigma))``
    per conv layer, the per-output-channel variance broadcast over the
    kernel. The noise is drawn from ``generator`` on its own device and
    moved to the weights'; feed the result to :func:`forward_sampled`.
    ``torch.Generator`` streams differ from ``jax.random``: compare with the
    JAX twin by distribution."""
    out: Dict[str, Tensor] = {}
    with torch.no_grad():
        for name, p in params.items():
            w_mu = p["w_mu"]
            eps = torch.randn(
                w_mu.shape, generator=generator, dtype=w_mu.dtype,
                device=generator.device,
            ).to(w_mu.device)
            out[name] = w_mu + torch.sqrt(F.softplus(p["w_sigma"])) * eps
    return out


def forward_sampled(weights: Dict[str, Tensor], x: Tensor, cfg: ModelConfig) -> Tensor:
    """Deterministic twin of :func:`forward`: one ordinary U-Net pass with
    concrete HWIO kernels (e.g. from :func:`sample_weights`); returns the
    softmax probabilities [B, H_out*W_out, n_classes].

    The architecture the moment propagation models: VALID convs, relu,
    2x2/2 max pool padded at the high end on odd sizes, zero-interleave
    unpool + 2x2 conv, the [3,3]/[2,2] pad choreography and crop-concat
    skips with the decoder channels first. Its convolutions are PyTorch's
    own (the JAX twin's are XLA's), at the precision of
    ``set_mxu_precision``."""
    depth = cfg.depth

    def conv(name: str, h: Tensor) -> Tensor:
        # NHWC activations and HWIO kernels through conv2d's NCHW / OIHW
        w = weights[name].permute(3, 2, 0, 1)
        return F.conv2d(h.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)

    def conv_relu(name: str, h: Tensor) -> Tensor:
        return F.relu(conv(name, h))

    def pad(h: Tensor, p) -> Tensor:
        lo, hi = (p, p) if isinstance(p, int) else p
        return F.pad(h, (0, 0, lo, hi, lo, hi))

    def pool(h: Tensor) -> Tensor:
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
        return h.permute(0, 2, 3, 1)

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
    for j in range(1, depth):
        h = conv(f"up{j}_conv2x2", _unpool_one(h))
        h = pad(h, (3, 3))
        enc = skips[depth - 1 - j]
        h = torch.cat([h, crop_center(enc, h.shape[1], h.shape[2])], dim=-1)
        h = conv_relu(f"up{j}_conv1", h)
        h = pad(h, (2, 2))
        h = conv_relu(f"up{j}_conv2", h)
    h = conv("conv_final", h)
    b, hh, ww, c = h.shape
    return torch.softmax(h.reshape(b, hh * ww, c), dim=-1)


def forward_images(params: Params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Forward pass returning image-shaped [B, H_out, W_out, C] moments."""
    probs, sigma = forward(params, x, cfg)
    b = x.shape[0]
    side = math.isqrt(probs.shape[1])
    return (
        probs.reshape(b, side, side, cfg.n_classes),
        sigma.reshape(b, side, side, cfg.n_classes),
    )


class _Layer(nn.Module):
    def __init__(self, w_mu: Tensor, w_sigma: Tensor):
        super().__init__()
        self.w_mu = nn.Parameter(w_mu)
        self.w_sigma = nn.Parameter(w_sigma)


class VDPUNet(nn.Module):
    """The VDP U-Net as an ``nn.Module``: one ``w_mu``/``w_sigma`` pair per
    layer name, initialized by :func:`init_params` from ``generator`` and
    held on ``device``. ``model(x)`` is :func:`forward`."""

    def __init__(self, cfg: ModelConfig, device, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleDict(
            {
                name: _Layer(p["w_mu"], p["w_sigma"])
                for name, p in init_params(generator, cfg, device).items()
            }
        )

    def params(self) -> Params:
        """The parameters as the dict :func:`forward` takes."""
        return {
            name: {"w_mu": mod.w_mu, "w_sigma": mod.w_sigma}
            for name, mod in self.layers.items()
        }

    @torch.no_grad()
    def load_jax_params(self, params_np) -> None:
        """Copy a JAX-layout parameter dict (numpy or JAX arrays) in."""
        for name, mod in self.layers.items():
            for attr in ("w_mu", "w_sigma"):
                src = torch.as_tensor(
                    np.array(params_np[name][attr]), dtype=torch.float32
                )
                dst = getattr(mod, attr)
                if src.shape != dst.shape:
                    raise ValueError(
                        f"{name}/{attr}: shape {tuple(src.shape)}, expected "
                        f"{tuple(dst.shape)}"
                    )
                dst.copy_(src)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return forward(self.params(), x, self.cfg)

    @property
    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
