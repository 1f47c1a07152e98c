"""Moment propagation through the layers of a shifted-window transformer
and of its residual CNN blocks, on NDHWC moments: what the Swin UNETR plan
(``models/swin_unetr3d.py``) needs beside ``ops/moments3d.py``.

Every layer is first-order, as SUPER-Net's are: the mean goes through the
deterministic layer, the diagonal variance through its Jacobian at the mean.

  norm          statistics m, s = sqrt(v + eps) of mu over the normalised
                axis (N elements), x = (mu - m) / s:
                  mu'    = gamma x + beta
                  sigma' = (gamma / s)^2 [sigma (1 - 2 (1 + x^2) / N)
                                          + (A + 2 x B + x^2 D) / N^2]
                with A, B, D the sums of sigma, x sigma, x^2 sigma over the
                axis (the diagonal of J diag(sigma) J^T, exactly).
                LayerNorm over channels, InstanceNorm over D*H*W.
  GELU (erf)    mu' = gelu(mu), sigma' = (Phi(mu) + mu phi(mu))^2 sigma
  LeakyReLU     sigma' = sigma where mu > 0, else slope^2 sigma
  residual      means add, variances add
  attention     per window and head, q scaled by d^-1/2 (sigma by 1/d):
                  mu_S    = mu_Q mu_K^T + bias + mask
                  sigma_S = sigma_Q (mu_K^2 + sigma_K)^T + mu_Q^2 sigma_K^T
                  P, sigma_P: ``vsoftmax`` along the keys
                  mu_O    = P mu_V
                  sigma_O = sigma_P (mu_V^2 + sigma_V) + P^2 sigma_V
                six batched products where a deterministic attention has two

Window partition, cyclic shift, padding to whole windows and the patch
merge's sub-grids are layout and move both moments alike. The layers with
Gaussian weights (linears, convs) are ``ops/moments3d.py``'s ``vconv3d``;
a linear is its k == 1 case on [B, D, H, W, C] tokens.

Counters (``tracing.count``): ``moments.norms`` per normalisation,
``moments.norms_fused`` per normalisation whose forward kernels launched
(``ops/kernels/vdp_norm.py``: every one on the card), ``swin.windows`` per
window computed (padded ones included) and ``swin.attention_products`` 6 per
attention.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from supernet_tpu_torch import tracing
from supernet_tpu_torch.ops.kernels.vdp_norm import VNorm
from supernet_tpu_torch.ops.moments import vsoftmax

Tensor = torch.Tensor
MomentPair = Tuple[Tensor, Tensor]

NORM_EPS = 1e-5  # LayerNorm's and InstanceNorm3d's
LEAKY_SLOPE = 0.01
MASK_VALUE = -100.0  # added to the scores of a token pair from two shift regions


def vnorm(mu: Tensor, sigma: Tensor, dims: Sequence[int],
          gamma: Optional[Tensor] = None, beta: Optional[Tensor] = None,
          eps: float = NORM_EPS) -> MomentPair:
    """Normalisation of ``mu`` over ``dims`` by its own (biased) statistics,
    then ``gamma``, ``beta`` where given; the variance through the
    normalisation's Jacobian in closed form (the module's docstring), and
    its gradient in closed form (``ops/kernels/vdp_norm.py:VNorm``: the
    kernel pair for CUDA tensors, the plain version for CPU tensors)."""
    tracing.count("moments.norms")
    return VNorm.apply(mu, sigma, gamma, beta, tuple(dims), eps)


def vlayer_norm(mu: Tensor, sigma: Tensor, gamma: Optional[Tensor] = None,
                beta: Optional[Tensor] = None) -> MomentPair:
    """LayerNorm over the channels of every token."""
    return vnorm(mu, sigma, (-1,), gamma, beta)


def vinstance_norm3d(mu: Tensor, sigma: Tensor) -> MomentPair:
    """InstanceNorm3d without affine: each channel of each volume over D*H*W."""
    return vnorm(mu, sigma, (1, 2, 3))


def vgelu(mu: Tensor, sigma: Tensor) -> MomentPair:
    """GELU (the erf form) with sigma through its derivative,
    Phi(mu) + mu phi(mu)."""
    cdf = 0.5 * (1.0 + torch.erf(mu * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * mu * mu) * (1.0 / math.sqrt(2.0 * math.pi))
    g = cdf + mu * pdf
    return F.gelu(mu), g * g * sigma


def vleaky_relu(mu: Tensor, sigma: Tensor, slope: float = LEAKY_SLOPE) -> MomentPair:
    keep = mu > 0
    return F.leaky_relu(mu, slope), torch.where(keep, sigma, sigma * (slope * slope))


def vadd(a: MomentPair, b: MomentPair) -> MomentPair:
    """The residual sum: means add, variances add."""
    return a[0] + b[0], a[1] + b[1]


# --------------------------------------------------------------- windows


def window_and_shift(side: int, window: int, shift: int) -> Tuple[int, int]:
    """The window and shift a cube of ``side`` takes: a side that fits in
    one window is the window, with no shift."""
    return (side, 0) if side <= window else (window, shift)


def _partition(x: Tensor, ws: int) -> Tensor:
    """[B, D, H, W, *rest] (sides multiples of ``ws``) -> [B, nW, ws^3, *rest],
    windows in (d, h, w) row-major order, tokens likewise inside each."""
    b, d, h, w = x.shape[:4]
    rest = x.shape[4:]
    x = x.reshape(b, d // ws, ws, h // ws, ws, w // ws, ws, *rest)
    tail = tuple(range(7, x.dim()))
    x = x.permute(0, 1, 3, 5, 2, 4, 6, *tail)
    return x.reshape(b, -1, ws ** 3, *rest)


def relative_position_index(window: int, n: int, device) -> Tensor:
    """The [n, n] rows of the bias table each token pair of a ``window``^3
    window reads (3-D Swin's index, cut to the first n tokens where the
    window has shrunk)."""
    r = torch.arange(window, device=device)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    m = 2 * window - 1
    return ((rel[0] * m + rel[1]) * m + rel[2])[:n, :n]


def shift_mask(side: int, ws: int, shift: int, device) -> Tensor:
    """[nW, n, n]: ``MASK_VALUE`` between two tokens of a window that come
    from different regions of the cyclically shifted cube of padded
    ``side``, else 0."""
    ids = torch.zeros((1, side, side, side), device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for k, (a, b, c) in enumerate(itertools.product(cuts, repeat=3)):
        ids[:, a, b, c] = float(k)
    win = _partition(ids, ws)[0]
    return torch.where(win[:, None, :] != win[:, :, None], MASK_VALUE, 0.0)


class SoftmaxMoments(torch.autograd.Function):
    """``vsoftmax`` along the last axis (the class head's closed form),
    saving only ``p`` and the input variance for the backward (autograd of
    the closed form would keep five score-sized tensors)."""

    @staticmethod
    def forward(ctx, mu, sigma):
        p, s_out = vsoftmax(mu, sigma, axis=-1)
        ctx.save_for_backward(p, sigma)
        return p, s_out

    @staticmethod
    def backward(ctx, g_p, g_s):
        p, sigma = ctx.saved_tensors
        if g_p is None:
            g_p = torch.zeros_like(p)
        if g_s is None:
            g_s = torch.zeros_like(p)
        a = p * p
        t = (a * sigma).sum(-1, keepdim=True)
        u = (g_s * a).sum(-1, keepdim=True)
        g_sigma = a * ((1.0 - 2.0 * p) * g_s + u)
        g_pt = g_p + 2.0 * p * (g_s * ((1.0 - 3.0 * p) * sigma + t) + sigma * u)
        g_mu = p * (g_pt - (p * g_pt).sum(-1, keepdim=True))
        return g_mu, g_sigma


def score_moments(qm: Tensor, qs: Tensor, km: Tensor, ks: Tensor) -> MomentPair:
    """``Q K^T`` of independent Gaussian entries ([..., n, d] each), its
    variance exact: ``sigma_Q (mu_K^2 + sigma_K)^T + mu_Q^2 sigma_K^T``."""
    kt = km.transpose(-1, -2)
    return qm @ kt, qs @ (km * km + ks).transpose(-1, -2) + (qm * qm) @ ks.transpose(-1, -2)


def value_moments(p: Tensor, sp: Tensor, vm: Tensor, vs: Tensor) -> MomentPair:
    """``P V`` of independent Gaussian entries, its variance exact:
    ``sigma_P (mu_V^2 + sigma_V) + mu_P^2 sigma_V``."""
    return p @ vm, sp @ (vm * vm + vs) + (p * p) @ vs


def window_attention(mu: Tensor, sigma: Tensor, heads: int, window: int, shift: int,
                     table: Tensor) -> MomentPair:
    """Shifted-window self-attention of the qkv moments [B, D, H, W, 3C]
    (channels as (3, heads, C/heads)), the tokens zero-padded at the high
    end to whole windows and rolled back by ``shift``; returns the heads'
    output moments [B, D, H, W, C] before ``proj``. ``table``
    [(2 window - 1)^3, heads] is the relative-position bias (a point
    parameter: the mean alone). Padding the qkv moments is padding the
    normalised tokens before the qkv linear, as MONAI does: without a bias
    the linear gives a zero token zero moments."""
    b, d, h, w, c3 = mu.shape
    c = c3 // 3
    hd = c // heads
    ws, shift = window_and_shift(d, window, shift)
    side = -(-d // ws) * ws
    pad = (0, 0, 0, side - w, 0, side - h, 0, side - d)
    mu, sigma = F.pad(mu, pad), F.pad(sigma, pad)
    if shift:
        mu = torch.roll(mu, (-shift,) * 3, (1, 2, 3))
        sigma = torch.roll(sigma, (-shift,) * 3, (1, 2, 3))
    n = ws ** 3
    n_win = (side // ws) ** 3
    tracing.count("swin.windows", b * n_win)
    tracing.count("swin.attention_products", 6)

    def heads_of(t: Tensor) -> Tensor:  # [3, B, nW, heads, n, hd]
        t = _partition(t.reshape(b, side, side, side, 3, heads, hd), ws)
        return t.permute(3, 0, 1, 4, 2, 5)

    qm, km, vm = heads_of(mu)
    qs, ks, vs = heads_of(sigma)
    scale = hd ** -0.5
    qm = qm * scale
    qs = qs * (scale * scale)
    bias = table[relative_position_index(window, n, table.device).reshape(-1)]
    mu_s, sigma_s = score_moments(qm, qs, km, ks)
    mu_s = mu_s + bias.reshape(n, n, heads).permute(2, 0, 1)
    if shift:
        mu_s = mu_s + shift_mask(side, ws, shift, mu.device)[:, None]
    mu_o, sigma_o = value_moments(*SoftmaxMoments.apply(mu_s, sigma_s), vm, vs)

    def merged(t: Tensor) -> Tensor:  # [B, nW, heads, n, hd] -> [B, D, H, W, C]
        g = side // ws
        t = t.reshape(b, g, g, g, heads, ws, ws, ws, hd)
        t = t.permute(0, 1, 5, 2, 6, 3, 7, 4, 8).reshape(b, side, side, side, c)
        if shift:
            t = torch.roll(t, (shift,) * 3, (1, 2, 3))
        return t[:, :d, :h, :w]

    return merged(mu_o), merged(sigma_o)


def patch_grids(mu: Tensor, sigma: Tensor) -> MomentPair:
    """The patch merge's layout: the eight 2x2x2 sub-grids of each moment
    (odd sides zero-padded at the high end), concatenated on channels in
    ``itertools.product`` order: [B, D/2, H/2, W/2, 8C]."""
    def grids(x: Tensor) -> Tensor:
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        return torch.cat([x[:, i::2, j::2, k::2]
                          for i, j, k in itertools.product(range(2), repeat=3)], -1)

    return grids(mu), grids(sigma)
