"""3-D VDP moment primitives in PyTorch: the counterpart of
``supernet_tpu/ops/moments3d.py``, its default path, with gradients.

The same algebra as ``ops/moments.py`` one rank up, on NDHWC moments and
DHWIO kernels: every variance term of a Bayesian conv stays a convolution
(``sigma = winsum3d(mu^2 + sigma) * s_w + conv3d(sigma, w_mu^2)``), the ReLU
is the 2-D ``vrelu``, the max-pool is the 2x2x2 first-occurrence argmax of
mu with sigma gathered at the same tap, the unpool is the zero-interleave
with a 1-voxel border on every spatial axis.

The JAX package runs this family on XLA alone, with no Pallas kernel and no
custom VJP (``supernet_tpu/ops/moments3d.py:22-25``), so the port runs it on
PyTorch's own ops: cuDNN ``conv3d`` for both moment products of a k > 1
conv (the NDHWC moments enter it as ``torch.channels_last_3d`` views, no
copy), matrix products for the 1x1x1 head and the fused unpool conv, and
elementwise ops for the rest. None of the hand-written kernels of
``ops/kernels`` runs here. Their gradients are PyTorch's autograd, as they
are XLA's AD in the JAX package, except the pool's, whose backward is
written out (:class:`VMaxPool3d`): the parity rule of
``supernet_tpu/ops/moments3d.py:300-321`` routes each gradient to the one
tap the forward chose, where autograd of a max would split a tie.

Activation dtype: the casts of the 2-D module (``_act`` on the moments
entering a conv and on its outputs, channel sums in float32), so
``ops.set_act_dtype`` covers both families; ``ops.set_mxu_precision``
('highest', TF32 off) covers ``conv3d`` as it does every PyTorch conv.

Two module attributes are the seams a caller may replace to replay the
discrete choices of another run (``chip_smoke.py`` does, to hold the card's
gradients against the CPU's with the card's ReLU masks and pool taps): every
ReLU of the family goes through the module's ``vrelu`` and every pool
through ``VMaxPool3d.apply``.

The JAX module's A/B lowerings run here on every device, since the family
has no hand-written kernel: ``set_conv3d_impl("im2col")`` (the k > 1 moment
products as one matrix product of the k^3 taps concatenated,
``torch.matmul``, as the JAX module's is an XLA einsum), the 2-D module's
``winsum``, ``chansum`` and ``sw_scale`` knobs, and the decoder's glue fold
:func:`vglue_conv3d_relu` (``set_glue_fold``, dispatched by
``models/unet3d.py``). The counters ``moments3d.products.conv3d`` and
``.im2col`` (``tracing.counters``) count the k > 1 moment products each
lowering ran.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from supernet_tpu_torch import tracing
from supernet_tpu_torch.ops.moments import (  # noqa: F401
    _act,
    _axis_pads,
    _conv_pads,
    _enc_pads,
    _f32,
    _ring,
    _sum_c,
    _winsum_shift,
    _winsum_shift_pads,
    chan_sum,
    get_winsum,
    scale_sw,
    vrelu,
    vsoftmax,
)

Tensor = torch.Tensor
MomentPair = Tuple[Tensor, Tensor]

# The k > 1 conv lowering (supernet_tpu/ops/moments3d.py:53-103): "conv"
# (cuDNN conv3d) or "im2col" (the k^3 taps concatenated on channels, one
# matrix product with the packed k^3*C_in contraction).
_CONV3D_IMPL = "conv"
# the counter of each lowering's moment products
_PRODUCT_COUNTERS = {"conv": "moments3d.products.conv3d",
                     "im2col": "moments3d.products.im2col"}


def set_conv3d_impl(mode: str) -> None:
    if mode not in ("conv", "im2col"):
        raise ValueError(f"unknown conv3d impl {mode!r}")
    global _CONV3D_IMPL
    _CONV3D_IMPL = mode


def get_conv3d_impl() -> str:
    return _CONV3D_IMPL


def _im2col3d(x: Tensor, k: int, stride: int = 1) -> Tensor:
    """The k^3 VALID-window taps concatenated on channels:
    [B, D, H, W, C] -> [B, D', H', W', k^3*C], tap-major (dz, dy, dx)
    order, C minor: ``w.reshape(k^3*C_in, C_out)``'s row order."""
    _, d, h, w, _ = x.shape
    return torch.cat([x[:, dz:d - (k - 1) + dz:stride, dy:h - (k - 1) + dy:stride,
                        dx:w - (k - 1) + dx:stride]
                      for dz in range(k) for dy in range(k) for dx in range(k)], dim=-1)


def _im2col_dot(patches: Tensor, w_flat: Tensor) -> Tensor:
    """[B, D', H', W', k^3*Cin] @ [k^3*Cin, Cout]."""
    return torch.matmul(patches, w_flat.to(patches.dtype))


def _conv3d_valid(x: Tensor, w: Tensor, stride: int = 1, padding=0) -> Tensor:
    """VALID ``conv3d`` of NDHWC ``x`` with a DHWIO kernel, NDHWC out
    (``padding``: a symmetric zero pad per spatial axis).

    The NDHWC tensor viewed as NCDHW is ``channels_last_3d``, the layout
    cuDNN takes without a transpose; the kernel is laid out to match
    (ODHWI, a small copy). cuDNN's output keeps the layout, so viewing it
    back as NDHWC is free; a backend that answers in NCDHW (PyTorch's CPU
    conv3d) pays one copy here, so that every op after it sees NDHWC."""
    xc = x.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
    wc = w.to(x.dtype).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    y = F.conv3d(xc, wc, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _conv3d_pads(x: Tensor, w: Tensor, pads) -> Tensor:
    """3-D conv under per-axis ``(lo, hi)`` padding, negative a crop (the
    2-D ``_conv_pad``, one rank up)."""
    return _conv_pads(_conv3d_valid, x, w, pads)


def _window_sum3d(x: Tensor, k: int, stride: int = 1) -> Tensor:
    """Channel sum (float32, ``chan_sum``) then the k^3 VALID window sum
    -> [B, D', H', W', 1] in the activation dtype, lowered per the 2-D
    module's ``set_winsum``: shifted adds, or a ones-kernel conv3d in
    float32."""
    s = chan_sum(x)
    if get_winsum() == "shift":
        return _act(_winsum_shift(s, k, stride))
    return _act(_conv3d_valid(s, s.new_ones((k, k, k, 1, 1)), stride))


def _moment_convs(mu: Tensor, sigma: Tensor, w_mu: Tensor, stride: int):
    """``(conv3d(mu, w_mu), conv3d(sigma, w_mu^2))`` of a k > 1 conv,
    ``sigma`` None for the first conv, lowered per ``set_conv3d_impl``.
    Each product adds 1 to the counter ``moments3d.products.<lowering>``
    (``conv3d`` or ``im2col``)."""
    w2 = torch.square(_f32(w_mu))
    tracing.count(_PRODUCT_COUNTERS[_CONV3D_IMPL], 1 if sigma is None else 2)
    if _CONV3D_IMPL == "im2col":
        k, cout = w_mu.shape[0], w_mu.shape[-1]
        mu_out = _im2col_dot(_im2col3d(mu, k, stride), w_mu.reshape(-1, cout))
        if sigma is None:
            return mu_out, None
        return mu_out, _im2col_dot(_im2col3d(sigma, k, stride), w2.reshape(-1, cout))
    mu_out = _conv3d_valid(mu, w_mu, stride)
    return mu_out, None if sigma is None else _conv3d_valid(sigma, w2, stride)


def _einsum_1x1(x: Tensor, w: Tensor) -> Tensor:
    return torch.einsum("bdhwc,co->bdhwo", x, w)


def vconv3d_input(
    x: Tensor, w_mu: Tensor, w_sigma: Tensor, stride: int = 1
) -> MomentPair:
    """First conv: deterministic input, Gaussian weights. ``w_mu``
    [k,k,k,Cin,Cout], ``w_sigma`` [Cout] (raw, softplus-parameterized).

      mu_out    = conv3d(x, w_mu)                    (VALID)
      sigma_out = winsum3d(x^2) * softplus(w_sigma)
    """
    k = w_mu.shape[0]
    s_w = F.softplus(_f32(w_sigma))
    x = _act(x)
    if k == 1 and stride == 1:
        w2 = _act(w_mu[0, 0, 0])
        t = _sum_c(torch.square(_f32(x)))
        return _act(_einsum_1x1(x, w2)), scale_sw(_act(t), s_w)
    mu_out, _ = _moment_convs(x, None, w_mu, stride)
    ws = _window_sum3d(torch.square(x), k, stride)
    return _act(mu_out), scale_sw(ws, s_w)


def vconv3d(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor, stride: int = 1
) -> MomentPair:
    """Conv with Gaussian input and weights:

      mu_out    = conv3d(mu, w_mu)
      sigma_out = winsum3d(mu^2 + sigma) * softplus(w_sigma)
                  + conv3d(sigma, w_mu^2)

    k == 1 (the segmentation head) is two einsums and a channel sum."""
    k = w_mu.shape[0]
    s_w = F.softplus(_f32(w_sigma))
    if k == 1 and stride == 1:
        mu_a, sigma_a = _act(mu), _act(sigma)
        w2 = _act(w_mu[0, 0, 0])
        t = _sum_c(torch.square(mu) + sigma)
        sigma_out = scale_sw(_act(t), s_w) + _einsum_1x1(sigma_a, torch.square(w2))
        return _act(_einsum_1x1(mu_a, w2)), _act(sigma_out)
    mu_out, sigma2 = _moment_convs(_act(mu), _act(sigma), w_mu, stride)
    ws = _window_sum3d(torch.square(mu) + sigma, k, stride)
    return _act(mu_out), _act(scale_sw(ws, s_w) + sigma2)


def vconv3d_relu(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor
) -> MomentPair:
    return vrelu(*vconv3d(mu, sigma, w_mu, w_sigma))


def vconv3d_input_relu(x: Tensor, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    return vrelu(*vconv3d_input(x, w_mu, w_sigma))


# ------------------------------------------------------------------ pool

# tap k of a 2x2x2 window sits at parity (k // 4, k // 2 % 2, k % 2) on
# (D, H, W): (d, h, w) row-major, the TF flat-index order
_TAPS = tuple((k >> 2, (k >> 1) & 1, k & 1) for k in range(8))


def _pool_view(x: Tensor) -> Tensor:
    """[B, D, H, W, C] (even sides) as [B, D/2, 2, H/2, 2, W/2, 2, C]."""
    b, d, h, w, c = x.shape
    return x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)


def _pool_taps3d(x: Tensor):
    """The eight window taps as eighth-size views, in tap order."""
    r = _pool_view(x)
    return [r[:, :, di, :, hi, :, wi] for di, hi, wi in _TAPS]


def _pad_even(mu: Tensor, sigma: Tensor) -> MomentPair:
    """SAME padding to even sides at the high end: ``finfo(dtype).min`` for
    mu, 0 for sigma (``supernet_tpu/ops/moments3d.py:269-277``)."""
    _, d, h, w, _ = mu.shape
    if d % 2 or h % 2 or w % 2:
        pad = (0, 0, 0, w % 2, 0, h % 2, 0, d % 2)
        mu = F.pad(mu, pad, value=torch.finfo(mu.dtype).min)
        sigma = F.pad(sigma, pad)
    return mu, sigma


def vmaxpool3d_plain(mu: Tensor, sigma: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(mx, sigma at the argmax, idx)``: the 2x2x2 / stride-2 max of mu
    over SAME-padded windows, the first tap in (d, h, w) order winning a
    tie, and the chosen tap 0..7 as uint8. ``torch.maximum`` propagates NaN,
    as ``jnp.maximum`` does."""
    mu, sigma = _pad_even(mu, sigma)
    m_taps, s_taps = _pool_taps3d(mu), _pool_taps3d(sigma)
    mx = m_taps[0]
    for t in m_taps[1:]:
        mx = torch.maximum(mx, t)
    # tap k wins iff it equals the max and no earlier tap does
    s_out = s_taps[7]
    idx = torch.full(mx.shape, 7, dtype=torch.uint8, device=mx.device)
    for k in range(6, -1, -1):
        hit = m_taps[k] == mx
        s_out = torch.where(hit, s_taps[k], s_out)
        idx = torch.where(hit, k, idx).to(torch.uint8)
    return mx, s_out, idx


def vmaxpool3d_bwd(idx: Tensor, g_mu: Tensor, g_sigma: Tensor,
                   shape: Sequence[int]) -> MomentPair:
    """Route each output gradient to the tap ``idx`` names, at full
    resolution: a voxel of window parity (pd, ph, pw) keeps its window's
    gradient iff ``idx == 4 pd + 2 ph + pw``, every other voxel gets 0 (the
    parity rule of ``supernet_tpu/ops/moments3d.py:300-321``, written as
    eight strided stores). ``shape`` is the unpadded input's."""
    b, d, h, w, c = shape
    full = (b, d + d % 2, h + h % 2, w + w % 2, c)
    outs = []
    for g in (g_mu, g_sigma):
        out = g.new_zeros(full)
        view = _pool_view(out)
        for k, (di, hi, wi) in enumerate(_TAPS):
            view[:, :, di, :, hi, :, wi] = torch.where(idx == k, g, 0.0)
        outs.append(out[:, :d, :h, :w])
    return outs[0], outs[1]


class VMaxPool3d(torch.autograd.Function):
    """The moment max-pool with the backward of the JAX module's custom VJP:
    each gradient goes to the one tap the forward chose, never split over a
    tie (autograd of ``torch.maximum`` would halve it)."""

    @staticmethod
    def forward(ctx, mu, sigma):
        mx, s_out, idx = vmaxpool3d_plain(mu, sigma)
        ctx.save_for_backward(idx)
        ctx.in_shape = tuple(mu.shape)
        return mx, s_out

    @staticmethod
    def backward(ctx, g_mu, g_sigma):
        (idx,) = ctx.saved_tensors
        return vmaxpool3d_bwd(idx, g_mu, g_sigma, ctx.in_shape)


def vmaxpool3d(mu: Tensor, sigma: Tensor) -> MomentPair:
    """2x2x2 / stride-2 max-pool of mu with sigma gathered at the same
    argmax; first-occurrence ties, in the gradient too; odd sides padded."""
    return VMaxPool3d.apply(mu, sigma)


# ---------------------------------------------------------------- unpool


def _unpool3d_one(x: Tensor) -> Tensor:
    """Zero-interleave 2x upsample with a 1-voxel border on every spatial
    axis: [B,D,H,W,C] -> [B,2D+1,2H+1,2W+1,C], values at odd indices."""
    b, d, h, w, c = x.shape
    out = x.new_zeros((b, 2 * d + 1, 2 * h + 1, 2 * w + 1, c))
    out[:, 1::2, 1::2, 1::2] = x
    return out


def vunpool3d(mu: Tensor, sigma: Tensor) -> MomentPair:
    return _unpool3d_one(mu), _unpool3d_one(sigma)


def _upsample2_nearest3d(x: Tensor) -> Tensor:
    """[B,d,h,w,C] -> [B,2d,2h,2w,C] nearest-neighbour 2x."""
    b, d, h, w, c = x.shape
    y = x[:, :, None, :, None, :, None, :].expand(b, d, 2, h, 2, w, 2, c)
    return y.reshape(b, 2 * d, 2 * h, 2 * w, c)


def _unpool_conv3d(x: Tensor, w: Tensor) -> Tensor:
    """Zero-interleave (1-voxel border) + 2^3 VALID conv, fused: every
    output voxel sees exactly one input voxel,
    ``out[2i+p, 2j+q, 2l+r] = x[i, j, l] @ w[1-p, 1-q, 1-r]``, so it is one
    matrix product against the flipped kernel and a voxel shuffle."""
    b, d, h, wd, _ = x.shape
    y = torch.einsum("bdhwc,pqrco->bdphqwro", x, w.flip(0, 1, 2).to(x.dtype))
    return y.reshape(b, 2 * d, 2 * h, 2 * wd, w.shape[-1])


def vunpool3d_conv2(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor
) -> MomentPair:
    """Fused ``vunpool3d`` + 2^3 VALID ``vconv3d`` (the decoder's upsampling
    step). The 2^3 window sum of the interleaved (mu^2 + sigma) sees one
    nonzero voxel per window, so it is the channel sum upsampled 2x."""
    sw = F.softplus(_f32(w_sigma))
    mu, sigma = _act(mu), _act(sigma)
    t_up = _upsample2_nearest3d(_act(_sum_c(torch.square(mu) + sigma)))
    mu_out = _unpool_conv3d(mu, w_mu)
    sigma_out = t_up * _act(sw) + _unpool_conv3d(sigma, torch.square(_f32(w_mu)))
    return mu_out, _act(sigma_out)


# ------------------------------------------------------- glue and head


def vpad3d(
    mu: Tensor,
    sigma: Tensor,
    pad_size: Sequence[int] = (2, 2),
    sigma_fill: float = 0.0,
) -> MomentPair:
    """``(lo, hi)`` pad on all three spatial axes: mu with zeros, sigma
    with ``sigma_fill``."""
    lo, hi = int(pad_size[0]), int(pad_size[1])
    pad = (0, 0, lo, hi, lo, hi, lo, hi)
    return F.pad(mu, pad), F.pad(sigma, pad, value=sigma_fill)


def crop_center3d(x, td: int, th: int, tw: int):
    """Center-crop the spatial axes of an NDHWC tensor (or array), offsets
    ``(S - s) // 2`` per axis."""
    od = (x.shape[1] - td) // 2
    oh = (x.shape[2] - th) // 2
    ow = (x.shape[3] - tw) // 2
    return x[:, od : od + td, oh : oh + th, ow : ow + tw, ...]


def vcrop_concat3d(
    mu: Tensor, sigma: Tensor, mu_e: Tensor, sigma_e: Tensor
) -> MomentPair:
    """Skip connection: center-crop the encoder pair to the decoder's size
    and concatenate on channels, decoder channels first."""
    d, h, w = mu.shape[1:4]
    return (
        torch.cat([mu, crop_center3d(mu_e, d, h, w)], dim=-1),
        torch.cat([sigma, crop_center3d(sigma_e, d, h, w)], dim=-1),
    )


def vglue_conv3d_relu(
    mu: Tensor,
    sigma: Tensor,
    w_mu: Tensor,
    w_sigma: Tensor,
    pad_size,
    sigma_fill: float,
    mu_enc: Tensor | None = None,
    sigma_enc: Tensor | None = None,
) -> MomentPair:
    """The decoder's ``vpad3d -> [vcrop_concat3d ->] vconv3d -> vrelu``
    computed inside the convs (``supernet_tpu/ops/moments3d.py:442-529``),
    the 2-D ``ops.moments.vglue_conv_relu`` one rank up: the zero mu-pad as
    conv padding, the skip crop as a ``narrow`` view, the concatenation as a
    split of the kernel's input axis, the constant ``sigma_fill`` border as
    two terms of a batch-1 ring map. The ReLU is this module's ``vrelu``
    (the replay seam). ``pad_size`` is one ``(lo, hi)`` for every spatial
    axis or a ``(lo, hi) >= 0`` per axis: the local conv of the D-sharded
    fold, padded on a side only where that side is an edge of the whole
    volume."""
    k = w_mu.shape[0]
    c_d = mu.shape[-1]
    s_w = F.softplus(_f32(w_sigma))
    mu, sigma = _act(mu), _act(sigma)
    w_d = w_mu[..., :c_d, :] if mu_enc is not None else w_mu
    shift = get_winsum() == "shift"
    ones = None if shift else mu.new_ones((k, k, k, 1, 1))
    pd = _axis_pads(pad_size, 3)

    def winsum(src: Tensor, pads) -> Tensor:
        if shift:
            return _winsum_shift_pads(src, k, *pads)
        return _conv3d_pads(src, ones, pads)

    def src_of(m: Tensor, s: Tensor) -> Tensor:
        return _sum_c(torch.square(m) + s).to(m.dtype)

    mu_out = _conv3d_pads(mu, w_d, pd)
    ws = winsum(src_of(mu, sigma), pd)
    sig_conv = _conv3d_pads(sigma, torch.square(_f32(w_d)), pd)
    if sigma_fill != 0.0 and any(lo or hi for lo, hi in pd):
        ring = _ring(mu, pd)
        fill = float(torch.tensor(sigma_fill, dtype=mu.dtype))  # jnp.asarray's rounding
        ws = ws + winsum(ring, ((0, 0),) * 3) * (c_d * fill)
        w2_sum = torch.square(_f32(w_d)).sum(dim=3, keepdim=True)
        sig_conv = sig_conv + _conv3d_valid(ring, w2_sum) * fill
    if mu_enc is not None:
        mu_enc, sigma_enc = _act(mu_enc), _act(sigma_enc)
        w_e = w_mu[..., c_d:, :]
        pe = _enc_pads(mu.shape[1:4], mu_enc.shape[1:4], pd)
        mu_out = mu_out + _conv3d_pads(mu_enc, w_e, pe)
        ws = ws + winsum(src_of(mu_enc, sigma_enc), pe)
        sig_conv = sig_conv + _conv3d_pads(sigma_enc, torch.square(_f32(w_e)), pe)
    sigma_out = scale_sw(_act(ws), s_w) + sig_conv
    return vrelu(_act(mu_out), _act(sigma_out))


def vsoftmax3d(mu: Tensor, sigma: Tensor) -> MomentPair:
    """Voxel-wise softmax with the variance through its Jacobian; outputs
    flattened to [B, D*H*W, C] (the 2-D closure on a [B, D*H, W, C] view)."""
    b, d, h, w, c = mu.shape
    return vsoftmax(mu.reshape(b, d * h, w, c), sigma.reshape(b, d * h, w, c))
