"""VDP moment primitives in PyTorch: the 2-D set of
``supernet_tpu/ops/moments.py`` that the serving and training paths run,
float32, with gradients.

Each primitive pushes the mean ``mu`` and the diagonal variance ``sigma`` of
the activations (both NHWC float32) through one network operation, with the
same algebra as the JAX module (see its docstring): every variance term of a
Bayesian conv is a convolution, because the kernel variance
``softplus(w_sigma)`` is one scalar per output channel.

Dispatch: every k > 1 conv goes through ``ops.kernels.vdp_conv.VDPConv``
and the max-pool through ``ops.kernels.pool.VMaxPool``, the autograd
Functions around the hand-written kernels (forward and backward). On CUDA
tensors those launch the kernels; on CPU tensors they run their plain
versions. The 1x1 head and the unpool conv are matrix products
(``torch.einsum``), as they are XLA ops in the JAX package; their gradients,
and those of the pads, crops, concatenations and the softmax, are PyTorch's
autograd, as they are XLA's AD in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from supernet_tpu_torch.ops.kernels import pool as _pool
from supernet_tpu_torch.ops.kernels import vdp_conv as _vdp

Tensor = torch.Tensor
MomentPair = Tuple[Tensor, Tensor]

# "highest" is true float32 in every matrix product and convolution that
# PyTorch runs on the card (TF32 off); "high" and "default" allow TF32.
_MXU_PRECISION: str = "highest"


def set_mxu_precision(precision: str) -> None:
    """Set the float32 precision of PyTorch's own matmuls and convolutions
    on the card ('highest' | 'high' | 'default'). 'highest' turns TF32 off
    for both cuDNN and cuBLAS; the others turn it on. The hand-written
    kernels compute at float32 accuracy whatever the setting: vdp_conv by
    3xTF32 on the tensor cores (each operand split into two TF32 halves,
    three products summed in float32), the others in float32."""
    global _MXU_PRECISION
    if precision not in ("highest", "default", "high"):
        raise ValueError(f"unknown precision {precision!r}")
    _MXU_PRECISION = precision
    tf32 = precision != "highest"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def get_mxu_precision() -> str:
    return _MXU_PRECISION


def scale_sw(ws: Tensor, s_w: Tensor) -> Tensor:
    """``ws [..., 1] * s_w [Cout] -> [..., Cout]``: the per-output-channel
    variance scale shared by every vconv sigma term."""
    return ws * s_w.to(ws.dtype)


def chan_sum(x: Tensor) -> Tensor:
    """Sum over the trailing channel axis -> [..., 1], in float32 (float64
    input keeps float64, for the gradient checks)."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    return x.sum(dim=-1, keepdim=True, dtype=dtype)


def _window_sum(x: Tensor, k: int) -> Tensor:
    """Sum of x over each k x k VALID window and over all input channels
    -> [B, H', W', 1]: the channel sum in float32, then the JAX module's
    shift lowering (per spatial axis, the k shifted views are added)."""
    s = chan_sum(x)
    for axis in (1, 2):
        n = s.shape[axis] - k + 1
        acc = s.narrow(axis, 0, n)
        for i in range(1, k):
            acc = acc + s.narrow(axis, i, n)
        s = acc
    return s.to(x.dtype)


def _einsum_1x1(x: Tensor, w: Tensor) -> Tensor:
    return torch.einsum("bhwc,co->bhwo", x, w)


def vconv_input(x: Tensor, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    """First VDP conv: deterministic input, Gaussian weights.

      mu_out    = conv(x, w_mu)                      (VALID)
      sigma_out = winsum(x^2) * softplus(w_sigma)
    """
    if w_mu.shape[0] == 1:
        w2 = w_mu[0, 0]
        t = chan_sum(x * x)
        return _einsum_1x1(x, w2), scale_sw(t, F.softplus(w_sigma))
    return _vdp.VDPConv.apply(x, None, w_mu, w_sigma, False)


def vconv(mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    """Intermediate VDP conv: Gaussian input and Gaussian weights.

      mu_out    = conv(mu, w_mu)
      sigma_out = winsum(mu^2 + sigma) * softplus(w_sigma) + conv(sigma, w_mu^2)

    k == 1 (the softmax head) is two einsums and a channel sum.
    """
    if w_mu.shape[0] == 1:
        w2 = w_mu[0, 0]
        t = chan_sum(mu * mu + sigma)
        sigma_out = scale_sw(t, F.softplus(w_sigma)) + _einsum_1x1(sigma, w2 * w2)
        return _einsum_1x1(mu, w2), sigma_out
    return _vdp.VDPConv.apply(mu, sigma, w_mu, w_sigma, False)


def vconv_relu(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor
) -> MomentPair:
    """``vrelu(*vconv(...))``, the ReLU fused into the conv for k > 1."""
    if w_mu.shape[0] == 1:
        return vrelu(*vconv(mu, sigma, w_mu, w_sigma))
    return _vdp.VDPConv.apply(mu, sigma, w_mu, w_sigma, True)


def vconv_input_relu(x: Tensor, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    """``vrelu(*vconv_input(...))``, fused the same way."""
    if w_mu.shape[0] == 1:
        return vrelu(*vconv_input(x, w_mu, w_sigma))
    return _vdp.VDPConv.apply(x, None, w_mu, w_sigma, True)


def vrelu(mu: Tensor, sigma: Tensor) -> MomentPair:
    """First-order Taylor ReLU with the strict mask ``mu > 0`` (TF's ReLU
    gradient is 0 at 0)."""
    mask = mu > 0
    return torch.where(mask, mu, 0.0), torch.where(mask, sigma, 0.0)


def vmaxpool(mu: Tensor, sigma: Tensor) -> MomentPair:
    """2x2/stride-2 max-pool of ``mu`` with ``sigma`` at the argmax;
    first-occurrence ties, in the gradient too; odd sizes padded with
    ``finfo.min``."""
    return _pool.VMaxPool.apply(mu, sigma)


def _upsample2_nearest(x: Tensor) -> Tensor:
    """[B,h,w,C] -> [B,2h,2w,C] nearest-neighbour 2x."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _unpool_conv(x: Tensor, w: Tensor) -> Tensor:
    """Zero-interleave 2x upsample (1-px border) + 2x2 VALID conv.

    The interleave puts x[i, j] at (2i+1, 2j+1), so every output pixel sees
    exactly one input pixel: ``out[2i+p, 2j+q] = x[i, j] @ w[1-p, 1-q]``.
    That is one matrix product against the flipped kernel, then a pixel
    shuffle.
    """
    b, h, wd, _ = x.shape
    y = torch.einsum("bhwc,pqco->bhpwqo", x, w.flip(0, 1))
    return y.reshape(b, 2 * h, 2 * wd, w.shape[-1])


def vunpool_conv2(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor
) -> MomentPair:
    """Fused ``vunpool`` + 2x2 VALID ``vconv`` (the decoder's first pair).
    The 2x2 window sum of the interleaved (mu^2 + sigma) sees one nonzero
    pixel per window, so it is the channel sum upsampled 2x."""
    t_up = _upsample2_nearest(chan_sum(mu * mu + sigma))
    mu_out = _unpool_conv(mu, w_mu)
    sigma_out = t_up * F.softplus(w_sigma) + _unpool_conv(sigma, w_mu * w_mu)
    return mu_out, sigma_out


def vpad(
    mu: Tensor,
    sigma: Tensor,
    pad_size: Sequence[int] = (2, 2),
    sigma_fill: float = 0.0,
) -> MomentPair:
    """Pad both spatial dims by ``(lo, hi)``: mu with zeros, sigma with
    ``sigma_fill`` (the pseudo-variance of invented pixels)."""
    lo, hi = int(pad_size[0]), int(pad_size[1])
    pad = (0, 0, lo, hi, lo, hi)
    return F.pad(mu, pad), F.pad(sigma, pad, value=sigma_fill)


def crop_center(x: Tensor, target_h: int, target_w: int) -> Tensor:
    """Center-crop the spatial dims of an NHWC tensor, offsets
    ``(H - h) // 2``."""
    oh = (x.shape[1] - target_h) // 2
    ow = (x.shape[2] - target_w) // 2
    return x[:, oh : oh + target_h, ow : ow + target_w]


def vcrop_concat(
    mu_dec: Tensor, sigma_dec: Tensor, mu_enc: Tensor, sigma_enc: Tensor
) -> MomentPair:
    """Skip connection: center-crop the encoder moments to the decoder's
    size and concatenate on channels, decoder channels first."""
    h, w = mu_dec.shape[1], mu_dec.shape[2]
    return (
        torch.cat([mu_dec, crop_center(mu_enc, h, w)], dim=-1),
        torch.cat([sigma_dec, crop_center(sigma_enc, h, w)], dim=-1),
    )


def vsoftmax(mu: Tensor, sigma: Tensor) -> MomentPair:
    """Pixel-wise softmax with the variance pushed through its Jacobian, in
    closed form and float32:

        sigma_out_c = p_c^2 * ((1 - 2 p_c) * sigma_c + sum_j p_j^2 sigma_j)

    Outputs are flattened to [B, H*W, C]; the batch dim is never squeezed.
    """
    b, h, w, c = mu.shape
    mu_flat = mu.reshape(b, h * w, c).float()
    sigma_flat = sigma.reshape(b, h * w, c).float()
    p = torch.softmax(mu_flat, dim=-1)
    p_sq = p * p
    s_tot = (p_sq * sigma_flat).sum(dim=-1, keepdim=True)
    return p, p_sq * ((1.0 - 2.0 * p) * sigma_flat + s_tot)
