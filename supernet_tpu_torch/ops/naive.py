"""Patch-matmul transliteration of the reference's VDP conv algorithm, in
plain PyTorch ops. The counterpart of ``supernet_tpu/ops/naive.py``.

The reference (`Hippocampus.py:125-136,178-197`) extracts k x k patches,
materializes ``[B, H'W', k^2 C]`` matrices and computes the variance terms
with dense matmuls against a broadcast per-channel kernel variance.

It exists as a cross-check (the tests hold ``ops.moments`` equal to it) and
as the algorithmic baseline of the benchmark: ``ops.set_backend("naive")``
(or ``SUPERNET_BACKEND=naive``) routes ``vconv_input``, ``vconv``,
``vmaxpool``, the unpool conv and ``vsoftmax`` here, as the JAX package's
naive backend does. It is not a kernel and shares no code with the
primitives it checks.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def extract_patches(x: Tensor, k: int, stride: int = 1) -> Tensor:
    """VALID k x k patch extraction, mirroring ``tf.image.extract_patches``.

    Returns [B, H', W', k*k*C] with the (row, col, channel) ordering TF uses:
    the channel axis is fastest, then patch column, then patch row. The taps
    are gathered as shifted slices, no convolution machinery.
    """
    b, h, w, c = x.shape
    ho = (h - k) // stride + 1
    wo = (w - k) // stride + 1
    rows = []
    for di in range(k):
        cols = [
            x[:, di : di + (ho - 1) * stride + 1 : stride,
              dj : dj + (wo - 1) * stride + 1 : stride]
            for dj in range(k)
        ]
        rows.append(torch.stack(cols, dim=3))  # [B, H', W', k, C]
    patches = torch.stack(rows, dim=3)  # [B, H', W', k, k, C]
    return patches.reshape(b, ho, wo, k * k * c)


def _patch_matrix(x: Tensor, k: int, stride: int) -> Tensor:
    xp = extract_patches(x, k, stride)
    return xp.reshape(xp.shape[0], xp.shape[1] * xp.shape[2], xp.shape[3])


def _mu_out(x: Tensor, w_mu: Tensor, stride: int) -> Tensor:
    """``patches(x) @ w_mu`` reshaped to NHWC: TF reshapes w_mu
    [k,k,Cin,Cout] -> [k*k*Cin, Cout], the same row-major order here."""
    k, _, cin, cout = w_mu.shape
    ho = (x.shape[1] - k) // stride + 1
    wo = (x.shape[2] - k) // stride + 1
    out = _patch_matrix(x, k, stride) @ w_mu.reshape(k * k * cin, cout)
    return out.reshape(x.shape[0], ho, wo, cout)


def vconv_input_naive(
    x: Tensor, w_mu: Tensor, w_sigma: Tensor, stride: int = 1
) -> Tuple[Tensor, Tensor]:
    """Reference algorithm for the first conv (`Hippocampus.py:125-136`)."""
    k, _, cin, cout = w_mu.shape
    mu_out = _mu_out(x, w_mu, stride)
    vect_sigma = F.softplus(w_sigma).expand(k * k * cin, cout)
    sigma = torch.square(_patch_matrix(x, k, stride)) @ vect_sigma
    return mu_out, sigma.reshape(mu_out.shape)


def vconv_naive(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor, stride: int = 1
) -> Tuple[Tensor, Tensor]:
    """Reference algorithm for intermediate convs (`Hippocampus.py:178-197`).

    sigma_out = patches(mu^2) @ bcast(s_w)      (sigma1)
              + patches(sigma) @ w_mu^2         (sigma2)
              + patches(sigma) @ bcast(s_w)     (sigma3)
    """
    k, _, cin, cout = w_mu.shape
    mu_out = _mu_out(mu, w_mu, stride)
    vect_sigma = F.softplus(w_sigma).expand(k * k * cin, cout)
    x_matrix = _patch_matrix(mu, k, stride)
    sigma_matrix = _patch_matrix(sigma, k, stride)
    w_mean = w_mu.reshape(k * k * cin, cout)
    sigma1 = torch.square(x_matrix) @ vect_sigma
    sigma2 = sigma_matrix @ torch.square(w_mean)
    sigma3 = sigma_matrix @ vect_sigma
    return mu_out, (sigma1 + sigma2 + sigma3).reshape(mu_out.shape)


def vmaxpool_naive(mu: Tensor, sigma: Tensor) -> Tuple[Tensor, Tensor]:
    """Reference algorithm for the pool (`Hippocampus.py:54-64,226-234`):
    argmax over each 2x2 window and a gather of sigma at the argmax (the TF
    ``max_pool_with_argmax`` + flat ``tf.gather`` analog). Odd spatial dims
    are padded at the bottom/right, mu with the dtype's lowest value so the
    padding never wins; ties go to the first tap in row-major order."""
    b, h, w, c = mu.shape
    ho, wo = -(-h // 2), -(-w // 2)
    if (2 * ho, 2 * wo) != (h, w):
        pad = (0, 0, 0, 2 * wo - w, 0, 2 * ho - h)
        mu = F.pad(mu, pad, value=torch.finfo(mu.dtype).min)
        sigma = F.pad(sigma, pad)

    def windows(a: Tensor) -> Tensor:
        a = a.reshape(b, ho, 2, wo, 2, c).permute(0, 1, 3, 2, 4, 5)
        return a.reshape(b, ho, wo, 4, c)

    mw, sw = windows(mu), windows(sigma)
    # argmax of a tie is not specified in PyTorch: the first maximal tap is
    # the lowest index among those equal to the maximum
    taps = torch.arange(4, device=mu.device).reshape(1, 1, 1, 4, 1)
    top = mw.amax(dim=3, keepdim=True)
    idx = torch.where(mw == top, taps, 3).amin(dim=3, keepdim=True)
    return (torch.gather(mw, 3, idx)[:, :, :, 0, :],
            torch.gather(sw, 3, idx)[:, :, :, 0, :])


def vsoftmax_naive(mu: Tensor, sigma: Tensor) -> Tuple[Tensor, Tensor]:
    """Reference algorithm for the softmax head (`Hippocampus.py:273-292`):
    the explicit per-pixel ``(J o J) @ sigma`` matmul (without the B == 1
    squeeze hazard)."""
    b, h, w, c = mu.shape
    mu_flat = mu.reshape(b, h * w, c)
    sigma_flat = sigma.reshape(b, h * w, c)
    p = torch.softmax(mu_flat, dim=-1)
    eye = torch.eye(c, dtype=p.dtype, device=p.device)
    grad = eye * p[..., None, :] - p[..., :, None] * p[..., None, :]
    sigma_out = (torch.square(grad) @ sigma_flat[..., None])[..., 0]
    return p, sigma_out
