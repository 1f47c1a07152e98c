"""ELBO losses: heteroscedastic Gaussian NLL + KL weight regularization.

Counterpart of ``supernet_tpu/losses.py``. Reference: ``nll_gaussian``
(`Hippocampus.py:302-322`) and ``sigma_regularizer`` + l2
(`Hippocampus.py:116,121,325-331`), combined in ``train_on_batch`` as
``nll + kl_factor * 0.5 * sum(model.losses)`` (`Hippocampus.py:520-531`).

The log-determinant term is ``sum_c log(sigma_c + eps)``, the stable form of
the reference's ``log(prod_c(sigma_c + eps))``; the reference's NaN/Inf
scrub of the quadratic term (`Hippocampus.py:314-315`) is kept. The loss is
float32 under either activation dtype (the softmax head's outputs are
float32; half-precision inputs are upcast here).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

NLL_EPS = 1e-3  # Hippocampus.py:304


def _mean(v: Tensor, members: bool) -> Tensor:
    """The mean over everything, or over all but the leading member axis."""
    return v.flatten(1).mean(1) if members else v.mean()


def nll_gaussian(y: Tensor, mu: Tensor, sigma: Tensor, eps: float = NLL_EPS,
                 members: bool = False) -> Tensor:
    """Expected Gaussian negative log-likelihood over flattened pixels.

    y one-hot [B, N, C]; mu the post-softmax probabilities [B, N, C]; sigma
    the per-class variance [B, N, C] (clipped by the caller):

      loss1 = mean_{B,N}[ sum_c (mu - y)^2 / (sigma + eps) ]   (NaN/Inf -> 0)
      loss2 = mean_{B,N}[ sum_c log(sigma_c + eps) ]
      nll   = 0.5 * (loss1 + loss2)

    ``members``: the inputs are [K, B, N, C], K ensemble members, and the
    result is each member's own [K] (the scrub per member), what
    ``jax.vmap`` of this function gives.
    """
    dt = torch.promote_types(mu.dtype, torch.float32)
    mu, sigma = mu.to(dt), sigma.to(dt)
    inv = 1.0 / (sigma + eps)
    loss1 = _mean(((mu - y) ** 2 * inv).sum(dim=-1), members)
    loss1 = torch.where(torch.isfinite(loss1), loss1, torch.zeros_like(loss1))
    loss2 = _mean(torch.log(sigma + eps).sum(dim=-1), members)
    return 0.5 * (loss1 + loss2)


def clip_sigma(sigma: Tensor, lo: float, hi: float) -> Tensor:
    """``sigma`` clipped to ``[lo, hi]`` before the NLL (`Hippocampus.py:524`,
    `:539`). The loss's one discrete choice besides the ReLU masks and pool
    taps: a pixel whose sigma lies within rounding of a bound has its
    gradient on in one float32 run and off in another (at BraTS depth half
    the pixels' sigma lies above the upper bound of 1e3)."""
    return torch.clamp(sigma, lo, hi)


def elbo_loss(
    y: Tensor,
    mu: Tensor,
    sigma: Tensor,
    kl: Tensor,
    kl_factor: float,
    sigma_clip_min: float = 1e-12,
    sigma_clip_max: float = 1e3,
    members: bool = False,
) -> Tensor:
    """Total training loss: clipped-NLL + kl_factor * 0.5 * KL
    (`Hippocampus.py:523-527`); per member ([K]) with ``members``, ``kl``
    then [K] too."""
    sigma_c = clip_sigma(sigma, sigma_clip_min, sigma_clip_max)
    return nll_gaussian(y, mu, sigma_c, members=members) + kl_factor * 0.5 * kl
