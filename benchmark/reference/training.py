"""The reference training step in plain PyTorch: the ELBO loss, Keras'
per-tensor ``clipnorm`` and Adam with epsilon 1e-7.

  nll   = 0.5 * (mean_{b,n} sum_c (p - y)^2 / (s + 1e-3)      (0 if not finite)
                 + mean_{b,n} sum_c log(s + 1e-3)),   s = clip(sigma, lo, hi)
  kl    = sum_layers [ sum w_mu^2 - k^2 * mean(1 + log softplus(w_sigma)
                                              - softplus(w_sigma)) ]
  loss  = nll + kl_factor * 0.5 * kl                      (Hippocampus.py:302-331, 520-531)
  clip  each gradient tensor g scaled by clipnorm / |g| where |g| > clipnorm
  adam  m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
        w -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.vdp_unet import forward

Tensor = torch.Tensor
Params = Dict[str, Dict[str, Tensor]]
NLL_EPS = 1e-3
BETAS = (0.9, 0.999)


def one_hot(labels: Tensor, n_classes: int) -> Tensor:
    """Label maps [B, H, W] -> [B, H*W, C] float32."""
    y = F.one_hot(labels.long(), n_classes).to(torch.float32)
    return y.reshape(labels.shape[0], -1, n_classes)


def kl_term(params: Params) -> Tensor:
    total = 0.0
    for p in params.values():
        k = p["w_mu"].shape[0]
        sp = F.softplus(p["w_sigma"])
        total = total + (p["w_mu"] ** 2).sum() - k * k * (1.0 + torch.log(sp) - sp).mean()
    return total


def loss(params: Params, x: Tensor, labels: Tensor, model: dict, train: dict) -> Tensor:
    probs, sigma = forward(params, x, model)
    y = one_hot(labels, model["n_classes"])
    s = torch.clamp(sigma, train["sigma_clip_min"], train["sigma_clip_max"])
    l1 = (((probs - y) ** 2) / (s + NLL_EPS)).sum(-1).mean()
    l1 = torch.where(torch.isfinite(l1), l1, torch.zeros_like(l1))
    l2 = torch.log(s + NLL_EPS).sum(-1).mean()
    return 0.5 * (l1 + l2) + train["kl_factor"] * 0.5 * kl_term(params)


class Reference:
    """The reference's trainable state: parameters (HWIO, float32) and Adam's
    moments. ``step`` takes one optimizer step and returns the loss and the
    clipped gradients it applied."""

    def __init__(self, params: Params, model: dict, train: dict):
        self.model, self.train = model, train
        self.params = {n: {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
                       for n, p in params.items()}
        self.m = {key: torch.zeros_like(t) for key, t in self.leaves()}
        self.v = {key: torch.zeros_like(t) for key, t in self.leaves()}
        self.t = 0

    def leaves(self) -> List[Tuple[str, Tensor]]:
        return [(f"{n}/{k}", v) for n, p in self.params.items() for k, v in p.items()]

    def step(self, x: Tensor, labels: Tensor, chunks: int = 1) -> Tuple[float, Dict[str, Tensor]]:
        """With ``chunks`` > 1 the batch's loss and gradient are summed over
        that many parts, each weighted by its share of the batch (a float64
        step then fits where the whole batch would not)."""
        tc = self.train
        named = self.leaves()
        value, grads = 0.0, None
        for xs, ys in zip(x.chunk(chunks), labels.chunk(chunks)):
            part = loss(self.params, xs, ys, self.model, tc) * (xs.shape[0] / x.shape[0])
            g = torch.autograd.grad(part, [t for _, t in named])
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            value = value + part.detach()
        self.t += 1
        b1, b2 = BETAS
        clipped = {}
        with torch.no_grad():
            for (key, w), g in zip(named, grads):
                n = torch.linalg.vector_norm(g)
                g = g * torch.where(n > tc["clipnorm"], tc["clipnorm"] / torch.clamp_min(n, 1e-30), 1.0)
                clipped[key] = g
                self.m[key].mul_(b1).add_(g, alpha=1 - b1)
                self.v[key].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[key] / (1 - b1 ** self.t)
                v_hat = self.v[key] / (1 - b2 ** self.t)
                w -= tc["lr"] * m_hat / (torch.sqrt(v_hat) + tc["adam_eps"])
        return float(value), clipped
