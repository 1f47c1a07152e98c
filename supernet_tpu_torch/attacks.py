"""Adversarial attacks: the FGSM gradient sign, the PGD loop and gradient
saliency. The counterpart of ``supernet_tpu/attacks.py``.

Reference: ``create_adversarial_pattern`` (`Hippocampus.py:533-547`,
`Brats.py:582-596`) and the adversarial test branches
(`Hippocampus.py:894-1003`, `Brats.py:951-1037`):

- the attack loss is ``0.5 * nll_gaussian(y, probs, clip(sigma))`` with the
  attack's own clip range ``[-1e4, 1e3]`` (`Hippocampus.py:539`);
- FGSM: ``sign(d loss / d x)`` with the model frozen;
- PGD: ``max_adv_step`` iterations of ``adv_x += step_size * sign``, each
  projected into the epsilon-ball ``[x - eps, x + eps]`` and the data range
  ``[x_min, x_max]`` (`Hippocampus.py:912-933`);
- targeted mode rewrites the label before the loss: every pixel of class
  ``adversary_targeted_class`` becomes ``adv_class``
  (`Hippocampus.py:914-916`);
- BraTS untargeted mode is a single FGSM step (`Brats.py:984-991`).

The gradient is taken with respect to the input alone: the parameters are
detached, so the backward pass of every VDP conv skips its weight gradients
and still runs the sigma-chain backward kernel for the input's. The JAX
package's ``lax.fori_loop`` is a Python loop here; the loop's state, the
ball and the range stay on the input's device and nothing is fetched inside
it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from supernet_tpu_torch.configs import AttackConfig, ModelConfig
from supernet_tpu_torch import losses
from supernet_tpu_torch.models import forward

Tensor = torch.Tensor
Params = Dict[str, Dict[str, Tensor]]


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "attacks over a device mesh are not ported yet (ROADMAP.md, "
            "Queue 1: 'Parallelism', parallel/data_parallel.py)"
        )


def _frozen(params: Params) -> Params:
    """The same tensors without their autograd history: no weight gradient
    is computed for an input gradient."""
    return {layer: {name: t.detach() for name, t in ws.items()}
            for layer, ws in params.items()}


def retarget_labels(y: Tensor, targeted_class: int, adv_class: int) -> Tensor:
    """Replace ``targeted_class`` with ``adv_class`` in integer labels
    (`Hippocampus.py:914-916`)."""
    return torch.where(y == targeted_class, adv_class, y)


def attack_loss(
    params: Params,
    x: Tensor,
    y: Tensor,
    cfg: ModelConfig,
    ac: AttackConfig,
    forward_fn=forward,
) -> Tensor:
    """``0.5 * nll_gaussian(y, probs, clip(sigma))`` (`Hippocampus.py:538-541`).

    ``y`` is one-hot flattened [B, N, C] (already retargeted if targeted).
    ``forward_fn(params, x, cfg) -> (probs, sigma)`` selects the model
    family (default the 2-D ``models.forward``).
    """
    probs, sigma = forward_fn(params, x, cfg)
    sigma_c = losses.clip_sigma(sigma, ac.sigma_clip_min, ac.sigma_clip_max)
    return 0.5 * losses.nll_gaussian(y, probs, sigma_c)


def input_gradient(
    params: Params,
    x: Tensor,
    y: Tensor,
    cfg: ModelConfig,
    ac: AttackConfig,
    forward_fn=forward,
) -> Tensor:
    """``d attack_loss / d x``, the parameters frozen."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        loss = attack_loss(_frozen(params), x, y, cfg, ac, forward_fn)
        (grad,) = torch.autograd.grad(loss, x)
    return grad


def fgsm_sign(
    params: Params,
    x: Tensor,
    y: Tensor,
    cfg: ModelConfig,
    ac: AttackConfig,
    forward_fn=forward,
) -> Tensor:
    """``sign(d attack_loss / d x)``: the FGSM perturbation direction."""
    return torch.sign(input_gradient(params, x, y, cfg, ac, forward_fn))


def _range(x: Tensor, x_min, x_max) -> Tuple[Tensor, Tensor]:
    """The data range as 0-dim tensors on ``x``'s device."""
    return (torch.as_tensor(x_min, dtype=x.dtype, device=x.device),
            torch.as_tensor(x_max, dtype=x.dtype, device=x.device))


def make_pgd_attack(cfg: ModelConfig, ac: AttackConfig, mesh=None, forward_fn=forward):
    """PGD: returns ``attack(params, x, y_flat, x_min, x_max) -> adv_x``.

    ``y_flat`` is the (possibly retargeted) one-hot flattened label. The
    per-step projection is `Hippocampus.py:930-932`: clip(adv, x - eps,
    x + eps), then clip(adv, x_min, x_max). ``x_min`` / ``x_max`` are the
    batch's data range (`Hippocampus.py:906-907`), numbers or 0-dim tensors.
    The result is detached.
    """
    _single_device(mesh)

    def attack(params: Params, x: Tensor, y_flat: Tensor, x_min, x_max) -> Tensor:
        x = x.detach()
        lo, hi = _range(x, x_min, x_max)
        ball_lo, ball_hi = x - ac.epsilon, x + ac.epsilon
        adv_x = x
        for _ in range(ac.max_adv_step):
            sign = fgsm_sign(params, adv_x, y_flat, cfg, ac, forward_fn)
            adv_x = adv_x + ac.step_size * sign
            adv_x = torch.clamp(adv_x, ball_lo, ball_hi)
            adv_x = torch.clamp(adv_x, lo, hi)
        return adv_x

    return attack


def make_fgsm_attack(cfg: ModelConfig, ac: AttackConfig, mesh=None, forward_fn=forward):
    """Single-step FGSM (`Brats.py:984-991`): ``attack(params, x, y_flat,
    x_min, x_max) -> clip(x + eps * sign, x_min, x_max)``, detached."""
    _single_device(mesh)

    def attack(params: Params, x: Tensor, y_flat: Tensor, x_min, x_max) -> Tensor:
        x = x.detach()
        lo, hi = _range(x, x_min, x_max)
        sign = fgsm_sign(params, x, y_flat, cfg, ac, forward_fn)
        return torch.clamp(x + ac.epsilon * sign, lo, hi)

    return attack


def make_saliency_map(cfg: ModelConfig, forward_fn=forward, mesh=None):
    """Gradient saliency (`Brats.py:598-609`): returns ``saliency(params, x,
    class_mask) -> (g, relu(g))`` with ``g = d(sum of the predicted
    probability mass of the masked classes) / dx``. ``class_mask`` is a [C]
    0/1 vector (all tumor = classes > 0).

    ``probs`` depends on the mean chain alone, so the variance chain's
    cotangents are all zero; the sigma-chain backward kernel still runs on
    them (skipping it would need a look at the data, a synchronisation).
    """
    _single_device(mesh)

    def saliency(params: Params, x: Tensor, class_mask: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            probs, _ = forward_fn(_frozen(params), x, cfg)
            mass = (probs * class_mask.to(probs)[None, None, :]).sum()
            (g,) = torch.autograd.grad(mass, x)
        return g, torch.relu(g)

    return saliency
