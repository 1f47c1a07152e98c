"""Single-device train and eval steps: the counterpart of the step builders
of ``supernet_tpu/train.py``.

A step is value-and-grad of the ELBO through the VDP U-Net (every k=3 conv
and every pool backward through the hand-written kernels on the card), then
Keras-style per-tensor gradient clipping and Adam with Keras' epsilon 1e-7.
PyTorch runs eagerly, so the JAX package's ``jit`` and ``lax.scan`` become
plain calls and Python loops; the state is updated in place (the JAX step
donates it) and returned. Parameters are the JAX-layout dict
``{layer: {"w_mu", "w_sigma"}}``.

With ``tc.augment`` the single and multi-step builders augment each batch
on the parameters' device (``data/augment.py``), keyed by the seed, the
state's step counter and the global image index.

With ``tc.adversarial_training`` ("fgsm" or "pgd") every step trains on
``adv_alpha * L(clean) + (1 - adv_alpha) * L(adv)``: the adversarial examples
are made inside the step against the current parameters (one or
``adv_steps`` extra forward and backward passes, the input gradient running
through the kernels' backward) and detached, so they act as fixed data for
the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, NamedTuple, Tuple

import torch

from supernet_tpu_torch.attacks import make_fgsm_attack, make_pgd_attack
from supernet_tpu_torch.checkpoint import Params, params_from_jax
from supernet_tpu_torch.configs import AttackConfig, ModelConfig, TrainConfig
from supernet_tpu_torch.losses import elbo_loss, nll_gaussian
from supernet_tpu_torch.models import forward, kl_regularizer

Tensor = torch.Tensor


def leaves(params: Params):
    """The parameter tensors in a fixed order (layer, then w_mu, w_sigma)."""
    return [t for p in params.values() for t in p.values()]


@torch.no_grad()
def clip_by_per_tensor_norm(grads: Iterable[Tensor], max_norm: float) -> None:
    """Keras ``clipnorm``: rescale each gradient tensor in place so that its
    L2 norm is at most ``max_norm`` (``tf.clip_by_norm`` per tensor, not the
    global norm of ``torch.nn.utils.clip_grad_norm_``)."""
    for g in grads:
        n = torch.linalg.vector_norm(g)
        g.mul_(torch.where(n > max_norm, max_norm / torch.clamp_min(n, 1e-30), 1.0))


def make_optimizer(params: Params, tc: TrainConfig) -> torch.optim.Adam:
    """Adam(lr, betas (0.9, 0.999), eps ``tc.adam_eps``); its update is
    optax's ``m_hat / (sqrt(v_hat) + eps)``. The clip runs before it, in
    the step."""
    return torch.optim.Adam(
        leaves(params), lr=tc.lr, betas=(0.9, 0.999), eps=tc.adam_eps
    )


@dataclass
class TrainState:
    params: Params
    opt_state: torch.optim.Adam
    step: int = 0


def create_train_state(
    params, tc: TrainConfig, device="cuda"
) -> Tuple[TrainState, torch.optim.Adam]:
    """Copy ``params`` (JAX-layout numpy, JAX arrays or tensors) onto
    ``device`` as trainable leaves and build their optimizer. Returns
    ``(state, optimizer)`` like the JAX twin; ``state.opt_state`` is the
    same optimizer."""
    params = params_from_jax(params, device)
    for t in leaves(params):
        t.requires_grad_(True)
    opt = make_optimizer(params, tc)
    return TrainState(params, opt, 0), opt


class StepMetrics(NamedTuple):
    loss: Tensor  # total loss
    nll: Tensor  # likelihood term ("loss_final" in the reference)
    kl: Tensor  # regularization sum ("regularization_loss")
    accuracy: Tensor  # pixel accuracy


def one_hot_flatten(y: Tensor, n_classes: int) -> Tensor:
    """Labels [B, H, W] -> one-hot flattened [B, H*W, C]
    (`Hippocampus.py:612-615`). A label outside ``[0, n_classes)`` gives an
    all-zero row, as ``tf.one_hot`` and ``jax.nn.one_hot`` do: the targeted
    Hippocampus attack relabels to class 3 of 3 (`Hippocampus.py:917`).
    ``F.one_hot`` would raise there (a device-side assert on the card)."""
    classes = torch.arange(n_classes, device=y.device)
    y1 = (y.long().unsqueeze(-1) == classes).to(torch.float32)
    return y1.reshape(y.shape[0], -1, n_classes)


def ensure_one_hot(y: Tensor, n_classes: int) -> Tensor:
    """Integer label maps [B, H, W] become one-hot [B, H*W, C] on their own
    device; one-hot input passes through."""
    if y.dim() == 3 and not torch.is_floating_point(y):
        return one_hot_flatten(y, n_classes)
    return y


def _to_device(params: Params, x, y) -> Tuple[Tensor, Tensor]:
    """x (float32) and y as tensors on the parameters' device."""
    device = next(iter(params.values()))["w_mu"].device
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x, torch.as_tensor(y, device=device)


def _batch(params: Params, x, y, n_classes: int) -> Tuple[Tensor, Tensor]:
    """x and y as tensors on the parameters' device; integer labels are
    one-hot encoded there (the host ships 4-byte labels)."""
    x, y = _to_device(params, x, y)
    return x, ensure_one_hot(y, n_classes)


def maybe_augment(
    step: int,
    x: Tensor,
    y: Tensor,
    cfg: ModelConfig,
    tc: TrainConfig,
    index_offset: int = 0,
) -> Tuple[Tensor, Tensor]:
    """On-device augmentation inside the step (``tc.augment``); identity
    when disabled. Keyed by ``tc.seed``, the step counter and the global
    image index (``index_offset`` + the image's place in the batch), so a
    sharded batch augments like the whole one."""
    if tc.augment is None:
        return x, y
    from supernet_tpu_torch.data.augment import augment_train_batch

    with torch.no_grad():
        return augment_train_batch(
            step, x, y, cfg.out_size, tc.augment, tc.seed, index_offset
        )


def loss_fn(
    params: Params, x: Tensor, y: Tensor, cfg: ModelConfig, tc: TrainConfig
) -> Tuple[Tensor, Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """Total loss and ``(nll, kl, probs, sigma)``. ``y`` is one-hot
    flattened [B, N, C] or an integer label map [B, H, W]."""
    y = ensure_one_hot(y, cfg.n_classes)
    probs, sigma = forward(params, x, cfg)
    kl = kl_regularizer(params)
    loss = elbo_loss(
        y, probs, sigma, kl, tc.kl_factor, tc.sigma_clip_min, tc.sigma_clip_max
    )
    with torch.no_grad():
        nll = nll_gaussian(
            y, probs, torch.clamp(sigma, tc.sigma_clip_min, tc.sigma_clip_max)
        )
    return loss, (nll, kl.detach(), probs.detach(), sigma.detach())


def make_adversarial_examples(
    params: Params, x: Tensor, y: Tensor, cfg: ModelConfig, tc: TrainConfig
) -> Tensor:
    """FGSM / PGD examples for adversarial training, made against the
    current parameters and detached. ``y`` is one-hot flattened. The
    projection is the eval attack's (`Hippocampus.py:930-932`): the L-inf
    ball of ``tc.adv_epsilon`` around ``x`` cut with the batch's data range."""
    ac = AttackConfig(
        epsilon=tc.adv_epsilon,
        step_size=tc.adv_step_size,
        max_adv_step=tc.adv_steps,
    )
    if tc.adversarial_training == "fgsm":
        attack = make_fgsm_attack(cfg, ac)
    elif tc.adversarial_training == "pgd":
        attack = make_pgd_attack(cfg, ac)
    else:
        raise ValueError(
            f"unknown adversarial_training mode {tc.adversarial_training!r}"
        )
    return attack(params, x, y, x.min(), x.max())


def mixed_loss(
    params: Params, x: Tensor, adv_x: Tensor, y: Tensor, cfg: ModelConfig,
    tc: TrainConfig,
):
    """``adv_alpha * L(clean) + (1 - adv_alpha) * L(adv)`` and the clean
    branch's ``(nll, kl, probs, sigma)``, so that logged accuracy and curves
    compare with standard training. ``adv_alpha = 0`` trains on the
    adversarial examples only."""
    loss_c, aux = loss_fn(params, x, y, cfg, tc)
    loss_a, _ = loss_fn(params, adv_x, y, cfg, tc)
    return tc.adv_alpha * loss_c + (1.0 - tc.adv_alpha) * loss_a, aux


def training_loss(
    params: Params, x: Tensor, y: Tensor, cfg: ModelConfig, tc: TrainConfig
):
    """The training objective and its auxiliaries: ``loss_fn``, or with
    ``tc.adversarial_training`` the mixed loss on examples made here (the
    objective of the JAX package's ``value_and_grad_step``). ``y`` must be
    one-hot flattened in the adversarial modes."""
    if tc.adversarial_training == "none":
        return loss_fn(params, x, y, cfg, tc)
    adv_x = make_adversarial_examples(params, x, y, cfg, tc)
    return mixed_loss(params, x, adv_x, y, cfg, tc)


def _accuracy(probs: Tensor, y1: Tensor) -> Tuple[Tensor, Tensor]:
    pred = probs.argmax(dim=-1).to(torch.int32)  # [B, H*W]
    return pred, (pred == y1.argmax(dim=-1)).to(torch.float32).mean()


def _update(state: TrainState, tc: TrainConfig) -> None:
    """Clip each gradient, take the Adam step, clear the gradients."""
    clip_by_per_tensor_norm([t.grad for t in leaves(state.params)], tc.clipnorm)
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    state.step += 1


def _train_step(state: TrainState, x, y, cfg: ModelConfig, tc: TrainConfig):
    x, y = _to_device(state.params, x, y)
    x, y = maybe_augment(state.step, x, y, cfg, tc)
    y = ensure_one_hot(y, cfg.n_classes)
    state.opt_state.zero_grad(set_to_none=True)
    loss, (nll, kl, probs, _) = training_loss(state.params, x, y, cfg, tc)
    loss.backward()
    _update(state, tc)
    pred, acc = _accuracy(probs, y)
    return state, StepMetrics(loss.detach(), nll, kl, acc), pred


def make_train_step(cfg: ModelConfig, tc: TrainConfig, with_pred: bool = False):
    """``step(state, x, y) -> (state, metrics)``, or ``(state, metrics,
    pred)`` with ``with_pred`` (the per-pixel argmax [B, H*W]). The state
    is updated in place."""
    def step(state: TrainState, x, y):
        state, m, pred = _train_step(state, x, y, cfg, tc)
        return (state, m, pred) if with_pred else (state, m)

    return step


def _stack(ms):
    return StepMetrics(*(torch.stack(f) for f in zip(*ms)))


def make_multi_train_step(
    cfg: ModelConfig, tc: TrainConfig, k_steps: int, with_pred: bool = False
):
    """K train steps per call on stacked batches ``x [K, B, H, W, C]``,
    ``y [K, B, H, W]``; metrics (and predictions) stacked along a leading
    K axis. The JAX twin's ``lax.scan`` is a loop here."""
    def steps(state: TrainState, x, y):
        ms, preds = [], []
        for i in range(k_steps):
            state, m, pred = _train_step(state, x[i], y[i], cfg, tc)
            ms.append(m)
            preds.append(pred)
        out = _stack(ms)
        return (state, out, torch.stack(preds)) if with_pred else (state, out)

    return steps


def make_accum_train_step(cfg: ModelConfig, tc: TrainConfig, n_micro: int):
    """One update from ``n_micro`` microbatches ``x [n_micro, B, ...]``,
    ``y [n_micro, B, ...]``: the gradients are summed over the
    microbatches and divided by ``n_micro`` (one batch of ``n_micro * B``),
    the metrics averaged."""
    def step(state: TrainState, x, y):
        state.opt_state.zero_grad(set_to_none=True)
        m_sum = None
        for i in range(n_micro):
            xb, yb = _batch(state.params, x[i], y[i], cfg.n_classes)
            loss, (nll, kl, probs, _) = training_loss(state.params, xb, yb, cfg, tc)
            loss.backward()  # accumulates into .grad
            _, acc = _accuracy(probs, yb)
            m = torch.stack([loss.detach(), nll, kl, acc])
            m_sum = m if m_sum is None else m_sum + m
        with torch.no_grad():
            for t in leaves(state.params):
                t.grad.div_(n_micro)
        _update(state, tc)
        m = m_sum / n_micro
        return state, StepMetrics(m[0], m[1], m[2], m[3])

    return step


def make_eval_step(cfg: ModelConfig, tc: TrainConfig):
    """``step(params, x, y) -> (probs, sigma, pred, loss, acc)``: forward,
    validation loss (clipped NLL + kl_factor * 0.5 * KL) and accuracy, no
    gradients."""

    @torch.no_grad()
    def step(params: Params, x, y):
        x, y = _batch(params, x, y, cfg.n_classes)
        probs, sigma = forward(params, x, cfg)
        sigma_c = torch.clamp(sigma, tc.sigma_clip_min, tc.sigma_clip_max)
        loss = nll_gaussian(y, probs, sigma_c) + tc.kl_factor * 0.5 * kl_regularizer(params)
        pred, acc = _accuracy(probs, y)
        return probs, sigma, pred, loss, acc

    return step
