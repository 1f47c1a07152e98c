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

Under the bf16 activation mode (``ops.set_act_dtype``) the parameters, the
Adam state, the loss and the gradients stay float32: the forward casts
activations to bf16 and back where ``ops/moments.py`` says, and the casts'
backward returns float32 gradients, as in the JAX package.

With ``tc.adversarial_training`` ("fgsm" or "pgd") every step trains on
``adv_alpha * L(clean) + (1 - adv_alpha) * L(adv)``: the adversarial examples
are made inside the step against the current parameters (one or
``adv_steps`` extra forward and backward passes, the input gradient running
through the kernels' backward) and detached, so they act as fixed data for
the update.

Deep ensembles (``make_ensemble_train_step``, ``make_ensemble_eval_step``):
K members as one state whose every leaf, Adam moment included, carries a
leading member axis (``stack_trees`` / ``index_tree``). One Adam over the
stacked tensors is elementwise, so it is K Adams that take the same step
count; the gradient clip is per member and per tensor (a norm over every axis
but the member axis); the members' losses are summed before the backward, so
each member's gradient is its own loss's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np
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


@torch.no_grad()
def clip_by_per_member_norm(grads: Iterable[Tensor], max_norm: float) -> None:
    """``clip_by_per_tensor_norm`` for member-stacked gradients [K, ...]:
    each member's slice of each tensor is rescaled by its own norm, taken
    over every axis but the member axis. Clipping the stacked tensor as one
    would scale all K members by their joint norm."""
    for g in grads:
        n = torch.linalg.vector_norm(g.flatten(1), dim=1)
        scale = torch.where(n > max_norm, max_norm / torch.clamp_min(n, 1e-30), 1.0)
        g.mul_(scale.view((-1,) + (1,) * (g.dim() - 1)))


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
    seed: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """On-device augmentation inside the step (``tc.augment``); identity
    when disabled. Keyed by ``tc.seed`` (or ``seed``: the ensemble step
    passes member k's ``tc.seed + k``), the step counter and the global
    image index (``index_offset`` + the image's place in the batch), so a
    sharded batch augments like the whole one."""
    if tc.augment is None:
        return x, y
    from supernet_tpu_torch.data.augment import augment_train_batch

    with torch.no_grad():
        return augment_train_batch(
            step, x, y, cfg.out_size, tc.augment,
            tc.seed if seed is None else seed, index_offset,
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
    params: Params, x: Tensor, y: Tensor, cfg: ModelConfig, tc: TrainConfig,
    x_range=None,
) -> Tensor:
    """FGSM / PGD examples for adversarial training, made against the
    current parameters and detached. ``y`` is one-hot flattened. The
    projection is the eval attack's (`Hippocampus.py:930-932`): the L-inf
    ball of ``tc.adv_epsilon`` around ``x`` cut with the batch's data range,
    ``x_range`` = (min, max) when given (a shard passes the global batch's:
    ``parallel/data_parallel.py``), else ``x``'s own."""
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
    lo, hi = (x.min(), x.max()) if x_range is None else x_range
    return attack(params, x, y, lo, hi)


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
    params: Params, x: Tensor, y: Tensor, cfg: ModelConfig, tc: TrainConfig,
    x_range=None,
):
    """The training objective and its auxiliaries: ``loss_fn``, or with
    ``tc.adversarial_training`` the mixed loss on examples made here (the
    objective of the JAX package's ``value_and_grad_step``). ``y`` must be
    one-hot flattened in the adversarial modes; ``x_range`` as in
    ``make_adversarial_examples``."""
    if tc.adversarial_training == "none":
        return loss_fn(params, x, y, cfg, tc)
    adv_x = make_adversarial_examples(params, x, y, cfg, tc, x_range)
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


# ------------------------------------------------------------ deep ensembles


def _tree_map(fn, *trees):
    """``fn`` over the leaves of like nested dicts."""
    if isinstance(trees[0], dict):
        return {key: _tree_map(fn, *(t[key] for t in trees)) for key in trees[0]}
    return fn(*trees)


def _opt_config(state: TrainState) -> TrainConfig:
    """A TrainConfig with the optimizer settings of ``state``."""
    d = state.opt_state.defaults
    return dataclasses.replace(TrainConfig(), lr=d["lr"], adam_eps=d["eps"])


def _state_of(snap: dict, like: TrainState) -> TrainState:
    from supernet_tpu_torch.checkpoint import state_from_snapshot

    device = leaves(like.params)[0].device
    return state_from_snapshot(snap, _opt_config(like), device)


def stack_trees(trees):
    """Stack K like trees along a new leading member axis: parameter dicts
    (tensors, numpy or JAX arrays; the result is tensors, on the tensors'
    device), checkpoint snapshots, or ``TrainState``s, whose parameters and
    Adam moments are stacked into one state with one optimizer (the members
    must have taken the same number of steps). The counterpart of
    ``supernet_tpu/train.py:stack_trees``."""
    trees = list(trees)
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    if isinstance(trees[0], TrainState):
        from supernet_tpu_torch.checkpoint import snapshot_state

        return _state_of(stack_trees([snapshot_state(t) for t in trees]), trees[0])

    def stack(*xs):
        if isinstance(xs[0], (int, float)):  # a snapshot's step counters
            if any(x != xs[0] for x in xs):
                raise ValueError(f"the members have taken different steps: {xs}")
            return xs[0]
        return torch.stack([x.detach() if isinstance(x, Tensor)
                            else torch.from_numpy(np.array(x, np.float32)) for x in xs])

    return _tree_map(stack, *trees)


def index_tree(tree, k: int):
    """Member ``k`` of a stacked tree: views of a parameter dict's or a
    snapshot's tensors (a gradient through a view reaches the stacked
    tensor), or a ``TrainState`` of its own (parameters, Adam moments and
    step on the same device, a fresh optimizer)."""
    if isinstance(tree, TrainState):
        from supernet_tpu_torch.checkpoint import snapshot_state

        return _state_of(index_tree(snapshot_state(tree), k), tree)
    return _tree_map(lambda a: a[k] if hasattr(a, "shape") else a, tree)


def n_members(params: Params) -> int:
    """The member count of stacked parameters."""
    return leaves(params)[0].shape[0]


def _seeds(seeds, k_members: int, tc: TrainConfig):
    """Member augmentation seeds as ints: ``tc.seed + k`` unless given."""
    if seeds is None:
        return [tc.seed + k for k in range(k_members)]
    return [int(v) for v in np.asarray(torch.as_tensor(seeds).cpu())]


def _check_member_mode(member_mode: str, mesh) -> None:
    if member_mode not in ("vmap", "unroll", "scan"):
        raise ValueError(f"unknown member_mode {member_mode!r}")
    if mesh is not None and member_mode != "vmap":
        raise ValueError(
            "mesh-sharded ensemble training requires member_mode='vmap'"
        )


def _block_view(state: TrainState, block: Optional[slice]):
    """The parameters the step differentiates: all members, or views of the
    members in ``block`` (their gradient lands in the stacked tensors'
    rows, the other rows' gradient is 0)."""
    if block is None:
        return state.params
    return _tree_map(lambda a: a[block], state.params)


def _member_sharded(step_block, mesh):
    """Member sharding over ``mesh``: ``step(state, x, y, seeds)`` with the
    whole member axis on every rank (K divisible by the mesh); each rank
    runs ``step_block`` on its block of members, then every rank's updated
    rows of the parameters and the Adam moments are gathered into every
    rank's state (the state stays replicated; no collective touches the
    forward or the backward), and the per-member metrics (and predictions)
    are gathered too."""
    from supernet_tpu_torch.parallel._comm import axis, gather_rows

    ax = axis(mesh, "data")

    def step(state: TrainState, x, y, seeds=None):
        k_members = n_members(state.params)
        if k_members % ax.size != 0:
            raise ValueError(
                f"{k_members} members must divide over the {ax.size}-rank "
                "mesh (parallel.make_mesh_for_batch(K), or pad the member "
                "axis as EnsembleTrainer does)"
            )
        per = k_members // ax.size
        block = slice(ax.index * per, (ax.index + 1) * per)
        state, m, pred = step_block(state, x, y, seeds, block)
        _gather_member_rows(state, block, ax)
        counts = [per] * ax.size
        m = StepMetrics(*(gather_rows(t, counts, ax) for t in m))
        return state, m, (None if pred is None else gather_rows(pred, counts, ax))

    return step


@torch.no_grad()
def _gather_member_rows(state: TrainState, block: slice, ax) -> None:
    """Every rank's ``block`` rows of each stacked parameter and Adam moment
    into every rank's tensors: one all-gather of a flat buffer."""
    from supernet_tpu_torch.parallel._comm import gather_rows

    tensors = leaves(state.params) + [
        v for st in state.opt_state.state.values() for k, v in st.items()
        if k != "step" and isinstance(v, Tensor)
    ]
    if ax.size == 1:
        return
    local = torch.cat([t[block].reshape(-1) for t in tensors])
    every = gather_rows(local, [local.numel()] * ax.size, ax).view(ax.size, -1)
    per = block.stop - block.start
    off = 0
    for t in tensors:
        n = t[block].numel()
        t.copy_(every[:, off:off + n].reshape((ax.size * per,) + tuple(t.shape[1:])))
        off += n


def _member_accuracy(probs: Tensor, y1: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-member argmax [K, B, N] and pixel accuracy [K]."""
    pred = probs.argmax(dim=-1).to(torch.int32)
    acc = (pred == y1.argmax(dim=-1)).to(torch.float32).flatten(1).mean(1)
    return pred, acc


def _ensemble_batch(state: TrainState, x, y, seeds, cfg: ModelConfig, tc: TrainConfig):
    """``x`` [K,B,...] and one-hot ``y1`` [K,B,N,C] on the parameters'
    device, member k augmented as the single-model step with seed
    ``seeds[k]`` augments it."""
    x, y = _to_device(state.params, x, y)
    k_members = x.shape[0]
    if tc.augment is not None:
        pairs = [maybe_augment(state.step, x[k], y[k], cfg, tc, seed=s)
                 for k, s in enumerate(_seeds(seeds, k_members, tc))]
        x = torch.stack([a for a, _ in pairs])
        y = torch.stack([b for _, b in pairs])
    if torch.is_floating_point(y):  # already one-hot [K, B, N, C]
        return x, y
    return x, one_hot_flatten(y.flatten(0, 1), cfg.n_classes).unflatten(0, (k_members, -1))


def _members_loss(params: Params, x: Tensor, y1: Tensor, cfg: ModelConfig,
                  tc: TrainConfig):
    """The K members' ELBOs [K] in one member-stacked forward, and their
    ``(nll, kl, probs)``."""
    probs, sigma = forward(params, x, cfg)
    kl = kl_regularizer(params)
    loss = elbo_loss(y1, probs, sigma, kl, tc.kl_factor, tc.sigma_clip_min,
                     tc.sigma_clip_max, members=True)
    with torch.no_grad():
        nll = nll_gaussian(y1, probs, torch.clamp(sigma, tc.sigma_clip_min,
                                                  tc.sigma_clip_max), members=True)
    return loss, (nll, kl.detach(), probs.detach())


def _members_training_loss(params: Params, x: Tensor, y1: Tensor, cfg: ModelConfig,
                           tc: TrainConfig):
    """The training objective of every member, [K] (``training_loss`` per
    member): with adversarial training, each member's examples are made
    against its own parameters (a loop over the members), then the mixed
    loss runs member-stacked."""
    if tc.adversarial_training == "none":
        return _members_loss(params, x, y1, cfg, tc)
    adv = torch.stack([
        make_adversarial_examples(index_tree(params, k), x[k], y1[k], cfg, tc)
        for k in range(x.shape[0])])
    loss_c, aux = _members_loss(params, x, y1, cfg, tc)
    loss_a, _ = _members_loss(params, adv, y1, cfg, tc)
    return tc.adv_alpha * loss_c + (1.0 - tc.adv_alpha) * loss_a, aux


def _block_inputs(x, y, seeds, block: Optional[slice], tc: TrainConfig):
    """``x``, ``y`` and the seeds of the members in ``block`` (all without)."""
    if block is None:
        return x, y, seeds
    k_members = len(x)
    seeds = _seeds(seeds, k_members, tc)
    return x[block], y[block], seeds[block]


def _ensemble_step(state: TrainState, x, y, seeds, cfg: ModelConfig, tc: TrainConfig,
                   member_mode: str, block: Optional[slice] = None):
    x, y, seeds = _block_inputs(x, y, seeds, block, tc)
    params = _block_view(state, block)
    x, y1 = _ensemble_batch(state, x, y, seeds, cfg, tc)
    state.opt_state.zero_grad(set_to_none=True)
    if member_mode == "vmap":
        loss, (nll, kl, probs) = _members_training_loss(params, x, y1, cfg, tc)
        # summed, not averaged: each member's gradient is that of its own loss
        loss.sum().backward()
        loss = loss.detach()
    else:
        outs = []
        for k in range(x.shape[0]):
            loss_k, (nll_k, kl_k, probs_k, _) = training_loss(
                index_tree(params, k), x[k], y1[k], cfg, tc)
            loss_k.backward()
            outs.append((loss_k.detach(), nll_k, kl_k, probs_k))
        loss, nll, kl = (torch.stack([o[i] for o in outs]) for i in range(3))
        probs = torch.stack([o[3] for o in outs])
    clip_by_per_member_norm([t.grad for t in leaves(state.params)], tc.clipnorm)
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    state.step += 1
    pred, acc = _member_accuracy(probs, y1)
    return state, StepMetrics(loss, nll, kl, acc), pred


def make_ensemble_train_step(cfg: ModelConfig, tc: TrainConfig, with_pred: bool = False,
                             mesh=None, member_mode: str = "vmap"):
    """K-member deep-ensemble training in one call, after
    ``supernet_tpu/train.py:make_ensemble_train_step``: ``step(state, x, y,
    seeds) -> (state, metrics[, pred])`` with a member-stacked ``state``
    (``stack_trees``), ``x`` [K,B,H,W,C], ``y`` [K,B,h,w] integer labels
    (each member its own shuffle) and ``seeds`` [K], member k's augmentation
    seed (None: ``tc.seed + k``); metrics are per member, [K], and ``pred``
    [K,B,h*w]. The state is updated in place.

    ``member_mode``:

    - ``"vmap"``: one member-stacked forward and backward; every kernel runs
      once per layer for all K members (the member axis of
      ``ops/kernels``), so a step launches what one single-model step does.
    - ``"unroll"`` and ``"scan"``: a Python loop of the single-model
      forward and backward over the members (K times the launches), then
      the same update. PyTorch traces nothing, so the two are one mode under
      two names, kept for the JAX package's.

    Both update with one Adam over the stacked tensors after the per-member
    clip; an unknown mode raises ``ValueError``.

    ``mesh`` (``parallel.make_mesh``, one process per device; ``"vmap"``
    only) shards the member axis: each rank trains its contiguous block of
    members (K must divide over the mesh) and the updated rows are gathered
    into every rank's state (see ``_member_sharded``)."""
    _check_member_mode(member_mode, mesh)

    def run(state, x, y, seeds, block=None):
        return _ensemble_step(state, x, y, seeds, cfg, tc, member_mode, block)

    inner = run if mesh is None else _member_sharded(run, mesh)

    def step(state: TrainState, x, y, seeds=None):
        state, m, pred = inner(state, x, y, seeds)
        return (state, m, pred) if with_pred else (state, m)

    return step


def make_ensemble_eval_step(cfg: ModelConfig, tc: TrainConfig):
    """Per-member validation on one shared batch, after
    ``supernet_tpu/train.py:make_ensemble_eval_step``: ``step(params, x, y)
    -> (probs, sigma, pred, loss, acc)`` with a leading member axis, from
    member-stacked ``params``, ``x`` [B,H,W,C] (read by every member through
    a stride-0 view, never copied) and ``y`` [B,h,w]."""

    @torch.no_grad()
    def step(params: Params, x, y):
        x, y1 = _batch(params, x, y, cfg.n_classes)
        k_members = n_members(params)
        probs, sigma = forward(params, x.expand(k_members, *x.shape), cfg)
        sigma_c = torch.clamp(sigma, tc.sigma_clip_min, tc.sigma_clip_max)
        y1 = y1.expand(k_members, *y1.shape)
        loss = (nll_gaussian(y1, probs, sigma_c, members=True)
                + tc.kl_factor * 0.5 * kl_regularizer(params))
        pred, acc = _member_accuracy(probs, y1)
        return probs, sigma, pred, loss, acc

    return step
