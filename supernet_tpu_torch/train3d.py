"""Training for the volumetric family (``models/unet3d.py``): the
counterpart of ``supernet_tpu/train3d.py``.

The same step as the 2-D port's (``train.py``): value-and-grad of the ELBO
through ``forward3d``, Keras-style per-tensor gradient clipping, Adam with
epsilon 1e-7, the state updated in place. ``Trainer3D`` is the epoch loop
over in-memory cubes: a seeded permutation per epoch, validation with the
whole-foreground Dice, a checkpoint per epoch in the ``epoch_{N}/state.pt``
scheme of the 2-D ``Trainer``, ``continue_training``, roll-back to the last
good checkpoint after a non-finite epoch, the curve PNGs, the history pickle
and the center-slice uncertainty report.

Data: [N, S, S, S, C] cubes and [N, S, S, S] integer labels, what
``data.volume_to_cube`` or ``data.synthetic_volumes`` produce. Everything
runs on one device (``device``, the card unless the caller names another);
the mesh modes raise ``NotImplementedError`` naming their ROADMAP.md item.
The deep-ensemble steps (``make_ensemble_train_step3d``,
``make_ensemble_eval_step3d``) take the 2-D steps' member-stacked state;
their epoch loop is ``ensemble.EnsembleTrainer3D``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from supernet_tpu_torch import checkpoint as ckpt
from supernet_tpu_torch import reports
from supernet_tpu_torch.configs import ExperimentConfig, ModelConfig, TrainConfig
from supernet_tpu_torch.losses import elbo_loss, nll_gaussian
from supernet_tpu_torch.models import forward3d, init_params3d, kl_regularizer3d
from supernet_tpu_torch.models.unet3d import stage_shapes3d
from supernet_tpu_torch.ops.moments3d import crop_center3d
from supernet_tpu_torch.train import (
    StepMetrics,
    TrainState,
    _accuracy,
    _check_member_mode,
    _member_accuracy,
    _seeds,
    _stack,
    _to_device,
    _update,
    clip_by_per_member_norm,
    create_train_state,
    index_tree,
    leaves,
    n_members,
    one_hot_flatten,
)

Tensor = torch.Tensor


def _unported(what: str, item: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: '{item}', {where})"
    )


def _crop_center_vol(y: np.ndarray, size: int) -> np.ndarray:
    """Center-crop [N, S, S, S] label cubes to [N, size, size, size]."""
    return crop_center3d(y, size, size, size)


def _loss3d(params, x: Tensor, y1h: Tensor, cfg: ModelConfig, tc: TrainConfig,
            constrain=None):
    """The ELBO of ``forward3d`` and ``(nll, probs)``; ``y1h`` one-hot
    flattened [B, out^3, C]."""
    probs, sigma = forward3d(params, x, cfg, constrain=constrain)
    loss = elbo_loss(y1h, probs, sigma, kl_regularizer3d(params), tc.kl_factor,
                     tc.sigma_clip_min, tc.sigma_clip_max)
    with torch.no_grad():
        nll = nll_gaussian(y1h, probs,
                           torch.clamp(sigma, tc.sigma_clip_min, tc.sigma_clip_max))
    return loss, nll, probs.detach()


def _train_step3d(state: TrainState, x, y, cfg: ModelConfig, tc: TrainConfig,
                  constrain=None):
    """The volumetric step (``supernet_tpu/train3d.py:_train_step3d``):
    ``y`` is an int label cube [B, out, out, out], one-hot encoded on the
    device. With ``tc.augment`` the batch is augmented there first, keyed by
    the seed and the state's step counter. ``kl`` in the metrics is that of
    the updated parameters, as in the JAX step."""
    x, y = _to_device(state.params, x, y)
    if tc.augment is not None:
        from supernet_tpu_torch.data.augment import _mix, augment_volumes

        with torch.no_grad():
            x, y = augment_volumes(_mix(tc.seed, state.step), x, y, tc.augment)
    y1h = one_hot_flatten(y, cfg.n_classes)
    state.opt_state.zero_grad(set_to_none=True)
    loss, nll, probs = _loss3d(state.params, x, y1h, cfg, tc, constrain)
    loss.backward()
    _update(state, tc)
    with torch.no_grad():
        _, acc = _accuracy(probs, y1h)
        kl = kl_regularizer3d(state.params)
    return state, StepMetrics(loss.detach(), nll, kl, acc)


def make_train_step3d(cfg: ModelConfig, tc: TrainConfig):
    """``step(state, x, y) -> (state, metrics)``, the state updated in
    place; ``y`` an int label cube [B, out, out, out]."""
    def step(state: TrainState, x, y):
        return _train_step3d(state, x, y, cfg, tc)

    return step


def make_multi_train_step3d(cfg: ModelConfig, tc: TrainConfig, k_steps: int):
    """K volumetric steps per call on stacked batches ``x [K, B, S, S, S,
    C]``, ``y [K, B, o, o, o]``; metrics stacked along a leading K axis.
    The JAX twin's ``lax.scan`` is a loop here."""
    def steps(state: TrainState, x, y):
        ms = []
        for i in range(k_steps):
            state, m = _train_step3d(state, x[i], y[i], cfg, tc)
            ms.append(m)
        return state, _stack(ms)

    return steps


def _ensemble_step3d(state: TrainState, x, y, seeds, cfg: ModelConfig,
                     tc: TrainConfig, member_mode: str):
    x, y = _to_device(state.params, x, y)
    k_members = x.shape[0]
    if tc.augment is not None:
        from supernet_tpu_torch.data.augment import _mix, augment_volumes

        with torch.no_grad():
            pairs = [augment_volumes(_mix(s, state.step), x[k], y[k], tc.augment)
                     for k, s in enumerate(_seeds(seeds, k_members, tc))]
        x = torch.stack([a for a, _ in pairs])
        y = torch.stack([b for _, b in pairs])
    y1h = one_hot_flatten(y.flatten(0, 1), cfg.n_classes).unflatten(0, (k_members, -1))
    state.opt_state.zero_grad(set_to_none=True)
    if member_mode == "vmap":
        probs, sigma = forward3d(state.params, x, cfg)
        loss = elbo_loss(y1h, probs, sigma, kl_regularizer3d(state.params),
                         tc.kl_factor, tc.sigma_clip_min, tc.sigma_clip_max,
                         members=True)
        with torch.no_grad():
            nll = nll_gaussian(y1h, probs, torch.clamp(
                sigma, tc.sigma_clip_min, tc.sigma_clip_max), members=True)
        loss.sum().backward()  # summed: each member's gradient is its own loss's
        loss, probs = loss.detach(), probs.detach()
    else:
        outs = []
        for k in range(k_members):
            loss_k, nll_k, probs_k = _loss3d(index_tree(state.params, k), x[k],
                                             y1h[k], cfg, tc)
            loss_k.backward()
            outs.append((loss_k.detach(), nll_k, probs_k))
        loss, nll, probs = (torch.stack([o[i] for o in outs]) for i in range(3))
    clip_by_per_member_norm([t.grad for t in leaves(state.params)], tc.clipnorm)
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    state.step += 1
    with torch.no_grad():
        _, acc = _member_accuracy(probs, y1h)
        kl = kl_regularizer3d(state.params)
    return state, StepMetrics(loss, nll, kl, acc)


def make_ensemble_train_step3d(cfg: ModelConfig, tc: TrainConfig, mesh=None,
                               member_mode: str = "vmap"):
    """The volumetric twin of ``train.make_ensemble_train_step``
    (``supernet_tpu/train3d.py:make_ensemble_train_step3d``): ``step(state,
    x, y, seeds) -> (state, metrics)`` with a member-stacked state, ``x``
    [K,B,S,S,S,C], ``y`` [K,B,o,o,o] integer label cubes and ``seeds`` [K]
    (member k augmented as ``make_train_step3d`` with ``tc.seed + k``
    augments); metrics per member, ``kl`` of the updated parameters.
    ``"vmap"`` runs one member-stacked forward (``forward3d``: each conv
    layer's members one after the other through cuDNN) and one backward;
    ``"unroll"`` and ``"scan"`` loop the single-model forward and backward
    over the members. ``mesh`` raises naming 'Parallelism'."""
    _check_member_mode(member_mode, mesh)

    def step(state: TrainState, x, y, seeds=None):
        return _ensemble_step3d(state, x, y, seeds, cfg, tc, member_mode)

    return step


def make_ensemble_eval_step3d(cfg: ModelConfig, tc: TrainConfig):
    """Per-member volumetric validation on one shared batch:
    ``step(params, x, y) -> (loss, acc, pred)`` with a leading member axis,
    the ELBO with its KL as in ``make_eval_step3d``."""

    @torch.no_grad()
    def step(params, x, y):
        x, y = _to_device(params, x, y)
        k_members = n_members(params)
        y1h = one_hot_flatten(y, cfg.n_classes).expand(k_members, -1, -1, -1)
        probs, sigma = forward3d(params, x.expand(k_members, *x.shape), cfg)
        loss = elbo_loss(y1h, probs, sigma, kl_regularizer3d(params), tc.kl_factor,
                         tc.sigma_clip_min, tc.sigma_clip_max, members=True)
        pred, acc = _member_accuracy(probs, y1h)
        return loss, acc, pred

    return step


def make_eval_step3d(cfg: ModelConfig, tc: TrainConfig):
    """``step(params, x, y) -> (loss, acc, pred)``: the ELBO (KL included,
    as the JAX eval step has it), voxel accuracy and the argmax [B, out^3],
    without gradients."""

    @torch.no_grad()
    def step(params, x, y):
        x, y = _to_device(params, x, y)
        y1h = one_hot_flatten(y, cfg.n_classes)
        probs, sigma = forward3d(params, x, cfg)
        loss = elbo_loss(y1h, probs, sigma, kl_regularizer3d(params), tc.kl_factor,
                         tc.sigma_clip_min, tc.sigma_clip_max)
        pred, acc = _accuracy(probs, y1h)
        return loss, acc, pred

    return step


def _dice_foreground(y_true: np.ndarray, pred: np.ndarray) -> float:
    """Whole-foreground Dice of [N, ...] int volumes, through the 2-D
    per-image Dice on an [N, -1, last] view."""
    from supernet_tpu_torch.metrics import dice

    t = (y_true > 0).astype(np.float64)
    p = (pred > 0).astype(np.float64)
    n = len(t)
    d, _ = dice(t.reshape(n, -1, t.shape[-1]), p.reshape(n, -1, p.shape[-1]))
    return d


class Trainer3D:
    """Epoch loop over cube datasets held in memory, on one device.

    ``initial_params`` (a JAX-layout dict, e.g. ``models.inflate_params3d``
    of a 2-D checkpoint) replaces the seeded init; a checkpoint found under
    ``continue_training`` still wins. ``steps_per_dispatch = K > 1`` runs K
    batches per call of ``make_multi_train_step3d``. ``mesh`` raises
    (ROADMAP.md, Queue 1: 'Parallelism')."""

    def __init__(
        self,
        exp: ExperimentConfig,
        x: np.ndarray,
        y: np.ndarray,
        x_val: Optional[np.ndarray] = None,
        y_val: Optional[np.ndarray] = None,
        out_dir: Optional[str] = None,
        mesh=None,
        shard: str = "batch",
        initial_params=None,
        steps_per_dispatch: int = 1,
        device="cuda",
    ):
        if mesh is not None:
            raise _unported(f"Trainer3D over a device mesh (shard={shard!r})",
                            "Parallelism", "parallel/spatial.py")
        self.exp, self.cfg, self.tc = exp, exp.model, exp.train
        self.device = torch.device(device)
        self.initial_params = initial_params
        self.x, self.y = np.asarray(x, np.float32), np.asarray(y, np.int32)
        self.x_val = x_val if x_val is None else np.asarray(x_val, np.float32)
        self.y_val = y_val if y_val is None else np.asarray(y_val, np.int32)
        self.out_dir = out_dir or os.path.join(
            exp.out_dir, exp.name + "_3d", "saved_models_SUPER_u-Net"
        )
        if len(self.x) < self.tc.batch_size:
            raise ValueError(
                f"{len(self.x)} training volumes < batch_size "
                f"{self.tc.batch_size}: every epoch would run zero steps"
            )
        self.y_crop = _crop_center_vol(self.y, self.cfg.out_size)
        self.y_val_crop = (
            None if self.y_val is None
            else _crop_center_vol(self.y_val, self.cfg.out_size)
        )
        self.k_steps = max(1, steps_per_dispatch)
        self._single_step = None
        if self.k_steps > 1:
            self.step_fn = make_multi_train_step3d(self.cfg, self.tc, self.k_steps)
        else:
            self.step_fn = make_train_step3d(self.cfg, self.tc)
        self.eval_fn = make_eval_step3d(self.cfg, self.tc)
        self.history: Dict[str, List[float]] = {
            "train_loss": [], "train_acc": [],
            "val_loss": [], "val_acc": [], "val_dice": [],
        }

    def _put(self, a) -> Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _batches(self, x, y, rng):
        """Full batches in a fresh permutation."""
        idx = rng.permutation(len(x))
        b = self.tc.batch_size
        for i in range(0, len(x) - b + 1, b):
            yield x[idx[i:i + b]], y[idx[i:i + b]]

    def init_state(self) -> TrainState:
        params = self.initial_params
        if params is None:
            params = init_params3d(
                torch.Generator().manual_seed(self.tc.seed), self.cfg, "cpu")
        state, _ = create_train_state(params, self.tc, self.device)
        self.start_epoch = 0
        if self.tc.continue_training:
            latest = ckpt.latest_epoch(self.out_dir)
            if latest is not None:
                state = ckpt.restore_state(self.out_dir, latest, self.tc, self.device)
                self.start_epoch = latest + 1
        return state

    def run(self, epochs: Optional[int] = None, log=print) -> TrainState:
        epochs = epochs if epochs is not None else self.tc.epochs
        state = self.init_state()
        rng = np.random.default_rng(self.tc.seed)
        writer = ckpt.AsyncEpochCheckpointer(self.out_dir)
        try:
            state = self._run_epochs(state, self.start_epoch, epochs, rng, writer, log)
            writer.wait()
        finally:
            writer.close()
        return self._finish(state)

    def _run_epochs(self, state, start, epochs, rng, writer, log):
        tc = self.tc
        last_good: Optional[int] = None
        t0 = time.perf_counter()
        for epoch in range(start, epochs):
            losses, accs = [], []
            xs, ys = [], []
            for xb, yb in self._batches(self.x, self.y_crop, rng):
                if self.k_steps > 1:
                    xs.append(xb)
                    ys.append(yb)
                    if len(xs) < self.k_steps:
                        continue
                    state, ms = self.step_fn(
                        state, self._put(np.stack(xs)), self._put(np.stack(ys)))
                    xs, ys = [], []
                    losses += ms.loss.cpu().tolist()
                    accs += ms.accuracy.cpu().tolist()
                    continue
                state, m = self.step_fn(state, self._put(xb), self._put(yb))
                losses.append(float(m.loss))
                accs.append(float(m.accuracy))
            for xb, yb in zip(xs, ys):
                # trailing batches below a chunk take the single step
                if self._single_step is None:
                    self._single_step = make_train_step3d(self.cfg, self.tc)
                state, m = self._single_step(state, self._put(xb), self._put(yb))
                losses.append(float(m.loss))
                accs.append(float(m.accuracy))
            self.history["train_loss"].append(float(np.mean(losses)))
            self.history["train_acc"].append(float(np.mean(accs)))
            vols_s = len(losses) * tc.batch_size / max(time.perf_counter() - t0, 1e-9)
            log(
                f"epoch {epoch}: loss={self.history['train_loss'][-1]:.4f} "
                f"acc={self.history['train_acc'][-1]:.4f} "
                f"({vols_s:.2f} vols/s cum)"
            )
            if not np.isfinite(self.history["train_loss"][-1]):
                if last_good is None:
                    raise FloatingPointError(
                        f"non-finite loss in epoch {epoch} and no "
                        "checkpoint to roll back to"
                    )
                log(
                    f"epoch {epoch}: non-finite loss - rolling back to "
                    f"epoch {last_good} checkpoint"
                )
                writer.wait()  # the roll-back target may still be in flight
                state = ckpt.restore_state(self.out_dir, last_good, tc, self.device)
                t0 = time.perf_counter()
                continue
            if self.x_val is not None:
                self._validate(state, epoch, log)
            if (epoch + 1) % tc.checkpoint_every == 0:
                writer.save(epoch, state)
                last_good = epoch
            t0 = time.perf_counter()
        return state

    def _finish(self, state: TrainState) -> TrainState:
        reports.save_training_curves(self.out_dir, self.history)
        reports.save_history_pickle(self.out_dir, self.history)
        if self.x_val is not None and len(self.x_val) >= self.tc.batch_size:
            self._save_val_report(state)
        return state

    def _save_val_report(self, state: TrainState) -> None:
        """Center-slice uncertainty renders and pickle from the first
        validation batch."""
        cfg, b = self.cfg, self.tc.batch_size
        xb = self.x_val[:b]
        with torch.no_grad():
            probs, sigma = forward3d(state.params, self._put(xb), cfg)
        o = cfg.out_size
        shape = (b, o, o, o, cfg.n_classes)
        reports.save_uncertainty_slices3d(
            self.out_dir,
            probs.cpu().numpy().reshape(shape),
            sigma.cpu().numpy().reshape(shape),
            xb,
            self.y_val_crop[:b],
            n_classes=cfg.n_classes,
        )

    def _validate(self, state: TrainState, epoch: int, log) -> None:
        cfg, b = self.cfg, self.tc.batch_size
        y_c = self.y_val_crop
        losses, accs, dices = [], [], []
        for i in range(0, len(self.x_val) - b + 1, b):
            loss, acc, pred = self.eval_fn(
                state.params, self._put(self.x_val[i:i + b]), self._put(y_c[i:i + b]))
            losses.append(float(loss))
            accs.append(float(acc))
            pred_vol = pred.cpu().numpy().reshape(b, cfg.out_size, cfg.out_size,
                                                  cfg.out_size)
            dices.append(_dice_foreground(y_c[i:i + b], pred_vol))
        if losses:
            self.history["val_loss"].append(float(np.mean(losses)))
            self.history["val_acc"].append(float(np.mean(accs)))
            self.history["val_dice"].append(float(np.nanmean(dices)))
            log(
                f"epoch {epoch} val: "
                f"loss={self.history['val_loss'][-1]:.4f} "
                f"acc={self.history['val_acc'][-1]:.4f} "
                f"dice={self.history['val_dice'][-1]:.4f}"
            )


def _out_side3d(cfg: ModelConfig) -> int:
    """The output cube side of ``forward3d`` at ``cfg.image_size``, from a
    forward on the ``meta`` device (shapes only)."""
    probs_shape = stage_shapes3d(cfg)[-1][1]  # conv_final: [1, o, o, o, C]
    side = probs_shape[1]
    if side <= 0 or probs_shape[1:4] != (side, side, side):
        raise ValueError(f"non-cubic traced output {probs_shape}")
    return side


def derive_out_size3d(cfg: ModelConfig) -> int:
    """Output cube side for an input of ``cfg.image_size``: the geometry of
    the VALID conv / pool chain, computed on the ``meta`` device (shapes,
    no FLOPs).

    A side too small for the config's depth makes the chain collapse (an
    encoder skip ends up smaller than the decoder tensor it is cropped to);
    the error then names the smallest side that works."""
    try:
        return _out_side3d(cfg)
    except ValueError:
        raise
    except Exception as e:
        for side in range(cfg.image_size + 1, cfg.image_size + 65):
            try:
                _out_side3d(dataclasses.replace(cfg, image_size=side))
            except Exception:
                continue
            raise ValueError(
                f"cube size {cfg.image_size} is not a valid geometry for "
                f"a depth-{cfg.depth} volumetric U-Net (the VALID "
                f"conv/pool chain collapses); the smallest valid side is "
                f"{side}"
            ) from e
        raise ValueError(
            f"cube size {cfg.image_size} is not a valid geometry for a "
            f"depth-{cfg.depth} volumetric U-Net, and no valid side was "
            f"found up to {cfg.image_size + 64}"
        ) from e
