"""Deep-ensemble training on one device: the counterpart of
``supernet_tpu/ensemble.py``.

K members train as one member-stacked state (``train.stack_trees``): every
update is one call of ``train.make_ensemble_train_step`` (or its 3-D twin),
and in the ``vmap`` mode every hand-written kernel runs once per layer for
all K members. The semantics are those of K sequential runs:

- member k's parameters are initialised from ``seed + k`` (``init_params``
  with a ``torch.Generator`` seeded ``seed + k``);
- member k's epoch shuffle is seeded ``seed + k``: each member sees its own
  data order, fed as stacked [K, B, ...] batches;
- member k's augmentation is keyed by ``seed + k``;
- per-member ``epoch_{N}/state.pt`` checkpoints in ``member_{k}/``, the
  layout that ``cli eval --checkpoint member_0,member_1,...`` and
  ``serving.EnsembleSession`` read;
- per-member validation curves, history pickles and hyperparameter dumps;
- ``continue_training`` resumes every member from the newest epoch all of
  them have.

``choose_ensemble_mode`` is the JAX package's crossover rule with constants
measured on the card (see its docstring).

With a ``mesh`` (one process per device) the member axis is sharded: each
rank trains a contiguous block of members and the updated rows are gathered
into every rank's state (``train.make_ensemble_train_step(mesh=)``). When K
does not divide the mesh the member axis is padded with members K.. (seeds
``seed + k``) that train and are discarded; rank 0 validates and writes.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from supernet_tpu_torch import checkpoint as ckpt
from supernet_tpu_torch import metrics as M
from supernet_tpu_torch import reports
from supernet_tpu_torch.configs import ExperimentConfig
from supernet_tpu_torch.train import (
    TrainState,
    create_train_state,
    index_tree,
    make_ensemble_eval_step,
    make_ensemble_train_step,
    stack_trees,
)

# Measured on an NVIDIA H100 80GB HBM3 at its 700.00 W power limit by
# chip_smoke.py phase 19 (PERF.md section 5): K = 4 hippocampus members at
# batch 20, 10 steps of each mode taken in turns. The sequential path's
# per-member step is one single-model step (27.68 ms); the faster one-program
# mode, vmap, took 0.309 of it per member (8.56 ms; unroll 23.99 ms). Across
# three calls the ratio read 0.174, 0.503 and 0.309: every 2-D step is
# host-bound and the host's speed moves between calls. In 3-D (cube 64, batch
# 4) the single-model step took 129.2 ms and a K = 2 vmap step 1.011 times
# two of them: that path is device-bound, and its members run one after the
# other through cuDNN. Nothing compiles per member in the port: a sequential
# member's start-up (its parameters, state and first step beyond a steady
# one) took 0.026 s. Override per deployment with the
# SUPERNET_ENSEMBLE_{COMPILE_S,STEP_S,STEP_RATIO} knobs.
ONE_PROGRAM_MODE = "vmap"
ONE_PROGRAM_STEP_RATIO = 0.309
ONE_PROGRAM_STEP3D_RATIO = 1.011
SEQUENTIAL_STEP_S = 0.02768
SEQUENTIAL_STEP3D_S = 0.1292
COMPILE_S = 0.026


def choose_ensemble_mode(
    n_members: int,
    total_steps: Optional[int],
    mesh=None,
    compile_s: Optional[float] = None,
    step_s: Optional[float] = None,
    step_ratio: Optional[float] = None,
):
    """The mode for ``--ensemble-mode auto``: ``(mode, reason)``, the JAX
    package's rule. With per-member step time ``t``, the one-program mode's
    per-step ratio ``r`` and a member's start-up ``c``:

        sequential:   K c + K total_steps t
        one-program:  1 c + K total_steps t r

    so the one-program mode (``ONE_PROGRAM_MODE``) wins iff
    ``(K-1) c > K total_steps t (r-1)``. ``SUPERNET_ENSEMBLE_MODE`` decides
    outright; on a mesh the answer is ``vmap``; an unsized stream
    (``total_steps`` None) keeps the one-program mode."""
    forced = os.environ.get("SUPERNET_ENSEMBLE_MODE")
    if forced:
        return forced, f"SUPERNET_ENSEMBLE_MODE={forced}"
    if mesh is not None:
        return "vmap", "mesh-sharded members run device-parallel"
    if total_steps is None:
        return ONE_PROGRAM_MODE, "unsized stream; keeping the one-compile mode"
    c = compile_s if compile_s is not None else float(
        os.environ.get("SUPERNET_ENSEMBLE_COMPILE_S", COMPILE_S)
    )
    t = step_s if step_s is not None else float(
        os.environ.get("SUPERNET_ENSEMBLE_STEP_S", SEQUENTIAL_STEP_S)
    )
    r = step_ratio if step_ratio is not None else float(
        os.environ.get("SUPERNET_ENSEMBLE_STEP_RATIO", ONE_PROGRAM_STEP_RATIO)
    )
    compile_saved_s = (n_members - 1) * c
    step_tax_s = n_members * total_steps * t * (r - 1.0)
    why = (
        f"K={n_members}, {total_steps} steps/member: one-program saves "
        f"{compile_saved_s:.0f}s of compiles, costs {step_tax_s:.0f}s of "
        f"per-step tax (x{r:.2f} on {t * 1e3:.1f}ms steps)"
    )
    if compile_saved_s > step_tax_s:
        return ONE_PROGRAM_MODE, why
    return "sequential", why


def _check(n_members: int, what: str) -> None:
    if n_members < 2:
        raise ValueError(f"{what} needs n_members >= 2")


def _n_pad(n_members: int, mesh) -> int:
    """Members added so that the member axis divides the mesh."""
    if mesh is None:
        return 0
    n_dev = int(mesh.mesh.numel())
    n_pad = (-n_members) % n_dev
    if n_pad:
        print(
            f"note: padding the member axis {n_members} -> "
            f"{n_members + n_pad} so it divides the {n_dev}-"
            "device mesh (pad members are trained and discarded)"
        )
    return n_pad


def _member_mode(member_mode: Optional[str]) -> str:
    return member_mode or os.environ.get("SUPERNET_ENSEMBLE_MODE", ONE_PROGRAM_MODE)


def _empty_history() -> Dict[str, List[float]]:
    return {"train_loss": [], "train_acc": [], "val_loss": [], "val_acc": [],
            "val_dice": []}


class _Base:
    """The epoch loop shared by the 2-D and 3-D trainers: state, resume,
    checkpoints, roll-back."""

    def _setup_mesh(self, n_members: int, mesh) -> None:
        from supernet_tpu_torch import parallel

        self.mesh = mesh
        self.n_train = n_members + _n_pad(n_members, mesh)
        self.writes = mesh is None or parallel.multihost.is_writer()

    def _sits_out(self) -> bool:
        """A rank outside a shrunken mesh: it builds no step and trains
        nothing."""
        from supernet_tpu_torch.parallel._comm import in_mesh

        return self.mesh is not None and not in_mesh(self.mesh)

    def _stack(self, members) -> TrainState:
        state = stack_trees(members)
        if self.mesh is not None:
            from supernet_tpu_torch import parallel

            state = parallel.replicate(self.mesh, state)
        return state

    def _fresh(self, k: int) -> TrainState:
        return create_train_state(self._init_one(k), self.tc, self.device)[0]

    def _init_members(self, init_one) -> TrainState:
        self._init_one = init_one
        members = [self._fresh(k) for k in range(self.n_train)]
        self.start_epoch = 0
        if self.tc.continue_training:
            latest = [ckpt.latest_epoch(d) for d in self.member_dirs]
            if all(e is not None for e in latest):
                # the newest epoch EVERY member has (an async writer can be
                # an epoch ahead for some members)
                epoch = min(latest)
                members = [ckpt.restore_state(d, epoch, self.tc, self.device)
                           for d in self.member_dirs] + members[self.n_members:]
                self.start_epoch = epoch + 1
            elif any(e is not None for e in latest):
                raise FileNotFoundError(
                    "continue_training: only some member dirs have "
                    f"checkpoints ({latest}); refusing a mixed resume"
                )
        return self._stack(members)

    def _restore(self, epoch: int) -> TrainState:
        """Every member's ``epoch`` checkpoint (pad members start afresh)."""
        return self._stack(
            [ckpt.restore_state(d, epoch, self.tc, self.device) for d in self.member_dirs]
            + [self._fresh(k) for k in range(self.n_members, self.n_train)])

    def run(self, epochs: Optional[int] = None, log=print) -> Optional[TrainState]:
        from supernet_tpu_torch.trainer import _Writer

        if self._sits_out():
            return None
        state = self.init_state()
        epochs = epochs if epochs is not None else self.tc.epochs
        writers = [_Writer(d, self.writes, self.mesh) for d in self.member_dirs]
        t_start = time.perf_counter()
        last_good: Optional[int] = None
        try:
            for epoch in range(self.start_epoch, epochs):
                state = self._train_epoch(state, epoch, log)
                bad = [k for k, h in enumerate(self.histories)
                       if not np.isfinite(h["train_loss"][-1])]
                if bad:
                    # one stacked state: a diverged member poisons its own
                    # slice only, but ALL members go back to the last good
                    # epoch so that the stack stays aligned
                    if last_good is None:
                        raise FloatingPointError(
                            f"non-finite loss in members {bad} at epoch "
                            f"{epoch} and no checkpoint to roll back to"
                        )
                    log(f"epoch {epoch}: non-finite loss in members {bad} "
                        f"- rolling back ALL members to epoch {last_good}")
                    for w in writers:
                        w.wait()
                    state = self._restore(last_good)
                    continue
                if self._has_validation() and self.writes:
                    self._validate(state, epoch, log)
                if (epoch + 1) % self.tc.checkpoint_every == 0:
                    # one host copy of the stacked state, sliced per member
                    snap = ckpt.snapshot_state(state)
                    for k, w in enumerate(writers):
                        w.save(epoch, index_tree(snap, k))
                    last_good = epoch
            for w in writers:
                w.wait()
        finally:
            for w in writers:
                w.close()
        self.total_time = time.perf_counter() - t_start
        if self.mesh is not None:
            # rank 0 validated: every rank reports the histories
            from supernet_tpu_torch.parallel._comm import broadcast_object

            self.histories = broadcast_object(self.histories, self.mesh)
        if self.writes:
            self._finalize(state)
        return state


class EnsembleTrainer(_Base):
    """Epoch loop of a K-member 2-D ensemble on one device: the JAX
    ``EnsembleTrainer``'s data, metrics, history keys and files per member.

    ``member_mode``: ``vmap`` (the member axis through the kernels),
    ``unroll`` / ``scan`` (a loop of the single-model step's forward and
    backward); None takes ``SUPERNET_ENSEMBLE_MODE`` or ``ONE_PROGRAM_MODE``.
    ``mesh`` shards the member axis (``vmap`` only; see the module
    docstring)."""

    def __init__(
        self,
        exp: ExperimentConfig,
        n_members: int,
        train_ds,
        val_ds=None,
        out_dir: Optional[str] = None,
        mesh=None,
        track_curves: bool = True,
        member_mode: Optional[str] = None,
        device="cuda",
    ):
        _check(n_members, "EnsembleTrainer")
        self.exp, self.cfg, self.tc = exp, exp.model, exp.train
        self.n_members = n_members
        self._setup_mesh(n_members, mesh)
        self.train_ds, self.val_ds = train_ds, val_ds
        self.device = torch.device(device)
        self.base_dir = out_dir or os.path.join(exp.out_dir, exp.name, "ensemble")
        self.member_dirs = [os.path.join(self.base_dir, f"member_{k}")
                            for k in range(n_members)]
        self.structures = M.dataset_structures(exp.name)
        # per-structure train curves: a [K, B, H*W] prediction fetch per step
        # and K x the host metrics; off under augmentation (the prediction is
        # of the augmented batch), as in Trainer
        self.track_curves = track_curves
        self.track_train_curves = track_curves and exp.train.augment is None
        self.member_mode = _member_mode(member_mode)
        self.step_fn = None if self._sits_out() else make_ensemble_train_step(
            self.cfg, self.tc, with_pred=self.track_train_curves,
            mesh=mesh, member_mode=self.member_mode)
        self.eval_fn = make_ensemble_eval_step(self.cfg, self.tc)
        self.seeds = np.arange(self.n_train, dtype=np.int32) + self.tc.seed
        self.histories = [_empty_history() for _ in range(n_members)]

    def init_state(self) -> TrainState:
        from supernet_tpu_torch.models import init_params

        return self._init_members(lambda k: init_params(
            torch.Generator().manual_seed(self.tc.seed + k), self.cfg, "cpu"))

    def _has_validation(self) -> bool:
        return self.val_ds is not None

    def _member_batches(self, epoch: int):
        """The K members' shuffles zipped into stacked [K, B, ...] batches;
        full batches only, so the stack is always rectangular."""
        from supernet_tpu_torch.trainer import _prep_batch

        iters = [self.train_ds.batches(self.tc.batch_size, shuffle=True,
                                       seed=self.tc.seed + k, epoch=epoch)
                 for k in range(self.n_train)]
        for group in zip(*iters):
            xs, ys = [], []
            for x, y in group:
                x, y_c = _prep_batch(x, y, self.cfg.out_size, self.cfg.n_classes)
                xs.append(np.asarray(x, np.float32))
                ys.append(np.ascontiguousarray(y_c, np.int32))
            yield np.stack(xs), np.stack(ys)

    def _train_epoch(self, state, epoch, log):
        from supernet_tpu_torch.profiling import StepTimer

        k_n = self.n_members
        losses = [[] for _ in range(k_n)]
        accs = [[] for _ in range(k_n)]
        t_dice = [{s: [] for s in self.structures} for _ in range(k_n)]
        t_haus = [{s: [] for s in self.structures} for _ in range(k_n)]
        timer = StepTimer()
        tick_imgs: List[int] = []
        tick_host: List[float] = []
        step = 0
        timer.tick()
        for xk, yk in self._member_batches(epoch):
            xb = torch.as_tensor(xk, device=self.device)
            yb = torch.as_tensor(yk, device=self.device)
            host_s = 0.0
            if self.track_train_curves:
                state, m, pred = self.step_fn(state, xb, yb, self.seeds)
                preds = pred.cpu().numpy()  # [K, B, H*W]; the fetch syncs
                t0 = time.perf_counter()
                for k in range(k_n):
                    pred_img = preds[k].reshape(yk[k].shape)
                    for s in self.structures:
                        tm = M.binarize(yk[k], s, self.exp.name)
                        pm = M.binarize(pred_img, s, self.exp.name)
                        d, _ = M.dice(tm, pm)
                        t_dice[k][s].append(d)
                        t_haus[k][s].append(M.compute_H(tm, pm))
                host_s = time.perf_counter() - t0
            else:
                state, m = self.step_fn(state, xb, yb, self.seeds)
            loss_k = m.loss.cpu().numpy()[:k_n]  # pad members are discarded
            acc_k = m.accuracy.cpu().numpy()[:k_n]
            for k in range(k_n):
                losses[k].append(float(loss_k[k]))
                accs[k].append(float(acc_k[k]))
            if step % self.tc.log_every == 0:
                log(f"epoch {epoch} step {step}: "
                    f"loss={np.array2string(loss_k, precision=4)} "
                    f"acc={np.array2string(acc_k, precision=4)}")
            step += 1
            timer.tick()
            tick_imgs.append(int(xk.shape[1]))  # per-member images
            tick_host.append(host_s)
        for k, h in enumerate(self.histories):
            h["train_loss"].append(float(np.mean(losses[k])))
            h["train_acc"].append(float(np.mean(accs[k])))
            if self.track_train_curves:
                for s in self.structures:
                    h.setdefault(f"train_dice_{s}", []).append(
                        float(np.nanmean(t_dice[k][s])))
                    h.setdefault(f"train_haus_{s}", []).append(
                        float(np.nanmean(t_haus[k][s])))
        timer.sync(state.params)
        n_ticks = len(tick_imgs)
        skip = 1 if n_ticks > 1 else 0
        secs = timer.times[-1] - timer.times[skip] if n_ticks > skip else 0.0
        secs -= sum(tick_host[skip:])
        imgs = sum(tick_imgs[skip:])
        # per member, comparable with the sequential path's images/sec; the
        # whole ensemble's rate is K times it
        ips = imgs / secs if secs > 0 else 0.0
        for h in self.histories:
            h.setdefault("images_per_sec", []).append(ips)
            h.setdefault("ensemble_images_per_sec", []).append(ips * k_n)
        log(f"epoch {epoch}: {ips:.4g} images/sec/member "
            f"({ips * k_n:.4g} ensemble-wide, {timer.total_seconds():.2f}s)")
        return state

    def _validate(self, state, epoch, log):
        from supernet_tpu_torch.trainer import _prep_batch

        k_n = self.n_members
        losses = [[] for _ in range(k_n)]
        accs = [[] for _ in range(k_n)]
        dices = [[] for _ in range(k_n)]
        v_dice = [{s: [] for s in self.structures} for _ in range(k_n)]
        v_haus = [{s: [] for s in self.structures} for _ in range(k_n)]
        for x, y in self.val_ds.batches(self.tc.batch_size, drop_remainder=False):
            x, y_c = _prep_batch(x, y, self.cfg.out_size, self.cfg.n_classes)
            _, _, pred, loss, acc = self.eval_fn(
                state.params, np.asarray(x, np.float32),
                np.ascontiguousarray(y_c, np.int32))
            loss, acc, preds = loss.cpu().numpy(), acc.cpu().numpy(), pred.cpu().numpy()
            for k in range(k_n):
                losses[k].append(float(loss[k]))
                accs[k].append(float(acc[k]))
                pred_img = preds[k].reshape(len(x), self.cfg.out_size, self.cfg.out_size)
                for s in self.structures:
                    tm = M.binarize(y_c, s, self.exp.name)
                    pm = M.binarize(pred_img, s, self.exp.name)
                    d, _ = M.dice(tm, pm)
                    dices[k].append(d)
                    v_dice[k][s].append(d)
                    if self.track_curves:
                        v_haus[k][s].append(M.compute_H(tm, pm))
        for k, h in enumerate(self.histories):
            h["val_loss"].append(float(np.mean(losses[k])))
            h["val_acc"].append(float(np.mean(accs[k])))
            h["val_dice"].append(float(np.nanmean(dices[k])))
            for s in self.structures:
                h.setdefault(f"val_dice_{s}", []).append(float(np.nanmean(v_dice[k][s])))
                if self.track_curves:
                    h.setdefault(f"val_haus_{s}", []).append(
                        float(np.nanmean(v_haus[k][s])))
        log(f"epoch {epoch} val: mean member "
            f"loss={np.mean([h['val_loss'][-1] for h in self.histories]):.4f} "
            f"dice={np.mean([h['val_dice'][-1] for h in self.histories]):.4f}")

    def _finalize(self, state):
        for k, (d, h) in enumerate(zip(self.member_dirs, self.histories)):
            reports.save_training_curves(d, h)
            reports.save_history_pickle(d, h)
            reports.save_reference_training_curves(d, h, self.structures)
            summary = {}
            for s in self.structures:
                for key in (f"train_dice_{s}", f"val_dice_{s}",
                            f"train_haus_{s}", f"val_haus_{s}"):
                    if h.get(key):
                        summary[f"final_{key}"] = h[key][-1]
            reports.write_hyperparameters(
                d, "Related_hyperparameters.txt",
                {**dataclasses.asdict(self.tc), **dataclasses.asdict(self.cfg),
                 "ensemble_member": k, "ensemble_size": self.n_members,
                 "total_training_time_s": getattr(self, "total_time", 0.0),
                 **summary},
            )


class EnsembleTrainer3D(_Base):
    """The volumetric twin: ``train3d.Trainer3D``'s data semantics (cubes in
    memory, full batches from a per-member permutation stream: member k's
    permutations come from ``np.random.default_rng(seed + k)``, advanced
    across epochs), member k initialised from ``seed + k`` or from the
    SHARED ``initial_params`` (an inflated 2-D checkpoint: diversity then
    comes from the shuffle alone), per-member checkpoints that ``cli eval3d
    / predict3d --checkpoint a,b`` read. ``member_mode`` as for
    ``EnsembleTrainer``; each conv layer of the ``vmap`` mode runs its
    members one after the other through cuDNN."""

    def __init__(
        self,
        exp: ExperimentConfig,
        n_members: int,
        x: np.ndarray,
        y: np.ndarray,
        x_val: Optional[np.ndarray] = None,
        y_val: Optional[np.ndarray] = None,
        out_dir: Optional[str] = None,
        mesh=None,
        member_mode: Optional[str] = None,
        initial_params=None,
        device="cuda",
    ):
        from supernet_tpu_torch.train3d import (
            _crop_center_vol,
            make_ensemble_eval_step3d,
            make_ensemble_train_step3d,
        )

        _check(n_members, "EnsembleTrainer3D")
        self.exp, self.cfg, self.tc = exp, exp.model, exp.train
        self.n_members = n_members
        self._setup_mesh(n_members, mesh)
        self.device = torch.device(device)
        self.x = np.asarray(x, np.float32)
        self.y = np.asarray(y, np.int32)
        self.x_val = None if x_val is None else np.asarray(x_val, np.float32)
        self.y_val = None if y_val is None else np.asarray(y_val, np.int32)
        if len(self.x) < self.tc.batch_size:
            raise ValueError(
                f"{len(self.x)} training volumes < batch_size "
                f"{self.tc.batch_size}: every epoch would run zero steps"
            )
        self.y_crop = _crop_center_vol(self.y, self.cfg.out_size)
        self.y_val_crop = (None if self.y_val is None
                           else _crop_center_vol(self.y_val, self.cfg.out_size))
        self.base_dir = out_dir or os.path.join(exp.out_dir, exp.name + "_3d",
                                                "ensemble")
        self.member_dirs = [os.path.join(self.base_dir, f"member_{k}")
                            for k in range(n_members)]
        self.member_mode = _member_mode(member_mode)
        self.initial_params = initial_params
        self.step_fn = None if self._sits_out() else make_ensemble_train_step3d(
            self.cfg, self.tc, mesh=mesh, member_mode=self.member_mode)
        self.eval_fn = make_ensemble_eval_step3d(self.cfg, self.tc)
        self.seeds = np.arange(self.n_train, dtype=np.int32) + self.tc.seed
        self.histories = [_empty_history() for _ in range(n_members)]

    def init_state(self) -> TrainState:
        from supernet_tpu_torch.models import init_params3d

        def init_one(k):
            if self.initial_params is not None:
                return self.initial_params
            return init_params3d(torch.Generator().manual_seed(self.tc.seed + k),
                                 self.cfg, "cpu")

        state = self._init_members(init_one)
        # one rng per member, advanced across epochs; Trainer3D restarts its
        # rng from the seed on resume, so epoch `start` takes its FIRST
        # permutation
        self._rngs = [np.random.default_rng(self.tc.seed + k)
                      for k in range(self.n_train)]
        return state

    def _has_validation(self) -> bool:
        return self.x_val is not None

    def _member_batches(self):
        """The K per-member permutation streams zipped into stacked
        [K, B, ...] batches (full batches: every stream has one length)."""
        b = self.tc.batch_size
        perms = [rng.permutation(len(self.x)) for rng in self._rngs]
        for i in range(0, len(self.x) - b + 1, b):
            xs = np.stack([self.x[p[i:i + b]] for p in perms])
            ys = np.stack([self.y_crop[p[i:i + b]] for p in perms])
            yield xs, ys

    def _train_epoch(self, state, epoch, log):
        losses = [[] for _ in range(self.n_members)]
        accs = [[] for _ in range(self.n_members)]
        t0 = time.perf_counter()
        n_steps = 0
        for xk, yk in self._member_batches():
            state, m = self.step_fn(state, torch.as_tensor(xk, device=self.device),
                                    torch.as_tensor(yk, device=self.device), self.seeds)
            loss_k, acc_k = m.loss.cpu().numpy(), m.accuracy.cpu().numpy()
            for k in range(self.n_members):
                losses[k].append(float(loss_k[k]))
                accs[k].append(float(acc_k[k]))
            n_steps += 1
        for k, h in enumerate(self.histories):
            h["train_loss"].append(float(np.mean(losses[k])))
            h["train_acc"].append(float(np.mean(accs[k])))
        secs = time.perf_counter() - t0
        log(f"epoch {epoch}: mean member loss="
            f"{np.mean([h['train_loss'][-1] for h in self.histories]):.4f} "
            f"({n_steps * self.tc.batch_size / max(secs, 1e-9):.2f} "
            f"vols/s/member, {secs:.2f}s)")
        return state

    def _validate(self, state, epoch, log):
        from supernet_tpu_torch.train3d import _dice_foreground

        cfg, b = self.cfg, self.tc.batch_size
        losses = [[] for _ in range(self.n_members)]
        accs = [[] for _ in range(self.n_members)]
        dices = [[] for _ in range(self.n_members)]
        for i in range(0, len(self.x_val) - b + 1, b):
            yb = self.y_val_crop[i:i + b]
            loss, acc, pred = self.eval_fn(state.params, self.x_val[i:i + b], yb)
            loss, acc, preds = loss.cpu().numpy(), acc.cpu().numpy(), pred.cpu().numpy()
            for k in range(self.n_members):
                losses[k].append(float(loss[k]))
                accs[k].append(float(acc[k]))
                o = cfg.out_size
                dices[k].append(_dice_foreground(yb, preds[k].reshape(b, o, o, o)))
        if not losses[0]:
            return
        for k, h in enumerate(self.histories):
            h["val_loss"].append(float(np.mean(losses[k])))
            h["val_acc"].append(float(np.mean(accs[k])))
            h["val_dice"].append(float(np.nanmean(dices[k])))
        log(f"epoch {epoch} val: mean member "
            f"loss={np.mean([h['val_loss'][-1] for h in self.histories]):.4f} "
            f"dice={np.mean([h['val_dice'][-1] for h in self.histories]):.4f}")

    def _finalize(self, state):
        """Per-member curve PNGs and history pickles, and the center-slice
        uncertainty report from the first validation batch (as
        ``Trainer3D._save_val_report`` writes it)."""
        from supernet_tpu_torch.models import forward3d

        cfg, b = self.cfg, self.tc.batch_size
        for k, (d, h) in enumerate(zip(self.member_dirs, self.histories)):
            reports.save_training_curves(d, h)
            reports.save_history_pickle(d, h)
            if self.x_val is not None and len(self.x_val) >= b:
                xb = self.x_val[:b]
                with torch.no_grad():
                    probs, sigma = forward3d(index_tree(state.params, k),
                                             torch.as_tensor(xb, device=self.device), cfg)
                o = cfg.out_size
                shape = (b, o, o, o, cfg.n_classes)
                reports.save_uncertainty_slices3d(
                    d, probs.cpu().numpy().reshape(shape),
                    sigma.cpu().numpy().reshape(shape), xb,
                    self.y_val_crop[:b], n_classes=cfg.n_classes)
