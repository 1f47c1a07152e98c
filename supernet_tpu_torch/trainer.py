"""The epoch-level trainer: train loop + validation + checkpoints +
curves + hyperparameter dumps. The counterpart of ``supernet_tpu/trainer.py``.

- one train step per batch, or K steps per call on a stacked chunk
  (``steps_per_dispatch``); batches prefetched by a background thread;
- loss/nll/kl/accuracy computed on the device inside the step; host-side
  metrics (per-structure Dice, SciPy Hausdorff) on the fetched argmax maps;
- per-epoch checkpoints in the reference's ``epoch_{N}`` scheme, written by
  a background thread, resume via ``continue_training``;
- a non-finite epoch loss rolls the state back to the last good checkpoint;
- the artifact set: curve PNGs (when matplotlib is installed), history
  pickle, ``Related_hyperparameters.txt``.

History keys and artifact names are the JAX trainer's. With a ``mesh``
(``parallel.make_mesh``: one process per device) each rank trains on the
rows of every global batch its mesh coordinate names
(``parallel.process_local_rows``) through ``make_sharded_train_step``; the
parameters stay replicated, so rank 0 alone writes checkpoints, the history
and the reports. A world on one node keeps the single-host surface (rank 0
records the train curves from the gathered predictions and validates); a
world over several nodes takes the JAX trainer's multi-host path (no train
curves, no in-loop validation, no reports). Ranks outside a shrunken mesh
(``make_mesh_for_batch``) sit the run out.
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
from supernet_tpu_torch import parallel
from supernet_tpu_torch import reports
from supernet_tpu_torch.configs import ExperimentConfig
from supernet_tpu_torch.data.loaders import BatchIterator, center_crop_np
from supernet_tpu_torch.models import init_params
from supernet_tpu_torch.profiling import StepTimer
from supernet_tpu_torch.train import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
)


def _prep_batch(x: np.ndarray, y: np.ndarray, out_size: int, n_classes: int):
    """Host-side batch prep mirroring `Hippocampus.py:608-615`: f32 NHWC
    image, labels center-cropped to the model's output size (the one-hot
    encoding happens on the device, inside the step)."""
    y_c = center_crop_np(y[..., None] if y.ndim == 3 else y, out_size)
    y_c = y_c[..., 0] if y_c.ndim == 4 else y_c
    return x, y_c


class _Writer:
    """``AsyncEpochCheckpointer`` on the writing rank, nothing on the
    others; under a mesh ``wait()`` also holds every rank until the writer
    has drained (a roll-back reads the file on every rank)."""

    def __init__(self, out_dir: str, writes: bool, mesh):
        self.ckpt = ckpt.AsyncEpochCheckpointer(out_dir) if writes else None
        self.mesh = mesh

    def save(self, epoch: int, state) -> None:
        if self.ckpt is not None:
            self.ckpt.save(epoch, state)

    def wait(self) -> None:
        if self.ckpt is not None:
            self.ckpt.wait()
        if self.mesh is not None:
            for name in self.mesh.mesh_dim_names:
                torch.distributed.barrier(group=self.mesh.get_group(name))

    def close(self) -> None:
        if self.ckpt is not None:
            self.ckpt.close()


class Trainer:
    def __init__(
        self,
        exp: ExperimentConfig,
        train_ds,
        val_ds=None,
        out_dir: Optional[str] = None,
        mesh=None,
        steps_per_dispatch: int = 1,
        track_curves: bool = True,
        device="cuda",
        initial_params=None,
    ):
        self.exp = exp
        self.cfg = exp.model
        self.tc = exp.train
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.out_dir = out_dir or os.path.join(
            exp.out_dir, exp.name, "saved_models_SUPER_u-Net"
        )
        self.device = torch.device(device)
        # a JAX-layout parameter dict to start from in place of the seeded
        # init (continue_training still prefers the latest checkpoint)
        self.initial_params = initial_params
        # per-structure train/val Dice + Hausdorff every epoch, like the
        # reference's epoch records (`Hippocampus.py:640-742`); costs one
        # [B, H*W] int32 fetch per step + host metrics (excluded from the
        # reported images/sec). Disable for throughput-only runs.
        self.track_curves = track_curves
        # train-side curves are off under augmentation: the step's
        # prediction is of the augmented batch while the host holds the
        # unaugmented labels (validation curves are unaffected)
        self.mesh = mesh
        self.multi_host = mesh is not None and parallel.multihost.multi_node()
        self.writes = parallel.multihost.is_writer()
        self.track_train_curves = track_curves
        if track_curves and self.multi_host:
            print(
                "note: per-structure train curves disabled on multi-host "
                "runs (predictions span non-addressable devices)"
            )
            self.track_train_curves = False
        if track_curves and exp.train.augment is not None:
            print(
                "note: per-structure train curves disabled with "
                "augmentation (step predictions are of the augmented "
                "batch; validation curves are unaffected)"
            )
            self.track_train_curves = False
        self.structures = M.dataset_structures(exp.name)
        # steps_per_dispatch > 1: K batches stacked into one call of
        # make_multi_train_step (one host-to-device copy and one metric
        # fetch per chunk)
        self.k_steps = max(1, steps_per_dispatch)
        if mesh is not None and self.k_steps > 1:
            raise ValueError(
                "steps_per_dispatch > 1 is not supported together with a "
                "device mesh yet; drop one of the two options"
            )
        if mesh is not None:
            n_dev = int(mesh.mesh.numel())
            if self.tc.batch_size % n_dev != 0:
                raise ValueError(
                    f"batch_size {self.tc.batch_size} is not divisible by "
                    f"the {n_dev}-device mesh; use "
                    "parallel.make_mesh_for_batch(batch_size) or pick a "
                    "batch that is a multiple of the device count"
                )
            # a rank outside a shrunken mesh builds no step: it sits out
            self.step_fn = parallel.make_sharded_train_step(
                self.cfg, self.tc, mesh, with_pred=self.track_train_curves
            ) if parallel._comm.in_mesh(mesh) else None
        elif self.k_steps > 1:
            self.step_fn = make_multi_train_step(
                self.cfg, self.tc, self.k_steps,
                with_pred=self.track_train_curves,
            )
        else:
            self.step_fn = make_train_step(
                self.cfg, self.tc, with_pred=self.track_train_curves
            )
        self.eval_fn = make_eval_step(self.cfg, self.tc)
        self._single_step = None  # built lazily for trailing batches
        self.history: Dict[str, List[float]] = {
            "train_loss": [],
            "train_acc": [],
            "val_loss": [],
            "val_acc": [],
            "val_dice": [],
        }
        # host seconds per epoch: curve metrics inside the train loop,
        # validation, and the blocking part of the checkpoint (the copy of
        # the state to the host); not part of the history
        self.timings: Dict[str, List[float]] = {
            "epoch_s": [], "host_metric_s": [], "validate_s": [],
            "checkpoint_s": [],
        }

    def _put(self, a, dtype=None) -> torch.Tensor:
        if self.mesh is not None:
            # this rank's block of the global batch the loader yields
            ax = parallel._comm.axis(self.mesh, "data")
            lo, hi = parallel.process_local_rows(len(a), ax.index, ax.size)
            a = parallel.global_batch(self.mesh, np.asarray(a)[lo:hi])
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def init_state(self) -> TrainState:
        params = self.initial_params
        if params is None:
            params = init_params(
                torch.Generator().manual_seed(self.tc.seed), self.cfg, "cpu"
            )
        state, _ = create_train_state(params, self.tc, self.device)
        start_epoch = 0
        if self.tc.continue_training:
            latest = ckpt.latest_epoch(self.out_dir)
            if latest is not None:
                state = ckpt.restore_state(
                    self.out_dir, latest, self.tc, self.device
                )
                start_epoch = latest + 1
        if self.mesh is not None:
            state = parallel.replicate(self.mesh, state)
        self.start_epoch = start_epoch
        return state

    def _restore(self, epoch: int) -> TrainState:
        """The state of the ``epoch`` checkpoint on every rank: each reads
        it (the checkpoint directory is shared, as in the JAX trainer) once
        rank 0's writer has finished it."""
        state = ckpt.restore_state(self.out_dir, epoch, self.tc, self.device)
        if self.mesh is not None:
            state = parallel.replicate(self.mesh, state)
        return state

    def run(self, epochs: Optional[int] = None, log=print) -> Optional[TrainState]:
        if self.mesh is not None and not parallel._comm.in_mesh(self.mesh):
            return None  # a rank outside a shrunken mesh sits the run out
        state = self.init_state()
        epochs = epochs if epochs is not None else self.tc.epochs
        # async writer: checkpoints stream to disk while the next epoch
        # trains (the reference blocks on a sync save every epoch)
        writer = _Writer(self.out_dir, self.writes, self.mesh)
        t_start = time.perf_counter()
        last_good: Optional[int] = None
        try:
            for epoch in range(self.start_epoch, epochs):
                state = self._train_epoch(state, epoch, log)
                # failure detection / recovery: if the epoch diverged
                # (non-finite loss), roll back to the last good checkpoint
                # instead of corrupting the run
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
                    writer.wait()  # the rollback target may still be in flight
                    state = self._restore(last_good)
                    continue
                if self.val_ds is not None and self.writes and not self.multi_host:
                    # multi-host: the in-loop validation and report surface
                    # is single-host work; evaluate the saved checkpoints
                    # afterwards (`cli eval`)
                    t0 = time.perf_counter()
                    self._validate(state, epoch, log)
                    self.timings["validate_s"].append(time.perf_counter() - t0)
                if (epoch + 1) % self.tc.checkpoint_every == 0:
                    # save() returns once the state is copied to the host:
                    # the next step overwrites the parameters in place
                    t0 = time.perf_counter()
                    writer.save(epoch, state)
                    self.timings["checkpoint_s"].append(time.perf_counter() - t0)
                    last_good = epoch
            writer.wait()
        finally:
            writer.close()
        self.total_time = time.perf_counter() - t_start
        if self.mesh is not None:
            # rank 0 validated: every rank reports its history
            self.history = parallel._comm.broadcast_object(self.history, self.mesh)
        if self.multi_host:
            # checkpoints are the multi-host product; the curve/report
            # surface assumes the in-loop validation history this mode skips
            log("multi-host run done; skipping single-host report surface")
        elif self.writes:
            self._finalize(state)
        return state

    def _leftover_step(self, state, xb, yb):
        """Single-batch train step for the tail of a steps_per_dispatch>1
        epoch (the same step the chunk loops over)."""
        if self._single_step is None:
            self._single_step = make_train_step(
                self.cfg, self.tc, with_pred=self.track_train_curves
            )
        return self._single_step(state, xb, yb)

    def _record_structures(self, pred_flat, y_np, dice_acc, haus_acc):
        """Per-structure Dice + Hausdorff on one train batch (the
        reference's per-step records, `Hippocampus.py:640-668`).
        ``pred_flat`` [B, H*W] host array, ``y_np`` [B, out, out]."""
        pred_img = np.asarray(pred_flat).reshape(y_np.shape)
        for s in self.structures:
            tm = M.binarize(y_np, s, self.exp.name)
            pm = M.binarize(pred_img, s, self.exp.name)
            d, _ = M.dice(tm, pm)
            dice_acc[s].append(d)
            haus_acc[s].append(M.compute_H(tm, pm))

    def _train_epoch(self, state, epoch, log):
        losses, accs = [], []
        t_dice = {s: [] for s in self.structures}
        t_haus = {s: [] for s in self.structures}
        timer = StepTimer()
        # per-tick bookkeeping so images/sec is exact for partial batches
        # and trailing single-step chunks, and so the host-side curve
        # metrics (track_curves) don't contaminate the device rate
        tick_imgs: List[int] = []
        tick_host: List[float] = []

        def record(pred_flat, y_np) -> float:
            # the fetch blocks on device completion of the step: it belongs
            # to the device interval, so fetch BEFORE opening the host timer
            # (otherwise host_s would swallow the step compute and its
            # subtraction below would inflate images/sec)
            pred_np = pred_flat.cpu().numpy()
            t0 = time.perf_counter()
            self._record_structures(pred_np, y_np, t_dice, t_haus)
            return time.perf_counter() - t0

        it = BatchIterator(
            self.train_ds.batches(
                self.tc.batch_size,
                shuffle=True,
                seed=self.tc.seed,
                epoch=epoch,
            )
        )
        timer.tick()
        xs, ys = [], []
        step = 0
        for x, y in it:
            x, y_c = _prep_batch(x, y, self.cfg.out_size, self.cfg.n_classes)
            if self.k_steps > 1:
                xs.append(x)
                ys.append(np.ascontiguousarray(y_c, np.int32))
                if len(xs) < self.k_steps:
                    continue
                xb = self._put(np.stack(xs), torch.float32)
                yb = self._put(np.stack(ys))
                n_imgs = sum(len(b) for b in xs)
                chunk_ys, xs, ys = ys, [], []
                host_s = 0.0
                if self.track_train_curves:
                    state, ms, preds = self.step_fn(state, xb, yb)
                    # fetch (= device sync) outside the host-metric timer
                    preds = preds.cpu().numpy()  # one [K, B, H*W] fetch
                    t0 = time.perf_counter()
                    for i, y_np in enumerate(chunk_ys):
                        self._record_structures(
                            preds[i], y_np, t_dice, t_haus
                        )
                    host_s = time.perf_counter() - t0
                else:
                    state, ms = self.step_fn(state, xb, yb)
                chunk_losses = ms.loss.cpu().numpy()
                chunk_accs = ms.accuracy.cpu().numpy()
                losses += chunk_losses.tolist()
                accs += chunk_accs.tolist()
                if step % self.tc.log_every < self.k_steps:
                    log(
                        f"epoch {epoch} step {step}: "
                        f"loss={chunk_losses[-1]:.4f} "
                        f"acc={chunk_accs[-1]:.4f}"
                    )
                step += self.k_steps
                timer.tick()
                tick_imgs.append(n_imgs)
                tick_host.append(host_s)
                continue
            xb = self._put(x, torch.float32)
            # integer labels; one-hot happens on the device inside the step
            yb = self._put(np.ascontiguousarray(y_c, np.int32))
            host_s = 0.0
            if self.track_train_curves:
                state, m, pred = self.step_fn(state, xb, yb)
                if self.writes:
                    host_s = record(pred, y_c)
            else:
                state, m = self.step_fn(state, xb, yb)
            if step % self.tc.log_every == 0:
                log(
                    f"epoch {epoch} step {step}: loss={float(m.loss):.4f} "
                    f"nll={float(m.nll):.4f} kl={float(m.kl):.2f} "
                    f"acc={float(m.accuracy):.4f}"
                )
            losses.append(float(m.loss))
            accs.append(float(m.accuracy))
            step += 1
            timer.tick()
            tick_imgs.append(len(x))
            tick_host.append(host_s)
        if xs:
            # trailing batches that don't fill a steps-per-dispatch chunk
            # are trained through the single-step path so no data is dropped
            log(
                f"epoch {epoch}: {len(xs)} trailing batch(es) below the "
                f"steps-per-dispatch chunk of {self.k_steps}; running them "
                "through the single-step path"
            )
            for x, y_c in zip(xs, ys):
                host_s = 0.0
                xb, yb = self._put(x, torch.float32), self._put(y_c)
                if self.track_train_curves:
                    state, m, pred = self._leftover_step(state, xb, yb)
                    host_s = record(pred, y_c)
                else:
                    state, m = self._leftover_step(state, xb, yb)
                losses.append(float(m.loss))
                accs.append(float(m.accuracy))
                step += 1
                timer.tick()
                tick_imgs.append(len(x))
                tick_host.append(host_s)
        if self.track_train_curves:
            for s in self.structures:
                self.history.setdefault(f"train_dice_{s}", []).append(
                    float(np.nanmean(t_dice[s]))
                )
                self.history.setdefault(f"train_haus_{s}", []).append(
                    float(np.nanmean(t_haus[s]))
                )
        timer.sync(state.params)
        # images/sec from exact per-tick image counts (partial batches and
        # trailing single-step chunks count what they actually trained),
        # minus the host-side curve-metric time so track_curves does not
        # contaminate the device rate. The first interval absorbs the
        # kernels' build and cuDNN's algorithm search and is dropped when
        # there is more than one.
        n_ticks = len(tick_imgs)
        skip = 1 if n_ticks > 1 else 0
        secs = timer.times[-1] - timer.times[skip] if n_ticks > skip else 0.0
        secs -= sum(tick_host[skip:])
        imgs = sum(tick_imgs[skip:])
        ips = imgs / secs if secs > 0 else 0.0
        self.history.setdefault("images_per_sec", []).append(ips)
        self.timings["epoch_s"].append(timer.total_seconds())
        self.timings["host_metric_s"].append(sum(tick_host))
        log(
            f"epoch {epoch}: {ips:.4g} images/sec "
            f"({timer.total_seconds():.2f}s)"
        )
        self.history["train_loss"].append(float(np.mean(losses)))
        self.history["train_acc"].append(float(np.mean(accs)))
        return state

    def _validate(self, state, epoch, log):
        losses, accs, dices = [], [], []
        v_dice = {s: [] for s in self.structures}
        v_haus = {s: [] for s in self.structures}
        params = state.params
        for x, y in self.val_ds.batches(
            self.tc.batch_size, drop_remainder=False
        ):
            x, y_c = _prep_batch(x, y, self.cfg.out_size, self.cfg.n_classes)
            probs, sigma, pred, loss, acc = self.eval_fn(
                params, x, y_c.astype(np.int32)
            )
            losses.append(float(loss))
            accs.append(float(acc))
            pred_img = pred.cpu().numpy().reshape(
                len(x), self.cfg.out_size, self.cfg.out_size
            )
            for s in self.structures:
                tm = M.binarize(y_c, s, self.exp.name)
                pm = M.binarize(pred_img, s, self.exp.name)
                d, _ = M.dice(tm, pm)
                dices.append(d)
                v_dice[s].append(d)
                if self.track_curves:
                    v_haus[s].append(M.compute_H(tm, pm))
        self.history["val_loss"].append(float(np.mean(losses)))
        self.history["val_acc"].append(float(np.mean(accs)))
        self.history["val_dice"].append(float(np.nanmean(dices)))
        for s in self.structures:
            self.history.setdefault(f"val_dice_{s}", []).append(
                float(np.nanmean(v_dice[s]))
            )
            if self.track_curves:
                self.history.setdefault(f"val_haus_{s}", []).append(
                    float(np.nanmean(v_haus[s]))
                )
        log(
            f"epoch {epoch} val: loss={self.history['val_loss'][-1]:.4f} "
            f"acc={self.history['val_acc'][-1]:.4f} "
            f"dice={self.history['val_dice'][-1]:.4f}"
        )

    def _finalize(self, state):
        out = self.out_dir
        reports.save_training_curves(out, self.history)
        reports.save_history_pickle(out, self.history)
        # the reference's named curve set + acc/error pickle
        # (`Hippocampus.py:744-796`)
        reports.save_reference_training_curves(
            out, self.history, self.structures
        )
        # final-epoch per-structure summary lines, like the reference's
        # "Averaged Training dice score <structure>" (`Hippocampus.py:820-833`)
        summary = {}
        for s in self.structures:
            for key in (
                f"train_dice_{s}",
                f"val_dice_{s}",
                f"train_haus_{s}",
                f"val_haus_{s}",
            ):
                if self.history.get(key):
                    summary[f"final_{key}"] = self.history[key][-1]
        reports.write_hyperparameters(
            out,
            "Related_hyperparameters.txt",
            {
                **dataclasses.asdict(self.tc),
                **dataclasses.asdict(self.cfg),
                "total_training_time_s": getattr(self, "total_time", 0.0),
                **summary,
            },
        )
