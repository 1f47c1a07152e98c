"""Evaluation runners: the clean / noise-robustness ``testing`` protocol and
the adversarial (FGSM/PGD) evaluation branch. The counterpart of
``supernet_tpu/evaluate.py``.

Reference: ``testing`` (`Hippocampus.py:1123-1547`, `Brats.py:1123-1519`),
the adversarial branch of ``main_function(Training=False)``
(`Hippocampus.py:839-1118`, `Brats.py:893-1119`), and the module-level
noise-sweep loop (`Hippocampus.py:1578-1601`).

Protocol per batch (noise eval):
 1. center-crop a copy of image+label to the output size for records;
 2. synthesize noise (gaussian/speckle/S&P), region-mask it by the label,
    add, clip to the clean batch range, account SNR, on the device
    (``supernet_tpu_torch.perturb``);
 3. forward -> (probs, sigma); accumulate predictions + artifacts;
 4. per-structure Dice/Hausdorff/sens/prec/spec/RVD/over-under on host.

Artifacts written per run: ``uncertainty_info*.pkl``,
``Predictive_variance_tasks.txt``, ``Related_hyperparameters*.txt``, in the
reference's noise-mode-specific directory scheme (on_anterior/on_posterior/
on_all, on_object/on_background/on_all). Result keys, file names and the
directory scheme are the JAX package's.

Every runner takes ``device`` (default the card; nothing falls back to the
CPU) and copies the parameters there. A batch's noise and the Monte-Carlo
weight draws come from CPU generators keyed by the seed and the batch index,
so a run sees the same draws on every device. With ``mesh`` (one process
per device, ``parallel.make_mesh``) every forward and attack runs each
rank's rows of the batch and gathers the outputs, so every rank computes
the single-device report; rank 0 writes its files (``report_dir``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from supernet_tpu_torch import metrics as M
from supernet_tpu_torch import perturb, reports
from supernet_tpu_torch.attacks import (
    make_fgsm_attack,
    make_pgd_attack,
    retarget_labels,
)
from supernet_tpu_torch.checkpoint import params_from_jax
from supernet_tpu_torch.configs import ExperimentConfig, NoiseConfig
from supernet_tpu_torch.data.augment import _mix
from supernet_tpu_torch.data.loaders import center_crop_np
from supernet_tpu_torch.metrics import _nanmean, _nanstd
from supernet_tpu_torch.models import forward, forward_sampled, sample_weights
from supernet_tpu_torch.serving import mixture
from supernet_tpu_torch.train import one_hot_flatten

Tensor = torch.Tensor

_REGION_DIR = {
    "A": "on_anterior",
    "P": "on_posterior",
    "O": "on_object",
    "B": "on_background",
    "all": "on_all",
}


def make_eval_forward(
    cfg,
    mesh,
    mc_samples: int,
    mc_seed: int,
    forward_fn,
    sampled_fn,
    sharded_factory=None,
):
    """The eval forward ``f(params, x) -> (probs, sigma)``, without
    gradients.

    Plain ``forward_fn`` by default. With ``mesh``, ``sharded_factory(cfg,
    mesh)`` (the volumes' D-split forward), else ``forward_fn`` on each
    rank's rows of the batch (any batch size: the tail is padded and cut),
    the outputs gathered so that every rank holds the whole batch's and
    every report equals the single-device one. ``mc_samples > 0`` switches to the
    Monte-Carlo ensemble that the VDP propagation replaces (the paper's
    baseline: "instead of Monte Carlo sampling"): N posterior weight draws
    through the deterministic twin ``sampled_fn``, returning the empirical
    (mean, variance) of the softmax outputs in the same [B, N, C] shapes, so
    every downstream metric and artifact path works unchanged. The draws are
    deterministic per (mc_seed, batch index) and the same on every device;
    the mode costs N forwards per batch against the VDP's one."""
    if mesh is not None:
        if mc_samples > 0:
            raise ValueError("mc_samples mode is single-device; drop mesh")
        if sharded_factory is not None:
            return sharded_factory(cfg, mesh)
        from supernet_tpu_torch.parallel.data_parallel import sharded_apply

        run = sharded_apply(lambda xs, p: forward_fn(p, xs, cfg), mesh)
        return torch.no_grad()(lambda params, x: run(x, params))
    if mc_samples > 0:
        counter = [0]

        @torch.no_grad()
        def mc(params, x):
            gen = torch.Generator().manual_seed(_mix(mc_seed, counter[0], 0x6D63))
            counter[0] += 1
            probs = torch.stack([
                sampled_fn(sample_weights(params, gen), x, cfg)
                for _ in range(mc_samples)
            ])  # [N, B, pixels, C]
            return probs.mean(0), probs.var(0, unbiased=False)

        return mc

    @torch.no_grad()
    def f(params, x):
        return forward_fn(params, x, cfg)

    return f


def ensemble_forward(fwd, params_list):
    """Deep-ensemble eval forward: wrap a ``fwd(params, x) -> (p, s)`` into
    the uniform-mixture moments over K members (the within-member variance
    plus the between-member disagreement), mixed by ``serving.mixture``, the
    function ``EnsembleSession`` uses. The members run together: ``fwd``
    gets their member-stacked parameters and the batch as a stride-0
    [K, B, ...] view, so each layer runs once for all of them (the
    counterpart of the JAX package's vmapped forward). Returns
    ``(mixture_fwd, members)``; call ``mixture_fwd(members, x)``. The stack
    is made at the first call and kept while the same member list comes back
    (a noise sweep calls per level and region): a member changed in place
    after that is not seen. Single-device VDP only: callers reject mesh /
    mc_samples modes."""
    members = list(params_list)
    if not members:
        raise ValueError("params_list must hold at least one member")
    cache = {}

    def efn(params, x):
        key = tuple(id(p) for p in params)
        if cache.get("key") != key:
            from supernet_tpu_torch.train import stack_trees

            # the member dicts are held with the key, so their ids stay theirs
            cache.update(key=key, members=list(params), stacked=stack_trees(params))
        probs, sigma = fwd(cache["stacked"], x.expand(len(params), *x.shape))
        return mixture(probs.unbind(0), sigma.unbind(0))

    return efn, members


@contextlib.contextmanager
def report_dir(out_dir: str, sharded):
    """The directory a runner writes ``out_dir``'s files into. In a sharded
    run (``sharded``: its mesh, or any true value) every rank computes the
    same report and rank 0 writes it; another rank writes into a temporary
    directory that is removed when the runner is done (the results it
    returns still name ``out_dir``)."""
    from supernet_tpu_torch.parallel.multihost import is_writer

    if not sharded or is_writer():
        os.makedirs(out_dir, exist_ok=True)
        yield out_dir
        return
    with tempfile.TemporaryDirectory() as tmp:
        yield tmp


def _reject_ensemble_modes(params, mesh, mc_samples=0) -> bool:
    """Shared guard: list-of-members params compose with the plain VDP
    forward only (the mixture is not defined for the MC baseline)."""
    if isinstance(params, (list, tuple)):
        if mesh is not None or mc_samples:
            raise ValueError(
                "ensemble eval (a list of member params) is single-device "
                "VDP only; drop mesh / mc_samples"
            )
        return True
    return False


def _forward_fn(cfg, mesh=None, mc_samples: int = 0, mc_seed: int = 0):
    """2-D eval forward (see `make_eval_forward`)."""
    return make_eval_forward(
        cfg, mesh, mc_samples, mc_seed, forward, forward_sampled
    )


def eval_forward_and_params(cfg, params, device, mesh=None, mc_samples=0, mc_seed=0,
                            forward_fn=forward, sampled_fn=forward_sampled,
                            sharded_factory=None):
    """``(fwd, params)`` for a runner: the parameters (one JAX-layout dict,
    or a list of ensemble members) copied to ``device``, and the forward
    that takes them (the model family of ``forward_fn`` / ``sampled_fn``,
    see `make_eval_forward`)."""
    if mc_samples > 0 and mesh is not None:
        raise ValueError("mc_samples mode is single-device; drop mesh")
    if _reject_ensemble_modes(params, mesh, mc_samples):
        fwd = make_eval_forward(cfg, None, mc_samples, mc_seed, forward_fn, sampled_fn)
        return ensemble_forward(
            fwd, [params_from_jax(p, device) for p in params]
        )
    fwd = make_eval_forward(cfg, mesh, mc_samples, mc_seed, forward_fn, sampled_fn,
                            sharded_factory)
    return fwd, params_from_jax(params, device)


def _aggregate_structures(
    result: Dict[str, object],
    structs,
    acc_metrics: Dict[str, List[M.StructureMetrics]],
) -> None:
    """The reference's per-structure report block (`Hippocampus.py:1051-1118`,
    `:1360-1399`): dice + std, Hausdorff, sens/prec/spec, RVD, over/under
    segmentation, c_score; NaN-safe for structures absent from every image
    (untargeted BraTS attacks)."""
    for s in structs:
        ms = acc_metrics[s]
        all_dice = np.concatenate([m.all_dice for m in ms])
        result[f"dice_{s}"] = _nanmean(all_dice)
        result[f"dice_{s}_std"] = _nanstd(all_dice)
        result[f"hausdorff_{s}"] = float(np.mean([m.hausdorff for m in ms]))
        for field in (
            "sensitivity",
            "precision",
            "specificity",
            "rvd",
            "over_seg",
            "under_seg",
        ):
            result[f"{field}_{s}"] = _nanmean(
                [getattr(m, field) for m in ms]
            )
        # combined over/under score from mean sensitivity + specificity
        # (`Hippocampus.py:1024,1394`: c_score(test_s, test_sp))
        result[f"c_score_{s}"] = M.c_score(
            result[f"sensitivity_{s}"], result[f"specificity_{s}"]
        )


def _crop_label(y: np.ndarray, size: int) -> np.ndarray:
    yc = center_crop_np(y[..., None] if y.ndim == 3 else y, size)
    return yc[..., 0] if yc.ndim == 4 else yc


class _Scores:
    """What both runners keep per batch: pixel accuracy, per-structure
    metrics, and the leading rows of the full-set ``uncertainty_info.pkl``
    ([probs, sigma, images, labels, acc], `Hippocampus.py:1420,1449`,
    ~2.8 MB/sample on BraTS; ``artifact_max_samples`` caps the rows kept,
    at least one). Host memory is O(batch + artifact rows): the variance
    report accumulates online in ``reports.UncertaintyAccumulator``."""

    def __init__(self, exp: ExperimentConfig, n_total: int,
                 artifact_max_samples: Optional[int]):
        self.exp = exp
        self.n_total = n_total
        self.cap = (
            n_total if artifact_max_samples is None
            else min(max(artifact_max_samples, 1), n_total)
        )
        self.structs = M.dataset_structures(exp.name)
        self.acc_metrics: Dict[str, List[M.StructureMetrics]] = {
            s: [] for s in self.structs
        }
        self.accs: List[float] = []
        self.snrs: List[float] = []
        self.rows: List[tuple] = []
        self.n_kept = 0
        self.t_infer = 0.0
        self.n_batches = 0

    def timed_forward(self, fwd, params, xb: Tensor, b: int):
        """Forward and the fetch of BOTH outputs to the host inside one
        timed window (the reference times the whole (logits, sigma)
        materialization, `Hippocampus.py:952-954`; the fetch is also what
        waits for the device). Returns image-shaped [b, o, o, C] arrays."""
        cfg = self.exp.model
        t0 = time.perf_counter()
        probs, sigma = fwd(params, xb)
        probs = probs.cpu().numpy()
        sigma = sigma.cpu().numpy()
        self.t_infer += time.perf_counter() - t0
        self.n_batches += 1
        shape = (b, cfg.out_size, cfg.out_size, cfg.n_classes)
        return probs[:b].reshape(shape), sigma[:b].reshape(shape)

    def add(self, probs_i, sigma_i, images, y_crop) -> None:
        name = self.exp.name
        pred = np.argmax(probs_i, axis=-1)
        self.accs.append(float(np.mean(pred == y_crop)))
        for s in self.structs:
            self.acc_metrics[s].append(
                M.structure_metrics(
                    M.binarize(y_crop, s, name), M.binarize(pred, s, name)
                )
            )
        take = min(len(probs_i), self.cap - self.n_kept)
        if take > 0:
            self.rows.append(
                (probs_i[:take], sigma_i[:take], images[:take], y_crop[:take])
            )
            self.n_kept += take

    def result(self, out_dir: str) -> Dict[str, object]:
        return {
            "accuracy": float(np.mean(self.accs)),
            "snr_db": float(np.mean(self.snrs)) if self.snrs else float("inf"),
            "test_time_per_batch_s": self.t_infer / max(self.n_batches, 1),
            "out_dir": out_dir,
        }

    def save_artifact(self, result, out_dir: str, name: str) -> None:
        probs, sigma, images, ys = (np.concatenate(c) for c in zip(*self.rows))
        result["artifact"] = reports.save_uncertainty_artifact(
            out_dir, probs, sigma, images, ys, acc=result["accuracy"], name=name
        )
        result["artifact_samples"] = self.n_kept
        if self.n_kept < self.n_total:
            logging.getLogger(__name__).info(
                "uncertainty_info artifact capped to %d of %d samples "
                "(artifact_max_samples)", self.n_kept, self.n_total,
            )


def run_testing(
    exp: ExperimentConfig,
    params,
    ds,
    noise: NoiseConfig = NoiseConfig(),
    out_dir: Optional[str] = None,
    images_n: int = 0,
    seed: int = 0,
    mesh=None,
    mc_samples: int = 0,
    artifact_max_samples: Optional[int] = None,
    device="cuda",
) -> Dict[str, object]:
    """The ``testing`` protocol; returns metrics + artifact path.

    ``params`` is a JAX-layout parameter dict (numpy arrays or tensors), or
    a list of them for a deep ensemble. ``mc_samples > 0`` evaluates the
    Monte-Carlo weight-sampling baseline instead of the VDP propagation
    (same metrics and artifacts; N forwards per batch, see
    `make_eval_forward`). Every test sample is evaluated, the partial final
    batch too (`Hippocampus.py:505-510`)."""
    cfg = exp.model
    fwd, params = eval_forward_and_params(
        cfg, params, device, mesh, mc_samples, mc_seed=seed
    )
    scores = _Scores(exp, len(ds), artifact_max_samples)
    rep = reports.UncertaintyAccumulator(
        len(ds), images_n=images_n, dataset=exp.name, adversarial=False
    )
    noisy_run = noise.kind != "none" and noise.std > 0

    for i, (x, y) in enumerate(
        ds.batches(exp.train.batch_size, drop_remainder=False)
    ):
        b = len(x)
        y_crop = _crop_label(y, cfg.out_size)
        xb = torch.as_tensor(x, dtype=torch.float32, device=device)
        if noisy_run:
            yb_full = torch.as_tensor(y.astype(np.int32), device=device)
            # crop_size: clip range + SNR use the center-cropped frames,
            # exactly like the reference (`Hippocampus.py:1270-1271,1302-1307`)
            xb, snr = perturb.apply_noise(
                perturb.noise_generator(seed, i), xb, yb_full, noise,
                exp.name, crop_size=cfg.out_size,
            )
            scores.snrs.append(float(snr))
        probs_i, sigma_i = scores.timed_forward(fwd, params, xb, b)
        x_noisy = center_crop_np(xb.cpu().numpy()[:b], cfg.out_size)
        scores.add(probs_i, sigma_i, x_noisy, y_crop)
        rep.update(x_noisy, probs_i, y_crop, sigma_i)

    region_dir = _REGION_DIR.get(noise.region, "on_all")
    sub = "clean" if not noisy_run else f"{noise.kind}_{noise.std}/{region_dir}"
    out_dir = out_dir or os.path.join(exp.out_dir, exp.name, "testing", sub)

    result = scores.result(out_dir)
    if mc_samples > 0:
        result["mc_samples"] = mc_samples
    _aggregate_structures(result, scores.structs, scores.acc_metrics)
    name = reports.uncertainty_artifact_name(
        0.0 if noise.kind == "none" else noise.std, noise.region)
    with report_dir(out_dir, mesh) as w:
        scores.save_artifact(result, w, name)
        result["artifact"] = os.path.join(out_dir, name)
        unc = rep.finalize(w)
        result["mean_predictive_variance"] = unc["mean"]
        reports.write_hyperparameters(
            w,
            "Related_hyperparameters.txt",
            {**dataclasses.asdict(noise), **result},
        )
    return result


def run_adversarial(
    exp: ExperimentConfig,
    params,
    ds,
    out_dir: Optional[str] = None,
    images_n: int = 0,
    mesh=None,
    artifact_max_samples: Optional[int] = None,
    device="cuda",
) -> Dict[str, object]:
    """Adversarial evaluation branch (`Hippocampus.py:894-1049`): PGD when
    targeted (both datasets) and always for Hippocampus; single-step FGSM
    for untargeted BraTS (`Brats.py:984-991`).

    Streams like ``run_testing``; ``params`` is one JAX-layout dict."""
    cfg = exp.model
    ac = exp.attack
    if isinstance(params, (list, tuple)):
        raise ValueError(
            "adversarial eval attacks ONE member's loss surface; pass a "
            "single checkpoint (ensemble attack transfer is out of scope)"
        )
    fwd, params = eval_forward_and_params(cfg, params, device, mesh)
    use_pgd = ac.targeted or exp.name == "hippocampus"
    attack = (make_pgd_attack if use_pgd else make_fgsm_attack)(cfg, ac, mesh=mesh)

    scores = _Scores(exp, len(ds), artifact_max_samples)
    rep = reports.UncertaintyAccumulator(
        len(ds), images_n=images_n, dataset=exp.name,
        adversarial=True, targeted=ac.targeted,
    )

    for x, y in ds.batches(exp.train.batch_size, drop_remainder=False):
        b = len(x)
        y_crop = _crop_label(y, cfg.out_size)
        xb = torch.as_tensor(x, dtype=torch.float32, device=device)
        y_attack = torch.as_tensor(y_crop.astype(np.int32), device=device)
        if ac.targeted:
            y_attack = retarget_labels(
                y_attack, ac.adversary_targeted_class, ac.adv_class
            )
        # one_hot with depth n_classes: the targeted adv_class (3 for
        # Hippocampus, out of range) becomes an all-zero row, exactly like
        # the reference's tf.one_hot(depth=output_size) (Hippocampus.py:917).
        y_flat = one_hot_flatten(y_attack, cfg.n_classes)
        adv = attack(params, xb, y_flat, xb.min(), xb.max())
        # the fetch forces the attack's max_adv_step forward+backward passes
        # to completion OUTSIDE the timed window; the host copy is reused
        adv_np = adv.cpu().numpy()

        probs_i, sigma_i = scores.timed_forward(fwd, params, adv, b)
        adv_crop = center_crop_np(adv_np[:b], cfg.out_size)
        x_crop = center_crop_np(x, cfg.out_size)
        # SNR of the adversarial perturbation on the cropped frames
        # (`Hippocampus.py:995-1000`: 10 log10(sum x^2 / sum (adv - x)^2))
        scores.snrs.append(float(perturb.snr_db(
            torch.from_numpy(np.ascontiguousarray(x_crop, np.float32)),
            torch.from_numpy(np.ascontiguousarray(adv_crop)),
        )))
        scores.add(probs_i, sigma_i, adv_crop, y_crop)
        rep.update(
            adv_crop, probs_i, y_crop, sigma_i, adv=adv_crop,
            masked=y_attack.cpu().numpy() if ac.targeted else None,
        )

    mode = "targeted" if ac.targeted else "untargeted"
    out_dir = out_dir or os.path.join(
        exp.out_dir, exp.name, "adversarial", f"{mode}_eps{ac.epsilon}"
    )

    result = scores.result(out_dir)
    _aggregate_structures(result, scores.structs, scores.acc_metrics)
    with report_dir(out_dir, mesh) as w:
        scores.save_artifact(result, w, "uncertainty_info.pkl")
        result["artifact"] = os.path.join(out_dir, "uncertainty_info.pkl")
        unc = rep.finalize(w)
        result["mean_predictive_variance"] = unc["mean"]
        # per-class / per-structure predictive variance lines the reference
        # appends for targeted attacks (`Hippocampus.py:1105-1112`)
        for k, v in unc.items():
            if k != "mean":
                result[f"predictive_variance_{k}"] = v
        reports.write_hyperparameters(
            w,
            "Related_hyperparameters_adversarial.txt",
            {**dataclasses.asdict(ac), **result},
        )
    return result


def run_noise_sweep(
    exp: ExperimentConfig,
    params,
    ds,
    images_n: int = 0,
    mesh=None,
    artifact_max_samples: Optional[int] = None,
    device="cuda",
) -> List[Dict[str, object]]:
    """The module-level sweep (`Hippocampus.py:1578-1601`): clean eval +
    uncertainty render, then gaussian noise at each level x region.

    ``artifact_max_samples`` bounds the pkl-artifact buffer of EVERY run in
    the sweep (7 full-set passes at the default 2 levels x 3 regions)."""
    noises = [NoiseConfig()] + [
        NoiseConfig(kind="gaussian", std=std, region=region)
        for std in exp.noise_levels
        for region in exp.noise_regions
    ]
    return [
        run_testing(
            exp, params, ds, noise, images_n=images_n, mesh=mesh,
            artifact_max_samples=artifact_max_samples, device=device,
        )
        for noise in noises
    ]
