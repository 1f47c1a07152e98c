"""Volumetric evaluation: the noise-robustness ``testing`` protocol, the
adversarial (FGSM/PGD) branch, the uncertainty-quality report and the noise
sweep for the 3-D family. The counterpart of ``supernet_tpu/evaluate3d.py``.

The 2-D protocol (``evaluate.py``) on whole volumes:

 1. synthesize noise (gaussian/speckle/S&P), mask it by the label's region,
    add, clip to the center-cropped clean batch's range, account the SNR,
    on the device (``perturb``, rank-generic);
 2. ``forward3d`` -> (probs, sigma);
 3. per-structure Dice/Hausdorff/sens/prec/spec/RVD/over-under on the host,
    through a [B, D*H, W] view of each volume (per-volume statistics, the
    analogue of the reference's per-image ones).

Artifacts per run: the center-slice renders and ``uncertainty_info.pkl``
(``reports.save_uncertainty_slices3d``), ``Predictive_variance_tasks.txt``,
``Related_hyperparameters*.txt`` and, for the calibration report, the 2-D
runner's set. Result keys, file names and directories are the JAX
package's.

Every runner takes ``device`` (default the card; nothing falls back to the
CPU). A batch's noise comes from a CPU generator keyed by the seed and the
batch index, the Monte-Carlo draws likewise, so a run sees the same draws
on every device. A comma-separated ensemble (a list of parameter dicts) is
served by one member-stacked forward and mixed (``evaluate.ensemble_forward``).
A mesh raises ``NotImplementedError`` (ROADMAP.md, Queue 1: 'Parallelism').
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from supernet_tpu_torch import metrics as M
from supernet_tpu_torch import perturb, reports
from supernet_tpu_torch.attacks import make_fgsm_attack, make_pgd_attack, retarget_labels
from supernet_tpu_torch.configs import ExperimentConfig, NoiseConfig
from supernet_tpu_torch.evaluate import (
    _REGION_DIR,
    _aggregate_structures,
    eval_forward_and_params,
    make_eval_forward,
)
from supernet_tpu_torch.models import forward3d, forward_sampled3d
from supernet_tpu_torch.ops.moments3d import crop_center3d
from supernet_tpu_torch.train import one_hot_flatten


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "volumetric evaluation over a device mesh is not ported yet "
            "(ROADMAP.md, Queue 1: 'Parallelism', parallel/spatial.py)"
        )


def _forward3d_fn(cfg, mesh=None, mc_samples: int = 0, mc_seed: int = 0):
    """The volumetric eval forward ``f(params, x) -> (probs, sigma)``
    without gradients: ``forward3d``, or with ``mc_samples > 0`` the
    Monte-Carlo ensemble of ``forward_sampled3d`` over weight draws."""
    _single_device(mesh)
    return make_eval_forward(cfg, mesh, mc_samples, mc_seed, forward3d, forward_sampled3d)


def _forward_and_params(cfg, params, device, mesh=None, mc_samples=0, mc_seed=0):
    """``(fwd, params)``: the parameters (one JAX-layout dict, or a list of
    ensemble members) copied to ``device`` and the volumetric forward that
    takes them."""
    _single_device(mesh)
    return eval_forward_and_params(cfg, params, device, mesh, mc_samples, mc_seed,
                                   forward3d, forward_sampled3d)


def _as2d(v: np.ndarray) -> np.ndarray:
    """[B, o, o, o(, C)] -> [B, o*o, o(, C)]: the 2-D metric kernels reduce
    over axes (1, 2), so each whole volume scores as one sample."""
    b, o = v.shape[0], v.shape[1]
    return v.reshape((b, o * o, o) + v.shape[4:])


def _batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    for i in range(0, len(x), batch_size):
        yield x[i : i + batch_size], y[i : i + batch_size]


def _crop(a: np.ndarray, o: int) -> np.ndarray:
    return np.asarray(crop_center3d(a, o, o, o))


def _score_batch(probs, sigma, y_crop, cfg, exp_name, structs, acc_metrics, accs):
    """Reshape the flat head outputs to cubes, record per-volume accuracy
    and per-structure metrics; returns ``(probs_v, sigma_v, pred)`` as
    [b, o, o, o(, C)] arrays."""
    b, o = len(y_crop), cfg.out_size
    probs_v = probs[:b].reshape(b, o, o, o, cfg.n_classes)
    sigma_v = sigma[:b].reshape(b, o, o, o, cfg.n_classes)
    pred = np.argmax(probs_v, axis=-1)
    # per-volume accuracies: every volume has the same voxel count, so their
    # mean is the voxel-level accuracy whatever the last batch's size
    accs.extend(np.mean(pred == y_crop, axis=(1, 2, 3)).tolist())
    for s in structs:
        acc_metrics[s].append(
            M.structure_metrics(
                _as2d(M.binarize(y_crop, s, exp_name)),
                _as2d(M.binarize(pred, s, exp_name)),
            )
        )
    return probs_v, sigma_v, pred


class _Rows:
    """The leading rows kept for the full-set ``uncertainty_info.pkl``
    (``artifact_max_samples``, at least one)."""

    def __init__(self, n_total: int, cap: Optional[int]):
        self.cap = n_total if cap is None else min(max(cap, 1), n_total)
        self.parts: List[tuple] = []
        self.n_kept = 0

    def add(self, *arrays) -> None:
        take = min(len(arrays[0]), self.cap - self.n_kept)
        if take > 0:
            self.parts.append(tuple(a[:take] for a in arrays))
            self.n_kept += take

    def arrays(self):
        return [np.concatenate(c) for c in zip(*self.parts)]


def _timed(fwd, params, xb, t_acc: List[float]):
    """Forward and the fetch of both outputs inside one timed window."""
    t0 = time.perf_counter()
    probs, sigma = fwd(params, xb)
    probs, sigma = probs.cpu().numpy(), sigma.cpu().numpy()
    t_acc[0] += time.perf_counter() - t0
    t_acc[1] += 1
    return probs, sigma


def run_testing3d(
    exp: ExperimentConfig,
    params,
    x: np.ndarray,
    y: np.ndarray,
    noise: NoiseConfig = NoiseConfig(),
    out_dir: Optional[str] = None,
    images_n: int = 4,
    seed: int = 0,
    mesh=None,
    mc_samples: int = 0,
    artifact_max_samples: Optional[int] = None,
    device="cuda",
) -> Dict[str, object]:
    """The ``testing`` protocol on volumes; returns metrics + artifact path.

    ``x``: [N, S, S, S, C] cubes, ``y``: [N, S, S, S] int labels.
    ``mc_samples > 0`` evaluates the Monte-Carlo weight-sampling baseline
    instead of the propagated moments. Metrics and the variance report
    accumulate online; ``artifact_max_samples`` caps the rows of the
    pickle and the renders (None: all volumes)."""
    cfg = exp.model
    fwd, params = _forward_and_params(cfg, params, device, mesh, mc_samples, seed)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    o = cfg.out_size
    rows = _Rows(len(x), artifact_max_samples)
    rep = reports.UncertaintyAccumulator(
        len(x), images_n=0, dataset=exp.name, adversarial=False
    )
    snrs: List[float] = []
    accs: List[float] = []
    structs = M.dataset_structures(exp.name)
    acc_metrics: Dict[str, List[M.StructureMetrics]] = {s: [] for s in structs}
    timing = [0.0, 0]
    noisy_run = noise.kind != "none" and noise.std > 0

    for i, (xb_np, yb_np) in enumerate(_batches(x, y, exp.train.batch_size)):
        y_crop = _crop(yb_np, o)
        xb = torch.as_tensor(xb_np, device=device)
        if noisy_run:
            # clip range and SNR on the center-cropped frames
            # (`Hippocampus.py:1270-1271,1302-1307`), all three axes
            xb, snr = perturb.apply_noise(
                perturb.noise_generator(seed, i), xb,
                torch.as_tensor(yb_np, device=device), noise, exp.name,
                crop_size=o,
            )
            snrs.append(float(snr))
        probs, sigma = _timed(fwd, params, xb, timing)
        probs_v, sigma_v, _ = _score_batch(
            probs, sigma, y_crop, cfg, exp.name, structs, acc_metrics, accs)
        xb_np = xb.cpu().numpy()
        rep.update(xb_np, probs_v, y_crop, sigma_v)
        rows.add(probs_v, sigma_v, xb_np, y_crop)

    region_dir = _REGION_DIR.get(noise.region, "on_all")
    sub = "clean" if not noisy_run else f"{noise.kind}_{noise.std}/{region_dir}"
    out_dir = out_dir or os.path.join(exp.out_dir, exp.name + "_3d", "testing", sub)
    os.makedirs(out_dir, exist_ok=True)

    result: Dict[str, object] = {
        "accuracy": float(np.mean(accs)),
        "snr_db": float(np.mean(snrs)) if snrs else float("inf"),
        "test_time_per_batch_s": timing[0] / max(timing[1], 1),
        "out_dir": out_dir,
    }
    if mc_samples > 0:
        result["mc_samples"] = mc_samples
    _aggregate_structures(result, structs, acc_metrics)
    probs_a, sigma_a, xs, ys = rows.arrays()
    reports.save_uncertainty_slices3d(
        out_dir, probs_a, sigma_a, xs, ys, images_n=images_n, n_classes=cfg.n_classes)
    unc = rep.finalize(out_dir)
    result["mean_predictive_variance"] = unc["mean"]
    result["artifact_samples"] = rows.n_kept
    reports.write_hyperparameters(
        out_dir, "Related_hyperparameters.txt", {**dataclasses.asdict(noise), **result})
    return result


def run_adversarial3d(
    exp: ExperimentConfig,
    params,
    x: np.ndarray,
    y: np.ndarray,
    out_dir: Optional[str] = None,
    images_n: int = 4,
    mesh=None,
    artifact_max_samples: Optional[int] = None,
    device="cuda",
) -> Dict[str, object]:
    """Adversarial evaluation on volumes: PGD when targeted or for
    hippocampus-style configs, one FGSM step otherwise (the branch of the
    2-D ``evaluate.run_adversarial``), the attack's gradient taken through
    the whole 3-D forward by autograd. Streams like ``run_testing3d``."""
    cfg = exp.model
    ac = exp.attack
    if isinstance(params, (list, tuple)):
        raise ValueError(
            "adversarial eval attacks ONE member's loss surface; pass a "
            "single checkpoint (ensemble attack transfer is out of scope)"
        )
    fwd, params = _forward_and_params(cfg, params, device, mesh)
    use_pgd = ac.targeted or exp.name == "hippocampus"
    attack = (make_pgd_attack if use_pgd else make_fgsm_attack)(
        cfg, ac, forward_fn=forward3d)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    o = cfg.out_size
    rows = _Rows(len(x), artifact_max_samples)
    rep = reports.UncertaintyAccumulator(
        len(x), images_n=0, dataset=exp.name, adversarial=True, targeted=ac.targeted)
    accs: List[float] = []
    snrs: List[float] = []
    structs = M.dataset_structures(exp.name)
    acc_metrics: Dict[str, List[M.StructureMetrics]] = {s: [] for s in structs}
    timing = [0.0, 0]

    for xb_np, yb_np in _batches(x, y, exp.train.batch_size):
        y_crop = _crop(yb_np, o)
        xb = torch.as_tensor(xb_np, device=device)
        y_attack = torch.as_tensor(y_crop, device=device)
        if ac.targeted:
            y_attack = retarget_labels(y_attack, ac.adversary_targeted_class, ac.adv_class)
        y_flat = one_hot_flatten(y_attack, cfg.n_classes)
        adv = attack(params, xb, y_flat, xb.min(), xb.max())
        # the fetch forces the attack to completion outside the timed window
        adv_np = adv.cpu().numpy()
        probs, sigma = _timed(fwd, params, adv, timing)
        probs_v, sigma_v, _ = _score_batch(
            probs, sigma, y_crop, cfg, exp.name, structs, acc_metrics, accs)
        adv_crop = _crop(adv_np, o)
        x_crop = _crop(xb_np, o)
        # SNR of the adversarial perturbation on the cropped frames
        # (`Hippocampus.py:995-1000`)
        snrs.append(float(perturb.snr_db(
            torch.from_numpy(np.ascontiguousarray(x_crop)),
            torch.from_numpy(np.ascontiguousarray(adv_crop)))))
        rep.update(adv_crop, probs_v, y_crop, sigma_v)
        rows.add(probs_v, sigma_v, adv_np, y_crop)

    mode = "targeted" if ac.targeted else "untargeted"
    out_dir = out_dir or os.path.join(
        exp.out_dir, exp.name + "_3d", "adversarial", f"{mode}_eps{ac.epsilon}")
    os.makedirs(out_dir, exist_ok=True)

    result: Dict[str, object] = {
        "accuracy": float(np.mean(accs)),
        "snr_db": float(np.mean(snrs)) if snrs else float("inf"),
        "test_time_per_batch_s": timing[0] / max(timing[1], 1),
        "out_dir": out_dir,
    }
    _aggregate_structures(result, structs, acc_metrics)
    probs_a, sigma_a, advs, ys = rows.arrays()
    reports.save_uncertainty_slices3d(
        out_dir, probs_a, sigma_a, advs, ys, images_n=images_n, n_classes=cfg.n_classes)
    pv = rep.finalize(out_dir)
    result["mean_predictive_variance"] = pv["mean"]
    result["artifact_samples"] = rows.n_kept
    for k, v in pv.items():
        if k != "mean":
            result[f"predictive_variance_{k}"] = v
    reports.write_hyperparameters(
        out_dir, "Related_hyperparameters_adversarial.txt",
        {**dataclasses.asdict(ac), **result})
    return result


def run_calibration3d(
    exp: ExperimentConfig,
    params,
    x: np.ndarray,
    y: np.ndarray,
    out_dir: Optional[str] = None,
    n_bins: int = 15,
    mesh=None,
    mc_samples: int = 0,
    device="cuda",
) -> Dict[str, object]:
    """The uncertainty-quality report on volumes: forward the set once,
    ``calibration.analyze`` voxel-wise (through the [N, D*H, W] view), and
    the 2-D runner's artifact set. ``mc_samples > 0`` scores the MC
    baseline's uncertainty instead."""
    from supernet_tpu_torch.calibration import analyze, write_calibration_artifacts

    cfg = exp.model
    fwd, params = _forward_and_params(cfg, params, device, mesh, mc_samples)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    o = cfg.out_size
    all_probs, all_sigma, all_y = [], [], []
    for xb_np, yb_np in _batches(x, y, exp.train.batch_size):
        b = len(xb_np)
        probs, sigma = fwd(params, torch.as_tensor(xb_np, device=device))
        all_probs.append(probs.cpu().numpy().reshape(b, o, o, o, cfg.n_classes))
        all_sigma.append(sigma.cpu().numpy().reshape(b, o, o, o, cfg.n_classes))
        all_y.append(_crop(yb_np, o))
    probs = np.concatenate(all_probs)
    sigma = np.concatenate(all_sigma)
    labels = np.concatenate(all_y).astype(np.int64)

    res = analyze(_as2d(probs), _as2d(sigma), _as2d(labels), exp.name, n_bins=n_bins)
    if mc_samples > 0:
        res["mc_samples"] = mc_samples
    if out_dir:
        write_calibration_artifacts(out_dir, res, exp.name + "_3d", len(labels))
        res["out_dir"] = out_dir
    return res


def run_noise_sweep3d(
    exp: ExperimentConfig,
    params,
    x: np.ndarray,
    y: np.ndarray,
    images_n: int = 4,
    mesh=None,
    mc_samples: int = 0,
    artifact_max_samples: Optional[int] = None,
    device="cuda",
) -> List[Dict[str, object]]:
    """Clean eval, then gaussian noise at each configured level x region
    (the volumetric module-level sweep, `Hippocampus.py:1578-1601`)."""
    noises = [NoiseConfig()] + [
        NoiseConfig(kind="gaussian", std=std, region=region)
        for std in exp.noise_levels
        for region in exp.noise_regions
    ]
    return [
        run_testing3d(exp, params, x, y, nc, images_n=images_n, mesh=mesh,
                      mc_samples=mc_samples,
                      artifact_max_samples=artifact_max_samples, device=device)
        for nc in noises
    ]
