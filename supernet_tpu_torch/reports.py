"""Uncertainty reporting: PNG renders, predictive-variance text reports, and
pickle artifacts — the reference's downstream-facing output surface.

Reference: ``save_adversarial_uncertainty`` + ``save_uncertainty``
(`Hippocampus_functions.py:29-145`, `Brats_functions.py:177-337,584-603`,
`Hippocampus.py:1549-1568`), plus the ``uncertainty_info*.pkl`` dumps and
``Related_hyperparameters*.txt`` files (`Hippocampus.py:1401-1546`).

Reproduced artifact set (so downstream notebooks keep working):
- per-sample PNGs: adversarial-noise overlay, ground-truth label, predicted
  label (the reference's custom colormaps: 3-color black/yellow/red for
  Hippocampus, 5-color black/cyan/lime/yellow/red for BraTS), uncertainty
  heatmap (``winter_r`` + colorbar), masked label (targeted attacks);
- ``Predictive_variance_tasks.txt`` with mean predictive variance overall,
  per structure (and per class + correct/incorrect for BraTS) — the
  reference's ``incorrect_unc`` bug (reusing the correct mask,
  `Brats_functions.py:299`) is fixed here, as catalogued in SURVEY §2.7.8;
- ``uncertainty_info*.pkl`` = [probs, sigma, images, labels, (acc)];
- ``Related_hyperparameters*.txt`` key-value dumps.

The sampled indices use the reference's seeds (3 for Hippocampus over N=403;
70 for BraTS over the actual N) so renders land on the same samples.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from supernet_tpu_torch.metrics import uncertainty_at_prediction

try:  # headless-safe matplotlib, optional
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    _HAVE_MPL = True
except Exception:  # pragma: no cover
    _HAVE_MPL = False


_COLORS = {
    3: ["Black", "Yellow", "Red"],  # Hippocampus_functions.py:52
    5: ["Black", "Cyan", "Lime", "Yellow", "Red"],  # Brats_functions.py:199
}


def label_colormap(n_classes: int):
    """The reference's custom label colormaps."""
    colours = _COLORS.get(n_classes)
    if colours is None:
        colours = ["Black"] + [f"C{i}" for i in range(n_classes - 1)]
    pts = [(v / (n_classes - 1), c) for v, c in enumerate(colours)]
    return LinearSegmentedColormap.from_list("custom", pts)


def _save(fig_path: str) -> None:
    ax = plt.gca()
    ax.axes.xaxis.set_visible(False)
    ax.axes.yaxis.set_visible(False)
    plt.savefig(fig_path)
    plt.close()


def sample_indices(n_total: int, images_n: int, dataset: str) -> np.ndarray:
    """The reference's sampled render indices: seed 3 over N=403 for
    Hippocampus (`Hippocampus_functions.py:39,49`), seed 70 over the actual
    N for BraTS (`Brats_functions.py:185,194`)."""
    if dataset == "hippocampus":
        np.random.seed(3)
        return np.random.choice(np.arange(min(403, n_total)), images_n)
    np.random.seed(70)
    return np.random.choice(np.arange(n_total), images_n)


def _variance_conditions(dataset: str, n_classes: int):
    """Ordered ``{key: fn(predict, truey) -> bool mask}`` for the
    reference's ``Predictive_variance_tasks.txt`` groups
    (`Hippocampus_functions.py:100-145`, `Brats_functions.py:296-335`)."""
    if dataset == "hippocampus":
        return {
            "anterior": lambda p, y: p == 1,
            "non_anterior": lambda p, y: p != 1,
            "posterior": lambda p, y: p == 2,
            "non_posterior": lambda p, y: p != 2,
        }
    conds = {
        "tumor": lambda p, y: p > 0,
        "background": lambda p, y: p == 0,
        "core": lambda p, y: (p > 0) & (p != 2),
        "non_core": lambda p, y: ~((p > 0) & (p != 2)),
        "enhancing": lambda p, y: p == 4,
        "non_enhancing": lambda p, y: p != 4,
    }
    for cls in range(1, n_classes):
        conds[f"class{cls}"] = (lambda c: lambda p, y: p == c)(cls)
    conds["correct"] = lambda p, y: p == y
    # the reference's incorrect_unc reuses the correct mask
    # (`Brats_functions.py:299`) — fixed here, catalogued SURVEY §2.7.8
    conds["incorrect"] = lambda p, y: p != y
    return conds


def _render_sample(
    img_dir: str,
    i: int,
    truex_i: np.ndarray,
    adv_i: Optional[np.ndarray],
    predict_i: np.ndarray,
    uncert_i: np.ndarray,
    truey_i: np.ndarray,
    masked_i: Optional[np.ndarray],
    cmap,
    adversarial: bool,
    targeted: bool,
) -> None:
    """The reference's per-sample PNG set (`Hippocampus_functions.py:55-98`,
    `Brats_functions.py:203-294`)."""
    if adversarial and adv_i is not None:
        n_mod = truex_i.shape[-1] if truex_i.ndim == 3 else 1
        if n_mod > 1:  # BraTS 4-modality overlay (Brats_functions.py:211)
            plt.figure(figsize=(10 * n_mod, 10))
            for j in range(n_mod):
                plt.subplot(1, n_mod, j + 1)
                plt.imshow(truex_i[:, :, j], "gray", interpolation="none")
                plt.imshow(adv_i[:, :, j], "gray",
                           interpolation="none", alpha=0.9)
                ax = plt.gca()
                ax.axes.xaxis.set_visible(False)
                ax.axes.yaxis.set_visible(False)
            plt.savefig(os.path.join(img_dir, f"{i}_Adversarial_noise.png"))
            plt.close()
        else:
            plt.figure()
            plt.imshow(np.squeeze(truex_i), "gray", interpolation="none")
            plt.imshow(np.squeeze(adv_i), "gray",
                       interpolation="none", alpha=0.8)
            _save(os.path.join(img_dir, f"{i}_Adversarial_noise.png"))
    plt.figure(figsize=(10, 10))
    plt.imshow(truey_i, cmap, interpolation="none")
    plt.title("Ground truth Label")
    _save(os.path.join(img_dir, f"{i}_Label_image.png"))
    plt.figure(figsize=(10, 10))
    plt.imshow(predict_i, cmap, interpolation="none")
    plt.title("Predicted Label")
    _save(os.path.join(img_dir, f"{i}_Predicted_image.png"))
    plt.figure(figsize=(10, 10))
    im = plt.imshow(uncert_i, cmap="winter_r", interpolation="nearest")
    plt.title("Uncertainty map")
    plt.colorbar(im, fraction=0.046, pad=0.04)
    _save(os.path.join(img_dir, f"{i}_uncertainty_heatmap.png"))
    if adversarial and targeted and masked_i is not None:
        plt.figure(figsize=(10, 10))
        plt.imshow(masked_i, cmap, interpolation="none")
        plt.title("Masked Label")
        _save(os.path.join(img_dir, f"{i}_Masked_Label_image.png"))


class UncertaintyAccumulator:
    """Online twin of ``save_uncertainty_report``: feed it batches, it
    holds O(batch + selected-render-samples) host memory — running
    per-condition (sum, count) pairs in float64 plus only the rows whose
    global index was pre-selected for rendering. ``finalize`` writes the
    same PNG set and ``Predictive_variance_tasks.txt`` byte-for-byte as
    the one-shot path (which is itself a wrapper over this class), so the
    eval protocols can stream arbitrarily large test sets.

    ``n_total`` must be the FULL dataset size (the reference's sampled
    render indices are drawn over N upfront: seed 3/N<=403 Hippocampus,
    seed 70/N BraTS — `Hippocampus_functions.py:39,49`).
    """

    def __init__(
        self,
        n_total: int,
        images_n: int = 10,
        dataset: str = "hippocampus",
        adversarial: bool = True,
        targeted: bool = True,
    ):
        sel = (
            sample_indices(n_total, images_n, dataset)
            if images_n > 0
            else np.empty((0,), np.int64)
        )
        self._sel = set(int(i) for i in sel)
        self.dataset = dataset
        self.adversarial = adversarial
        self.targeted = targeted
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._total_sum = 0.0
        self._total_cnt = 0
        self._stash: Dict[int, tuple] = {}
        self._n_seen = 0
        self._n_classes: Optional[int] = None
        self._conds = None

    @property
    def n_seen(self) -> int:
        return self._n_seen

    @property
    def n_stashed(self) -> int:
        """Rows held for rendering — the accumulator's entire per-sample
        memory footprint (bounded by images_n)."""
        return len(self._stash)

    def update(
        self,
        truex: np.ndarray,
        probs: np.ndarray,
        truey: np.ndarray,
        sigma: np.ndarray,
        adv: Optional[np.ndarray] = None,
        masked: Optional[np.ndarray] = None,
    ) -> None:
        n = len(probs)
        i0 = self._n_seen
        self._n_seen += n
        predict = np.argmax(probs, axis=-1)
        uncert = uncertainty_at_prediction(sigma, predict)
        if self._n_classes is None:
            self._n_classes = probs.shape[-1]
            self._conds = _variance_conditions(self.dataset, self._n_classes)
        self._total_sum += float(uncert.sum(dtype=np.float64))
        self._total_cnt += uncert.size
        for key, fn in self._conds.items():
            m = fn(predict, truey)
            self._sums[key] = self._sums.get(key, 0.0) + float(
                uncert[m].sum(dtype=np.float64)
            )
            self._counts[key] = self._counts.get(key, 0) + int(m.sum())
        for i in range(n):
            gi = i0 + i
            if gi in self._sel:
                self._stash[gi] = (
                    np.asarray(truex[i]),
                    None if adv is None else np.asarray(adv[i]),
                    predict[i],
                    uncert[i],
                    np.asarray(truey[i]),
                    None if masked is None else np.asarray(masked[i]),
                )

    def _mean(self, key: str) -> float:
        c = self._counts.get(key, 0)
        return self._sums.get(key, 0.0) / c if c else float("nan")

    def finalize(self, path: str) -> Dict[str, float]:
        """Render the stashed samples + write the variance report; returns
        the mean predictive variances the reference returns."""
        n_classes = self._n_classes or 2
        mean_u = self._total_sum / self._total_cnt if self._total_cnt else float("nan")
        out: Dict[str, float] = {"mean": mean_u}

        if _HAVE_MPL and self._stash:
            img_dir = os.path.join(path, "test_images")
            os.makedirs(img_dir, exist_ok=True)
            cmap = label_colormap(n_classes)
            for i in sorted(self._stash):
                tx, ad, pr, un, ty, mk = self._stash[i]
                _render_sample(
                    img_dir, i, tx, ad, pr, un, ty, mk, cmap,
                    self.adversarial, self.targeted,
                )

        os.makedirs(path, exist_ok=True)
        lines = [f"\n Average Predictive variance : {mean_u}"]
        lines.append("\n---------------------------------")
        if self.dataset == "hippocampus":
            for key in ("anterior", "non_anterior", "posterior",
                        "non_posterior"):
                out[key] = self._mean(key)
            lines.append(
                "\n Predictive variance for all  anterior structures : "
                + str(out["anterior"])
            )
            lines.append(
                "\n Predictive variance for non-anterior structures : "
                + str(out["non_anterior"])
            )
            lines.append("\n---------------------------------")
            lines.append(
                "\n Predictive variance for posterior portion : "
                + str(out["posterior"])
            )
            lines.append(
                "\n Predictive variance for non-posterior structures : "
                + str(out["non_posterior"])
            )
        else:
            for key in self._conds or _variance_conditions(
                self.dataset, n_classes
            ):
                out[key] = self._mean(key)
            lines += [
                f"\n Predictive variance for all tumor structures : {out['tumor']}",
                f"\n Predictive variance for non-tumor structures : {out['background']}",
                "\n---------------------------------",
                f"\n Predictive variance for core portion : {out['core']}",
                f"\n Predictive variance for non-core structures : {out['non_core']}",
                "\n---------------------------------",
                f"\n Predictive variance for enhancing portion : {out['enhancing']}",
                f"\n Predictive variance for non-enhancing portion : {out['non_enhancing']}",
                "\n-----------Uncertainty Per Class--------------",
            ]
            for cls in range(n_classes):
                key = "background" if cls == 0 else f"class{cls}"
                lines.append(
                    f"\n Predictive variance for class {cls} : {out[key]}"
                )
            lines += [
                "\n-------------------------",
                f"\n Predictive variance for correct : {out['correct']}",
                f"\n Predictive variance for incorrect : {out['incorrect']}",
            ]

        with open(os.path.join(path, "Predictive_variance_tasks.txt"), "w") as f:
            f.writelines(lines)
        return out


def save_uncertainty_report(
    path: str,
    truex: np.ndarray,  # clean images   [N, H, W, C] (or [N, H, W])
    adv: Optional[np.ndarray],  # corrupted/adversarial images, same shape
    probs: np.ndarray,  # predictive probabilities [N, H, W, C_cls]
    truey: np.ndarray,  # integer labels [N, H, W]
    sigma: np.ndarray,  # predictive variance [N, H, W, C_cls]
    masked: Optional[np.ndarray] = None,  # retargeted labels (targeted atk)
    images_n: int = 10,
    adversarial: bool = True,
    targeted: bool = True,
    dataset: str = "hippocampus",
) -> Dict[str, float]:
    """Render PNGs + write Predictive_variance_tasks.txt; returns the mean
    predictive variances the reference returns. One-shot wrapper over
    ``UncertaintyAccumulator`` (the streaming path the eval protocols use)."""
    acc = UncertaintyAccumulator(
        len(truex), images_n=images_n, dataset=dataset,
        adversarial=adversarial, targeted=targeted,
    )
    acc.update(truex, probs, truey, sigma, adv=adv, masked=masked)
    return acc.finalize(path)


_REGION_NAME = {
    "A": "anterior",
    "P": "posterior",
    "O": "object",
    "B": "background",
}


def uncertainty_artifact_name(noise_std: float = 0.0, region: str = "all") -> str:
    """The reference's noise-mode-specific artifact filename
    (`Hippocampus.py:1408-1449`, `Brats.py:1363-1425`,
    `Brats_functions.py:586-598`): clean -> ``uncertainty_info.pkl``;
    region-masked noise -> ``uncertainty_info_on_{region}_noise_{std}.pkl``;
    noise everywhere -> ``uncertainty_info_noise_{std}.pkl``."""
    if not noise_std:
        return "uncertainty_info.pkl"
    name = _REGION_NAME.get(region)
    if name is None:
        return f"uncertainty_info_noise_{noise_std}.pkl"
    return f"uncertainty_info_on_{name}_noise_{noise_std}.pkl"


def save_uncertainty_artifact(
    path: str,
    probs: np.ndarray,
    sigma: np.ndarray,
    images: np.ndarray,
    labels: np.ndarray,
    acc: Optional[float] = None,
    name: str = "uncertainty_info.pkl",
) -> str:
    """``uncertainty_info*.pkl`` = [probs, sigma, images, labels, (acc)]
    (`Hippocampus.py:1420,1449`)."""
    os.makedirs(path, exist_ok=True)
    payload = [probs, sigma, images, labels]
    if acc is not None:
        payload.append(acc)
    full = os.path.join(path, name)
    with open(full, "wb") as f:
        pickle.dump(payload, f)
    return full


def load_uncertainty_artifact(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_uncertainty(
    path: str,
    images_n: int = 10,
    noise: float = 0.0,
    where_noise: str = "all",
    dataset: str = "hippocampus",
) -> Dict[str, float]:
    """The reference's ``save_uncertainty(path, images_n, noise,
    where_noise)`` (`Hippocampus.py:1549-1568`, `Brats_functions.py:584-603`):
    select the noise-mode-specific artifact inside ``path`` and re-render
    the uncertainty report from it."""
    artifact = os.path.join(
        path, uncertainty_artifact_name(noise, where_noise)
    )
    return save_uncertainty_from_artifact(
        artifact, images_n=images_n, dataset=dataset
    )


def save_uncertainty_from_artifact(
    artifact_path: str,
    out_dir: Optional[str] = None,
    images_n: int = 10,
    dataset: str = "hippocampus",
) -> Dict[str, float]:
    """Offline re-render from a saved artifact (``save_uncertainty``,
    `Hippocampus.py:1549-1568`)."""
    payload = load_uncertainty_artifact(artifact_path)
    probs, sigma, images, labels = payload[:4]
    probs, sigma = np.asarray(probs), np.asarray(sigma)
    if probs.ndim == 3:  # [N, HW, C] -> [N, H, W, C]
        side = int(np.sqrt(probs.shape[1]))
        probs = probs.reshape(-1, side, side, probs.shape[-1])
        sigma = sigma.reshape(-1, side, side, sigma.shape[-1])
    out_dir = out_dir or os.path.dirname(os.path.abspath(artifact_path))
    return save_uncertainty_report(
        out_dir,
        np.asarray(images),
        np.asarray(images),
        probs,
        np.asarray(labels),
        sigma,
        images_n=images_n,
        adversarial=False,
        dataset=dataset,
    )


def write_hyperparameters(path: str, name: str, values: Dict) -> str:
    """``Related_hyperparameters*.txt`` key-value dump
    (`Hippocampus.py:798-837`)."""
    os.makedirs(path, exist_ok=True)
    full = os.path.join(path, name)
    with open(full, "w") as f:
        for k, v in values.items():
            f.write(f"\n {k} : {v}")
    return full


def save_saliency_maps(
    path: str,
    x: np.ndarray,  # input image [H, W, C] (BraTS: 4 modalities)
    saliency: np.ndarray,  # raw gradient [H, W, C]
    saliency_relu: np.ndarray,  # ReLU'd gradient [H, W, C]
    index: int = 0,
    mask: Optional[np.ndarray] = None,  # binary structure mask [H, W]
) -> None:
    """Per-modality saliency overlays (``plot_saliency_map`` + ``get_mask``,
    `Brats_functions.py:23-140`): for each input modality, the image, the
    raw-gradient saliency and the ReLU'd saliency (plus the structure mask
    when given). The gradients come from ``attacks.make_saliency_map``
    (`Brats.py:598-609`)."""
    if not _HAVE_MPL:  # pragma: no cover
        return
    os.makedirs(path, exist_ok=True)
    n_mod = x.shape[-1] if x.ndim == 3 else 1
    x = x if x.ndim == 3 else x[..., None]
    saliency = saliency if saliency.ndim == 3 else saliency[..., None]
    saliency_relu = (
        saliency_relu if saliency_relu.ndim == 3 else saliency_relu[..., None]
    )
    rows = 3 + (1 if mask is not None else 0)
    plt.figure(figsize=(6 * n_mod, 6 * rows))
    for j in range(n_mod):
        plt.subplot(rows, n_mod, j + 1)
        plt.imshow(x[:, :, j], "gray", interpolation="none")
        plt.title(f"modality {j}")
        plt.axis("off")
        plt.subplot(rows, n_mod, n_mod + j + 1)
        plt.imshow(saliency[:, :, j], "hot", interpolation="none")
        plt.title("saliency (raw grad)")
        plt.axis("off")
        plt.subplot(rows, n_mod, 2 * n_mod + j + 1)
        plt.imshow(saliency_relu[:, :, j], "hot", interpolation="none")
        plt.title("saliency (relu grad)")
        plt.axis("off")
    if mask is not None:
        plt.subplot(rows, n_mod, 3 * n_mod + 1)
        plt.imshow(mask, "gray", interpolation="none")
        plt.title("structure mask")
        plt.axis("off")
    plt.savefig(os.path.join(path, f"{index}_saliency.png"))
    plt.close()


def save_training_curves(
    path: str, curves: Dict[str, Sequence[float]], prefix: str = ""
) -> None:
    """Per-epoch metric curves as PNGs (`Hippocampus.py:744-792`)."""
    if not _HAVE_MPL:  # pragma: no cover
        return
    os.makedirs(path, exist_ok=True)
    for name, values in curves.items():
        plt.figure()
        plt.plot(np.arange(1, len(values) + 1), values)
        plt.xlabel("epoch")
        plt.ylabel(name)
        plt.grid(True, alpha=0.3)
        plt.savefig(os.path.join(path, f"{prefix}{name}.png"))
        plt.close()


def save_history_pickle(path: str, history: Dict, name: str = "history.pkl"):
    """Training-history pickle (`Hippocampus.py:794-796`)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "wb") as f:
        pickle.dump(history, f)


def save_reference_training_curves(
    path: str, history: Dict[str, Sequence[float]], structures: Sequence[str]
) -> None:
    """The reference's named training-artifact set (`Hippocampus.py:744-796`):

    - ``VDP_UNET_Data_acc.png``   — validation accuracy per epoch;
    - ``VDP_UNET_Data_error.png`` — training + validation error (loss);
    - ``VDP_UNET_Data_DICE.png``  — train/val Dice per structure;
    - ``VDP_UNET_Data_Haus.png``  — train/val Hausdorff per structure;
    - ``training_validation_acc_error.pkl`` = [train_acc, valid_acc,
      train_err, valid_error].

    PNGs are written only for multi-epoch runs (the reference's
    ``epochs > 1`` guard); the pickle is always written.
    """
    os.makedirs(path, exist_ok=True)
    train_acc = np.asarray(history.get("train_acc", []), np.float64)
    valid_acc = np.asarray(history.get("val_acc", []), np.float64)
    train_err = np.asarray(history.get("train_loss", []), np.float64)
    valid_err = np.asarray(history.get("val_loss", []), np.float64)
    with open(
        os.path.join(path, "training_validation_acc_error.pkl"), "wb"
    ) as f:
        pickle.dump([train_acc, valid_acc, train_err, valid_err], f)

    epochs = len(train_err)
    if not _HAVE_MPL or epochs <= 1:  # pragma: no cover - mpl guard
        return

    def _fig(series, ylabel, fname, ylim=None, loc="lower right"):
        fig = plt.figure(figsize=(15, 7))
        plotted = 0
        for label, values, colour in series:
            if len(values):
                plt.plot(values, colour, label=label)
                plotted += 1
        if ylim:
            plt.ylim(*ylim)
        plt.title("Density Propagation for Segmentation with UNET")
        plt.xlabel("Epochs")
        plt.ylabel(ylabel)
        if plotted:
            plt.legend(loc=loc)
        plt.savefig(os.path.join(path, fname))
        plt.close(fig)

    _fig(
        [("Validation acc", valid_acc, "r")],
        "Accuracy",
        "VDP_UNET_Data_acc.png",
        ylim=(0, 1.1),
    )
    _fig(
        [("Training error", train_err, "b"),
         ("Validation error", valid_err, "r")],
        "Error",
        "VDP_UNET_Data_error.png",
        loc="upper right",
    )
    palette = [("b", "r"), ("royalblue", "firebrick"), ("navy", "darkred")]
    dice_series, haus_series = [], []
    for i, s in enumerate(structures):
        ct, cv = palette[i % len(palette)]
        dice_series += [
            (f"Training Dice {s}", history.get(f"train_dice_{s}", []), ct),
            (f"Validation Dice {s}", history.get(f"val_dice_{s}", []), cv),
        ]
        haus_series += [
            (f"Training Haus {s}", history.get(f"train_haus_{s}", []), ct),
            (f"Validation Haus {s}", history.get(f"val_haus_{s}", []), cv),
        ]
    _fig(dice_series, "dice coefficient", "VDP_UNET_Data_DICE.png")
    _fig(haus_series, "Hausdorff coefficient", "VDP_UNET_Data_Haus.png")


def save_uncertainty_slices3d(
    path: str,
    probs: np.ndarray,
    sigma: np.ndarray,
    volumes: np.ndarray,
    labels: np.ndarray,
    images_n: int = 4,
    n_classes: int = 3,
) -> Dict[str, float]:
    """Volumetric analog of the uncertainty report: renders the CENTER
    axial slice of each sampled volume — input, ground-truth label,
    predicted label, and the predictive-variance heatmap (same winter_r +
    colorbar styling as the 2-D artifacts) — plus the
    `uncertainty_info.pkl` payload with the full volumes.

    probs/sigma: [N, o, o, o, C]; volumes: [N, S, S, S, C_in];
    labels: [N, o, o, o] int. Returns {"mean": mean predictive variance
    at the predicted class}.
    """
    os.makedirs(path, exist_ok=True)
    pred = np.argmax(probs, axis=-1)
    uncert = np.take_along_axis(sigma, pred[..., None], axis=-1)[..., 0]
    out = {"mean": float(np.mean(uncert))}
    with open(os.path.join(path, "uncertainty_info.pkl"), "wb") as f:
        pickle.dump([probs, sigma, volumes, labels], f)
    if _HAVE_MPL and images_n > 0:
        img_dir = os.path.join(path, "test_images")
        os.makedirs(img_dir, exist_ok=True)
        cmap = label_colormap(n_classes)
        mid_in = volumes.shape[1] // 2
        mid_out = labels.shape[1] // 2
        for i in range(min(images_n, len(volumes))):
            plt.figure(figsize=(10, 10))
            plt.imshow(volumes[i, mid_in, :, :, 0], "gray",
                       interpolation="none")
            plt.title("Input (center slice)")
            _save(os.path.join(img_dir, f"{i}_Input_slice.png"))
            plt.figure(figsize=(10, 10))
            plt.imshow(labels[i, mid_out], cmap, interpolation="none")
            plt.title("Ground truth Label (center slice)")
            _save(os.path.join(img_dir, f"{i}_Label_slice.png"))
            plt.figure(figsize=(10, 10))
            plt.imshow(pred[i, mid_out], cmap, interpolation="none")
            plt.title("Predicted Label (center slice)")
            _save(os.path.join(img_dir, f"{i}_Predicted_slice.png"))
            plt.figure(figsize=(10, 10))
            im = plt.imshow(uncert[i, mid_out], cmap="winter_r",
                            interpolation="nearest")
            plt.title("Uncertainty map (center slice)")
            plt.colorbar(im, fraction=0.046, pad=0.04)
            _save(os.path.join(img_dir, f"{i}_uncertainty_heatmap.png"))
    return out
