"""Segmentation metrics: Dice, Hausdorff, sensitivity/precision/specificity,
RVD, over-/under-segmentation, c-score, and the per-structure binary maskers.

Reference: `Hippocampus_functions.py:183-309` and
`Brats_functions.py:372-484`. Semantics preserved exactly:

- all ratio metrics are per-image (reduce over spatial axes (1,2)), invalid
  entries (0/0) dropped, then averaged over the batch;
- ``dice`` returns ``(mean, per_image)`` where invalid images are NaN — this
  unifies the two reference variants (Hippocampus returns ``(mean, var)``,
  `Hippocampus_functions.py:221`; BraTS returns ``(mean, masked array)``,
  `Brats_functions.py:413`) — use ``np.nanvar(per_image)`` /
  ``np.nanstd(per_image, ddof=1)`` to recover each;
- Hausdorff is the symmetric directed Hausdorff on binary masks treated as
  point sets of ROW VECTORS (the reference passes the [H, W] mask matrix
  straight to ``scipy.spatial.distance.directed_hausdorff``, so "points" are
  whole image rows in R^W — `Hippocampus_functions.py:227`; we reproduce that
  exact semantic for parity);
- binary maskers: Hippocampus anterior = (y == 1), posterior = (y == 2)
  (`Hippocampus_functions.py:248-280`); BraTS whole tumor = (y > 0), core =
  (y > 0 and y != 2), enhancing = (y == 4) (`Brats_functions.py:440-484`).
  The Hippocampus maskers return the full 9-tuple the reference intends
  (its 3-value return vs 9-value unpack is a catalogued defect, SURVEY §2.7.3).

Host/device split (SURVEY §7.3): everything here is NumPy, run on small eval
batches; the hot training-loop metrics (pixel accuracy, on-device dice) are
computed in ``supernet_tpu_torch.train`` / ``dice_torch`` below.

The port's own copy of ``supernet_tpu/metrics.py`` (the tests hold the two
equal on random inputs); ``dice_torch`` stands in for ``dice_jax``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

try:  # SciPy is available in the image; guarded for minimal installs.
    from scipy.spatial.distance import directed_hausdorff

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


def _nanmean(x) -> float:
    """np.nanmean without the all-NaN RuntimeWarning (returns NaN there);
    infinities propagate exactly as np.nanmean's would — e.g. a structure
    zeroed out of every image by an untargeted attack yields NaN dice."""
    x = np.asarray(x, np.float64)
    x = x[~np.isnan(x)]
    return float(np.mean(x)) if x.size else float("nan")


def _nanstd(x, ddof: int = 1) -> float:
    """np.nanstd(ddof) without the degrees-of-freedom warning when fewer
    than ddof+1 non-NaN values exist (returns NaN there)."""
    x = np.asarray(x, np.float64)
    if np.sum(~np.isnan(x)) <= ddof:
        return float("nan")
    return float(np.nanstd(x, ddof=ddof))


def dice(y_true: np.ndarray, y_pred: np.ndarray) -> Tuple[float, np.ndarray]:
    """Per-image Dice; returns (batch mean over valid images, per-image array
    with NaN where both masks are empty)."""
    a = np.sum(y_true, axis=(1, 2)).astype(np.float64)
    b = np.sum(y_pred, axis=(1, 2)).astype(np.float64)
    inter = np.sum(y_true * y_pred, axis=(1, 2)).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = 2.0 * inter / (a + b)
    return _nanmean(c), c


def compute_H(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Symmetric Hausdorff averaged over the batch, on the raw mask matrices
    (rows as points), matching `Hippocampus_functions.py:223-229`."""
    if not _HAVE_SCIPY:  # pragma: no cover
        return float("nan")
    n = y_true.shape[0]
    h = 0.0
    for i in range(n):
        h += max(
            directed_hausdorff(y_pred[i], y_true[i])[0],
            directed_hausdorff(y_true[i], y_pred[i])[0],
        )
    return h / n


def sensitivity(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Recall: TP / (TP + FN), per image, NaN-filtered mean."""
    tp = np.sum(y_true * y_pred, axis=(1, 2)).astype(np.float64)
    den = np.sum(y_true, axis=(1, 2)).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return _nanmean(tp / den)


def precision(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """TP / (TP + FP), per image, NaN-filtered mean."""
    tp = np.sum(y_true * y_pred, axis=(1, 2)).astype(np.float64)
    den = np.sum(y_pred, axis=(1, 2)).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return _nanmean(tp / den)


def specificity(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """TN / (TN + FP), per image, NaN-filtered mean
    (`Hippocampus_functions.py:232-246` via masked-array trickery)."""
    tn = np.sum((y_true == 0) & (y_pred == 0), axis=(1, 2)).astype(np.float64)
    neg = np.sum(y_true == 0, axis=(1, 2)).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return _nanmean(tn / neg)


def rvd(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Relative volume difference mean((|pred| - |true|) / |true|)
    (`Hippocampus_functions.py:288-296`)."""
    a = np.sum(y_true, axis=(1, 2)).astype(np.float64)
    b = np.sum(y_pred, axis=(1, 2)).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = (b - a) / a
    r[np.isinf(r)] = np.nan
    return _nanmean(r)


def os_and_us(
    y_true: np.ndarray, y_pred: np.ndarray
) -> Tuple[float, float]:
    """Over-/under-segmentation fractions of the union
    (`Hippocampus_functions.py:298-309`)."""
    a = np.sum(y_true, axis=(1, 2)).astype(np.float64)
    b = np.sum(y_pred, axis=(1, 2)).astype(np.float64)
    inter = np.sum(y_true * y_pred, axis=(1, 2)).astype(np.float64)
    union = a + b - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        over = (b - inter) / union
        under = (a - inter) / union
    return _nanmean(over), _nanmean(under)


def c_score(p: float, q: float) -> float:
    """Combined over/under score, signed by p < q
    (`Hippocampus_functions.py:281-287`). NumPy division semantics: degenerate
    inputs (p=1,q=0 / NaN) yield NaN/inf like the reference's np floats, not
    an exception."""
    p, q = np.float64(p), np.float64(q)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = 2 * p * (1 - q) / (p + (1 - q)) + 2 * (1 - p) * q / ((1 - p) + q)
    return float(-d if p < q else d)


class StructureMetrics(NamedTuple):
    """The 9-tuple the reference's callers unpack (`Hippocampus.py:968`)."""

    dice: float
    all_dice: np.ndarray  # per-image dice (NaN = invalid)
    hausdorff: float
    sensitivity: float
    precision: float
    specificity: float
    rvd: float
    over_seg: float
    under_seg: float


def structure_metrics(
    true_mask: np.ndarray, pred_mask: np.ndarray
) -> StructureMetrics:
    """All per-structure metrics on binary masks [B, H, W]."""
    di, all_di = dice(true_mask, pred_mask)
    over, under = os_and_us(true_mask, pred_mask)
    return StructureMetrics(
        dice=di,
        all_dice=all_di,
        hausdorff=compute_H(true_mask, pred_mask),
        sensitivity=sensitivity(true_mask, pred_mask),
        precision=precision(true_mask, pred_mask),
        specificity=specificity(true_mask, pred_mask),
        rvd=rvd(true_mask, pred_mask),
        over_seg=over,
        under_seg=under,
    )


# ------------------------------------------------------------------ maskers


def binarize(y: np.ndarray, structure: str, dataset: str) -> np.ndarray:
    """Multi-class label map -> float 0/1 mask for a clinical structure.

    Hippocampus (`Hippocampus_functions.py:248-280`):
      'anterior'  = (y == 1)   (class 2 zeroed, class 1 kept)
      'posterior' = (y == 2)
    BraTS (`Brats_functions.py:440-484`):
      'tumor' = (y > 0); 'core' = (y > 0) & (y != 2); 'enhancing' = (y == 4)
    Lungs (binary labels): 'object' = (y > 0).
    """
    if dataset == "hippocampus":
        table = {"anterior": y == 1, "posterior": y == 2}
    elif dataset == "brats":
        table = {
            "tumor": y > 0,
            "core": (y > 0) & (y != 2),
            "enhancing": y == 4,
        }
    else:
        table = {"object": y > 0}
    try:
        return table[structure].astype(np.float32)
    except KeyError:
        raise KeyError(
            f"unknown structure {structure!r} for {dataset}; "
            f"available: {sorted(table)}"
        ) from None


def dataset_structures(dataset: str) -> Tuple[str, ...]:
    return {
        "hippocampus": ("anterior", "posterior"),
        "brats": ("tumor", "core", "enhancing"),
    }.get(dataset, ("object",))


def mask_anterior(y_true, y_pred) -> StructureMetrics:
    return structure_metrics(
        binarize(np.asarray(y_true), "anterior", "hippocampus"),
        binarize(np.asarray(y_pred), "anterior", "hippocampus"),
    )


def mask_posterior(y_true, y_pred) -> StructureMetrics:
    return structure_metrics(
        binarize(np.asarray(y_true), "posterior", "hippocampus"),
        binarize(np.asarray(y_pred), "posterior", "hippocampus"),
    )


def mask_tumor(y_true, y_pred) -> StructureMetrics:
    return structure_metrics(
        binarize(np.asarray(y_true), "tumor", "brats"),
        binarize(np.asarray(y_pred), "tumor", "brats"),
    )


def mask_core(y_true, y_pred) -> StructureMetrics:
    return structure_metrics(
        binarize(np.asarray(y_true), "core", "brats"),
        binarize(np.asarray(y_pred), "core", "brats"),
    )


def mask_enh(y_true, y_pred) -> StructureMetrics:
    return structure_metrics(
        binarize(np.asarray(y_true), "enhancing", "brats"),
        binarize(np.asarray(y_pred), "enhancing", "brats"),
    )


# ------------------------------------------------------------ torch variant


def dice_torch(true_mask, pred_mask):
    """Batch-mean dice on 0/1 mask tensors [B, H, W] (invalid -> excluded),
    computed on the tensors' own device for metric accumulation in the
    train loop."""
    import torch

    a = true_mask.sum(dim=(1, 2))
    b = pred_mask.sum(dim=(1, 2))
    inter = (true_mask * pred_mask).sum(dim=(1, 2))
    denom = a + b
    valid = denom > 0
    c = torch.where(valid, 2.0 * inter / torch.clamp_min(denom, 1.0), 0.0)
    n_valid = torch.clamp_min(valid.sum(), 1)
    return c.sum() / n_valid


def uncertainty_at_prediction(
    sigma: np.ndarray, pred: np.ndarray
) -> np.ndarray:
    """Per-pixel predictive variance at the predicted class:
    ``sigma[..., argmax]`` (`Hippocampus.py:1039-1043`,
    `Hippocampus_functions.py:58-63`). sigma [B, H, W, C], pred [B, H, W]."""
    return np.take_along_axis(sigma, pred[..., None].astype(np.int64), -1)[
        ..., 0
    ]
