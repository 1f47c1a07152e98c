"""Small host-side helpers mirroring the reference's utility surface."""

from __future__ import annotations

import sys

import numpy as np


def update_progress(progress: float, bar_length: int = 20) -> None:
    """stdout progress bar (``update_progress``,
    `Hippocampus_functions.py:157-174`): accepts a float in [0, 1]; values
    outside clamp with the reference's status messages."""
    status = ""
    if isinstance(progress, int):
        progress = float(progress)
    if not isinstance(progress, float):
        progress = 0.0
        status = "error: progress var must be float\r\n"
    if progress < 0:
        progress = 0.0
        status = "Halt...\r\n"
    if progress >= 1:
        progress = 1.0
        status = "Done...\r\n"
    block = int(round(bar_length * progress))
    text = "\rPercent: [{0}] {1:.2f}% {2}".format(
        "#" * block + "-" * (bar_length - block), progress * 100, status
    )
    sys.stdout.write(text)
    sys.stdout.flush()


def softplus_np(x: np.ndarray) -> np.ndarray:
    """NumPy softplus (`Hippocampus_functions.py:177-180`), stable form."""
    return np.logaddexp(0.0, x)


def uncert_for_corr(
    uncert: np.ndarray, pred: np.ndarray, dataset: str = "brats"
) -> dict:
    """Per-image mean uncertainty per predicted structure, for
    uncertainty-error correlation studies (``uncert_for_corr``,
    `Brats_functions.py:154-174`).

    ``uncert``: [N, H, W] predictive variance at the predicted class;
    ``pred``: [N, H, W] integer predictions. Returns {structure:
    np.ndarray[N]} with NaN where a structure is absent from an image.
    """
    from supernet_tpu_torch.metrics import binarize, dataset_structures

    out = {}
    for s in dataset_structures(dataset):
        mask = binarize(pred, s, dataset)
        num = (uncert * mask).sum(axis=(1, 2))
        den = mask.sum(axis=(1, 2))
        with np.errstate(invalid="ignore"):
            out[s] = np.where(den > 0, num / np.maximum(den, 1), np.nan)
    return out
