"""Synthetic segmentation data for tests, benchmarks, and smoke training.

The reference's datasets (Task04_Hippocampus pickle, BraTS batched pickles)
are not in the snapshot (`README.md:24-29`), so every runnable path in this
repo needs a stand-in with the same shapes/dtypes: images [B, H, W, C] f32,
integer labels [B, H, W] in [0, n_classes). Blobs are geometric (ellipses)
so Dice on a trained model is actually learnable.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from supernet_tpu_torch.configs import ModelConfig


def synthetic_dataset(
    cfg: ModelConfig, n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """n samples of (image, label) shaped for ``cfg``.

    Each image contains per-foreground-class elliptical blobs; image
    intensity correlates with class so the task is learnable. Labels span
    the full input size (callers center-crop to cfg.out_size as the
    reference does, `Hippocampus.py:612`).
    """
    rng = np.random.default_rng(seed)
    h = w = cfg.image_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    x = rng.normal(0.0, 0.05, (n, h, w, cfg.in_channels)).astype(np.float32)
    y = np.zeros((n, h, w), np.int32)
    for i in range(n):
        for cls in range(1, cfg.n_classes):
            cy, cx = rng.uniform(0.25 * h, 0.75 * h), rng.uniform(
                0.25 * w, 0.75 * w
            )
            ry, rx = rng.uniform(0.06 * h, 0.15 * h), rng.uniform(
                0.06 * w, 0.15 * w
            )
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            y[i][blob] = cls
            x[i, ..., i % cfg.in_channels][blob] += 0.4 + 0.2 * cls
    return x, y


def synthetic_volumes(
    cfg: ModelConfig, n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """n cube samples for the 3-D family (`models/unet3d.py`): per-class
    ellipsoidal blobs with class-correlated intensity, labels spanning the
    full cube (Trainer3D center-crops to cfg.out_size per axis)."""
    rng = np.random.default_rng(seed)
    s = cfg.image_size
    zz, yy, xx = np.mgrid[0:s, 0:s, 0:s].astype(np.float32)
    x = rng.normal(0.0, 0.05, (n, s, s, s, cfg.in_channels)).astype(
        np.float32
    )
    y = np.zeros((n, s, s, s), np.int32)
    for i in range(n):
        for cls in range(1, cfg.n_classes):
            c = rng.uniform(0.25 * s, 0.75 * s, 3)
            r = rng.uniform(0.08 * s, 0.2 * s, 3)
            blob = (
                ((zz - c[0]) / r[0]) ** 2
                + ((yy - c[1]) / r[1]) ** 2
                + ((xx - c[2]) / r[2]) ** 2
                < 1.0
            )
            y[i][blob] = cls
            x[i, ..., i % cfg.in_channels][blob] += 0.4 + 0.2 * cls
    return x, y
