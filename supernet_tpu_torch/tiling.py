"""Sliding-window inference at arbitrary spatial shapes (2-D and 3-D).

The port's own copy of ``supernet_tpu/tiling.py`` (numpy only), so the port
imports nothing of the JAX package.

The VDP U-Nets map one fixed input frame (side ``cfg.image_size``) to a
center-aligned output frame (side ``cfg.out_size``) — the VALID geometry
of the reference's chains (`Hippocampus.py:375-418`). Real MSD/BraTS
volumes (and off-protocol slices) are larger than a single model frame,
so full-frame prediction tiles the input with overlapping frames and
blends the per-tile moment pairs:

- the tile grid is STATIC for a given (volume shape, config, overlap) —
  every tile runs through the same compiled program at the same batch
  shape (the TPU-friendly formulation: one XLA executable, MXU-sized
  batches of tiles, no dynamic shapes);
- blending is a per-voxel weighted average with either uniform or
  separable-Gaussian tile weights (the Gaussian down-weights tile borders,
  where VALID-padding context is thinnest);
- ``probs`` stays on the simplex (a convex combination of softmax outputs,
  renormalized against fp drift); ``sigma`` is blended with the same
  weights — the standard approximation that ignores cross-tile covariance
  of the SAME voxel predicted from different contexts (the propagated
  variances are per-tile diagonals; disagreement between tiles is visible
  as spatial structure in the blended map, not re-added to it).

Everything here is host-side numpy around a batched device ``predict``
callable (e.g. ``serving.InferenceSession.predict``) — assembly is
O(volume) elementwise work; the model FLOPs stay on device.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

Predict = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


def tile_positions(size: int, tile: int, stride: int) -> List[int]:
    """Start offsets of ``tile``-long windows covering ``[0, size)`` with
    step ``stride``, the last window clamped flush to the end. ``size``
    must be >= ``tile`` (pad first otherwise)."""
    if tile > size:
        raise ValueError(f"tile {tile} exceeds size {size}; pad first")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    pos = list(range(0, size - tile + 1, stride))
    if pos[-1] != size - tile:
        pos.append(size - tile)
    return pos


def _axis_weights(o: int, kind: str) -> np.ndarray:
    if kind == "uniform":
        return np.ones(o, np.float32)
    if kind == "gaussian":
        # nnU-Net-style border down-weighting: sigma = tile/8, floored so
        # voxels covered by a single tile keep a usable weight
        c = (o - 1) / 2.0
        w = np.exp(-0.5 * ((np.arange(o) - c) / (o / 8.0)) ** 2)
        return np.maximum(w, 1e-6)
    raise ValueError(f"unknown weight kind {kind!r} (uniform|gaussian)")


def output_margins(in_size: int, out_size: int) -> Tuple[int, int]:
    """(front, back) voxels the VALID chain shaves off one axis: the
    output cube sits center-aligned in the input cube."""
    shrink = in_size - out_size
    if shrink < 0:
        raise ValueError(f"out_size {out_size} exceeds in_size {in_size}")
    lo = shrink // 2
    return lo, shrink - lo


def predict_volume(
    predict: Predict,
    vol: np.ndarray,
    in_size: int,
    out_size: int,
    overlap: int = 0,
    weight: str = "gaussian",
    pad_mode: str = "reflect",
) -> Tuple[np.ndarray, np.ndarray]:
    """Full-volume ``(probs, sigma)`` for one volume of any spatial shape.

    ``predict`` maps a batch of input cubes ``[N, T, T, T, C]`` to
    moment-pair cubes ``[N, O, O, O, K]`` (``serving.InferenceSession
    .predict`` with ``volumetric=True`` is exactly this). ``vol`` is
    ``[D, H, W]`` or ``[D, H, W, C]``; the returned maps are
    ``[D, H, W, K]`` — the model's interior-only VALID output is extended
    to the full frame by reflect-padding the input by the output margins
    (``pad_mode`` as in ``np.pad``; axes shorter than the reflect window
    fall back to edge padding).

    ``overlap`` is in OUTPUT voxels (0 = abutting tiles); the tile stride
    is ``out_size - overlap``.
    """
    vol = np.asarray(vol, np.float32)
    if vol.ndim == 3:
        vol = vol[..., None]
    if vol.ndim != 4:
        raise ValueError(f"expected [D,H,W] or [D,H,W,C], got {vol.shape}")
    return predict_tiled(
        predict, vol, in_size, out_size,
        overlap=overlap, weight=weight, pad_mode=pad_mode,
    )


def predict_image(
    predict: Predict,
    img: np.ndarray,
    in_size: int,
    out_size: int,
    overlap: int = 0,
    weight: str = "gaussian",
    pad_mode: str = "reflect",
) -> Tuple[np.ndarray, np.ndarray]:
    """2-D counterpart of :func:`predict_volume` — full-frame
    ``(probs, sigma)`` for ONE image of any spatial shape through the
    fixed-geometry 2-D model (``predict`` maps ``[N, T, T, C]`` tile
    batches to ``[N, O, O, K]`` moment pairs). ``img`` is ``[H, W]`` or
    ``[H, W, C]``; returns ``[H, W, K]`` maps."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3:
        raise ValueError(f"expected [H,W] or [H,W,C], got {img.shape}")
    return predict_tiled(
        predict, img, in_size, out_size,
        overlap=overlap, weight=weight, pad_mode=pad_mode,
    )


def predict_tiled(
    predict: Predict,
    arr: np.ndarray,
    in_size: int,
    out_size: int,
    overlap: int = 0,
    weight: str = "gaussian",
    pad_mode: str = "reflect",
    tiles_per_call: int = 32,
) -> Tuple[np.ndarray, np.ndarray]:
    """N-D tiling core shared by :func:`predict_image` (2-D) and
    :func:`predict_volume` (3-D): ``arr`` is ``spatial… + [C]`` with a
    channel axis already present; every spatial axis is tiled with the
    same (in_size, out_size, overlap).

    Tiles stream through ``predict`` in groups of ``tiles_per_call`` and
    blend immediately — peak host memory is one group of input tiles plus
    the accumulators, not the whole tile set (a 240^3 4-modality BraTS
    volume cuts into hundreds of cubes)."""
    import itertools

    t, o = int(in_size), int(out_size)
    if not 0 <= overlap < o:
        raise ValueError(f"overlap must be in [0, {o}), got {overlap}")
    stride = o - overlap
    lo, hi = output_margins(t, o)
    spatial = arr.shape[:-1]
    nd = len(spatial)
    # output coverage per axis: at least one full tile
    cover = tuple(max(s, o) for s in spatial)
    pads = [(lo, (cv - s) + hi) for s, cv in zip(spatial, cover)]
    padded = _pad(arr, pads + [(0, 0)], pad_mode)

    grids = [tile_positions(cv, o, stride) for cv in cover]
    corners = list(itertools.product(*grids))

    w1 = _axis_weights(o, weight)
    wnd = w1
    for _ in range(nd - 1):
        wnd = wnd[..., None] * w1
    wnd = wnd[..., None].astype(np.float32)  # [O]*nd + [1]
    acc_p = acc_s = acc_w = None
    step = max(1, int(tiles_per_call))
    for g in range(0, len(corners), step):
        group = corners[g : g + step]
        tiles = np.stack([
            padded[tuple(slice(p, p + t) for p in c) + (slice(None),)]
            for c in group
        ])
        probs_t, sigma_t = predict(tiles)
        if acc_p is None:
            k = probs_t.shape[-1]
            # f32 accumulators: window weights are >= 1e-6 and the blend
            # is renormalized below, so f32 precision is ample — and a
            # 240^3 4-class volume's accumulators drop from ~1 GB to
            # ~0.5 GB of host RAM (ADVICE r3)
            acc_p = np.zeros(cover + (k,), np.float32)
            acc_s = np.zeros(cover + (k,), np.float32)
            acc_w = np.zeros(cover + (1,), np.float32)
        for i, c in enumerate(group):
            sl = tuple(slice(p, p + o) for p in c)
            acc_p[sl] += wnd * probs_t[i].astype(np.float32)
            acc_s[sl] += wnd * sigma_t[i].astype(np.float32)
            acc_w[sl] += wnd
    probs = acc_p / acc_w
    sigma = acc_s / acc_w
    # convex combination of simplex points; renormalize the fp drift
    probs /= np.maximum(probs.sum(axis=-1, keepdims=True), 1e-12)
    crop = tuple(slice(0, s) for s in spatial)
    return probs[crop].astype(np.float32), sigma[crop].astype(np.float32)


def _pad(
    vol: np.ndarray, pads: Sequence[Tuple[int, int]], mode: str
) -> np.ndarray:
    if mode != "reflect":
        return np.pad(vol, pads, mode=mode)
    # np.pad reflect requires pad < axis size; fall back per-axis to edge
    out = vol
    for ax, (a, b) in enumerate(pads):
        if a == 0 and b == 0:
            continue
        p = [(0, 0)] * out.ndim
        p[ax] = (a, b)
        m = "reflect" if max(a, b) < out.shape[ax] else "edge"
        out = np.pad(out, p, mode=m)
    return out
