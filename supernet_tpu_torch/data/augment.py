"""On-device data augmentation, images and volumes: the counterpart of
``supernet_tpu/data/augment.py``.

Applied inside the train step on the parameters' device. The properties of
the JAX module are kept:

- **Per-image scalar draws, batched selects**: every image's choices (three
  spatial 2-bit draws, an intensity scale, an intensity shift) are scalars;
  they are applied to the whole batch with ``torch.where`` selects over
  ``flip`` / ``transpose`` views, never by branching on data.
- **Crop-commutation**: every spatial op (H/V flip, quarter turns of square
  frames) commutes with a symmetric center crop, so augmenting the
  full-frame image and the already-cropped label with the same draws keeps
  them geometrically consistent.
- **Device- and sharding-invariant randomness**: each image's scalars come
  from a CPU generator keyed by ``(seed, step, global image index)``, so a
  batch augments the same way on the CPU and on the card, whole or split
  into shards (``index_offset`` is the global index of the shard's first
  image). Only the optional Gaussian noise field is drawn on the tensor's
  own device, from a generator keyed by ``(seed, step, index_offset)``.

Volumes (``augment_volumes``) draw four spatial values each
(``volume_draws``): a quarter turn in the axial H-W plane and a flip of each
of the D, H and W axes, as ``supernet_tpu/data/augment.py:154-207`` does;
the intensity draws are the images'.

``torch`` streams differ from ``jax.random``: the two packages agree by
these invariants and by distribution, never value for value.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from supernet_tpu_torch.configs import AugmentConfig

Tensor = torch.Tensor

__all__ = [
    "AugmentConfig",
    "augment_batch",
    "augment_train_batch",
    "augment_volumes",
    "image_draws",
    "volume_draws",
]

_MASK63 = (1 << 63) - 1


def _mix(*words: int) -> int:
    """A 63-bit key from a tuple of integers (splitmix64 finalizer over a
    running sum), the port's ``fold_in``."""
    h = 0
    for w in words:
        h = (h + (int(w) & _MASK63) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & _MASK63


def _draws(key: int, n: int, index_offset: int, n_bits: int) -> Tuple[Tensor, Tensor]:
    bits = torch.empty((n, n_bits), dtype=torch.int64)
    u = torch.empty((n, 2), dtype=torch.float32)
    g = torch.Generator()
    for i in range(n):
        g.manual_seed(_mix(key, index_offset + i))
        bits[i] = torch.randint(0, 4, (n_bits,), generator=g)
        u[i] = torch.rand(2, generator=g)
    return bits, u


def image_draws(key: int, n: int, index_offset: int = 0) -> Tuple[Tensor, Tensor]:
    """The scalar draws of ``n`` images, on the CPU: ``bits`` int64 [n, 3]
    uniform in {0,1,2,3} (rotation count, vertical flip if < 2, horizontal
    flip if < 2) and ``u`` float32 [n, 2] uniform in [0, 1) (intensity
    scale, intensity shift). Image ``i`` is keyed by ``(key, index_offset +
    i)`` whatever the batch it arrives in."""
    return _draws(key, n, index_offset, 3)


def volume_draws(key: int, n: int, index_offset: int = 0) -> Tuple[Tensor, Tensor]:
    """The scalar draws of ``n`` volumes: ``bits`` int64 [n, 4] uniform in
    {0,1,2,3} (axial rotation count, D flip if < 2, H flip if < 2, W flip if
    < 2: the bit order of ``supernet_tpu/data/augment.py:_spatial_one_3d``)
    and ``u`` as :func:`image_draws`; keyed the same way."""
    return _draws(key, n, index_offset, 4)


def _per_image(v: Tensor, like: Tensor) -> Tensor:
    """[B] -> [B, 1, 1, ...] on ``like``'s device, broadcastable over it."""
    return v.to(like.device).reshape((-1,) + (1,) * (like.dim() - 1))


def _spatial(bits: Tensor, img: Tensor, cfg: AugmentConfig) -> Tensor:
    """Apply the spatial draws to a batch of [B, H, W, ...] frames."""
    if cfg.rot90:
        if img.shape[1] != img.shape[2]:
            raise ValueError(
                f"rot90 augmentation needs square frames, got {tuple(img.shape)}"
            )
        rk = _per_image(bits[:, 0], img)
        # np.rot90(m, 1) = rev0(T), rot180 = rev0(rev1(m)), rot270 = rev1(T)
        base = torch.where(rk % 2 == 1, img.transpose(1, 2), img)
        base = torch.where((rk == 1) | (rk == 2), base.flip(1), base)
        img = torch.where((rk == 2) | (rk == 3), base.flip(2), base)
    if cfg.vflip:
        img = torch.where(_per_image(bits[:, 1], img) < 2, img.flip(1), img)
    if cfg.hflip:
        img = torch.where(_per_image(bits[:, 2], img) < 2, img.flip(2), img)
    return img


def _spatial3d(bits: Tensor, vol: Tensor, cfg: AugmentConfig) -> Tensor:
    """Apply the spatial draws to a batch of [B, D, H, W, ...] volumes: a
    quarter turn in the axial H-W plane (the D axis is the scan direction),
    then the D (``dflip``), H (``vflip``) and W (``hflip``) flips."""
    if cfg.rot90:
        if vol.shape[2] != vol.shape[3]:
            raise ValueError(f"axial rot90 needs square H/W, got {tuple(vol.shape)}")
        rk = _per_image(bits[:, 0], vol)
        base = torch.where(rk % 2 == 1, vol.transpose(2, 3), vol)
        base = torch.where((rk == 1) | (rk == 2), base.flip(2), base)
        vol = torch.where((rk == 2) | (rk == 3), base.flip(3), base)
    for on, col, axis in ((cfg.dflip, 1, 1), (cfg.vflip, 2, 2), (cfg.hflip, 3, 3)):
        if on:
            vol = torch.where(_per_image(bits[:, col], vol) < 2, vol.flip(axis), vol)
    return vol


def _intensity(
    u: Tensor, img: Tensor, cfg: AugmentConfig, noise_key: int
) -> Tensor:
    if cfg.intensity_scale > 0.0:
        s = (1.0 - cfg.intensity_scale) + (2.0 * cfg.intensity_scale) * u[:, 0]
        img = img * _per_image(s.to(img.dtype), img)
    if cfg.intensity_shift > 0.0:
        d = (2.0 * cfg.intensity_shift) * u[:, 1] - cfg.intensity_shift
        img = img + _per_image(d.to(img.dtype), img)
    if cfg.noise_std > 0.0:
        g = torch.Generator(device=img.device)
        g.manual_seed(noise_key)
        img = img + cfg.noise_std * torch.randn(
            img.shape, generator=g, dtype=img.dtype, device=img.device
        )
    return img


def augment_batch(
    key: int,
    x: Tensor,
    y: Optional[Tensor],
    cfg: AugmentConfig,
    index_offset: int = 0,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Augment a batch: ``x`` [B, H, W, C] float; ``y`` either int labels
    [B, h, w], one-hot [B, h, w, C'], or None. The spatial draws are shared
    between x and y per image; intensity and noise touch x only.
    ``index_offset`` is the global index of the batch's first image when the
    batch is a shard of a larger one."""
    bits, u = image_draws(key, x.shape[0], index_offset)
    x_out = _intensity(
        u, _spatial(bits, x, cfg), cfg, _mix(key, index_offset, 0x6E6F697365)
    )
    # a select over transposed views may come out in their strides; the
    # kernels take contiguous tensors
    x_out = x_out.contiguous()
    if y is None:
        return x_out, None
    return x_out, _spatial(bits, y, cfg).contiguous()


def augment_train_batch(
    step: int,
    x: Tensor,
    y: Tensor,
    out_size: int,
    cfg: AugmentConfig,
    seed: int,
    index_offset: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Train-step entry: the key is derived from the seed and the step
    counter, and the label is given back in the form it arrived in (int map
    [B, h, w] or flattened one-hot [B, h*w, C])."""
    key = _mix(seed, step)
    flat = not (y.dim() == 3 and tuple(y.shape[1:]) == (out_size, out_size))
    y_sp = y.reshape(y.shape[0], out_size, out_size, -1) if flat else y
    x_out, y_out = augment_batch(key, x, y_sp, cfg, index_offset)
    if flat:
        y_out = y_out.reshape(y.shape)
    return x_out, y_out


def augment_volumes(
    key: int,
    x: Tensor,
    y: Optional[Tensor],
    cfg: AugmentConfig,
    index_offset: int = 0,
) -> Tuple[Tensor, Optional[Tensor]]:
    """The volumetric ``augment_batch``: ``x`` [B, D, H, W, C] float, ``y``
    int label cubes [B, d, h, w] or None. The spatial draws are shared per
    volume between image and label (every one commutes with the symmetric
    center crop, so the full-size image and the cropped label stay aligned);
    intensity and noise touch the image only."""
    bits, u = volume_draws(key, x.shape[0], index_offset)
    x_out = _intensity(
        u, _spatial3d(bits, x, cfg), cfg, _mix(key, index_offset, 0x6E6F697365)
    ).contiguous()
    if y is None:
        return x_out, None
    return x_out, _spatial3d(bits, y, cfg).contiguous()
