"""Test-time corruption: gaussian / speckle / salt-and-pepper noise with
region-selective application and SNR accounting. The counterpart of
``supernet_tpu/perturb.py``.

Reference: the noise branches of ``testing`` (`Hippocampus.py:1272-1307`,
`Brats.py:1248-1276`) and ``salt_and_pepper`` (`Brats_functions.py:565-582`).

Semantics preserved:
- gaussian: ``x + N(0, std)``; speckle: ``x + x * N(0, std)``;
  salt&pepper: additive: with flip prob ``p``, salt (ratio ``q``) pixels
  get +1 (saturating at the batch max after the clip), pepper +low_clip
  (0 for non-negative data, i.e. unchanged; -1 for signed).
- region masks are built from the *label*: Hippocampus ``'A'`` = anterior
  only (label == 1), ``'P'`` = posterior only (label == 2)
  (`Hippocampus.py:1278-1299`); BraTS ``'O'`` = object/tumor (label > 0),
  ``'B'`` = background (label == 0) (`Brats.py:1257-1276`); anything else =
  everywhere.
- after adding noise the image is clipped to the [min, max] of the
  CENTER-CROPPED clean batch (``max_val = np.amax(x1)`` where ``x1`` is the
  crop to the model's output size, `Hippocampus.py:1270-1271,1298`): pass
  ``crop_size`` to ``apply_noise`` for this.
- SNR per batch on the CROPPED frames:
  ``10 * log10(sum(x1^2) / sum((x_crop - x1)^2))``
  (`Hippocampus.py:1302-1307`).

The draw is kept apart from the arithmetic. A draw comes from a
``torch.Generator`` on the generator's own device and is then moved to the
image's: with the CPU generator of :func:`noise_generator` a batch gets the
same noise on the CPU and on the card. Everything after the draw
(:func:`salt_and_pepper_values`, :func:`apply_delta`, :func:`snr_db`) is a
function of its inputs alone. ``torch`` streams differ from ``jax.random``:
the two packages agree on that arithmetic value for value, and on the draws
by distribution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from supernet_tpu_torch.configs import NoiseConfig
from supernet_tpu_torch.data.augment import _mix
from supernet_tpu_torch.ops.moments import crop_center
from supernet_tpu_torch.ops.moments3d import crop_center3d

Tensor = torch.Tensor


def noise_generator(seed: int, batch_index: int) -> torch.Generator:
    """A CPU generator keyed by ``(seed, batch_index)``: a batch's noise
    does not depend on the device it is evaluated on or on how many batches
    came before it."""
    return torch.Generator().manual_seed(_mix(seed, batch_index, 0x6E6F697365))


def region_mask(y: Tensor, region: str, dataset: str) -> Optional[Tensor]:
    """0/1 mask [B, H, W] ([B, D, H, W] for volumes) of pixels that receive
    noise, or None for 'all'.

    ``y`` is the integer label map [B, H, W] or [B, D, H, W]; labels are anatomical classes
    (Hippocampus: 0 bg, 1 anterior, 2 posterior; BraTS: 0 bg, >0 tumor).
    """
    if dataset == "hippocampus":
        if region == "A":
            return (y == 1).to(torch.float32)
        if region == "P":
            return (y == 2).to(torch.float32)
        return None
    # brats / lungs follow the object/background convention (Brats.py:1257)
    if region == "O":
        return (y > 0).to(torch.float32)
    if region == "B":
        return (y == 0).to(torch.float32)
    return None


def _randn(generator: torch.Generator, x: Tensor) -> Tensor:
    return torch.randn(
        x.shape, generator=generator, dtype=x.dtype, device=generator.device
    ).to(x.device)


def _rand(generator: torch.Generator, x: Tensor) -> Tensor:
    return torch.rand(
        x.shape, generator=generator, dtype=torch.float32, device=generator.device
    ).to(x.device)


def gaussian_noise(generator: torch.Generator, x: Tensor, std: float) -> Tensor:
    return std * _randn(generator, x)


def speckle_noise(generator: torch.Generator, x: Tensor, std: float) -> Tensor:
    return x * (std * _randn(generator, x))


def salt_and_pepper_values(flipped: Tensor, salted: Tensor, x: Tensor) -> Tensor:
    """The additive S&P array for given boolean draws: flipped&salted pixels
    get +1, flipped&peppered +low_clip (0 where ``x`` is non-negative, -1
    where it has a negative value), everything else +0."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    low_clip = torch.where(x.min() < 0, -one, 0.0 * one)
    out = torch.where(salted, one, low_clip)
    return torch.where(flipped, out, torch.zeros_like(x))


def salt_and_pepper(
    generator: torch.Generator, x: Tensor, p: float, q: float = 0.5
) -> Tensor:
    """Additive S&P array per `Brats_functions.py:565-582`, flip
    probability ``p`` and salt ratio ``q``. The reference then ADDS this to
    x and clips to the clean batch's [min, max] (`Brats.py:1255-1275`), so
    salted pixels saturate at the batch max and peppered pixels are
    unchanged on non-negative data; ``apply_delta`` applies that clip for
    every kind."""
    flipped = _rand(generator, x) < p
    salted = _rand(generator, x) < q
    return salt_and_pepper_values(flipped, salted, x)


def noise_delta(generator: torch.Generator, x: Tensor, nc: NoiseConfig) -> Tensor:
    """The unmasked additive noise of kind ``nc.kind`` for ``x``."""
    if nc.kind == "gaussian":
        return gaussian_noise(generator, x, nc.std)
    if nc.kind == "speckle":
        return speckle_noise(generator, x, nc.std)
    if nc.kind == "salt_and_pepper":
        return salt_and_pepper(generator, x, nc.std, nc.sp_ratio)
    raise ValueError(f"unknown noise kind {nc.kind!r}")


def apply_delta(
    x: Tensor,
    y: Tensor,
    delta: Tensor,
    nc: NoiseConfig,
    dataset: str = "hippocampus",
    crop_size: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Everything of the protocol after the draw: mask ``delta`` by the
    region of ``nc``, add it, clip, account the SNR. Returns
    ``(noisy_x, snr_db)``; see :func:`apply_noise`. Images [B, H, W, C] and
    volumes [B, D, H, W, C] alike: every rule is voxel-wise, and a volume's
    crop takes all three spatial axes."""
    mask = region_mask(y, nc.region, dataset)
    if mask is not None:
        delta = delta * mask[..., None]
    cropped = bool(crop_size) and crop_size != x.shape[1]

    def crop(a: Tensor) -> Tensor:
        if not cropped:
            return a
        if a.dim() == 5:
            return crop_center3d(a, crop_size, crop_size, crop_size)
        return crop_center(a, crop_size, crop_size)

    x_ref = crop(x)
    # every kind, S&P too, is clipped to the CROP frame's range
    # (Hippocampus.py:1270-1271,1298; Brats.py:1264/1271/1275 clip in all
    # branches). Salt&pepper's low_clip, by contrast, keys off the FULL
    # frame: the reference calls salt_and_pepper on the uncropped batch
    # (Brats.py:1253), so its sign test sees the full-frame min.
    noisy = torch.clamp(x + delta, x_ref.min(), x_ref.max())
    return noisy, snr_db(x_ref, crop(noisy))


def apply_noise(
    generator: torch.Generator,
    x: Tensor,
    y: Tensor,
    nc: NoiseConfig,
    dataset: str = "hippocampus",
    crop_size: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Corrupt ``x`` per the protocol; returns (noisy_x, snr_db).

    ``x``: [B, H, W, C] full-frame images (or [B, D, H, W, C] volumes);
    ``y``: [B, H, W] ([B, D, H, W]) integer labels of the same spatial size (the reference builds the region mask from the
    FULL-frame label, `Hippocampus.py:1279-1292`).

    ``crop_size`` > 0 reproduces the reference's cropped-frame semantics:
    the clip range is the min/max of the CENTER-CROPPED clean batch
    (`Hippocampus.py:1270-1271,1298`) and the SNR compares the CROPPED clean
    and noisy frames (`Hippocampus.py:1302-1307`). With ``crop_size=0`` both
    use the full frame.
    """
    if nc.kind == "none" or nc.std == 0.0:
        return x, torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    return apply_delta(x, y, noise_delta(generator, x, nc), nc, dataset, crop_size)


def snr_db(x: Tensor, noisy: Tensor) -> Tensor:
    """``10 log10(sum x^2 / sum (x - noisy)^2)`` (`Hippocampus.py:1302-1307`)."""
    num = torch.sum(torch.square(x))
    den = torch.sum(torch.square(x - noisy))
    return 10.0 * torch.log10(num / torch.clamp_min(den, 1e-30))
