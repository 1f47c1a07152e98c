"""Frozen dataclass configs for the three reference datasets.

The port's own copy of ``supernet_tpu/configs/configs.py``, field for field
(``tests/test_torch_train.py`` holds the two equal), so the port imports
nothing of the JAX package. Defaults are lifted from the reference drivers:
- Hippocampus: `Hippocampus.py:425-428` (batch 20, epochs 120, lr 1e-4,
  kl_factor 1e-3, 3 classes, 64 -> 54, sigma_fill 0.02).
- BraTS: `Brats.py:462-480` (batch 20, epochs 100, lr 1e-3, kl_factor 1e-5,
  5 classes, 204 -> 186, sigma_fill 0.1, depth 5 with a [1,0] pre-pad on the
  bottleneck block, `Brats.py:407`).
- Lungs: scripts absent from the snapshot (`README.md:16-29`); per
  `README.md:18` it follows the same single-channel noise-sweep protocol, so
  it is a config of the generic pipeline (SURVEY.md §7.2 step 7).

Besides them, and outside ``__all__``: ``CICEK3D``, the 3D U-Net of Cicek
et al. under its own layer plan (``CicekConfig``, read by
``models/unet3d.py``), and ``SWINUNETR``, Swin UNETR under its plan
(``SwinUNETRConfig``, read by ``models/swin_unetr3d.py``): the port's
experiments with no JAX twin.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = [
    "AugmentConfig",
    "ModelConfig",
    "TrainConfig",
    "AttackConfig",
    "NoiseConfig",
    "ExperimentConfig",
    "HIPPOCAMPUS",
    "BRATS",
    "LUNGS",
    "get_config",
]


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the VDP U-Net (see supernet_tpu.models.unet)."""

    in_channels: int
    n_classes: int
    image_size: int
    out_size: int
    base_kernels: int = 32
    depth: int = 3  # number of encoder blocks
    sigma_fill: float = 0.02  # pseudo-variance for padded pixels
    # (lo, hi) pad applied before the bottleneck block's convs, or None.
    bottleneck_pre_pad: Optional[Tuple[int, int]] = None
    # how many leading decoder 2x2 convs (and the 1x1 head) use the tighter
    # sigma init range [-4.6, -2.2]  (Hippocampus.py:354-363, Brats.py:349-367)
    tight_upconvs: int = 2
    # rematerialize each encoder/decoder block under jax.checkpoint: trades
    # recompute FLOPs for HBM during backprop (for BraTS-scale training)
    remat: bool = False
    # weight init (Hippocampus.py:97-123)
    mean_mu: float = 0.0
    mean_sigma: float = 0.1
    sigma_min: float = -12.0
    sigma_max: float = -4.6
    tight_sigma_min: float = -4.6
    tight_sigma_max: float = -2.2


@dataclass(frozen=True)
class AugmentConfig:
    """On-device augmentation knobs (`data/augment.py`; net-new — the
    reference trains from a pre-augmented pickle, `Hippocampus.py:479`).

    Spatial ops apply identically to image and label; intensity ops apply
    to the image only. All probabilities are per image."""

    hflip: bool = True  # horizontal (W-axis) flip, p=0.5
    vflip: bool = True  # vertical (H-axis) flip, p=0.5
    dflip: bool = True  # volumetric only: scan (D-axis) flip, p=0.5
    rot90: bool = False  # uniform k in {0,1,2,3} quarter turns (square only)
    intensity_scale: float = 0.0  # multiplicative jitter: U[1-s, 1+s]
    intensity_shift: float = 0.0  # additive jitter: U[-d, d]
    noise_std: float = 0.0  # additive Gaussian pixel noise


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 20
    epochs: int = 120
    lr: float = 1e-4
    lr_end: float = 1e-4
    kl_factor: float = 1e-3
    clipnorm: float = 1.0  # per-tensor gradient clip (Keras clipnorm semantics)
    adam_eps: float = 1e-7  # Keras Adam default
    sigma_clip_min: float = 1e-12  # Hippocampus.py:524
    sigma_clip_max: float = 1e3
    seed: int = 0
    continue_training: bool = False
    saved_model_epochs: int = 50
    log_every: int = 20
    checkpoint_every: int = 1  # epochs
    # adversarial training (BASELINE.json configs[4]: "FGSM/PGD attack
    # training"): the reference's Adversarial_noise branch is eval-only
    # (`Hippocampus.py:839`) — this is the training half the blueprint
    # names. Objective: adv_alpha * L(clean) + (1 - adv_alpha) * L(adv),
    # adversarial examples generated INSIDE the jitted step with the
    # current (gradient-stopped) parameters.
    adversarial_training: str = "none"  # none | fgsm | pgd
    adv_alpha: float = 0.5  # clean-loss weight in the mixed objective
    adv_epsilon: float = 0.01  # L-inf ball radius
    adv_step_size: float = 0.005  # PGD step
    adv_steps: int = 5  # PGD iterations
    # on-device augmentation applied inside the jitted train step
    # (data/augment.py); None disables. Keyed by the step counter + the
    # image's GLOBAL batch index, so all data-parallel paths see identical
    # augmented batches.
    augment: "AugmentConfig | None" = None


@dataclass(frozen=True)
class AttackConfig:
    """FGSM/PGD evaluation (Hippocampus.py:533-547,894-1003)."""

    epsilon: float = 1e-4
    targeted: bool = True
    max_adv_step: int = 20
    step_size: float = 1.0
    adversary_targeted_class: int = 2  # class to be replaced in the label
    adv_class: int = 3  # replacement class
    sigma_clip_min: float = -1e4  # Hippocampus.py:539
    sigma_clip_max: float = 1e3


@dataclass(frozen=True)
class NoiseConfig:
    """Test-time corruption protocol (Hippocampus.py:1123-1307, C21/C25)."""

    kind: str = "none"  # none | gaussian | speckle | salt_and_pepper
    std: float = 0.0  # gaussian/speckle std; S&P flip probability
    region: str = "all"  # hippocampus: A|P|all ; brats: O|B|all
    sp_ratio: float = 0.5  # salt vs pepper ratio q (Brats_functions.py:565)


@dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: ModelConfig
    train: TrainConfig
    attack: AttackConfig = field(default_factory=AttackConfig)
    data_path: str = ""
    out_dir: str = "./runs"
    # test-time noise sweep (module-level driver, Hippocampus.py:1578-1601)
    noise_levels: Tuple[float, ...] = (0.05, 0.1)
    noise_regions: Tuple[str, ...] = ("A", "P", "all")

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


HIPPOCAMPUS = ExperimentConfig(
    name="hippocampus",
    model=ModelConfig(
        in_channels=1,
        n_classes=3,
        image_size=64,
        out_size=54,
        depth=3,
        sigma_fill=0.02,
    ),
    train=TrainConfig(epochs=120, lr=1e-4, kl_factor=1e-3),
    attack=AttackConfig(),
    data_path="./Segmentation_data/Task04_Hippocampus/train_test_augmented2.pkl",
    noise_levels=(0.05, 0.1),
    noise_regions=("A", "P", "all"),
)

BRATS = ExperimentConfig(
    name="brats",
    model=ModelConfig(
        in_channels=4,
        n_classes=5,
        image_size=204,
        out_size=186,
        depth=5,
        sigma_fill=0.1,
        bottleneck_pre_pad=(1, 0),
    ),
    train=TrainConfig(epochs=100, lr=1e-3, kl_factor=1e-5),
    attack=AttackConfig(targeted=False),
    data_path="./Segmentation_data/Data_all/batched_data",
    noise_levels=(0.005, 0.01),
    noise_regions=("O", "B", "all"),
)

# Lungs CT: single-modality protocol per README.md:18 — same pipeline as
# Hippocampus with CT-sized inputs (scripts absent from the snapshot).
LUNGS = ExperimentConfig(
    name="lungs",
    model=ModelConfig(
        in_channels=1,
        n_classes=2,
        image_size=128,
        out_size=118,
        depth=3,
        sigma_fill=0.02,
    ),
    train=TrainConfig(epochs=100, lr=1e-4, kl_factor=1e-3),
    attack=AttackConfig(targeted=False),
    data_path="./Segmentation_data/Lungs/lungs_data.pkl",
    noise_levels=(0.05, 0.1),
    noise_regions=("O", "B", "all"),
)


@dataclass(frozen=True)
class CicekConfig(ModelConfig):
    """A ``ModelConfig`` under the layer plan of the 3D U-Net of Cicek et
    al. (arXiv:1606.06650, Fig. 1), read by every function of
    ``models/unet3d.py`` and by ``train3d.derive_out_size3d``. At encoder
    level i the first conv keeps ``base * 2^i`` channels (takes
    ``in_channels`` at level 0) and the second doubles them; a 2x2x2 pool follows every level but the last.
    Decoder j: the up-conv (the fused unpool + 2^3 conv) keeps the channel
    count, the skip is centre-cropped and concatenated after the decoder's
    channels, and two convs take ``base * 2^(depth-j)`` channels. No decoder
    pads; the head is the 1x1x1 conv from ``2 * base`` channels. The fields
    are ``ModelConfig``'s (``bottleneck_pre_pad`` still applies where set)."""


# The port's own (not in ``__all__``, no JAX twin): the 3D U-Net of Cicek
# et al. as a VDP network, at its published widths and depth, with a 132^3
# tile (the paper's is 132x132x116: the family takes one side). The paper's
# network is deterministic, so the weight variances are an assumption:
# SUPER-Net's raw w_sigma ranges moved down by 6 (variances / 403). A VDP
# conv adds winsum(sum_c mu^2 + sigma) * softplus(w_sigma) to the variance,
# 27 * C_in * softplus(w_sigma) times its input's per layer: at these
# widths (C_in up to 768) SUPER-Net's ranges make that 30-2000x per decoder
# layer and every voxel's sigma 1e7-1e9 at the head, far above the loss's
# clip (1e3), where the ELBO's data term is a constant. Moved down, the
# factor stays under about 1 and the head's sigma near the loss's 1e-3.
# The train block is assumed too (the paper trained with SGD): BraTS's ELBO
# settings at batch 2.
CICEK3D = ExperimentConfig(
    name="cicek3d",
    model=CicekConfig(in_channels=3, n_classes=3, image_size=132, out_size=44,
                      base_kernels=32, depth=4, sigma_min=-18.0, sigma_max=-10.6,
                      tight_sigma_min=-10.6, tight_sigma_max=-8.2),
    train=TrainConfig(batch_size=2, epochs=100, lr=1e-3, kl_factor=1e-5),
)



@dataclass(frozen=True)
class SwinUNETRConfig(ModelConfig):
    """A ``ModelConfig`` under the layer plan of Swin UNETR
    (Hatamizadeh et al., arXiv:2201.01266; MONAI's ``SwinUNETR`` v1), read
    by ``models/swin_unetr3d.py``: a 2^3 stride-2 patch embedding to
    ``feature_size`` channels, ``len(depths)`` (four) stages of shifted-
    window transformer blocks with ``num_heads`` heads, ``window_size``^3
    windows and MLPs ``mlp_ratio`` times wide, patch merges doubling the
    channels, and a residual CNN decoder to ``n_classes`` at the input's
    side. ``base_kernels``, ``depth``, ``bottleneck_pre_pad``, ``mean_mu``
    and ``mean_sigma`` are unused; ``sigma_fill`` fills the variance of the
    SAME convs' pads. Lists given for ``depths`` and ``num_heads`` (a JSON
    file's) are kept as tuples."""

    feature_size: int = 48
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 2
    mlp_ratio: int = 4

    def __post_init__(self):
        object.__setattr__(self, "depths", tuple(self.depths))
        object.__setattr__(self, "num_heads", tuple(self.num_heads))
        if len(self.depths) != 4 or len(self.num_heads) != 4:
            raise ValueError("Swin UNETR has four stages: give four depths and four head counts")


# The port's own (not in ``__all__``, no JAX twin): Swin UNETR as a VDP
# network at the widths of MONAI's BraTS 2021 recipe (128^3 regions of 4
# MRI modalities, 3 output channels, feature size 48, batch 1 per GPU,
# lr 1e-4). The published network is deterministic, so the weight variances
# are assumed: Cicek3d's ranges (SUPER-Net's moved down by 6), under which
# the head's sigma stays below the loss's clip at these widths.
SWINUNETR = ExperimentConfig(
    name="swinunetr",
    model=SwinUNETRConfig(in_channels=4, n_classes=3, image_size=128, out_size=128,
                          sigma_fill=0.0, sigma_min=-18.0, sigma_max=-10.6,
                          tight_sigma_min=-10.6, tight_sigma_max=-8.2),
    train=TrainConfig(batch_size=1, epochs=100, lr=1e-4, kl_factor=1e-5),
)

_CONFIGS = {c.name: c for c in (HIPPOCAMPUS, BRATS, LUNGS, CICEK3D, SWINUNETR)}


def get_config(name: str) -> ExperimentConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(_CONFIGS)}"
        ) from None
