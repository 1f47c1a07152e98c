"""Analytic FLOP and byte counts of the VDP U-Nets: the port's copy of the
2-D and 3-D counts of ``supernet_tpu/flops.py`` (``:92-334``).

The counts follow the moment primitives, per output pixel (1 MAC = 2 FLOPs):
``conv_input`` ``2 k^2 Cin Cout`` + the window sum ``2 k^2``; an
intermediate conv (the 1x1 head too) ``4 k^2 Cin Cout + 2 k^2``; the fused
unpool + 2x2 conv ``4 Cin Cout``. Elementwise work is not counted. A train
step is 3x the forward (remat's recomputation not charged). Bytes: the
minimum traffic, every conv's input pair read once and its output pair
written once. The volumetric counts are the same one rank up (k^2 -> k^3,
HW -> DHW). The geometry comes from ``models.layer_names`` and the stage
taps of one forward (``profiling.stage_shapes``; in 3-D
``models.unet3d.stage_shapes3d``, a forward on the ``meta`` device);
nothing here imports JAX.

The card's peaks (``peak_tflops``, ``peak_hbm_gbps``; ``supernet_tpu/flops.py:35-90``)
are NVIDIA's published dense rates, looked up by a substring of
``torch.cuda.get_device_name``: the bf16 tensor-core peak, as the JAX
package's table holds each TPU's bf16 peak, so that ``mfu`` reads the same
convention on both. An unknown card or a CPU device reads 0.0, and ``mfu``
and ``hbm_utilization`` then read 0.0: unavailable, never wrong. The
variables ``SUPERNET_TPU_PEAK_TFLOPS`` and ``SUPERNET_TPU_PEAK_HBM_GBPS``
override the tables, under the JAX package's names.
"""

from __future__ import annotations

import os
from typing import Dict

from supernet_tpu_torch.configs import ModelConfig

# bf16 dense (no sparsity) TFLOP/s per card, keyed by a substring of the
# device name lower-cased without spaces; the first match wins, so the
# longer names come first. Each rate is half the datasheet's sparse figure.
_PEAK_BF16_TFLOPS = (
    ("h200nvl", 835.5),  # NVIDIA H200 datasheet, H200 NVL: 1,671 sparse
    ("h200", 989.0),  # NVIDIA H200 datasheet, H200 SXM: 1,979 sparse
    ("h100nvl", 835.5),  # NVIDIA H100 datasheet, H100 NVL: 1,671 sparse
    ("h100pcie", 756.5),  # NVIDIA H100 datasheet, H100 PCIe: 1,513 sparse
    ("h10080gbhbm3", 989.0),  # NVIDIA H100 datasheet, H100 SXM: 1,979 sparse
    ("h100sxm", 989.0),  # the same part under its other name
)

# peak HBM GB/s per card (the same datasheets).
_PEAK_HBM_GBPS = (
    ("h200nvl", 4800.0),  # NVIDIA H200 datasheet, H200 NVL: 4.8 TB/s
    ("h200", 4800.0),  # NVIDIA H200 datasheet, H200 SXM: 4.8 TB/s
    ("h100nvl", 3900.0),  # NVIDIA H100 datasheet, H100 NVL: 3.9 TB/s
    ("h100pcie", 2000.0),  # NVIDIA H100 datasheet, H100 PCIe: 2 TB/s
    ("h10080gbhbm3", 3350.0),  # NVIDIA H100 datasheet, H100 SXM: 3.35 TB/s
    ("h100sxm", 3350.0),
)


def _device_kind(device) -> str:
    """The device's name, lower-cased without spaces; '' for a CPU device
    and, with ``device=None``, when no card is visible."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return ""
        device = torch.cuda.current_device()
    if isinstance(device, int):  # a card's index
        device = torch.device("cuda", device)
    if torch.device(device).type != "cuda":
        return ""
    return torch.cuda.get_device_name(device).lower().replace(" ", "")


def _lookup(table, env: str, device) -> float:
    v = os.environ.get(env)
    if v:
        return float(v)
    kind = _device_kind(device)
    for key, rate in table:
        if key in kind:
            return rate
    return 0.0


def peak_tflops(device=None) -> float:
    """bf16 dense peak TFLOP/s of ``device`` (default: the current card);
    0.0 when unknown or on the CPU, so MFU reads as unavailable, never
    wrong. Override with SUPERNET_TPU_PEAK_TFLOPS."""
    return _lookup(_PEAK_BF16_TFLOPS, "SUPERNET_TPU_PEAK_TFLOPS", device)


def peak_hbm_gbps(device=None) -> float:
    """Peak HBM GB/s of ``device`` (default: the current card); 0.0 when
    unknown or on the CPU. Override with SUPERNET_TPU_PEAK_HBM_GBPS."""
    return _lookup(_PEAK_HBM_GBPS, "SUPERNET_TPU_PEAK_HBM_GBPS", device)


def mfu(flops_per_second: float, device=None) -> float:
    """Model FLOP utilization against the card's bf16 peak; 0.0 if the peak
    is unknown."""
    peak = peak_tflops(device)
    if peak <= 0:
        return 0.0
    return flops_per_second / (peak * 1e12)


def hbm_utilization(bytes_per_second: float, device=None) -> float:
    """Achieved HBM bandwidth against the card's peak; 0.0 if the peak is
    unknown."""
    peak = peak_hbm_gbps(device)
    if peak <= 0:
        return 0.0
    return bytes_per_second / (peak * 1e9)


def _conv_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """``{conv layer: output side}`` at batch 1."""
    from supernet_tpu_torch.models import layer_names
    from supernet_tpu_torch.profiling import stage_shapes

    convs = {name for name, *_ in layer_names(cfg)}
    return {name: shape[1] for name, shape in stage_shapes(cfg) if name in convs}


def forward_flops_per_layer(cfg: ModelConfig) -> Dict[str, float]:
    """FLOPs of one forward pass per conv layer, batch size 1."""
    from supernet_tpu_torch.models import layer_names

    sizes = _conv_sizes(cfg)
    out: Dict[str, float] = {}
    for name, k, cin, cout in layer_names(cfg):
        hw = sizes[name] ** 2
        if name == "conv_input":
            f = hw * (2 * k * k * cin * cout + 2 * k * k)
        elif name.endswith("_conv2x2"):
            f = hw * (4 * cin * cout)
        else:  # intermediate vconv (3x3 and the 1x1 head)
            f = hw * (4 * k * k * cin * cout + 2 * k * k)
        out[name] = float(f)
    return out


def forward_flops(cfg: ModelConfig, batch: int = 1) -> float:
    """FLOPs of one forward pass at ``batch``."""
    return batch * sum(forward_flops_per_layer(cfg).values())


def train_step_flops(cfg: ModelConfig, batch: int) -> float:
    """One optimizer step: forward + backward ~= 3x forward."""
    return 3.0 * forward_flops(cfg, batch)


def param_bytes(cfg: ModelConfig, dtype_bytes: int = 4) -> float:
    """Parameter bytes (w_mu + w_sigma of every layer)."""
    from supernet_tpu_torch.models import layer_names

    n = sum(k * k * cin * cout + cout for _, k, cin, cout in layer_names(cfg))
    return float(n * dtype_bytes)


def forward_act_bytes(cfg: ModelConfig, batch: int = 1, act_bytes: int = 2) -> float:
    """Minimum forward activation traffic at ``act_bytes`` per element (2
    under bf16): one read of every conv's input pair (the image alone for
    ``conv_input``; the pre-unpool tensor for the fused unpool conv) and one
    write of its output pair."""
    from supernet_tpu_torch.models import layer_names

    sizes = _conv_sizes(cfg)
    total = 0
    for name, k, cin, cout in layer_names(cfg):
        h_out = sizes[name]
        h_in = h_out // 2 if name.endswith("_conv2x2") else h_out + k - 1
        total += h_in * h_in * cin * (1 if name == "conv_input" else 2)
        total += h_out * h_out * cout * 2
    return float(total) * batch * act_bytes


def train_step_min_bytes(cfg: ModelConfig, batch: int, act_bytes: int = 2) -> float:
    """Traffic of one train step when every residual is stored: 3x the
    forward's activation bytes plus 9x the float32 parameter bytes (read in
    the forward and backward, gradients written and read, Adam's two moments
    read and written, parameters written)."""
    return 3.0 * forward_act_bytes(cfg, batch, act_bytes) + 9.0 * param_bytes(cfg)


def _conv_shapes3d(cfg: ModelConfig) -> Dict[str, int]:
    """``{3-D conv layer: output side}`` (the cubes stay cubic)."""
    from supernet_tpu_torch.models.unet3d import layer_names3d, stage_shapes3d

    convs = {name for name, *_ in layer_names3d(cfg)}
    return {name: shape[1] for name, shape in stage_shapes3d(cfg) if name in convs}


# elementwise operations per attention score: the bias, the mask, the
# variance's sum, the softmax (exp, sum, divide) and its moment (six)
SWIN_SCORE_OPS = 12


def _forward_flops_swin(cfg) -> float:
    """One volume's forward under the Swin UNETR plan: every layer with
    weights by the counting below (a linear is k = 1, on the real tokens),
    and per Swin block, window (padded ones included) and head, the six
    products of ``2 n^2 d`` and ``SWIN_SCORE_OPS`` per score."""
    from supernet_tpu_torch.models.swin_unetr3d import layer_names_swin

    s = cfg.image_size
    st = [-(-(s // cfg.patch_size) // 2 ** i) for i in range(len(cfg.depths) + 1)]
    side_of = {"patch": st[0], "encoder1": s, "encoder2": st[0], "encoder3": st[1],
               "encoder4": st[2], "encoder10": st[4], "decoder5": st[3], "decoder4": st[2],
               "decoder3": st[1], "decoder2": st[0], "decoder1": s, "out": s}
    total = 0.0
    for name, k, cin, cout in layer_names_swin(cfg):
        head = name.split("_")[0]
        if head.startswith("stage"):
            i = int(head[len("stage"):])
            side = st[i + 1] if name.endswith("_merge") else st[i]
        else:
            side = side_of[head]
        k3 = k ** 3
        if name in ("patch_embed", "encoder1_conv1", "encoder1_conv3"):
            per = 2 * k3 * cin * cout + 2 * k3
        elif name.endswith("_up"):
            per = 4 * cin * cout
        else:
            per = 4 * k3 * cin * cout + 2 * k3
        total += float(side ** 3 * per)
    for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        ws = min(st[i], cfg.window_size)
        n, d = ws ** 3, cfg.feature_size * 2 ** i // heads
        n_win = (-(-st[i] // ws)) ** 3
        total += float(depth * n_win * heads * (12 * n * n * d + SWIN_SCORE_OPS * n * n))
    return total


def forward_flops3d(cfg: ModelConfig, batch: int = 1) -> float:
    """FLOPs of one volumetric forward at ``batch``: the 2-D counting one
    rank up; the fused unpool conv sees one nonzero tap per output voxel, so
    it costs ``4 Cin Cout`` per voxel in either rank. The Swin UNETR plan
    is counted by ``_forward_flops_swin``."""
    from supernet_tpu_torch.models.unet3d import is_swin, layer_names3d

    if is_swin(cfg):
        return batch * _forward_flops_swin(cfg)

    sizes = _conv_shapes3d(cfg)
    total = 0.0
    for name, k, cin, cout in layer_names3d(cfg):
        dhw = sizes[name] ** 3
        k3 = k ** 3
        if name == "conv_input":
            f = dhw * (2 * k3 * cin * cout + 2 * k3)
        elif name.endswith("_conv2x2"):
            f = dhw * (4 * cin * cout)
        else:
            f = dhw * (4 * k3 * cin * cout + 2 * k3)
        total += float(f)
    return batch * total


def train_step_flops3d(cfg: ModelConfig, batch: int) -> float:
    """One volumetric optimizer step: ~3x the forward."""
    return 3.0 * forward_flops3d(cfg, batch)


def forward_act_bytes3d(cfg: ModelConfig, batch: int = 1, act_bytes: int = 2) -> float:
    """Minimum volumetric forward activation traffic (``forward_act_bytes``
    one rank up): the fused unpool conv reads the pre-unpool cube of side
    D_out / 2."""
    from supernet_tpu_torch.models.unet3d import layer_names3d

    sizes = _conv_shapes3d(cfg)
    total = 0
    for name, k, cin, cout in layer_names3d(cfg):
        d_out = sizes[name]
        d_in = d_out // 2 if name.endswith("_conv2x2") else d_out + k - 1
        total += d_in ** 3 * cin * (1 if name == "conv_input" else 2)
        total += d_out ** 3 * cout * 2
    return float(total) * batch * act_bytes


def train_step_min_bytes3d(cfg: ModelConfig, batch: int, act_bytes: int = 2) -> float:
    """``train_step_min_bytes`` for the volumetric family: 3x the forward's
    activation bytes plus 9x the float32 parameter bytes."""
    from supernet_tpu_torch.models.unet3d import layer_names3d

    p_bytes = 4.0 * sum(k ** 3 * cin * cout + cout
                        for _, k, cin, cout in layer_names3d(cfg))
    return 3.0 * forward_act_bytes3d(cfg, batch, act_bytes) + 9.0 * p_bytes
