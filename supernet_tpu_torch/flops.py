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
nothing here imports JAX. The peak tables, ``mfu`` and ``hbm_utilization``
come with the port's benchmark (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Dict

from supernet_tpu_torch.configs import ModelConfig


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


def forward_flops3d(cfg: ModelConfig, batch: int = 1) -> float:
    """FLOPs of one volumetric forward at ``batch``: the 2-D counting one
    rank up; the fused unpool conv sees one nonzero tap per output voxel, so
    it costs ``4 Cin Cout`` per voxel in either rank."""
    from supernet_tpu_torch.models.unet3d import layer_names3d

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
