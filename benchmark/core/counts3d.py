"""Analytic operation and byte counts of the 3D U-Net of Cicek et al. as a
VDP network (``configs/cicek3d.json``): ``core/counts.py``'s conventions one
rank up, with the geometry worked out here from the configuration's
``model`` block (``supernet_tpu_torch/flops.py:forward_flops3d`` counts the
same on the port's own layer plan).

Per output voxel (1 multiply-add = 2 operations): ``conv_input``
``2 k^3 Cin Cout`` plus the window sum ``2 k^3``; every other k^3 conv, the
1x1x1 head too, ``4 k^3 Cin Cout + 2 k^3`` (the mean product, the variance
product and the window sum); the fused unpool + 2^3 conv ``4 Cin Cout`` (one
nonzero tap per output voxel). Bytes: each conv's input pair read once (the
volume alone for ``conv_input``, the pre-unpool tensor for the unpool conv)
and its output pair written once.

A training step's convolution work is the forward, the input gradients
(every conv but ``conv_input``) and the filter gradients: 3x the forward,
2x at ``conv_input``; its bytes add the output-gradient pair read once and
the input-gradient pair written once. ``train_step_flops`` is the ``mfu``
convention, 3x the forward.

The layer plan: at encoder level i two VALID 3^3 convs, the first keeping
``base * 2^i`` channels (``in_channels`` into level 0), the second doubling
them, a 2x2x2 pool (odd sides padded at the high end) after every level
but the last; decoder j an up-conv that keeps the channels (side 2s), the
skip concatenated, two VALID 3^3 convs to ``base * 2^(depth-j)``; the 1x1x1
head. No pads.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def layers(model: dict) -> List[Tuple[str, int, int, int, int, int]]:
    """``(name, k, c_in, c_out, side_in, side_out)`` of every conv of one
    forward, in order."""
    b, depth = model["base_kernels"], model["depth"]
    s, c_prev = model["image_size"], model["in_channels"]
    out = []
    for i in range(depth):
        c = b * 2 ** i
        if i > 0:
            s = -(-s // 2)
        out.append(("conv_input" if i == 0 else f"conv{2 * i}", 3, c_prev, c, s, s - 2))
        out.append((f"conv{2 * i + 1}", 3, c, 2 * c, s - 2, s - 4))
        s, c_prev = s - 4, 2 * c
    for j in range(1, depth):
        c = b * 2 ** (depth - j)
        out.append((f"up{j}_conv2x2", 2, c_prev, c_prev, s, 2 * s))
        s = 2 * s
        out.append((f"up{j}_conv1", 3, c_prev + c, c, s, s - 2))
        out.append((f"up{j}_conv2", 3, c, c, s - 2, s - 4))
        s, c_prev = s - 4, c
    out.append(("conv_final", 1, c_prev, model["n_classes"], s, s))
    return out


def forward_flops_per_layer(model: dict) -> Dict[str, float]:
    """Operations of one forward per conv, one volume."""
    out = {}
    for name, k, cin, cout, _, so in layers(model):
        dhw, k3 = so ** 3, k ** 3
        if name == "conv_input":
            f = dhw * (2 * k3 * cin * cout + 2 * k3)
        elif name.endswith("_conv2x2"):
            f = dhw * 4 * cin * cout
        else:
            f = dhw * (4 * k3 * cin * cout + 2 * k3)
        out[name] = float(f)
    return out


def forward_flops(model: dict) -> float:
    """Operations of one forward, one volume."""
    return sum(forward_flops_per_layer(model).values())


def train_flops_per_layer(model: dict) -> Dict[str, float]:
    """Operations of one training step's convolution work per conv, one
    volume: 3x the forward, 2x at ``conv_input``."""
    return {n: f * (2.0 if n == "conv_input" else 3.0)
            for n, f in forward_flops_per_layer(model).items()}


def train_step_flops(model: dict, batch: int) -> float:
    """Operations of one training step, the convention of ``mfu``: 3x the
    forward per trained volume."""
    return 3.0 * forward_flops(model) * batch


def train_conv_bound_s(model: dict, ops_per_s: float, bytes_per_s: float,
                       act_bytes: int = 4) -> float:
    """Least time of one volume's convolution work in a training step
    (forward, input and filter gradients): per conv the larger of its
    operations over the peak and its bytes over the bandwidth."""
    flops = train_flops_per_layer(model)
    total = 0.0
    for name, _, cin, cout, si, so in layers(model):
        reads = si ** 3 * cin * (1 if name == "conv_input" else 2)
        writes = so ** 3 * cout * 2
        grads = 0 if name == "conv_input" else si ** 3 * cin * 2
        nbytes = (reads + 2 * writes + grads) * act_bytes
        total += max(flops[name] / ops_per_s, nbytes / bytes_per_s)
    return total
