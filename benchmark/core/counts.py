"""Analytic operation and byte counts of the VDP U-Net's convolutions, and
the card's peaks: a frozen copy of ``supernet_tpu_torch/flops.py``'s layer
counts, with the geometry worked out here from the configuration file.

Per output pixel (1 multiply-add = 2 operations): ``conv_input``
``2 k^2 Cin Cout`` plus the window sum ``2 k^2``; every other k x k conv,
the 1x1 head too, ``4 k^2 Cin Cout + 2 k^2`` (the mean product, the
variance product and the window sum); the fused unpool + 2x2 conv
``4 Cin Cout`` (one nonzero tap per output pixel). Bytes: each conv's input
pair read once (the image alone for ``conv_input``, the pre-unpool tensor
for the unpool conv) and its output pair written once.

A training step's convolution work is the forward, the input gradients
(every conv but ``conv_input``, whose input needs none) and the filter
gradients: two forwards' operations for each backward, the convention of
``flops.train_step_flops`` (3x the forward) except at ``conv_input`` (2x).
Its bytes add the output-gradient pair read once and the input-gradient
pair written once.

Peaks are NVIDIA's published dense rates (data sheets, SXM / PCIe / NVL
parts), matched on ``torch.cuda.get_device_name`` lower-cased without
spaces, by the precision of the operands: float32 operands are held to the
dense TF32 rate, the fastest at which any float32-input product runs on the
card, so no share of it can pass 100%.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# (substring of the device name, dense TF32 TFLOP/s, dense bf16 TFLOP/s,
# HBM GB/s); the first match wins, so the longer names come first
_PEAKS = (
    ("h100nvl", 417.5, 835.5, 3900.0),
    ("h100pcie", 378.0, 756.5, 2000.0),
    ("h10080gbhbm3", 495.0, 989.0, 3350.0),
    ("h100sxm", 495.0, 989.0, 3350.0),
)


def peaks(device_name: str, precision: str) -> Optional[Tuple[float, float]]:
    """``(operations/s, bytes/s)`` of the card named ``device_name`` for
    operands of ``precision`` ("float32" or "bfloat16"); None for a card
    the table does not hold."""
    kind = device_name.lower().replace(" ", "")
    for key, tf32, bf16, hbm in _PEAKS:
        if key in kind:
            flops = tf32 if precision == "float32" else bf16
            return flops * 1e12, hbm * 1e9
    return None


def layers(model: dict) -> List[Tuple[str, int, int, int, int, int]]:
    """``(name, k, c_in, c_out, side_in, side_out)`` of every conv of one
    forward, in order, from the configuration's ``model`` block: VALID
    convs, 2x2/2 pools padded at the high end on odd sides, the bottleneck
    pre-pad, the unpool + 2x2 conv (side 2s), the decoder's (3,3) and (2,2)
    pads and the 1x1 head."""
    base, depth = model["base_kernels"], model["depth"]
    pre = model.get("bottleneck_pre_pad") or (0, 0)
    out = []
    s, c_prev = model["image_size"], model["in_channels"]
    for i in range(depth):
        c = base * 2 ** i
        if i > 0:
            s = -(-s // 2)
            if i == depth - 1:
                s += pre[0] + pre[1]
        out.append(("conv_input" if i == 0 else f"conv{2 * i}", 3, c_prev, c, s, s - 2))
        out.append((f"conv{2 * i + 1}", 3, c, c, s - 2, s - 4))
        s, c_prev = s - 4, c
    for j in range(1, depth):
        c = base * 2 ** (depth - 1 - j)
        out.append((f"up{j}_conv2x2", 2, c_prev, c, s, 2 * s))
        s = 2 * s + 6
        out.append((f"up{j}_conv1", 3, 2 * c, c, s, s - 2))
        s = s - 2 + 4
        out.append((f"up{j}_conv2", 3, c, c, s, s - 2))
        s, c_prev = s - 2, c
    out.append(("conv_final", 1, c_prev, model["n_classes"], s, s))
    return out


def forward_flops_per_layer(model: dict) -> Dict[str, float]:
    """Operations of one forward per conv, one image."""
    out = {}
    for name, k, cin, cout, _, so in layers(model):
        hw = so * so
        if name == "conv_input":
            f = hw * (2 * k * k * cin * cout + 2 * k * k)
        elif name.endswith("_conv2x2"):
            f = hw * 4 * cin * cout
        else:
            f = hw * (4 * k * k * cin * cout + 2 * k * k)
        out[name] = float(f)
    return out


def forward_flops(model: dict) -> float:
    """Operations of one forward, one image."""
    return sum(forward_flops_per_layer(model).values())


def _pair_bytes(name: str, cin: int, cout: int, si: int, so: int) -> Tuple[int, int]:
    """Elements of a conv's input (as read) and output pairs."""
    reads = si * si * cin * (1 if name == "conv_input" else 2)
    return reads, so * so * cout * 2


def forward_conv_bound_s(model: dict, ops_per_s: float, bytes_per_s: float,
                         act_bytes: int = 4) -> float:
    """Least time of one image's forward convolutions: per conv the larger
    of its operations over the peak and its bytes over the bandwidth."""
    flops = forward_flops_per_layer(model)
    total = 0.0
    for name, _, cin, cout, si, so in layers(model):
        r, w = _pair_bytes(name, cin, cout, si, so)
        total += max(flops[name] / ops_per_s, (r + w) * act_bytes / bytes_per_s)
    return total


def train_flops_per_layer(model: dict) -> Dict[str, float]:
    """Operations of one training step's convolution work per conv, one
    image: 3x the forward, 2x at ``conv_input``."""
    return {n: f * (2.0 if n == "conv_input" else 3.0)
            for n, f in forward_flops_per_layer(model).items()}


def train_conv_bound_s(model: dict, ops_per_s: float, bytes_per_s: float,
                       act_bytes: int = 4) -> float:
    """Least time of one image's convolution work in a training step
    (forward, input and filter gradients)."""
    flops = train_flops_per_layer(model)
    total = 0.0
    for name, _, cin, cout, si, so in layers(model):
        r, w = _pair_bytes(name, cin, cout, si, so)
        grads = 0 if name == "conv_input" else si * si * cin * 2
        nbytes = (r + w + so * so * cout * 2 + grads) * act_bytes
        total += max(flops[name] / ops_per_s, nbytes / bytes_per_s)
    return total


def train_step_flops(model: dict, batch: int) -> float:
    """Operations of one training step, the convention of ``mfu``: 3x the
    forward per trained image."""
    return 3.0 * forward_flops(model) * batch
