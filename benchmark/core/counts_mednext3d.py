"""Analytic operation and byte counts of MedNeXt as a VDP network
(``configs/mednext.json``), worked out here from the configuration's
``model`` block (``supernet_tpu_torch/flops.py:forward_flops3d`` counts the
same on the port's own layer plan).

Per output voxel (1 multiply-add = 2 operations), the conventions of
``core/counts3d.py``: the stem, on the deterministic volume, ``2 Cin Cout +
2``; every other 1^3 conv ``4 Cin Cout + 2`` (the mean product, the
variance product and the window sum of one tap), counted on the input's
grid for the stride-2 transposed one (it computes nothing at the other
voxels). A depthwise conv makes three multiply-adds per tap and channel (the
mean's product, the variance's product and the per-channel window sum):
``6 k^3 C`` per output voxel, per input voxel for the stride-2 transposed
one (each input voxel meets every tap once). Norm and GELU moments are left
out (a few operations per element, under 1% of the forward's).

Bytes of a depthwise moment conv: its input moment pair read once, its
output moment pair written once and its weights (``w_mu`` and ``w_sigma``)
read once, float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

ACT_BYTES = 4
LEVELS = 4


def blocks(model: dict) -> List[Tuple[str, str, int, int, int, int, int]]:
    """``(name, kind, C, ratio, C_out, side_in, side_out)`` of every block in
    forward order; ``kind`` is ``block``, ``down`` or ``up`` (an up block's
    ``side_out`` is its transposed conv's, 2 s - 1, before the pad)."""
    n, r, bc = model["n_channels"], model["exp_r"], model["block_counts"]
    side = model["image_size"]
    out = []
    for i in range(LEVELS):
        c = n << i
        out += [(f"enc{i}_block{j}", "block", c, r[i], c, side, side) for j in range(bc[i])]
        out.append((f"down{i}", "down", c, r[i + 1], 2 * c, side, side // 2))
        side //= 2
    c = n << LEVELS
    out += [(f"bottleneck_block{j}", "block", c, r[LEVELS], c, side, side)
            for j in range(bc[LEVELS])]
    for lvl in (3, 2, 1, 0):
        c = n << (lvl + 1)
        out.append((f"up{lvl}", "up", c, r[8 - lvl], c // 2, side, 2 * side - 1))
        side *= 2
        out += [(f"dec{lvl}_block{j}", "block", c // 2, r[8 - lvl], c // 2, side, side)
                for j in range(bc[8 - lvl])]
    return out


def layers(model: dict) -> List[Tuple[str, int, int, int, int, str]]:
    """``(name, k, c_in, c_out, voxels_side, kind)`` of every layer with
    weights, in forward order; ``voxels_side`` is the side of the grid its
    operations are counted on and ``kind`` is ``input`` (the stem),
    ``conv`` (a 1^3 conv), ``dw`` or ``dw_t`` (the transposed one)."""
    k, s = model["kernel_size"], model["image_size"]
    out = [("stem", 1, model["in_channels"], model["n_channels"], s, "input")]
    for name, kind, c, r, c_out, s_in, s_out in blocks(model):
        dw_side = s_in if kind == "up" else s_out
        out += [(f"{name}_dw", k, 1, c, dw_side, "dw_t" if kind == "up" else "dw"),
                (f"{name}_expand", 1, c, r * c, s_out, "conv"),
                (f"{name}_project", 1, r * c, c_out, s_out, "conv")]
        if kind != "block":
            out.append((f"{name}_res", 1, c, c_out, min(s_in, s_out), "conv"))
    out.append(("out", 1, model["n_channels"], model["n_classes"], s, "conv"))
    return out


def forward_flops_per_layer(model: dict) -> Dict[str, float]:
    """Operations of one forward per layer with weights, one volume."""
    out = {}
    for name, k, cin, cout, side, kind in layers(model):
        per = {"input": 2 * cin * cout + 2, "conv": 4 * cin * cout + 2,
               "dw": 6 * k ** 3 * cout, "dw_t": 6 * k ** 3 * cout}[kind]
        out[name] = float(side ** 3 * per)
    return out


def forward_flops(model: dict) -> float:
    """Operations of one forward, one volume."""
    return sum(forward_flops_per_layer(model).values())


def train_step_flops(model: dict, batch: int) -> float:
    """Operations of one training step, the convention of ``mfu``: 3x the
    forward per trained volume (recomputation not counted)."""
    return 3.0 * forward_flops(model) * batch


def dwconv_bytes(model: dict) -> Dict[str, float]:
    """Least traffic of each depthwise moment conv, one volume."""
    k = model["kernel_size"]
    out = {}
    for name, kind, c, _, _, s_in, s_out in blocks(model):
        acts = 2 * c * (s_in ** 3 + s_out ** 3)
        out[f"{name}_dw"] = float((acts + k ** 3 * c + c) * ACT_BYTES)
    return out


def dwconv_bound_s(model: dict, ops_per_s: float, bytes_per_s: float) -> float:
    """Least time of one volume's forward depthwise moment convs: per conv
    the larger of its operations over the peak and its bytes over the
    bandwidth."""
    flops = forward_flops_per_layer(model)
    return sum(max(flops[name] / ops_per_s, nbytes / bytes_per_s)
               for name, nbytes in dwconv_bytes(model).items())
