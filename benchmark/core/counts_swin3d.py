"""Analytic operation and byte counts of Swin UNETR as a VDP network
(``configs/swinunetr.json``), worked out here from the configuration's
``model`` block (``supernet_tpu_torch/flops.py:forward_flops3d`` counts the
same on the port's own layer plan).

Per output voxel or token (1 multiply-add = 2 operations), the conventions
of ``core/counts3d.py``: a layer on the deterministic volume (``patch_embed``,
``encoder1``'s first and residual convs) ``2 k^3 Cin Cout + 2 k^3``; every
other conv or linear (k = 1) ``4 k^3 Cin Cout + 2 k^3`` (the mean product,
the variance product and the window sum); a transposed 2^3 conv
``4 Cin Cout`` (one input voxel per output voxel). A linear of a Swin block
runs on the real tokens: the padding to whole windows is zero in both
moments after it (no biases).

The window attention of a block, per window (padded ones included) and
head, n tokens of d channels: six products of ``2 n^2 d`` operations each
(two for the scores' variance, one for their mean, three for the output's
moments) and ``SOFTMAX_OPS`` elementwise operations per score for the
bias, the mask, the softmax and its moment. Normalisations, GELU and
LeakyReLU moments are left out: at these sizes they are under 1% of the
forward's operations.

Bytes of the attention (qkv linear through proj): its input moments read
once, its output moments written once and its weights read once, float32;
the scores need never reach memory, so a kernel that keeps them on chip is
bounded by the operations.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

SOFTMAX_OPS = 12  # per score: bias, mask, sigma sum, exp, sum, divide, moment (6)
ACT_BYTES = 4


def sides(model: dict) -> List[int]:
    """The cube side of the patch embedding's output and of each stage's
    blocks (stage i: ``sides[i]``), then of each merge's output."""
    s = model["image_size"] // model["patch_size"]
    return [-(-s // 2 ** i) for i in range(len(model["depths"]) + 1)]


def _window(side: int, model: dict) -> Tuple[int, int]:
    """``(window, windows per volume)`` of a stage at ``side``."""
    ws = min(side, model["window_size"])
    return ws, (-(-side // ws)) ** 3


def layers(model: dict) -> List[Tuple[str, int, int, int, int, str]]:
    """``(name, k, c_in, c_out, side_out, kind)`` of every layer with
    weights, in forward order; ``kind`` is ``input`` (on the volume),
    ``conv`` (a conv or a linear) or ``up`` (the transposed conv)."""
    f, r = model["feature_size"], model["mlp_ratio"]
    s, cin = model["image_size"], model["in_channels"]
    st = sides(model)
    out = [("patch_embed", model["patch_size"], cin, f, st[0], "input")]
    for i, depth in enumerate(model["depths"]):
        c = f * 2 ** i
        for j in range(depth):
            pre = f"stage{i}_block{j}"
            out += [(f"{pre}_qkv", 1, c, 3 * c, st[i], "conv"),
                    (f"{pre}_proj", 1, c, c, st[i], "conv"),
                    (f"{pre}_fc1", 1, c, r * c, st[i], "conv"),
                    (f"{pre}_fc2", 1, r * c, c, st[i], "conv")]
        out.append((f"stage{i}_merge", 1, 8 * c, 2 * c, st[i + 1], "conv"))

    def res(name, cin, cout, side, on_input=False):
        first = "input" if on_input else "conv"
        rows = [(f"{name}_conv1", 3, cin, cout, side, first),
                (f"{name}_conv2", 3, cout, cout, side, "conv")]
        if cin != cout:
            rows.append((f"{name}_conv3", 1, cin, cout, side, first))
        return rows

    out += res("encoder1", cin, f, s, True)
    for name, c, side in (("encoder2", f, st[0]), ("encoder3", 2 * f, st[1]),
                          ("encoder4", 4 * f, st[2]), ("encoder10", 16 * f, st[4])):
        out += res(name, c, c, side)
    for name, ci, co, side in (("decoder5", 16 * f, 8 * f, st[3]),
                               ("decoder4", 8 * f, 4 * f, st[2]),
                               ("decoder3", 4 * f, 2 * f, st[1]),
                               ("decoder2", 2 * f, f, st[0]), ("decoder1", f, f, s)):
        out.append((f"{name}_up", 2, ci, co, side, "up"))
        out += res(name, 2 * co, co, side)
    out.append(("out", 1, f, model["n_classes"], s, "conv"))
    return out


def attention_blocks(model: dict) -> List[Tuple[str, int, int, int, int, int]]:
    """``(block, side, channels, heads, window, windows)`` of every Swin
    block."""
    out = []
    st = sides(model)
    for i, (depth, heads) in enumerate(zip(model["depths"], model["num_heads"])):
        ws, n_win = _window(st[i], model)
        for j in range(depth):
            out.append((f"stage{i}_block{j}", st[i], model["feature_size"] * 2 ** i,
                        heads, ws, n_win))
    return out


def forward_flops_per_layer(model: dict) -> Dict[str, float]:
    """Operations of one forward per layer with weights, one volume."""
    out = {}
    for name, k, cin, cout, side, kind in layers(model):
        k3 = k ** 3
        per = {"input": 2 * k3 * cin * cout + 2 * k3, "conv": 4 * k3 * cin * cout + 2 * k3,
               "up": 4 * cin * cout}[kind]
        out[name] = float(side ** 3 * per)
    return out


def attention_core_flops(model: dict) -> Dict[str, float]:
    """Operations of each block's window attention between its qkv linear
    and its proj, one volume: the six products and the score passes."""
    out = {}
    for block, _, c, heads, ws, n_win in attention_blocks(model):
        n, d = ws ** 3, c // heads
        out[block] = float(n_win * heads * (6 * 2 * n * n * d + SOFTMAX_OPS * n * n))
    return out


def attention_flops(model: dict) -> Dict[str, float]:
    """Operations of each block's attention span (qkv linear, window
    attention, proj), one volume."""
    per_layer = forward_flops_per_layer(model)
    return {b: f + per_layer[f"{b}_qkv"] + per_layer[f"{b}_proj"]
            for b, f in attention_core_flops(model).items()}


def forward_flops(model: dict) -> float:
    """Operations of one forward, one volume."""
    return sum(forward_flops_per_layer(model).values()) + sum(attention_core_flops(model).values())


def train_step_flops(model: dict, batch: int) -> float:
    """Operations of one training step, the convention of ``mfu``: 3x the
    forward per trained volume."""
    return 3.0 * forward_flops(model) * batch


def attention_bytes(model: dict) -> Dict[str, float]:
    """Least traffic of each block's attention span, one volume: the input
    moment pair, the output moment pair, the weights of qkv and proj (w_mu
    and w_sigma) and the bias table."""
    rows = (2 * model["window_size"] - 1) ** 3
    out = {}
    for block, side, c, heads, _, _ in attention_blocks(model):
        acts = 2 * 2 * side ** 3 * c
        weights = c * 3 * c + 3 * c + c * c + c + rows * heads
        out[block] = float((acts + weights) * ACT_BYTES)
    return out


def attention_bound_s(model: dict, ops_per_s: float, bytes_per_s: float) -> float:
    """Least time of one volume's forward attention: per block the larger of
    its operations over the peak and its bytes over the bandwidth."""
    flops, nbytes = attention_flops(model), attention_bytes(model)
    return sum(max(flops[b] / ops_per_s, nbytes[b] / bytes_per_s) for b in flops)
