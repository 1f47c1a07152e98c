"""Weights of the Swin UNETR configuration from the seed, made on the device
in a few large calls (``core/data3d.py``'s scheme; the volumes are its
``volumes``).

Every layer with weights (``core/counts_swin3d.py:layers``) gets ``w_mu``
(``[k, k, k, Cin, Cout]``) a normal cut at two standard deviations and
scaled to He scale (std ``sqrt(2 / fan_in)``) and ``w_sigma`` (``[Cout]``)
uniform on the ranges of ``model`` (the tighter one on the first
``tight_upconvs`` up-convs and the head). The point parameters: LayerNorm's
``gamma`` 1 and ``beta`` 0, each block's ``bias_table``
``[(2 window - 1)^3, heads]`` a normal of std 0.02 cut at two standard
deviations (MONAI's inits). One draw of each kind serves all layers.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.core.counts_swin3d import layers
from benchmark.core.data import _TRUNC2_STD

BIAS_STD = 0.02


def weights(model: dict, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The parameters of ``model``: ``{layer: {"w_mu", "w_sigma"}}`` for the
    layers with weights, then ``{entry: {"gamma", "beta"}}`` and
    ``{entry: {"bias_table"}}`` for the point parameters."""
    rows = layers(model)
    n_mu = sum(k ** 3 * cin * cout for _, k, cin, cout, _, _ in rows)
    n_sig = sum(cout for _, _, _, cout, _, _ in rows)
    mu = torch.empty(n_mu, device=device)
    torch.nn.init.trunc_normal_(mu, 0.0, 1.0, -2.0, 2.0, generator=gen)
    u = torch.rand(n_sig, device=device, generator=gen)
    ups = [name for name, *_, kind in rows if kind == "up"][: model["tight_upconvs"]]
    tight = set(ups) | {"out"}
    out, a, b = {}, 0, 0
    for name, k, cin, cout, _, _ in rows:
        n = k ** 3 * cin * cout
        scale = math.sqrt(2.0 / (k ** 3 * cin)) / _TRUNC2_STD
        lo, hi = ((model["tight_sigma_min"], model["tight_sigma_max"]) if name in tight
                  else (model["sigma_min"], model["sigma_max"]))
        out[name] = {"w_mu": (mu[a:a + n] * scale).view(k, k, k, cin, cout),
                     "w_sigma": u[b:b + cout] * (hi - lo) + lo}
        a, b = a + n, b + cout
    table_rows = (2 * model["window_size"] - 1) ** 3
    f = model["feature_size"]
    n_tab = table_rows * sum(d * h for d, h in zip(model["depths"], model["num_heads"]))
    tab = torch.empty(n_tab, device=device)
    torch.nn.init.trunc_normal_(tab, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t = 0
    for i, (depth, heads) in enumerate(zip(model["depths"], model["num_heads"])):
        c = f * 2 ** i
        for j in range(depth):
            pre = f"stage{i}_block{j}"
            n = table_rows * heads
            out[f"{pre}_norm1"] = {"gamma": torch.ones(c, device=device),
                                   "beta": torch.zeros(c, device=device)}
            out[f"{pre}_attn"] = {"bias_table": (tab[t:t + n] * BIAS_STD).view(table_rows, heads)}
            out[f"{pre}_norm2"] = {"gamma": torch.ones(c, device=device),
                                   "beta": torch.zeros(c, device=device)}
            t += n
        out[f"stage{i}_merge_norm"] = {"gamma": torch.ones(8 * c, device=device),
                                       "beta": torch.zeros(8 * c, device=device)}
    return out
