"""Weights of the MedNeXt configuration from the seed, made on the device in
a few large calls (``core/data3d.py``'s scheme; the volumes are its
``volumes``).

Every layer with weights (``core/counts_mednext3d.py:layers``) gets
``w_mu`` (``[k, k, k, Cin, Cout]``, a depthwise conv's ``Cin`` 1) a normal
cut at two standard deviations and scaled to He scale (std
``sqrt(2 / fan_in)``, ``fan_in = k^3 Cin``) and ``w_sigma`` (``[Cout]``)
uniform on the ranges of ``model`` (the tighter one on the head alone). Each block's
GroupNorm gets ``gamma`` 1 and ``beta`` 0. One draw of each kind serves all
layers.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.core.counts_mednext3d import blocks, layers
from benchmark.core.data import _TRUNC2_STD


def weights(model: dict, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The parameters of ``model``: ``{layer: {"w_mu", "w_sigma"}}`` for the
    layers with weights, then ``{block_norm: {"gamma", "beta"}}``."""
    rows = layers(model)
    n_mu = sum(k ** 3 * cin * cout for _, k, cin, cout, _, _ in rows)
    n_sig = sum(cout for _, _, _, cout, _, _ in rows)
    mu = torch.empty(n_mu, device=device)
    torch.nn.init.trunc_normal_(mu, 0.0, 1.0, -2.0, 2.0, generator=gen)
    u = torch.rand(n_sig, device=device, generator=gen)
    out, a, b = {}, 0, 0
    for name, k, cin, cout, _, _ in rows:
        n = k ** 3 * cin * cout
        scale = math.sqrt(2.0 / (k ** 3 * cin)) / _TRUNC2_STD
        lo, hi = ((model["tight_sigma_min"], model["tight_sigma_max"]) if name == "out"
                  else (model["sigma_min"], model["sigma_max"]))
        out[name] = {"w_mu": (mu[a:a + n] * scale).view(k, k, k, cin, cout),
                     "w_sigma": u[b:b + cout] * (hi - lo) + lo}
        a, b = a + n, b + cout
    for name, _, c, _, _, _, _ in blocks(model):
        out[f"{name}_norm"] = {"gamma": torch.ones(c, device=device),
                               "beta": torch.zeros(c, device=device)}
    return out
