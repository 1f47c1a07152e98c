"""Weights and volumes of the 3-D configurations from the seed, made on the
device in a few large calls (``core/data.py`` one rank up).

Weights: every conv's ``w_mu`` (DHWIO ``[k, k, k, Cin, Cout]``) and raw
``w_sigma`` (``[Cout]``), named and shaped as ``core/counts3d.py`` lays the
plan out. ``w_mu`` is a normal cut at two standard deviations and scaled to
He scale (std ``sqrt(2 / fan_in)``), the stand-in for trained weights that
the configuration file names under ``assumed``; ``w_sigma`` is uniform on
the ranges of ``model`` (the tighter one for the first ``tight_upconvs``
decoder up-convs and the head). One draw of each serves all layers.

Volumes: a copy of ``supernet_tpu_torch/data/synthetic.py:synthetic_volumes``
computed for a whole batch at once on the device: Gaussian noise (std 0.05),
and per foreground class an ellipsoid (centre uniform on the middle half of
each axis, radii 8-20% of the side) that sets the label and adds
``0.4 + 0.2 * class`` to channel ``i % C`` of volume ``i``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.core.counts3d import layers
from benchmark.core.data import _TRUNC2_STD


def he_weights(model: dict, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The parameters of ``model`` as ``{layer: {"w_mu", "w_sigma"}}``."""
    convs = layers(model)
    n_mu = sum(k ** 3 * cin * cout for _, k, cin, cout, _, _ in convs)
    n_sig = sum(cout for _, _, _, cout, _, _ in convs)
    mu = torch.empty(n_mu, device=device)
    torch.nn.init.trunc_normal_(mu, 0.0, 1.0, -2.0, 2.0, generator=gen)
    u = torch.rand(n_sig, device=device, generator=gen)
    tight = {f"up{j}_conv2x2" for j in range(1, model["tight_upconvs"] + 1)}
    tight.add("conv_final")
    out, a, b = {}, 0, 0
    for name, k, cin, cout, _, _ in convs:
        n = k ** 3 * cin * cout
        scale = math.sqrt(2.0 / (k ** 3 * cin)) / _TRUNC2_STD
        lo, hi = ((model["tight_sigma_min"], model["tight_sigma_max"]) if name in tight
                  else (model["sigma_min"], model["sigma_max"]))
        out[name] = {
            "w_mu": (mu[a:a + n] * scale).view(k, k, k, cin, cout),
            "w_sigma": u[b:b + cout] * (hi - lo) + lo,
        }
        a, b = a + n, b + cout
    return out


def volumes(model: dict, n: int, gen: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` volumes ``[n, S, S, S, C]`` float32 and labels ``[n, S, S, S]``
    int32."""
    s, c, classes = model["image_size"], model["in_channels"], model["n_classes"]
    x = torch.randn((n, s, s, s, c), device=device, generator=gen) * 0.05
    y = torch.zeros((n, s, s, s), dtype=torch.int32, device=device)
    grid = torch.arange(s, device=device, dtype=torch.float32)
    axes = (grid.view(1, s, 1, 1), grid.view(1, 1, s, 1), grid.view(1, 1, 1, s))
    chan = torch.nn.functional.one_hot(torch.arange(n, device=device) % c, c)
    chan = chan.to(torch.float32).view(n, 1, 1, 1, c)
    for cls in range(1, classes):
        r = torch.rand((6, n), device=device, generator=gen)
        inside = torch.zeros((n, s, s, s), device=device)
        for a, g in enumerate(axes):
            centre = (0.25 + 0.5 * r[a]) * s
            radius = (0.08 + 0.12 * r[3 + a]) * s
            inside = inside + ((g - centre.view(n, 1, 1, 1)) / radius.view(n, 1, 1, 1)) ** 2
        blob = inside < 1.0
        y = torch.where(blob, torch.full_like(y, cls), y)
        x = x + blob.unsqueeze(-1).to(torch.float32) * chan * (0.4 + 0.2 * cls)
    return x, y


def center_crop(y: torch.Tensor, size: int) -> torch.Tensor:
    """The centre ``size^3`` of the spatial axes 1-3, offset ``(S - size) // 2``
    (the crop of the labels to the output side)."""
    o = (y.shape[1] - size) // 2
    return y[:, o:o + size, o:o + size, o:o + size]
