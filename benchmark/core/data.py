"""Weights and images from the seed, made on the device in a few large calls.

Weights: every layer's ``w_mu`` (HWIO ``[k, k, Cin, Cout]``) and raw
``w_sigma`` (``[Cout]``), named as the port's layers are. ``w_mu`` is a
normal cut at two standard deviations and scaled to He scale (std
``sqrt(2 / fan_in)``), the stand-in for trained weights that the
configuration files name under ``assumed``; ``w_sigma`` is uniform on the
published ranges (the tighter one for the first ``tight_upconvs`` decoder
2x2 convs and the head). One draw of each serves all layers.

Images: a frozen copy of ``supernet_tpu_torch/data/synthetic.py``'s
generator, computed for a whole batch at once on the device: Gaussian noise
(std 0.05), and per foreground class an elliptical blob (centre uniform on
the middle half, radii 6-15% of the side) that sets the label and adds
``0.4 + 0.2 * class`` to channel ``i % C`` of image ``i``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.core.counts import layers

# the standard deviation of a unit normal cut at +-2
_TRUNC2_STD = 0.8796256610342398


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number up to
    64 bits; larger ones are folded)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def he_weights(model: dict, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The parameters of ``model`` as ``{layer: {"w_mu", "w_sigma"}}``."""
    convs = layers(model)
    n_mu = sum(k * k * cin * cout for _, k, cin, cout, _, _ in convs)
    n_sig = sum(cout for _, _, _, cout, _, _ in convs)
    mu = torch.empty(n_mu, device=device)
    torch.nn.init.trunc_normal_(mu, 0.0, 1.0, -2.0, 2.0, generator=gen)
    u = torch.rand(n_sig, device=device, generator=gen)
    tight = {f"up{j}_conv2x2" for j in range(1, model["tight_upconvs"] + 1)}
    tight.add("conv_final")
    out, a, b = {}, 0, 0
    for name, k, cin, cout, _, _ in convs:
        n = k * k * cin * cout
        scale = math.sqrt(2.0 / (k * k * cin)) / _TRUNC2_STD
        lo, hi = ((model["tight_sigma_min"], model["tight_sigma_max"]) if name in tight
                  else (model["sigma_min"], model["sigma_max"]))
        out[name] = {
            "w_mu": (mu[a:a + n] * scale).view(k, k, cin, cout),
            "w_sigma": u[b:b + cout] * (hi - lo) + lo,
        }
        a, b = a + n, b + cout
    return out


def images(model: dict, n: int, gen: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` images ``[n, S, S, C]`` float32 and labels ``[n, S, S]`` int32."""
    s, c, classes = model["image_size"], model["in_channels"], model["n_classes"]
    x = torch.randn((n, s, s, c), device=device, generator=gen) * 0.05
    y = torch.zeros((n, s, s), dtype=torch.int32, device=device)
    grid = torch.arange(s, device=device, dtype=torch.float32)
    yy, xx = grid.view(1, s, 1), grid.view(1, 1, s)
    chan = torch.nn.functional.one_hot(torch.arange(n, device=device) % c, c)
    chan = chan.to(torch.float32).view(n, 1, 1, c)
    for cls in range(1, classes):
        r = torch.rand((4, n), device=device, generator=gen)
        cy, cx = (0.25 + 0.5 * r[0]) * s, (0.25 + 0.5 * r[1]) * s
        ry, rx = (0.06 + 0.09 * r[2]) * s, (0.06 + 0.09 * r[3]) * s
        blob = (((yy - cy.view(n, 1, 1)) / ry.view(n, 1, 1)) ** 2
                + ((xx - cx.view(n, 1, 1)) / rx.view(n, 1, 1)) ** 2) < 1.0
        y = torch.where(blob, torch.full_like(y, cls), y)
        x = x + blob.unsqueeze(-1).to(torch.float32) * chan * (0.4 + 0.2 * cls)
    return x, y


def center_crop(y: torch.Tensor, size: int) -> torch.Tensor:
    """The centre ``size x size`` of the spatial axes 1 and 2, offset
    ``(S - size) // 2`` (the crop of the labels to the output side)."""
    o = (y.shape[1] - size) // 2
    return y[:, o:o + size, o:o + size]
