"""The VDP U-Net forward in plain PyTorch: the reference the benchmark holds
the program to.

Every operation carries the mean ``mu`` and the diagonal variance ``sigma``
of the activations (NCHW here). Weights are Gaussian with mean ``w_mu``
(HWIO ``[k, k, Cin, Cout]``) and per-output-channel variance
``softplus(w_sigma)``:

  input conv  mu' = conv(x, w)          sigma' = winsum(sum_c x^2) * s
  conv        mu' = conv(mu, w)         sigma' = winsum(sum_c mu^2 + sigma) * s
                                               + conv(sigma, w^2)
  relu        both kept where mu' > 0, else 0
  max-pool    2x2/2, odd sides padded at the high end; sigma at the first
              maximal tap (row-major)
  upsample    zero-interleave with a 1-pixel border (2s + 1), then a 2x2 conv
  pad         mu with zeros, sigma with the configuration's ``sigma_fill``
  skip        the encoder pair centre-cropped, concatenated after the
              decoder's channels
  head        1x1 conv, then the softmax with the variance through its
              Jacobian: sigma_c = p_c^2 ((1 - 2 p_c) sigma_c + sum_j p_j^2 sigma_j)

where ``winsum`` sums each k x k VALID window. Block order (encoder i: two
conv+relu, a pool between blocks; the bottleneck pre-pad; decoder j:
upsample + 2x2 conv, pad (3,3), skip, conv+relu, pad (2,2), conv+relu) as in
``Hippocampus.py:373-421`` and ``Brats.py:323-457``. The upsample is run as
written, not fused. Outputs are ``[B, H_out * W_out, n_classes]``, pixels in
row-major order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]


def _oihw(w: Tensor) -> Tensor:
    return w.permute(3, 2, 0, 1)


def _winsum(t: Tensor, k: int) -> Tensor:
    return F.conv2d(t, t.new_ones((1, 1, k, k)))


def conv_input(x: Tensor, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    k = w_mu.shape[0]
    s = F.softplus(w_sigma).view(1, -1, 1, 1)
    mu = F.conv2d(x, _oihw(w_mu))
    return mu, _winsum((x * x).sum(1, keepdim=True), k) * s


def conv(mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    k = w_mu.shape[0]
    s = F.softplus(w_sigma).view(1, -1, 1, 1)
    w = _oihw(w_mu)
    mu_o = F.conv2d(mu, w)
    sig_o = _winsum((mu * mu + sigma).sum(1, keepdim=True), k) * s + F.conv2d(sigma, w * w)
    return mu_o, sig_o


def relu(mu: Tensor, sigma: Tensor) -> Pair:
    keep = mu > 0
    return torch.where(keep, mu, 0.0), torch.where(keep, sigma, 0.0)


def maxpool(mu: Tensor, sigma: Tensor) -> Pair:
    b, c, h, w = mu.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        mu = F.pad(mu, (0, pw, 0, ph), value=torch.finfo(mu.dtype).min)
        sigma = F.pad(sigma, (0, pw, 0, ph))
    h2, w2 = mu.shape[2] // 2, mu.shape[3] // 2

    def taps(t: Tensor) -> Tensor:
        return t.view(b, c, h2, 2, w2, 2).permute(0, 1, 2, 4, 3, 5).reshape(b, c, h2, w2, 4)

    tm, ts = taps(mu), taps(sigma)
    idx = tm.argmax(-1, keepdim=True)
    return tm.gather(-1, idx).squeeze(-1), ts.gather(-1, idx).squeeze(-1)


def upsample(t: Tensor) -> Tensor:
    b, c, h, w = t.shape
    out = t.new_zeros((b, c, 2 * h + 1, 2 * w + 1))
    out[:, :, 1::2, 1::2] = t
    return out


def pad(mu: Tensor, sigma: Tensor, lo: int, hi: int, fill: float) -> Pair:
    p = (lo, hi, lo, hi)
    return F.pad(mu, p), F.pad(sigma, p, value=fill)


def crop(t: Tensor, size: int) -> Tensor:
    o = (t.shape[2] - size) // 2
    return t[:, :, o:o + size, o:o + size]


def softmax(mu: Tensor, sigma: Tensor) -> Pair:
    b, c, h, w = mu.shape
    m = mu.permute(0, 2, 3, 1).reshape(b, h * w, c)
    s = sigma.permute(0, 2, 3, 1).reshape(b, h * w, c)
    p = torch.softmax(m, dim=-1)
    p2 = p * p
    return p, p2 * ((1.0 - 2.0 * p) * s + (p2 * s).sum(-1, keepdim=True))


def forward(params: Dict[str, Dict[str, Tensor]], x: Tensor, model: dict) -> Pair:
    """``x`` [B, H, W, C] (NHWC, as served) -> ``(probs, sigma)``, each
    [B, H_out * W_out, n_classes]."""
    depth, fill = model["depth"], model["sigma_fill"]
    pre = model.get("bottleneck_pre_pad")

    def p(name):
        return params[name]["w_mu"], params[name]["w_sigma"]

    x = x.permute(0, 3, 1, 2)
    mu, sig = relu(*conv_input(x, *p("conv_input")))
    mu, sig = relu(*conv(mu, sig, *p("conv1")))
    skips: List[Pair] = []
    for i in range(depth):
        if i > 0:
            if i == depth - 1 and pre:
                mu, sig = pad(mu, sig, pre[0], pre[1], fill)
            mu, sig = relu(*conv(mu, sig, *p(f"conv{2 * i}")))
            mu, sig = relu(*conv(mu, sig, *p(f"conv{2 * i + 1}")))
        if i < depth - 1:
            skips.append((mu, sig))
            mu, sig = maxpool(mu, sig)
    for j in range(1, depth):
        mu, sig = conv(upsample(mu), upsample(sig), *p(f"up{j}_conv2x2"))
        mu, sig = pad(mu, sig, 3, 3, fill)
        mu_e, sig_e = skips[depth - 1 - j]
        size = mu.shape[2]
        mu = torch.cat([mu, crop(mu_e, size)], dim=1)
        sig = torch.cat([sig, crop(sig_e, size)], dim=1)
        mu, sig = relu(*conv(mu, sig, *p(f"up{j}_conv1")))
        mu, sig = pad(mu, sig, 2, 2, fill)
        mu, sig = relu(*conv(mu, sig, *p(f"up{j}_conv2")))
    mu, sig = conv(mu, sig, *p("conv_final"))
    return softmax(mu, sig)
