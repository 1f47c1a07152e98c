"""The 3D U-Net of Cicek et al. as a VDP network, in plain PyTorch: the
reference the port's Cicek layer plan is held to.

Source: Cicek, Abdulkadir, Lienkamp, Brox, Ronneberger, "3D U-Net: Learning
Dense Volumetric Segmentation from Sparse Annotation", MICCAI 2016,
arXiv:1606.06650, Fig. 1 and section 2. The published network takes a
132x132x116x3 tile to 44x44x28x3: four resolution levels; at each encoder
level two VALID 3x3x3 convs with ReLU, the second doubling the channels
(3->32->64 | 64->64->128 | 128->128->256 | 256->256->512), a 2x2x2 max-pool
of stride 2 after each of the first three; at each decoder level a 2x2x2
up-convolution of stride 2 that keeps the channels, the centre-cropped skip
concatenated, two VALID 3x3x3 convs with ReLU that take the skip's channel
count (768->256->256 | 384->128->128 | 192->64->64); no padding anywhere;
a 1x1x1 head 64->3 and a softmax. 19,067,616 conv weights (the paper's
19,069,955 adds the biases of every conv but the up-convs).

Departures from the paper:

- Every layer is a VDP layer (SUPER-Net's moment propagation): weights are
  Gaussian with mean ``w_mu`` (DHWIO ``[k, k, k, Cin, Cout]``) and one
  variance ``softplus(w_sigma)`` per output channel, and every activation
  carries its mean ``mu`` and diagonal variance ``sigma``.
- No batch norm (the paper puts it before each ReLU): SUPER-Net's VDP layers
  carry no normalisation, and moments through batch statistics have no
  published equations. No biases, as every VDP conv.
- The loss is the VDP ELBO (below), not the paper's weighted softmax with
  unlabelled voxels ignored; the optimizer is Adam with a per-tensor clip,
  not SGD.
- The tile is a cube (132^3 -> 44^3 at the published depth and widths).

The layers (NDHWC moments):

  input conv  mu' = conv(x, w)          sigma' = winsum(sum_c x^2) * s
  conv        mu' = conv(mu, w)         sigma' = winsum(sum_c mu^2 + sigma) * s
                                                 + conv(sigma, w^2)
  relu        both kept where mu' > 0, else 0
  max-pool    2x2x2 / 2, odd sides padded at the high end; sigma at the
              first maximal tap in (d, h, w) row-major order
  up-conv     zero-interleave with a 1-voxel border (2s + 1), then a VALID
              2x2x2 conv (the stride-2 up-convolution, run as written)
  skip        the encoder pair centre-cropped, concatenated after the
              decoder's channels
  head        1x1x1 conv, then the softmax with the variance through its
              Jacobian: sigma_c = p_c^2 ((1 - 2 p_c) sigma_c + sum_j p_j^2 sigma_j)

with ``s = softplus(w_sigma)`` and ``winsum`` the sum over each k^3 VALID
window. A k^3 conv is k^3 matrix products of the whole input, each summed
over its shifted output window (no cuDNN). The loss and the step:

  nll   = 0.5 * (mean_{b,n} sum_c (p - y)^2 / (s + 1e-3)      (0 if not finite)
                 + mean_{b,n} sum_c log(s + 1e-3)),   s = clip(sigma, lo, hi)
  kl    = sum_layers [ sum w_mu^2 - k^3 * mean(1 + log softplus(w_sigma)
                                              - softplus(w_sigma)) ]
  loss  = nll + kl_factor * 0.5 * kl
  clip  each gradient tensor g scaled by clipnorm / |g| where |g| > clipnorm
  adam  m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
        w -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

Float32 with TF32 off inside :func:`arithmetic` (with ``tf32`` on: the
control, the nearest precision below float32). Imports nothing but
``torch`` and the standard library.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]
Params = Dict[str, Dict[str, Tensor]]
NLL_EPS = 1e-3
BETAS = (0.9, 0.999)


@contextlib.contextmanager
def arithmetic(tf32: bool = False):
    """Float32 products with TF32 off inside the block (on with ``tf32``),
    the flags restored after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def layers(model: dict) -> List[Tuple[str, int, int, int]]:
    """``(name, k, c_in, c_out)`` of every conv, in order, from the ``model``
    block (``in_channels``, ``n_classes``, ``base_kernels``, ``depth``)."""
    b, depth = model["base_kernels"], model["depth"]
    out = [("conv_input", 3, model["in_channels"], b), ("conv1", 3, b, 2 * b)]
    for i in range(1, depth):
        c = b * 2 ** i
        out += [(f"conv{2 * i}", 3, c, c), (f"conv{2 * i + 1}", 3, c, 2 * c)]
    ch = b * 2 ** depth
    for j in range(1, depth):
        c = b * 2 ** (depth - j)
        out += [(f"up{j}_conv2x2", 2, ch, ch), (f"up{j}_conv1", 3, ch + c, c),
                (f"up{j}_conv2", 3, c, c)]
        ch = c
    out.append(("conv_final", 1, ch, model["n_classes"]))
    return out


def _shifted_sum(parts, k: int) -> Tensor:
    """Sum of the k^3 VALID windows: ``parts(dz, dy, dx)`` is tap (dz, dy,
    dx)'s full-size contribution, summed over its shifted output window."""
    out = None
    for dz in range(k):
        for dy in range(k):
            for dx in range(k):
                y = parts(dz, dy, dx)
                d, h, w = y.shape[1] - k + 1, y.shape[2] - k + 1, y.shape[3] - k + 1
                part = y[:, dz:dz + d, dy:dy + h, dx:dx + w]
                out = part if out is None else out + part
    return out


def conv(x: Tensor, w: Tensor) -> Tensor:
    """VALID conv of ``x`` [B, D, H, W, Cin] with ``w`` [k, k, k, Cin, Cout]."""
    return _shifted_sum(lambda dz, dy, dx: x @ w[dz, dy, dx], w.shape[0])


def winsum(t: Tensor, k: int) -> Tensor:
    """Sum of each k^3 VALID window of ``t`` [B, D, H, W, 1]."""
    return _shifted_sum(lambda dz, dy, dx: t, k)


def conv_input(x: Tensor, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    s = F.softplus(w_sigma)
    return conv(x, w_mu), winsum((x * x).sum(-1, keepdim=True), w_mu.shape[0]) * s


def vconv(mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    s = F.softplus(w_sigma)
    t = (mu * mu + sigma).sum(-1, keepdim=True)
    return conv(mu, w_mu), winsum(t, w_mu.shape[0]) * s + conv(sigma, w_mu * w_mu)


def relu(mu: Tensor, sigma: Tensor) -> Pair:
    keep = mu > 0
    return torch.where(keep, mu, 0.0), torch.where(keep, sigma, 0.0)


def maxpool(mu: Tensor, sigma: Tensor) -> Pair:
    b, d, h, w, c = mu.shape
    pad = (0, 0, 0, w % 2, 0, h % 2, 0, d % 2)
    if d % 2 or h % 2 or w % 2:
        mu = F.pad(mu, pad, value=torch.finfo(mu.dtype).min)
        sigma = F.pad(sigma, pad)
    d2, h2, w2 = mu.shape[1] // 2, mu.shape[2] // 2, mu.shape[3] // 2

    def taps(t: Tensor) -> Tensor:
        t = t.reshape(b, d2, 2, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
        return t.reshape(b, d2, h2, w2, c, 8)

    tm, ts = taps(mu), taps(sigma)
    idx = tm.argmax(-1, keepdim=True)
    return tm.gather(-1, idx).squeeze(-1), ts.gather(-1, idx).squeeze(-1)


def upsample(t: Tensor) -> Tensor:
    b, d, h, w, c = t.shape
    out = t.new_zeros((b, 2 * d + 1, 2 * h + 1, 2 * w + 1, c))
    out[:, 1::2, 1::2, 1::2] = t
    return out


def crop(t: Tensor, size: int) -> Tensor:
    o = [(t.shape[a] - size) // 2 for a in (1, 2, 3)]
    return t[:, o[0]:o[0] + size, o[1]:o[1] + size, o[2]:o[2] + size]


def softmax(mu: Tensor, sigma: Tensor) -> Pair:
    b, c = mu.shape[0], mu.shape[-1]
    p = torch.softmax(mu.reshape(b, -1, c), dim=-1)
    s = sigma.reshape(b, -1, c)
    p2 = p * p
    return p, p2 * ((1.0 - 2.0 * p) * s + (p2 * s).sum(-1, keepdim=True))


def forward(params: Params, x: Tensor, model: dict) -> Pair:
    """``x`` [B, S, S, S, C] -> ``(probs, sigma)``, each [B, O^3, n_classes],
    voxels in (d, h, w) row-major order."""
    depth = model["depth"]

    def p(name):
        return params[name]["w_mu"], params[name]["w_sigma"]

    mu, sig = relu(*conv_input(x, *p("conv_input")))
    mu, sig = relu(*vconv(mu, sig, *p("conv1")))
    skips: List[Pair] = []
    for i in range(depth):
        if i > 0:
            mu, sig = relu(*vconv(mu, sig, *p(f"conv{2 * i}")))
            mu, sig = relu(*vconv(mu, sig, *p(f"conv{2 * i + 1}")))
        if i < depth - 1:
            skips.append((mu, sig))
            mu, sig = maxpool(mu, sig)
    for j in range(1, depth):
        mu, sig = vconv(upsample(mu), upsample(sig), *p(f"up{j}_conv2x2"))
        mu_e, sig_e = skips[depth - 1 - j]
        size = mu.shape[1]
        mu = torch.cat([mu, crop(mu_e, size)], dim=-1)
        sig = torch.cat([sig, crop(sig_e, size)], dim=-1)
        mu, sig = relu(*vconv(mu, sig, *p(f"up{j}_conv1")))
        mu, sig = relu(*vconv(mu, sig, *p(f"up{j}_conv2")))
    mu, sig = vconv(mu, sig, *p("conv_final"))
    return softmax(mu, sig)


def one_hot(labels: Tensor, n_classes: int) -> Tensor:
    """Label cubes [B, O, O, O] -> [B, O^3, C] float32."""
    y = F.one_hot(labels.long(), n_classes).to(torch.float32)
    return y.reshape(labels.shape[0], -1, n_classes)


def kl_term(params: Params) -> Tensor:
    total = 0.0
    for p in params.values():
        k = p["w_mu"].shape[0]
        sp = F.softplus(p["w_sigma"])
        total = total + (p["w_mu"] ** 2).sum() - k ** 3 * (1.0 + torch.log(sp) - sp).mean()
    return total


def loss(params: Params, x: Tensor, labels: Tensor, model: dict, train: dict) -> Tensor:
    """The ELBO of one batch (``train``: ``sigma_clip_min``,
    ``sigma_clip_max``, ``kl_factor``)."""
    probs, sigma = forward(params, x, model)
    y = one_hot(labels, model["n_classes"]).to(probs.dtype)
    s = torch.clamp(sigma, train["sigma_clip_min"], train["sigma_clip_max"])
    l1 = (((probs - y) ** 2) / (s + NLL_EPS)).sum(-1).mean()
    l1 = torch.where(torch.isfinite(l1), l1, torch.zeros_like(l1))
    l2 = torch.log(s + NLL_EPS).sum(-1).mean()
    return 0.5 * (l1 + l2) + train["kl_factor"] * 0.5 * kl_term(params)


class Reference:
    """The reference's trainable state: parameters and Adam's moments.
    ``step`` takes one optimizer step (``train``: ``lr``, ``clipnorm``,
    ``adam_eps`` besides the loss's keys) and returns the loss and the
    clipped gradients it applied."""

    def __init__(self, params: Params, model: dict, train: dict):
        self.model, self.train = model, train
        self.params = {n: {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
                       for n, p in params.items()}
        self.m = {key: torch.zeros_like(t) for key, t in self.leaves()}
        self.v = {key: torch.zeros_like(t) for key, t in self.leaves()}
        self.t = 0

    def leaves(self) -> List[Tuple[str, Tensor]]:
        return [(f"{n}/{k}", v) for n, p in self.params.items() for k, v in p.items()]

    def step(self, x: Tensor, labels: Tensor) -> Tuple[float, Dict[str, Tensor]]:
        tc = self.train
        named = self.leaves()
        value = loss(self.params, x, labels, self.model, tc)
        grads = torch.autograd.grad(value, [t for _, t in named])
        self.t += 1
        b1, b2 = BETAS
        clipped = {}
        with torch.no_grad():
            for (key, w), g in zip(named, grads):
                n = torch.linalg.vector_norm(g)
                g = g * torch.where(n > tc["clipnorm"], tc["clipnorm"] / torch.clamp_min(n, 1e-30), 1.0)
                clipped[key] = g
                self.m[key].mul_(b1).add_(g, alpha=1 - b1)
                self.v[key].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[key] / (1 - b1 ** self.t)
                v_hat = self.v[key] / (1 - b2 ** self.t)
                w -= tc["lr"] * m_hat / (torch.sqrt(v_hat) + tc["adam_eps"])
        return float(value.detach()), clipped
