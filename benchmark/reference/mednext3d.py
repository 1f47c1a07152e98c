"""MedNeXt as a VDP network, in plain PyTorch: the reference the port's
MedNeXt layer plan is held to.

Source: Roy, Koehler, Ulrich, Baumgartner, Petersen, Isensee, Jaeger,
Maier-Hein, "MedNeXt: Transformer-driven Scaling of ConvNets for Medical
Image Segmentation", MICCAI 2023, arXiv:2303.09975, as
``create_mednext_v1(num_input_channels=4, num_classes=4, model_id='L',
kernel_size=3)`` of MIC-DKFZ/MedNeXt builds it: ``n_channels`` 32, ``exp_r``
and ``block_counts`` (3, 4, 8, 8, 8, 8, 8, 4, 3), ``do_res`` and
``do_res_up_down`` on, ``norm_type='group'`` (GroupNorm(C, C)), no GRN,
``checkpoint_style='outside_block'``; 61.8 M parameters.

The layer graph (n the stem's width, NDHWC tensors, every conv SAME):

  x = stem(x)                       1^3 conv, Cin -> n
  level i = 0..3 (C = n 2^i):       block_counts[i] blocks at C, ratio exp_r[i];
                                    skip_i = x; x = down_i(x)  (C -> 2C, exp_r[i+1])
  bottleneck                        block_counts[4] blocks at 16 n, exp_r[4]
  level l = 3..0 (C = n 2^(l+1)):   x = up_l(x) + skip_l  (C -> C/2, exp_r[8-l]);
                                    block_counts[8-l] blocks at C/2, exp_r[8-l]
  logits = out(x)                   1^3 conv n -> n_classes

  block     h = dw(x) (k^3 depthwise, pad k // 2); h = GroupNorm(C, C)(h);
            h = conv1(h) C -> R C; h = GELU(h); h = conv1(h) R C -> C; x + h
  down      the block with a stride-2 depthwise conv, its last conv to 2C and
            no inner residual, plus conv1 at stride 2 (C -> 2C) of x
  up        the block with the stride-2 transposed depthwise conv (padding
            k // 2, side s -> 2 s - 1), its last conv to C / 2 and no inner
            residual, padded (1, 0) on every spatial axis; plus the stride-2
            1^3 transposed conv of x (side 2 s - 1: the product at even
            positions, 0 elsewhere) padded the same way

Departures from the published network:

- Every layer with weights is a VDP layer (SUPER-Net's moment propagation):
  Gaussian weights with mean ``w_mu`` ([k, k, k, Cin, Cout]; a depthwise
  conv [k, k, k, 1, C], a 1^3 conv k = 1) and one variance
  ``softplus(w_sigma)`` per output channel; every activation carries its
  mean and diagonal variance. No biases (every conv of MedNeXt has one).
- GroupNorm's gamma and beta are point parameters: they act on the mean,
  carry no variance and no KL term.
- The loss is the VDP ELBO (below) over a softmax of 4 classes, not
  nnU-Net's Dice + cross-entropy with deep supervision (whose four 1^3 heads
  are left out); Adam without weight decay or schedule, not nnU-Net's SGD
  (momentum 0.99, poly schedule) or the AdamW runs of the MedNeXt trainers.
- Each block is recomputed in the backward (``torch.utils.checkpoint``), as
  the published L model runs, so that the reference fits on one card at
  batch 2 beside nothing else; the mathematics is the same.

The moments (mu, sigma), first-order, ``s = softplus(w_sigma)``:

  1^3 conv    mu' = mu w                 sigma' = (sum_c mu^2 + sigma) s + sigma w^2
              (the volume's: sigma' = (sum_c x^2) s)
  depthwise   per channel c over the window's taps t (zero pad, sigma 0 there):
              mu'[c]    = sum_t w[t, c] mu[c](p + t)
              sigma'[c] = s[c] sum_t (mu[c]^2 + sigma[c])(p + t)
                          + sum_t w[t, c]^2 sigma[c](p + t)
              the transposed form the same sums scattered: each input voxel
              i adds to output 2 i + t - k // 2
  norm        y = (mu - m) / r over D*H*W per channel and volume (N voxels),
              m the mean, r = sqrt(var + 1e-5) of mu;
              mu' = gamma y + beta, sigma' = gamma^2 diag(J diag(sigma) J^T),
              J = (I - (1 + y y^T) / N) / r
  gelu        sigma' = (Phi(mu) + mu phi(mu))^2 sigma
  residual    means and variances add
  softmax     p, sigma_p = p^2 ((1 - 2 p) sigma + sum_j p_j^2 sigma_j)

Each depthwise conv is its k^3 taps' multiply-adds per channel; each 1^3
conv a float32 matrix product. The loss and the step:

  nll   = 0.5 * (mean_{b,n} sum_c (p - y)^2 / (s + 1e-3)      (0 if not finite)
                 + mean_{b,n} sum_c log(s + 1e-3)),   s = clip(sigma, lo, hi)
  kl    = sum_layers [ sum w_mu^2 - k^3 * mean(1 + log softplus(w_sigma)
                                              - softplus(w_sigma)) ]
  loss  = nll + kl_factor * 0.5 * kl
  clip  each gradient tensor g scaled by clipnorm / |g| where |g| > clipnorm
  adam  m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
        w -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

Float32 with TF32 off and cuDNN off inside :func:`arithmetic` (with ``tf32``
on: the control, the nearest precision below float32). Imports nothing but
``torch`` and the standard library.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]
Params = Dict[str, Dict[str, Tensor]]
NLL_EPS = 1e-3
NORM_EPS = 1e-5
BETAS = (0.9, 0.999)
LEVELS = 4


@contextlib.contextmanager
def arithmetic(tf32: bool = False):
    """Float32 products with TF32 off and cuDNN off inside the block (TF32
    on with ``tf32``), the flags restored after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = flags


# ------------------------------------------------------------- the plan


def blocks(model: dict) -> List[Tuple[str, str, int, int, int]]:
    """``(name, kind, C, ratio, C_out)`` of every block in forward order."""
    n, r, bc = model["n_channels"], model["exp_r"], model["block_counts"]
    out = []
    for i in range(LEVELS):
        c = n << i
        out += [(f"enc{i}_block{j}", "block", c, r[i], c) for j in range(bc[i])]
        out.append((f"down{i}", "down", c, r[i + 1], 2 * c))
    c = n << LEVELS
    out += [(f"bottleneck_block{j}", "block", c, r[LEVELS], c) for j in range(bc[LEVELS])]
    for lvl in (3, 2, 1, 0):
        c = n << (lvl + 1)
        out.append((f"up{lvl}", "up", c, r[8 - lvl], c // 2))
        out += [(f"dec{lvl}_block{j}", "block", c // 2, r[8 - lvl], c // 2)
                for j in range(bc[8 - lvl])]
    return out


def layers(model: dict) -> List[Tuple[str, int, int, int]]:
    """``(name, k, c_in, c_out)`` of every layer with Gaussian weights."""
    k = model["kernel_size"]
    out = [("stem", 1, model["in_channels"], model["n_channels"])]
    for name, kind, c, r, c_out in blocks(model):
        out += [(name + "_dw", k, 1, c), (name + "_expand", 1, c, r * c),
                (name + "_project", 1, r * c, c_out)]
        if kind != "block":
            out.append((name + "_res", 1, c, c_out))
    return out + [("out", 1, model["n_channels"], model["n_classes"])]


def points(model: dict) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """``(entry, key, shape)`` of every point parameter."""
    out = []
    for name, _, c, _, _ in blocks(model):
        out += [(name + "_norm", "gamma", (c,)), (name + "_norm", "beta", (c,))]
    return out


# ----------------------------------------------------------- the layers


def linear(mu: Tensor, sig, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    """A VDP 1^3 conv (``sig`` None: the deterministic volume)."""
    w = w_mu[0, 0, 0]
    t = (mu * mu).sum(-1, keepdim=True)
    if sig is None:
        return mu @ w, t * F.softplus(w_sigma)
    t = t + sig.sum(-1, keepdim=True)
    return mu @ w, t * F.softplus(w_sigma) + sig @ (w * w)


def _pad(t: Tensor, p: int) -> Tensor:
    return F.pad(t, (0, 0, p, p, p, p, p, p))


def depthwise(mu: Tensor, sig: Tensor, w_mu: Tensor, w_sigma: Tensor, stride: int = 1) -> Pair:
    """The depthwise VDP conv, tap by tap: zero pads of k // 2, every
    ``stride``-th output voxel."""
    k = w_mu.shape[0]
    p = k // 2
    s = F.softplus(w_sigma)
    mp, sp = _pad(mu, p), _pad(sig, p)
    tp = _pad(mu * mu + sig, p)
    size = [(mu.shape[a] + 2 * p - k) // stride + 1 for a in (1, 2, 3)]
    out_m = out_s = None
    for dz, dy, dx in itertools.product(range(k), repeat=3):
        view = (slice(None), slice(dz, dz + stride * (size[0] - 1) + 1, stride),
                slice(dy, dy + stride * (size[1] - 1) + 1, stride),
                slice(dx, dx + stride * (size[2] - 1) + 1, stride))
        w = w_mu[dz, dy, dx, 0]
        m = mp[view] * w
        v = tp[view] * s + sp[view] * (w * w)
        out_m = m if out_m is None else out_m + m
        out_s = v if out_s is None else out_s + v
    return out_m, out_s


def depthwise_transposed(mu: Tensor, sig: Tensor, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    """The stride-2 transposed depthwise VDP conv, tap by tap: input voxel i
    adds its tap t's products to output 2 i + t - k // 2; side n -> 2 n - 1."""
    k = w_mu.shape[0]
    p = k // 2
    s = F.softplus(w_sigma)
    b, n, c = mu.shape[0], mu.shape[1], mu.shape[-1]
    full = 2 * (n - 1) + k
    out_m = mu.new_zeros((b, full, full, full, c))
    out_s = mu.new_zeros((b, full, full, full, c))
    t = mu * mu + sig
    for dz, dy, dx in itertools.product(range(k), repeat=3):
        view = (slice(None), slice(dz, dz + 2 * n - 1, 2), slice(dy, dy + 2 * n - 1, 2),
                slice(dx, dx + 2 * n - 1, 2))
        w = w_mu[dz, dy, dx, 0]
        out_m[view] += mu * w
        out_s[view] += t * s + sig * (w * w)
    crop = (slice(None),) + (slice(p, p + 2 * n - 1),) * 3
    return out_m[crop], out_s[crop]


def pad_low(t: Tensor) -> Tensor:
    """One zero voxel before every spatial axis."""
    return F.pad(t, (0, 0, 1, 0, 1, 0, 1, 0))


def transposed_1x1(mu: Tensor, sig: Tensor, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    """The stride-2 1^3 transposed VDP conv (side n -> 2 n - 1: the product
    at even positions, mean and variance 0 at the others), then
    :func:`pad_low`."""
    m, s = linear(mu, sig, w_mu, w_sigma)

    def spread(t):
        b, n, c = t.shape[0], t.shape[1], t.shape[-1]
        out = t.new_zeros((b, 2 * n - 1, 2 * n - 1, 2 * n - 1, c))
        out[:, ::2, ::2, ::2] = t
        return pad_low(out)

    return spread(m), spread(s)


def norm(mu: Tensor, sig: Tensor, gamma: Tensor, beta: Tensor) -> Pair:
    """GroupNorm(C, C): each channel of each volume over D*H*W."""
    dims = (1, 2, 3)
    var, mean = torch.var_mean(mu, dim=dims, unbiased=False, keepdim=True)
    r = torch.sqrt(var + NORM_EPS)
    y = (mu - mean) / r
    n = math.prod(mu.shape[d] for d in dims)
    # sum_j (delta_ij - (1 + y_i y_j) / N)^2 sigma_j
    tot = (sig.sum(dims, keepdim=True) + 2 * y * (y * sig).sum(dims, keepdim=True)
           + y * y * (y * y * sig).sum(dims, keepdim=True))
    var_out = (sig - 2 * (1 + y * y) * sig / n + tot / n ** 2) / (r * r)
    return y * gamma + beta, var_out * gamma * gamma


def gelu(mu: Tensor, sig: Tensor) -> Pair:
    cdf = 0.5 * (1 + torch.erf(mu / math.sqrt(2)))
    slope = cdf + mu * torch.exp(-mu * mu / 2) / math.sqrt(2 * math.pi)
    return mu * cdf, slope * slope * sig


def softmax(mu: Tensor, sig: Tensor, dim: int = -1) -> Pair:
    p = torch.softmax(mu, dim=dim)
    p2 = p * p
    return p, p2 * ((1 - 2 * p) * sig + (p2 * sig).sum(dim, keepdim=True))


# -------------------------------------------------------------- blocks


def block(params: Params, name: str, kind: str, mu: Tensor, sig: Tensor) -> Pair:
    def w(part):
        return params[f"{name}_{part}"]["w_mu"], params[f"{name}_{part}"]["w_sigma"]

    if kind == "block":
        hm, hs = depthwise(mu, sig, *w("dw"))
    elif kind == "down":
        hm, hs = depthwise(mu, sig, *w("dw"), stride=2)
    else:
        hm, hs = depthwise_transposed(mu, sig, *w("dw"))
    g = params[f"{name}_norm"]
    hm, hs = linear(*norm(hm, hs, g["gamma"], g["beta"]), *w("expand"))
    hm, hs = linear(*gelu(hm, hs), *w("project"))
    if kind == "block":
        return mu + hm, sig + hs
    if kind == "down":
        rm, rs = linear(mu[:, ::2, ::2, ::2], sig[:, ::2, ::2, ::2], *w("res"))
        return hm + rm, hs + rs
    rm, rs = transposed_1x1(mu, sig, *w("res"))
    return pad_low(hm) + rm, pad_low(hs) + rs


def _ckpt(fn, *args):
    """``fn(*args)``, recomputed in the backward where gradients flow."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(params: Params, x: Tensor, model: dict) -> Pair:
    """``x`` [B, S, S, S, Cin] -> ``(probs, sigma)``, each [B, S^3, n_classes],
    voxels in (d, h, w) row-major order."""
    mu, sig = linear(x, None, params["stem"]["w_mu"], params["stem"]["w_sigma"])
    skips = {}
    for name, kind, _, _, _ in blocks(model):
        if kind == "down":
            skips[int(name[-1])] = (mu, sig)
        mu, sig = _ckpt(lambda m, s, name=name, kind=kind: block(params, name, kind, m, s),
                        mu, sig)
        if kind == "up":
            em, es = skips[int(name[-1])]
            mu, sig = mu + em, sig + es
    mu, sig = linear(mu, sig, params["out"]["w_mu"], params["out"]["w_sigma"])
    b, c = mu.shape[0], mu.shape[-1]
    return softmax(mu.reshape(b, -1, c), sig.reshape(b, -1, c), -1)


# ------------------------------------------------------ loss and Adam


def one_hot(labels: Tensor, n_classes: int) -> Tensor:
    """Label cubes [B, S, S, S] -> [B, S^3, C] float32."""
    y = F.one_hot(labels.long(), n_classes).to(torch.float32)
    return y.reshape(labels.shape[0], -1, n_classes)


def kl_term(params: Params) -> Tensor:
    total = 0.0
    for p in params.values():
        if "w_mu" not in p:
            continue
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
