"""Swin UNETR as a VDP network, in plain PyTorch: the reference the port's
Swin UNETR layer plan is held to.

Source: Hatamizadeh, Nath, Tang, Yang, Roth, Xu, "Swin UNETR: Swin
Transformers for Semantic Segmentation of Brain Tumors in MRI Images",
BrainLes 2021, arXiv:2201.01266, as ``monai.networks.nets.SwinUNETR`` (v1,
``use_v2=False``) builds it for MONAI's BraTS 2021 recipe: 128^3 regions of
4 modalities, 3 output channels, feature size 48, depths (2, 2, 2, 2),
heads (3, 6, 12, 24), windows of 7^3, patches of 2^3, MLP ratio 4,
instance-normalised residual CNN blocks; about 62 M parameters.

The layer graph (F the feature size, NDHWC tensors):

  x0 = patch_embed(x)               2^3 conv, stride 2, Cin -> F
  x1..x4 = stage_i(x_{i-1})         depths[i] Swin blocks at F 2^i channels,
                                    then the patch merge (-> F 2^(i+1), side / 2)
  h_i = LayerNorm(x_i)              no affine (``normalize=True``)
  enc0 = encoder1(x); enc1..3 = encoder2..4(h0..h2); dec4 = encoder10(h4)
  dec3 = decoder5(dec4, h3); dec2 = decoder4(dec3, enc3); ...;
  out = decoder1(dec0, enc0); logits = out(out)    1^3 conv F -> n_classes

  Swin block   x = x + proj(attention(LN1(x))); x = x + fc2(gelu(fc1(LN2(x))))
  attention    LN1's tokens zero-padded at the high end to whole windows,
               rolled by -shift (shift = window // 2 on every second block),
               split into windows; per window and head scores q k^T / sqrt(d)
               + the relative-position bias + the shift mask (-100 between
               tokens of two regions), softmax over the keys, times v;
               windows merged, rolled back, cropped. A side that fits in one
               window is the window, with no shift. qkv: a linear C -> 3C,
               channels (3, heads, d).
  patch merge  the eight 2^3 sub-grids in itertools.product order,
               concatenated (8C), LayerNorm, a linear 8C -> 2C
  res block    conv3 SAME, InstanceNorm, LeakyReLU(0.01), conv3 SAME,
               InstanceNorm; plus the input, or its 1^3 conv and
               InstanceNorm where the channels change; LeakyReLU
  up block     2^3 stride-2 transposed conv Cin -> Cout, concatenated with
               the skip after it, a res block 2 Cout -> Cout

Departures from MONAI:

- Every layer with weights is a VDP layer (SUPER-Net's moment propagation):
  Gaussian weights with mean ``w_mu`` ([k, k, k, Cin, Cout]; a linear is
  k = 1) and one variance ``softplus(w_sigma)`` per output channel; every
  activation carries its mean and diagonal variance. No biases (MONAI's
  convs, linears and qkv have them).
- LayerNorm's gamma and beta and the bias tables are point parameters: they
  act on the mean, carry no variance and no KL term.
- The patch merge takes each of the eight sub-grids once (MONAI's
  ``PatchMergingV2`` order); v1's ``"merging"`` default repeats two
  sub-grids and leaves two out.
- Where a window shrinks (a side under 7) the bias index is the 7^3
  window's cut to the first n tokens, as MONAI's ``[:n, :n]`` has it.
- The loss is the VDP ELBO (below) over a softmax of 3 classes, not the
  recipe's Dice over 3 sigmoid regions; Adam without weight decay or
  schedule, not AdamW with a cosine schedule. No dropout (the recipe's
  rates are 0).
- Each Swin block and each res block is recomputed in the backward
  (``torch.utils.checkpoint``, MONAI's ``use_checkpoint``) so that the
  reference fits on one card beside nothing else; the mathematics is the
  same.

The moments (mu, sigma), first-order:

  conv        mu' = conv(mu, w)    sigma' = winsum(sum_c mu^2 + sigma) * s
                                            + conv(sigma, w^2)
              (the volume's conv: sigma' = winsum(sum_c x^2) * s)
  norm        y = (mu - m) / r over the axis (N elements), m the mean,
              r = sqrt(var + 1e-5) of mu; sigma' = diag(J diag(sigma) J^T),
              J = (I - (1 + y y^T) / N) / r, times gamma^2 where given
  gelu        sigma' = (Phi(mu) + mu phi(mu))^2 sigma
  leaky relu  sigma' = sigma where mu > 0, else 1e-4 sigma
  residual    means and variances add
  scores      mu_S = mu_q mu_k^T + bias + mask;
              sigma_S = sigma_q (mu_k^2 + sigma_k)^T + mu_q^2 sigma_k^T
  softmax     p, sigma_p = p^2 ((1 - 2 p) sigma_S + sum_j p_j^2 sigma_S,j)
              (over the keys; over the classes at the head)
  values      mu_O = p mu_v; sigma_O = sigma_p (mu_v^2 + sigma_v) + p^2 sigma_v

with ``s = softplus(w_sigma)`` and ``winsum`` the sum over each window. A
k^3 conv is k^3 matrix products of the whole input, each summed over its
shifted output window (no cuDNN); the attention is explicit window
partitions and einsums. The loss and the step:

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
SLOPE = 0.01
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


# ------------------------------------------------------------- the plan


def _widths(model: dict):
    f = model["feature_size"]
    encoders = [("encoder2", f), ("encoder3", 2 * f), ("encoder4", 4 * f),
                ("encoder10", 16 * f)]
    decoders = [("decoder5", 16 * f, 8 * f), ("decoder4", 8 * f, 4 * f),
                ("decoder3", 4 * f, 2 * f), ("decoder2", 2 * f, f), ("decoder1", f, f)]
    return f, encoders, decoders


def layers(model: dict) -> List[Tuple[str, int, int, int]]:
    """``(name, k, c_in, c_out)`` of every layer with Gaussian weights."""
    f, encoders, decoders = _widths(model)
    r = model["mlp_ratio"]

    def res(name, cin, cout):
        out = [(name + "_conv1", 3, cin, cout), (name + "_conv2", 3, cout, cout)]
        return out + ([(name + "_conv3", 1, cin, cout)] if cin != cout else [])

    out = [("patch_embed", model["patch_size"], model["in_channels"], f)]
    for i, depth in enumerate(model["depths"]):
        c = f << i
        for j in range(depth):
            b = f"stage{i}_block{j}"
            out += [(b + "_qkv", 1, c, 3 * c), (b + "_proj", 1, c, c),
                    (b + "_fc1", 1, c, r * c), (b + "_fc2", 1, r * c, c)]
        out.append((f"stage{i}_merge", 1, 8 * c, 2 * c))
    out += res("encoder1", model["in_channels"], f)
    for name, c in encoders:
        out += res(name, c, c)
    for name, cin, cout in decoders:
        out += [(name + "_up", 2, cin, cout)] + res(name, 2 * cout, cout)
    return out + [("out", 1, f, model["n_classes"])]


def points(model: dict) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """``(entry, key, shape)`` of every point parameter."""
    f, ws = model["feature_size"], model["window_size"]
    out = []
    for i, (depth, heads) in enumerate(zip(model["depths"], model["num_heads"])):
        c = f << i
        for j in range(depth):
            b = f"stage{i}_block{j}"
            out += [(b + "_norm1", "gamma", (c,)), (b + "_norm1", "beta", (c,)),
                    (b + "_attn", "bias_table", ((2 * ws - 1) ** 3, heads)),
                    (b + "_norm2", "gamma", (c,)), (b + "_norm2", "beta", (c,))]
        out += [(f"stage{i}_merge_norm", "gamma", (8 * c,)),
                (f"stage{i}_merge_norm", "beta", (8 * c,))]
    return out


# ----------------------------------------------------------- the layers


def _tap_views(x: Tensor, k: int, stride: int):
    """Each tap's (dz, dy, dx) strided shifted view of ``x`` [B, D, H, W, C]
    for a VALID k^3 conv: the input voxels its output voxels read."""
    size = [(x.shape[a] - k) // stride + 1 for a in (1, 2, 3)]
    for dz, dy, dx in itertools.product(range(k), repeat=3):
        yield (dz, dy, dx), (slice(None), slice(dz, dz + stride * (size[0] - 1) + 1, stride),
                             slice(dy, dy + stride * (size[1] - 1) + 1, stride),
                             slice(dx, dx + stride * (size[2] - 1) + 1, stride))


class _Conv(torch.autograd.Function):
    """VALID conv of ``x`` [B, D, H, W, Cin] with ``w`` [k, k, k, Cin, Cout]:
    the sum over the taps of the tap's matrix product with its strided
    shifted view of the input. The backward is written the same way, tap by
    tap, so that only ``x`` and ``w`` are kept for it (autograd of the
    products would keep a copy of the input per tap)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        out = None
        for tap, view in _tap_views(x, w.shape[0], stride):
            part = x[view] @ w[tap]
            out = part if out is None else out + part
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        gw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        g2 = g.reshape(-1, g.shape[-1])
        for tap, view in _tap_views(x, w.shape[0], ctx.stride):
            if gw is not None:
                gw[tap] = x[view].reshape(-1, x.shape[-1]).transpose(0, 1) @ g2
            if gx is not None:
                gx[view] += g @ w[tap].transpose(0, 1)
        return gx, gw, None


def conv(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    """VALID (strided) conv of ``x`` [B, D, H, W, Cin] with ``w`` [k, k, k,
    Cin, Cout], tap by tap (:class:`_Conv`)."""
    return _Conv.apply(x, w, stride)


def vconv(mu: Tensor, sig, w_mu: Tensor, w_sigma: Tensor, stride: int = 1) -> Pair:
    """A VDP conv (``sig`` None: the deterministic volume)."""
    s = F.softplus(w_sigma)
    k = w_mu.shape[0]
    t = (mu * mu).sum(-1, keepdim=True)
    if sig is not None:
        t = t + sig.sum(-1, keepdim=True)
    ones = torch.ones((k, k, k, 1, 1), dtype=mu.dtype, device=mu.device)
    var = conv(t, ones, stride) * s
    if sig is not None:
        var = var + conv(sig, w_mu * w_mu, stride)
    return conv(mu, w_mu, stride), var


def same(mu: Tensor, sig) -> Tuple[Tensor, Tensor]:
    """Zero pads of 1 on every spatial side (the variance's zero too)."""
    pad = (0, 0, 1, 1, 1, 1, 1, 1)
    return F.pad(mu, pad), None if sig is None else F.pad(sig, pad)


def transposed(mu: Tensor, sig: Tensor, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    """The stride-2 2^3 transposed conv as written: zero-interleave with a
    one-voxel border (side 2s + 1), then a VALID 2^3 conv."""
    def interleave(t):
        b, d, h, w, c = t.shape
        out = t.new_zeros((b, 2 * d + 1, 2 * h + 1, 2 * w + 1, c))
        out[:, 1::2, 1::2, 1::2] = t
        return out

    return vconv(interleave(mu), interleave(sig), w_mu, w_sigma)


def norm(mu: Tensor, sig: Tensor, dims, gamma=None, beta=None) -> Pair:
    var, mean = torch.var_mean(mu, dim=dims, unbiased=False, keepdim=True)
    r = torch.sqrt(var + NORM_EPS)
    y = (mu - mean) / r
    n = math.prod(mu.shape[d] for d in dims)
    # sum_j (delta_ij - (1 + y_i y_j) / N)^2 sigma_j
    tot = (sig.sum(dims, keepdim=True) + 2 * y * (y * sig).sum(dims, keepdim=True)
           + y * y * (y * y * sig).sum(dims, keepdim=True))
    var_out = (sig - 2 * (1 + y * y) * sig / n + tot / n ** 2) / (r * r)
    if gamma is not None:
        return y * gamma + beta, var_out * gamma * gamma
    return y, var_out


def gelu(mu: Tensor, sig: Tensor) -> Pair:
    cdf = 0.5 * (1 + torch.erf(mu / math.sqrt(2)))
    slope = cdf + mu * torch.exp(-mu * mu / 2) / math.sqrt(2 * math.pi)
    return mu * cdf, slope * slope * sig


def leaky_relu(mu: Tensor, sig: Tensor) -> Pair:
    pos = mu > 0
    return torch.where(pos, mu, SLOPE * mu), torch.where(pos, sig, SLOPE * SLOPE * sig)


def softmax(mu: Tensor, sig: Tensor, dim: int = -1) -> Pair:
    p = torch.softmax(mu, dim=dim)
    p2 = p * p
    return p, p2 * ((1 - 2 * p) * sig + (p2 * sig).sum(dim, keepdim=True))


# ----------------------------------------------------------- attention


def windows(t: Tensor, ws: int) -> Tensor:
    """[B, S, S, S, C] -> [B, nW, ws^3, C], windows and their tokens in
    (d, h, w) order."""
    b, s, c = t.shape[0], t.shape[1], t.shape[-1]
    g = s // ws
    t = t.reshape(b, g, ws, g, ws, g, ws, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return t.reshape(b, g ** 3, ws ** 3, c)


def unwindows(t: Tensor, ws: int, s: int) -> Tensor:
    b, c = t.shape[0], t.shape[-1]
    g = s // ws
    t = t.reshape(b, g, g, g, ws, ws, ws, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return t.reshape(b, s, s, s, c)


def bias_index(window: int, n: int) -> Tensor:
    """Each token pair's row of the bias table, for the first n tokens of a
    ``window``^3 window."""
    m = 2 * window - 1
    coords = list(itertools.product(range(window), repeat=3))[:n]
    rows = [[((zi - zj + window - 1) * m + yi - yj + window - 1) * m + xi - xj + window - 1
             for zj, yj, xj in coords] for zi, yi, xi in coords]
    return torch.tensor(rows)


def region_mask(s: int, ws: int, shift: int, device) -> Tensor:
    """[nW, n, n]: -100 between two tokens of a window from different regions
    of the shifted cube, else 0."""
    idx = torch.arange(s, device=device)
    part = (idx >= s - ws).long() + (idx >= s - shift).long()
    region = (part.view(s, 1, 1) * 9 + part.view(1, s, 1) * 3 + part.view(1, 1, s)).float()
    w = windows(region.view(1, s, s, s, 1), ws)[0, :, :, 0]
    return (w.unsqueeze(1) != w.unsqueeze(2)).float() * -100.0


def attention_moments(qm, qs, km, ks, vm, vs, add):
    """One head's moments per window (q already scaled; ``add`` the bias
    and mask): the scores, their softmax over the keys, times the values."""
    sm = torch.einsum("bwhid,bwhjd->bwhij", qm, km) + add
    ss = (torch.einsum("bwhid,bwhjd->bwhij", qs, km * km + ks)
          + torch.einsum("bwhid,bwhjd->bwhij", qm * qm, ks))
    p, sp = softmax(sm, ss, -1)
    om = torch.einsum("bwhij,bwhjd->bwhid", p, vm)
    os_ = (torch.einsum("bwhij,bwhjd->bwhid", sp, vm * vm + vs)
           + torch.einsum("bwhij,bwhjd->bwhid", p * p, vs))
    return om, os_


def linear(mu: Tensor, sig: Tensor, w_mu: Tensor, w_sigma: Tensor) -> Pair:
    """A VDP linear on tokens of any shape [..., Cin] (``w_mu`` [1, 1, 1,
    Cin, Cout])."""
    w = w_mu[0, 0, 0]
    t = (mu * mu + sig).sum(-1, keepdim=True)
    return mu @ w, t * F.softplus(w_sigma) + sig @ (w * w)


def attention(mu: Tensor, sig: Tensor, w, heads: int, window: int, shift: int) -> Pair:
    """Window attention of the normalised tokens, as MONAI orders it: pad,
    roll, windows, qkv, the heads, proj, windows merged, roll back, crop
    (``w``: the block's parameters by part)."""
    b, d = mu.shape[0], mu.shape[1]
    if d <= window:
        window_used, shift = d, 0
    else:
        window_used = window
    s = -(-d // window_used) * window_used
    pad = (0, 0, 0, s - d, 0, s - d, 0, s - d)
    mu, sig = F.pad(mu, pad), F.pad(sig, pad)
    if shift:
        mu, sig = (torch.roll(t, (-shift, -shift, -shift), (1, 2, 3)) for t in (mu, sig))
    c = mu.shape[-1]
    hd = c // heads
    n = window_used ** 3
    qm, qs = linear(windows(mu, window_used), windows(sig, window_used), *w("qkv"))

    def split(t):  # -> 3 x [B, nW, heads, n, hd]
        return t.reshape(b, -1, n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5).unbind(0)

    (q_m, k_m, v_m), (q_s, k_s, v_s) = split(qm), split(qs)
    table = w("attn")[0]
    idx = bias_index(window, n).to(table.device)
    add = table[idx].permute(2, 0, 1)  # [heads, n, n]
    if shift:
        add = add + region_mask(s, window_used, shift, table.device).unsqueeze(1)
    om, os_ = attention_moments(q_m / math.sqrt(hd), q_s / hd, k_m, k_s, v_m, v_s, add)
    om, os_ = linear(om.permute(0, 1, 3, 2, 4).reshape(b, -1, n, c),
                     os_.permute(0, 1, 3, 2, 4).reshape(b, -1, n, c), *w("proj"))

    def merge(t):
        t = unwindows(t, window_used, s)
        if shift:
            t = torch.roll(t, (shift, shift, shift), (1, 2, 3))
        return t[:, :d, :d, :d]

    return merge(om), merge(os_)


# -------------------------------------------------------------- blocks


def swin_block(params: Params, name: str, heads: int, window: int, shift: int,
               mu: Tensor, sig: Tensor) -> Pair:
    def w(part):
        p = params[f"{name}_{part}"]
        return (p["bias_table"],) if part == "attn" else (p["w_mu"], p["w_sigma"])

    def ln(part, m, s):
        p = params[f"{name}_{part}"]
        return norm(m, s, (-1,), p["gamma"], p["beta"])

    am, as_ = attention(*ln("norm1", mu, sig), w, heads, window, shift)
    mu, sig = mu + am, sig + as_
    hm, hs = vconv(*ln("norm2", mu, sig), *w("fc1"))
    hm, hs = vconv(*gelu(hm, hs), *w("fc2"))
    return mu + hm, sig + hs


def res_block(params: Params, name: str, mu: Tensor, sig=None) -> Pair:
    def w(part):
        return params[f"{name}_{part}"]["w_mu"], params[f"{name}_{part}"]["w_sigma"]

    hm, hs = leaky_relu(*norm(*vconv(*same(mu, sig), *w("conv1")), (1, 2, 3)))
    hm, hs = norm(*vconv(*same(hm, hs), *w("conv2")), (1, 2, 3))
    if f"{name}_conv3" in params:
        rm, rs = norm(*vconv(mu, sig, *w("conv3")), (1, 2, 3))
    else:
        rm, rs = mu, sig
    return leaky_relu(hm + rm, hs + rs)


def _ckpt(fn, *args):
    """``fn(*args)``, recomputed in the backward where gradients flow."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(params: Params, x: Tensor, model: dict) -> Pair:
    """``x`` [B, S, S, S, Cin] -> ``(probs, sigma)``, each [B, S^3, n_classes],
    voxels in (d, h, w) row-major order."""
    f, encoders, decoders = _widths(model)
    window = model["window_size"]

    def p(name):
        return params[name]["w_mu"], params[name]["w_sigma"]

    def hidden(m, s):
        return norm(m, s, (-1,))

    mu, sig = vconv(x, None, *p("patch_embed"), stride=model["patch_size"])
    states = [hidden(mu, sig)]
    for i, (depth, heads) in enumerate(zip(model["depths"], model["num_heads"])):
        for j in range(depth):
            shift = window // 2 if j % 2 else 0
            mu, sig = _ckpt(lambda m, s, i=i, j=j, heads=heads, shift=shift: swin_block(
                params, f"stage{i}_block{j}", heads, window, shift, m, s), mu, sig)
        if any(n % 2 for n in mu.shape[1:4]):
            pad = (0, 0, 0, mu.shape[3] % 2, 0, mu.shape[2] % 2, 0, mu.shape[1] % 2)
            mu, sig = F.pad(mu, pad), F.pad(sig, pad)
        grids = list(itertools.product(range(2), repeat=3))
        mu = torch.cat([mu[:, a::2, b::2, c::2] for a, b, c in grids], -1)
        sig = torch.cat([sig[:, a::2, b::2, c::2] for a, b, c in grids], -1)
        ln = params[f"stage{i}_merge_norm"]
        mu, sig = vconv(*norm(mu, sig, (-1,), ln["gamma"], ln["beta"]), *p(f"stage{i}_merge"))
        states.append(hidden(mu, sig))

    skips = [_ckpt(lambda v: res_block(params, "encoder1", v), x)]
    for (name, _), h in zip(encoders, (states[0], states[1], states[2], states[4])):
        skips.append(_ckpt(lambda m, s, name=name: res_block(params, name, m, s), *h))
    mu, sig = skips[4]
    for (name, _, _), (em, es) in zip(decoders, (states[3], skips[3], skips[2], skips[1],
                                                 skips[0])):
        um, us = transposed(mu, sig, *p(name + "_up"))
        mu, sig = _ckpt(lambda m, s, name=name: res_block(params, name, m, s),
                        torch.cat([um, em], -1), torch.cat([us, es], -1))
    mu, sig = vconv(mu, sig, *p("out"))
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
