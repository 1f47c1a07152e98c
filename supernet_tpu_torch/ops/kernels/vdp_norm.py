"""Normalisation moments (``ops/moments_swin.py:vnorm``): the CUDA kernel
pair, its plain version and the autograd Function of both.

The JAX package has no counterpart: the Swin UNETR plan is the port's own,
and this replaces the chain of PyTorch operations the closed form took on
the card (about 30 a forward and 70 in autograd's backward, each a pass over
the normalised tensor). The kernels are in ``csrc/vdp_norm.cu``; they are
bound by bytes. Two layouts, chosen by the normalised dims:

- ``(-1,)``, LayerNorm ("rows"): a token's C channels in the registers of
  one warp (C <= 256) or of a block of up to 512 threads (C <= 4096). The
  forward reads ``mu`` and ``sigma`` once and writes both outputs; the
  backward reads the two and the two cotangents once and writes both
  gradients, and the gamma and beta gradients are summed over the tokens
  per block and across blocks in float64 (:func:`plan_rows`).
- ``(1, 2, 3)`` of a [B, D, H, W, C] tensor, InstanceNorm ("slices"): per
  (volume, channel) over D*H*W, a grid of position chunks x channel tiles,
  16-byte loads along C, so C % 4 == 0 (:func:`plan_slices`); the forward
  makes a pass for the mean, one for the four centred sums and one for the
  outputs, the
  backward one for its eight sums and one for the gradients, each sum folded
  across blocks in float64 by a small kernel.

Sums inside a thread and a block are float32, sums across blocks float64 in
a fixed order; nothing uses atomics, so two runs give the same bits. The
kernels take float32 moments (the configuration's precision) and float32
gamma and beta of shape [C].

:class:`VNorm` is the Function: :func:`norm_fwd` and :func:`norm_bwd`
launch the kernels for CUDA tensors and take :func:`norm_fwd_plain` and
:func:`norm_bwd_plain` only for CPU tensors (and meta ones, which carry
shapes alone); any other device raises. It
saves ``mu``, ``sigma``, gamma and the per-slice statistics m, s, A, B, D.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from supernet_tpu_torch import tracing
from supernet_tpu_torch.ops.kernels import _lib

Tensor = torch.Tensor

# Calls of the forward and of the backward that launched their kernels in
# this process (a call's kernels count as one)
launches = 0
bwd_launches = 0

ROW_ELEMS = 8  # elements of a row one thread holds (csrc/vdp_norm.cu kRowElems)
MIN_TPR = 32  # threads of one row at least: a warp
MAX_TPR = 512  # threads of one row at most: C <= ROW_ELEMS * MAX_TPR
ROW_THREADS_PER_SM = 1024  # the rows' grid: about one wave at this occupancy
VEC = 4  # channels of a slice thread's 16-byte load (csrc/vdp_norm.cu kVec)
SLICE_THREADS = 256
SLICE_BLOCKS_PER_SM = 8  # the slices' grid: about one wave of these
N_STATS = 5  # m, s, A, B, D
N_COEF = 10  # the slices' backward coefficients (csrc/vdp_norm.cu FinishBwd)
SMS = 132  # the shape-only plans' SM count (H100 SXM)


class RowPlan(NamedTuple):
    """A LayerNorm launch: blocks of ``tpr`` threads, one row each at a
    time, and ``blocks`` the grid."""

    tpr: int
    blocks: int


@functools.lru_cache(maxsize=None)
def plan_rows(rows: int, c: int, sms: int = SMS) -> RowPlan:
    """The LayerNorm kernels' plan for ``rows`` tokens of ``c`` channels on
    a card of ``sms`` SMs, from the shape alone (no CUDA: the CPU tests call
    it): the fewest threads per row, a power of two from a warp, that hold
    the row at ROW_ELEMS each; a grid of about one wave (the backward's gamma
    and beta partial rows are one a block)."""
    if c > ROW_ELEMS * MAX_TPR:
        raise ValueError(f"vdp_norm: LayerNorm over C={c} channels; the kernel takes "
                         f"C <= {ROW_ELEMS * MAX_TPR}")
    tpr = MIN_TPR
    while tpr * ROW_ELEMS < c:
        tpr *= 2
    return RowPlan(tpr, max(1, min(rows, sms * (ROW_THREADS_PER_SM // tpr))))


class SlicePlan(NamedTuple):
    """An InstanceNorm launch: a block of ``qx`` threads across channel
    units of VEC channels by ``py`` across positions, ``ctiles`` channel
    tiles and ``chunks`` position chunks of ``chunk`` positions per
    volume."""

    qx: int
    py: int
    ctiles: int
    chunks: int
    chunk: int


@functools.lru_cache(maxsize=None)
def plan_slices(b: int, p: int, c: int, sms: int = SMS) -> SlicePlan:
    """The InstanceNorm kernels' plan for ``b`` volumes of ``p`` positions
    and ``c`` channels on a card of ``sms`` SMs, from the shape alone: a
    block takes all channel units of a tile (up to SLICE_THREADS) and as many
    positions as fill SLICE_THREADS threads; the chunks split each volume so
    that the grid is about SLICE_BLOCKS_PER_SM blocks per SM, each chunk a
    whole number of the block's position rows."""
    if b > 65535:
        raise ValueError(f"vdp_norm: {b} volumes; the kernel takes at most 65535")
    if c % VEC:
        raise ValueError(f"vdp_norm: InstanceNorm over C={c} channels; the kernel loads "
                         f"{VEC} channels at a time and takes C % {VEC} == 0")
    units = c // VEC
    qx = min(units, SLICE_THREADS)
    py = SLICE_THREADS // qx
    ctiles = -(-units // qx)
    want = -(-sms * SLICE_BLOCKS_PER_SM // (b * ctiles))
    chunks = max(1, min(want, -(-p // py)))
    chunk = -(-(-(-p // chunks)) // py) * py
    return SlicePlan(qx, py, ctiles, -(-p // chunk), chunk)


def layout(shape: Sequence[int], dims: Sequence[int]) -> Optional[str]:
    """"rows" for the last axis, "slices" for axes (1, 2, 3) of a 5-D
    tensor, None for any other normalisation (the plain version's alone)."""
    nd = len(shape)
    axes = tuple(sorted(d % nd for d in dims))
    if axes == (nd - 1,):
        return "rows"
    if nd == 5 and axes == (1, 2, 3):
        return "slices"
    return None


# ----------------------------------------------------------------- plain


def norm_fwd_plain(mu: Tensor, sigma: Tensor, dims: Tuple[int, ...],
                   gamma: Optional[Tensor], beta: Optional[Tensor], eps: float):
    """The closed form (``ops/moments_swin.py``'s docstring) in PyTorch:
    ``(mu', sigma', (m, s, A, B, D))``, the statistics kept over ``dims``."""
    n = math.prod(mu.shape[d] for d in dims)
    m = mu.mean(dims, keepdim=True)
    c = mu - m
    s = torch.sqrt((c * c).mean(dims, keepdim=True) + eps)
    x = c / s
    xs = x * sigma
    a = sigma.sum(dims, keepdim=True)
    b = xs.sum(dims, keepdim=True)
    d = (x * xs).sum(dims, keepdim=True)
    x2 = x * x
    inner = sigma * (1.0 - 2.0 * (1.0 + x2) / n) + (a + 2.0 * x * b + x2 * d) / (n * n)
    scale = 1.0 / (s * s)
    if gamma is not None:
        scale = scale * (gamma * gamma)
        x = x * gamma
    if beta is not None:
        x = x + beta
    return x, scale * inner, (m, s, a, b, d)


def norm_bwd_plain(mu: Tensor, sigma: Tensor, g_mu: Tensor, g_sigma: Tensor,
                   gamma: Optional[Tensor], beta_shape, stats, dims: Tuple[int, ...]):
    """The closed form's gradient: ``(d_mu, d_sigma, d_gamma, d_beta)``,
    the last two summed to gamma's shape and ``beta_shape`` (None without
    gamma, or with ``beta_shape`` None).

    With K = gamma^2 / s^2, sigma' = K inner and mu' = gamma x + beta. Over
    the slice's N elements, G = g_sigma' K, gx = g_mu' gamma and the eight
    sums S0, S1, S2 = sum G, G x, G x^2; P0, P1 = sum gx, gx x; Q0, Q1, Q2 =
    sum G sigma, G sigma x, G sigma x^2:

    - sigma enters inner directly and through A, B, D (d/dsigma_j of A, B, D
      is 1, x_j, x_j^2): d_sigma = G (1 - 2 (1 + x^2) / N)
      + (S0 + 2 x S1 + x^2 S2) / N^2;
    - at fixed s, mu' and inner depend on x, also through B and D: dL/dx =
      gX = gx + G (-4 x sigma / N + 2 (B + x D) / N^2) + 2 sigma (S1 + x S2)
      / N^2, whose sums over the slice are P0 - 4 Q1 / N + 2 (B S0 + (A + D)
      S1 + B S2) / N^2 and P1 - 4 Q2 / N + 4 (B S1 + D S2) / N^2;
    - at fixed x, sigma' depends on s through K alone: dL/ds = -2 T / s with
      T = sum G inner = Q0 (1 - 2 / N) - 2 Q2 / N + (A S0 + 2 B S1 + D S2)
      / N^2;
    - through x = (mu - m) / s and ds/dmu_j = x_j / N: d_mu = (gX - sum gX /
      N - x sum (gX x) / N) / s + x (dL/ds) / N;
    - d_gamma sums g_mu' x + 2 gamma g_sigma' inner / s^2, d_beta g_mu'.
    """
    m, s, a, b, d = stats
    n = math.prod(mu.shape[i] for i in dims)
    nn = n * n
    x = (mu - m) / s
    x2 = x * x
    k = 1.0 / (s * s)
    gx = g_mu
    if gamma is not None:
        k = k * (gamma * gamma)
        gx = g_mu * gamma
    G = g_sigma * k
    Gs = G * sigma

    def total(t):
        return t.sum(dims, keepdim=True)

    s0, s1, s2 = total(G), total(G * x), total(G * x2)
    p0, p1 = total(gx), total(gx * x)
    q0, q1, q2 = total(Gs), total(Gs * x), total(Gs * x2)
    keep = 1.0 - 2.0 * (1.0 + x2) / n
    d_sigma = G * keep + (s0 + 2.0 * x * s1 + x2 * s2) / nn
    g_x = gx + G * (-4.0 * x * sigma / n + 2.0 * (b + x * d) / nn) + 2.0 * sigma * (s1 + x * s2) / nn
    sum_gx = p0 - 4.0 * q1 / n + 2.0 * (b * s0 + (a + d) * s1 + b * s2) / nn
    sum_gxx = p1 - 4.0 * q2 / n + 4.0 * (b * s1 + d * s2) / nn
    t = q0 * (1.0 - 2.0 / n) - 2.0 * q2 / n + (a * s0 + 2.0 * b * s1 + d * s2) / nn
    d_mu = (g_x - sum_gx / n - x * sum_gxx / n) / s - x * (2.0 * t / s) / n
    d_gamma = d_beta = None
    if gamma is not None:
        inner = sigma * keep + (a + 2.0 * x * b + x2 * d) / nn
        d_gamma = (g_mu * x + 2.0 * gamma * g_sigma * inner / (s * s)).sum_to_size(gamma.shape)
    if beta_shape is not None:
        d_beta = g_mu.sum_to_size(beta_shape)
    return d_mu, d_sigma, d_gamma, d_beta


# ---------------------------------------------------------------- kernels


def _check_affine(t: Optional[Tensor], c: int, name: str) -> Optional[Tensor]:
    if t is None:
        return None
    t = t.contiguous()
    _lib.check_input("vdp_norm", name, t, (c,))
    return t


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(mu, sigma, dims, gamma, beta, eps):
    global launches
    kind = layout(mu.shape, dims)
    if kind is None:
        raise ValueError(f"vdp_norm: no kernel normalises dims {tuple(dims)} of a "
                         f"{mu.dim()}-D tensor: (-1,) or (1, 2, 3) of [B, D, H, W, C]")
    mu, sigma = mu.contiguous(), sigma.contiguous()
    _lib.check_input("vdp_norm", "mu", mu, mu.shape)
    _lib.check_input("vdp_norm", "sigma", sigma, mu.shape)
    c = mu.shape[-1]
    if kind == "slices" and (gamma is not None or beta is not None):
        raise ValueError("vdp_norm: the InstanceNorm kernel takes no gamma or beta")
    gamma, beta = _check_affine(gamma, c, "gamma"), _check_affine(beta, c, "beta")
    out_mu, out_sigma = torch.empty_like(mu), torch.empty_like(mu)
    slices = mu.numel() // c if kind == "rows" else mu.shape[0] * c
    stats = torch.empty((N_STATS, slices), device=mu.device, dtype=torch.float32)
    if mu.numel() == 0:
        return out_mu, out_sigma, (stats,)
    lib = _lib.load()
    sms = _lib.sm_count(mu.device)
    with torch.cuda.device(mu.device):
        if kind == "rows":
            p = plan_rows(slices, c, sms)
            err = lib.supernet_vdp_norm_rows_fwd(
                mu.data_ptr(), sigma.data_ptr(),
                None if gamma is None else gamma.data_ptr(),
                None if beta is None else beta.data_ptr(),
                out_mu.data_ptr(), out_sigma.data_ptr(), stats.data_ptr(),
                slices, c, eps, p.tpr, p.blocks, _stream(mu))
        else:
            b, positions = mu.shape[0], math.prod(mu.shape[1:4])
            p = plan_slices(b, positions, c, sms)
            mu, sigma = _lib.aligned(mu), _lib.aligned(sigma)
            part = torch.empty((b, p.chunks, 4, c), device=mu.device, dtype=torch.float32)
            err = lib.supernet_vdp_norm_slices_fwd(
                mu.data_ptr(), sigma.data_ptr(), out_mu.data_ptr(), out_sigma.data_ptr(),
                stats.data_ptr(), part.data_ptr(), b, positions, c, eps, p.qx, p.py,
                p.ctiles, p.chunks, p.chunk, _stream(mu))
    _lib.check(err, f"vdp_norm forward kernel launch ({kind})")
    launches += 1
    tracing.count("moments.norms_fused")
    return out_mu, out_sigma, (stats,)


def _launch_bwd(mu, sigma, g_mu, g_sigma, gamma, beta_shape, stats, dims, affine):
    global bwd_launches
    kind = layout(mu.shape, dims)
    (stats,) = stats
    mu, sigma = mu.contiguous(), sigma.contiguous()
    g_mu, g_sigma = g_mu.contiguous(), g_sigma.contiguous()
    for name, t in (("mu", mu), ("sigma", sigma), ("g_mu", g_mu), ("g_sigma", g_sigma)):
        _lib.check_input("vdp_norm_bwd", name, t, mu.shape)
    c = mu.shape[-1]
    _lib.check_input("vdp_norm_bwd", "stats", stats, (N_STATS, stats.shape[1]))
    d_mu, d_sigma = torch.empty_like(mu), torch.empty_like(mu)
    affine = affine and kind == "rows"
    d_gamma = d_beta = None
    if affine:  # the fold writes every channel's sums
        d_gamma = torch.empty((c,), device=mu.device, dtype=torch.float32)
        d_beta = torch.empty_like(d_gamma)
    if mu.numel() == 0:
        if affine:
            d_gamma.zero_()
            d_beta.zero_()
        return d_mu, d_sigma, d_gamma, d_beta
    lib = _lib.load()
    sms = _lib.sm_count(mu.device)
    with torch.cuda.device(mu.device):
        if kind == "rows":
            rows = mu.numel() // c
            p = plan_rows(rows, c, sms)
            part = (torch.empty((p.blocks, 2, c), device=mu.device, dtype=torch.float32)
                    if affine else None)
            err = lib.supernet_vdp_norm_rows_bwd(
                mu.data_ptr(), sigma.data_ptr(), g_mu.data_ptr(), g_sigma.data_ptr(),
                None if gamma is None else gamma.data_ptr(), stats.data_ptr(),
                d_mu.data_ptr(), d_sigma.data_ptr(),
                None if part is None else part.data_ptr(),
                None if d_gamma is None else d_gamma.data_ptr(),
                None if d_beta is None else d_beta.data_ptr(),
                rows, c, p.tpr, p.blocks, _stream(mu))
        else:
            b, positions = mu.shape[0], math.prod(mu.shape[1:4])
            p = plan_slices(b, positions, c, sms)
            mu, sigma, g_mu, g_sigma = (_lib.aligned(t) for t in (mu, sigma, g_mu, g_sigma))
            coef = torch.empty((N_COEF, b * c), device=mu.device, dtype=torch.float32)
            part = torch.empty((b, p.chunks, 8, c), device=mu.device, dtype=torch.float32)
            err = lib.supernet_vdp_norm_slices_bwd(
                mu.data_ptr(), sigma.data_ptr(), g_mu.data_ptr(), g_sigma.data_ptr(),
                stats.data_ptr(), coef.data_ptr(), part.data_ptr(), d_mu.data_ptr(),
                d_sigma.data_ptr(), b, positions, c, p.qx, p.py, p.ctiles, p.chunks,
                p.chunk, _stream(mu))
    _lib.check(err, f"vdp_norm backward kernel launch ({kind})")
    bwd_launches += 1
    return (d_mu, d_sigma, None if gamma is None else d_gamma,
            None if beta_shape is None else d_beta)


def _device(op: str, mu: Tensor) -> str:
    """"cuda", or "cpu" for the plain version: CPU tensors and meta ones
    (``models/unet3d.py:stage_shapes3d`` reads the plan's shapes on meta
    tensors); any other device raises."""
    if mu.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{op}: unsupported device {mu.device}")
    return "cuda" if mu.is_cuda else "cpu"


def norm_fwd(mu: Tensor, sigma: Tensor, dims: Tuple[int, ...], gamma: Optional[Tensor],
             beta: Optional[Tensor], eps: float):
    """``(mu', sigma', stats)``: the kernels for CUDA tensors (or raise),
    :func:`norm_fwd_plain` for CPU tensors; any other device raises. The
    stats are what :func:`norm_bwd` takes: the kernels' [5, slices]
    tensor, or the plain version's five."""
    if _device("vdp_norm", mu) == "cuda":
        return _launch_fwd(mu, sigma, dims, gamma, beta, eps)
    return norm_fwd_plain(mu, sigma, dims, gamma, beta, eps)


def norm_bwd(mu: Tensor, sigma: Tensor, g_mu: Tensor, g_sigma: Tensor,
             gamma: Optional[Tensor], beta_shape, stats, dims: Tuple[int, ...], affine: bool):
    """``(d_mu, d_sigma, d_gamma, d_beta)`` from :func:`norm_fwd`'s
    ``stats`` (``beta_shape`` None: the forward had no beta): the kernels
    for CUDA tensors, which sum the gamma and beta gradients only with
    ``affine`` (else None), :func:`norm_bwd_plain` for CPU tensors."""
    if _device("vdp_norm_bwd", mu) == "cuda":
        return _launch_bwd(mu, sigma, g_mu, g_sigma, gamma, beta_shape, stats, dims, affine)
    return norm_bwd_plain(mu, sigma, g_mu, g_sigma, gamma, beta_shape, stats, dims)


class VNorm(torch.autograd.Function):
    """``vnorm`` with its gradient in closed form: forward :func:`norm_fwd`,
    backward :func:`norm_bwd` from the saved ``mu``, ``sigma``, gamma and
    per-slice statistics (autograd of the closed form would keep a dozen
    tensors of the input's size)."""

    @staticmethod
    def forward(ctx, mu, sigma, gamma, beta, dims, eps):
        out_mu, out_sigma, stats = norm_fwd(mu, sigma, dims, gamma, beta, eps)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(mu, sigma, gamma, *stats)
            ctx.dims = dims
            ctx.beta_shape = None if beta is None else beta.shape
        return out_mu, out_sigma

    @staticmethod
    def backward(ctx, g_mu, g_sigma):
        mu, sigma, gamma, *stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_mu, d_sigma, d_gamma, d_beta = norm_bwd(
            mu, sigma, g_mu, g_sigma, gamma, ctx.beta_shape, tuple(stats), ctx.dims,
            need[2] or need[3])
        return (d_mu if need[0] else None, d_sigma if need[1] else None,
                d_gamma if need[2] else None, d_beta if need[3] else None, None, None)
