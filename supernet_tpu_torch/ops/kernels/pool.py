"""Moment max-pool (2x2, stride 2): the CUDA kernels and their plain versions.

Counterpart of ``supernet_tpu/ops/pallas/pool.py``. Both kernels are in
``csrc/pool.cu``: the forward (``vmaxpool``) and the backward
(``vmaxpool_bwd``), which routes each output gradient to the selected window
tap. Both are bound by bytes. Both take float32 or bf16 and return their
input's dtype (the tap index too), as the TPU kernels do: bf16 moments are
compared exactly (in float32 registers, or as bf16 pairs on the forward's
vector path) and stored back unchanged. Each has two
kernels, picked by :func:`plan_fwd` and :func:`plan_bwd` from the shape and
the element size: a vector path for C a multiple of the channels in 16
bytes (4 float32 or 8 bf16: one thread per pooled window and 16 bytes of
channels, 16-byte loads and stores) and ``"scalar"`` for any other C (one
thread per output element forward, per full-resolution element backward).
Both write every output once, without atomics, bit-exact with the plain
version. :class:`VMaxPool` is the autograd pair of forward and backward.
Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from supernet_tpu_torch.ops.kernels import _lib

# Kernel launches in this process, forward and backward; chip_smoke.py zeroes
# and reads them to show that a path went through the kernels.
launches = 0
bwd_launches = 0


def _taps(x: torch.Tensor):
    """The four 2x2-window elements as quarter-size views, row-major."""
    b, h, w, c = x.shape
    r = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return r[:, :, 0, :, 0], r[:, :, 0, :, 1], r[:, :, 1, :, 0], r[:, :, 1, :, 1]


def vmaxpool_plain(
    mu: torch.Tensor, sigma: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PyTorch composition of the pool: ``(mx, so, idx)``.

    Mirrors ``ops/moments.py:_vmaxpool_fwd_impl``: odd H or W are padded at
    the bottom/right with ``finfo.min`` for mu and 0 for sigma; ties go to
    the first tap in row-major order; ``idx`` is the selected tap 0..3 in
    mu's dtype. ``torch.maximum`` propagates NaN, as ``jnp.maximum`` does.
    Every output is one of the inputs (or the padding), so computing in the
    input's dtype is the kernel's float32 compare of the same values.
    """
    b, h, w, c = mu.shape
    if h % 2 or w % 2:
        pad = (0, 0, 0, w % 2, 0, h % 2)
        mu = torch.nn.functional.pad(mu, pad, value=torch.finfo(mu.dtype).min)
        sigma = torch.nn.functional.pad(sigma, pad)
    m00, m01, m10, m11 = _taps(mu)
    s00, s01, s10, s11 = _taps(sigma)
    mx = torch.maximum(torch.maximum(m00, m01), torch.maximum(m10, m11))
    p0 = m00 == mx
    p1 = ~p0 & (m01 == mx)
    p2 = ~(p0 | p1) & (m10 == mx)
    so = torch.where(p0, s00, torch.where(p1, s01, torch.where(p2, s10, s11)))
    tap = torch.where(p0, 0, torch.where(p1, 1, torch.where(p2, 2, 3)))
    return mx, so, tap.to(mu.dtype)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """[B,h,w,C] -> [B,2h,2w,C] nearest-neighbour 2x."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def vmaxpool_bwd_plain(
    idx: torch.Tensor, g_mu: torch.Tensor, g_sigma: torch.Tensor, h: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch composition of the pool's backward: ``(d_mu, d_sigma)``, each
    [B,h,w,C]. Mirrors ``ops/moments.py:_vmaxpool_bwd``: the gradient and
    the tap index upsampled 2x, kept where the pixel's window parity
    ``2 * (y % 2) + (x % 2)`` equals the index, then cropped to (h, w)."""
    b, ho, wo, c = idx.shape
    par = torch.arange(2, dtype=idx.dtype, device=idx.device)
    tap = (2 * par[:, None] + par[None, :]).repeat(ho, wo)  # [2ho, 2wo]
    sel = _upsample2(idx) == tap[None, :, :, None]
    zero = torch.zeros((), dtype=g_mu.dtype, device=g_mu.device)
    d_mu = torch.where(sel, _upsample2(g_mu), zero)
    d_sigma = torch.where(sel, _upsample2(g_sigma), zero)
    return d_mu[:, :h, :w].contiguous(), d_sigma[:, :h, :w].contiguous()


THREADS = 256  # per block: the largest the kernels take, and the backward's
# the forward's vector path takes the largest of these block sizes that still
# gives every SM a block, else the smallest: on an H100 blocks of 64 beat
# blocks of 128 and 256 at every model pool, and blocks of 32 tie with them
# where 64 leaves SMs idle (chip_smoke.py's vmaxpool_blocks lines)
FWD_THREADS = (64, 32)


class FwdPlan(NamedTuple):
    """How one pool forward runs: ``path`` "vec" or "scalar", the channels
    one thread handles, the threads that do work (windows x C/channels, or
    output elements), the block size and the blocks that hold them."""

    path: str
    channels: int
    items: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=None)
def plan_fwd(b: int, h: int, w: int, c: int, itemsize: int = 4,
             sms: int = 132) -> FwdPlan:
    """The forward's kernel plan for mu [b,h,w,c] of ``itemsize``-byte
    elements (4 float32, 2 bf16) on a card of ``sms`` SMs, from the shape
    alone (no CUDA: the CPU tests call it). "vec" takes C a multiple of the
    16 / itemsize channels of one 16-byte load with fewer than 2^31
    threads, in blocks as large as :data:`FWD_THREADS` allows while every
    SM still gets one; a window at an odd bottom or right edge loads only
    the taps that lie inside h x w."""
    ho, wo = (h + 1) // 2, (w + 1) // 2
    v = 16 // itemsize
    if c % v == 0 and b * ho * wo * (c // v) < 2 ** 31:
        items = b * ho * wo * (c // v)
        threads = next((t for t in FWD_THREADS if -(-items // t) >= sms),
                       FWD_THREADS[-1])
        return FwdPlan("vec", v, items, threads, -(-items // threads))
    items = b * ho * wo * c
    return FwdPlan("scalar", 1, items, THREADS, -(-items // THREADS))


def _launch(mu, sigma, return_idx, plan=None):
    """The forward kernel on CUDA tensors; ``plan`` (default
    :func:`plan_fwd`'s) may name another path or block size, as the card's
    measurements of them do."""
    global launches
    if mu.dim() != 4:
        raise ValueError(f"vmaxpool: mu must be [B,H,W,C], got {tuple(mu.shape)}")
    _lib.check_input("vmaxpool", "mu", mu, mu.shape, _lib.MOMENT_DTYPES)
    _lib.check_input("vmaxpool", "sigma", sigma, mu.shape, (mu.dtype,))
    if sigma.device != mu.device:
        raise ValueError("vmaxpool: mu and sigma are on different devices")
    b, h, w, c = mu.shape
    out_shape = (b, (h + 1) // 2, (w + 1) // 2, c)
    mx = torch.empty(out_shape, device=mu.device, dtype=mu.dtype)
    so = torch.empty_like(mx)
    idx = torch.empty_like(mx) if return_idx else None
    if mx.numel():
        p = plan or plan_fwd(b, h, w, c, mu.element_size(), _lib.sm_count(mu.device))
        if p.path == "vec":
            mu, sigma = _lib.aligned(mu), _lib.aligned(sigma)
        lib = _lib.load()
        with torch.cuda.device(mu.device):
            err = lib.supernet_vmaxpool_fwd(
                mu.data_ptr(), sigma.data_ptr(), mx.data_ptr(), so.data_ptr(),
                idx.data_ptr() if idx is not None else None,
                b, h, w, c, int(p.path == "vec"), p.threads,
                _lib.dtype_code(mu.dtype),
                torch.cuda.current_stream(mu.device).cuda_stream,
            )
        _lib.check(err, f"vmaxpool kernel launch ({p.path})")
        launches += 1
    return (mx, so, idx) if return_idx else (mx, so)


def vmaxpool(mu: torch.Tensor, sigma: torch.Tensor, return_idx: bool = False):
    """2x2/stride-2 max of ``mu`` with ``sigma`` at the argmax:
    ``(mx, so)``, or ``(mx, so, idx)`` with ``return_idx``. No autograd:
    :class:`VMaxPool` is the differentiable form.

    CUDA tensors go to the kernel :func:`plan_fwd` picks (or raise); CPU
    tensors to :func:`vmaxpool_plain`. Any other device raises.
    """
    if mu.is_cuda:
        return _launch(mu, sigma, return_idx)
    if mu.device.type != "cpu":
        raise ValueError(f"vmaxpool: unsupported device {mu.device}")
    mx, so, idx = vmaxpool_plain(mu, sigma)
    return (mx, so, idx) if return_idx else (mx, so)


class BwdPlan(NamedTuple):
    """How one pool backward runs: ``path`` "vec4" or "scalar", the
    channels one thread handles, the threads that do work (windows x
    C/channels, or full-resolution elements) and the blocks of THREADS that
    hold them."""

    path: str
    channels: int
    items: int
    blocks: int


@functools.lru_cache(maxsize=None)
def plan_bwd(b: int, h: int, w: int, c: int, itemsize: int = 4) -> BwdPlan:
    """The backward's kernel plan for d_mu [b,h,w,c] of ``itemsize``-byte
    elements (4 float32, 2 bf16), from the shape alone (no CUDA: the CPU
    tests call it). "vec4" takes C a multiple of the 16 / itemsize channels
    of one 16-byte load with fewer than 2^31 threads; a window at an odd
    bottom or right edge writes only the taps that lie inside h x w."""
    ho, wo = (h + 1) // 2, (w + 1) // 2
    v = 16 // itemsize
    if c % v == 0 and b * ho * wo * (c // v) < 2 ** 31:
        items = b * ho * wo * (c // v)
        return BwdPlan("vec4", v, items, -(-items // THREADS))
    items = b * h * w * c
    return BwdPlan("scalar", 1, items, -(-items // THREADS))


def _launch_bwd(idx, g_mu, g_sigma, h, w):
    global bwd_launches
    if idx.dim() != 4:
        raise ValueError(f"vmaxpool_bwd: idx must be [B,h,w,C], got {tuple(idx.shape)}")
    b, ho, wo, c = idx.shape
    if (h + 1) // 2 != ho or (w + 1) // 2 != wo:
        raise ValueError(
            f"vmaxpool_bwd: output {h}x{w} does not pool to {ho}x{wo}"
        )
    _lib.check_input("vmaxpool_bwd", "idx", idx, idx.shape, _lib.MOMENT_DTYPES)
    for name, t in (("g_mu", g_mu), ("g_sigma", g_sigma)):
        _lib.check_input("vmaxpool_bwd", name, t, idx.shape, (idx.dtype,))
        if t.device != idx.device:
            raise ValueError("vmaxpool_bwd: inputs are on different devices")
    d_mu = torch.empty((b, h, w, c), device=idx.device, dtype=idx.dtype)
    d_sigma = torch.empty_like(d_mu)
    if d_mu.numel():
        p = plan_bwd(b, h, w, c, idx.element_size())
        if p.path == "vec4":
            idx, g_mu, g_sigma = (_lib.aligned(t) for t in (idx, g_mu, g_sigma))
        lib = _lib.load()
        with torch.cuda.device(idx.device):
            err = lib.supernet_vmaxpool_bwd(
                idx.data_ptr(), g_mu.data_ptr(), g_sigma.data_ptr(),
                d_mu.data_ptr(), d_sigma.data_ptr(), b, h, w, c,
                int(p.path == "vec4"), _lib.dtype_code(idx.dtype),
                torch.cuda.current_stream(idx.device).cuda_stream,
            )
        _lib.check(err, f"vmaxpool_bwd kernel launch ({p.path})")
        bwd_launches += 1
    return d_mu, d_sigma


def vmaxpool_bwd(
    idx: torch.Tensor, g_mu: torch.Tensor, g_sigma: torch.Tensor, h: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pool's backward: ``idx``, ``g_mu``, ``g_sigma`` [B,ceil(h/2),
    ceil(w/2),C] -> ``(d_mu, d_sigma)`` [B,h,w,C]: each full-resolution
    element takes its window's gradient where ``idx`` names its tap, else 0.
    The three inputs share one dtype, float32 or bf16, and so do the outputs.

    CUDA tensors go to the kernel :func:`plan_bwd` picks (or raise); CPU
    tensors to
    :func:`vmaxpool_bwd_plain`. Any other device raises.
    """
    if idx.is_cuda:
        return _launch_bwd(idx, g_mu, g_sigma, h, w)
    if idx.device.type != "cpu":
        raise ValueError(f"vmaxpool_bwd: unsupported device {idx.device}")
    return vmaxpool_bwd_plain(idx, g_mu, g_sigma, h, w)


class VMaxPool(torch.autograd.Function):
    """The moment max-pool with its gradient: forward :func:`vmaxpool`
    (keeping the tap index when a gradient is needed), backward
    :func:`vmaxpool_bwd`. Autograd of ``torch.maximum`` would split a tied
    gradient in half; this routes it to the first tap, as the reference
    does. The tap index is saved in the moments' dtype, as the JAX package
    saves it, and the gradients come back in it."""

    @staticmethod
    def forward(ctx, mu, sigma):
        if not any(ctx.needs_input_grad):
            return vmaxpool(mu, sigma)
        mx, so, idx = vmaxpool(mu, sigma, return_idx=True)
        ctx.save_for_backward(idx)
        ctx.hw = (mu.shape[1], mu.shape[2])
        return mx, so

    @staticmethod
    def backward(ctx, g_mu, g_sigma):
        (idx,) = ctx.saved_tensors
        return vmaxpool_bwd(idx, g_mu.contiguous(), g_sigma.contiguous(), *ctx.hw)
