"""Fused VDP convolution: the CUDA kernel, its plain version and its
autograd backward.

Counterpart of ``supernet_tpu/ops/pallas/vdp_conv.py``. One call computes,
VALID and stride 1:

    mu_out  = conv(mu, w_mu)
    win     = k x k window sum of sum_c(mu^2 + sigma)     (sum_c x^2 when sigma is None)
    sig_out = win * softplus(w_sigma) + conv(sigma, w_mu^2)
    [optional ReLU: where mu_out > 0 is false, both outputs are 0]

and returns ``(mu_out, sig_out, win)``; ``win`` [B,H',W',1] is the backward
residual. The kernels are ``csrc/vdp_conv.cu``: a 3xTF32 implicit GEMM on
the tensor cores (wgmma), with split-K for the layers whose output tiles
alone do not fill the card, and a CUDA-core kernel for the other shapes.
:func:`plan` picks the path, the tile and the number of K slices from the
shape alone. :func:`vdp_conv` launches the planned kernel for CUDA tensors
and takes :func:`vdp_conv_plain` only for CPU tensors.
:class:`VDPConv` is the differentiable form: its backward is the JAX
package's hand-derived VJP (``_bwd_common``), with the window-sum term
through the sigma-chain kernel (``ops/kernels/sigma_bwd.py``) and the
transposed and filter-gradient convolutions as PyTorch ops, as they are XLA
convolutions in the JAX package. Layouts are the JAX package's: NHWC
activations, HWIO ``w_mu`` [k,k,Cin,Cout] and the raw (pre-softplus)
``w_sigma`` [Cout].
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from supernet_tpu_torch.ops.kernels import _lib
from supernet_tpu_torch.ops.kernels.sigma_bwd import winsum_spread_bwd

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# Kernel launches in this process; chip_smoke.py zeroes and reads them to
# show that a path went through the kernels. `launches` counts calls of the
# op (one main kernel each), `reduce_launches` the split-K reduce kernel.
launches = 0
reduce_launches = 0

# The planner's constants: the card's SM count (H100 SXM), the tensor-core
# kernel's output pixels per block (wgmma's M) and input channels per K
# step, and the caps on the number of K slices and on their scratch.
SMS = 132
TC_TILE_M = 64
TC_CHUNK = 8
MAX_SPLITS = 16
MAX_SCRATCH_BYTES = 64 << 20
_PATH_ID = {"simt": 0, "wgmma": 1}


class Plan(NamedTuple):
    """How one vdp_conv call runs: ``path`` "wgmma" (tensor cores) or
    "simt" (CUDA cores), output pixels x channels per block, K slices, the
    main launch's blocks (slices included) and the split-K scratch."""

    path: str
    tile_m: int
    tile_n: int
    splits: int
    blocks: int
    scratch_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, cin: int, cout: int, k: int) -> Plan:
    """The kernel plan for mu [b,h,w,cin] and w_mu [k,k,cin,cout], from the
    shape alone (no CUDA: the CPU tests call it).

    The tensor-core path takes k = 3 with Cin % 8 == 0 (its K steps are 8
    channels of one tap), Cout % 4 == 0 (16-byte weight copies) and step
    offsets that fit an int (9 Cin Cout and 3 W Cin below 2^31): N = 32
    for Cout <= 32, else 64, and 64 output pixels (one warpgroup) per block.
    Its blocks are M tiles x N tiles; where they are fewer than the SMs,
    the Cin/8 chunks are cut into the fewest slices S (a divisor of the
    chunks) that fill one wave, at most MAX_SPLITS and within
    MAX_SCRATCH_BYTES, and a reduce kernel sums them. Everything else takes
    the CUDA-core kernel (CT = 64 output channels per block for Cout >= 64,
    else 32; tiles of 8x8 or 8x16 pixels of one image)."""
    ho, wo = h - k + 1, w - k + 1
    m = b * ho * wo
    if (k == 3 and cin % TC_CHUNK == 0 and cout % 4 == 0
            and 9 * cin * cout < 2 ** 31 and 3 * w * cin < 2 ** 31):
        tile_n = 32 if cout <= 32 else 64
        tiles = _cdiv(m, TC_TILE_M) * _cdiv(cout, tile_n)
        chunks = cin // TC_CHUNK

        def scratch(s: int) -> int:
            return 0 if s == 1 else 4 * s * m * (2 * cout + 1)

        splits = 1
        for s in range(1, min(chunks, MAX_SPLITS) + 1):
            if chunks % s or scratch(s) > MAX_SCRATCH_BYTES:
                continue
            splits = s
            if tiles * s >= SMS:
                break
        return Plan("wgmma", TC_TILE_M, tile_n, splits, tiles * splits,
                    scratch(splits))
    ct = 64 if cout >= 64 else 32
    tw = 8 if ct == 64 else 16
    th = 8
    blocks = _cdiv(ho, th) * _cdiv(wo, tw) * _cdiv(cout, ct) * b
    return Plan("simt", th * tw, ct, 1, blocks, 0)


def _conv_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID cross-correlation, NHWC x HWIO -> NHWC. The NHWC tensor
    permuted to NCHW is a channels_last tensor, so no copy is made."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def vdp_conv_plain(
    mu: torch.Tensor,
    sigma: Optional[torch.Tensor],
    w_mu: torch.Tensor,
    w_sigma: torch.Tensor,
    fuse_relu: bool = False,
) -> Triple:
    """PyTorch composition of the fused conv (the XLA path of
    ``ops/moments.py:vconv``/``vconv_input``, plus ``win``)."""
    # imported here: ops.moments imports this module
    from supernet_tpu_torch.ops.moments import _window_sum

    k = w_mu.shape[0]
    mu_out = _conv_valid(mu, w_mu)
    t = mu * mu if sigma is None else mu * mu + sigma
    win = _window_sum(t, k)
    sig_out = win * F.softplus(w_sigma)
    if sigma is not None:
        sig_out = sig_out + _conv_valid(sigma, w_mu * w_mu)
    if fuse_relu:
        mask = mu_out > 0
        mu_out = torch.where(mask, mu_out, 0.0)
        sig_out = torch.where(mask, sig_out, 0.0)
    return mu_out.contiguous(), sig_out.contiguous(), win.contiguous()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, copied if its data does not start on 16 bytes (a contiguous
    view into a larger tensor may not): the tensor-core kernel moves 16-byte
    pieces."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def _launch(mu, sigma, w_mu, w_sigma, fuse_relu) -> Triple:
    global launches, reduce_launches
    if mu.dim() != 4 or w_mu.dim() != 4:
        raise ValueError(
            f"vdp_conv: expected mu [B,H,W,Cin] and w_mu [k,k,Cin,Cout], got "
            f"{tuple(mu.shape)} and {tuple(w_mu.shape)}"
        )
    b, h, w, cin = mu.shape
    k, cout = w_mu.shape[0], w_mu.shape[3]
    _lib.check_input("vdp_conv", "mu", mu, mu.shape)
    if sigma is not None:
        _lib.check_input("vdp_conv", "sigma", sigma, mu.shape)
    _lib.check_input("vdp_conv", "w_mu", w_mu, (k, k, cin, cout))
    _lib.check_input("vdp_conv", "w_sigma", w_sigma, (cout,))
    tensors = [mu, w_mu, w_sigma] + ([sigma] if sigma is not None else [])
    if any(t.device != mu.device for t in tensors):
        raise ValueError("vdp_conv: inputs are on different devices")
    if not (1 <= k <= min(h, w)) or cin < 1 or cout < 1 or b > 65535:
        raise ValueError(
            f"vdp_conv: unsupported sizes B={b} H={h} W={w} Cin={cin} "
            f"Cout={cout} k={k}"
        )
    ho, wo = h - k + 1, w - k + 1
    mu_out = torch.empty((b, ho, wo, cout), device=mu.device, dtype=torch.float32)
    sig_out = torch.empty_like(mu_out)
    win = torch.empty((b, ho, wo, 1), device=mu.device, dtype=torch.float32)
    if b == 0:
        return mu_out, sig_out, win
    p = plan(b, h, w, cin, cout, k)
    sw = F.softplus(w_sigma).contiguous()
    scratch = None
    if p.path == "wgmma":
        mu, sigma, w_mu, sw = (_aligned(t) for t in (mu, sigma, w_mu, sw))
        if p.splits > 1:
            scratch = torch.empty(p.scratch_bytes // 4, device=mu.device,
                                  dtype=torch.float32)
    lib = _lib.load()
    with torch.cuda.device(mu.device):
        err = lib.supernet_vdp_conv_fwd(
            mu.data_ptr(),
            sigma.data_ptr() if sigma is not None else None,
            w_mu.data_ptr(), sw.data_ptr(),
            mu_out.data_ptr(), sig_out.data_ptr(), win.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, h, w, cin, cout, k, int(fuse_relu),
            _PATH_ID[p.path], p.tile_n, p.splits,
            torch.cuda.current_stream(mu.device).cuda_stream,
        )
    _lib.check(err, f"vdp_conv kernel launch ({p.path}, {p.splits} K slices)")
    launches += 1
    if p.splits > 1:
        reduce_launches += 1
    return mu_out, sig_out, win


def vdp_conv(
    mu: torch.Tensor,
    sigma: Optional[torch.Tensor],
    w_mu: torch.Tensor,
    w_sigma: torch.Tensor,
    fuse_relu: bool = False,
) -> Triple:
    """Fused VDP conv (+ optional ReLU) -> ``(mu_out, sig_out, win)``.
    ``sigma=None`` is the deterministic-input form (the first layer).

    CUDA tensors go to the kernel (or raise); CPU tensors to
    :func:`vdp_conv_plain`. Any other device raises.
    """
    if mu.is_cuda:
        return _launch(mu, sigma, w_mu, w_sigma, fuse_relu)
    if mu.device.type != "cpu":
        raise ValueError(f"vdp_conv: unsupported device {mu.device}")
    return vdp_conv_plain(mu, sigma, w_mu, w_sigma, fuse_relu)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _conv_t(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`_conv_valid`: the full transposed conv of
    ``g`` [B,H',W',Cout] with HWIO ``w`` -> [B,H,W,Cin]."""
    return F.conv_transpose2d(_nchw(g), _oihw(w)).permute(0, 2, 3, 1)


def _filter_grad(x: torch.Tensor, g: torch.Tensor, w_shape) -> torch.Tensor:
    """Weight gradient of :func:`_conv_valid` -> HWIO [k,k,Cin,Cout]."""
    k, _, cin, cout = w_shape
    dw = torch.nn.grad.conv2d_weight(_nchw(x), (cout, cin, k, k), _nchw(g))
    return dw.permute(2, 3, 1, 0)


class VDPConv(torch.autograd.Function):
    """The fused VDP conv (+ optional ReLU) with its gradient: ``apply(mu,
    sigma, w_mu, w_sigma, fuse_relu) -> (mu_out, sig_out)``, ``sigma`` None
    for the deterministic first layer.

    Forward: :func:`vdp_conv`. Backward, after
    ``supernet_tpu/ops/pallas/vdp_conv.py:_bwd_common``:

        g1, g2  = the cotangents of mu_out, sig_out, masked by mu_out > 0 with the ReLU
        u, d_sw = winsum_spread_bwd(g2, win, softplus(w_sigma))     (kernel 4)
        d_mu    = convT(g1, w_mu) + 2 mu u
        d_sigma = u + convT(g2, w_mu^2)
        d_w_mu  = filter_grad(mu, g1) + 2 w_mu filter_grad(sigma, g2)
        d_w_sig = d_sw * sigmoid(w_sigma)
    """

    @staticmethod
    def forward(ctx, mu, sigma, w_mu, w_sigma, fuse_relu):
        mu_out, sig_out, win = vdp_conv(mu, sigma, w_mu, w_sigma, fuse_relu)
        ctx.fuse_relu = fuse_relu
        ctx.save_for_backward(mu, sigma, w_mu, w_sigma, win, mu_out)
        return mu_out, sig_out

    @staticmethod
    def backward(ctx, g1, g2):
        mu, sigma, w_mu, w_sigma, win, mu_out = ctx.saved_tensors
        need_mu, need_sigma, need_w, need_ws, _ = ctx.needs_input_grad
        if ctx.fuse_relu:
            mask = mu_out > 0
            g1 = torch.where(mask, g1, 0.0)
            g2 = torch.where(mask, g2, 0.0)
        g2 = g2.contiguous()
        k = w_mu.shape[0]
        b, ho, wo, _ = mu_out.shape
        u, d_sw = winsum_spread_bwd(
            g2, win.reshape(b, ho, wo), F.softplus(w_sigma).contiguous(), k
        )
        g_win = u[..., None]
        d_mu = d_sigma = d_w = d_ws = None
        if need_mu:
            d_mu = _conv_t(g1, w_mu) + 2.0 * mu * g_win
        if need_sigma:
            d_sigma = g_win + _conv_t(g2, w_mu * w_mu)
        if need_w:
            d_w = _filter_grad(mu, g1, w_mu.shape)
            if sigma is not None:
                d_w = d_w + 2.0 * w_mu * _filter_grad(sigma, g2, w_mu.shape)
        if need_ws:
            d_ws = d_sw * torch.sigmoid(w_sigma)
        return d_mu, d_sigma, d_w, d_ws, None
