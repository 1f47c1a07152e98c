"""Sigma-chain backward of the fused VDP conv: the CUDA kernel and its plain
version.

Counterpart of ``supernet_tpu/ops/pallas/sigma_bwd.py:_bwd_call``. The
variance output of a VDP conv holds the term ``win[..., None] * s_w`` (``win``
the k x k window sum of the channel-summed source, ``s_w =
softplus(w_sigma)``). Given its cotangent ``g`` [B,H',W',C], one pass gives

    u   = spread_k(sum_c g * s_w)     [B,H'+k-1,W'+k-1]  (the cotangent of the source)
    dsw = sum_{b,h',w'} g * win       [C]                (the cotangent of s_w)

where ``spread_k`` is the transposed k x k ones convolution. The kernel is
``csrc/sigma_bwd.cu``; it writes one ``dsw`` partial per block, which
``torch.sum`` reduces here, as the TPU path sums its per-image partials
outside the kernel. :func:`winsum_spread_bwd` launches it for CUDA tensors
and takes :func:`winsum_spread_bwd_plain` only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from supernet_tpu_torch.ops.kernels import _lib

# Kernel launches in this process; chip_smoke.py zeroes and reads it to show
# that the training path went through the kernel.
launches = 0

# u rows per block: a block recomputes k-1 halo rows of dt, so fewer rows
# cost more re-reads of g and more rows give fewer blocks for the SMs.
ROWS = 8


def winsum_spread_bwd_plain(
    g: torch.Tensor, t: torch.Tensor, s_w: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch composition: ``(u, dsw)`` as in the module docstring."""
    dt = (g * s_w).sum(dim=-1)
    ones = torch.ones((1, 1, k, k), dtype=g.dtype, device=g.device)
    u = F.conv_transpose2d(dt[:, None], ones)[:, 0]
    dsw = (g * t[..., None]).sum(dim=(0, 1, 2))
    return u.contiguous(), dsw


def _launch(g, t, s_w, k):
    global launches
    if g.dim() != 4:
        raise ValueError(f"winsum_spread_bwd: g must be [B,H',W',C], got {tuple(g.shape)}")
    b, hp, wp, c = g.shape
    _lib.check_input("winsum_spread_bwd", "g", g, g.shape)
    _lib.check_input("winsum_spread_bwd", "t", t, (b, hp, wp))
    _lib.check_input("winsum_spread_bwd", "s_w", s_w, (c,))
    if t.device != g.device or s_w.device != g.device:
        raise ValueError("winsum_spread_bwd: inputs are on different devices")
    if k < 1 or c < 1 or min(hp, wp) < 1:
        raise ValueError(f"winsum_spread_bwd: unsupported sizes {tuple(g.shape)}, k={k}")
    h, w = hp + k - 1, wp + k - 1
    tiles = -(-h // ROWS)
    u = torch.empty((b, h, w), device=g.device, dtype=torch.float32)
    part = torch.empty((b * tiles, c), device=g.device, dtype=torch.float32)
    if b == 0:
        return u, part.sum(dim=0)
    lib = _lib.load()
    with torch.cuda.device(g.device):
        err = lib.supernet_sigma_bwd(
            g.data_ptr(), t.data_ptr(), s_w.data_ptr(), u.data_ptr(),
            part.data_ptr(), b, hp, wp, c, k, ROWS,
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    _lib.check(err, "winsum_spread_bwd kernel launch")
    launches += 1
    return u, part.sum(dim=0)


def winsum_spread_bwd(
    g: torch.Tensor, t: torch.Tensor, s_w: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u, dsw)`` from ``g`` [B,H',W',C], ``t`` [B,H',W'] (the forward's
    ``win``) and ``s_w`` [C].

    CUDA tensors go to the kernel (or raise); CPU tensors to
    :func:`winsum_spread_bwd_plain`. Any other device raises.
    """
    if g.is_cuda:
        return _launch(g, t, s_w, k)
    if g.device.type != "cpu":
        raise ValueError(f"winsum_spread_bwd: unsupported device {g.device}")
    return winsum_spread_bwd_plain(g, t, s_w, k)
