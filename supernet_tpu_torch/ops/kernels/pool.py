"""Moment max-pool (2x2, stride 2): the CUDA kernel and its plain version.

Counterpart of ``supernet_tpu/ops/pallas/pool.py`` (forward only; the
backward kernel comes with the training slice). The kernel is
``csrc/pool.cu``. :func:`vmaxpool` launches it for CUDA tensors and takes
:func:`vmaxpool_plain` only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from supernet_tpu_torch.ops.kernels import _lib

# Kernel launches in this process; chip_smoke.py zeroes and reads it to show
# that the serving path went through the kernel.
launches = 0


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


def _launch(mu, sigma, return_idx):
    global launches
    if mu.dim() != 4:
        raise ValueError(f"vmaxpool: mu must be [B,H,W,C], got {tuple(mu.shape)}")
    _lib.check_input("vmaxpool", "mu", mu, mu.shape)
    _lib.check_input("vmaxpool", "sigma", sigma, mu.shape)
    if sigma.device != mu.device:
        raise ValueError("vmaxpool: mu and sigma are on different devices")
    if torch.is_grad_enabled() and (mu.requires_grad or sigma.requires_grad):
        raise RuntimeError(
            "vmaxpool: the CUDA kernel has no backward yet; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    b, h, w, c = mu.shape
    out_shape = (b, (h + 1) // 2, (w + 1) // 2, c)
    mx = torch.empty(out_shape, device=mu.device, dtype=torch.float32)
    so = torch.empty_like(mx)
    idx = torch.empty_like(mx) if return_idx else None
    if mx.numel():
        lib = _lib.load()
        with torch.cuda.device(mu.device):
            err = lib.supernet_vmaxpool_fwd(
                mu.data_ptr(), sigma.data_ptr(), mx.data_ptr(), so.data_ptr(),
                idx.data_ptr() if idx is not None else None,
                b, h, w, c, torch.cuda.current_stream(mu.device).cuda_stream,
            )
        _lib.check(err, "vmaxpool kernel launch")
        launches += 1
    return (mx, so, idx) if return_idx else (mx, so)


def vmaxpool(mu: torch.Tensor, sigma: torch.Tensor, return_idx: bool = False):
    """2x2/stride-2 max of ``mu`` with ``sigma`` at the argmax:
    ``(mx, so)``, or ``(mx, so, idx)`` with ``return_idx``.

    CUDA tensors go to the kernel (or raise); CPU tensors to
    :func:`vmaxpool_plain`. Any other device raises.
    """
    if mu.is_cuda:
        return _launch(mu, sigma, return_idx)
    if mu.device.type != "cpu":
        raise ValueError(f"vmaxpool: unsupported device {mu.device}")
    mx, so, idx = vmaxpool_plain(mu, sigma)
    return (mx, so, idx) if return_idx else (mx, so)
