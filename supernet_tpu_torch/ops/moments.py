"""VDP moment primitives in PyTorch: the 2-D set of
``supernet_tpu/ops/moments.py`` that the serving and training paths run,
with gradients.

Each primitive pushes the mean ``mu`` and the diagonal variance ``sigma`` of
the activations (both NHWC) through one network operation, with the same
algebra as the JAX module (see its docstring): every variance term of a
Bayesian conv is a convolution, because the kernel variance
``softplus(w_sigma)`` is one scalar per output channel.

Activation dtype (``set_act_dtype``): float32 by default, or bfloat16, the
JAX package's production mode. The casts sit where the JAX module's default
path puts them: ``_act`` on the moments entering a conv and on its outputs,
channel sums in float32 and cast back before the broadcast multiply, the
softmax head in float32. Weights stay float32; the casts' backward returns
their gradients in float32. The kernels compute in float32: a bf16 moment is
upcast at the kernel boundary and the outputs are cast back
(``supernet_tpu/ops/pallas/vdp_conv.py:466-477``), so the kernels' backward
sees float32 cotangents too.

Dispatch: every k > 1 conv goes through ``ops.kernels.vdp_conv.VDPConv``
and the max-pool through ``ops.kernels.pool.VMaxPool``, the autograd
Functions around the hand-written kernels (forward and backward). On CUDA
tensors those launch the kernels; on CPU tensors they run their plain
versions. The 1x1 head and the unpool conv are matrix products
(``torch.einsum``), as they are XLA ops in the JAX package; their gradients,
and those of the pads, crops, concatenations and the softmax, are PyTorch's
autograd, as they are XLA's AD in the JAX package.

Member axis (a deep ensemble's K members in one forward, the counterpart of
``jax.vmap`` over a stacked parameter tree): weights stacked along a leading
axis (``w_mu`` [K,k,k,Cin,Cout], ``w_sigma`` [K,Cout]) make every conv run
all K members, with the activations [K*B,H,W,C] member-major; the first
conv also takes [K,B,H,W,C], ``x.expand(K, *x.shape)`` for one batch that
every member reads. The kernels take the member axis in one launch; the 1x1
head and the unpool conv are member-batched matrix products; the pool, the
pads, crops, concatenations and the softmax see the member axis as part of
the batch.
"""

from __future__ import annotations

import os
import sys
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from supernet_tpu_torch.ops.kernels import pool as _pool
from supernet_tpu_torch.ops.kernels import vdp_conv as _vdp

Tensor = torch.Tensor
MomentPair = Tuple[Tensor, Tensor]

# "highest" is true float32 in every matrix product and convolution that
# PyTorch runs on the card (TF32 off); "high" and "default" allow TF32.
_MXU_PRECISION: str = "highest"


def set_mxu_precision(precision: str) -> None:
    """Set the float32 precision of PyTorch's own matmuls and convolutions
    on the card ('highest' | 'high' | 'default'). 'highest' turns TF32 off
    for both cuDNN and cuBLAS; the others turn it on. The hand-written
    kernels compute at float32 accuracy whatever the setting: vdp_conv by
    3xTF32 on the tensor cores (each operand split into two TF32 halves,
    three products summed in float32), the others in float32."""
    global _MXU_PRECISION
    if precision not in ("highest", "default", "high"):
        raise ValueError(f"unknown precision {precision!r}")
    _MXU_PRECISION = precision
    tf32 = precision != "highest"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def get_mxu_precision() -> str:
    return _MXU_PRECISION


# The inter-layer activation dtype (supernet_tpu/ops/moments.py:342).
_ACT_DTYPE: torch.dtype = torch.float32
_HALF = (torch.bfloat16, torch.float16)


def set_act_dtype(dtype: str) -> None:
    """Set the inter-layer activation dtype ('float32'|'f32'|'bfloat16'|'bf16')."""
    global _ACT_DTYPE
    if dtype in ("float32", "f32"):
        _ACT_DTYPE = torch.float32
    elif dtype in ("bfloat16", "bf16"):
        _ACT_DTYPE = torch.bfloat16
    else:
        raise ValueError(f"unknown activation dtype {dtype!r}")


def get_act_dtype() -> torch.dtype:
    return _ACT_DTYPE


def _act(x: Tensor) -> Tensor:
    """Cast an activation (or a weight entering a matmul) to the activation
    dtype; a no-op under float32. A float64 tensor (the gradient checks)
    keeps its dtype."""
    if x.dtype == torch.float64:
        return x
    return x.to(_ACT_DTYPE)


def _f32(x: Tensor) -> Tensor:
    """``x`` in float32 (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# SUPERNET_* knobs of the JAX package that the port has no counterpart for,
# with the reason apply_env_overrides gives on stderr.
_NO_KERNEL_SWITCH = (
    "has no counterpart: on a CUDA tensor the port always runs its "
    "hand-written kernels, on a CPU tensor their plain versions"
)
_AB_PATH = ("is not ported yet (ROADMAP.md, Queue 1: 'Remaining 2-D A/B "
            "paths'); the default lowering runs")
_UNMATCHED_ENV = {
    "SUPERNET_BACKEND": _NO_KERNEL_SWITCH,
    "SUPERNET_POOL": _NO_KERNEL_SWITCH,
    "SUPERNET_SIGMA_BWD": _NO_KERNEL_SWITCH,
    "SUPERNET_CONV_FOLD": _AB_PATH,
    "SUPERNET_GLUE_FOLD": _AB_PATH,
    "SUPERNET_WINSUM": _AB_PATH,
    "SUPERNET_SW_SCALE": _AB_PATH,
    "SUPERNET_CHANSUM": _AB_PATH,
    "SUPERNET_CONV2D": _AB_PATH,
}


def apply_env_overrides() -> None:
    """Apply the SUPERNET_* knobs (supernet_tpu/ops/moments.py:358):

    SUPERNET_ACT_DTYPE=float32|bfloat16   (inter-layer activation dtype)
    SUPERNET_PRECISION=highest|high|default (PyTorch's own f32 matmuls/convs)
    SUPERNET_CONV3D=conv                  (the 3-D conv lowering; 'im2col'
                                           raises: not ported yet)

    Every other knob of the JAX package that is set is named on stderr with
    the reason it does nothing here; none is ignored silently."""
    v = os.environ.get("SUPERNET_PRECISION")
    if v:
        set_mxu_precision(v)
    v = os.environ.get("SUPERNET_ACT_DTYPE")
    if v:
        set_act_dtype(v)
    v = os.environ.get("SUPERNET_CONV3D")
    if v:
        # late import: moments3d imports this module
        from supernet_tpu_torch.ops import moments3d

        moments3d.set_conv3d_impl(v)
    for name, why in _UNMATCHED_ENV.items():
        v = os.environ.get(name)
        if v:
            print(f"warning: {name}={v} {why}", file=sys.stderr)


def scale_sw(ws: Tensor, s_w: Tensor) -> Tensor:
    """``ws [..., 1] * s_w [Cout] -> [..., Cout]``: the per-output-channel
    variance scale shared by every vconv sigma term. Member-stacked ``s_w``
    [K, Cout] scales the K member blocks of ``ws`` [K*B, ..., 1] each by
    its own row."""
    if s_w.dim() == 2:
        k = s_w.shape[0]
        rows = s_w.view((k,) + (1,) * (ws.dim() - 1) + (-1,)).to(ws.dtype)
        return (ws.unflatten(0, (k, -1)) * rows).flatten(0, 1)
    return ws * s_w.to(ws.dtype)


def _w11(w_mu: Tensor) -> Tensor:
    """The [Cin, Cout] (stacked: [K, Cin, Cout]) matrix of a 1x1 kernel."""
    return w_mu[..., 0, 0, :, :]


def _fold(x: Tensor) -> Tensor:
    """Activations [K,B,...] as [K*B,...] (a copy only for a shared input);
    [K*B,...] passes through."""
    return x.flatten(0, 1) if x.dim() == 5 else x


def chan_sum(x: Tensor) -> Tensor:
    """Sum over the trailing channel axis -> [..., 1], in float32 (float64
    input keeps float64, for the gradient checks)."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    return x.sum(dim=-1, keepdim=True, dtype=dtype)


def _window_sum(x: Tensor, k: int) -> Tensor:
    """Sum of x over each k x k VALID window and over all input channels
    -> [B, H', W', 1]: the channel sum in float32, then the JAX module's
    shift lowering (per spatial axis, the k shifted views are added)."""
    s = chan_sum(x)
    for axis in (1, 2):
        n = s.shape[axis] - k + 1
        acc = s.narrow(axis, 0, n)
        for i in range(1, k):
            acc = acc + s.narrow(axis, i, n)
        s = acc
    return s.to(x.dtype)


def _einsum_1x1(x: Tensor, w: Tensor) -> Tensor:
    if w.dim() == 3:  # member-stacked [K, Cin, Cout]
        xs = x.unflatten(0, (w.shape[0], -1))
        return torch.einsum("kbhwc,kco->kbhwo", xs, w).flatten(0, 1)
    return torch.einsum("bhwc,co->bhwo", x, w)


def _kernel_conv(mu, sigma, w_mu, w_sigma, relu: bool) -> MomentPair:
    """The fused conv (kernel 1 on CUDA tensors): half-precision moments are
    upcast at the boundary and the outputs cast back to their dtype."""
    dt = mu.dtype
    if dt in _HALF:
        mu = mu.float()
        sigma = None if sigma is None else sigma.float()
    m, s = _vdp.VDPConv.apply(mu, sigma, w_mu, w_sigma, relu)
    return m.to(dt), s.to(dt)


def vconv_input(x: Tensor, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    """First VDP conv: deterministic input, Gaussian weights.

      mu_out    = conv(x, w_mu)                      (VALID)
      sigma_out = winsum(x^2) * softplus(w_sigma)
    """
    x = _act(x)
    if w_mu.shape[-3] == 1:
        x = _fold(x)
        w2 = _act(_w11(w_mu))
        # the 1-channel sum in float32, cast before the broadcast multiply
        t = _act(chan_sum(torch.square(_f32(x))))
        return _act(_einsum_1x1(x, w2)), scale_sw(t, F.softplus(w_sigma))
    return _kernel_conv(x, None, w_mu, w_sigma, False)


def vconv(mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    """Intermediate VDP conv: Gaussian input and Gaussian weights.

      mu_out    = conv(mu, w_mu)
      sigma_out = winsum(mu^2 + sigma) * softplus(w_sigma) + conv(sigma, w_mu^2)

    k == 1 (the softmax head) is two einsums and a channel sum.
    """
    mu, sigma = _act(mu), _act(sigma)
    if w_mu.shape[-3] == 1:
        w2 = _act(_w11(w_mu))
        t = _act(chan_sum(mu * mu + sigma))
        sigma_out = scale_sw(t, F.softplus(w_sigma)) + _einsum_1x1(sigma, w2 * w2)
        return _act(_einsum_1x1(mu, w2)), _act(sigma_out)
    return _kernel_conv(mu, sigma, w_mu, w_sigma, False)


def vconv_relu(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor
) -> MomentPair:
    """``vrelu(*vconv(...))``, the ReLU fused into the conv for k > 1."""
    if w_mu.shape[-3] == 1:
        return vrelu(*vconv(mu, sigma, w_mu, w_sigma))
    return _kernel_conv(_act(mu), _act(sigma), w_mu, w_sigma, True)


def vconv_input_relu(x: Tensor, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    """``vrelu(*vconv_input(...))``, fused the same way."""
    if w_mu.shape[-3] == 1:
        return vrelu(*vconv_input(x, w_mu, w_sigma))
    return _kernel_conv(_act(x), None, w_mu, w_sigma, True)


def vrelu(mu: Tensor, sigma: Tensor) -> MomentPair:
    """First-order Taylor ReLU with the strict mask ``mu > 0`` (TF's ReLU
    gradient is 0 at 0)."""
    mask = mu > 0
    return torch.where(mask, mu, 0.0), torch.where(mask, sigma, 0.0)


def vmaxpool(mu: Tensor, sigma: Tensor) -> MomentPair:
    """2x2/stride-2 max-pool of ``mu`` with ``sigma`` at the argmax;
    first-occurrence ties, in the gradient too; odd sizes padded with
    ``finfo.min``. Keeps its input's dtype: half-precision moments are
    upcast at the kernel boundary and the outputs cast back, which is exact
    (the TPU kernel loads bf16, selects in float32 and stores bf16)."""
    dt = mu.dtype
    if dt in _HALF:
        mu, sigma = mu.float(), sigma.float()
    m, s = _pool.VMaxPool.apply(mu, sigma)
    return m.to(dt), s.to(dt)


def _upsample2_nearest(x: Tensor) -> Tensor:
    """[B,h,w,C] -> [B,2h,2w,C] nearest-neighbour 2x."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _unpool_conv(x: Tensor, w: Tensor) -> Tensor:
    """Zero-interleave 2x upsample (1-px border) + 2x2 VALID conv.

    The interleave puts x[i, j] at (2i+1, 2j+1), so every output pixel sees
    exactly one input pixel: ``out[2i+p, 2j+q] = x[i, j] @ w[1-p, 1-q]``.
    That is one matrix product against the flipped kernel, then a pixel
    shuffle.
    """
    b, h, wd, _ = x.shape
    if w.dim() == 5:  # member-stacked [K, 2, 2, Cin, Cout]
        xs = x.unflatten(0, (w.shape[0], -1))
        y = torch.einsum("kbhwc,kpqco->kbhpwqo", xs, w.flip(1, 2).to(x.dtype))
        return y.reshape(b, 2 * h, 2 * wd, w.shape[-1])
    y = torch.einsum("bhwc,pqco->bhpwqo", x, w.flip(0, 1).to(x.dtype))
    return y.reshape(b, 2 * h, 2 * wd, w.shape[-1])


def _unpool_one(x: Tensor) -> Tensor:
    """Zero-interleaved 2x upsample with a 1-px border: [B,H,W,C] ->
    [B,2H+1,2W+1,C], the input values landing at the odd indices (the JAX
    module's ``lax.pad`` with lo=1, hi=1, interior=1)."""
    b, h, w, c = x.shape
    out = x.new_zeros((b, 2 * h + 1, 2 * w + 1, c))
    out[:, 1::2, 1::2] = x
    return out


def vunpool(mu: Tensor, sigma: Tensor) -> MomentPair:
    """The zero-interleave upsample applied to both moments (unfused; the
    decoder runs :func:`vunpool_conv2`)."""
    return _unpool_one(mu), _unpool_one(sigma)


def vunpool_conv2(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor
) -> MomentPair:
    """Fused ``vunpool`` + 2x2 VALID ``vconv`` (the decoder's first pair).
    The 2x2 window sum of the interleaved (mu^2 + sigma) sees one nonzero
    pixel per window, so it is the channel sum upsampled 2x."""
    mu, sigma = _act(mu), _act(sigma)
    # the [B,h,w,1] channel sum in float32, cast back before the broadcast
    t_up = _upsample2_nearest(_act(chan_sum(mu * mu + sigma)))
    mu_out = _unpool_conv(mu, w_mu)
    sigma_out = scale_sw(t_up, F.softplus(w_sigma)) + _unpool_conv(sigma, w_mu * w_mu)
    return mu_out, _act(sigma_out)


def vpad(
    mu: Tensor,
    sigma: Tensor,
    pad_size: Sequence[int] = (2, 2),
    sigma_fill: float = 0.0,
) -> MomentPair:
    """Pad both spatial dims by ``(lo, hi)``: mu with zeros, sigma with
    ``sigma_fill`` (the pseudo-variance of invented pixels)."""
    lo, hi = int(pad_size[0]), int(pad_size[1])
    pad = (0, 0, lo, hi, lo, hi)
    return F.pad(mu, pad), F.pad(sigma, pad, value=sigma_fill)


def crop_center(x: Tensor, target_h: int, target_w: int) -> Tensor:
    """Center-crop the spatial dims of an NHWC tensor, offsets
    ``(H - h) // 2``."""
    oh = (x.shape[1] - target_h) // 2
    ow = (x.shape[2] - target_w) // 2
    return x[:, oh : oh + target_h, ow : ow + target_w]


def crop_to_match(x: Tensor, like: Tensor) -> Tensor:
    """Center-crop ``x`` to the spatial shape of ``like``."""
    return crop_center(x, like.shape[1], like.shape[2])


def vcrop_concat(
    mu_dec: Tensor, sigma_dec: Tensor, mu_enc: Tensor, sigma_enc: Tensor
) -> MomentPair:
    """Skip connection: center-crop the encoder moments to the decoder's
    size and concatenate on channels, decoder channels first."""
    return (
        torch.cat([mu_dec, crop_to_match(mu_enc, mu_dec)], dim=-1),
        torch.cat([sigma_dec, crop_to_match(sigma_enc, sigma_dec)], dim=-1),
    )


def vsoftmax(mu: Tensor, sigma: Tensor) -> MomentPair:
    """Pixel-wise softmax with the variance pushed through its Jacobian, in
    closed form and float32:

        sigma_out_c = p_c^2 * ((1 - 2 p_c) * sigma_c + sum_j p_j^2 sigma_j)

    Outputs are flattened to [B, H*W, C]; the batch dim is never squeezed.
    """
    b, h, w, c = mu.shape
    mu_flat = mu.reshape(b, h * w, c).float()
    sigma_flat = sigma.reshape(b, h * w, c).float()
    p = torch.softmax(mu_flat, dim=-1)
    p_sq = p * p
    s_tot = (p_sq * sigma_flat).sum(dim=-1, keepdim=True)
    return p, p_sq * ((1.0 - 2.0 * p) * sigma_flat + s_tot)
