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
their gradients in float32. The kernels take bf16 moments as they are, as
the TPU kernels take them: they load bf16, compute in float32 and store bf16
(kernel 1 keeps its window-sum residual in float32), so no cast stands
between a moment op and its kernel, forward or backward. Where the JAX
package casts around kernel 1 (``supernet_tpu/ops/pallas/vdp_conv.py:
466-477``), the kernel's rounding at its store and ``VDPConv``'s rounding of
each input gradient are the same roundings. float16, which no mode
produces, is still upcast at the kernel boundary and cast back.

Dispatch: every stride-1 k > 1 conv goes through
``ops.kernels.vdp_conv.VDPConv`` and the max-pool through
``ops.kernels.pool.VMaxPool``, the autograd Functions around the
hand-written kernels (forward and backward). On CUDA tensors those launch
the kernels; on CPU tensors they run their plain versions. The 1x1 head and
the unpool conv are matrix products (``torch.einsum``), as they are XLA ops
in the JAX package; their gradients, and those of the pads, crops,
concatenations and the softmax, are PyTorch's autograd, as they are XLA's
AD in the JAX package. ``set_backend("naive")`` leaves the kernels: the five
ops the JAX package's naive backend routes run the reference's patch-matmul
algorithm (``ops/naive.py``) on any device.

One lowering per device: a stride-1 k > 1 conv takes ``VDPConv`` (kernel 1
on a CUDA tensor, its plain version on a CPU tensor); a conv of stride > 1
runs the JAX module's default XLA composition on both (a VALID conv, the
window sum by shifted adds, a broadcast multiply by ``s_w``). The JAX
package's A/B lowering switches have no counterpart here
(:func:`apply_env_overrides` names them and ignores them). The decoder glue
fold (``set_glue_fold``, :func:`vglue_conv_relu`) is the models' choice; its
convs are PyTorch's on every device, as they are XLA's on every backend in
the JAX package.

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

import contextlib
import os
import sys
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from supernet_tpu_torch.ops import naive
from supernet_tpu_torch.ops.kernels import pool as _pool
from supernet_tpu_torch.ops.kernels import vdp_conv as _vdp

Tensor = torch.Tensor
MomentPair = Tuple[Tensor, Tensor]

# The precision of the moment convolutions (supernet_tpu/ops/moments.py:58-
# 70): "highest" is true float32 in kernel 1 and in every matrix product and
# convolution that PyTorch runs on the card (TF32 off); "high" keeps kernel 1
# at float32 accuracy and allows TF32 in PyTorch's own; "default" runs kernel
# 1 in one bf16 pass and allows TF32 in PyTorch's own.
_MXU_PRECISION: str = "highest"


def set_mxu_precision(precision: str) -> None:
    """Set the precision of the moment convolutions ('highest' | 'high' |
    'default'), as the JAX package's global reaches its Pallas conv's dots.

    Kernel 1 (``VDPConv``, forward and transposed pair; each call reads the
    global once): under 'default' one bf16 pass, each product's operands
    rounded to bf16 and the sums in float32, as the TPU's MXU computes a
    DEFAULT dot; under 'high' and 'highest' float32 accuracy, 3xTF32 on the
    tensor cores (each operand split into two TF32 halves, three products
    summed in float32), as Mosaic rounds 'high' up to 'highest'. Its plain
    version on a CPU tensor rounds alike. PyTorch's own matmuls and
    convolutions on the card (cuDNN's filter gradients among them): 'highest'
    turns TF32 off for both cuDNN and cuBLAS, the others turn it on. The
    other hand-written kernels compute in float32 whatever the setting."""
    global _MXU_PRECISION
    if precision not in _vdp.PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    _MXU_PRECISION = precision
    tf32 = precision != "highest"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def get_mxu_precision() -> str:
    return _MXU_PRECISION


# The inter-layer activation dtype (supernet_tpu/ops/moments.py:342).
_ACT_DTYPE: torch.dtype = torch.float32
# the half-precision dtypes the kernels do not take (bf16 they do): upcast at
# the kernel boundary and cast back
_HALF = (torch.float16,)


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


# The decoder glue fold of the JAX package (supernet_tpu/ops/moments.py:
# 209-229), with its default: "none" | "fold", the decoder's pad ->
# [crop-concat ->] conv -> relu computed inside the convs (vglue_conv_relu;
# dispatched by models/unet.py and models/unet3d.py).
_GLUE_FOLD: str = "none"


def set_glue_fold(mode: str) -> None:
    global _GLUE_FOLD
    if mode not in ("none", "fold"):
        raise ValueError(f"unknown glue fold mode {mode!r}")
    _GLUE_FOLD = mode


def get_glue_fold() -> str:
    return _GLUE_FOLD


@contextlib.contextmanager
def lowering(glue_fold: str | None = None):
    """Run the block under ``glue_fold`` ("none" | "fold"; None keeps the
    current mode), then restore the mode it found."""
    global _GLUE_FOLD
    before = _GLUE_FOLD
    try:
        if glue_fold is not None:
            set_glue_fold(glue_fold)
        yield
    finally:
        _GLUE_FOLD = before


# The op backend (supernet_tpu/ops/moments.py:76-93). "kernels", the port's
# one path: the hand-written kernels on a CUDA tensor, their plain versions
# on a CPU tensor. "naive": the reference's patch-matmul algorithm
# (ops/naive.py) for the five ops the JAX package routes to it, on any
# device, with autograd through the plain tensor ops; the models then ignore
# the glue fold. A measured same-hardware baseline for the benchmark, never
# a production path.
_BACKEND: str = "kernels"


def set_backend(backend: str) -> None:
    if backend not in ("kernels", "naive"):
        raise ValueError(f"unknown backend {backend!r}")
    global _BACKEND
    _BACKEND = backend


def get_backend() -> str:
    return _BACKEND


def glue_fold_active() -> bool:
    """True when the models compute the decoder glue inside the convs: the
    fold is set and the backend is not naive (supernet_tpu/models/unet.py:170)."""
    return _GLUE_FOLD == "fold" and _BACKEND != "naive"


def _promoted(*ts):
    """The naive path's operands in their promoted dtype, as the JAX naive
    ops see a bf16 moment against float32 weights."""
    dt = torch.float32
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


# The JAX package's other kernel switches and its xla | pallas | auto
# backends have no counterpart: the port always runs its hand-written
# kernels on a CUDA tensor. Nor have its A/B lowering switches: the port
# runs one lowering per device.
_NO_COUNTERPART = ("has no counterpart: on a CUDA tensor the port always runs its "
                   "hand-written kernels, on a CPU tensor their plain versions")
_ONE_LOWERING = ("has no counterpart: the port runs one lowering per device, and the "
                 "JAX package's XLA lowering that it selects is not ported")
_UNMATCHED_ENV = {
    **{name: _NO_COUNTERPART for name in ("SUPERNET_POOL", "SUPERNET_SIGMA_BWD")},
    **{name: _ONE_LOWERING for name in (
        "SUPERNET_CONV_FOLD", "SUPERNET_WINSUM", "SUPERNET_SW_SCALE", "SUPERNET_CHANSUM",
        "SUPERNET_CONV2D", "SUPERNET_CONV3D")},
}


def apply_env_overrides() -> None:
    """Apply the SUPERNET_* knobs (supernet_tpu/ops/moments.py:359-416):

    SUPERNET_PRECISION=highest|high|default   (kernel 1, PyTorch's f32 matmuls/convs)
    SUPERNET_ACT_DTYPE=float32|bfloat16       (inter-layer activation dtype)
    SUPERNET_GLUE_FOLD=none|fold              (the decoder glue fold)

    SUPERNET_BACKEND=naive|kernels            (the reference's patch-matmul ops)

    SUPERNET_BACKEND=xla|pallas|auto, SUPERNET_POOL, SUPERNET_SIGMA_BWD and
    the lowering switches SUPERNET_CONV_FOLD, SUPERNET_WINSUM,
    SUPERNET_SW_SCALE, SUPERNET_CHANSUM, SUPERNET_CONV2D and SUPERNET_CONV3D,
    when set, are named on stderr with the reason they do nothing here."""
    setters = (
        ("SUPERNET_PRECISION", set_mxu_precision),
        ("SUPERNET_ACT_DTYPE", set_act_dtype),
        ("SUPERNET_GLUE_FOLD", set_glue_fold),
    )
    for name, setter in setters:
        v = os.environ.get(name)
        if v:
            setter(v)
    v = os.environ.get("SUPERNET_BACKEND")
    if v in ("xla", "pallas", "auto"):
        print(f"warning: SUPERNET_BACKEND={v} {_NO_COUNTERPART}", file=sys.stderr)
    elif v:
        set_backend(v)
    for name, why in _UNMATCHED_ENV.items():
        v = os.environ.get(name)
        if v:
            print(f"warning: {name}={v} {why}", file=sys.stderr)


def scale_sw(ws: Tensor, s_w: Tensor) -> Tensor:
    """``ws [..., 1] * s_w [Cout] -> [..., Cout]``: the per-output-channel
    variance scale shared by every vconv sigma term, a broadcast multiply.
    Member-stacked ``s_w`` [K, Cout] scales the K member blocks of ``ws``
    [K*B, ..., 1] each by its own row."""
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


def _per_member(fn, moments, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    """One conv of member-stacked weights as a loop over the members, what
    ``jax.vmap`` of ``fn`` computes: member k's moments (a slice of
    [K,B,...] or of [K*B,...]) through ``fn`` with its weights, the outputs
    concatenated member-major [K*B, ...]. A moment may be None."""
    n, rank = w_mu.shape[0], w_mu.dim() - 1

    def member(t, k: int):
        if t is None:
            return None
        return t[k] if t.dim() == rank + 1 else t.unflatten(0, (n, -1))[k]

    outs = [fn(*(member(t, k) for t in moments), w_mu[k], w_sigma[k]) for k in range(n)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def chan_sum(x: Tensor) -> Tensor:
    """Sum over the trailing channel axis -> [..., 1], accumulated in
    float32 (float64 input keeps float64, for the gradient checks)."""
    return x.sum(dim=-1, keepdim=True, dtype=torch.promote_types(x.dtype, torch.float32))


def _winsum_shift(s: Tensor, k: int, stride: int = 1) -> Tensor:
    """Separable VALID window sum over every spatial axis of a
    single-channel [B, *spatial, 1] tensor: per axis the k (strided) shifted
    views are added (``supernet_tpu/ops/moments.py:489-508``)."""
    for axis in range(1, s.dim() - 1):
        out_len = (s.shape[axis] - k) // stride + 1
        span = (out_len - 1) * stride + 1

        def view(i: int, s=s, axis=axis, span=span) -> Tensor:
            v = s.narrow(axis, i, span)
            if stride == 1:
                return v
            index = [slice(None)] * s.dim()
            index[axis] = slice(None, None, stride)
            return v[tuple(index)]

        acc = view(0)
        for i in range(1, k):
            acc = acc + view(i)
        s = acc
    return s


def _winsum_shift_pads(src: Tensor, k: int, *pads) -> Tensor:
    """Shift-add window sum of a single-channel [B, *spatial, 1] tensor
    with per-axis ``(lo, hi)`` conv-style padding, positive a zero pad and
    negative a crop; accumulated in float32 and rounded once to
    ``src.dtype`` (``supernet_tpu/ops/moments.py:511-524``). The source is
    one channel wide, so padding it costs 1/C of padding the moments."""
    flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    s = F.pad(_f32(src), [0, 0] + flat)
    return _winsum_shift(s, k).to(src.dtype)


def _conv_valid(x: Tensor, w: Tensor, stride: int = 1, padding=0) -> Tensor:
    """VALID 2-D convolution (cross-correlation), NHWC x HWIO -> NHWC in
    ``x``'s dtype (``padding``: a symmetric zero pad per spatial axis). The
    NHWC tensor permuted to NCHW is a channels_last tensor, so no copy is
    made."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _window_sum(x: Tensor, k: int, stride: int = 1) -> Tensor:
    """Sum of x over each k x k VALID window and over all input channels
    -> [B, H', W', 1]: the channel sum in float32 (``chan_sum``), then
    separable shifted adds, the result in ``x``'s dtype."""
    return _winsum_shift(chan_sum(x), k, stride).to(x.dtype)


def _einsum_1x1(x: Tensor, w: Tensor) -> Tensor:
    if w.dim() == 3:  # member-stacked [K, Cin, Cout]
        xs = x.unflatten(0, (w.shape[0], -1))
        return torch.einsum("kbhwc,kco->kbhwo", xs, w).flatten(0, 1)
    return torch.einsum("bhwc,co->bhwo", x, w)


def _kernel_conv(mu, sigma, w_mu, w_sigma, relu: bool) -> MomentPair:
    """The fused conv (kernel 1 on CUDA tensors) at the global precision:
    float32 and bf16 moments go to ``VDPConv`` as they are and come back in
    their dtype; float16 moments are upcast at the boundary and the outputs
    cast back."""
    dt = mu.dtype
    if dt in _HALF:
        mu = mu.float()
        sigma = None if sigma is None else sigma.float()
    m, s = _vdp.VDPConv.apply(mu, sigma, w_mu, w_sigma, relu, _MXU_PRECISION)
    return m.to(dt), s.to(dt)


def _use_kernel(w_mu: Tensor, stride: int) -> bool:
    """A stride-1 k > 1 conv takes ``VDPConv``: kernel 1 on a CUDA tensor,
    its plain version on a CPU tensor."""
    return w_mu.shape[-3] > 1 and stride == 1 and _BACKEND != "naive"


def vconv_input(
    x: Tensor, w_mu: Tensor, w_sigma: Tensor, stride: int = 1
) -> MomentPair:
    """First VDP conv: deterministic input, Gaussian weights.

      mu_out    = conv(x, w_mu)                      (VALID, ``stride``)
      sigma_out = winsum(x^2) * softplus(w_sigma)

    k == 1 (stride 1) is an einsum and a channel sum; a stride-1 k > 1 conv
    is ``VDPConv`` (see :func:`_use_kernel`); a k > 1 conv of stride > 1 is
    the JAX module's default XLA composition
    (``supernet_tpu/ops/moments.py:580-631``).
    Under the naive backend: ``ops.naive.vconv_input_naive``.
    """
    if _BACKEND == "naive":
        return _naive_conv(naive.vconv_input_naive, (x,), w_mu, w_sigma, stride)
    x = _act(x)
    if _use_kernel(w_mu, stride):
        return _kernel_conv(x, None, w_mu, w_sigma, False)
    if w_mu.shape[-3] == 1 and stride == 1:
        x = _fold(x)
        w2 = _act(_w11(w_mu))
        # the 1-channel sum in float32, cast before the broadcast multiply
        t = _act(chan_sum(torch.square(_f32(x))))
        return _act(_einsum_1x1(x, w2)), scale_sw(t, F.softplus(w_sigma))
    if w_mu.dim() == 5:
        return _per_member(lambda a, wm, ws: vconv_input(a, wm, ws, stride),
                           (x,), w_mu, w_sigma)
    mu_out = _conv_valid(x, w_mu, stride)
    ws = _act(_window_sum(torch.square(x), w_mu.shape[0], stride))
    return _act(mu_out), scale_sw(ws, F.softplus(w_sigma))


def vconv(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor, stride: int = 1
) -> MomentPair:
    """Intermediate VDP conv: Gaussian input and Gaussian weights.

      mu_out    = conv(mu, w_mu)
      sigma_out = winsum(mu^2 + sigma) * softplus(w_sigma) + conv(sigma, w_mu^2)

    k == 1 (the softmax head) is two einsums and a channel sum; a stride-1
    k > 1 conv is ``VDPConv`` (see :func:`_use_kernel`); a k > 1 conv of
    stride > 1 is the JAX module's default XLA composition
    (``supernet_tpu/ops/moments.py:653-743``).
    Under the naive backend: ``ops.naive.vconv_naive``.
    """
    if _BACKEND == "naive":
        return _naive_conv(naive.vconv_naive, (mu, sigma), w_mu, w_sigma, stride)
    mu, sigma = _act(mu), _act(sigma)
    if _use_kernel(w_mu, stride):
        return _kernel_conv(mu, sigma, w_mu, w_sigma, False)
    if w_mu.shape[-3] == 1 and stride == 1:
        w2 = _act(_w11(w_mu))
        t = _act(chan_sum(mu * mu + sigma))
        sigma_out = scale_sw(t, F.softplus(w_sigma)) + _einsum_1x1(sigma, w2 * w2)
        return _act(_einsum_1x1(mu, w2)), _act(sigma_out)
    if w_mu.dim() == 5:
        return _per_member(lambda m, s, wm, ws: vconv(m, s, wm, ws, stride),
                           (mu, sigma), w_mu, w_sigma)
    mu_out = _conv_valid(mu, w_mu, stride)
    # the [B,H',W',1] window sum is cast before the broadcast multiply, so
    # the full-width sigma chain stays in the activation dtype
    ws = _act(_window_sum(mu * mu + sigma, w_mu.shape[0], stride))
    sigma_out = scale_sw(ws, F.softplus(w_sigma)) + _conv_valid(sigma, w_mu * w_mu, stride)
    return _act(mu_out), _act(sigma_out)


def _naive_conv(fn, moments, w_mu: Tensor, w_sigma: Tensor, stride: int) -> MomentPair:
    """A conv of the naive backend: ``fn`` (an ``ops.naive`` conv) on the
    promoted operands, member-stacked weights member by member (the JAX
    naive path runs under ``jax.vmap``)."""
    if w_mu.dim() == 5:
        return _per_member(
            lambda *a: _naive_conv(fn, a[:-2], a[-2], a[-1], stride), moments, w_mu, w_sigma)
    return fn(*_promoted(*moments, w_mu, w_sigma), stride=stride)


def vconv_relu(
    mu: Tensor, sigma: Tensor, w_mu: Tensor, w_sigma: Tensor
) -> MomentPair:
    """``vrelu(*vconv(...))``, the ReLU fused into ``VDPConv`` wherever the
    conv takes it (:func:`_use_kernel`)."""
    if _use_kernel(w_mu, 1):
        return _kernel_conv(_act(mu), _act(sigma), w_mu, w_sigma, True)
    return vrelu(*vconv(mu, sigma, w_mu, w_sigma))


def vconv_input_relu(x: Tensor, w_mu: Tensor, w_sigma: Tensor) -> MomentPair:
    """``vrelu(*vconv_input(...))``, fused the same way."""
    if _use_kernel(w_mu, 1):
        return _kernel_conv(_act(x), None, w_mu, w_sigma, True)
    return vrelu(*vconv_input(x, w_mu, w_sigma))


def vrelu(mu: Tensor, sigma: Tensor) -> MomentPair:
    """First-order Taylor ReLU with the strict mask ``mu > 0`` (TF's ReLU
    gradient is 0 at 0)."""
    mask = mu > 0
    return torch.where(mask, mu, 0.0), torch.where(mask, sigma, 0.0)


def vmaxpool(mu: Tensor, sigma: Tensor) -> MomentPair:
    """2x2/stride-2 max-pool of ``mu`` with ``sigma`` at the argmax;
    first-occurrence ties, in the gradient too; odd sizes padded with
    ``finfo.min``. Keeps its input's dtype: float32 and bf16 moments go to
    ``VMaxPool`` as they are (the kernels load bf16, select in float32 and
    store bf16, the tap index too, as the TPU kernel does); float16 moments
    are upcast at the boundary and cast back, which is exact.
    Under the naive backend: ``ops.naive.vmaxpool_naive``."""
    if _BACKEND == "naive":
        return naive.vmaxpool_naive(mu, sigma)
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
    pixel per window, so it is the channel sum upsampled 2x. Under the
    naive backend: the reference's choreography, the zero-interleaved
    upsample made and a 2x2 ``ops.naive.vconv_naive`` over it."""
    if _BACKEND == "naive":
        return _naive_conv(naive.vconv_naive, vunpool(mu, sigma), w_mu, w_sigma, 1)
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


def _conv_pad(x: Tensor, w: Tensor, *pads) -> Tensor:
    """2-D convolution of NHWC ``x`` with HWIO ``w`` under per-axis
    ``(lo, hi)`` padding, as XLA's ``padding`` config reads it: positive a
    zero pad, negative a crop. PyTorch's convs take neither a negative nor
    an unequal pair, so a crop is a ``narrow`` view of ``x`` and an unequal
    pad runs the conv at the larger pad and narrows the output; no padded
    or cropped copy of ``x`` is made here."""
    return _conv_pads(_conv_valid, x, w, pads)


def _conv_pads(conv, x: Tensor, w: Tensor, pads) -> Tensor:
    """The padded conv of :func:`_conv_pad` for any rank, ``conv`` the VALID
    conv of that rank taking a ``padding`` tuple."""
    for axis, (lo, hi) in enumerate(pads, start=1):
        a, b = max(-lo, 0), max(-hi, 0)
        if a or b:
            x = x.narrow(axis, a, x.shape[axis] - a - b)
    sym = tuple(max(lo, hi, 0) for lo, hi in pads)
    out = conv(x, w, padding=sym)
    for axis, ((lo, hi), p) in enumerate(zip(pads, sym), start=1):
        a, b = p - max(lo, 0), p - max(hi, 0)
        if a or b:
            out = out.narrow(axis, a, out.shape[axis] - a - b)
    return out


def _moment_src(mu: Tensor, sigma: Tensor) -> Tensor:
    """Channel sum of (mu^2 + sigma) in float32, the result in mu's dtype:
    the window-sum source column (``supernet_tpu/ops/moments.py:1049-1056``)."""
    return chan_sum(mu * mu + sigma).to(mu.dtype)


def _ring(like: Tensor, pads) -> Tensor:
    """The 1-channel ring of ones around a batch-1 map of zeros of
    ``like``'s spatial shape, padded by ``pads`` per axis."""
    flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    zeros = like.new_zeros((1,) + tuple(like.shape[1:-1]) + (1,))
    return F.pad(zeros, [0, 0] + flat, value=1.0)


def _enc_pads(dec_shape, enc_shape, pads):
    """Per spatial axis, the center crop of the encoder map to the padded
    decoder size (``pads``: the decoder's ``(lo, hi)`` per axis) as negative
    ``(lo, hi)`` conv padding; an odd difference crops one more at the high
    end (offsets ``(S - s) // 2``)."""
    out = []
    for d, e, (lo, hi) in zip(dec_shape, enc_shape, pads):
        t = d + lo + hi
        o = (e - t) // 2
        out.append((-o, -(e - o - t)))
    return tuple(out)


def _axis_pads(pad_size, n: int):
    """``pad_size`` as one ``(lo, hi)`` per spatial axis: a single
    ``(lo, hi)`` pair pads every one of the ``n`` axes alike."""
    if isinstance(pad_size[0], (tuple, list)):
        return tuple((int(lo), int(hi)) for lo, hi in pad_size)
    return ((int(pad_size[0]), int(pad_size[1])),) * n


def vglue_conv_relu(
    mu: Tensor,
    sigma: Tensor,
    w_mu: Tensor,
    w_sigma: Tensor,
    pad_size,
    sigma_fill: float,
    mu_enc: Tensor | None = None,
    sigma_enc: Tensor | None = None,
) -> MomentPair:
    """The decoder's ``vpad -> [vcrop_concat ->] vconv -> vrelu`` computed
    inside the convs, so none of the padded, cropped or concatenated moment
    tensors is made (``supernet_tpu/ops/moments.py:1059-1163``). Equal, to
    float32 summation order, to::

        m, s = vpad(mu, sigma, pad_size, sigma_fill)
        if mu_enc is not None:
            m, s = vcrop_concat(m, s, mu_enc, sigma_enc)
        return vrelu(*vconv(m, s, w_mu, w_sigma))

    The zero mu-pad is the conv's padding; the encoder's center crop is a
    negative padding (:func:`_conv_pad`); the concatenation splits the
    kernel into its decoder block ``w_mu[:, :, :c_d]`` and encoder block,
    two convs summed; the constant ``sigma_fill`` border adds
    ``c_d * fill * winsum(ring)`` to the window sum and
    ``fill * conv(ring, sum_cin w_mu^2)`` to the variance conv, convs of a
    batch-1 ring map broadcast over the batch. Its convs are PyTorch's on
    every device, as the JAX package's are XLA's on every backend.
    Member-stacked weights run member by member (:func:`_per_member`).

    ``pad_size`` is one ``(lo, hi)`` for both spatial axes, as ``vpad``
    takes it, or a ``(lo, hi) >= 0`` per axis: the local conv of the
    row-sharded fold (``parallel/spatial.py``), whose block of rows is
    padded only on a side that is an edge of the whole image. The
    ``sigma_fill`` ring covers exactly the padded sides, and the encoder's
    crop is taken to the padded block's size on each axis."""
    if w_mu.dim() == 5:
        return _per_member(
            lambda m, s, me, se, wm, ws: vglue_conv_relu(
                m, s, wm, ws, pad_size, sigma_fill, me, se),
            (mu, sigma, mu_enc, sigma_enc), w_mu, w_sigma)
    k = w_mu.shape[0]
    c_d = mu.shape[-1]
    s_w = F.softplus(w_sigma)
    mu, sigma = _act(mu), _act(sigma)
    w_d = w_mu[:, :, :c_d] if mu_enc is not None else w_mu
    pd = _axis_pads(pad_size, 2)
    mu_out = _conv_pad(mu, w_d, *pd)
    ws = _winsum_shift_pads(_moment_src(mu, sigma), k, *pd)
    sig_conv = _conv_pad(sigma, w_d * w_d, *pd)
    if sigma_fill != 0.0 and any(lo or hi for lo, hi in pd):
        # each border pixel contributes (mu = 0, sigma = fill) per decoder
        # channel
        ring = _ring(mu, pd)
        fill = float(torch.tensor(sigma_fill, dtype=mu.dtype))  # jnp.asarray's rounding
        ws = ws + _winsum_shift_pads(ring, k, (0, 0), (0, 0)) * (c_d * fill)
        w2_sum = (w_d * w_d).sum(dim=2, keepdim=True)
        sig_conv = sig_conv + _conv_valid(ring, w2_sum) * fill
    if mu_enc is not None:
        mu_enc, sigma_enc = _act(mu_enc), _act(sigma_enc)
        w_e = w_mu[:, :, c_d:]
        pe = _enc_pads(mu.shape[1:3], mu_enc.shape[1:3], pd)
        mu_out = mu_out + _conv_pad(mu_enc, w_e, *pe)
        ws = ws + _winsum_shift_pads(_moment_src(mu_enc, sigma_enc), k, *pe)
        sig_conv = sig_conv + _conv_pad(sigma_enc, w_e * w_e, *pe)
    sigma_out = scale_sw(_act(ws), s_w) + sig_conv
    return vrelu(_act(mu_out), _act(sigma_out))


def vsoftmax(mu: Tensor, sigma: Tensor) -> MomentPair:
    """Pixel-wise softmax with the variance pushed through its Jacobian, in
    closed form and float32:

        sigma_out_c = p_c^2 * ((1 - 2 p_c) * sigma_c + sum_j p_j^2 sigma_j)

    Outputs are flattened to [B, H*W, C]; the batch dim is never squeezed.
    Under the naive backend: ``ops.naive.vsoftmax_naive``.
    """
    if _BACKEND == "naive":
        return naive.vsoftmax_naive(mu, sigma)
    b, h, w, c = mu.shape
    mu_flat = mu.reshape(b, h * w, c).float()
    sigma_flat = sigma.reshape(b, h * w, c).float()
    p = torch.softmax(mu_flat, dim=-1)
    p_sq = p * p
    s_tot = (p_sq * sigma_flat).sum(dim=-1, keepdim=True)
    return p, p_sq * ((1.0 - 2.0 * p) * sigma_flat + s_tot)
