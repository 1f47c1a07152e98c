"""Fused VDP convolution: the CUDA kernel, its plain version and its
autograd backward.

Counterpart of ``supernet_tpu/ops/pallas/vdp_conv.py``. One call computes,
VALID and stride 1:

    mu_out  = conv(mu, w_mu)
    win     = k x k window sum of sum_c(mu^2 + sigma)     (sum_c x^2 when sigma is None)
    sig_out = win * softplus(w_sigma) + conv(sigma, w_mu^2)
    [optional ReLU: where mu_out > 0 is false, both outputs are 0]

and returns ``(mu_out, sig_out, win)``; ``win`` [B,H',W',1] is the backward
residual. Without the window sum (``w_sigma=None``) a call computes
``conv(mu, w_mu)`` and ``conv(sigma, w_mu^2)`` alone: the form in which
:func:`conv_t_pair` runs the backward's two transposed convolutions. The
kernels are ``csrc/vdp_conv.cuh`` (built from ``vdp_conv.cu`` and
``vdp_conv_bf16.cu``): an implicit GEMM on the tensor cores (wgmma), with
split-K for the layers whose output tiles alone do not fill the card, and a
CUDA-core kernel for the other shapes. :func:`plan` picks the path, the tile
and the number of K slices from the shape and the precision.
:func:`vdp_conv` launches the planned kernel for CUDA tensors and takes
:func:`vdp_conv_plain` only for CPU tensors.

Precision (``precision``, the global ``SUPERNET_PRECISION`` that
``ops.moments`` passes in), as the Pallas kernel takes it into its two MXU
dots (``supernet_tpu/ops/pallas/vdp_conv.py:108-121``): ``"highest"`` and
``"high"`` compute at float32 accuracy (3xTF32 on the tensor cores: Mosaic
rounds "high" up to "highest"); ``"default"`` is one bf16 pass, each
product's operands (``mu``, ``sigma``, ``w_mu`` and ``w_mu^2``, squared in
float32 first) rounded to bf16 to nearest even and the sums in float32. The
window sum is no product: it is taken from the unrounded moments under every
setting. The transposed pair rounds ``g1``, ``g2`` and the flipped weights
alike. The plain versions round where the kernel does, so the port on the
CPU under ``"default"`` computes the TPU's arithmetic.
:class:`VDPConv` is the differentiable form: its backward is the JAX
package's hand-derived VJP (``_bwd_common``), with the window-sum term
through the sigma-chain kernel (``ops/kernels/sigma_bwd.py``), both
transposed convolutions through one launch of this kernel without the
window sum (CUDA tensors; PyTorch's ``conv_transpose2d`` on the CPU) and the
filter gradients as PyTorch ops, as they are XLA convolutions in the JAX
package. Layouts are the JAX package's: NHWC
activations, HWIO ``w_mu`` [k,k,Cin,Cout] and the raw (pre-softplus)
``w_sigma`` [Cout].

Dtypes: ``mu`` and ``sigma`` are float32 or bf16 (one dtype), the weights
float32. The kernel converts as it loads and computes in float32, as the TPU
kernel does behind its wrapper's cast (``vdp_conv.py:460-477``). With the
window sum, ``mu_out`` and ``sig_out`` come out in the moments' dtype,
rounded once, and ``win`` in float32; without it (the transposed pair) both
outputs are float32. A bf16 call runs the float32 plan on the same values,
so it returns the float32 call's outputs rounded to bf16. The plain versions
take the same dtypes and compute in float32 as well. :class:`VDPConv` takes
the rounding points of the JAX package's bf16 mode, whose casts sit outside
the custom VJP: the backward sums in float32 from bf16 cotangents and
rounds each input gradient once.

Member axis (a deep ensemble's K parameter sets, the counterpart of
``jax.vmap`` over the Pallas call): ``w_mu`` [K,k,k,Cin,Cout] and
``w_sigma`` [K,Cout] make every function here run all K members in one
launch. The activations are then [K*B,H,W,Cin], member-major, or
[K,B,H,W,Cin] with each member contiguous and the member stride either
B*H*W*Cin or 0: ``x.expand(K, *x.shape)`` is one batch that every member
reads, passed to the kernel by its stride and never copied. The outputs are
[K*B,H',W',...]. The plain versions run the single-member plain version
member by member.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from supernet_tpu_torch import tracing
from supernet_tpu_torch.ops.kernels import _lib
from supernet_tpu_torch.ops.kernels._lib import aligned as _aligned, wide as _wide
from supernet_tpu_torch.ops.kernels.sigma_bwd import winsum_spread_bwd

# Kernel launches in this process; chip_smoke.py zeroes and reads them to
# show that a path went through the kernels. `launches` counts calls of the
# op (one main kernel each), `reduce_launches` the split-K reduce kernel;
# `dgrad_launches` and `dgrad_reduce_launches` the same for the calls
# without the window sum (the backward's transposed convolutions);
# `bf16_launches` the calls of either form made in one bf16 pass
# (precision "default"). Beside them, ``tracing.count`` counts each call's
# plan path: ``kernel1.path.<simt|wgmma>``.
launches = 0
reduce_launches = 0
dgrad_launches = 0
dgrad_reduce_launches = 0
bf16_launches = 0

# The planner's constants: the SM count of the shape-only plan (H100 SXM;
# a launch plans with its own card's count, ``_lib.sm_count``), the
# tensor-core kernel's output pixels per block (wgmma's M) and input
# channels per K step (8 in 3xTF32, 16 in one bf16 pass), the caps on the
# number of K slices and on their scratch, and the grid's z extent (members
# x K slices, members x images).
SMS = 132
TC_TILE_M = 64
TC_CHUNK = 8
TC_CHUNK_BF16 = 16
MAX_SPLITS = 16
MAX_SCRATCH_BYTES = 64 << 20
MAX_GRID_Z = 65535
_PATH_ID = {"simt": 0, "wgmma": 1}
_PATH_COUNTER = {path: f"kernel1.path.{path}" for path in _PATH_ID}
PRECISIONS = ("highest", "high", "default")


class Plan(NamedTuple):
    """How one vdp_conv call runs: ``path`` "wgmma" (tensor cores) or
    "simt" (CUDA cores), output pixels x channels per block, K slices, the
    main launch's blocks (slices included), the split-K scratch, and
    ``bf16``: the products in one bf16 pass (precision "default"; the
    tensor cores' wgmma k16 bf16) or at float32 accuracy (3xTF32 on the
    tensor cores)."""

    path: str
    tile_m: int
    tile_n: int
    splits: int
    blocks: int
    scratch_bytes: int
    bf16: bool = False


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _one_pass(precision: str) -> bool:
    """True where ``precision`` computes the products in one bf16 pass
    ("default"); "high" and "highest" compute at float32 accuracy. Raises
    on any other value."""
    if precision not in PRECISIONS:
        raise ValueError(f"vdp_conv: unknown precision {precision!r}")
    return precision == "default"


def _rounded(t: Optional[torch.Tensor], bf16: bool) -> Optional[torch.Tensor]:
    """``t`` rounded to bf16 (to nearest even) and back to its dtype where
    ``bf16``: a product's operand in one bf16 pass; else ``t``."""
    if t is None or not bf16:
        return t
    return t.to(torch.bfloat16).to(t.dtype)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, cin: int, cout: int, k: int,
         members: int = 1, sms: int = SMS, precision: str = "highest") -> Plan:
    """The kernel plan for ``members`` members of mu [b,h,w,cin] and w_mu
    [k,k,cin,cout] at ``precision``, from the shape alone (no CUDA: the CPU
    tests call it), for a card of ``sms`` SMs.

    The tensor-core path takes k = 3 with Cin a multiple of its K step's
    channels (8 of one tap in 3xTF32 under "highest" and "high"; 16 in one
    bf16 pass, ``bf16``, under "default"), Cout % 8 == 0
    (whole 8-column groups of the N tile: the 1- and 4-channel input
    gradient of conv_input takes the CUDA cores) and step offsets that fit
    an int (9 Cin Cout and 3 W Cin below 2^31): N = 32 for Cout <= 32, else
    64, and 64 output pixels (one warpgroup) per block. Its blocks are
    members x M tiles x N tiles, the M tiles counted per member (M = b H'
    W'), so that no tile holds pixels of two members; where they are fewer
    than the SMs, the Cin chunks (of 8 or 16 channels) are cut into the
    fewest slices S (a divisor of the chunks) that fill one wave, at most
    MAX_SPLITS, within MAX_SCRATCH_BYTES (members x S partials) and with
    members x S within the grid, and a reduce kernel sums them. Everything
    else takes the CUDA-core kernel (CT = 64 output channels per block for
    Cout >= 64, else 32; tiles of 8x8 or 8x16 pixels of one image of one
    member); under "default" it rounds each product's operand to bf16 as it
    reads it, so a Cin that is a multiple of 8 but not of 16 computes the
    one bf16 pass there."""
    bf16 = _one_pass(precision)
    chunk = TC_CHUNK_BF16 if bf16 else TC_CHUNK
    ho, wo = h - k + 1, w - k + 1
    m = b * ho * wo
    if (k == 3 and cin % chunk == 0 and cout % TC_CHUNK == 0
            and 9 * cin * cout < 2 ** 31 and 3 * w * cin < 2 ** 31):
        tile_n = 32 if cout <= 32 else 64
        tiles = members * _cdiv(m, TC_TILE_M) * _cdiv(cout, tile_n)
        chunks = cin // chunk

        def scratch(s: int) -> int:
            return 0 if s == 1 else 4 * members * s * m * (2 * cout + 1)

        splits = 1
        for s in range(1, min(chunks, MAX_SPLITS) + 1):
            if (chunks % s or scratch(s) > MAX_SCRATCH_BYTES
                    or members * s > MAX_GRID_Z):
                continue
            splits = s
            if tiles * s >= sms:
                break
        return Plan("wgmma", TC_TILE_M, tile_n, splits, tiles * splits,
                    scratch(splits), bf16)
    ct = 64 if cout >= 64 else 32
    tw = 8 if ct == 64 else 16
    th = 8
    blocks = _cdiv(ho, th) * _cdiv(wo, tw) * _cdiv(cout, ct) * b * members
    return Plan("simt", th * tw, ct, 1, blocks, 0, bf16)


def _member(x: torch.Tensor, k: int, members: int) -> torch.Tensor:
    """Member ``k``'s slice of activations in either member layout
    ([K,B,...] or [K*B,...], see the module docstring)."""
    if x.dim() == 5:
        return x[k]
    return x.unflatten(0, (members, -1))[k]


def _stacked(w_mu: torch.Tensor) -> bool:
    """True for member-stacked weights [K,k,k,Cin,Cout]."""
    return w_mu.dim() == 5


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
    relu_mask: bool = False,
    precision: str = "highest",
):
    """PyTorch composition of the fused conv (the XLA path of
    ``ops/moments.py:vconv``/``vconv_input``, plus ``win``); with stacked
    weights, member by member, concatenated member-major. bf16 moments are
    converted to float32 first and ``mu_out``, ``sig_out`` rounded back, as
    the kernel does. Under ``precision="default"`` each product's operands
    are rounded to bf16 (``w_mu^2`` after squaring), the window sum taken
    from the unrounded moments, as the kernel's one bf16 pass does. With
    ``relu_mask`` a fourth output: the ReLU's mask ``mu_out > 0`` before
    the rounding (None without the ReLU)."""
    # imported here: ops.moments imports this module
    from supernet_tpu_torch.ops.moments import _window_sum

    if _stacked(w_mu):
        n = w_mu.shape[0]
        outs = [vdp_conv_plain(_member(mu, i, n),
                               None if sigma is None else _member(sigma, i, n),
                               w_mu[i], w_sigma[i], fuse_relu, relu_mask, precision)
                for i in range(n)]
        return tuple(None if o[0] is None else torch.cat(o) for o in zip(*outs))

    bf16 = _one_pass(precision)
    out_dtype = mu.dtype
    mu, sigma = _wide(mu), _wide(sigma)
    k = w_mu.shape[0]
    mu_out = _conv_valid(_rounded(mu, bf16), _rounded(w_mu, bf16))
    t = mu * mu if sigma is None else mu * mu + sigma
    win = _window_sum(t, k)
    sig_out = win * F.softplus(w_sigma)
    if sigma is not None:
        sig_out = sig_out + _conv_valid(_rounded(sigma, bf16),
                                        _rounded(w_mu * w_mu, bf16))
    mask = None
    if fuse_relu:
        mask = mu_out > 0
        mu_out = torch.where(mask, mu_out, 0.0)
        sig_out = torch.where(mask, sig_out, 0.0)
    out = (mu_out.to(out_dtype).contiguous(), sig_out.to(out_dtype).contiguous(),
           win.contiguous())
    return out + (mask,) if relu_mask else out


def _input(name: str, t: torch.Tensor, members: int, dtypes):
    """``(t, per-member shape [B,H,W,C], member stride in elements)`` of an
    activation operand in either member layout; raises unless it is on the
    card in one of ``dtypes`` and each member contiguous."""
    if t.dim() == 5:
        if t.shape[0] != members:
            raise ValueError(f"vdp_conv: {name} has {t.shape[0]} members, the "
                             f"weights {members}")
        one = t[0]
        _lib.check_input("vdp_conv", name, one, one.shape, dtypes)
        ms = t.stride(0) if members > 1 else one.numel()
        if ms not in (0, one.numel()):
            raise ValueError(f"vdp_conv: {name}'s member stride {ms} is neither "
                             f"0 nor {one.numel()}")
        return t, tuple(one.shape), ms
    if t.dim() != 4 or t.shape[0] % members:
        raise ValueError(f"vdp_conv: {name} must be [K*B,H,W,C] or [K,B,H,W,C] "
                         f"for {members} member(s), got {tuple(t.shape)}")
    _lib.check_input("vdp_conv", name, t, t.shape, dtypes)
    shape = (t.shape[0] // members,) + tuple(t.shape[1:])
    return t, shape, t.numel() // members


def _aligned_input(t: torch.Tensor, ms: int) -> torch.Tensor:
    """``t`` with its data on 16 bytes (a copy if not); a shared input
    (member stride 0) stays shared."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    if t.dim() == 5 and ms == 0:
        return t[0].clone().expand(t.shape)
    return t.clone()


def _launch(mu, sigma, w_mu, w_sigma, fuse_relu, relu_mask=False,
            precision="highest"):
    """The kernel on CUDA tensors -> ``(mu_out, sig_out, win, mask)``;
    ``w_sigma=None`` is the form without the window sum (and without the
    ReLU), which returns ``(mu_out, sig_out or None, None, None)`` in
    float32. ``relu_mask`` asks for the ReLU's mask (bool, [K*B,H',W',
    Cout]). Stacked weights run every member in the same launch; the
    precision picks the plan and the kernels' arithmetic."""
    global launches, reduce_launches, dgrad_launches, dgrad_reduce_launches
    global bf16_launches
    with_win = w_sigma is not None
    if w_mu.dim() not in (4, 5):
        raise ValueError(f"vdp_conv: w_mu must be [k,k,Cin,Cout] or "
                         f"[K,k,k,Cin,Cout], got {tuple(w_mu.shape)}")
    members = w_mu.shape[0] if _stacked(w_mu) else 1
    mu, (b, h, w, cin), x_ms = _input("mu", mu, members, _lib.MOMENT_DTYPES)
    k, cout = w_mu.shape[-3], w_mu.shape[-1]
    if sigma is not None:
        sigma, s_shape, s_ms = _input("sigma", sigma, members, (mu.dtype,))
        if s_shape != (b, h, w, cin) or s_ms != x_ms:
            raise ValueError("vdp_conv: sigma must have mu's shape and member stride")
    lead = (members,) if _stacked(w_mu) else ()
    _lib.check_input("vdp_conv", "w_mu", w_mu, lead + (k, k, cin, cout))
    if with_win:
        _lib.check_input("vdp_conv", "w_sigma", w_sigma, lead + (cout,))
    elif fuse_relu:
        raise ValueError("vdp_conv: the form without the window sum has no ReLU")
    tensors = [t for t in (mu, sigma, w_mu, w_sigma) if t is not None]
    if any(t.device != mu.device for t in tensors):
        raise ValueError("vdp_conv: inputs are on different devices")
    if (not (1 <= k <= min(h, w)) or cin < 1 or cout < 1
            or members * b > MAX_GRID_Z):
        raise ValueError(
            f"vdp_conv: unsupported sizes K={members} B={b} H={h} W={w} "
            f"Cin={cin} Cout={cout} k={k}"
        )
    ho, wo = h - k + 1, w - k + 1
    mu_out = torch.empty((members * b, ho, wo, cout), device=mu.device,
                         dtype=mu.dtype if with_win else torch.float32)
    sig_out = (torch.empty_like(mu_out)
               if with_win or sigma is not None else None)
    win = (torch.empty((members * b, ho, wo, 1), device=mu.device,
                       dtype=torch.float32) if with_win else None)
    mask = (torch.empty(mu_out.shape, device=mu.device, dtype=torch.bool)
            if relu_mask and fuse_relu else None)
    p = plan(b, h, w, cin, cout, k, members, _lib.sm_count(mu.device), precision)
    if b == 0:
        return mu_out, sig_out, win, mask
    sw = F.softplus(w_sigma).contiguous() if with_win else None
    scratch = None
    if p.path != "simt":
        mu, sigma = _aligned_input(mu, x_ms), _aligned_input(sigma, x_ms)
        w_mu, sw = _aligned(w_mu), _aligned(sw)
        if p.splits > 1:
            scratch = torch.empty(p.scratch_bytes // 4, device=mu.device,
                                  dtype=torch.float32)
    lib = _lib.load()
    with torch.cuda.device(mu.device):
        err = lib.supernet_vdp_conv_fwd(
            mu.data_ptr(),
            sigma.data_ptr() if sigma is not None else None,
            w_mu.data_ptr(), sw.data_ptr() if sw is not None else None,
            mu_out.data_ptr(),
            sig_out.data_ptr() if sig_out is not None else None,
            win.data_ptr() if win is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            mask.data_ptr() if mask is not None else None,
            b, h, w, cin, cout, k, int(fuse_relu), int(with_win),
            _PATH_ID[p.path], p.tile_n, p.splits, members,
            _lib.dtype_code(mu.dtype), int(p.bf16), x_ms, k * k * cin * cout, cout,
            torch.cuda.current_stream(mu.device).cuda_stream,
        )
    _lib.check(err, f"vdp_conv kernel launch ({p.path}, {p.splits} K slices, "
                    f"{members} member(s){'' if with_win else ', no window sum'}, "
                    f"precision {precision})")
    if with_win:
        launches += 1
        reduce_launches += p.splits > 1
    else:
        dgrad_launches += 1
        dgrad_reduce_launches += p.splits > 1
    bf16_launches += p.bf16
    tracing.count(_PATH_COUNTER[p.path])
    return mu_out, sig_out, win, mask


def vdp_conv(
    mu: torch.Tensor,
    sigma: Optional[torch.Tensor],
    w_mu: torch.Tensor,
    w_sigma: torch.Tensor,
    fuse_relu: bool = False,
    relu_mask: bool = False,
    precision: str = "highest",
):
    """Fused VDP conv (+ optional ReLU) -> ``(mu_out, sig_out, win)``.
    ``sigma=None`` is the deterministic-input form (the first layer).
    ``mu`` and ``sigma`` float32 or bf16: ``mu_out`` and ``sig_out`` come
    out in their dtype, ``win`` in float32. With ``relu_mask`` a fourth
    output: the ReLU's mask, the float32 ``mu_out > 0`` before the
    rounding (bool; None without the ReLU). ``precision``: see the module
    docstring ("default" is one bf16 pass).

    CUDA tensors go to the kernel (or raise); CPU tensors to
    :func:`vdp_conv_plain`. Any other device raises.
    """
    if mu.is_cuda:
        out = _launch(mu, sigma, w_mu, w_sigma, fuse_relu, relu_mask, precision)
        return out if relu_mask else out[:3]
    if mu.device.type != "cpu":
        raise ValueError(f"vdp_conv: unsupported device {mu.device}")
    return vdp_conv_plain(mu, sigma, w_mu, w_sigma, fuse_relu, relu_mask, precision)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _conv_t(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`_conv_valid`: the full transposed conv of
    ``g`` [B,H',W',Cout] with HWIO ``w`` -> [B,H,W,Cin]."""
    return F.conv_transpose2d(_nchw(g), _oihw(w)).permute(0, 2, 3, 1)


def dgrad_operands(g1, g2, w_mu):
    """The transposed convolutions as VALID ones: ``g1``, ``g2`` (or None)
    [B,H',W',Cout] padded by k - 1 on every spatial side, and ``w_mu``
    [k,k,Cin,Cout] flipped in both spatial axes with Cin and Cout swapped
    -> [k,k,Cout,Cin] (stacked [K,...] alike). Then ``conv(pad(g),
    flip(w)^T) = convT(g, w)``."""
    k = w_mu.shape[-3]
    pad = (0, 0, k - 1, k - 1, k - 1, k - 1)
    w = w_mu.flip(-4, -3).transpose(-2, -1).contiguous()
    return (F.pad(g1, pad), None if g2 is None else F.pad(g2, pad), w)


def _per_member(fn, g1, g2, w_mu, precision):
    """``fn(g1, g2, w_mu, precision)`` member by member for stacked weights,
    the results concatenated member-major."""
    n = w_mu.shape[0]
    outs = [fn(_member(g1, i, n), None if g2 is None else _member(g2, i, n),
               w_mu[i], precision) for i in range(n)]
    return (torch.cat([o[0] for o in outs]),
            None if g2 is None else torch.cat([o[1] for o in outs]))


def conv_t_pair_plain(g1, g2, w_mu, precision="highest"):
    """PyTorch composition of the padded, flipped form: ``(convT(g1, w_mu),
    convT(g2, w_mu^2))`` (the second None when ``g2`` is), as the kernel
    computes them without the window sum: bf16 cotangents converted to
    float32, float32 out; under ``precision="default"`` the cotangents and
    both weights rounded to bf16 (``w_mu^2`` after squaring)."""
    if _stacked(w_mu):
        return _per_member(conv_t_pair_plain, g1, g2, w_mu, precision)
    bf16 = _one_pass(precision)
    mu, sigma, w = dgrad_operands(_wide(g1), _wide(g2), w_mu)
    d1 = _conv_valid(_rounded(mu, bf16), _rounded(w, bf16)).contiguous()
    d2 = (None if sigma is None else
          _conv_valid(_rounded(sigma, bf16), _rounded(w * w, bf16)).contiguous())
    return d1, d2


def conv_t_pair(g1, g2, w_mu, precision="highest"):
    """``(convT(g1, w_mu), convT(g2, w_mu^2))``, ``g2`` may be None: the two
    transposed convolutions of :class:`VDPConv`'s backward. ``g1`` and
    ``g2`` float32 or bf16 (one dtype); the outputs are float32. Under
    ``precision="default"`` one bf16 pass, as :func:`conv_t_pair_plain`.

    CUDA tensors: one launch of the kernel without the window sum on
    :func:`dgrad_operands` (or raise), for all members of stacked weights;
    bf16 cotangents are padded and read as bf16. CPU tensors:
    :func:`_conv_t` in float32, member by member."""
    if g1.is_cuda:
        mu, sigma, w = dgrad_operands(g1, g2, w_mu)
        d1, d2, _, _ = _launch(mu, sigma, w, None, False, precision=precision)
        return d1, d2
    if g1.device.type != "cpu":
        raise ValueError(f"vdp_conv: unsupported device {g1.device}")
    if _stacked(w_mu):
        return _per_member(conv_t_pair, g1, g2, w_mu, precision)
    bf16 = _one_pass(precision)
    g1, g2 = _rounded(_wide(g1), bf16), _rounded(_wide(g2), bf16)
    d1 = _conv_t(g1, _rounded(w_mu, bf16))
    return d1, None if g2 is None else _conv_t(g2, _rounded(w_mu * w_mu, bf16))


def _filter_grad(x: torch.Tensor, g: torch.Tensor, w_shape) -> torch.Tensor:
    """Weight gradient of :func:`_conv_valid` -> HWIO [k,k,Cin,Cout]; for
    stacked ``w_shape`` [K,k,k,Cin,Cout] one cuDNN call per member ->
    [K,k,k,Cin,Cout]."""
    if len(w_shape) == 5:
        n = w_shape[0]
        return torch.stack([_filter_grad(_member(x, i, n), _member(g, i, n),
                                         w_shape[1:]) for i in range(n)])
    k, _, cin, cout = w_shape
    dw = torch.nn.grad.conv2d_weight(_nchw(x), (cout, cin, k, k), _nchw(g))
    return dw.permute(2, 3, 1, 0)


class VDPConv(torch.autograd.Function):
    """The fused VDP conv (+ optional ReLU) with its gradient: ``apply(mu,
    sigma, w_mu, w_sigma, fuse_relu, precision="highest") -> (mu_out,
    sig_out)``, ``sigma`` None for the deterministic first layer.
    ``precision`` (see the module docstring; ``ops.moments`` passes the
    global one) is kept for the backward, whose transposed pair runs at the
    forward's precision even if the global changes in between: one bf16
    pass under "default", as ``_bwd_common``'s convolutions take the
    precision there. The filter gradients stay cuDNN's (TF32 under
    "default" and "high", through ``set_mxu_precision``'s flags), and
    kernel 4 keeps ``u`` in float32: the Pallas ``sigma_bwd`` kernel takes
    no precision.

    Forward: :func:`vdp_conv`. Backward, after
    ``supernet_tpu/ops/pallas/vdp_conv.py:_bwd_common``:

        g1, g2  = the cotangents of mu_out, sig_out, masked by mu_out > 0 with the ReLU
        u, d_sw = winsum_spread_bwd(g2, win, softplus(w_sigma))     (kernel 4)
        c1, c2  = conv_t_pair(g1, g2, w_mu)                          (kernel 1, no window sum)
        d_mu    = c1 + 2 mu u
        d_sigma = u + c2
        d_w_mu  = filter_grad(mu, g1) + 2 w_mu filter_grad(sigma, g2)
        d_w_sig = d_sw * sigmoid(w_sigma)

    With stacked weights (the member axis of the module docstring) kernels
    1 and 4 run every member in one launch each, forward and backward; the
    filter gradients are one cuDNN call per member. ``mu`` may then be one
    batch that every member reads (member stride 0); autograd sums its
    gradient over the members.

    bf16 moments: the residuals are saved as they come (``mu``, ``sigma``
    in bf16, ``win`` in float32); ``g1`` and ``g2`` reach kernels 4 and 1
    in bf16, ``u``, ``c1`` and ``c2`` are float32, and ``d_mu``, ``d_sigma``
    are rounded to bf16 once, at the end. The filter gradients are float32
    products of float32 operands, as in the JAX package (cuDNN's on bf16
    operands would return a bf16 gradient). The ReLU's mask is the float32
    ``mu_out > 0``: a positive ``mu_out`` below bf16's least subnormal
    rounds to 0, so under bf16 the forward saves the kernel's mask instead
    of reading it back from the rounded ``mu_out``.
    """

    @staticmethod
    def forward(ctx, mu, sigma, w_mu, w_sigma, fuse_relu, precision="highest"):
        keep_mask = (fuse_relu and mu.dtype == torch.bfloat16
                     and any(ctx.needs_input_grad))
        out = vdp_conv(mu, sigma, w_mu, w_sigma, fuse_relu, relu_mask=keep_mask,
                       precision=precision)
        mu_out, sig_out, win = out[:3]
        ctx.fuse_relu = fuse_relu
        ctx.precision = precision
        ctx.save_for_backward(mu, sigma, w_mu, w_sigma, win,
                              out[3] if keep_mask else mu_out)
        return mu_out, sig_out

    @staticmethod
    def backward(ctx, g1, g2):
        mu, sigma, w_mu, w_sigma, win, relu_out = ctx.saved_tensors
        need_mu, need_sigma, need_w, need_ws = ctx.needs_input_grad[:4]
        if ctx.fuse_relu:
            # the saved mask (bool), or mu_out itself
            mask = relu_out if relu_out.dtype == torch.bool else relu_out > 0
            g1 = torch.where(mask, g1, 0.0)
            g2 = torch.where(mask, g2, 0.0)
        g2 = g2.contiguous()
        k = w_mu.shape[-3]
        b, ho, wo, _ = g1.shape
        u, d_sw = winsum_spread_bwd(
            g2, win.reshape(b, ho, wo), F.softplus(w_sigma).contiguous(), k
        )
        g_win = u[..., None]
        d_mu = d_sigma = d_w = d_ws = None
        if need_mu or need_sigma:
            c1, c2 = conv_t_pair(g1, g2 if need_sigma else None, w_mu, ctx.precision)
            # a [K,B,...] input (a shared one too) gets its gradient in its
            # own shape; autograd sums a shared one over the members. 2 mu
            # is exact in bf16, and its product with the float32 u is
            # float32
            if need_mu:
                d_mu = (c1 + 2.0 * mu.reshape(c1.shape) * g_win).view(mu.shape)
                d_mu = d_mu.to(mu.dtype)
            if need_sigma:
                d_sigma = (g_win + c2).view(sigma.shape).to(sigma.dtype)
        if need_w:
            mu, g1 = _wide(mu), _wide(g1)
            d_w = _filter_grad(mu, g1, w_mu.shape)
            if sigma is not None:
                sigma, g2 = _wide(sigma), _wide(g2)
                d_w = d_w + 2.0 * w_mu * _filter_grad(sigma, g2, w_mu.shape)
        if need_ws:
            d_ws = d_sw * torch.sigmoid(w_sigma)
        return d_mu, d_sigma, d_w, d_ws, None, None
