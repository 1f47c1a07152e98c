"""Sigma-chain backward of the fused VDP conv: the CUDA kernel and its plain
version.

Counterpart of ``supernet_tpu/ops/pallas/sigma_bwd.py:_bwd_call``. The
variance output of a VDP conv holds the term ``win[..., None] * s_w`` (``win``
the k x k window sum of the channel-summed source, ``s_w =
softplus(w_sigma)``). Given its cotangent ``g`` [B,H',W',C], one pass gives

    u   = spread_k(sum_c g * s_w)     [B,H'+k-1,W'+k-1]  (the cotangent of the source)
    dsw = sum_{b,h',w'} g * win       [C]                (the cotangent of s_w)

where ``spread_k`` is the transposed k x k ones convolution. The kernels are
in ``csrc/sigma_bwd.cu``. The work is a streaming pass over ``g``, bound by
bytes (by the cost of a launch at the small layers), and :func:`plan` lays
it out from the shape alone:

- ``"vec4"`` (C % 4 == 0, C <= 512: every model width): two kernels. The
  first walks ``g`` flat by pixel with 16-byte loads, a group of 8, 16 or 32
  lanes per pixel, writes ``dt`` to a scratch and one ``dsw`` partial row per
  block; the second writes ``u`` from ``dt`` and folds the partial rows.
- ``"rows"`` (any other C): one kernel, a block per ROWS rows of ``u`` of one
  image with a recomputed halo, and ``torch.sum`` over its per-block ``dsw``
  partials.

Neither uses atomics, and the grid and the order of every sum depend on the
shape only, so ``u`` and ``dsw`` are the same bits in every run.

Dtypes, as the TPU kernel's (``sigma_bwd.py:82-84, 106, 172-173``): ``g``
and ``t`` are each float32 or bf16 and ``s_w`` float32; the sums run in
float32, ``u`` comes out in ``t``'s dtype and ``dsw`` in float32. A bf16
call keeps the float32 plan, so it computes the float32 call on the same
values and rounds ``u`` once.

Member axis (a deep ensemble's K parameter sets in one launch, the
counterpart of ``jax.vmap`` over the Pallas call): ``s_w`` [K, C] with ``g``
[K*B,H',W',C] and ``t`` [K*B,H',W'] member-major give ``u`` [K*B,H,W] and
``dsw`` [K, C]; every partial row of ``dsw`` belongs to one member.
:func:`winsum_spread_bwd` launches the planned kernels for CUDA tensors and
takes :func:`winsum_spread_bwd_plain` only for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from supernet_tpu_torch.ops.kernels import _lib

# Calls of the op that launched its kernels in this process (the two kernels
# of the "vec4" path count as one); chip_smoke.py zeroes and reads it to show
# that the training path went through the kernels.
launches = 0

# The planner's constants: the SM count of the shape-only plan (H100 SXM; a
# launch plans with its own card's count, ``_lib.sm_count``), the threads of
# a block, pass 1's blocks per SM (two blocks of 256 threads per SM: on the card
# one and three per SM were 1-6% slower over a train step's layers, four 4%
# and eight 18-25%, each block paying for its fold and its partial row), the
# widest C whose dsw sums fit a lane's registers (4 float4 per lane of 32),
# the channels per dsw-fold block of pass 2, and the shared memory a block
# may ask for.
SMS = 132
THREADS = 256
BLOCKS_PER_SM = 2
MAX_BLOCKS = BLOCKS_PER_SM * SMS  # pass 1's grid cap at SMS and one member
MAX_VEC_C = 512
DSW_CHANNELS = 8
SMEM_LIMIT = 232448
# "rows" path, u rows per block: a block recomputes k-1 halo rows of dt, so
# fewer rows cost more re-reads of g and more rows give fewer blocks.
ROWS = 8


class Plan(NamedTuple):
    """How one call runs. ``path`` "vec4" or "rows"; ``lanes`` per pixel,
    16-byte ``steps`` per lane and pixel, pixels per trip (``unroll``);
    ``blocks`` of the main kernel per member, which is also the number of
    a member's dsw partial rows; ``groups``: the pixel groups of one
    member's grid, the stride of the walk over its pixels; ``trips``: the
    most pixels one group visits; ``spread_blocks`` of pass 2, the first
    ``dsw_blocks`` of which fold the partials (all members); static or
    dynamic shared memory of the main kernel and the floats of scratch (dt,
    then the partial rows on a 16-byte boundary). The "rows" path's
    ``blocks`` are those of all members."""

    path: str
    lanes: int
    steps: int
    unroll: int
    blocks: int
    groups: int
    trips: int
    spread_blocks: int
    dsw_blocks: int
    smem_bytes: int
    scratch_floats: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(b: int, hp: int, wp: int, c: int, k: int, members: int = 1,
         sms: int = SMS) -> Plan:
    """The kernel plan for ``members`` members of g [b,hp,wp,c] and a k x k
    window, from the shape alone (no CUDA: the CPU tests call it), for a
    card of ``sms`` SMs.

    "vec4": a pixel's c/4 float4 go to the fewest lanes of 8, 16 or 32 that
    hold them, in ceil(c/128) steps per lane; a block of THREADS has
    THREADS/lanes groups. Each member's grid gives every group at least one
    pixel and stops where the members' grids together reach BLOCKS_PER_SM
    blocks per SM (one block per member at least), beyond which the groups
    walk on with the grid's stride; each trip takes 4/steps pixels. Pass 2
    has one thread per element of u behind ceil(c/8) fold blocks per
    member."""
    pixels = b * hp * wp
    h, w = hp + k - 1, wp + k - 1
    if (c % 4 == 0 and c <= MAX_VEC_C and members * b * h * w < 2 ** 31
            and members <= 65535):
        c4 = c // 4
        lanes = 8 if c4 <= 8 else 16 if c4 <= 16 else 32
        steps = _cdiv(c4, lanes)
        per_block = THREADS // lanes
        cap = max(1, BLOCKS_PER_SM * sms // members)
        blocks = max(1, min(_cdiv(pixels, per_block), cap))
        groups = blocks * per_block
        dsw_blocks = members * _cdiv(c, DSW_CHANNELS)
        return Plan("vec4", lanes, steps, max(1, 4 // steps), blocks, groups,
                    _cdiv(pixels, groups),
                    dsw_blocks + _cdiv(members * b * h * w, THREADS), dsw_blocks,
                    16 * (THREADS // 32) * lanes * steps,
                    _cdiv(members * pixels, 4) * 4 + members * blocks * c)
    tiles = _cdiv(h, ROWS)
    smem = 4 * ((ROWS + k - 1) * (wp + 2 * (k - 1)) + (1 + THREADS // 32) * c)
    return Plan("rows", 32, _cdiv(c, 32), 1, members * b * tiles, 0, 0, 0, 0,
                smem, 0)


def winsum_spread_bwd_plain(
    g: torch.Tensor, t: torch.Tensor, s_w: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch composition: ``(u, dsw)`` as in the module docstring; with
    ``s_w`` [K, C], member by member. A bf16 ``g`` or ``t`` is converted to
    float32 first; ``u`` comes out in ``t``'s dtype, ``dsw`` in float32 (or
    float64 for float64 inputs)."""
    if s_w.dim() == 2:
        n = s_w.shape[0]
        outs = [winsum_spread_bwd_plain(gi, ti, s_w[i], k) for i, (gi, ti)
                in enumerate(zip(g.unflatten(0, (n, -1)), t.unflatten(0, (n, -1))))]
        return torch.cat([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    u_dtype = t.dtype
    g, t = _lib.wide(g), _lib.wide(t)
    dt = (g * s_w).sum(dim=-1)
    ones = torch.ones((1, 1, k, k), dtype=g.dtype, device=g.device)
    u = F.conv_transpose2d(dt[:, None], ones)[:, 0]
    dsw = (g * t[..., None]).sum(dim=(0, 1, 2))
    return u.to(u_dtype).contiguous(), dsw



def _launch(g, t, s_w, k):
    global launches
    if g.dim() != 4 or s_w.dim() not in (1, 2):
        raise ValueError(f"winsum_spread_bwd: g must be [B,H',W',C] and s_w [C] "
                         f"or [K,C], got {tuple(g.shape)} and {tuple(s_w.shape)}")
    members = s_w.shape[0] if s_w.dim() == 2 else 1
    kb, hp, wp, c = g.shape
    if kb % members:
        raise ValueError(f"winsum_spread_bwd: {kb} images for {members} members")
    b = kb // members
    _lib.check_input("winsum_spread_bwd", "g", g, g.shape, _lib.MOMENT_DTYPES)
    _lib.check_input("winsum_spread_bwd", "t", t, (kb, hp, wp), _lib.MOMENT_DTYPES)
    _lib.check_input("winsum_spread_bwd", "s_w", s_w, tuple(s_w.shape[:-1]) + (c,))
    if t.device != g.device or s_w.device != g.device:
        raise ValueError("winsum_spread_bwd: inputs are on different devices")
    if k < 1 or c < 1 or min(hp, wp) < 1:
        raise ValueError(f"winsum_spread_bwd: unsupported sizes {tuple(g.shape)}, k={k}")
    u = torch.empty((kb, hp + k - 1, wp + k - 1), device=g.device, dtype=t.dtype)
    if b == 0:
        return u, torch.zeros(s_w.shape, device=g.device, dtype=torch.float32)
    p = plan(b, hp, wp, c, k, members, _lib.sm_count(g.device))
    dtypes = (_lib.dtype_code(g.dtype), _lib.dtype_code(t.dtype))
    lib = _lib.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if p.path == "vec4":
        g, s_w = _lib.aligned(g), _lib.aligned(s_w)
        scratch = torch.empty(p.scratch_floats, device=g.device, dtype=torch.float32)
        part = scratch[p.scratch_floats - members * p.blocks * c:]
        dsw = torch.empty(s_w.shape, device=g.device, dtype=torch.float32)
        with torch.cuda.device(g.device):
            err = lib.supernet_sigma_bwd_vec(
                g.data_ptr(), t.data_ptr(), s_w.data_ptr(), scratch.data_ptr(),
                part.data_ptr(), u.data_ptr(), dsw.data_ptr(),
                b, hp, wp, c, k, p.lanes, p.steps, p.blocks, members, *dtypes, stream,
            )
    else:
        part = torch.empty((p.blocks, c), device=g.device, dtype=torch.float32)
        with torch.cuda.device(g.device):
            err = lib.supernet_sigma_bwd(
                g.data_ptr(), t.data_ptr(), s_w.data_ptr(), u.data_ptr(),
                part.data_ptr(), b, hp, wp, c, k, ROWS, members, *dtypes, stream,
            )
        dsw = part.view(members, -1, c).sum(dim=1).view(s_w.shape)
    _lib.check(err, f"winsum_spread_bwd kernel launch ({p.path}, {p.blocks} blocks)")
    launches += 1
    return u, dsw


def winsum_spread_bwd(
    g: torch.Tensor, t: torch.Tensor, s_w: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u, dsw)`` from ``g`` [B,H',W',C], ``t`` [B,H',W'] (the forward's
    ``win``) and ``s_w`` [C]; or, for K members, ``s_w`` [K,C] with ``g``
    and ``t`` [K*B,...] member-major and ``dsw`` [K,C]. ``g`` and ``t`` are
    each float32 or bf16; ``u`` comes out in ``t``'s dtype, ``dsw`` in
    float32.

    CUDA tensors go to the kernels :func:`plan` picks (or raise), and give
    the same bits in every run; CPU tensors go to
    :func:`winsum_spread_bwd_plain`. Any other device raises.
    """
    if g.is_cuda:
        return _launch(g, t, s_w, k)
    if g.device.type != "cpu":
        raise ValueError(f"winsum_spread_bwd: unsupported device {g.device}")
    return winsum_spread_bwd_plain(g, t, s_w, k)
