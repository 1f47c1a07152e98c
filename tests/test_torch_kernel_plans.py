"""The planners of the sigma-chain backward (kernel 4), the pool backward
(kernel 3) and the pool forward (kernel 2) on the CPU: for every layer shape
of both configs and the extra shapes chip_smoke.py drives, the plan's grid
covers the work exactly once and fills the card; an emulation of what the
planned kernels compute (flat dt, spread, per-block dsw partials folded in
the kernel's order; one write per window tap; one read of every input and
one write of every output per pooled window and 16 bytes of channels)
agrees with the plain versions and with the JAX package's Pallas kernels in
interpret mode. The CUDA kernels themselves are held against the same plain
versions on the card by chip_smoke.py."""

import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops.moments import _vmaxpool_bwd, _vmaxpool_fwd_impl  # noqa: E402
from supernet_tpu.ops.pallas import pool as jpool  # noqa: E402
from supernet_tpu.ops.pallas import sigma_bwd as jsigma_bwd  # noqa: E402
from supernet_tpu_torch import hlo_profile, profiling  # noqa: E402
from supernet_tpu_torch import xplane as X  # noqa: E402
from supernet_tpu_torch.configs import get_config  # noqa: E402
from supernet_tpu_torch.models import layer_names  # noqa: E402
from supernet_tpu_torch.ops.kernels import pool, sigma_bwd  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCH = {"hippocampus": 20, "brats": 2}  # the batches chip_smoke.py drives
CONVS = [(c, name) for c in BATCH
         for name, k, _, _ in layer_names(get_config(c).model) if k == 3]
POOLS = [(c, f"pool{i}") for c in BATCH
         for i in range(get_config(c).model.depth - 1)]
# (b, h', w', c, k): chip_smoke.py's extra cases, tiny test widths, a width
# above the 16-byte path's and one that is no multiple of 4
EXTRA_SIGMA = [
    (3, 17, 19, 130, 3), (3, 17, 19, 36, 3), (4, 32, 28, 40, 2),
    (2, 8, 8, 8, 3), (2, 9, 7, 4, 2), (1, 5, 5, 384, 1), (1, 4, 4, 516, 3),
    (2, 6, 6, 6, 3),
]
# (b, h, w, c): chip_smoke.py's extra cases and tiny widths, odd sizes
EXTRA_POOL = [
    (20, 60, 60, 32), (3, 8, 8, 130), (3, 13, 15, 36), (2, 9, 7, 64),
    (3, 13, 15, 130), (2, 7, 8, 4), (1, 1, 1, 8),
]
REL_TOL = 1e-6  # emulated split against the plain version, of its max


@functools.lru_cache(maxsize=None)
def _shapes(config):
    """({conv: (b, h', w', c, 3)}, {pool: (b, h, w, c)}) of one step."""
    convs, pools = profiling.layer_shapes(get_config(config).model)
    b = BATCH[config]
    return ({name: (b, h - 2, w - 2, cout, 3) for name, (_, h, w, _), cout in convs},
            {name: (b, h, w, c) for name, (_, h, w, c) in pools})


def _sigma_inputs(b, hp, wp, c, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1, (b, hp, wp, c)).astype(np.float32)
    t = (10.0 * np.abs(rng.normal(0, 1, (b, hp, wp)))).astype(np.float32)
    s_w = rng.uniform(0.01, 0.2, (c,)).astype(np.float32)
    return g, t, s_w


# ----------------------------------------------------------- kernel 4: plan


def _check_sigma_plan(b, hp, wp, c, k):
    p = sigma_bwd.plan(b, hp, wp, c, k)
    pixels = b * hp * wp
    h, w = hp + k - 1, wp + k - 1
    if c % 4 == 0 and c <= sigma_bwd.MAX_VEC_C:
        assert p.path == "vec4"
        # a pixel's float4 fit its group's lanes and steps, no wider than needed
        assert p.lanes in (8, 16, 32) and 1 <= p.steps <= 4
        assert p.lanes * p.steps >= c // 4
        assert p.lanes == 8 or c // 4 > p.lanes // 2
        assert p.steps == -(-(c // 4) // p.lanes)
        assert p.lanes == 32 or p.steps == 1
        assert p.unroll * p.steps <= 4
        assert 1 <= p.blocks <= sigma_bwd.MAX_BLOCKS
        assert p.groups == p.blocks * (sigma_bwd.THREADS // p.lanes)
        # group i visits pixels i, i + groups, ...: every pixel exactly once
        visits = (np.arange(p.groups)[:, None]
                  + np.arange(p.trips)[None, :] * p.groups).ravel()
        seen = np.bincount(visits[visits < pixels], minlength=pixels)
        assert seen.shape == (pixels,) and (seen == 1).all()
        assert (p.trips - 1) * p.groups < pixels  # no trip without a pixel
        # pass 2: the fold blocks, then one thread per element of u
        assert p.dsw_blocks * sigma_bwd.DSW_CHANNELS >= c
        assert (p.spread_blocks - p.dsw_blocks) * sigma_bwd.THREADS >= b * h * w
        assert p.scratch_floats >= pixels + p.blocks * c
        assert (p.scratch_floats - p.blocks * c) % 4 == 0  # partials on 16 bytes
    else:
        assert p.path == "rows"
        tiles = -(-h // sigma_bwd.ROWS)
        assert p.blocks == b * tiles
        # tile i owns u rows and g rows [i ROWS, (i+1) ROWS): each g row once
        owner = np.arange(hp) // sigma_bwd.ROWS
        assert owner.max() < tiles
    if 4 * pixels * c >= 1 << 20:
        assert p.blocks >= sigma_bwd.SMS
    assert p.smem_bytes <= sigma_bwd.SMEM_LIMIT
    # the partial rows depend on the shape only
    sigma_bwd.plan.cache_clear()
    assert sigma_bwd.plan(b, hp, wp, c, k) == p
    return p


@pytest.mark.parametrize("config,layer", CONVS)
def test_sigma_bwd_plan_every_layer(config, layer):
    p = _check_sigma_plan(*_shapes(config)[0][layer])
    assert p.path == "vec4"  # every model width is a multiple of 4, <= 512


@pytest.mark.parametrize("shape", EXTRA_SIGMA)
def test_sigma_bwd_plan_extra_shapes(shape):
    p = _check_sigma_plan(*shape)
    assert p.path == ("vec4" if shape[3] % 4 == 0 and shape[3] <= 512 else "rows")


MEMBERS = {"hippocampus": 4, "brats": 2}  # the ensembles chip_smoke.py drives


@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
@pytest.mark.parametrize("config,layer", CONVS)
def test_sigma_bwd_plan_members_every_layer(config, layer, sms):
    """The member axis: ``members=1`` on 132 SMs is the plan of the shape
    alone; with K members each member's grid walks that member's pixels
    alone, exactly once (so a dsw partial row never mixes two members), the
    members' grids together stay within BLOCKS_PER_SM blocks per SM, pass 2
    folds each member's partial rows and covers all K x B images of u, and
    the scratch holds every member's dt and partial rows."""
    b, hp, wp, c, k = _shapes(config)[0][layer]
    members = MEMBERS[config]
    one = sigma_bwd.plan(b, hp, wp, c, k, 1, sms)
    if sms == sigma_bwd.SMS:
        assert one == sigma_bwd.plan(b, hp, wp, c, k)
    p = sigma_bwd.plan(b, hp, wp, c, k, members, sms)
    pixels = b * hp * wp
    assert p.path == one.path == "vec4"
    assert (p.lanes, p.steps, p.unroll) == (one.lanes, one.steps, one.unroll)
    assert members * p.blocks <= max(members, sigma_bwd.BLOCKS_PER_SM * sms)
    assert p.groups == p.blocks * (sigma_bwd.THREADS // p.lanes)
    visits = (np.arange(p.groups)[:, None]
              + np.arange(p.trips)[None, :] * p.groups).ravel()
    seen = np.bincount(visits[visits < pixels], minlength=pixels)
    assert seen.shape == (pixels,) and (seen == 1).all()  # within the member
    assert p.dsw_blocks == members * -(-c // sigma_bwd.DSW_CHANNELS)
    h, w = hp + k - 1, wp + k - 1
    assert (p.spread_blocks - p.dsw_blocks) * sigma_bwd.THREADS >= members * b * h * w
    assert p.scratch_floats >= members * pixels + members * p.blocks * c
    assert (p.scratch_floats - members * p.blocks * c) % 4 == 0


@pytest.mark.parametrize("shape,members", [
    ((2, 8, 8, 8, 3), 2), ((3, 17, 19, 36, 3), 4), ((2, 9, 11, 6, 3), 3),
    ((20, 60, 60, 32, 3), 4),
])
def test_sigma_bwd_members_split_matches_plain_and_pallas(shape, members):
    """What the member-axis kernels compute (each member's planned split in
    turn, its own s_w) against the member-axis plain version and, at the
    small shapes, ``jax.vmap`` of the Pallas ``_bwd_call`` in interpret
    mode, each within REL_TOL of the output's max."""
    b, hp, wp, c, k = shape
    ins = [_sigma_inputs(b, hp, wp, c, seed=i) for i in range(members)]
    g, t, s_w = (torch.from_numpy(np.stack(a)) for a in zip(*ins))
    p = sigma_bwd.plan(b, hp, wp, c, k, members)
    if p.path == "rows":  # its blocks are all members'; one member's share
        p = p._replace(blocks=p.blocks // members)
    outs = [_emulate_sigma_bwd(g[i], t[i], s_w[i], k, p) for i in range(members)]
    u, dsw = torch.cat([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    want_u, want_dsw = sigma_bwd.winsum_spread_bwd_plain(g.flatten(0, 1), t.flatten(0, 1),
                                                         s_w, k)
    assert u.shape == want_u.shape == (members * b, hp + k - 1, wp + k - 1)
    assert dsw.shape == want_dsw.shape == (members, c)
    assert _rel(u, want_u) <= REL_TOL and _rel(dsw, want_dsw) <= REL_TOL
    if b * hp * wp <= 1000:
        import jax

        ju, jdsw = jax.vmap(lambda a, bb, s: jsigma_bwd._bwd_call(a, bb, s, k, interpret=True))(
            *(jnp.asarray(x.numpy()) for x in (g, t, s_w)))
        assert _rel(u, torch.from_numpy(np.asarray(ju)).reshape(u.shape)) <= REL_TOL
        assert _rel(dsw, torch.from_numpy(np.asarray(jdsw))) <= REL_TOL


# ------------------------------------------------- kernel 4: the arithmetic


def _emulate_sigma_bwd(g, t, s_w, k, p):
    """What the planned kernels compute, in torch float32. "vec4": dt flat
    by pixel, u spread from it, dsw as one partial row per block (pixel i
    belongs to group i % groups, groups are dealt to blocks in order) folded
    as pass 2 does: the rows dealt to THREADS / DSW_CHANNELS slices, each
    slice's rows in order, then a tree over the slices. "rows": a partial
    per block of ROWS rows of one image, summed."""
    b, hp, wp, c = g.shape
    pixels = b * hp * wp
    gf = g.reshape(pixels, c)
    dt = (gf * s_w).sum(-1).reshape(b, hp, wp)
    u = torch.zeros(b, hp + k - 1, wp + k - 1)
    for di in range(k):
        for dj in range(k):
            u[:, di:di + hp, dj:dj + wp] += dt
    gt = gf * t.reshape(pixels, 1)
    if p.path == "rows":
        tile = (torch.arange(hp) // sigma_bwd.ROWS).repeat_interleave(wp).repeat(b)
        image = torch.arange(b).repeat_interleave(hp * wp)
        tiles = p.blocks // b
        part = torch.zeros(p.blocks, c).index_add_(0, image * tiles + tile, gt)
        return u, part.sum(0)
    block = (torch.arange(pixels) % p.groups) // (p.groups // p.blocks)
    part = torch.zeros(p.blocks, c).index_add_(0, block, gt)
    slices = sigma_bwd.THREADS // sigma_bwd.DSW_CHANNELS
    rounds = -(-p.blocks // slices)
    padded = torch.zeros(rounds * slices, c)
    padded[:p.blocks] = part
    fold = torch.zeros(slices, c)
    for r in padded.reshape(rounds, slices, c):
        fold = fold + r
    while len(fold) > 1:
        half = len(fold) // 2
        fold = fold[:half] + fold[half:]
    return u, fold[0]


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _check_emulation(b, hp, wp, c, k):
    g, t, s_w = (torch.from_numpy(a) for a in _sigma_inputs(b, hp, wp, c))
    p = sigma_bwd.plan(b, hp, wp, c, k)
    u, dsw = _emulate_sigma_bwd(g, t, s_w, k, p)
    want_u, want_dsw = sigma_bwd.winsum_spread_bwd_plain(g, t, s_w, k)
    assert u.shape == want_u.shape and dsw.shape == want_dsw.shape
    assert _rel(u, want_u) <= REL_TOL
    assert _rel(dsw, want_dsw) <= REL_TOL


@pytest.mark.parametrize("config,layer", CONVS)
def test_sigma_bwd_split_matches_plain_every_layer(config, layer):
    _check_emulation(*_shapes(config)[0][layer])


@pytest.mark.parametrize("shape", EXTRA_SIGMA)
def test_sigma_bwd_split_matches_plain_extra_shapes(shape):
    _check_emulation(*shape)


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 8, 3), (2, 8, 8, 4, 2), (2, 35, 35, 16, 3),  # tests/test_sigma_bwd.py
    (3, 17, 19, 36, 3), (2, 9, 11, 6, 3), (1, 5, 5, 384, 1),
])
def test_sigma_bwd_split_matches_pallas_interpret(shape):
    """The tolerance of tests/test_torch_kernels.py for the plain version."""
    b, hp, wp, c, k = shape
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (b, hp, wp, c)).astype(np.float32)
    t = rng.normal(0, 1, (b, hp, wp)).astype(np.float32)
    s_w = rng.uniform(0.01, 0.2, (c,)).astype(np.float32)
    want = jsigma_bwd._bwd_call(jnp.asarray(g), jnp.asarray(t), jnp.asarray(s_w),
                                k, interpret=True)
    p = sigma_bwd.plan(b, hp, wp, c, k)
    got = _emulate_sigma_bwd(*(torch.from_numpy(a) for a in (g, t, s_w)), k, p)
    assert got[0].shape == (b, hp + k - 1, wp + k - 1) and got[1].shape == (c,)
    for x, r in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- kernel 3


def _emulate_pool_bwd(idx, g_mu, g_sigma, h, w, p):
    """What the planned kernel writes, and how often each element: "vec4"
    writes, per window, the taps that lie inside h x w; "scalar" writes per
    full-resolution element from its window. Unwritten elements stay NaN."""
    b, ho, wo, c = idx.shape
    outs = [torch.full((b, h, w, c), float("nan")) for _ in range(2)]
    writes = torch.zeros(b, h, w, c, dtype=torch.int32)
    if p.path == "vec4":
        assert c % p.channels == 0 and p.items == b * ho * wo * (c // 4)
        for tap in range(4):
            dy, dx = tap >> 1, tap & 1
            ny, nx = len(range(dy, h, 2)), len(range(dx, w, 2))
            sel = idx[:, :ny, :nx] == float(tap)
            for out, g in zip(outs, (g_mu, g_sigma)):
                out[:, dy::2, dx::2] = torch.where(sel, g[:, :ny, :nx], 0.0)
            writes[:, dy::2, dx::2] += 1
    else:
        assert p.items == b * h * w * c
        ys, xs = torch.arange(h), torch.arange(w)
        tap = (2 * (ys % 2)[:, None] + (xs % 2)[None, :]).float()
        sel = idx[:, ys // 2][:, :, xs // 2] == tap[None, :, :, None]
        for out, g in zip(outs, (g_mu, g_sigma)):
            out[:] = torch.where(sel, g[:, ys // 2][:, :, xs // 2], 0.0)
        writes += 1
    return outs, writes


def _pool_case(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.integers(-3, 3, (b, h, w, c)).astype(np.float32)  # ties
    sigma = np.abs(rng.normal(0, 1, (b, h, w, c))).astype(np.float32)
    ho, wo = (h + 1) // 2, (w + 1) // 2
    g = [rng.normal(0, 1, (b, ho, wo, c)).astype(np.float32) for _ in range(2)]
    return mu, sigma, g


def _check_pool_plan(b, h, w, c):
    p = pool.plan_bwd(b, h, w, c)
    assert p.path == ("vec4" if c % 4 == 0 else "scalar")
    assert p.channels == (4 if c % 4 == 0 else 1)
    assert p.blocks == -(-p.items // pool.THREADS)
    mu, sigma, g = _pool_case(b, h, w, c)
    idx = pool.vmaxpool(torch.from_numpy(mu), torch.from_numpy(sigma),
                        return_idx=True)[2]
    g_mu, g_sigma = (torch.from_numpy(a) for a in g)
    got, writes = _emulate_pool_bwd(idx, g_mu, g_sigma, h, w, p)
    assert (writes == 1).all()  # every element once, odd edges included
    want = pool.vmaxpool_bwd_plain(idx, g_mu, g_sigma, h, w)
    for x, r in zip(got, want):
        assert torch.equal(x, r)
    return idx, g, got


@pytest.mark.parametrize("config,layer", POOLS)
def test_pool_bwd_plan_every_layer(config, layer):
    b, h, w, c = _shapes(config)[1][layer]
    _check_pool_plan(b, h, w, c)
    assert pool.plan_bwd(b, h, w, c).path == "vec4"


@pytest.mark.parametrize("shape", EXTRA_POOL)
def test_pool_bwd_plan_extra_shapes_bit_exact_vs_jax(shape):
    """The emulated kernel against the JAX package: the Pallas backward in
    interpret mode for even sizes, its composition for odd ones."""
    b, h, w, c = shape
    idx, g, got = _check_pool_plan(b, h, w, c)
    jg = tuple(jnp.asarray(a) for a in g)
    if h % 2 == 0 and w % 2 == 0:
        jpool.set_interpret(True)
        try:
            want = jpool._vmp_bwd(jnp.asarray(idx.numpy()), jg)
        finally:
            jpool.set_interpret(False)
    else:
        mu, sigma, _ = _pool_case(b, h, w, c)
        _, _, res = _vmaxpool_fwd_impl(jnp.asarray(mu), jnp.asarray(sigma))
        np.testing.assert_array_equal(np.asarray(res[0]), idx.numpy())
        want = _vmaxpool_bwd(res, jg)
    for x, r in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(r))


def test_cpu_tensors_never_count_a_launch():
    pool.bwd_launches = sigma_bwd.launches = 0
    g, t, s_w = (torch.from_numpy(a) for a in _sigma_inputs(1, 4, 4, 8))
    sigma_bwd.winsum_spread_bwd(g, t, s_w, 3)
    idx = torch.zeros(1, 2, 2, 4)
    pool.vmaxpool_bwd(idx, idx, idx, 4, 4)
    assert sigma_bwd.launches == 0 and pool.bwd_launches == 0


@pytest.mark.parametrize("config", list(BATCH))
def test_layer_shapes_name_every_conv_and_pool(config):
    convs, pools = _shapes(config)
    assert set(convs) == {name for c, name in CONVS if c == config}
    assert set(pools) == {name for c, name in POOLS if c == config}


# ---------------------------------------------------------------- kernel 2


def _nan_max(a, b):
    """The kernel's nan_max: a NaN in either operand is the result."""
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.where(a > b, a, b)))


def _emulate_pool_fwd(mu, sigma, p, pad):
    """What the planned forward writes, and how often it reads each input
    element and writes each output element. Thread i of ``p.items`` takes
    one pooled window and ``p.channels`` channels (1 on the scalar path),
    channels fastest; it loads the taps that lie inside h x w, a missing
    tap counting as ``pad`` for mu and 0 for sigma, and selects in float32
    (the bf16 kernel's bf16x2 max and equality are the same relations on
    the same values). ``mu``, ``sigma``: float32 numpy arrays holding
    values of the moments' dtype. Unwritten outputs stay NaN."""
    b, h, w, c = mu.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    v = p.channels
    assert c % v == 0 and p.items == b * ho * wo * (c // v)
    assert p.blocks == -(-p.items // p.threads) and p.threads % 32 == 0
    i = np.arange(p.items, dtype=np.int64)
    cv, r = i % (c // v), i // (c // v)
    ox, r = r % wo, r // wo
    oy, bb = r % ho, r // ho
    ch = (cv * v)[:, None] + np.arange(v)[None, :]  # [items, v]
    taps_m, taps_s, flat_in = [], [], []
    for tap in range(4):
        y, x = 2 * oy + (tap >> 1), 2 * ox + (tap & 1)
        inside = (y < h) & (x < w)
        flat = ((bb * h + np.where(inside, y, 0)) * w + np.where(inside, x, 0))[:, None] * c + ch
        taps_m.append(np.where(inside[:, None], mu.reshape(-1)[flat], pad))
        taps_s.append(np.where(inside[:, None], sigma.reshape(-1)[flat], 0.0).astype(np.float32))
        flat_in.append(flat[inside].ravel())
    reads = np.bincount(np.concatenate(flat_in), minlength=mu.size).reshape(mu.shape)
    m00, m01, m10, m11 = taps_m
    s00, s01, s10, s11 = taps_s
    with np.errstate(invalid="ignore"):
        mx = _nan_max(_nan_max(m00, m01), _nan_max(m10, m11))
        p0 = m00 == mx
        p1 = ~p0 & (m01 == mx)
        p2 = ~(p0 | p1) & (m10 == mx)
    so = np.where(p0, s00, np.where(p1, s01, np.where(p2, s10, s11)))
    tap = np.where(p0, 0.0, np.where(p1, 1.0, np.where(p2, 2.0, 3.0))).astype(np.float32)
    out_flat = ((bb * ho + oy) * wo + ox)[:, None] * c + ch
    writes = np.bincount(out_flat.ravel(), minlength=b * ho * wo * c)
    outs = []
    for val in (mx, so, tap):
        o = np.full(b * ho * wo * c, np.nan, np.float32)
        o[out_flat.ravel()] = val.ravel()
        outs.append(o.reshape(b, ho, wo, c))
    return outs, reads, writes.reshape(b, ho, wo, c)


DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pool_fwd_inputs(b, h, w, c, dtype, nan, seed=0):
    """Seeded mu with ties (and with ``nan`` a NaN every 7th element) and
    sigma >= 0, as float32 numpy arrays of values exact in ``dtype``."""
    rng = np.random.default_rng(seed)
    mu = rng.integers(-3, 3, (b, h, w, c)).astype(np.float32)
    if nan:
        mu.reshape(-1)[::7] = np.nan
    sigma = np.abs(rng.normal(0, 1, (b, h, w, c))).astype(np.float32)
    tdt = DTYPES[dtype][0]
    return mu, torch.from_numpy(sigma).to(tdt).float().numpy()


def _check_pool_fwd(b, h, w, c, dtype, nan=False):
    """The planned forward emulated at one shape: every input element read
    once, every output written once, bit-exact with the JAX package (the
    Pallas kernel in interpret mode for even sizes, its composition for odd
    ones) and with the plain version. Returns the plan."""
    tdt, jdt = DTYPES[dtype]
    itemsize = torch.finfo(tdt).bits // 8
    p = pool.plan_fwd(b, h, w, c, itemsize, 132)
    v = 16 // itemsize
    assert p.path == ("vec" if c % v == 0 else "scalar")
    assert p.channels == (v if c % v == 0 else 1)
    mu, sigma = _pool_fwd_inputs(b, h, w, c, dtype, nan)
    pad = float(torch.finfo(tdt).min)
    got, reads, writes = _emulate_pool_fwd(mu, sigma, p, np.float32(pad))
    assert (reads == 1).all() and (writes == 1).all()  # odd edges included
    got = [torch.from_numpy(x).to(tdt) for x in got]
    jmu, jsigma = jnp.asarray(mu).astype(jdt), jnp.asarray(sigma).astype(jdt)
    if h % 2 == 0 and w % 2 == 0:
        jpool.set_interpret(True)
        try:
            (jmx, jso), jidx = jpool._vmp_fwd(jmu, jsigma)
        finally:
            jpool.set_interpret(False)
    else:
        jmx, jso, (jidx, _) = _vmaxpool_fwd_impl(jmu, jsigma)
    plain = pool.vmaxpool_plain(torch.from_numpy(mu).to(tdt), torch.from_numpy(sigma).to(tdt))
    for x, r, q in zip(got, (jmx, jso, jidx), plain):
        assert r.dtype == jdt and q.dtype == tdt
        np.testing.assert_array_equal(x.float().numpy(), np.asarray(r.astype(jnp.float32)))
        np.testing.assert_array_equal(x.float().numpy(), q.float().numpy())
    return p


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("config,layer", POOLS)
def test_pool_fwd_plan_every_layer_bit_exact_vs_jax(config, layer, dtype):
    b, h, w, c = _shapes(config)[1][layer]
    p = _check_pool_fwd(b, h, w, c, dtype)
    assert p.path == "vec"
    # every SM gets a block where the layer has the threads for it
    if p.items >= 132 * pool.FWD_THREADS[-1]:
        assert p.blocks >= 132


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", EXTRA_POOL)
def test_pool_fwd_plan_extra_shapes_bit_exact_vs_jax(shape, dtype, nan):
    """C = 130 on the scalar path in both dtypes, C = 36 in bf16 too;
    odd sizes on either path; a NaN every 7th mu."""
    _check_pool_fwd(*shape, dtype, nan)


def test_pool_fwd_plan_block_size():
    """Blocks as large as FWD_THREADS allows while every SM gets one: a
    large pool in the largest blocks, a small one in smaller blocks, the
    smallest when even those leave SMs idle; the SM count is the card's."""
    big_t, small_t = pool.FWD_THREADS[0], pool.FWD_THREADS[-1]
    assert big_t > small_t
    big = pool.plan_fwd(20, 60, 60, 32, 2, 132)
    assert (big.items, big.threads, big.blocks) == (72000, big_t, -(-72000 // big_t))
    small = pool.plan_fwd(2, 18, 18, 256, 2, 132)  # BraTS pool3 in bf16
    assert (small.items, small.threads) == (5184, small_t)
    assert -(-5184 // big_t) < 132 <= small.blocks
    assert pool.plan_fwd(2, 18, 18, 256, 2, -(-5184 // big_t)).threads == big_t
    tiny = pool.plan_fwd(1, 2, 2, 8, 2, 132)
    assert (tiny.threads, tiny.blocks) == (small_t, 1)
    assert pool.plan_fwd(3, 8, 8, 130, 2, 132).threads == pool.THREADS


def test_cpu_pool_fwd_never_counts_a_launch():
    pool.launches = 0
    mu = torch.zeros(1, 4, 4, 8)
    pool.vmaxpool(mu, mu, return_idx=True)
    pool.VMaxPool.apply(mu.requires_grad_(), mu)
    assert pool.launches == 0


def _pool_kernel_names():
    src = (Path(pool.__file__).resolve().parents[2] / "csrc" / "pool.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", src)
    assert len(names) == 4
    return names


@pytest.mark.parametrize("kernel", _pool_kernel_names())
def test_every_pool_kernel_name_falls_in_its_category(kernel):
    """The profiler's three name keys (``profiling.CATEGORIES``,
    ``hlo_profile.launch_counter``, ``xplane.op_class``) file each
    ``__global__`` of csrc/pool.cu, in both dtypes, under its own kernel."""
    fwd = "_fwd" in kernel
    for t in ("float", "__nv_bfloat16"):
        name = f"void (anonymous namespace)::{kernel}<{t}>(uint4 const*, int, int)"
        assert profiling.category(name) == (
            "pool forward (kernel 2)" if fwd else "pool backward (kernel 3)")
        assert hlo_profile.launch_counter(name) == ("vmaxpool" if fwd else "vmaxpool_bwd")
        assert X.op_class(name, "kernel") == (X.POOL_FWD if fwd else X.POOL_BWD)
