"""The port's kernel modules (supernet_tpu_torch/ops/kernels) on the CPU:
their plain versions against the JAX package's Pallas kernels run in
interpret mode, the autograd Functions around them against jax.grad and
float64 gradcheck, and the launch counters untouched by CPU tensors. The
CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py."""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops.pallas import pool as jpool  # noqa: E402
from supernet_tpu.ops.pallas import sigma_bwd as jsigma_bwd  # noqa: E402
from supernet_tpu.ops.pallas import vdp_conv as jvdp_conv  # noqa: E402
from supernet_tpu_torch.ops.kernels import pool, sigma_bwd, vdp_conv  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the module, not the function the package re-exports under the same name
jvdp_module = importlib.import_module("supernet_tpu.ops.pallas.vdp_conv")

CASES = [
    # k, cin, cout, H, fuse_relu, has_sigma  (tests/test_pallas.py:12-19)
    (3, 8, 16, 12, False, True),
    (3, 8, 16, 12, True, True),
    (2, 8, 8, 10, False, True),
    (1, 16, 4, 9, False, True),
    (3, 1, 8, 12, False, False),
]
VDP_ATOL = 1e-4  # the tolerance of tests/test_pallas.py for the same cases


def _conv_inputs(k, cin, cout, h, has_sigma, seed=0):
    rng = np.random.default_rng(seed)

    def t(*s):
        return rng.normal(0, 1, s).astype(np.float32)

    mu = t(2, h, h, cin)
    sigma = np.abs(t(2, h, h, cin)) if has_sigma else None
    return mu, sigma, 0.3 * t(k, k, cin, cout), t(cout) - 5.0


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CASES)
def test_vdp_conv_plain_matches_pallas_interpret(k, cin, cout, h, fuse, has_sigma):
    mu, sigma, w_mu, w_sigma = _conv_inputs(k, cin, cout, h, has_sigma)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (mu, sigma, w_mu, w_sigma)]
    want_mu, want_sig = jvdp_conv(*jargs, fuse_relu=fuse, interpret=True)
    _, _, want_win = jvdp_module._pallas_forward(
        *jargs, fuse_relu=fuse, precision="highest", interpret=True
    )
    targs = [torch.from_numpy(a) if a is not None else None
             for a in (mu, sigma, w_mu, w_sigma)]
    got = vdp_conv.vdp_conv(*targs, fuse_relu=fuse)
    assert vdp_conv.launches == 0  # CPU tensors never reach the kernel
    for g, w in zip(got, (want_mu, want_sig, want_win)):
        assert g.shape == w.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VDP_ATOL)


def _pool_inputs(shape, ties, seed=0):
    rng = np.random.default_rng(seed)
    if ties:
        mu = rng.integers(-3, 3, shape).astype(np.float32)
    else:
        mu = rng.normal(0, 1, shape).astype(np.float32)
    return mu, np.abs(rng.normal(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("shape,ties", [
    ((2, 8, 8, 32), True),
    ((1, 12, 16, 8), False),
    ((3, 4, 4, 130), True),  # >1 lane tile (tests/test_pallas.py:119-123)
])
def test_vmaxpool_plain_bit_exact_vs_pallas_interpret(shape, ties):
    mu, sigma = _pool_inputs(shape, ties)
    jpool.set_interpret(True)
    try:
        (want_mx, want_so), want_idx = jpool._vmp_fwd(
            jnp.asarray(mu), jnp.asarray(sigma)
        )
    finally:
        jpool.set_interpret(False)
    got = pool.vmaxpool(torch.from_numpy(mu), torch.from_numpy(sigma),
                        return_idx=True)
    assert pool.launches == 0
    for g, w in zip(got, (want_mx, want_so, want_idx)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_vmaxpool_odd_shape_bit_exact_vs_composition():
    from supernet_tpu.ops.moments import _vmaxpool_fwd_impl

    mu, sigma = _pool_inputs((2, 7, 9, 4), ties=True)
    want_mx, want_so, (want_idx, _) = _vmaxpool_fwd_impl(
        jnp.asarray(mu), jnp.asarray(sigma)
    )
    mx, so, idx = pool.vmaxpool(torch.from_numpy(mu), torch.from_numpy(sigma),
                                return_idx=True)
    assert mx.shape == (2, 4, 5, 4)
    for g, w in zip((mx, so, idx), (want_mx, want_so, want_idx)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_vmaxpool_propagates_nan_like_jnp_maximum():
    mu = np.zeros((1, 2, 2, 1), np.float32)
    mu[0, 0, 1, 0] = np.nan
    sigma = np.arange(4, dtype=np.float32).reshape(1, 2, 2, 1)
    from supernet_tpu.ops.moments import _vmaxpool_fwd_impl

    want_mx, want_so, (want_idx, _) = _vmaxpool_fwd_impl(
        jnp.asarray(mu), jnp.asarray(sigma)
    )
    mx, so, idx = pool.vmaxpool(torch.from_numpy(mu), torch.from_numpy(sigma),
                                return_idx=True)
    assert np.isnan(mx.numpy()).all() and np.isnan(np.asarray(want_mx)).all()
    np.testing.assert_array_equal(so.numpy(), np.asarray(want_so))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_wrappers_reject_other_devices():
    meta = torch.empty((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError):
        pool.vmaxpool(meta, meta)
    with pytest.raises(ValueError):
        vdp_conv.vdp_conv(meta, None, torch.empty((3, 3, 2, 4), device="meta"),
                          torch.empty((4,), device="meta"))


def test_library_path_is_named_by_source_hash():
    from supernet_tpu_torch.ops.kernels import _lib

    path = _lib._library_path()
    assert path.parent == _lib.BUILD_DIR
    assert path.name.startswith("libsupernet_kernels_") and path.suffix == ".so"
    assert path == _lib._library_path()  # stable for unchanged sources
    assert {p.name for p in _lib._CSRC.glob("*.cu")} >= {
        "vdp_conv.cu", "pool.cu", "sigma_bwd.cu"}


POOL_SHAPES = [
    ((2, 8, 8, 32), True),
    ((1, 12, 16, 8), False),
    ((3, 4, 4, 130), True),  # >1 lane tile (tests/test_pallas.py:119-124)
]


def _no_launches():
    return (vdp_conv.launches, pool.launches, pool.bwd_launches,
            sigma_bwd.launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("shape,ties", POOL_SHAPES)
def test_vmaxpool_bwd_plain_bit_exact_vs_pallas_interpret(shape, ties):
    mu, sigma = _pool_inputs(shape, ties)
    b, h, w, c = shape
    rng = np.random.default_rng(1)
    g_mu, g_sigma = (rng.normal(0, 1, (b, h // 2, w // 2, c)).astype(np.float32)
                     for _ in range(2))
    jpool.set_interpret(True)
    try:
        _, idx = jpool._vmp_fwd(jnp.asarray(mu), jnp.asarray(sigma))
        want = jpool._vmp_bwd(idx, (jnp.asarray(g_mu), jnp.asarray(g_sigma)))
    finally:
        jpool.set_interpret(False)
    got = pool.vmaxpool_bwd(torch.from_numpy(np.asarray(idx)), torch.from_numpy(g_mu),
                            torch.from_numpy(g_sigma), h, w)
    assert _no_launches()
    for g, r in zip(got, want):
        assert g.shape == shape and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_vmaxpool_bwd_odd_shape_bit_exact_vs_composition():
    from supernet_tpu.ops.moments import _vmaxpool_bwd, _vmaxpool_fwd_impl

    mu, sigma = _pool_inputs((2, 7, 9, 4), ties=True)
    _, _, res = _vmaxpool_fwd_impl(jnp.asarray(mu), jnp.asarray(sigma))
    rng = np.random.default_rng(2)
    g = [rng.normal(0, 1, (2, 4, 5, 4)).astype(np.float32) for _ in range(2)]
    want = _vmaxpool_bwd(res, tuple(jnp.asarray(a) for a in g))
    got = pool.vmaxpool_bwd(torch.from_numpy(np.asarray(res[0])),
                            *(torch.from_numpy(a) for a in g), 7, 9)
    for x, r in zip(got, want):
        assert x.shape == (2, 7, 9, 4)
        np.testing.assert_array_equal(x.numpy(), np.asarray(r))


@pytest.mark.parametrize("shape,ties", POOL_SHAPES + [((2, 7, 9, 4), True)])
def test_vmaxpool_autograd_bit_exact_vs_jax_grad(shape, ties):
    """VMaxPool's gradient routes a tie to the first tap, as the JAX
    package's custom VJP does (autograd of torch.maximum would split it)."""
    from supernet_tpu.ops.moments import _vmaxpool_fast

    mu, sigma = _pool_inputs(shape, ties)

    def loss(m, s):
        o1, o2 = _vmaxpool_fast(m, s)
        return jnp.sum(o1 * 1.3) + jnp.sum(o2 * 0.7)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(sigma))
    tm, ts = (torch.from_numpy(a).requires_grad_() for a in (mu, sigma))
    o1, o2 = pool.VMaxPool.apply(tm, ts)
    (o1 * 1.3 + 0.0).sum().add((o2 * 0.7).sum()).backward()
    for g, r in zip((tm.grad, ts.grad), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("k,h,c", [(3, 10, 8), (2, 9, 4), (3, 37, 16)])
def test_winsum_spread_bwd_plain_matches_pallas_interpret(k, h, c):
    """The cases of tests/test_sigma_bwd.py, against _bwd_call."""
    rng = np.random.default_rng(0)
    hp = h - k + 1
    g = rng.normal(0, 1, (2, hp, hp, c)).astype(np.float32)
    t = rng.normal(0, 1, (2, hp, hp)).astype(np.float32)
    s_w = rng.uniform(0.01, 0.2, (c,)).astype(np.float32)
    want = jsigma_bwd._bwd_call(jnp.asarray(g), jnp.asarray(t), jnp.asarray(s_w),
                                k, interpret=True)
    got = sigma_bwd.winsum_spread_bwd(*(torch.from_numpy(a) for a in (g, t, s_w)), k)
    assert _no_launches()
    assert got[0].shape == (2, h, h) and got[1].shape == (c,)
    for x, r in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CASES)
def test_vdp_conv_grads_match_jax_grad(k, cin, cout, h, fuse, has_sigma):
    """VDPConv's backward (plain forward and kernel-4 plain version on the
    CPU) against jax.grad of the Pallas vdp_conv in interpret mode, each
    gradient within 1e-4 of its max magnitude."""
    mu, sigma, w_mu, w_sigma = _conv_inputs(k, cin, cout, h, has_sigma)
    rng = np.random.default_rng(7)
    ho = h - k + 1
    c1, c2 = (rng.normal(0, 1, (2, ho, ho, cout)).astype(np.float32) for _ in range(2))
    args = [a for a in (mu, sigma, w_mu, w_sigma) if a is not None]

    def loss(*a):
        m, s = (jvdp_conv(a[0], a[1], *a[2:], fuse_relu=fuse, interpret=True)
                if has_sigma else jvdp_conv(a[0], None, *a[1:], fuse_relu=fuse,
                                            interpret=True))
        return jnp.sum(m * c1) + jnp.sum(s * c2)

    want = jax.grad(loss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    tsig = t[1] if has_sigma else None
    m, s = vdp_conv.VDPConv.apply(t[0], tsig, t[-2], t[-1], fuse)
    ((m * torch.from_numpy(c1)).sum() + (s * torch.from_numpy(c2)).sum()).backward()
    assert _no_launches()
    for x, r in zip(t, want):
        r = np.asarray(r)
        assert np.abs(x.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max()


def _f64(*shape, positive=False, seed=0):
    a = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape))
    return (a.abs() if positive else a).requires_grad_()


@pytest.mark.parametrize("case", ["vdp_conv", "vdp_conv_relu", "vdp_conv_input",
                                  "vmaxpool", "sigma_bwd"])
def test_gradcheck_float64(case):
    """torch.autograd.gradcheck of each Function on tiny float64 shapes;
    the pool's inputs have no ties, and the sigma backward is checked as the
    VJP of win * s_w through the ones-window sum of its source."""
    if case.startswith("vdp_conv"):
        mu, sg = _f64(2, 6, 7, 3, seed=1), _f64(2, 6, 7, 3, positive=True, seed=2)
        w = (0.3 * _f64(3, 3, 3, 4, seed=3)).detach().requires_grad_()
        ws = (_f64(4, seed=4) - 3.0).detach().requires_grad_()
        relu = case == "vdp_conv_relu"
        if case == "vdp_conv_input":
            fn, args = (lambda a, c, e: vdp_conv.VDPConv.apply(a, None, c, e, False),
                        (mu, w, ws))
        else:
            fn, args = (lambda a, b, c, e: vdp_conv.VDPConv.apply(a, b, c, e, relu),
                        (mu, sg, w, ws))
    elif case == "vmaxpool":
        fn, args = pool.VMaxPool.apply, (_f64(2, 5, 7, 3, seed=5),
                                         _f64(2, 5, 7, 3, positive=True, seed=6))
    else:
        class WinsumScale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, src, s_w):
                win = torch.nn.functional.conv2d(
                    src[:, None], torch.ones(1, 1, 3, 3, dtype=src.dtype))[:, 0]
                ctx.save_for_backward(win, s_w)
                return win[..., None] * s_w

            @staticmethod
            def backward(ctx, g):
                win, s_w = ctx.saved_tensors
                return sigma_bwd.winsum_spread_bwd(g.contiguous(), win, s_w, 3)

        fn, args = WinsumScale.apply, (_f64(2, 7, 8, seed=7),
                                       _f64(4, positive=True, seed=8))
    assert torch.autograd.gradcheck(fn, args)
    assert _no_launches()
