"""The kernels' bf16 contract on the CPU: the plain versions of kernels 1-4
on bf16 inputs against the JAX package's Pallas kernels on the same values
in interpret mode (the pool bit for bit, the others within the tolerances
stated below), ``VDPConv`` and ``VMaxPool`` gradients in bf16 against
``jax.grad`` of the JAX package's bf16 path, and the wrappers' dtype checks.
The CUDA kernels are held to the same plain versions, and to their own
float32 runs on the upcast inputs, on the card by chip_smoke.py.

Inputs are drawn with numpy in float32, rounded to bf16 once by torch, and
handed to JAX as the float32 values of those bf16 numbers (exact), so both
packages see the same bf16 values."""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops.pallas import pool as jpool  # noqa: E402
from supernet_tpu.ops.pallas import sigma_bwd as jsigma_bwd  # noqa: E402
from supernet_tpu.ops.pallas import vdp_conv as jvdp_conv  # noqa: E402
from supernet_tpu_torch.ops.kernels import _lib, pool, sigma_bwd, vdp_conv  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


jvdp_module = importlib.import_module("supernet_tpu.ops.pallas.vdp_conv")
BF = torch.bfloat16

# the cases of tests/test_torch_kernels.py (after tests/test_pallas.py)
POOL_SHAPES = [
    ((2, 8, 8, 32), True),
    ((1, 12, 16, 8), False),
    ((3, 4, 4, 130), True),
]
CONV_CASES = [
    # k, cin, cout, H, fuse_relu, has_sigma
    (3, 8, 16, 12, False, True),
    (3, 8, 16, 12, True, True),
    (2, 8, 8, 10, False, True),
    (1, 16, 4, 9, False, True),
    (3, 1, 8, 12, False, False),
]
# float32 agreement of the port's plain composition and the Pallas kernel on
# these cases (tests/test_torch_kernels.py:VDP_ATOL)
VDP_ATOL = 1e-4
# one bf16 rounding step: bf16 keeps 8 significant bits, so the spacing of
# its values near x is at most 2^-7 |x|. Two float32 results a few float32
# roundings apart can round to neighbouring bf16 values, never farther.
BF16_ULP = 2.0 ** -7


def _bf16(a: np.ndarray) -> torch.Tensor:
    """``a`` rounded to bf16 (to nearest even) by torch."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(BF)


def _jax(t: torch.Tensor):
    """The same bf16 values as a JAX bf16 array (exact through float32)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    """float32 numpy values of a torch tensor or a JAX array, bf16 or not."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_ulp(got, want, atol=0.0):
    """|got - want| <= atol + one bf16 step at the larger magnitude."""
    g, w = _np(got), _np(want)
    bound = atol + BF16_ULP * np.maximum(np.abs(g), np.abs(w))
    assert np.all(np.abs(g - w) <= bound), float(np.max(np.abs(g - w) - bound))


def _no_launches():
    return (vdp_conv.launches, pool.launches, pool.bwd_launches,
            sigma_bwd.launches) == (0, 0, 0, 0)


def _pool_inputs(shape, ties, seed=0):
    rng = np.random.default_rng(seed)
    if ties:
        mu = rng.integers(-3, 3, shape).astype(np.float32)
    else:
        mu = rng.normal(0, 1, shape).astype(np.float32)
    return _bf16(mu), _bf16(np.abs(rng.normal(0, 1, shape)))


@pytest.mark.parametrize("shape,ties", POOL_SHAPES)
def test_vmaxpool_bf16_plain_bit_exact_vs_pallas_interpret(shape, ties):
    """Kernel 2 on bf16: mx, so and the tap index come out bf16 and equal
    the Pallas kernel's bf16 outputs bit for bit."""
    mu, sigma = _pool_inputs(shape, ties)
    jpool.set_interpret(True)
    try:
        (want_mx, want_so), want_idx = jpool._vmp_fwd(_jax(mu), _jax(sigma))
    finally:
        jpool.set_interpret(False)
    got = pool.vmaxpool(mu, sigma, return_idx=True)
    assert _no_launches()
    for g, w in zip(got, (want_mx, want_so, want_idx)):
        assert g.dtype == BF and w.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("shape,ties", POOL_SHAPES)
def test_vmaxpool_bwd_bf16_plain_bit_exact_vs_pallas_interpret(shape, ties):
    """Kernel 3 on bf16: the routed gradients come out bf16, bit for bit
    the Pallas backward's."""
    mu, sigma = _pool_inputs(shape, ties)
    b, h, w, c = shape
    rng = np.random.default_rng(1)
    g_mu, g_sigma = (_bf16(rng.normal(0, 1, (b, h // 2, w // 2, c))) for _ in range(2))
    jpool.set_interpret(True)
    try:
        _, idx = jpool._vmp_fwd(_jax(mu), _jax(sigma))
        want = jpool._vmp_bwd(idx, (_jax(g_mu), _jax(g_sigma)))
    finally:
        jpool.set_interpret(False)
    t_idx = _bf16(_np(idx))
    got = pool.vmaxpool_bwd(t_idx, g_mu, g_sigma, h, w)
    assert _no_launches()
    for g, r in zip(got, want):
        assert g.shape == shape and g.dtype == BF and g.is_contiguous()
        np.testing.assert_array_equal(_np(g), _np(r))


@pytest.mark.parametrize("shape,ties", POOL_SHAPES + [((2, 7, 9, 4), True)])
def test_vmaxpool_bf16_grads_bit_exact_vs_jax_grad(shape, ties):
    """VMaxPool in bf16 against jax.vjp of the JAX package's pool on bf16
    moments: the tap index saved in bf16, the gradients bf16 and equal bit
    for bit (routing moves values, it rounds nothing)."""
    from supernet_tpu.ops.moments import _vmaxpool_fast

    mu, sigma = _pool_inputs(shape, ties)
    b, h, w, c = shape
    rng = np.random.default_rng(3)
    cots = [_bf16(rng.normal(0, 1, (b, -(-h // 2), -(-w // 2), c))) for _ in range(2)]
    _, vjp = jax.vjp(_vmaxpool_fast, _jax(mu), _jax(sigma))
    want = vjp(tuple(_jax(t) for t in cots))
    tm, ts = mu.clone().requires_grad_(), sigma.clone().requires_grad_()
    out = pool.VMaxPool.apply(tm, ts)
    assert out[0].dtype == out[1].dtype == BF
    got = torch.autograd.grad(out, (tm, ts), cots)
    for g, r in zip(got, want):
        assert g.dtype == BF
        np.testing.assert_array_equal(_np(g), _np(r))


@pytest.mark.parametrize("k,h,c", [(3, 10, 8), (2, 9, 4), (3, 37, 16)])
def test_winsum_spread_bwd_bf16_plain_vs_pallas_interpret(k, h, c):
    """Kernel 4 with bf16 g and t (the cases of
    test_winsum_spread_bwd_plain_matches_pallas_interpret): u in bf16 within
    one bf16 step of the Pallas kernel's bf16 u (both sum in float32, in
    other orders, and round once), dsw float32 at rtol 1e-5."""
    rng = np.random.default_rng(0)
    hp = h - k + 1
    g = _bf16(rng.normal(0, 1, (2, hp, hp, c)))
    t = _bf16(rng.normal(0, 1, (2, hp, hp)))
    s_w = rng.uniform(0.01, 0.2, (c,)).astype(np.float32)
    want_u, want_dsw = jsigma_bwd._bwd_call(_jax(g), _jax(t), jnp.asarray(s_w), k,
                                            interpret=True)
    u, dsw = sigma_bwd.winsum_spread_bwd(g, t, torch.from_numpy(s_w), k)
    assert _no_launches()
    assert u.dtype == BF and want_u.dtype == jnp.bfloat16
    assert dsw.dtype == torch.float32 and want_dsw.dtype == jnp.float32
    assert u.shape == (2, h, h) and dsw.shape == (c,)
    _within_one_ulp(u, want_u, atol=1e-6)
    np.testing.assert_allclose(dsw.numpy(), np.asarray(want_dsw), rtol=1e-5, atol=1e-6)


def test_winsum_spread_bwd_mixed_dtypes_plain():
    """g in bf16 with a float32 t (VDPConv's case: t is kernel 1's float32
    window-sum residual): u stays float32 and equals the float32 call on
    the upcast g."""
    rng = np.random.default_rng(4)
    g = _bf16(rng.normal(0, 1, (3, 6, 7, 12)))
    t = torch.from_numpy(rng.normal(0, 1, (3, 6, 7)).astype(np.float32))
    s_w = torch.from_numpy(rng.uniform(0.01, 0.2, (12,)).astype(np.float32))
    u, dsw = sigma_bwd.winsum_spread_bwd(g, t, s_w, 3)
    u32, dsw32 = sigma_bwd.winsum_spread_bwd(g.float(), t, s_w, 3)
    assert u.dtype == dsw.dtype == torch.float32
    assert torch.equal(u, u32) and torch.equal(dsw, dsw32)


def _conv_inputs(k, cin, cout, h, has_sigma, seed=0):
    rng = np.random.default_rng(seed)

    def t(*s):
        return rng.normal(0, 1, s).astype(np.float32)

    mu = _bf16(t(2, h, h, cin))
    sigma = _bf16(np.abs(t(2, h, h, cin))) if has_sigma else None
    return mu, sigma, torch.from_numpy(0.3 * t(k, k, cin, cout)), torch.from_numpy(t(cout) - 5.0)


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CONV_CASES)
def test_vdp_conv_bf16_plain_vs_pallas_interpret(k, cin, cout, h, fuse, has_sigma):
    """Kernel 1 on bf16 moments: JAX's vdp_conv upcasts at its wrapper, runs
    the Pallas kernel in float32 and casts mu_out, sig_out back to bf16; the
    port's plain version computes in float32 and rounds the same two
    outputs once. They agree within VDP_ATOL (the float32 agreement) plus
    one bf16 step; win stays float32 and agrees within VDP_ATOL."""
    mu, sigma, w_mu, w_sigma = _conv_inputs(k, cin, cout, h, has_sigma)
    jm, js = _jax(mu), None if sigma is None else _jax(sigma)
    jw, jws = jnp.asarray(w_mu.numpy()), jnp.asarray(w_sigma.numpy())
    want_mu, want_sig = jvdp_conv(jm, js, jw, jws, fuse_relu=fuse, interpret=True)
    assert want_mu.dtype == want_sig.dtype == jnp.bfloat16
    _, _, want_win = jvdp_module._pallas_forward(
        jm.astype(jnp.float32), None if js is None else js.astype(jnp.float32), jw, jws,
        fuse_relu=fuse, precision="highest", interpret=True)
    got = vdp_conv.vdp_conv(mu, sigma, w_mu, w_sigma, fuse_relu=fuse)
    assert _no_launches()
    assert got[0].dtype == got[1].dtype == BF and got[2].dtype == torch.float32
    _within_one_ulp(got[0], want_mu, atol=VDP_ATOL)
    _within_one_ulp(got[1], want_sig, atol=VDP_ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want_win), atol=VDP_ATOL)


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CONV_CASES)
def test_vdp_conv_bf16_plain_is_float32_rounded_once(k, cin, cout, h, fuse, has_sigma):
    """What the kernel does on the card: the bf16 call is the float32 call
    on the upcast values with mu_out and sig_out rounded to bf16 once, win
    and the ReLU mask untouched (the mask of the float32 mu_out, not of the
    rounded one)."""
    mu, sigma, w_mu, w_sigma = _conv_inputs(k, cin, cout, h, has_sigma)
    got = vdp_conv.vdp_conv_plain(mu, sigma, w_mu, w_sigma, fuse, relu_mask=True)
    ref = vdp_conv.vdp_conv_plain(mu.float(), None if sigma is None else sigma.float(),
                                  w_mu, w_sigma, fuse, relu_mask=True)
    assert torch.equal(got[0], ref[0].to(BF)) and torch.equal(got[1], ref[1].to(BF))
    assert torch.equal(got[2], ref[2])
    if fuse:
        assert torch.equal(got[3], ref[3]) and torch.equal(got[3], ref[0] > 0)
    else:
        assert got[3] is None


def test_conv_t_pair_bf16_plain_is_float32():
    """The transposed pair on bf16 cotangents: float32 out, equal to the
    float32 pair on the upcast cotangents (the kernel reads bf16 and writes
    the float32 sums VDPConv keeps)."""
    rng = np.random.default_rng(5)
    g1, g2 = (_bf16(rng.normal(0, 1, (2, 7, 8, 6))) for _ in range(2))
    w = torch.from_numpy(0.3 * rng.normal(0, 1, (3, 3, 4, 6)).astype(np.float32))
    for fn in (vdp_conv.conv_t_pair, vdp_conv.conv_t_pair_plain):
        got = fn(g1, g2, w)
        ref = fn(g1.float(), g2.float(), w)
        assert all(a.dtype == torch.float32 for a in got)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _no_launches()


# VDPConv's gradients in bf16 against jax.grad of the JAX package's bf16
# path: both take float32 sums from the same bf16 cotangents and residuals
# (JAX's convert sits outside its custom VJP) and round each bf16 input
# gradient once, so they differ by the float32 agreement of the gradient
# check in tests/test_torch_kernels.py (1e-4 of the leaf's max) plus one
# bf16 step of an element, at most 2^-7 of the leaf's max. The float32
# weight gradients see float32 operands on both sides: 1e-4 alone.
GRAD_TOL = 1e-4
BF16_GRAD_TOL = GRAD_TOL + BF16_ULP


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CONV_CASES)
def test_vdp_conv_bf16_grads_match_jax_grad(k, cin, cout, h, fuse, has_sigma):
    mu, sigma, w_mu, w_sigma = _conv_inputs(k, cin, cout, h, has_sigma)
    rng = np.random.default_rng(7)
    ho = h - k + 1
    c1, c2 = (_bf16(rng.normal(0, 1, (2, ho, ho, cout))) for _ in range(2))
    args = [a for a in (mu, sigma, w_mu, w_sigma) if a is not None]
    jargs = [_jax(a) if a.dtype == BF else jnp.asarray(a.numpy()) for a in args]

    def f(*a):
        if has_sigma:
            return jvdp_conv(a[0], a[1], *a[2:], fuse_relu=fuse, interpret=True)
        return jvdp_conv(a[0], None, *a[1:], fuse_relu=fuse, interpret=True)

    _, vjp = jax.vjp(f, *jargs)
    want = vjp((_jax(c1), _jax(c2)))
    t = [a.clone().requires_grad_() for a in args]
    out = vdp_conv.VDPConv.apply(t[0], t[1] if has_sigma else None, t[-2], t[-1], fuse)
    assert out[0].dtype == out[1].dtype == BF
    got = torch.autograd.grad(out, t, (c1, c2))
    assert _no_launches()
    for x, r, a in zip(got, want, args):
        assert x.dtype == a.dtype and str(r.dtype) == str(a.dtype).replace("torch.", "")
        tol = BF16_GRAD_TOL if a.dtype == BF else GRAD_TOL
        r = _np(r)
        assert np.abs(_np(x) - r).max() <= tol * np.abs(r).max()


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CONV_CASES)
def test_vdp_conv_bf16_grads_are_float32_grads_rounded_once(k, cin, cout, h, fuse,
                                                            has_sigma):
    """The gradient twin of test_vdp_conv_bf16_plain_is_float32_rounded_once,
    and the rounding points the JAX package takes: VDPConv's bf16 input
    gradients are its float32 gradients on the upcast inputs and cotangents,
    rounded to bf16 once (u, c1 and c2 stay float32 until d_mu = c1 + 2 mu u
    and d_sigma = u + c2), and its weight gradients, float32 products of
    float32 operands, are the float32 ones bit for bit."""
    mu, sigma, w_mu, w_sigma = _conv_inputs(k, cin, cout, h, has_sigma)
    rng = np.random.default_rng(7)
    ho = h - k + 1
    c1, c2 = (_bf16(rng.normal(0, 1, (2, ho, ho, cout))) for _ in range(2))
    args = [a for a in (mu, sigma, w_mu, w_sigma) if a is not None]

    def grads(dtype):
        t = [(a.to(dtype) if a.dtype == BF else a).clone().requires_grad_() for a in args]
        out = vdp_conv.VDPConv.apply(t[0], t[1] if has_sigma else None, t[-2], t[-1], fuse)
        return torch.autograd.grad(out, t, (c1.to(dtype), c2.to(dtype)))

    got, ref = grads(BF), grads(torch.float32)
    assert _no_launches()
    for x, r, a in zip(got, ref, args):
        assert x.dtype == a.dtype and r.dtype == torch.float32
        assert torch.equal(x, r.to(x.dtype))


def test_vdp_conv_bf16_relu_mask_is_saved_not_read_back():
    """A positive pre-activation below bf16's least subnormal rounds to 0 in
    the bf16 mu_out; the ReLU's gradient still passes there, as it does in
    float32 (and in the JAX package, whose VJP keeps the float32 mu_out).
    VDPConv saves the mask of the float32 mu_out under bf16."""
    mu = torch.zeros(1, 3, 3, 1, dtype=BF)
    mu[0, 1, 1, 0] = 1.0
    w = torch.zeros(3, 3, 1, 1)
    w[1, 1, 0, 0] = 2.0 ** -140  # mu_out = 2^-140 > 0, bf16(2^-140) == 0
    ws = torch.full((1,), -5.0)
    x = mu.clone().requires_grad_()
    wt = w.clone().requires_grad_()
    m, _ = vdp_conv.VDPConv.apply(x, None, wt, ws, True)
    assert m.dtype == BF and float(m.detach()) == 0.0
    (gw,) = torch.autograd.grad(m.float().sum(), (wt,))
    assert float(gw[1, 1, 0, 0]) == 1.0  # the mask passed the gradient


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: the wrappers' checks run
    (and refuse) before anything would be launched."""

    @property
    def is_cuda(self):
        return True


def _card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t)


def test_check_input_takes_the_dtypes_a_kernel_allows():
    x = _card(torch.zeros(2, 3, dtype=BF))
    _lib.check_input("op", "x", x, (2, 3), _lib.MOMENT_DTYPES)
    with pytest.raises(ValueError, match="x must be a contiguous float32 CUDA tensor"):
        _lib.check_input("op", "x", x, (2, 3))
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16 CUDA tensor"):
            _lib.check_input("op", "x", _card(torch.zeros(2, 3, dtype=dt)), (2, 3),
                             _lib.MOMENT_DTYPES)
    with pytest.raises(ValueError, match="x has shape"):
        _lib.check_input("op", "x", x, (3, 2), _lib.MOMENT_DTYPES)
    assert _lib.dtype_code(torch.float32) == 0 and _lib.dtype_code(BF) == 1
    with pytest.raises(ValueError):
        _lib.dtype_code(torch.float16)


@pytest.mark.parametrize("op", ["vmaxpool", "vmaxpool_bwd", "vdp_conv", "conv_t_pair",
                                "winsum_spread_bwd"])
def test_wrappers_refuse_mixed_and_unsupported_dtypes(op):
    """mu and sigma (or g1 and g2, idx and the gradients) in different
    dtypes raise, as does a moment in float16; nothing is launched."""
    z = lambda *s, dt=BF: _card(torch.zeros(s, dtype=dt))  # noqa: E731
    w = _card(torch.zeros(3, 3, 4, 6))
    ws = _card(torch.zeros(6))
    calls = {
        "vmaxpool": (lambda a, b: pool.vmaxpool(a, b), (2, 4, 4, 4)),
        "vmaxpool_bwd": (lambda a, b: pool.vmaxpool_bwd(a, b, b, 4, 4), (2, 2, 2, 4)),
        "vdp_conv": (lambda a, b: vdp_conv.vdp_conv(a, b, w, ws, True), (2, 6, 6, 4)),
        "conv_t_pair": (lambda a, b: vdp_conv.conv_t_pair(a, b, w), (2, 4, 4, 6)),
        "winsum_spread_bwd": (
            lambda a, b: sigma_bwd.winsum_spread_bwd(b, z(2, 4, 4, dt=torch.float16), ws, 3),
            (2, 4, 4, 6)),
    }
    fn, shape = calls[op]
    with pytest.raises(ValueError, match="must be a contiguous"):
        fn(z(*shape), z(*shape, dt=torch.float32))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fn(z(*shape, dt=torch.float16), z(*shape, dt=torch.float16))
    assert _no_launches()


def test_conversion_kernels_count_the_converting_copies():
    """profiling.conversion_kernels on a CPU trace: the ``aten::copy_``
    operators that change dtype (each one kernel on the card), not the
    copies within a dtype. (A multiply of mixed dtypes converts through such
    a copy on the CPU; on the card it casts inside its own kernel.)"""
    from supernet_tpu_torch import profiling

    x = torch.randn(4, 8)
    xb = x.to(BF)

    def run():
        x.to(BF)
        xb.float()
        x.clone()
        x.t().contiguous()
        x.to(torch.float32)  # already float32: no copy at all

    assert profiling.conversion_kernels(run, calls=2) == 2


def test_count_conversions_joins_device_kernels_by_external_id():
    """On a trace with device events, the kernels whose External id is that
    of a converting copy (the card's trace of ``.to(bfloat16)`` and
    ``.float()`` next to a copy within one dtype)."""
    from supernet_tpu_torch import profiling
    from supernet_tpu_torch import xplane as X

    def ev(name, cat, ext, types=None):
        args = {"External id": ext}
        if types is not None:
            args["Input type"] = types
        return X.Event({"ph": "X", "name": name, "cat": cat, "ts": 0, "dur": 1, "args": args})

    events = [
        ev("aten::_to_copy", "cpu_op", 2, ["float", "Scalar"]),
        ev("aten::copy_", "cpu_op", 4, ["c10::BFloat16", "float", "Scalar"]),
        ev("void at::native::vectorized_elementwise_kernel<8, bfloat16_copy_kernel_cuda>",
           "kernel", 4),
        ev("aten::copy_", "cpu_op", 8, ["float", "c10::BFloat16", "Scalar"]),
        ev("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", "kernel", 8),
        ev("aten::copy_", "cpu_op", 11, ["float", "float", "Scalar"]),
        ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 11),
        ev("void vdp_conv_kernel<32, false, true, true, __nv_bfloat16>", "kernel", 13),
    ]
    assert profiling.count_conversions(events) == 2
    assert profiling.count_conversions([e for e in events if e.cat == "cpu_op"]) == 2
