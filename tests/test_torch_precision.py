"""Kernel 1's precision on the CPU: the plain versions of the fused VDP conv
and of its transposed pair under ``SUPERNET_PRECISION=default`` (one bf16
pass: each product's operands rounded to bf16, the sums in float32, the
window sum from the unrounded moments) against the JAX package's own
functions on bf16-rounded operands; "high" bit-equal to "highest"; VDPConv's
backward at its forward's precision; the model forward under "default"
against the JAX model whose Pallas dot rounds as the TPU's MXU does; the
profiler's modes at ``SUPERNET_PRECISION``. XLA's
CPU dot ignores DEFAULT, so the JAX side rounds its operands by hand. The
CUDA kernels are held against the same plain versions on the card by
chip_smoke.py."""

import dataclasses
import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.configs import HIPPOCAMPUS  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import ops  # noqa: E402
from supernet_tpu_torch.checkpoint import params_from_jax  # noqa: E402
from supernet_tpu_torch.models import forward  # noqa: E402
from supernet_tpu_torch.ops import moments  # noqa: E402
from supernet_tpu_torch.ops.kernels import vdp_conv as V  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _highest():
    """Every test leaves the global precision at the tests' "highest"."""
    yield
    ops.set_mxu_precision("highest")


# the module, not the function the package re-exports under the same name
jvdp = importlib.import_module("supernet_tpu.ops.pallas.vdp_conv")

CASES = [
    # k, cin, cout, H, fuse_relu, has_sigma  (tests/test_torch_kernels.py)
    (3, 8, 16, 12, False, True),
    (3, 8, 16, 12, True, True),
    (2, 8, 8, 10, False, True),
    (1, 16, 4, 9, False, True),
    (3, 1, 8, 12, False, False),
    (3, 32, 16, 10, True, True),  # Cin >= 32: the K of a model layer's step
]
# the products of bf16 operands are exact in float32, so the plain version and
# the reference differ only in the order of their float32 sums: relative to
# the output's max
TOL = 1e-5
# pixels whose ReLU mask the two orders decide differently (mu_out within
# rounding of 0): at most this share, and each within TOL of mu's max
TIE_SHARE = 1e-2
# "default" against "highest", element by element: a bf16 operand lies
# within 2^-8 of its float32 value (round to nearest, 8 significant bits), so
# each product of two lies within 2^-7 (+ 2^-16) of the exact one and a sum
# within that share of the sum of its terms' magnitudes, conv(|x|, |w|)
BF16_PRODUCT = 2.0 ** -7 * (1 + 2.0 ** -9)
# at Cin >= 32, "default" must move an output by more than this share of
# the max: the setting takes effect
MOVES = 1e-4


def r(x):
    """float32 -> bf16 (to nearest even) -> float32, in JAX."""
    return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)


def _inputs(k, cin, cout, h, has_sigma, seed=0):
    rng = np.random.default_rng(seed)

    def t(*s):
        return rng.normal(0, 1, s).astype(np.float32)

    mu = t(2, h, h, cin)
    sigma = np.abs(t(2, h, h, cin)) if has_sigma else None
    return mu, sigma, 0.3 * t(k, k, cin, cout), t(cout) - 5.0


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _reference(mu, sigma, w_mu, w_sigma, fuse):
    """The Pallas kernel's forward under DEFAULT as the MXU computes it:
    both dots on bf16-rounded operands (``w_mu^2`` squared in float32 first,
    as ``_pallas_forward`` squares before its dot), summed in float32; the
    window sum the kernel's own output on the unrounded moments."""
    jm = jnp.asarray(mu)
    js = None if sigma is None else jnp.asarray(sigma)
    jw, jws = jnp.asarray(w_mu), jnp.asarray(w_sigma)
    _, _, win = jvdp._pallas_forward(jm, js, jw, jws, fuse_relu=False,
                                     precision="highest", interpret=True)
    mu_out = jvdp._conv(r(jm), r(jw), "VALID", "highest")
    sig = win * jax.nn.softplus(jws)
    if js is not None:
        sig = sig + jvdp._conv(r(js), r(jnp.square(jw)), "VALID", "highest")
    if fuse:
        mask = mu_out > 0
        mu_out, sig = jnp.where(mask, mu_out, 0.0), jnp.where(mask, sig, 0.0)
    return tuple(np.asarray(a) for a in (mu_out, sig, win))


def _check_forward(got, want, fuse):
    """(a)'s comparison: mu and win within TOL of the max; sigma within TOL
    of the max where both ReLU masks agree, the rest bounded by share."""
    g_mu, g_sig, g_win = (g.numpy() for g in got)
    w_mu, w_sig, w_win = want
    assert _rel(g_mu, w_mu) <= TOL and _rel(g_win, w_win) <= TOL
    keep = np.ones(g_mu.shape, bool)
    if fuse:
        tie = (g_mu > 0) != (w_mu > 0)
        assert tie.mean() <= TIE_SHARE
        if tie.any():
            assert np.maximum(np.abs(g_mu), np.abs(w_mu))[tie].max() <= TOL * np.abs(w_mu).max()
        keep = ~tie
    scale = np.abs(w_sig).max()
    assert np.abs(g_sig - w_sig)[keep].max() <= TOL * scale


# ------------------------------------------------------------------- (a)


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CASES)
def test_forward_default_matches_jax_on_rounded_operands(k, cin, cout, h, fuse, has_sigma):
    """(a) ``vdp_conv_plain(..., precision="default")`` and the CPU path of
    ``vdp_conv`` against the JAX package's conv on bf16-rounded operands with
    the Pallas kernel's unrounded window sum."""
    args = _inputs(k, cin, cout, h, has_sigma)
    want = _reference(*args, fuse)
    plain = V.vdp_conv_plain(*_torch(*args), fuse, precision="default")
    _check_forward(plain, want, fuse)
    before = (V.launches, V.bf16_launches)
    got = V.vdp_conv(*_torch(*args), fuse, precision="default")
    assert (V.launches, V.bf16_launches) == before  # CPU tensors launch nothing
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_forward_default_member_axis_and_bf16_moments():
    """Stacked weights under "default" run each member's one-pass plain
    version; bf16 moments are already bf16, so only the weights round: the
    bf16 call is the float32 call on the upcast moments, rounded once."""
    mu, sigma, w_mu, w_sigma = _inputs(3, 16, 8, 10, True, seed=3)
    w2, ws2 = 0.5 * w_mu, w_sigma + 1.0
    tm, ts = _torch(mu, sigma)
    stacked = V.vdp_conv_plain(torch.stack([tm, tm]), torch.stack([ts, ts]),
                               torch.from_numpy(np.stack([w_mu, w2])),
                               torch.from_numpy(np.stack([w_sigma, ws2])), True,
                               precision="default")
    for i, (wm, ws) in enumerate(((w_mu, w_sigma), (w2, ws2))):
        one = V.vdp_conv_plain(tm, ts, torch.from_numpy(wm), torch.from_numpy(ws), True,
                               precision="default")
        for s, o in zip(stacked, one):
            assert torch.equal(s[2 * i:2 * i + 2], o)
    hb, sb = tm.to(torch.bfloat16), ts.to(torch.bfloat16)
    got = V.vdp_conv_plain(hb, sb, *_torch(w_mu, w_sigma), True, precision="default")
    up = V.vdp_conv_plain(hb.float(), sb.float(), *_torch(w_mu, w_sigma), True,
                          precision="default")
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.float32
    for g, u in zip(got, up):
        assert torch.equal(g, u.to(g.dtype))


# ------------------------------------------------------------------- (b)

# b, h', w' (the cotangent's spatial size), cin, cout, k
DGRAD_SHAPES = [
    (2, 6, 7, 3, 4, 3),
    (1, 9, 5, 8, 16, 3),
    (2, 4, 4, 16, 8, 3),
    (3, 5, 6, 4, 1, 3),   # conv_input's 1-channel input gradient
    (2, 7, 6, 24, 40, 2),
    (1, 6, 6, 32, 32, 3),
]


def _cotangents(shape, seed=1):
    b, hp, wp, cin, cout, k = shape
    rng = np.random.default_rng(seed)
    g1 = rng.normal(0, 1, (b, hp, wp, cout)).astype(np.float32)
    g2 = rng.normal(0, 1, (b, hp, wp, cout)).astype(np.float32)
    w = (0.3 * rng.normal(0, 1, (k, k, cin, cout))).astype(np.float32)
    return g1, g2, w


@pytest.mark.parametrize("shape", DGRAD_SHAPES)
def test_transposed_pair_default_matches_bwd_common_convs(shape):
    """(b) ``conv_t_pair`` (its CPU path) and ``conv_t_pair_plain`` under
    "default" against ``_bwd_common``'s two transposed convolutions, ``_conv``
    over the full padding with the flipped weights, on bf16-rounded ``g1``,
    ``g2``, flipped ``w_mu`` and flipped ``w_mu^2``."""
    g1, g2, w = _cotangents(shape)
    k = shape[-1]
    full = ((k - 1, k - 1), (k - 1, k - 1))
    jw = jnp.asarray(w)
    w_flip_t = jw[::-1, ::-1].transpose(0, 1, 3, 2)
    w2_flip_t = jnp.square(jw)[::-1, ::-1].transpose(0, 1, 3, 2)
    want1 = jvdp._conv(r(g1), r(w_flip_t), full, "highest")
    want2 = jvdp._conv(r(g2), r(w2_flip_t), full, "highest")
    for fn in (V.conv_t_pair, V.conv_t_pair_plain):
        d1, d2 = fn(*_torch(g1, g2, w), "default")
        assert d1.dtype == d2.dtype == torch.float32
        assert _rel(d1, want1) <= TOL and _rel(d2, want2) <= TOL
        d1_only, none = fn(*_torch(g1, None, w), "default")
        assert none is None and _rel(d1_only, want1) <= TOL
    # bf16 cotangents are already bf16: only the weights round
    b1, b2 = (torch.from_numpy(g).to(torch.bfloat16) for g in (g1, g2))
    c1, c2 = V.conv_t_pair_plain(b1, b2, torch.from_numpy(w), "default")
    u1, u2 = V.conv_t_pair_plain(b1.float(), b2.float(), torch.from_numpy(w), "default")
    assert torch.equal(c1, u1) and torch.equal(c2, u2)


# ------------------------------------------------------------------- (c)


def _abs_conv(x, w):
    return V._conv_valid(x.abs().double(), w.abs().double())


def test_default_takes_effect_within_the_bf16_limit():
    """(c) At Cin >= 32 "default" moves each output by more than ``MOVES``
    of its max against "highest", and every element by no more than
    ``BF16_PRODUCT`` of the magnitudes it sums (plus the float32 orders'
    ``TOL``); the window sum does not move at all."""
    mu, sigma, w_mu, w_sigma = _torch(*_inputs(3, 32, 16, 10, True, seed=5))
    hi = V.vdp_conv_plain(mu, sigma, w_mu, w_sigma, False, precision="highest")
    lo = V.vdp_conv_plain(mu, sigma, w_mu, w_sigma, False, precision="default")
    assert torch.equal(hi[2], lo[2])
    terms = (_abs_conv(mu, w_mu), _abs_conv(sigma, w_mu * w_mu))
    for h, d, t in zip(hi[:2], lo[:2], terms):
        diff = (d.double() - h.double()).abs()
        scale = float(h.abs().max())
        assert float(diff.max()) > MOVES * scale
        assert bool((diff <= BF16_PRODUCT * t + TOL * scale).all())
    g1, g2, w = _torch(*_cotangents((1, 6, 6, 32, 32, 3), seed=6))
    dh = V.conv_t_pair(g1, g2, w, "highest")
    dd = V.conv_t_pair(g1, g2, w, "default")
    pad = (0, 0, 2, 2, 2, 2)
    wf = w.flip(0, 1).transpose(-2, -1)
    for h, d, x, ww in zip(dh, dd, (g1, g2), (wf, wf * wf)):
        diff = (d.double() - h.double()).abs()
        scale = float(h.abs().max())
        assert float(diff.max()) > MOVES * scale
        bound = BF16_PRODUCT * _abs_conv(torch.nn.functional.pad(x, pad), ww)
        assert bool((diff <= bound + TOL * scale).all())


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CASES)
def test_high_is_highest_bit_for_bit(k, cin, cout, h, fuse, has_sigma):
    """(c) "high" computes what "highest" does (Mosaic rounds "high" up),
    forward and transposed pair."""
    args = _torch(*_inputs(k, cin, cout, h, has_sigma, seed=2))
    a = V.vdp_conv_plain(*args, fuse, precision="high")
    b = V.vdp_conv_plain(*args, fuse, precision="highest")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    g1, g2 = (torch.randn(2, h - k + 1, h - k + 1, cout, generator=torch.Generator().manual_seed(s))
              for s in (0, 1))
    for fn in (V.conv_t_pair, V.conv_t_pair_plain):
        assert all(torch.equal(x, y) for x, y in zip(fn(g1, g2, args[2], "high"),
                                                     fn(g1, g2, args[2], "highest")))


def test_profiling_takes_the_precision_from_supernet_precision(monkeypatch):
    """The profiler's train, serve and ensemble modes run at
    ``SUPERNET_PRECISION`` ("highest" when it is unset or empty), so
    ``SUPERNET_PRECISION=default python -m supernet_tpu_torch.profiling``
    profiles the bench's one-pass kernel 1; there is no flag of its own."""
    from supernet_tpu_torch import profiling

    with pytest.raises(SystemExit):
        profiling.main(["--mode", "train", "--precision", "default"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for env, want in ((None, "highest"), ("", "highest"), ("default", "default"),
                      ("high", "high")):
        if env is None:
            monkeypatch.delenv("SUPERNET_PRECISION", raising=False)
        else:
            monkeypatch.setenv("SUPERNET_PRECISION", env)
        ops.set_mxu_precision("high" if want != "high" else "default")
        profiling._setup("hippocampus", 0)
        assert ops.get_mxu_precision() == want
    monkeypatch.setenv("SUPERNET_PRECISION", "tf32")
    with pytest.raises(ValueError, match="unknown precision"):
        profiling._setup("hippocampus", 0)


def test_unknown_precision_raises():
    x = torch.ones(1, 6, 6, 8)
    with pytest.raises(ValueError):
        V.vdp_conv_plain(x, x, torch.ones(3, 3, 8, 8), torch.zeros(8), precision="tf32")
    with pytest.raises(ValueError):
        V.plan(2, 10, 10, 16, 16, 3, precision="bf16")
    with pytest.raises(ValueError):
        V.conv_t_pair(x, x, torch.ones(3, 3, 4, 8), "fast")


def _vconv_grads(precision_fwd, precision_bwd, seed=7):
    """Gradients of a sum of ``ops.moments.vconv_relu`` (``VDPConv`` on CPU
    tensors) with the global precision set to ``precision_fwd`` for the
    forward and to ``precision_bwd`` before the backward."""
    mu, sigma, w_mu, w_sigma = (t.requires_grad_() for t in
                                _torch(*_inputs(3, 32, 16, 10, True, seed=seed)))
    ops.set_mxu_precision(precision_fwd)
    m, s = moments.vconv_relu(mu, sigma, w_mu, w_sigma)
    loss = (m * torch.linspace(-1, 1, m.numel()).view(m.shape)).sum() + s.sum()
    ops.set_mxu_precision(precision_bwd)
    return torch.autograd.grad(loss, (mu, sigma, w_mu, w_sigma))


def test_vdpconv_backward_runs_at_the_forward_precision():
    """(c) The global is read once per call, in the forward; the backward's
    transposed pair runs at that precision even when the global changes in
    between, and "default" moves the input gradients."""
    same = _vconv_grads("default", "default")
    changed = _vconv_grads("default", "highest")
    highest = _vconv_grads("highest", "highest")
    for a, b in zip(same, changed):
        assert torch.equal(a, b)
    for a, b in zip(_vconv_grads("highest", "default"), highest):
        assert torch.equal(a, b)
    assert _rel(same[0], highest[0]) > MOVES and _rel(same[1], highest[1]) > MOVES
    assert all(torch.equal(a, b) for a, b in zip(_vconv_grads("high", "high"), highest))


# ---------------------------------------------------------- the slice


CFG = dataclasses.replace(HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4)
ATOL = 1e-5  # tests/test_torch_model.py's, for the same model against JAX


def _mxu_dot3(orig):
    """``_dot3`` as the TPU's MXU computes it: under DEFAULT both operands
    rounded to bf16, the products summed in float32."""
    def dot3(x, w, precision):
        if precision == "default":
            return orig(r(x), r(w), "highest")
        return orig(x, w, precision)
    return dot3


def _he(params):
    """Each ``w_mu`` at He scale, std sqrt(2 / fan_in), as chip_smoke.py
    drives the models: at the raw init the logits and sigma of two
    precisions part by little more than two float32 orders do."""
    out = {}
    for name, p in params.items():
        k, _, cin, _ = p["w_mu"].shape
        w = p["w_mu"]
        out[name] = {**p, "w_mu": w * (np.sqrt(2.0 / (k * k * cin)) / jnp.std(w))}
    return out


def test_model_forward_default_matches_jax_mxu_arithmetic(monkeypatch):
    """The slice: the port's forward under "default" (every k=3 conv through
    ``VDPConv`` in one bf16 pass) against the JAX forward through the Pallas
    kernel in interpret mode under ``set_mxu_precision("default")``, its dot
    rounding as the MXU does and every k=3 conv on the kernel (interpret
    mode has no compile envelope, so none falls back to XLA, whose CPU dot
    ignores DEFAULT). Each layer rounds its products' operands to bf16, so
    a float32 value that the two packages' summation orders leave a
    rounding apart lands on another bf16 operand, and such a flip spreads
    through the layers after it: the pair is held to a tenth of the
    distance between the two precisions' answers (here, where no flip
    occurs, it reads about 1e-7 absolute), and that distance to more than
    100x the 1e-5 of tests/test_torch_model.py."""
    from supernet_tpu.ops import moments as jmoments
    from supernet_tpu.ops.pallas import pool as jpool
    import supernet_tpu.ops.pallas as pk

    params = _he(jinit(jax.random.PRNGKey(0), CFG))
    x = np.random.default_rng(0).normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
    monkeypatch.setattr(jvdp, "_dot3", _mxu_dot3(jvdp._dot3))
    monkeypatch.setattr(pk, "vdp_conv", functools.partial(jvdp.vdp_conv, interpret=True))
    monkeypatch.setattr(jmoments, "_use_pallas_for", lambda x, w_mu: w_mu.shape[0] > 1)
    old = jmoments.get_mxu_precision()
    jmoments.set_backend("pallas")
    jmoments.set_pool_impl("pallas")
    jmoments.set_mxu_precision("default")
    jpool.set_interpret(True)
    try:
        pj, sj = (np.asarray(a) for a in jforward(params, jnp.asarray(x), CFG))
    finally:
        jpool.set_interpret(False)
        jmoments.set_mxu_precision(old)
        jmoments.set_pool_impl("xla")
        jmoments.set_backend("xla")

    def port(precision):
        ops.set_mxu_precision(precision)
        with torch.inference_mode():
            p, s = forward(params_from_jax(params, "cpu"), torch.from_numpy(x), CFG)
        return p.numpy(), s.numpy()

    pt, st = port("default")
    ph, sh = port("highest")
    gap_p, gap_s = np.abs(ph - pj).max(), _rel(sh, sj)
    assert gap_p > 100 * ATOL and gap_s > 100 * ATOL  # the precisions part
    assert np.abs(pt - pj).max() <= 0.1 * gap_p and _rel(st, sj) <= 0.1 * gap_s
