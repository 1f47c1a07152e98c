"""The A/B lowerings of the port's moment ops (supernet_tpu_torch/ops/
moments.py and moments3d.py: ``set_winsum``, ``set_sw_scale``,
``set_chansum``, ``set_conv_fold``, ``set_conv2d_impl``,
``set_conv3d_impl``, the ``stride`` of ``vconv``/``vconv_input`` and
``apply_env_overrides``) against the JAX package under the same knob, on
the CPU, mirroring ``tests/test_moments.py:61-166``: outputs within ``ATOL``
(float32 sums in another order), gradients (autograd against ``jax.grad``
on the same cotangents) within ``GRAD_RTOL`` of each gradient's max
magnitude, as ``tests/test_torch_ops.py`` holds the default lowering."""

import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops import moments as jm  # noqa: E402
from supernet_tpu.ops import moments3d as jm3  # noqa: E402
from supernet_tpu_torch import ops  # noqa: E402
from supernet_tpu_torch.ops import moments as tm  # noqa: E402
from supernet_tpu_torch.ops import moments3d as tm3  # noqa: E402
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


ATOL = 1e-5
GRAD_RTOL = 1e-4
# setter names of the JAX module per knob of the port's ``lowering``
_JSET = {"winsum": jm.set_winsum, "sw_scale": jm.set_sw_scale, "chansum": jm.set_chansum,
         "conv_fold": jm.set_conv_fold, "conv2d_impl": jm.set_conv2d_impl}
_JGET = {"winsum": jm.get_winsum, "sw_scale": jm.get_sw_scale, "chansum": jm.get_chansum,
         "conv_fold": jm.get_conv_fold, "conv2d_impl": jm.get_conv2d_impl}


@contextlib.contextmanager
def both(**modes):
    """Both packages under the same knobs, restored afterwards."""
    before = {k: _JGET[k]() for k in modes}
    try:
        for k, v in modes.items():
            _JSET[k](v)
        with tm.lowering(**modes):
            yield
    finally:
        for k, v in before.items():
            _JSET[k](v)


def _rand(rng, *shape, positive=False):
    a = rng.normal(0, 1, shape).astype(np.float32)
    return np.abs(a) * 0.1 if positive else a


def _check(got, want, atol=ATOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol)


def _grads(tfn, jfn, args, rng):
    """Autograd of ``tfn`` against ``jax.grad`` of ``jfn`` on the same
    random cotangents, every input's gradient within GRAD_RTOL of its max."""
    cots = [rng.normal(0, 1, np.shape(o)).astype(np.float32)
            for o in jfn(*map(jnp.asarray, args))]

    def jloss(*a):
        return sum(jnp.sum(o * c) for o, c in zip(jfn(*a), cots))

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tfn(*t), cots)).backward()
    for x, r in zip(t, want):
        r = np.asarray(r)
        assert np.abs(x.grad.numpy() - r).max() <= GRAD_RTOL * np.abs(r).max()


def _conv_case(rng, k=3, cin=4, cout=6, h=9):
    return (_rand(rng, 2, h, h, cin), _rand(rng, 2, h, h, cin, positive=True),
            0.1 * _rand(rng, k, k, cin, cout),
            rng.uniform(-12, -2, cout).astype(np.float32))


# ------------------------------------------------------------- window sum


@pytest.mark.parametrize("mode", ["shift", "conv"])
@pytest.mark.parametrize("k,stride", [(2, 1), (3, 1), (3, 2), (5, 2)])
def test_window_sum_matches_jax(mode, k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = _rand(rng, 2, 13, 11, 5)
    with both(winsum=mode):
        _check(tm._window_sum(torch.from_numpy(x), k, stride),
               jm._window_sum(jnp.asarray(x), k, stride))
        _grads(lambda a: (tm._window_sum(a, k, stride),),
               lambda a: (jm._window_sum(a, k, stride),), [x], rng)


@pytest.mark.parametrize("mode", ["shift", "conv"])
def test_window_sum3d_matches_jax(mode):
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 9, 11, 13, 3)
    with both(winsum=mode):
        _check(tm3._window_sum3d(torch.from_numpy(x), 3, 1),
               jm3._window_sum3d(jnp.asarray(x), 3, 1))


def test_winsum_shift_equals_conv():
    """The two lowerings agree with each other in the port too."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_rand(rng, 2, 13, 11, 5))
    with tm.lowering(winsum="conv"):
        ref = tm._window_sum(x, 3, 2)
    _check(tm._window_sum(x, 3, 2), ref.numpy())


# ------------------------------------------------------ sw scale, chan sum


@pytest.mark.parametrize("sw_scale,chansum", [("dot", "reduce"), ("mul", "dot"),
                                              ("dot", "dot")])
def test_sw_scale_and_chansum_match_jax(sw_scale, chansum):
    """vconv (k=3 and the 1x1 head), vconv3d and the gradients under the
    dot lowerings, against JAX under the same."""
    rng = np.random.default_rng(11)
    args = _conv_case(rng)
    head = _conv_case(rng, k=1)
    mu3, sg3 = _rand(rng, 1, 7, 7, 7, 3), _rand(rng, 1, 7, 7, 7, 3, positive=True)
    w3, ws3 = 0.1 * _rand(rng, 3, 3, 3, 3, 4), rng.uniform(-12, -2, 4).astype(np.float32)
    with both(sw_scale=sw_scale, chansum=chansum):
        for a in (args, head):
            _check(tm.vconv(*map(torch.from_numpy, a)), jm.vconv(*map(jnp.asarray, a)))
            _grads(tm.vconv, jm.vconv, list(a), rng)
        _check(tm3.vconv3d(*map(torch.from_numpy, (mu3, sg3, w3, ws3))),
               jm3.vconv3d(*map(jnp.asarray, (mu3, sg3, w3, ws3))))


def test_head_honours_sw_scale_and_not_chansum(monkeypatch):
    """The 1x1 head takes ``scale_sw`` (the dot under sw_scale="dot") and
    its channel sum is never ``chan_sum``, as in the JAX head."""
    rng = np.random.default_rng(12)
    mu, sg, w, ws = map(torch.from_numpy, _conv_case(rng, k=1))
    calls = {"matmul": 0, "chan_sum": 0}
    matmul, chan_sum = torch.matmul, tm.chan_sum

    def counting_matmul(*a):
        calls["matmul"] += 1
        return matmul(*a)

    def counting_chan_sum(x):
        calls["chan_sum"] += 1
        return chan_sum(x)

    monkeypatch.setattr(torch, "matmul", counting_matmul)
    monkeypatch.setattr(tm, "chan_sum", counting_chan_sum)
    with tm.lowering(sw_scale="dot", chansum="dot"):
        tm.vconv(mu, sg, w, ws)
        tm.vconv_input(mu, w, ws)
    assert calls == {"matmul": 2, "chan_sum": 0}


# --------------------------------------------------------------- conv fold


@pytest.mark.parametrize("fold", ["none", "sigma", "full"])
def test_conv_fold_matches_jax(fold):
    """vconv and vconv_input under each conv fold, outputs and gradients,
    against JAX under the same fold."""
    rng = np.random.default_rng(13)
    mu, sg, w, ws = _conv_case(rng)
    with both(conv_fold=fold):
        _check(tm.vconv(*map(torch.from_numpy, (mu, sg, w, ws))),
               jm.vconv(*map(jnp.asarray, (mu, sg, w, ws))))
        _check(tm.vconv_input(*map(torch.from_numpy, (mu, w, ws))),
               jm.vconv_input(*map(jnp.asarray, (mu, w, ws))))
        _grads(tm.vconv, jm.vconv, [mu, sg, w, ws], rng)
        _grads(tm.vconv_input, jm.vconv_input, [mu, w, ws], rng)


# -------------------------------------------------------------- im2col 2-D


@pytest.mark.parametrize("k", [2, 3])
def test_conv2d_im2col_matches_jax(k):
    rng = np.random.default_rng(14 + k)
    mu, sg, w, ws = _conv_case(rng, k=k)
    with both(conv2d_impl="im2col"):
        _check(tm.vconv(*map(torch.from_numpy, (mu, sg, w, ws))),
               jm.vconv(*map(jnp.asarray, (mu, sg, w, ws))))
        _check(tm.vconv_input(*map(torch.from_numpy, (mu, w, ws))),
               jm.vconv_input(*map(jnp.asarray, (mu, w, ws))))
        _grads(tm.vconv, jm.vconv, [mu, sg, w, ws], rng)


def test_im2col2d_patch_order():
    """``patches @ w.reshape(k^2 Cin, Cout)`` is the VALID conv."""
    rng = np.random.default_rng(16)
    x, w = _rand(rng, 2, 8, 7, 3), _rand(rng, 3, 3, 3, 5)
    got = tm._im2col2d_dot(tm._im2col2d(torch.from_numpy(x), 3), torch.from_numpy(w).reshape(-1, 5))
    _check(got, tm._conv_valid(torch.from_numpy(x), torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("impl", ["conv", "im2col"])
def test_conv3d_im2col_matches_jax(impl):
    rng = np.random.default_rng(17)
    mu, sg = _rand(rng, 1, 7, 8, 7, 3), _rand(rng, 1, 7, 8, 7, 3, positive=True)
    w, ws = 0.1 * _rand(rng, 3, 3, 3, 3, 4), rng.uniform(-12, -2, 4).astype(np.float32)
    try:
        tm3.set_conv3d_impl(impl)
        jm3.set_conv3d_impl(impl)
        _check(tm3.vconv3d(*map(torch.from_numpy, (mu, sg, w, ws))),
               jm3.vconv3d(*map(jnp.asarray, (mu, sg, w, ws))))
        _check(tm3.vconv3d_input(*map(torch.from_numpy, (mu, w, ws))),
               jm3.vconv3d_input(*map(jnp.asarray, (mu, w, ws))))
        _grads(tm3.vconv3d, jm3.vconv3d, [mu, sg, w, ws], rng)
    finally:
        tm3.set_conv3d_impl("conv")
        jm3.set_conv3d_impl("conv")


# ------------------------------------------------------------------ stride


@pytest.mark.parametrize("impl", ["conv", "im2col"])
@pytest.mark.parametrize("k", [2, 3])
def test_stride2_matches_jax(impl, k):
    """vconv and vconv_input at stride 2 (the composition on every
    device), against JAX."""
    rng = np.random.default_rng(20 + k)
    mu, sg, w, ws = _conv_case(rng, k=k, h=11)
    with both(conv2d_impl=impl):
        _check(tm.vconv(*map(torch.from_numpy, (mu, sg, w, ws)), stride=2),
               jm.vconv(*map(jnp.asarray, (mu, sg, w, ws)), stride=2))
        _check(tm.vconv_input(*map(torch.from_numpy, (mu, w, ws)), stride=2),
               jm.vconv_input(*map(jnp.asarray, (mu, w, ws)), stride=2))
        _grads(lambda *a: tm.vconv(*a, stride=2), lambda *a: jm.vconv(*a, stride=2),
               [mu, sg, w, ws], rng)


# ---------------------------------------------------------------- dispatch


@pytest.mark.parametrize("knob,mode,kernel", [
    (None, None, True), ("winsum", "conv", False), ("conv_fold", "sigma", False),
    ("chansum", "dot", False), ("sw_scale", "dot", False),
    ("conv2d_impl", "im2col", False), ("glue_fold", "fold", True)])
def test_cpu_dispatch(monkeypatch, knob, mode, kernel):
    """On a CPU tensor a stride-1 k=3 conv runs VDPConv's plain version at
    the default lowering (the glue fold is the model's choice, not the
    conv's) and the JAX package's XLA composition under any other knob."""
    calls = []
    apply = V.VDPConv.apply
    monkeypatch.setattr(V.VDPConv, "apply", lambda *a: calls.append(1) or apply(*a))
    rng = np.random.default_rng(30)
    mu, sg, w, ws = map(torch.from_numpy, _conv_case(rng))
    with tm.lowering(**({knob: mode} if knob else {})):
        tm.vconv_relu(mu, sg, w, ws)
        tm.vconv_input(mu, w, ws)
        tm.vconv(mu, sg, w, ws, stride=2)  # never the kernel
    assert len(calls) == (2 if kernel else 0)


def test_member_stacked_knob_path_is_per_member():
    """Member-stacked weights under a knob run member by member, as
    ``jax.vmap`` of the lowering does."""
    rng = np.random.default_rng(31)
    mu = torch.from_numpy(_rand(rng, 2 * 2, 9, 9, 4))
    sg = torch.from_numpy(_rand(rng, 2 * 2, 9, 9, 4, positive=True))
    w = torch.from_numpy(0.1 * _rand(rng, 2, 3, 3, 4, 6))
    ws = torch.from_numpy(rng.uniform(-12, -2, (2, 6)).astype(np.float32))
    with tm.lowering(conv_fold="full"):
        m, s = tm.vconv(mu, sg, w, ws)
        for k in range(2):
            mk, sk = tm.vconv(mu[2 * k:2 * k + 2], sg[2 * k:2 * k + 2], w[k], ws[k])
            _check((m[2 * k:2 * k + 2], s[2 * k:2 * k + 2]), (mk.numpy(), sk.numpy()), atol=0)


def test_bf16_conv_fold_matches_jax():
    """Under bf16 activations the folded lowering agrees with JAX's within
    bf16 rounding (2^-8 of the output's magnitude)."""
    rng = np.random.default_rng(32)
    mu, sg, w, ws = _conv_case(rng)
    try:
        ops.set_act_dtype("bfloat16")
        jm.set_act_dtype("bfloat16")
        with both(conv_fold="sigma"):
            got = tm.vconv(*map(torch.from_numpy, (mu, sg, w, ws)))
            want = jm.vconv(*map(jnp.asarray, (mu, sg, w, ws)))
    finally:
        ops.set_act_dtype("float32")
        jm.set_act_dtype("float32")
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r, np.float32)
        assert np.abs(g.float().numpy() - r).max() <= 2 ** -7 * np.abs(r).max()


# ------------------------------------------------------------------- knobs


_ENV = [("SUPERNET_CONV_FOLD", "full", tm.get_conv_fold),
        ("SUPERNET_GLUE_FOLD", "fold", tm.get_glue_fold),
        ("SUPERNET_WINSUM", "conv", tm.get_winsum),
        ("SUPERNET_SW_SCALE", "dot", tm.get_sw_scale),
        ("SUPERNET_CHANSUM", "dot", tm.get_chansum),
        ("SUPERNET_CONV2D", "im2col", tm.get_conv2d_impl),
        ("SUPERNET_CONV3D", "im2col", tm3.get_conv3d_impl)]


@pytest.mark.parametrize("name,value,getter", _ENV, ids=[e[0] for e in _ENV])
def test_apply_env_overrides_reads_each_knob(monkeypatch, capsys, name, value, getter):
    """Each A/B knob of ``supernet_tpu/ops/moments.py:apply_env_overrides``
    is honoured, as the JAX function honours it, and named on no warning."""
    for n, _, _ in _ENV:
        monkeypatch.delenv(n, raising=False)
    monkeypatch.setenv(name, value)
    with tm.lowering():
        try:
            ops.apply_env_overrides()
            assert getter() == value
        finally:
            tm3.set_conv3d_impl("conv")
    assert name not in capsys.readouterr().err


@pytest.mark.parametrize("name", ["SUPERNET_BACKEND", "SUPERNET_POOL", "SUPERNET_SIGMA_BWD"])
def test_kernel_switches_warn(monkeypatch, capsys, name):
    monkeypatch.setenv(name, "pallas")
    ops.apply_env_overrides()
    assert f"{name}=pallas has no counterpart" in capsys.readouterr().err


def test_knob_setters_refuse_unknown_modes():
    for setter in (tm.set_conv_fold, tm.set_winsum, tm.set_glue_fold, tm.set_sw_scale,
                   tm.set_chansum, tm.set_conv2d_impl, tm3.set_conv3d_impl):
        with pytest.raises(ValueError):
            setter("winograd")
    with pytest.raises(ValueError):
        with tm.lowering(backend="pallas"):
            pass


def test_lowering_restores_the_knobs():
    with pytest.raises(RuntimeError):
        with tm.lowering(winsum="conv", glue_fold="fold"):
            assert (tm.get_winsum(), tm.get_glue_fold()) == ("conv", "fold")
            raise RuntimeError
    assert (tm.get_winsum(), tm.get_glue_fold()) == ("shift", "none")


def test_defaults_are_the_jax_defaults():
    assert (tm.get_conv_fold(), tm.get_glue_fold(), tm.get_winsum(), tm.get_sw_scale(),
            tm.get_chansum(), tm.get_conv2d_impl(), tm3.get_conv3d_impl()) == (
        jm.get_conv_fold(), jm.get_glue_fold(), jm.get_winsum(), jm.get_sw_scale(),
        jm.get_chansum(), jm.get_conv2d_impl(), jm3.get_conv3d_impl())
