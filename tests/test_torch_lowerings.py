"""The port's one lowering of each moment op (supernet_tpu_torch/ops/
moments.py and moments3d.py), the ``stride`` of ``vconv``/``vconv_input``
and ``apply_env_overrides``, against each of the JAX package's A/B
lowerings (``set_winsum``, ``set_sw_scale``, ``set_chansum``,
``set_conv_fold``, ``set_conv2d_impl``, ``set_conv3d_impl``), which are set
on the JAX modules alone, on the CPU, mirroring
``tests/test_moments.py:61-166``: outputs within ``ATOL`` (float32 sums in
another order), gradients (autograd against ``jax.grad`` on the same
cotangents) within ``GRAD_RTOL`` of each gradient's max magnitude, as
``tests/test_torch_ops.py`` holds the JAX default lowering."""

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
# the JAX module's setter and getter per A/B lowering knob
_JSET = {"winsum": jm.set_winsum, "sw_scale": jm.set_sw_scale, "chansum": jm.set_chansum,
         "conv_fold": jm.set_conv_fold, "conv2d_impl": jm.set_conv2d_impl,
         "conv3d_impl": jm3.set_conv3d_impl}
_JGET = {"winsum": jm.get_winsum, "sw_scale": jm.get_sw_scale, "chansum": jm.get_chansum,
         "conv_fold": jm.get_conv_fold, "conv2d_impl": jm.get_conv2d_impl,
         "conv3d_impl": jm3.get_conv3d_impl}


@contextlib.contextmanager
def jax_lowering(**modes):
    """The JAX package under the given knobs, restored afterwards; the port
    runs its one lowering whatever they say."""
    before = {k: _JGET[k]() for k in modes}
    try:
        for k, v in modes.items():
            _JSET[k](v)
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
    with jax_lowering(winsum=mode):
        _check(tm._window_sum(torch.from_numpy(x), k, stride),
               jm._window_sum(jnp.asarray(x), k, stride))
        _grads(lambda a: (tm._window_sum(a, k, stride),),
               lambda a: (jm._window_sum(a, k, stride),), [x], rng)


@pytest.mark.parametrize("mode", ["shift", "conv"])
def test_window_sum3d_matches_jax(mode):
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 9, 11, 13, 3)
    with jax_lowering(winsum=mode):
        _check(tm3._window_sum3d(torch.from_numpy(x), 3, 1),
               jm3._window_sum3d(jnp.asarray(x), 3, 1))


# ------------------------------------------------------ sw scale, chan sum


@pytest.mark.parametrize("sw_scale,chansum", [("dot", "reduce"), ("mul", "dot"),
                                              ("dot", "dot")])
def test_sw_scale_and_chansum_match_jax(sw_scale, chansum):
    """vconv (k=3 and the 1x1 head), vconv3d and the gradients against
    JAX under the dot lowerings."""
    rng = np.random.default_rng(11)
    args = _conv_case(rng)
    head = _conv_case(rng, k=1)
    mu3, sg3 = _rand(rng, 1, 7, 7, 7, 3), _rand(rng, 1, 7, 7, 7, 3, positive=True)
    w3, ws3 = 0.1 * _rand(rng, 3, 3, 3, 3, 4), rng.uniform(-12, -2, 4).astype(np.float32)
    with jax_lowering(sw_scale=sw_scale, chansum=chansum):
        for a in (args, head):
            _check(tm.vconv(*map(torch.from_numpy, a)), jm.vconv(*map(jnp.asarray, a)))
            _grads(tm.vconv, jm.vconv, list(a), rng)
        _check(tm3.vconv3d(*map(torch.from_numpy, (mu3, sg3, w3, ws3))),
               jm3.vconv3d(*map(jnp.asarray, (mu3, sg3, w3, ws3))))


# --------------------------------------------------------------- conv fold


@pytest.mark.parametrize("fold", ["none", "sigma", "full"])
def test_conv_fold_matches_jax(fold):
    """vconv and vconv_input, outputs and gradients, against JAX under
    each conv fold."""
    rng = np.random.default_rng(13)
    mu, sg, w, ws = _conv_case(rng)
    with jax_lowering(conv_fold=fold):
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
    with jax_lowering(conv2d_impl="im2col"):
        _check(tm.vconv(*map(torch.from_numpy, (mu, sg, w, ws))),
               jm.vconv(*map(jnp.asarray, (mu, sg, w, ws))))
        _check(tm.vconv_input(*map(torch.from_numpy, (mu, w, ws))),
               jm.vconv_input(*map(jnp.asarray, (mu, w, ws))))
        _grads(tm.vconv, jm.vconv, [mu, sg, w, ws], rng)


@pytest.mark.parametrize("impl", ["conv", "im2col"])
def test_conv3d_im2col_matches_jax(impl):
    rng = np.random.default_rng(17)
    mu, sg = _rand(rng, 1, 7, 8, 7, 3), _rand(rng, 1, 7, 8, 7, 3, positive=True)
    w, ws = 0.1 * _rand(rng, 3, 3, 3, 3, 4), rng.uniform(-12, -2, 4).astype(np.float32)
    with jax_lowering(conv3d_impl=impl):
        _check(tm3.vconv3d(*map(torch.from_numpy, (mu, sg, w, ws))),
               jm3.vconv3d(*map(jnp.asarray, (mu, sg, w, ws))))
        _check(tm3.vconv3d_input(*map(torch.from_numpy, (mu, w, ws))),
               jm3.vconv3d_input(*map(jnp.asarray, (mu, w, ws))))
        _grads(tm3.vconv3d, jm3.vconv3d, [mu, sg, w, ws], rng)


# ------------------------------------------------------------------ stride


@pytest.mark.parametrize("impl", ["conv", "im2col"])
@pytest.mark.parametrize("k", [2, 3])
def test_stride2_matches_jax(impl, k):
    """vconv and vconv_input at stride 2 (the composition on every
    device), against JAX under each 2-D conv lowering."""
    rng = np.random.default_rng(20 + k)
    mu, sg, w, ws = _conv_case(rng, k=k, h=11)
    with jax_lowering(conv2d_impl=impl):
        _check(tm.vconv(*map(torch.from_numpy, (mu, sg, w, ws)), stride=2),
               jm.vconv(*map(jnp.asarray, (mu, sg, w, ws)), stride=2))
        _check(tm.vconv_input(*map(torch.from_numpy, (mu, w, ws)), stride=2),
               jm.vconv_input(*map(jnp.asarray, (mu, w, ws)), stride=2))
        _grads(lambda *a: tm.vconv(*a, stride=2), lambda *a: jm.vconv(*a, stride=2),
               [mu, sg, w, ws], rng)


# ---------------------------------------------------------------- dispatch


@pytest.mark.parametrize("glue_fold", ["none", "fold"])
def test_cpu_dispatch(monkeypatch, glue_fold):
    """On a CPU tensor a stride-1 k=3 conv runs VDPConv's plain version
    whatever the glue fold (the model's choice, not the conv's); a stride-2
    conv never does."""
    calls = []
    apply = V.VDPConv.apply
    monkeypatch.setattr(V.VDPConv, "apply", lambda *a: calls.append(1) or apply(*a))
    rng = np.random.default_rng(30)
    mu, sg, w, ws = map(torch.from_numpy, _conv_case(rng))
    with tm.lowering(glue_fold=glue_fold):
        tm.vconv_relu(mu, sg, w, ws)
        tm.vconv_input(mu, w, ws)
        tm.vconv(mu, sg, w, ws, stride=2)  # never the kernel
    assert len(calls) == 2


def test_member_stacked_stride2_is_per_member():
    """Member-stacked weights at stride 2, the one conv that leaves the
    kernel, run member by member, as ``jax.vmap`` of the composition does."""
    rng = np.random.default_rng(31)
    mu = torch.from_numpy(_rand(rng, 2 * 2, 9, 9, 4))
    sg = torch.from_numpy(_rand(rng, 2 * 2, 9, 9, 4, positive=True))
    w = torch.from_numpy(0.1 * _rand(rng, 2, 3, 3, 4, 6))
    ws = torch.from_numpy(rng.uniform(-12, -2, (2, 6)).astype(np.float32))
    m, s = tm.vconv(mu, sg, w, ws, stride=2)
    for k in range(2):
        mk, sk = tm.vconv(mu[2 * k:2 * k + 2], sg[2 * k:2 * k + 2], w[k], ws[k], stride=2)
        _check((m[2 * k:2 * k + 2], s[2 * k:2 * k + 2]), (mk.numpy(), sk.numpy()), atol=0)


def test_bf16_conv_fold_matches_jax():
    """Under bf16 activations the port agrees with JAX's folded lowering
    within bf16 rounding (2^-8 of the output's magnitude)."""
    rng = np.random.default_rng(32)
    mu, sg, w, ws = _conv_case(rng)
    try:
        ops.set_act_dtype("bfloat16")
        jm.set_act_dtype("bfloat16")
        with jax_lowering(conv_fold="sigma"):
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


def test_apply_env_overrides_reads_each_knob(monkeypatch, capsys):
    """SUPERNET_GLUE_FOLD of ``supernet_tpu/ops/moments.py:
    apply_env_overrides`` is honoured, as the JAX function honours it, and
    named on no warning."""
    monkeypatch.setenv("SUPERNET_GLUE_FOLD", "fold")
    with tm.lowering():
        ops.apply_env_overrides()
        assert tm.get_glue_fold() == "fold"
    assert tm.get_glue_fold() == "none"
    assert "SUPERNET_GLUE_FOLD" not in capsys.readouterr().err


# the JAX package's switches the port names and ignores, each with a value
# that selects something in the JAX package
_IGNORED = [("SUPERNET_BACKEND", "pallas"), ("SUPERNET_POOL", "pallas"),
            ("SUPERNET_SIGMA_BWD", "pallas"), ("SUPERNET_CONV_FOLD", "full"),
            ("SUPERNET_WINSUM", "conv"), ("SUPERNET_SW_SCALE", "dot"),
            ("SUPERNET_CHANSUM", "dot"), ("SUPERNET_CONV2D", "im2col"),
            ("SUPERNET_CONV3D", "im2col")]


@pytest.mark.parametrize("name,value", _IGNORED, ids=[n for n, _ in _IGNORED])
def test_kernel_switches_warn(monkeypatch, capsys, name, value):
    """Each switch, when set, is named on stderr with its reason and changes
    no output of ``vconv``, ``vconv_input`` or ``vconv3d``."""
    rng = np.random.default_rng(33)
    mu, sg, w, ws = map(torch.from_numpy, _conv_case(rng))
    mu3 = torch.from_numpy(_rand(rng, 1, 6, 6, 6, 3))
    sg3 = torch.from_numpy(_rand(rng, 1, 6, 6, 6, 3, positive=True))
    w3 = torch.from_numpy(0.1 * _rand(rng, 3, 3, 3, 3, 4))
    ws3 = torch.from_numpy(rng.uniform(-12, -2, 4).astype(np.float32))

    def outputs():
        return (*tm.vconv(mu, sg, w, ws), *tm.vconv(mu, sg, w, ws, stride=2),
                *tm.vconv_input(mu, w, ws), *tm3.vconv3d(mu3, sg3, w3, ws3))

    before = outputs()
    monkeypatch.setenv(name, value)
    ops.apply_env_overrides()
    assert f"{name}={value} has no counterpart" in capsys.readouterr().err
    _check(outputs(), [t.numpy() for t in before], atol=0)


def test_knob_setters_refuse_unknown_modes():
    with pytest.raises(ValueError):
        tm.set_glue_fold("winograd")
    with pytest.raises(ValueError):
        with tm.lowering(glue_fold="winograd"):
            pass
    with pytest.raises(TypeError):
        with tm.lowering(winsum="conv"):
            pass


def test_lowering_restores_the_knobs():
    with pytest.raises(RuntimeError):
        with tm.lowering(glue_fold="fold"):
            assert tm.get_glue_fold() == "fold"
            raise RuntimeError
    assert tm.get_glue_fold() == "none"


def test_defaults_are_the_jax_defaults():
    assert tm.get_glue_fold() == jm.get_glue_fold()
