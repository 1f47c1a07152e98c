"""The port's 3-D moment ops (supernet_tpu_torch/ops/moments3d.py) against
the JAX ops of supernet_tpu/ops/moments3d.py on the same numpy inputs, on the
CPU: each op's outputs and its gradients (``jax.grad`` of the same scalar).

Tolerances: outputs within ``ATOL`` (float32 sums in another order);
gradients within ``GRAD_RTOL`` of each gradient's max magnitude. The pool is
held bit for bit, tap index and backward too."""


import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops import moments3d as jm3  # noqa: E402
from supernet_tpu_torch import ops  # noqa: E402
from supernet_tpu_torch.ops import moments3d as tm3  # noqa: E402


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
GRAD_RTOL = 2e-5


def _rand(rng, *shape, positive=False):
    a = rng.normal(0, 1, shape).astype(np.float32)
    return np.abs(a) if positive else a


def _check(got, want, atol=ATOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol)


def _grads_match(t_fn, j_fn, arrays, rng):
    """Gradients of ``sum(a * out0) + sum(b * out1)`` with respect to every
    input, port against ``jax.grad``, within GRAD_RTOL of each max."""
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    t_out = t_fn(*t_in)
    weights = [_rand(rng, *o.shape) for o in t_out]
    loss = sum((torch.from_numpy(w) * o).sum() for w, o in zip(weights, t_out))
    t_g = torch.autograd.grad(loss, t_in)

    def j_loss(*xs):
        outs = j_fn(*xs)
        return sum(jnp.sum(jnp.asarray(w) * o) for w, o in zip(weights, outs))

    j_g = jax.grad(j_loss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    for g, w in zip(t_g, j_g):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * scale, (err, scale)


@pytest.mark.parametrize("k,stride", [(1, 1), (2, 1), (3, 1), (3, 2)])
def test_vconv3d_input(k, stride):
    rng = np.random.default_rng(1)
    arrays = [_rand(rng, 2, 9, 8, 7, 2), 0.3 * _rand(rng, k, k, k, 2, 5),
              _rand(rng, 5) - 4.0]
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    _check(tm3.vconv3d_input(*t, stride=stride), jm3.vconv3d_input(*j, stride=stride))
    _grads_match(lambda *a: tm3.vconv3d_input(*a, stride=stride),
                 lambda *a: jm3.vconv3d_input(*a, stride=stride), arrays, rng)


@pytest.mark.parametrize("k,stride", [(1, 1), (2, 1), (3, 1), (3, 2)])
def test_vconv3d(k, stride):
    rng = np.random.default_rng(2)
    arrays = [_rand(rng, 2, 8, 9, 7, 4), _rand(rng, 2, 8, 9, 7, 4, positive=True),
              0.3 * _rand(rng, k, k, k, 4, 3), _rand(rng, 3) - 4.0]
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    _check(tm3.vconv3d(*t, stride=stride), jm3.vconv3d(*j, stride=stride))
    _grads_match(lambda *a: tm3.vconv3d(*a, stride=stride),
                 lambda *a: jm3.vconv3d(*a, stride=stride), arrays, rng)


def test_vconv3d_relu_and_input_relu():
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 7, 7, 7, 3)
    s = _rand(rng, 1, 7, 7, 7, 3, positive=True)
    w, ws = 0.3 * _rand(rng, 3, 3, 3, 3, 4), _rand(rng, 4) - 4.0
    _check(tm3.vconv3d_relu(*map(torch.from_numpy, (x, s, w, ws))),
           jm3.vconv3d_relu(*map(jnp.asarray, (x, s, w, ws))))
    _check(tm3.vconv3d_input_relu(*map(torch.from_numpy, (x, w, ws))),
           jm3.vrelu(*jm3.vconv3d_input(*map(jnp.asarray, (x, w, ws)))))
    _grads_match(tm3.vconv3d_relu, jm3.vconv3d_relu, [x, s, w, ws], rng)


@pytest.mark.parametrize("k,stride", [(2, 1), (3, 1), (3, 2)])
def test_window_sum3d(k, stride):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 9, 10, 7, 3)
    _check(tm3._window_sum3d(torch.from_numpy(x), k, stride),
           jm3._window_sum3d(jnp.asarray(x), k, stride))


def _pool_inputs(shape, ties, seed=5):
    rng = np.random.default_rng(seed)
    if ties:
        # few distinct values: most windows hold a tie, some several
        mu = rng.integers(-2, 3, shape).astype(np.float32)
    else:
        mu = _rand(rng, *shape)
    return mu, _rand(rng, *shape, positive=True)


@pytest.mark.parametrize("shape", [(2, 6, 8, 4, 3), (1, 7, 5, 9, 2), (2, 5, 5, 5, 4)],
                         ids=["even", "odd", "odd_cube"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_vmaxpool3d_forward_and_tap(shape, ties):
    """Max, sigma at the argmax and the tap index, bit for bit, at even and
    odd sizes (odd sides pad with finfo.min) and with ties (the first tap
    in (d, h, w) order wins)."""
    mu, sigma = _pool_inputs(shape, ties)
    mx, so, idx = tm3.vmaxpool3d_plain(torch.from_numpy(mu), torch.from_numpy(sigma))
    jmx, jso, (jidx, _) = jm3._vmaxpool3d_fwd_impl(jnp.asarray(mu), jnp.asarray(sigma))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(so.numpy(), np.asarray(jso))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx).astype(np.uint8))
    m2, s2 = tm3.vmaxpool3d(torch.from_numpy(mu), torch.from_numpy(sigma))
    assert torch.equal(m2, mx) and torch.equal(s2, so)


@pytest.mark.parametrize("shape", [(2, 6, 8, 4, 3), (1, 7, 5, 9, 2), (2, 5, 5, 5, 4)],
                         ids=["even", "odd", "odd_cube"])
def test_vmaxpool3d_backward_is_the_parity_rule(shape):
    """The custom backward against JAX's ``_vmaxpool3d_bwd`` on the same
    taps and cotangents (ties included: the whole gradient goes to the
    chosen tap), and against ``jax.grad`` of the pool."""
    mu, sigma = _pool_inputs(shape, ties=True, seed=6)
    rng = np.random.default_rng(7)
    _, _, (jidx, dims) = jm3._vmaxpool3d_fwd_impl(jnp.asarray(mu), jnp.asarray(sigma))
    g_mu = _rand(rng, *jidx.shape)
    g_s = _rand(rng, *jidx.shape)
    want = jm3._vmaxpool3d_bwd((jidx, dims), (jnp.asarray(g_mu), jnp.asarray(g_s)))
    t_mu = torch.from_numpy(mu).requires_grad_(True)
    t_s = torch.from_numpy(sigma).requires_grad_(True)
    m, s = tm3.vmaxpool3d(t_mu, t_s)
    got = torch.autograd.grad((m * torch.from_numpy(g_mu)).sum()
                              + (s * torch.from_numpy(g_s)).sum(), (t_mu, t_s))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the whole window's gradient lands on one voxel: nothing is split
    assert int((got[0] != 0).sum()) <= int(np.count_nonzero(g_mu))
    _grads_match(tm3.vmaxpool3d, jm3.vmaxpool3d, [mu, sigma], rng)


def test_vmaxpool3d_gradcheck_float64():
    rng = np.random.default_rng(8)
    mu = torch.from_numpy(rng.normal(size=(1, 5, 4, 3, 2))).requires_grad_(True)
    sigma = torch.from_numpy(rng.random((1, 5, 4, 3, 2))).requires_grad_(True)
    assert torch.autograd.gradcheck(tm3.vmaxpool3d, (mu, sigma))


def test_vunpool3d_conv2_against_jax_and_the_unfused_composition():
    rng = np.random.default_rng(9)
    arrays = [_rand(rng, 2, 4, 3, 5, 4), _rand(rng, 2, 4, 3, 5, 4, positive=True),
              0.3 * _rand(rng, 2, 2, 2, 4, 3), _rand(rng, 3) - 4.0]
    t = [torch.from_numpy(a) for a in arrays]
    _check(tm3.vunpool3d_conv2(*t), jm3.vunpool3d_conv2(*map(jnp.asarray, arrays)))
    unfused = tm3.vconv3d(*tm3.vunpool3d(t[0], t[1]), t[2], t[3])
    _check(tm3.vunpool3d_conv2(*t), [u.numpy() for u in unfused])
    _check(tm3.vunpool3d(t[0], t[1]), jm3.vunpool3d(*map(jnp.asarray, arrays[:2])))
    _grads_match(tm3.vunpool3d_conv2, jm3.vunpool3d_conv2, arrays, rng)


@pytest.mark.parametrize("pad,fill", [((2, 2), 0.0), ((3, 3), 0.02), ((1, 0), 0.1)])
def test_vpad3d(pad, fill):
    rng = np.random.default_rng(10)
    mu, sigma = _rand(rng, 2, 3, 4, 5, 2), _rand(rng, 2, 3, 4, 5, 2, positive=True)
    _check(tm3.vpad3d(torch.from_numpy(mu), torch.from_numpy(sigma), pad, fill),
           jm3.vpad3d(jnp.asarray(mu), jnp.asarray(sigma), pad, fill), atol=0)


def test_crop_and_concat3d():
    rng = np.random.default_rng(11)
    arrays = [_rand(rng, 2, 4, 4, 4, 3), _rand(rng, 2, 4, 4, 4, 3),
              _rand(rng, 2, 9, 8, 7, 2), _rand(rng, 2, 9, 8, 7, 2)]
    _check(tm3.vcrop_concat3d(*map(torch.from_numpy, arrays)),
           jm3.vcrop_concat3d(*map(jnp.asarray, arrays)), atol=0)
    _check(tm3.crop_center3d(torch.from_numpy(arrays[2]), 5, 4, 3),
           jm3.crop_center3d(jnp.asarray(arrays[2]), 5, 4, 3), atol=0)
    # numpy label cubes crop the same way (the trainers use it on the host)
    y = np.arange(2 * 9 * 8 * 7).reshape(2, 9, 8, 7)
    np.testing.assert_array_equal(tm3.crop_center3d(y, 5, 4, 3),
                                  np.asarray(jm3.crop_center3d(jnp.asarray(y), 5, 4, 3)))


def test_vsoftmax3d():
    rng = np.random.default_rng(12)
    mu, sigma = _rand(rng, 2, 3, 4, 5, 3), _rand(rng, 2, 3, 4, 5, 3, positive=True)
    _check(tm3.vsoftmax3d(torch.from_numpy(mu), torch.from_numpy(sigma)),
           jm3.vsoftmax3d(jnp.asarray(mu), jnp.asarray(sigma)))
    _grads_match(tm3.vsoftmax3d, jm3.vsoftmax3d, [mu, sigma], rng)


def test_channels_last_conv_layout():
    """The NDHWC moments reach conv3d as channels_last_3d views (no copy),
    and the output comes back NDHWC-contiguous."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(_rand(rng, 1, 6, 6, 6, 4))
    assert x.permute(0, 4, 1, 2, 3).is_contiguous(memory_format=torch.channels_last_3d)
    out = tm3._conv3d_valid(x, torch.from_numpy(_rand(rng, 3, 3, 3, 4, 5)))
    assert out.shape == (1, 4, 4, 4, 5) and out.is_contiguous()


def test_ab_lowerings_name_their_roadmap_item(monkeypatch, capsys):
    """The port runs one 3-D lowering: it equals the JAX module's im2col
    lowering; SUPERNET_CONV3D, which selects that lowering in the JAX
    package, is named on stderr and changes nothing; the 3-D glue fold
    answers."""
    rng = np.random.default_rng(14)
    mu, sigma = _rand(rng, 1, 7, 7, 7, 3), np.abs(_rand(rng, 1, 7, 7, 7, 3))
    w_mu, w_sigma = 0.2 * _rand(rng, 3, 3, 3, 3, 4), _rand(rng, 4) - 5.0
    t = [torch.from_numpy(a) for a in (mu, sigma, w_mu, w_sigma)]
    j = [jnp.asarray(a) for a in (mu, sigma, w_mu, w_sigma)]
    jm3.set_conv3d_impl("im2col")
    try:
        want = jm3.vconv3d(*j)
    finally:
        jm3.set_conv3d_impl("conv")
    got = tm3.vconv3d(*t)
    _check(got, want)
    m, s = tm3.vglue_conv3d_relu(*t, (2, 2), 0.02)
    assert m.shape == s.shape == (1, 9, 9, 9, 4)
    monkeypatch.setenv("SUPERNET_CONV3D", "im2col")
    ops.apply_env_overrides()
    assert "SUPERNET_CONV3D=im2col has no counterpart" in capsys.readouterr().err
    _check(tm3.vconv3d(*t), [g.numpy() for g in got], atol=0)


def test_bf16_casts_follow_the_jax_module():
    """Under bf16 activations both packages cast at the same places: the
    outputs agree within bf16 rounding and keep bf16."""
    rng = np.random.default_rng(14)
    arrays = [_rand(rng, 1, 7, 7, 7, 4), _rand(rng, 1, 7, 7, 7, 4, positive=True),
              0.3 * _rand(rng, 3, 3, 3, 4, 3), _rand(rng, 3) - 4.0]
    from supernet_tpu.ops import moments as jm

    ops.set_act_dtype("bfloat16")
    jm.set_act_dtype("bfloat16")
    try:
        got = tm3.vconv3d(*map(torch.from_numpy, arrays))
        want = jm3.vconv3d(*map(jnp.asarray, arrays))
    finally:
        ops.set_act_dtype("float32")
        jm.set_act_dtype("float32")
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2 * np.abs(w).max())
