"""The port's moment ops (supernet_tpu_torch/ops/moments.py) against the JAX
ops of supernet_tpu/ops/moments.py on the same numpy inputs, on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from supernet_tpu.ops import moments as jm  # noqa: E402
from supernet_tpu_torch.ops import moments as tm  # noqa: E402


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


def _rand(rng, *shape, positive=False):
    a = rng.normal(0, 1, shape).astype(np.float32)
    return np.abs(a) if positive else a


def _check(got, want, atol=ATOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("k", [1, 3])
def test_vconv_input(k):
    rng = np.random.default_rng(1)
    j, t = _both(_rand(rng, 2, 11, 11, 3), 0.3 * _rand(rng, k, k, 3, 5),
                 _rand(rng, 5) - 5.0)
    _check(tm.vconv_input(*t), jm.vconv_input(*j))
    _check(tm.vconv_input_relu(*t), jm.vconv_input_relu(*j))


@pytest.mark.parametrize("k", [1, 3])
def test_vconv(k):
    rng = np.random.default_rng(2)
    j, t = _both(_rand(rng, 2, 10, 10, 6), _rand(rng, 2, 10, 10, 6, positive=True),
                 0.3 * _rand(rng, k, k, 6, 4), _rand(rng, 4) - 5.0)
    _check(tm.vconv(*t), jm.vconv(*j))
    _check(tm.vconv_relu(*t), jm.vconv_relu(*j))


def test_vrelu_strict_mask():
    rng = np.random.default_rng(3)
    mu = _rand(rng, 2, 5, 5, 3)
    mu[0, 0, 0, :] = 0.0  # TF's ReLU gradient is 0 at 0
    j, t = _both(mu, _rand(rng, 2, 5, 5, 3, positive=True))
    got = tm.vrelu(*t)
    _check(got, jm.vrelu(*j), atol=0)
    assert (got[1][0, 0, 0] == 0).all()


def test_vunpool_conv2():
    rng = np.random.default_rng(4)
    j, t = _both(_rand(rng, 2, 5, 6, 4), _rand(rng, 2, 5, 6, 4, positive=True),
                 0.3 * _rand(rng, 2, 2, 4, 3), _rand(rng, 3) - 3.0)
    _check(tm.vunpool_conv2(*t), jm.vunpool_conv2(*j))


def test_vunpool_conv2_equals_interleave_then_valid_conv():
    """The matrix-product form against the reference choreography: zero-
    interleave with a 1-px border (Hippocampus.py:26-51), then a 2x2 VALID
    VDP conv."""
    from supernet_tpu_torch.ops.kernels.vdp_conv import vdp_conv_plain

    rng = np.random.default_rng(5)
    _, (mu, sigma, w_mu, w_sigma) = _both(
        _rand(rng, 2, 4, 5, 3), _rand(rng, 2, 4, 5, 3, positive=True),
        0.3 * _rand(rng, 2, 2, 3, 6), _rand(rng, 6) - 3.0,
    )

    def interleave(x):
        b, h, w, c = x.shape
        out = torch.zeros((b, 2 * h + 1, 2 * w + 1, c))
        out[:, 1::2, 1::2] = x
        return out

    want_mu, want_sig, _ = vdp_conv_plain(interleave(mu), interleave(sigma),
                                          w_mu, w_sigma)
    got_mu, got_sig = tm.vunpool_conv2(mu, sigma, w_mu, w_sigma)
    torch.testing.assert_close(got_mu, want_mu, atol=ATOL, rtol=0)
    torch.testing.assert_close(got_sig, want_sig, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pad,fill", [((2, 2), 0.02), ((3, 3), 0.0), ((1, 0), 0.1)])
def test_vpad(pad, fill):
    rng = np.random.default_rng(6)
    j, t = _both(_rand(rng, 2, 5, 5, 3), _rand(rng, 2, 5, 5, 3, positive=True))
    _check(tm.vpad(*t, pad, fill), jm.vpad(*j, pad, fill), atol=0)


@pytest.mark.parametrize("enc", [24, 25])
def test_vcrop_concat(enc):
    rng = np.random.default_rng(7)
    j, t = _both(_rand(rng, 2, 18, 18, 4), _rand(rng, 2, 18, 18, 4),
                 _rand(rng, 2, enc, enc, 4), _rand(rng, 2, enc, enc, 4))
    _check(tm.vcrop_concat(*t), jm.vcrop_concat(*j), atol=0)


def test_vsoftmax():
    rng = np.random.default_rng(8)
    j, t = _both(3.0 * _rand(rng, 2, 6, 6, 3), _rand(rng, 2, 6, 6, 3, positive=True))
    got = tm.vsoftmax(*t)
    _check(got, jm.vsoftmax(*j))
    assert got[0].shape == (2, 36, 3)


def test_window_sum_and_chan_sum():
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 9, 8, 5)
    got = tm._window_sum(torch.from_numpy(x), 3)
    _check(got, jm._window_sum(jnp.asarray(x), 3))
    want = F.avg_pool2d(torch.from_numpy(x).sum(-1)[:, None], 3, 1) * 9
    torch.testing.assert_close(got[..., 0], want[:, 0], atol=ATOL, rtol=0)


def test_set_mxu_precision_sets_tf32_flags():
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        tm.set_mxu_precision("default")
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        tm.set_mxu_precision("highest")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert tm.get_mxu_precision() == "highest"
        with pytest.raises(ValueError):
            tm.set_mxu_precision("tf32")
    finally:
        tm.set_mxu_precision("highest")
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _grad_case(name, rng):
    """(op name, numpy inputs, extra arguments) of one gradient case."""
    mu, sg = _rand(rng, 2, 10, 10, 4), _rand(rng, 2, 10, 10, 4, positive=True)
    ws = _rand(rng, 5) - 4.0
    w = {k: 0.3 * _rand(rng, k, k, 4, 5) for k in (1, 2, 3)}
    return {
        "vconv_input_k1": ("vconv_input", (mu, w[1], ws), ()),
        "vconv_input_relu_k3": ("vconv_input_relu", (mu, w[3], ws), ()),
        "vconv_k1": ("vconv", (mu, sg, w[1], ws), ()),
        "vconv_relu_k1": ("vconv_relu", (mu, sg, w[1], ws), ()),
        "vconv_k3": ("vconv", (mu, sg, w[3], ws), ()),
        "vconv_relu_k3": ("vconv_relu", (mu, sg, w[3], ws), ()),
        "vrelu": ("vrelu", (mu, sg), ()),
        "vmaxpool": ("vmaxpool", (mu, sg), ()),
        "vunpool_conv2": ("vunpool_conv2", (mu, sg, w[2], ws), ()),
        "vpad": ("vpad", (mu, sg), ((2, 2), 0.02)),
        "vcrop_concat": ("vcrop_concat", (_rand(rng, 2, 6, 6, 4),
                                          _rand(rng, 2, 6, 6, 4, positive=True), mu, sg), ()),
        "vsoftmax": ("vsoftmax", (3.0 * mu, sg), ()),
    }[name]


@pytest.mark.parametrize("name", [
    "vconv_input_k1", "vconv_input_relu_k3", "vconv_k1", "vconv_relu_k1", "vconv_k3",
    "vconv_relu_k3", "vrelu", "vmaxpool", "vunpool_conv2", "vpad", "vcrop_concat",
    "vsoftmax"])
def test_grads_match_jax_grad(name):
    """Autograd of each moment op (through VDPConv/VMaxPool for the k=3
    convs and the pool, PyTorch's own elsewhere) against jax.grad of its
    JAX twin, on the same cotangents: each input's gradient within 1e-4 of
    its max magnitude."""
    import jax

    rng = np.random.default_rng(10)
    op, args, extra = _grad_case(name, rng)
    jfn, tfn = getattr(jm, op), getattr(tm, op)
    cots = [rng.normal(0, 1, o.shape).astype(np.float32)
            for o in jfn(*map(jnp.asarray, args), *extra)]

    def jloss(*a):
        return sum(jnp.sum(o * c) for o, c in zip(jfn(*a, *extra), cots))

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tfn(*t, *extra), cots)).backward()
    for x, r in zip(t, want):
        r = np.asarray(r)
        assert np.abs(x.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max()
