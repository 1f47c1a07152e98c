"""The port's patch-matmul baseline (``supernet_tpu_torch/ops/naive.py``) on
the CPU: each ``*_naive`` against ``supernet_tpu.ops.naive`` on the same
numpy inputs, and against the port's fused primitives in ``ops/moments.py``
(the cross-check it exists for). float32 matrix products in two summation
orders: ``ATOL`` absolute on values of order 1 to 10.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops import naive as jnaive  # noqa: E402
from supernet_tpu_torch.ops import moments as tm  # noqa: E402
from supernet_tpu_torch.ops import naive  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5


def _rand(rng, *shape, positive=False):
    a = rng.normal(0, 1, shape).astype(np.float32)
    return np.abs(a) * 0.1 if positive else a


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol=ATOL):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=atol)


@pytest.mark.parametrize("k,stride", [(3, 1), (2, 1), (1, 1), (3, 2), (2, 2)])
def test_extract_patches_matches_jax(k, stride):
    """The (row, column, channel) tap order of ``tf.image.extract_patches``,
    bit for bit."""
    x = _rand(np.random.default_rng(0), 2, 9, 8, 3)
    got = naive.extract_patches(torch.from_numpy(x), k, stride)
    want = np.asarray(jnaive.extract_patches(jnp.asarray(x), k, stride))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_extract_patches_tap_order():
    x = torch.arange(2 * 3 * 3 * 2, dtype=torch.float32).reshape(2, 3, 3, 2)
    p = naive.extract_patches(x, 2)
    assert p.shape == (2, 2, 2, 8)
    # window at (0, 0) of image 0: rows 0-1, columns 0-1, channel fastest
    np.testing.assert_array_equal(p[0, 0, 0].numpy(), [0, 1, 2, 3, 6, 7, 8, 9])


@pytest.mark.parametrize("k,cin,cout,stride", [(3, 1, 4, 1), (3, 3, 5, 1), (2, 4, 3, 1),
                                               (1, 4, 3, 1), (3, 2, 4, 2)])
def test_vconv_input_naive(k, cin, cout, stride):
    rng = np.random.default_rng(k + cin)
    x, w_mu, w_sigma = _rand(rng, 2, 10, 11, cin), 0.3 * _rand(rng, k, k, cin, cout), \
        _rand(rng, cout) - 3.0
    got = naive.vconv_input_naive(*_t(x, w_mu, w_sigma), stride=stride)
    _close(got, jnaive.vconv_input_naive(*_j(x, w_mu, w_sigma), stride=stride))
    if stride == 1:
        fused = tm.vconv_input(*_t(x, w_mu, w_sigma))
        _close(got, [f.numpy() for f in fused])


@pytest.mark.parametrize("k,cin,cout,stride", [(3, 2, 4, 1), (3, 8, 8, 1), (2, 4, 3, 1),
                                               (1, 4, 3, 1), (3, 3, 2, 2)])
def test_vconv_naive(k, cin, cout, stride):
    rng = np.random.default_rng(10 * k + cin)
    mu, sigma = _rand(rng, 2, 9, 10, cin), _rand(rng, 2, 9, 10, cin, positive=True)
    w_mu, w_sigma = 0.3 * _rand(rng, k, k, cin, cout), _rand(rng, cout) - 3.0
    got = naive.vconv_naive(*_t(mu, sigma, w_mu, w_sigma), stride=stride)
    _close(got, jnaive.vconv_naive(*_j(mu, sigma, w_mu, w_sigma), stride=stride))
    if stride == 1:
        fused = tm.vconv(*_t(mu, sigma, w_mu, w_sigma))
        _close(got, [f.numpy() for f in fused])


@pytest.mark.parametrize("shape,ties", [((2, 8, 8, 3), False), ((2, 7, 9, 4), False),
                                        ((3, 6, 5, 2), True), ((1, 1, 1, 1), False)])
def test_vmaxpool_naive(shape, ties):
    """Even and odd sizes (padded at the bottom and right), and ties, which
    go to the first tap of the window: equal to the JAX baseline and to the
    port's pool bit for bit."""
    rng = np.random.default_rng(sum(shape))
    mu, sigma = _rand(rng, *shape), _rand(rng, *shape, positive=True)
    if ties:
        mu = np.round(2.0 * mu)
    got = naive.vmaxpool_naive(*_t(mu, sigma))
    want = jnaive.vmaxpool_naive(*_j(mu, sigma))
    fused = tm.vmaxpool(*_t(mu, sigma))
    for g, w, f in zip(got, want, fused):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), f.numpy())


@pytest.mark.parametrize("b,c", [(2, 3), (1, 5)])
def test_vsoftmax_naive(b, c):
    """The explicit Jacobian form, a batch of one included (the reference's
    squeeze hazard), against the JAX baseline and the port's closed form."""
    rng = np.random.default_rng(b + c)
    mu, sigma = 2.0 * _rand(rng, b, 4, 5, c), _rand(rng, b, 4, 5, c, positive=True)
    got = naive.vsoftmax_naive(*_t(mu, sigma))
    assert got[0].shape == (b, 20, c)
    _close(got, jnaive.vsoftmax_naive(*_j(mu, sigma)), atol=1e-6)
    _close(got, [f.numpy() for f in tm.vsoftmax(*_t(mu, sigma))], atol=1e-6)


def test_no_path_of_the_port_calls_the_baseline(monkeypatch):
    """It is a cross-check and a baseline, not a kernel: the one module that
    imports it is ``ops/moments.py``, whose naive backend
    (``set_backend("naive")``) routes to it, and on the default backend a
    forward and a backward never call it."""
    import dataclasses
    import os
    import re

    from supernet_tpu_torch import configs
    from supernet_tpu_torch.models import forward, init_params

    root = os.path.dirname(os.path.abspath(naive.__file__))
    pkg = os.path.dirname(root)
    users = []
    for d, _, files in os.walk(pkg):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith(".py") and path != os.path.abspath(naive.__file__):
                with open(path) as fh:
                    if re.search(r"import naive\b|ops\.naive import", fh.read()):
                        users.append(os.path.relpath(path, pkg))
    assert users == [os.path.join("ops", "moments.py")]

    def refuse(*a, **k):
        raise AssertionError("the default path called ops/naive.py")

    for name in ("vconv_input_naive", "vconv_naive", "vmaxpool_naive", "vsoftmax_naive"):
        monkeypatch.setattr(naive, name, refuse)
    assert tm.get_backend() == "kernels"
    cfg = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                              base_kernels=4)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for t in (t for p in params.values() for t in p.values()):
        t.requires_grad_(True)
    probs, sigma = forward(params, torch.zeros(1, 32, 32, 1), cfg)
    (probs.sum() + sigma.sum()).backward()
