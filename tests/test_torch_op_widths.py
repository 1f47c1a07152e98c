"""The port's one lowering of each conv at the channel widths the cells run:
every distinct ``(k, C_in, C_out)`` of the ``brats`` configuration through
the 2-D ops (``VDPConv``'s plain version for k = 3, the einsum head for
k = 1), and of the Cicek plan through the 3-D ops (``conv3d``), against
the JAX package's ops at a small spatial size, outputs and gradients.

Inputs are on the models' scales: mu ~ N(0, 1), sigma = 0.1 |N(0, 1)|,
``w_mu`` at the He scale of the models' init, ``w_sigma`` uniform on the
configuration's range. Outputs are held within the ``ATOL`` of
``tests/test_torch_ops.py`` and ``tests/test_torch_moments3d.py`` taken
relative to the output's max magnitude where that exceeds 1 (a window sum
over 9 * 512 channels is of order 10^2), gradients within each file's
``GRAD_RTOL`` of each gradient's max magnitude."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops import moments as jm  # noqa: E402
from supernet_tpu.ops import moments3d as jm3  # noqa: E402
from supernet_tpu_torch.configs import BRATS  # noqa: E402
from supernet_tpu_torch.models import unet, unet3d  # noqa: E402
from supernet_tpu_torch.ops import moments as tm  # noqa: E402
from supernet_tpu_torch.ops import moments3d as tm3  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5
GRAD_RTOL_2D = 1e-4  # tests/test_torch_ops.py
GRAD_RTOL_3D = 2e-5  # tests/test_torch_moments3d.py
CICEK = unet3d.CICEK3D.model


def _widths(layers):
    """``(first, k, C_in, C_out)`` of each distinct k > 1 or 1x1 conv, the
    first conv (deterministic input) apart; the 2x2 unpool convs are
    ``vunpool_conv2``'s, not a lowering of ``vconv``."""
    return sorted({(name == "conv_input", k, cin, cout)
                   for name, k, cin, cout in layers if k != 2})


WIDTHS_2D = _widths(unet.layer_names(BRATS.model))
WIDTHS_3D = _widths(unet3d.layer_names3d(CICEK))


def _ids(widths):
    return [f"{'input-' if first else ''}k{k}-{cin}-{cout}" for first, k, cin, cout in widths]


def _case(rng, first, k, cin, cout, spatial, cfg):
    """numpy ``(mu[, sigma], w_mu, w_sigma)`` of one conv."""
    shape = (2,) + spatial + (cin,)
    mu = rng.normal(0, 1, shape).astype(np.float32)
    sigma = (0.1 * np.abs(rng.normal(0, 1, shape))).astype(np.float32)
    w_shape = (k,) * len(spatial) + (cin, cout)
    w_mu = rng.normal(0, np.sqrt(2.0 / (k ** len(spatial) * cin)), w_shape).astype(np.float32)
    w_sigma = rng.uniform(cfg.sigma_min, cfg.sigma_max, cout).astype(np.float32)
    return [mu, w_mu, w_sigma] if first else [mu, sigma, w_mu, w_sigma]


def _check(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL * scale)


def _grads(tfn, jfn, args, rng, rtol):
    """Autograd of ``tfn`` against ``jax.grad`` of ``jfn`` on the same
    random cotangents, every input's gradient within ``rtol`` of its max."""
    cots = [rng.normal(0, 1, np.shape(o)).astype(np.float32)
            for o in jfn(*map(jnp.asarray, args))]

    def jloss(*a):
        return sum(jnp.sum(o * c) for o, c in zip(jfn(*a), cots))

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tfn(*t), cots)).backward()
    for x, r in zip(t, want):
        r = np.asarray(r)
        assert np.abs(x.grad.numpy() - r).max() <= rtol * np.abs(r).max()


def _run(t_mod, j_mod, first, k, args, rng, rtol, suffix=""):
    """The plain op forward and, for k > 1, the port's fused-ReLU form (the
    models' call) against ``vrelu`` of the JAX op, forward and gradients;
    ``suffix`` "3d" names the 3-D ops (``vconv3d_input``, ...)."""
    name = f"vconv{suffix}_input" if first else f"vconv{suffix}"
    t_fn, j_plain = getattr(t_mod, name), getattr(j_mod, name)
    j_fn = j_plain
    if k > 1:
        _check(t_fn(*map(torch.from_numpy, args)), j_plain(*map(jnp.asarray, args)))
        t_fn = getattr(t_mod, name + "_relu")

        def j_fn(*a):
            return jm.vrelu(*j_plain(*a))

    _check(t_fn(*map(torch.from_numpy, args)), j_fn(*map(jnp.asarray, args)))
    _grads(t_fn, j_fn, args, rng, rtol)


@pytest.mark.parametrize("first,k,cin,cout", WIDTHS_2D, ids=_ids(WIDTHS_2D))
def test_brats_widths_match_jax(first, k, cin, cout):
    rng = np.random.default_rng(cin * 1000 + cout)
    args = _case(rng, first, k, cin, cout, (10, 10), BRATS.model)
    _run(tm, jm, first, k, args, rng, GRAD_RTOL_2D)


@pytest.mark.parametrize("first,k,cin,cout", WIDTHS_3D, ids=_ids(WIDTHS_3D))
def test_cicek_widths_match_jax(first, k, cin, cout):
    rng = np.random.default_rng(cin * 1000 + cout)
    args = _case(rng, first, k, cin, cout, (6, 6, 6), CICEK)
    _run(tm3, jm3, first, k, args, rng, GRAD_RTOL_3D, suffix="3d")
