"""The port's naive backend (``ops.set_backend("naive")``,
``SUPERNET_BACKEND=naive``) on the CPU: the whole model through the
reference's patch-matmul algorithm (``ops/naive.py``) against the JAX
package under ``set_backend("naive")`` from the same npz parameters, forward
and the train step's gradients at the golden tolerance (atol 2e-5,
``tests/test_golden.py:59``); against the port's default path;
the glue fold ignored in 2-D and 3-D; member-stacked weights; the env
override."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import ops as jops  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.checkpoint import save_params_npz as jsave  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import configs, ops, train  # noqa: E402
from supernet_tpu_torch.checkpoint import load_params_npz  # noqa: E402
from supernet_tpu_torch.models import forward, forward3d  # noqa: E402
from supernet_tpu_torch.ops import moments as tm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_backend():
    yield
    ops.set_backend("kernels")
    jops.set_backend("xla")


TINY = dict(image_size=32, out_size=22, base_kernels=4)
CFG = dataclasses.replace(configs.HIPPOCAMPUS.model, **TINY)
JCFG = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, **TINY)
TC, JTC = configs.HIPPOCAMPUS.train, jconfigs.HIPPOCAMPUS.train
ATOL = 2e-5  # tests/test_golden.py:59


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("params") / "init.npz")
    jsave(path, jinit(jax.random.PRNGKey(0), JCFG))
    return path


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, 32, 32, 1)).astype(np.float32),
            rng.integers(0, 3, (b, 22, 22)).astype(np.int32))


def _port(npz, x, y, backend, fold="none"):
    """(probs, sigma, loss, gradients) of the port under ``backend``."""
    params = load_params_npz(npz, "cpu")
    leaves = train.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    ops.set_backend(backend)
    with tm.lowering(glue_fold=fold):
        loss, (_, _, probs, sigma) = train.loss_fn(
            params, torch.from_numpy(x), torch.from_numpy(y), CFG, TC)
        grads = torch.autograd.grad(loss, leaves)
    return (probs.detach().numpy(), sigma.detach().numpy(), float(loss.detach()),
            [g.numpy() for g in grads], params)


def _grad_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_naive_model_matches_jax_naive(npz):
    """Forward and train-step gradients of the whole model under the naive
    backend against the JAX package's naive backend."""
    from supernet_tpu.checkpoint import load_params_npz as jload

    x, y = _batch()
    probs, sigma, loss, grads, params = _port(npz, x, y, "naive")
    jparams = jload(npz)
    jops.set_backend("naive")
    jp, js = jforward(jparams, jnp.asarray(x), JCFG)
    jl, jg = jax.value_and_grad(lambda p: jtrain.loss_fn(
        p, jnp.asarray(x), jtrain.ensure_one_hot(jnp.asarray(y), 3), JCFG, JTC)[0])(jparams)
    np.testing.assert_allclose(probs, np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(sigma, np.asarray(js), atol=ATOL)
    assert loss == pytest.approx(float(jl), rel=1e-5)
    _grad_close(grads, [np.asarray(jg[layer][name])
                        for layer, ws in params.items() for name in ws])


@pytest.mark.parametrize("fold", ["none", "fold"])
def test_naive_matches_the_default_path_and_ignores_the_fold(npz, fold):
    """The port's naive path against its default path (the plain versions
    of the kernels here); under ``glue_fold="fold"`` the naive forward is
    the unfolded one bit for bit (the models ignore the fold, as
    ``supernet_tpu/models/unet.py:170`` does)."""
    x, y = _batch(1)
    naive = _port(npz, x, y, "naive", fold)
    dflt = _port(npz, x, y, "kernels")
    np.testing.assert_allclose(naive[0], dflt[0], atol=ATOL)
    np.testing.assert_allclose(naive[1], dflt[1], atol=ATOL)
    _grad_close(naive[3], dflt[3])
    if fold == "fold":
        plain = _port(npz, x, y, "naive")
        for a, b in zip(naive[:2] + tuple(naive[3]), plain[:2] + tuple(plain[3])):
            np.testing.assert_array_equal(a, b)


def test_naive_forward3d_ignores_the_fold():
    """The 3-D forward under the naive backend takes the unfolded glue, bit
    for bit (its head is the 2-D softmax closure, naive in both packages)."""
    from supernet_tpu_torch.models import init_params3d

    cfg = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=16, out_size=10,
                              base_kernels=2, depth=2)
    params = init_params3d(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (1, 16, 16, 16, 1))
                         .astype(np.float32))
    ops.set_backend("naive")
    with tm.lowering(glue_fold="none"):
        want = forward3d(params, x, cfg)
    with tm.lowering(glue_fold="fold"):
        got = forward3d(params, x, cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_naive_member_stacked_forward(npz):
    """Member-stacked weights under the naive backend run member by member
    (the JAX naive path runs under ``jax.vmap``): each member's output is
    its single-model naive forward."""
    x, _ = _batch(3)
    p0 = load_params_npz(npz, "cpu")
    p1 = {k: {n: t * 0.9 for n, t in v.items()} for k, v in p0.items()}
    stacked = train.stack_trees([p0, p1])
    xt = torch.from_numpy(x)
    ops.set_backend("naive")
    probs, sigma = forward(stacked, xt.expand(2, *xt.shape), CFG)
    assert probs.shape == (2, 2, 22 * 22, 3)
    for k, p in enumerate((p0, p1)):
        pk, sk = forward(p, xt, CFG)
        np.testing.assert_allclose(probs[k].numpy(), pk.numpy(), atol=1e-6)
        np.testing.assert_allclose(sigma[k].numpy(), sk.numpy(), atol=1e-6,
                                   rtol=1e-5)


def test_backend_env_override(monkeypatch, capsys):
    """``SUPERNET_BACKEND=naive`` selects the naive backend; ``xla``,
    ``pallas`` and ``auto`` leave the port's one path and say so on stderr;
    an unknown value is refused as the JAX setter refuses it."""
    monkeypatch.setenv("SUPERNET_BACKEND", "naive")
    ops.apply_env_overrides()
    assert ops.get_backend() == "naive"
    ops.set_backend("kernels")
    for v in ("xla", "pallas", "auto"):
        monkeypatch.setenv("SUPERNET_BACKEND", v)
        ops.apply_env_overrides()
        assert ops.get_backend() == "kernels"
        assert f"SUPERNET_BACKEND={v} has no counterpart" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        ops.set_backend("tpu")
