"""Hybrid data x spatial partitioning of the port
(``supernet_tpu_torch/parallel/hybrid.py``) on a 2-D (data, space) gloo
mesh of spawned ranks, against the JAX package's unsharded step, forward and
3-D step, with the tolerances of ``tests/test_hybrid.py`` / ``test_spatial.py``
(step loss rtol 1e-5, forward atol 2e-5) and ``tests/test_parallel.py``
(parameters rtol 2e-5, atol 1e-6); the ranks' parameters equal bit for bit.
The image's 32 rows split over 3 space ranks unevenly, as the JAX docstring
allows. The decoder glue fold on a (2, 2) mesh against the unfolded hybrid
path and JAX's single-device fold."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import configs  # noqa: E402
from supernet_tpu_torch.data.augment import augment_train_batch  # noqa: E402
from _torch_parallel_ranks import rank_fold, rank_forward, rank_train, spawn  # noqa: E402
from test_torch_spatial import check_sharded_fold, fold_case  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(image_size=32, out_size=22, base_kernels=4)
CFG = dataclasses.replace(configs.HIPPOCAMPUS.model, **TINY)
JCFG = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, **TINY)
TC, JTC = configs.HIPPOCAMPUS.train, jconfigs.HIPPOCAMPUS.train
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.PRNGKey(0), JCFG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params(outs, jstate):
    for layer, ws in jstate.params.items():
        for k, v in ws.items():
            for o in outs:
                np.testing.assert_allclose(o["params"][layer][k], np.asarray(v),
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=f"{layer}/{k}")
                np.testing.assert_array_equal(o["params"][layer][k],
                                              outs[0]["params"][layer][k])


@pytest.mark.parametrize("n_data,n_space", [
    (2, 3),  # 32 rows over 3 space ranks: uneven blocks
    pytest.param(2, 2, marks=pytest.mark.slow),
    pytest.param(4, 1, marks=pytest.mark.slow),
])
def test_hybrid_train_step_matches_jax(jparams, tmp_path, n_data, n_space):
    """Two steps on the (data, space) mesh, augmentation on (each data
    group augments its block of the batch with its global offset), against
    two JAX unsharded steps: the weight gradient summed over space and
    averaged over data."""
    rng = np.random.default_rng(0)
    b = 2 * n_data
    xs = [rng.normal(0, 1, (b, 32, 32, 1)).astype(np.float32) for _ in range(2)]
    ys = [rng.integers(0, 3, (b, 22, 22)).astype(np.int32) for _ in range(2)]
    augment = configs.AugmentConfig(rot90=True)
    outs = spawn(rank_train, n_data * n_space, tmp_path, "hybrid", CFG,
                 dataclasses.replace(TC, augment=augment), _np(jparams), xs, ys, n_data)
    # jax.random and the port's draws are two streams: the reference is the
    # port's augmentation of the whole batch, through the JAX unsharded step
    state, _ = jtrain.create_train_state(jax.tree.map(jnp.array, jparams), JTC)
    step = jtrain.make_train_step(JCFG, JTC)
    for i in range(2):
        xa, ya = augment_train_batch(i, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]),
                                     22, augment, TC.seed)
        state, m = step(state, jnp.asarray(xa.numpy()), jnp.asarray(ya.numpy()))
        for o in outs:
            assert o["metrics"][i][0] == pytest.approx(float(m.loss), rel=LOSS_RTOL)
    _assert_params(outs, state)


@pytest.mark.slow
def test_hybrid_forward_matches_jax(jparams, tmp_path):
    """The hybrid forward of a 3-image batch on a (2, 2) mesh (the batch
    padded over data) gives every rank the JAX unsharded outputs."""
    x = np.random.default_rng(1).normal(0, 1, (3, 32, 32, 1)).astype(np.float32)
    outs = spawn(rank_forward, 4, tmp_path, "hybrid", CFG, _np(jparams), x, 2)
    want = jforward(jparams, jnp.asarray(x), JCFG)
    for o in outs:
        for got, w in zip(o, want):
            np.testing.assert_allclose(got, np.asarray(w), atol=2e-5)


@pytest.mark.slow
def test_hybrid_train_step3d_matches_jax(tmp_path):
    """The volumetric step on a (2, 2) mesh (volumes over data, D over
    space) against the JAX unsharded 3-D step."""
    from supernet_tpu.models import init_params3d as jinit3d
    from supernet_tpu.train3d import make_train_step3d as jstep3d

    shape = dict(image_size=16, out_size=10, base_kernels=2, depth=2)
    cfg = dataclasses.replace(configs.HIPPOCAMPUS.model, **shape)
    jcfg = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, **shape)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, 3, (2, 10, 10, 10)).astype(np.int32)
    jp = jinit3d(jax.random.PRNGKey(0), jcfg)
    outs = spawn(rank_train, 4, tmp_path, "hybrid", cfg, TC, _np(jp), [x], [y], 2, True)
    state, _ = jtrain.create_train_state(jax.tree.map(jnp.array, jp), JTC)
    state, m = jstep3d(jcfg, JTC)(state, jnp.asarray(x), jnp.asarray(y))
    assert outs[0]["metrics"][0][0] == pytest.approx(float(m.loss), rel=LOSS_RTOL)
    _assert_params(outs, state)


@pytest.mark.parametrize("three_d", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_hybrid_glue_fold_matches_unfolded_and_jax(tmp_path, three_d):
    """The glue fold on a (2, 2) mesh (the batch over data, rows over
    space), forward and one train step, against the unfolded hybrid path in
    the same world and the JAX single-device fold."""
    cfg, jcfg, jp, x, y = fold_case(three_d)
    outs = spawn(rank_fold, 4, tmp_path, "hybrid", cfg, TC, _np(jp), x, y, 2, three_d)
    check_sharded_fold(outs, jp, x, jcfg, three_d)


def test_make_mesh2d_shape_and_axes(tmp_path):
    """A (1, 1) mesh in a world of one has the JAX mesh's axes; a mesh
    larger than the world is refused with the JAX message."""
    from _torch_parallel_ranks import world_of_one
    from supernet_tpu_torch import parallel

    with world_of_one(tmp_path):
        mesh = parallel.make_mesh2d(1, 1)
        assert mesh.mesh_dim_names == ("data", "space") and mesh.mesh.shape == (1, 1)
        with pytest.raises(ValueError, match="mesh needs 2x2=4 devices, 1 available"):
            parallel.make_mesh2d(2, 2)
