"""Spatial (row-sharded) partitioning of the port
(``supernet_tpu_torch/parallel/spatial.py``) in spawned gloo worlds, against
the JAX package: the halo exchange, the sharded conv and the encoder block
against the JAX sharded primitives on the virtual CPU mesh (per-rank
outputs, and the halo's gradient against ``jax.grad`` through
``shard_map``); the whole-model forward and train step against the JAX
unsharded functions, with the tolerances of ``tests/test_spatial.py``
(forward atol 2e-5, step loss rtol 1e-5) and ``tests/test_parallel.py``
(parameters rtol 2e-5, atol 1e-6); ranks' parameters equal bit for bit. At
the tiny size on 4 ranks the bottleneck holds fewer rows than ranks. The
decoder glue fold under row sharding against the unfolded sharded path and
JAX's single-device fold, in 2-D and 3-D."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from supernet_tpu.parallel import spatial as jspatial  # noqa: E402
from supernet_tpu_torch import configs, ops  # noqa: E402
from supernet_tpu_torch.parallel import spatial  # noqa: E402
from _torch_parallel_ranks import (  # noqa: E402
    mesh1,  # noqa: F401  (a fixture)
    rank_block,
    rank_fold,
    rank_forward,
    rank_halo,
    rank_session,
    rank_train,
    spawn,
)


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
FWD_ATOL = 2e-5  # tests/test_spatial.py:103
LOSS_RTOL = 1e-5  # tests/test_spatial.py:153
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6  # tests/test_parallel.py:69-73


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.PRNGKey(0), JCFG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_sharded(fn, n_dev, n_in, n_out):
    """``fn`` under ``shard_map`` over an n_dev-device virtual CPU mesh, the
    first ``n_in`` arguments H-sharded, the rest replicated."""
    def wrap(*args):
        specs = tuple(P(None, "data") if i < n_in else P() for i in range(len(args)))
        out = P(None, "data") if n_out == 1 else (P(None, "data"),) * n_out
        return shard_map(fn, mesh=jmake_mesh(n_dev), in_specs=specs, out_specs=out,
                         check_vma=False)(*args)
    return wrap


def _per_rank(a, n):
    """An assembled H-sharded array as the n ranks' blocks."""
    h = a.shape[1] // n
    return [a[:, r * h:(r + 1) * h] for r in range(n)]


def test_split_rows():
    """Even blocks, and empty trailing blocks when rows run short (a pool
    splits its output rows, so its input blocks start on even rows)."""
    assert spatial._split(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert spatial._split(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    assert spatial._split(1, 3) == [(0, 1), (1, 1), (1, 1)]


@pytest.mark.parametrize("halo", [1, pytest.param(2, marks=pytest.mark.slow)])
def test_halo_exchange_rows_matches_jax(tmp_path, halo):
    """Four ranks of 3 rows: each rank's halo-extended block (zeros at the
    mesh's edges) is JAX's ``ppermute`` halo, and the gradient of a
    weighted sum reaches each row's owner as ``jax.grad`` through
    ``shard_map`` does."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 12, 5, 3)).astype(np.float32)
    f = _jax_sharded(lambda a: jspatial.halo_exchange_rows(a, "data", halo), 4, 1, 1)
    want = np.asarray(f(jnp.asarray(x)))
    w = rng.normal(0, 1, want.shape).astype(np.float32)
    jgrad = np.asarray(jax.grad(lambda a: (f(a) * w).sum())(jnp.asarray(x)))
    outs = spawn(rank_halo, 4, tmp_path, x, halo, w)
    for r, (y, g) in enumerate(outs):
        np.testing.assert_array_equal(y, _per_rank(want, 4)[r])
        np.testing.assert_allclose(g, _per_rank(jgrad, 4)[r], rtol=1e-6, atol=1e-6)


def test_spatial_vconv_and_encoder_block_match_jax(tmp_path):
    """``make_spatial_vconv`` and ``make_spatial_encoder_block`` on 4 ranks
    of 8 rows each against the JAX sharded primitives: every rank's block
    within atol 2e-5 (after ``trim_valid`` the assembled outputs are the
    unsharded VALID results, as the JAX tests hold)."""
    rng = np.random.default_rng(5)
    mu = rng.normal(0, 1, (2, 32, 12, 4)).astype(np.float32)
    sg = np.abs(rng.normal(0, 1, (2, 32, 12, 4))).astype(np.float32)
    w1 = (0.3 * rng.normal(0, 1, (3, 3, 4, 8))).astype(np.float32)
    ws1 = (rng.normal(0, 1, (8,)) - 4.0).astype(np.float32)
    w2 = (0.3 * rng.normal(0, 1, (3, 3, 8, 8))).astype(np.float32)
    ws2 = (rng.normal(0, 1, (8,)) - 4.0).astype(np.float32)
    jmesh = jmake_mesh(4)
    for what, args in (("vconv", (mu, sg, w1, ws1)), ("block", (mu, sg, w1, ws1, w2, ws2))):
        jf = (jspatial.make_spatial_vconv if what == "vconv"
              else jspatial.make_spatial_encoder_block)(jmesh)
        want = [np.asarray(a) for a in jf(*map(jnp.asarray, args))]
        outs = spawn(rank_block, 4, tmp_path / what, what, args)
        for r, got in enumerate(outs):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, _per_rank(w, 4)[r], atol=2e-5, err_msg=what)


def test_spatial_forward_matches_jax(jparams, tmp_path):
    """The whole U-Net forward with H split over 4 ranks (rows 32 -> a
    3-row and a 1-row bottleneck: ranks without rows there) gives every rank
    the JAX unsharded forward's outputs."""
    x = np.random.default_rng(0).normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
    outs = spawn(rank_forward, 4, tmp_path, "spatial", CFG, _np(jparams), x)
    want = jforward(jparams, jnp.asarray(x), JCFG)
    for o in outs:
        for got, w in zip(o, want):
            np.testing.assert_allclose(got, np.asarray(w), atol=FWD_ATOL)


def _check_steps(outs, jparams, xs, ys, cfg=JCFG, tc=JTC):
    state, _ = jtrain.create_train_state(jax.tree.map(jnp.array, jparams), tc)
    step = jtrain.make_train_step(cfg, tc)
    for i, (x, y) in enumerate(zip(xs, ys)):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        for o in outs:
            assert o["metrics"][i][0] == pytest.approx(float(m.loss), rel=LOSS_RTOL)
            assert o["metrics"][i][3] == pytest.approx(float(m.accuracy), abs=1e-3)
    for layer, ws in state.params.items():
        for k, v in ws.items():
            for o in outs:
                np.testing.assert_allclose(o["params"][layer][k], np.asarray(v),
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=f"{layer}/{k}")
                np.testing.assert_array_equal(o["params"][layer][k],
                                              outs[0]["params"][layer][k])


def _batches(n_steps, b, seed=0):
    rng = np.random.default_rng(seed)
    return ([rng.normal(0, 1, (b, 32, 32, 1)).astype(np.float32) for _ in range(n_steps)],
            [rng.integers(0, 3, (b, 22, 22)).astype(np.int32) for _ in range(n_steps)])


@pytest.mark.parametrize("remat", [False, True])
def test_spatial_train_step_matches_jax(jparams, tmp_path, remat):
    """Two steps with H split over 4 ranks (forward and backward: the halo
    gradients go back to their rows' owners, the weight gradient is summed
    over the ranks) against two JAX unsharded steps; under ``cfg.remat``
    every block's exchanges run again inside the backward, on every rank in
    the same order."""
    cfg = dataclasses.replace(CFG, remat=remat)
    xs, ys = _batches(2, 2)
    outs = spawn(rank_train, 4, tmp_path, "spatial", cfg, TC, _np(jparams), xs, ys)
    _check_steps(outs, jparams, xs, ys)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["fgsm", "pgd"])
def test_spatial_adversarial_training_matches_jax(jparams, tmp_path, mode):
    """Adversarial training with H split over 3 ranks: the examples come
    from the gradient of the sharded attack loss with respect to each
    rank's rows, clipped to the whole batch's range."""
    xs, ys = _batches(1, 2, seed=1)
    xs[0][0, 0, 0, 0] = 9.0
    kw = dict(adversarial_training=mode, adv_epsilon=0.3, adv_alpha=0.5, adv_steps=2)
    outs = spawn(rank_train, 3, tmp_path, "spatial", CFG, dataclasses.replace(TC, **kw),
                 _np(jparams), xs, ys)
    _check_steps(outs, jparams, xs, ys, tc=dataclasses.replace(JTC, **kw))


@pytest.mark.slow
def test_spatial_forward3d_and_step3d_match_jax(tmp_path):
    """The volumetric forward and step with D split over 3 ranks (16 rows:
    uneven blocks) against the JAX unsharded ``forward3d`` and 3-D step."""
    from supernet_tpu.models import forward3d as jforward3d
    from supernet_tpu.models import init_params3d as jinit3d
    from supernet_tpu.train3d import make_train_step3d as jstep3d

    shape = dict(image_size=16, out_size=10, base_kernels=2, depth=2)
    cfg = dataclasses.replace(configs.HIPPOCAMPUS.model, **shape)
    jcfg = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, **shape)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, 3, (2, 10, 10, 10)).astype(np.int32)
    jp = jinit3d(jax.random.PRNGKey(0), jcfg)
    outs = spawn(rank_forward, 3, tmp_path / "f", "spatial", cfg, _np(jp), x, 1, True)
    want = jforward3d(jp, jnp.asarray(x), jcfg)
    for got, w in zip(outs[0], want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4, atol=1e-6)
    outs = spawn(rank_train, 3, tmp_path / "s", "spatial", cfg, TC, _np(jp), [x], [y], 1,
                 True)
    state, _ = jtrain.create_train_state(jax.tree.map(jnp.array, jp), JTC)
    state, m = jstep3d(jcfg, JTC)(state, jnp.asarray(x), jnp.asarray(y))
    assert outs[0]["metrics"][0][0] == pytest.approx(float(m.loss), rel=LOSS_RTOL)
    for layer, ws in state.params.items():
        for k, v in ws.items():
            np.testing.assert_allclose(outs[0]["params"][layer][k], np.asarray(v),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.mark.slow
def test_scan_sharded_volumetric_session_matches_jax(tmp_path):
    """``InferenceSession(volumetric=True, mesh=, shard="scan")``: each
    volume's D axis over 3 ranks, 3 cubes at batch 2 (a padded tail), the
    answer of the JAX single-device volumetric session on every rank."""
    from supernet_tpu import serving as jserving
    from supernet_tpu.models import init_params3d as jinit3d

    shape = dict(image_size=16, out_size=10, base_kernels=2, depth=2)
    cfg = dataclasses.replace(configs.HIPPOCAMPUS.model, **shape)
    jcfg = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, **shape)
    jp = jinit3d(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(2).normal(0, 1, (3, 16, 16, 16, 1)).astype(np.float32)
    outs = spawn(rank_session, 3, tmp_path, cfg, [_np(jp)], x, 2, True, "scan")
    want = jserving.InferenceSession(jp, jcfg, batch_size=2, volumetric=True).predict(x)
    for o in outs:
        for got, w in zip(o, want):
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6)


def test_glue_fold_under_row_sharding_runs(jparams, mesh1):
    """The decoder glue fold under row sharding, in a world of one: the
    sharded forward under ``glue_fold="fold"`` is the meshless folded
    forward."""
    from supernet_tpu_torch import parallel
    from supernet_tpu_torch.checkpoint import params_from_jax
    from supernet_tpu_torch.models import forward

    params = params_from_jax(_np(jparams), "cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, 32, 32, 1))
                         .astype(np.float32))
    with ops.moments.lowering(glue_fold="fold"):
        got = parallel.make_spatial_forward(CFG, mesh1)(params, x)
        want = forward(params, x, CFG)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=FWD_ATOL)


def _jax_fold_forward(jp, x, jcfg, three_d):
    from supernet_tpu.models import forward3d as jforward3d
    from supernet_tpu.ops import moments as jm

    jm.set_glue_fold("fold")
    try:
        return (jforward3d if three_d else jforward)(jp, jnp.asarray(x), jcfg)
    finally:
        jm.set_glue_fold("none")


def check_sharded_fold(outs, jp, x, jcfg, three_d):
    """Each rank's folded sharded forward and step against its unfolded
    sharded run (forward atol 2e-5; parameters rtol 2e-5 / atol 1e-6; the
    step's metrics rtol 1e-5), the folded forward against JAX's
    single-device fold, the ranks' parameters bit-equal."""
    want = _jax_fold_forward(jp, x, jcfg, three_d)
    for o in outs:
        fold, none = o["fold"], o["none"]
        for got, ref, w in zip(fold["out"], none["out"], want):
            np.testing.assert_allclose(got, ref, atol=FWD_ATOL)
            np.testing.assert_allclose(got, np.asarray(w), atol=FWD_ATOL)
        np.testing.assert_allclose(fold["metrics"], none["metrics"], rtol=LOSS_RTOL)
        for layer, ws in none["params"].items():
            for k, v in ws.items():
                np.testing.assert_allclose(fold["params"][layer][k], v, rtol=PARAM_RTOL,
                                           atol=PARAM_ATOL, err_msg=f"{layer}/{k}")
                np.testing.assert_array_equal(fold["params"][layer][k],
                                              outs[0]["fold"]["params"][layer][k])


SHAPE3 = dict(image_size=16, out_size=10, base_kernels=2, depth=2)


def fold_case(three_d):
    """(cfg, jcfg, JAX params, x, y) of the sharded-fold cases: the tiny
    2-D config, or a 16^3 cube at depth 2."""
    from supernet_tpu.models import init_params3d as jinit3d

    rng = np.random.default_rng(6)
    if three_d:
        cfg = dataclasses.replace(configs.HIPPOCAMPUS.model, **SHAPE3)
        jcfg = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, **SHAPE3)
        return (cfg, jcfg, jinit3d(jax.random.PRNGKey(0), jcfg),
                rng.normal(0, 1, (2, 16, 16, 16, 1)).astype(np.float32),
                rng.integers(0, 3, (2, 10, 10, 10)).astype(np.int32))
    return (CFG, JCFG, jinit(jax.random.PRNGKey(0), JCFG),
            rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32),
            rng.integers(0, 3, (2, 22, 22)).astype(np.int32))


@pytest.mark.parametrize("world,three_d", [
    (4, False),  # 32 rows: the bottleneck and the first decoder levels hold
                 # fewer rows than ranks, windows wholly in a pad widen
    (2, True),
    pytest.param(2, False, marks=pytest.mark.slow),
    pytest.param(4, True, marks=pytest.mark.slow),
])
def test_sharded_glue_fold_matches_unfolded_and_jax(tmp_path, world, three_d):
    """The glue fold with H (D) split over ``world`` ranks, forward and one
    train step, against the unfolded sharded path in the same world and
    the JAX single-device fold."""
    cfg, jcfg, jp, x, y = fold_case(three_d)
    outs = spawn(rank_fold, world, tmp_path, "spatial", cfg, TC, _np(jp), x, y, 1, three_d)
    check_sharded_fold(outs, jp, x, jcfg, three_d)


@pytest.mark.slow
def test_sharded_glue_fold_with_the_bottleneck_pre_pad(tmp_path):
    """The BraTS geometry at a test width (depth 5, the (1, 0) pre-pad
    folded into the bottleneck's first conv) over 3 ranks."""
    cfg = dataclasses.replace(configs.BRATS.model, base_kernels=2)
    jcfg = dataclasses.replace(jconfigs.BRATS.model, base_kernels=2)
    jp = jinit(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (1, 204, 204, 4)).astype(np.float32)
    y = rng.integers(0, 5, (1, 186, 186)).astype(np.int32)
    outs = spawn(rank_fold, 3, tmp_path, "spatial", cfg, configs.BRATS.train, _np(jp), x, y)
    check_sharded_fold(outs, jp, x, jcfg, False)
