"""Data parallelism of the port (``supernet_tpu_torch/parallel/
data_parallel.py`` and the mesh paths of the trainer, the evaluation
runners, the sessions and the ensembles) in spawned gloo worlds of 2 or 3
ranks, against the JAX package's single-device functions on the same npz
parameters and numpy batches, with the tolerances of its twin tests
(``tests/test_parallel.py``): a step's loss rtol 1e-5, parameters rtol 2e-5
and atol 1e-6; the ranks' parameters equal bit for bit."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import evaluate as jevaluate  # noqa: E402
from supernet_tpu import serving as jserving  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.data import PickleDataset as JPickleDataset  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from supernet_tpu_torch import configs, evaluate  # noqa: E402
from supernet_tpu_torch.data import PickleDataset, synthetic_dataset  # noqa: E402
from _torch_parallel_ranks import (  # noqa: E402
    mesh1,  # noqa: F401  (a fixture)
    rank_ensemble_trainer,
    rank_eval,
    rank_forward,
    rank_session,
    rank_train,
    rank_trainer,
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
LOSS_RTOL = 1e-5  # tests/test_parallel.py:63-65
PARAM_RTOL, PARAM_ATOL = 2e-5, 1e-6  # tests/test_parallel.py:69-73
# the port against the JAX package on the CPU (tests/test_torch_evaluate.py:
# ReLU and argmax ties of two float32 implementations); against the port's
# own single-device run the mesh run holds 1e-6
METRIC_ATOL, ADV_METRIC_ATOL = 2e-3, 2e-2


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.PRNGKey(0), JCFG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n_steps, b, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(0, 1, (b, 32, 32, 1)).astype(np.float32) for _ in range(n_steps)]
    ys = [rng.integers(0, 3, (b, 22, 22)).astype(np.int32) for _ in range(n_steps)]
    return xs, ys


def _jax_steps(jparams, xs, ys, tc=JTC, cfg=JCFG):
    state, _ = jtrain.create_train_state(jax.tree.map(jnp.array, jparams), tc)
    step = jtrain.make_train_step(cfg, tc)
    losses = []
    for x, y in zip(xs, ys):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m.loss))
    return state, losses


def assert_matches(outs, jstate, jlosses):
    """Every rank's losses and parameters against the JAX run; the ranks'
    parameters equal bit for bit."""
    for o in outs:
        for got, want in zip(o["metrics"], jlosses):
            assert got[0] == pytest.approx(want, rel=LOSS_RTOL)
        for layer, ws in jstate.params.items():
            for k, v in ws.items():
                np.testing.assert_allclose(o["params"][layer][k], np.asarray(v),
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=f"{layer}/{k}")
                np.testing.assert_array_equal(o["params"][layer][k],
                                              outs[0]["params"][layer][k])


@pytest.mark.parametrize("use_shard_map", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_sharded_step_matches_single_device(jparams, tmp_path, use_shard_map):
    """Two ranks, two steps of ``make_sharded_train_step`` on their halves
    of each batch against two JAX single-device steps on the whole; the
    prediction gathered from the ranks is the whole batch's. Both values of
    ``use_shard_map`` are the one per-shard path."""
    xs, ys = _batches(2, 4)
    tc = dataclasses.replace(TC, seed=3 if use_shard_map else TC.seed)
    jtc = dataclasses.replace(JTC, seed=tc.seed)
    outs = spawn(rank_train, 2, tmp_path, "dp", CFG, tc, _np(jparams), xs, ys, 1, False,
                 True)
    jstate, jlosses = _jax_steps(jparams, xs, ys, jtc)
    assert_matches(outs, jstate, jlosses)
    assert outs[0]["pred"].shape == (4, 22 * 22) and outs[0]["step"] == 2


def test_sharded_adversarial_training_matches_single_device(jparams, tmp_path):
    """FGSM adversarial training under data parallelism clips the examples
    to the GLOBAL batch's range: the extremes live on rank 0's rows only,
    so a per-rank range would train other parameters."""
    xs, ys = _batches(1, 4, seed=1)
    xs[0][0, 0, 0, 0], xs[0][0, 0, 1, 0] = 9.0, -9.0
    kw = dict(adversarial_training="fgsm", adv_epsilon=0.5, adv_alpha=0.5)
    outs = spawn(rank_train, 2, tmp_path, "dp", CFG, dataclasses.replace(TC, **kw),
                 _np(jparams), xs, ys)
    jstate, jlosses = _jax_steps(jparams, xs, ys, dataclasses.replace(JTC, **kw))
    assert_matches(outs, jstate, jlosses)


@pytest.mark.slow
def test_sharded_forward_and_session_match_jax(jparams, tmp_path):
    """``make_sharded_forward`` of a 5-image batch on 2 ranks (the tail
    padded and cut) against the JAX forward, atol 2e-5; an
    ``InferenceSession(mesh=)`` at batch 2 answers 5 images as the JAX
    session does."""
    x = np.random.default_rng(2).normal(0, 1, (5, 32, 32, 1)).astype(np.float32)
    outs = spawn(rank_forward, 2, tmp_path / "f", "dp", CFG, _np(jparams), x)
    want = jforward(jparams, jnp.asarray(x), JCFG)
    for o in outs:
        for got, w in zip(o, want):
            np.testing.assert_allclose(got, np.asarray(w), atol=2e-5)
    outs = spawn(rank_session, 2, tmp_path / "s", CFG, [_np(jparams)], x, 2)
    want = jserving.InferenceSession(jparams, JCFG, batch_size=2).predict(x)
    for o in outs:
        for got, w in zip(o, want):
            np.testing.assert_allclose(got, w, atol=2e-5)


def test_run_testing_with_mesh_nondivisible_tail(jparams, tmp_path):
    """13 samples at batch 8 on 2 ranks (a tail of 5: the last rank's rows
    padded): the report equals the JAX single-device run's."""
    exp = configs.HIPPOCAMPUS.replace(
        model=CFG, train=dataclasses.replace(TC, batch_size=8))
    jexp = jconfigs.HIPPOCAMPUS.replace(
        model=JCFG, train=dataclasses.replace(JTC, batch_size=8), out_dir=str(tmp_path))
    x, y = synthetic_dataset(CFG, 13, seed=0)
    outs = spawn(rank_eval, 2, tmp_path / "w", "run_testing", exp, _np(jparams), x, y,
                 str(tmp_path / "out"))
    want = jevaluate.run_testing(jexp, jparams, JPickleDataset(x, y, 1), images_n=0,
                                 out_dir=str(tmp_path / "j"))
    one = evaluate.run_testing(exp, _np(jparams), PickleDataset(x, y, 1), images_n=0,
                               out_dir=str(tmp_path / "one"), device="cpu")
    for o in outs:
        for k in ("accuracy", "dice_anterior", "dice_posterior", "hausdorff_anterior",
                  "sensitivity_posterior", "mean_predictive_variance"):
            assert o[k] == pytest.approx(want[k], abs=METRIC_ATOL, rel=METRIC_ATOL,
                                         nan_ok=True), k
            assert o[k] == pytest.approx(one[k], rel=1e-6, nan_ok=True), k


def test_trainer_on_a_shrunken_mesh(tmp_path):
    """Three ranks and a batch of 4: a mesh over all three is refused at
    setup; ``make_mesh_for_batch`` keeps two; rank 2 trains and writes
    nothing, ranks 0 and 1 train the same bits, and rank 0 alone writes the
    checkpoint, history and hyperparameters."""
    exp = configs.HIPPOCAMPUS.replace(
        model=CFG, train=dataclasses.replace(TC, batch_size=4, epochs=1, log_every=100))
    x, y = synthetic_dataset(CFG, 8, seed=0)
    outs = spawn(rank_trainer, 3, tmp_path / "w", exp, x, y, str(tmp_path / "out"))
    assert all("not divisible by the 3-device mesh" in o["guard"] for o in outs)
    assert [o["mesh"] for o in outs] == [2, 2, 2]
    assert outs[2]["params"] is None and outs[2]["history"]["train_loss"] == []
    for layer, ws in outs[0]["params"].items():
        for k, v in ws.items():
            np.testing.assert_array_equal(v, outs[1]["params"][layer][k])
    assert {"epoch_0", "history.pkl", "Related_hyperparameters.txt"} <= set(outs[0]["files"])
    assert np.isfinite(outs[0]["history"]["val_loss"][-1])
    assert outs[1]["history"] == outs[0]["history"]  # rank 0 validates, all report


@pytest.mark.slow
def test_run_adversarial_with_mesh_matches_single_device(jparams, tmp_path):
    """PGD on 11 samples at batch 8 on 2 ranks: the adversarial report
    equals the JAX single-device run's (tests/test_parallel.py:208)."""
    kw = dict(max_adv_step=2, epsilon=0.01)
    exp = configs.HIPPOCAMPUS.replace(
        model=CFG, train=dataclasses.replace(TC, batch_size=8),
        attack=dataclasses.replace(configs.HIPPOCAMPUS.attack, **kw))
    jexp = jconfigs.HIPPOCAMPUS.replace(
        model=JCFG, train=dataclasses.replace(JTC, batch_size=8), out_dir=str(tmp_path),
        attack=dataclasses.replace(jconfigs.HIPPOCAMPUS.attack, **kw))
    x, y = synthetic_dataset(CFG, 11, seed=0)
    outs = spawn(rank_eval, 2, tmp_path / "w", "run_adversarial", exp, _np(jparams), x, y,
                 str(tmp_path / "out"))
    want = jevaluate.run_adversarial(jexp, jparams, JPickleDataset(x, y, 1),
                                     out_dir=str(tmp_path / "j"))
    one = evaluate.run_adversarial(exp, _np(jparams), PickleDataset(x, y, 1),
                                   out_dir=str(tmp_path / "one"), device="cpu")
    for k in ("accuracy", "snr_db", "dice_anterior", "dice_posterior"):
        assert outs[0][k] == pytest.approx(want[k], abs=ADV_METRIC_ATOL, nan_ok=True), k
        assert outs[0][k] == pytest.approx(one[k], rel=1e-6, nan_ok=True), k


@pytest.mark.slow
def test_dp_train_step3d_matches_single_device(tmp_path):
    """``make_dp_train_step3d`` on 2 ranks against the JAX 3-D step."""
    from supernet_tpu.models import init_params3d as jinit3d
    from supernet_tpu.train3d import make_train_step3d as jstep3d

    shape = dict(image_size=16, out_size=10, base_kernels=2, depth=2)
    cfg = dataclasses.replace(configs.HIPPOCAMPUS.model, **shape)
    jcfg = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, **shape)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 16, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, 3, (4, 10, 10, 10)).astype(np.int32)
    jp = jinit3d(jax.random.PRNGKey(0), jcfg)
    outs = spawn(rank_train, 2, tmp_path, "dp", cfg, TC, _np(jp), [x], [y], 1, True)
    state, _ = jtrain.create_train_state(jax.tree.map(jnp.array, jp), JTC)
    state, m = jstep3d(jcfg, JTC)(state, jnp.asarray(x), jnp.asarray(y))
    assert_matches(outs, state, [float(m.loss)])


@pytest.mark.slow
def test_ensemble_session_and_trainer_shard_the_members(jparams, tmp_path):
    """Three members on 2 ranks: the session pads the member axis with a
    zero-weight repeat and answers as JAX's EnsembleSession; the trainer
    pads to 4 trained members and its 3 real members equal the meshless
    trainer's."""
    from supernet_tpu_torch import ensemble

    members = [jinit(jax.random.PRNGKey(k), JCFG) for k in (3, 61, 99)]
    x = np.random.default_rng(1).normal(0, 1, (3, 32, 32, 1)).astype(np.float32)
    outs = spawn(rank_session, 2, tmp_path / "s", CFG, [_np(m) for m in members], x, 2)
    want = jserving.EnsembleSession(members, JCFG, batch_size=2).predict(x)
    for o in outs:
        for got, w in zip(o, want):
            np.testing.assert_allclose(got, w, atol=1e-5)
    exp = configs.HIPPOCAMPUS.replace(
        model=CFG, train=dataclasses.replace(TC, batch_size=4, log_every=100))
    xs, ys = synthetic_dataset(CFG, 8, seed=0)
    outs = spawn(rank_ensemble_trainer, 2, tmp_path / "e", exp, 3, xs, ys,
                 str(tmp_path / "out"))
    ref = ensemble.EnsembleTrainer(exp, 3, PickleDataset(xs, ys, 1), track_curves=False,
                                   out_dir=str(tmp_path / "ref"), device="cpu")
    state = ref.run(epochs=1, log=lambda *_: None)
    assert outs[0]["n_train"] == 4
    for layer, ws in state.params.items():
        for k, v in ws.items():
            np.testing.assert_allclose(outs[0]["params"][layer][k][:3], v.detach().numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)
            np.testing.assert_array_equal(outs[0]["params"][layer][k],
                                          outs[1]["params"][layer][k])
    np.testing.assert_allclose([h["train_loss"] for h in outs[0]["histories"]],
                               [h["train_loss"] for h in ref.histories], rtol=LOSS_RTOL)


def test_session_shard_guards(jparams, mesh1):
    """The JAX session's guards on ``mesh`` and ``shard``, word for word."""
    from supernet_tpu_torch import serving

    p = _np(jparams)
    for kw, msg in ((dict(shard="rows"), "unknown shard mode 'rows'"),
                    (dict(shard="scan", mesh=True), "shard='scan' shards a volume's D axis"),
                    (dict(shard="scan", volumetric=True), "needs a mesh to shard the D axis")):
        mine = dict(kw, mesh=mesh1) if kw.get("mesh") else kw
        theirs = dict(kw, mesh=jmake_mesh(1)) if kw.get("mesh") else kw
        with pytest.raises(ValueError, match=msg):
            serving.InferenceSession(p, CFG, 2, device="cpu", **mine)
        with pytest.raises(ValueError, match=msg):
            jserving.InferenceSession(p, JCFG, 2, **theirs)
