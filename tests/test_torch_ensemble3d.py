"""Volumetric deep ensembles in the port (supernet_tpu_torch/train3d.py's
ensemble steps, ensemble.EnsembleTrainer3D, the volumetric EnsembleSession,
``cli train3d --ensemble K``) on the CPU against the JAX package, at the tiny
3-D config of its tests (cube 16, 2 base kernels, depth 2), K = 2.

Tolerances: a step's per-member loss within ``LOSS_RTOL`` (1e-4, as
tests/test_torch_train3d.py) of JAX's; parameters after n steps within
2 * lr * n; the vmapped step against the port's own single-model step per
member with augmentation on (the random streams differ from JAX's)."""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu import cli as jcli  # noqa: E402
from supernet_tpu import serving as jserving  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu import train3d as jtrain3d  # noqa: E402
from supernet_tpu.configs import HIPPOCAMPUS as JHIPPO  # noqa: E402
from supernet_tpu.models import init_params3d as jinit3d  # noqa: E402
from supernet_tpu_torch import checkpoint as ckpt  # noqa: E402
from supernet_tpu_torch import cli, ensemble, serving, train, train3d  # noqa: E402
from supernet_tpu_torch.configs import HIPPOCAMPUS, AugmentConfig  # noqa: E402
from supernet_tpu_torch.data import synthetic_volumes  # noqa: E402
from supernet_tpu_torch.models import forward3d  # noqa: E402
from _torch_parallel_ranks import mesh1  # noqa: E402,F401  (a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_RTOL = 1e-4
K, BATCH, STEPS = 2, 2, 2
CFG = dataclasses.replace(HIPPOCAMPUS.model, image_size=16, out_size=10,
                          base_kernels=2, depth=2)
JCFG = dataclasses.replace(JHIPPO.model, image_size=16, out_size=10,
                           base_kernels=2, depth=2)
TC = dataclasses.replace(HIPPOCAMPUS.train, batch_size=BATCH, epochs=2, lr=1e-3)
JTC = dataclasses.replace(JHIPPO.train, batch_size=BATCH, epochs=2, lr=1e-3)
EXP = HIPPOCAMPUS.replace(model=CFG, train=TC)
SHAPE3D = ["--cube-size", "16", "--base-kernels", "2", "--depth", "2",
           "--batch-size", str(BATCH)]


def _quiet(*_):
    pass


def _np_tree(tree):
    return {layer: {name: np.array(v) for name, v in ws.items()}
            for layer, ws in tree.items()}


@pytest.fixture(scope="module")
def members():
    """K JAX-layout parameter trees that both packages start from."""
    return [_np_tree(jinit3d(jax.random.PRNGKey(k), JCFG)) for k in range(K)]


def _data(steps, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (steps, K, BATCH, 16, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, 3, (steps, K, BATCH, 10, 10, 10)).astype(np.int32)
    return x, y


def _stacked_state(members, tc):
    return train.stack_trees([train.create_train_state(p, tc, "cpu")[0] for p in members])


@pytest.mark.parametrize("mode", ["vmap", "unroll", "scan"])
def test_ensemble_train_step3d_matches_jax(members, mode):
    """STEPS steps of the port's step in each member mode against JAX's
    vmapped step: per-member loss, nll, kl (of the updated parameters) and
    accuracy, then the parameters."""
    x, y = _data(STEPS)
    jstate = jtrain.stack_trees([jtrain.create_train_state(p, JTC)[0] for p in members])
    jstep = jtrain3d.make_ensemble_train_step3d(JCFG, JTC, member_mode="vmap")
    state = _stacked_state(members, TC)
    step = train3d.make_ensemble_train_step3d(CFG, TC, member_mode=mode)
    seeds = np.arange(K, dtype=np.int32) + TC.seed
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.asarray(seeds))
        state, m = step(state, x[i], y[i], seeds)
        for got, want in zip(m, jm):
            assert got.shape == (K,)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL)
    want = jax.device_get(jstate.params)
    for layer, ws in state.params.items():
        for name, t in ws.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[layer][name]),
                                       atol=2 * TC.lr * STEPS)


def test_ensemble_eval_step3d_matches_jax(members):
    x, y = _data(1)
    params = train.stack_trees([train.create_train_state(p, TC, "cpu")[0].params
                                for p in members])
    loss, acc, pred = train3d.make_ensemble_eval_step3d(CFG, TC)(params, x[0][0], y[0][0])
    jl, ja, jp = jtrain3d.make_ensemble_eval_step3d(JCFG, JTC)(
        jtrain.stack_trees(members), jnp.asarray(x[0][0]), jnp.asarray(y[0][0]))
    assert loss.shape == acc.shape == (K,) and pred.shape == (K, BATCH, 1000)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), atol=2e-3)
    assert (pred.numpy() != np.asarray(jp)).mean() < 2e-3


def test_vmap_step3d_matches_single_steps_with_augment(members):
    """Member k of the vmapped step equals ``make_train_step3d`` with
    ``tc.seed + k`` on member k's parameters and cubes, augmentation on."""
    tc = dataclasses.replace(TC, augment=AugmentConfig(rot90=True))
    x, y = _data(STEPS, seed=3)
    state = _stacked_state(members, tc)
    step = train3d.make_ensemble_train_step3d(CFG, tc, member_mode="vmap")
    losses = []
    for i in range(STEPS):
        state, m = step(state, x[i], y[i], np.arange(K) + tc.seed)
        losses.append(m.loss.numpy())
    for k, p in enumerate(members):
        tck = dataclasses.replace(tc, seed=tc.seed + k)
        single = train.create_train_state(p, tck, "cpu")[0]
        one = train3d.make_train_step3d(CFG, tck)
        for i in range(STEPS):
            single, m = one(single, x[i][k], y[i][k])
            np.testing.assert_allclose(losses[i][k], float(m.loss), rtol=LOSS_RTOL)
        for a, b in zip(train.leaves(train.index_tree(state.params, k)),
                        train.leaves(single.params)):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       atol=2 * tc.lr * STEPS)


def test_modes_and_mesh_are_checked(tmp_path, mesh1):
    """An unknown mode is refused; on a mesh (a one-rank gloo world; more
    ranks in test_torch_parallel.py) EnsembleTrainer3D shards the member
    axis and trains what it trains without one."""
    with pytest.raises(ValueError, match="member_mode"):
        train3d.make_ensemble_train_step3d(CFG, TC, member_mode="pmap")
    vols = synthetic_volumes(CFG, 4, seed=0)
    runs = [ensemble.EnsembleTrainer3D(EXP, 2, *vols, mesh=mesh, device="cpu",
                                       out_dir=str(tmp_path / f"m{i}"))
            for i, mesh in enumerate((None, mesh1))]
    states = [r.run(epochs=1, log=_quiet) for r in runs]
    assert runs[0].histories == runs[1].histories
    for a, b in zip(train.leaves(states[0].params), train.leaves(states[1].params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="n_members >= 2"):
        ensemble.EnsembleTrainer3D(EXP, 1, *synthetic_volumes(CFG, 4, seed=0), device="cpu")


def test_volumetric_session_matches_jax_and_the_member_loop(members):
    """The member-stacked volumetric EnsembleSession against JAX's and
    against the mixture of the members' own forwards."""
    x = np.random.default_rng(4).normal(0, 1, (3, 16, 16, 16, 1)).astype(np.float32)
    sess = serving.EnsembleSession(members, CFG, batch_size=2, device="cpu", volumetric=True)
    got_p, got_s = sess.predict(x)
    want_p, want_s = jserving.EnsembleSession(members, JCFG, batch_size=2,
                                              volumetric=True).predict(x)
    np.testing.assert_allclose(got_p, np.asarray(want_p), atol=2e-5)
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=2e-7)
    with torch.no_grad():
        outs = [forward3d(train.create_train_state(p, TC, "cpu")[0].params,
                          torch.from_numpy(x), CFG) for p in members]
    loop_p, loop_s = serving.mixture([p for p, _ in outs], [s for _, s in outs])
    np.testing.assert_allclose(got_p.reshape(3, -1, 3), loop_p.numpy(), atol=1e-7)
    np.testing.assert_allclose(got_s.reshape(3, -1, 3), loop_s.numpy(), atol=1e-7)


def test_trainer3d_matches_sequential_and_resumes(tmp_path):
    """Member k of EnsembleTrainer3D against a Trainer3D seeded seed + k
    (init, permutations, curves); member_{k}/epoch_{N} checkpoints, history
    and the validation report; continue_training resumes bit for bit."""
    x, y = synthetic_volumes(CFG, 6, seed=0)
    xv, yv = synthetic_volumes(CFG, 2, seed=1)
    base = str(tmp_path / "ens")
    ens = ensemble.EnsembleTrainer3D(EXP, K, x, y, xv, yv, out_dir=base, device="cpu")
    state = ens.run(log=_quiet)
    for k in range(K):
        d = os.path.join(base, f"member_{k}")
        assert ckpt.latest_epoch(d) == 1 and os.path.isfile(os.path.join(d, "history.pkl"))
        assert len(ens.histories[k]["val_dice"]) == 2
        exp_k = EXP.replace(train=dataclasses.replace(TC, seed=TC.seed + k))
        tr = train3d.Trainer3D(exp_k, x, y, xv, yv, out_dir=str(tmp_path / f"s{k}"),
                               device="cpu")
        single = tr.run(log=_quiet)
        np.testing.assert_allclose(ens.histories[k]["train_loss"], tr.history["train_loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(ens.histories[k]["val_loss"], tr.history["val_loss"],
                                   rtol=LOSS_RTOL)
        assert sorted(os.listdir(d)) == sorted(os.listdir(tmp_path / f"s{k}"))
        for a, b in zip(train.leaves(train.index_tree(state.params, k)),
                        train.leaves(single.params)):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       atol=2 * TC.lr * 6)
    resume = EXP.replace(train=dataclasses.replace(TC, continue_training=True, epochs=3))
    ens2 = ensemble.EnsembleTrainer3D(resume, K, x, y, out_dir=base, device="cpu")
    ens2.run(log=_quiet)
    assert ens2.start_epoch == 2
    assert all(ckpt.latest_epoch(os.path.join(base, f"member_{k}")) == 2 for k in range(K))


@pytest.mark.parametrize("mode", ["vmap", "sequential"])
def test_cli_train3d_ensemble_matches_jax(tmp_path, capsys, mode):
    """``train3d --ensemble 2`` on both packages: the same JSON keys (the
    sequential line has no "mode", as in the JAX CLI), member_0/ and
    member_1/ with the same files beside the checkpoints."""
    argv = ["train3d", "--synthetic", "6", "--epochs", "1", "--ensemble", "2",
            "--ensemble-mode", mode if mode == "sequential" else "unroll", *SHAPE3D]
    jcli.main(argv + ["--out-dir", str(tmp_path / "j")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    argv[argv.index("--ensemble-mode") + 1] = mode
    assert cli.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path / "t")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) and got["members"] == want["members"] == 2
    assert ("mode" in got) == (mode != "sequential")
    assert got["checkpoint_arg"] == ",".join(got["dirs"])
    for d, jd in zip(got["dirs"], want["dirs"]):
        assert os.path.isfile(os.path.join(d, "epoch_0", "state.pt"))
        top = lambda p: sorted(f for f in os.listdir(p) if not f.startswith("epoch_"))  # noqa: E731
        assert top(d) == top(jd)
    assert [set(f) for f in got["final"]] == [set(f) for f in want["final"]]
