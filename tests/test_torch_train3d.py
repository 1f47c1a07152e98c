"""The port's volumetric training (supernet_tpu_torch/train3d.py) and volume
augmentation (data/augment.py:augment_volumes) against the JAX package, on
the CPU, at the tiny config of its tests (cube 16, 2 base kernels, depth 2).

Tolerances: a step's loss within ``LOSS_RTOL`` (1e-4) of the JAX step's;
parameters after n steps within 2 * lr * n (Adam moves a weight by at most
about lr per step, and a gradient near 0 may take either sign in two
float32 orders); an epoch's mean loss within ``EPOCH_RTOL``; validation
accuracy and Dice within ``METRIC_ATOL`` (a few argmax flips). The random
streams differ, so augmentation is held by its invariants and by the
distribution of its draws."""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu import train3d as jtrain3d  # noqa: E402
from supernet_tpu.configs import HIPPOCAMPUS as JHIPPO  # noqa: E402
from supernet_tpu.models import init_params3d as jinit3d  # noqa: E402
from supernet_tpu_torch import checkpoint as ckpt  # noqa: E402
from supernet_tpu_torch import train3d  # noqa: E402
from supernet_tpu_torch.configs import HIPPOCAMPUS, AugmentConfig  # noqa: E402
from supernet_tpu_torch.data import augment_volumes, synthetic_volumes  # noqa: E402
from supernet_tpu_torch.data.augment import _mix, volume_draws  # noqa: E402
from supernet_tpu_torch.train import create_train_state, leaves  # noqa: E402


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
EPOCH_RTOL = 1e-4
METRIC_ATOL = 2e-3
CFG = dataclasses.replace(HIPPOCAMPUS.model, image_size=16, out_size=10,
                          base_kernels=2, depth=2)
JCFG = dataclasses.replace(JHIPPO.model, image_size=16, out_size=10,
                           base_kernels=2, depth=2)
TC = dataclasses.replace(HIPPOCAMPUS.train, batch_size=2, epochs=2, lr=1e-3)
JTC = dataclasses.replace(JHIPPO.train, batch_size=2, epochs=2, lr=1e-3)
EXP = HIPPOCAMPUS.replace(model=CFG, train=TC)
JEXP = JHIPPO.replace(model=JCFG, train=JTC)


def _np_tree(tree):
    return {layer: {name: np.array(v) for name, v in ws.items()}
            for layer, ws in tree.items()}


@pytest.fixture(scope="module")
def jparams():
    return _np_tree(jinit3d(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def volumes():
    return synthetic_volumes(CFG, 10, seed=0)


def _cropped(y):
    return train3d._crop_center_vol(y, CFG.out_size)


def _params_close(state, jparams_now, n_steps, lr):
    for layer, ws in state.params.items():
        for name, t in ws.items():
            d = np.abs(t.detach().numpy() - np.asarray(jparams_now[layer][name])).max()
            assert d <= 2 * lr * n_steps, (layer, name, d)


def test_three_train_steps_match_jax(jparams, volumes):
    x, y = volumes
    yc = _cropped(y)
    jstate, _ = jtrain.create_train_state(jax.tree_util.tree_map(jnp.asarray, jparams), JTC)
    jstep = jtrain3d.make_train_step3d(JCFG, JTC)
    state, _ = create_train_state(jparams, TC, "cpu")
    step = train3d.make_train_step3d(CFG, TC)
    for i in range(3):
        xb, yb = x[2 * i:2 * i + 2], yc[2 * i:2 * i + 2]
        jstate, jm = jstep(jstate, jnp.asarray(xb), jnp.asarray(yb))
        state, m = step(state, xb, yb)
        assert float(m.loss) == pytest.approx(float(jm.loss), rel=LOSS_RTOL)
        assert float(m.nll) == pytest.approx(float(jm.nll), rel=LOSS_RTOL)
        assert float(m.kl) == pytest.approx(float(jm.kl), rel=1e-5)
        assert float(m.accuracy) == pytest.approx(float(jm.accuracy), abs=METRIC_ATOL)
    assert state.step == int(jstate.step) == 3
    _params_close(state, jstate.params, 3, TC.lr)


def test_multi_step_equals_single_steps(jparams, volumes):
    """``make_multi_train_step3d`` is a loop over the single step: the same
    losses and parameters, bit for bit."""
    x, y = volumes
    yc = _cropped(y)
    a, _ = create_train_state(jparams, TC, "cpu")
    b, _ = create_train_state(jparams, TC, "cpu")
    single = train3d.make_train_step3d(CFG, TC)
    multi = train3d.make_multi_train_step3d(CFG, TC, 2)
    ms = [single(a, x[i:i + 2], yc[i:i + 2])[1] for i in (0, 2)]
    b, mm = multi(b, np.stack([x[0:2], x[2:4]]), np.stack([yc[0:2], yc[2:4]]))
    assert mm.loss.shape == (2,)
    assert [float(m.loss) for m in ms] == mm.loss.tolist()
    for p, q in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(p, q)


def _adam(jstate):
    return jstate.opt_state[1][0]


def test_state_carried_across_packages(jparams, volumes):
    """A JAX Trainer3D-style state after 2 steps goes to the port
    (``checkpoint.state_from_jax``), both take a step with the same loss;
    the port's state goes back (``state_to_jax``) and the JAX step from it
    agrees with the port's next one."""
    x, y = volumes
    yc = _cropped(y)
    jstate, _ = jtrain.create_train_state(jax.tree_util.tree_map(jnp.asarray, jparams), JTC)
    jstep = jtrain3d.make_train_step3d(JCFG, JTC)
    for i in (0, 2):
        jstate, _ = jstep(jstate, jnp.asarray(x[i:i + 2]), jnp.asarray(yc[i:i + 2]))
    adam = _adam(jstate)
    state = ckpt.state_from_jax(_np_tree(jstate.params), _np_tree(adam.mu),
                                _np_tree(adam.nu), int(adam.count), TC, "cpu")
    step = train3d.make_train_step3d(CFG, TC)
    jstate, jm = jstep(jstate, jnp.asarray(x[4:6]), jnp.asarray(yc[4:6]))
    state, m = step(state, x[4:6], yc[4:6])
    assert float(m.loss) == pytest.approx(float(jm.loss), rel=LOSS_RTOL)
    params, mu, nu, count = ckpt.state_to_jax(state)
    as_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    new_adam = _adam(jstate)._replace(count=jnp.int32(count), mu=as_jnp(mu), nu=as_jnp(nu))
    opt_state = (jstate.opt_state[0], (new_adam,) + tuple(jstate.opt_state[1][1:]))
    jback = jtrain.TrainState(as_jnp(params), opt_state, jnp.int32(count))
    jback, jm = jstep(jback, jnp.asarray(x[6:8]), jnp.asarray(yc[6:8]))
    state, m = step(state, x[6:8], yc[6:8])
    assert float(m.loss) == pytest.approx(float(jm.loss), rel=LOSS_RTOL)
    assert int(jback.step) == state.step == 4


def _quiet(*_):
    pass


def test_trainer3d_matches_jax_trainer3d(jparams, volumes, tmp_path):
    """Two epochs of both trainers on the same volumes from the same
    parameters (the permutation is numpy's in both): every history entry
    within the tolerances, the same checkpoints and report files."""
    x, y = volumes
    tr = train3d.Trainer3D(EXP, x[:8], y[:8], x[8:], y[8:],
                           out_dir=str(tmp_path / "t"), initial_params=jparams,
                           device="cpu")
    tr.run(log=_quiet)
    jtr = jtrain3d.Trainer3D(JEXP, x[:8], y[:8], x[8:], y[8:],
                             out_dir=str(tmp_path / "j"),
                             initial_params=jax.tree_util.tree_map(jnp.asarray, jparams))
    jtr.run(log=_quiet)
    assert set(tr.history) == set(jtr.history)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(tr.history[key], jtr.history[key], rtol=EPOCH_RTOL)
    for key in ("train_acc", "val_acc", "val_dice"):
        np.testing.assert_allclose(tr.history[key], jtr.history[key], atol=METRIC_ATOL)
    for d in ("epoch_0", "epoch_1"):
        assert os.path.isfile(tmp_path / "t" / d / "state.pt")
        assert os.path.isdir(tmp_path / "j" / d)
    top = lambda p: sorted(f for f in os.listdir(p) if not f.startswith("epoch_"))  # noqa: E731
    assert top(tmp_path / "t") == top(tmp_path / "j")
    assert "uncertainty_info.pkl" in top(tmp_path / "t")


def test_trainer3d_steps_per_dispatch_is_the_same_run(jparams, volumes, tmp_path):
    """K = 3 steps per call with a trailing batch (4 batches per epoch):
    the same history as K = 1, bit for bit."""
    x, y = volumes
    runs = []
    for k in (1, 3):
        tr = train3d.Trainer3D(EXP, x[:8], y[:8], out_dir=str(tmp_path / f"k{k}"),
                               initial_params=jparams, steps_per_dispatch=k,
                               device="cpu")
        tr.run(epochs=1, log=_quiet)
        runs.append(tr.history)
    assert runs[0]["train_loss"] == runs[1]["train_loss"]


def test_trainer3d_continue_training(jparams, volumes, tmp_path):
    """``continue_training`` resumes at the latest epoch_{N}: the restored
    state is the saved one, bit for bit, and exactly one epoch is added."""
    x, y = volumes
    out = str(tmp_path / "run")
    exp1 = EXP.replace(train=dataclasses.replace(TC, epochs=1))
    first = train3d.Trainer3D(exp1, x[:4], y[:4], out_dir=out, initial_params=jparams,
                              device="cpu")
    s1 = first.run(log=_quiet)
    assert ckpt.latest_epoch(out) == 0
    exp2 = EXP.replace(train=dataclasses.replace(TC, continue_training=True))
    second = train3d.Trainer3D(exp2, x[:4], y[:4], out_dir=out, device="cpu")
    restored = second.init_state()
    assert second.start_epoch == 1 and restored.step == s1.step
    for p, q in zip(leaves(restored.params), leaves(s1.params)):
        assert torch.equal(p, q)
    second.run(epochs=2, log=_quiet)
    assert ckpt.latest_epoch(out) == 1
    assert len(second.history["train_loss"]) == 1


def test_trainer3d_rolls_back_on_nonfinite_loss(jparams, tmp_path):
    """A diverged epoch restores the last good checkpoint and training goes
    on (the JAX trainer's contract): epochs 0 and 2 are checkpointed, the
    poisoned epoch 1 is not."""
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (4, 16, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, 3, (4, 16, 16, 16)).astype(np.int32)
    exp = EXP.replace(train=dataclasses.replace(TC, epochs=3))
    out = str(tmp_path / "run")
    tr = train3d.Trainer3D(exp, x, y, out_dir=out, initial_params=jparams, device="cpu")
    orig = tr.step_fn
    calls = {"n": 0}

    def flaky(state, xb, yb):
        state, m = orig(state, xb, yb)
        calls["n"] += 1
        if 3 <= calls["n"] <= 4:  # both steps of epoch 1
            m = m._replace(loss=torch.tensor(float("nan")))
        return state, m

    tr.step_fn = flaky
    logs = []
    tr.run(log=logs.append)
    assert any("rolling back to epoch 0" in str(m) for m in logs), logs
    assert ckpt.latest_epoch(out) == 2
    assert not os.path.isdir(os.path.join(out, "epoch_1"))
    with pytest.raises(FloatingPointError):
        bad = train3d.Trainer3D(exp, x, y, out_dir=str(tmp_path / "bad"),
                                initial_params=jparams, device="cpu")
        orig2 = bad.step_fn
        bad.step_fn = lambda s, a, b: (lambda r: (r[0], r[1]._replace(
            loss=torch.tensor(float("nan")))))(orig2(s, a, b))
        bad.run(log=_quiet)


def test_trainer3d_checks_and_unported_modes(volumes):
    x, y = volumes
    with pytest.raises(ValueError, match="batch_size"):
        train3d.Trainer3D(EXP, x[:1], y[:1], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*'Parallelism'"):
        train3d.Trainer3D(EXP, x, y, mesh=object(), shard="scan", device="cpu")
    # the ensemble steps are ported: a mesh names Parallelism, a mode
    # nobody knows is a ValueError
    with pytest.raises(NotImplementedError, match="ROADMAP.*'Parallelism'"):
        train3d.make_ensemble_train_step3d(CFG, TC, mesh=object())
    with pytest.raises(ValueError, match="member_mode"):
        train3d.make_ensemble_train_step3d(CFG, TC, member_mode="pmap")
    assert callable(train3d.make_ensemble_eval_step3d(CFG, TC))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "ROADMAP.md")) as f:
        text = f.read()
    assert "**Parallelism**" in text and "**Ensembles**" in text


# --------------------------------------------------------------- augment


def _vols(n=6, s=8, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (n, s, s, s, 2)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (n, s, s, s)).astype(np.int32))
    return x, y


def test_augment_volumes_commutes_with_the_center_crop():
    """Every spatial draw (axial quarter turns, D/H/W flips) commutes with
    the symmetric center crop: augmenting the full image and the cropped
    label keeps them aligned (the JAX contract, augment.py:197-199)."""
    x, y = _vols()
    cfg = AugmentConfig(rot90=True)
    labels_full = torch.arange(8 ** 3, dtype=torch.int32).reshape(1, 8, 8, 8).repeat(6, 1, 1, 1)
    _, y_full = augment_volumes(7, x, labels_full, cfg)
    _, y_crop = augment_volumes(7, x, labels_full[:, 2:6, 2:6, 2:6].contiguous(), cfg)
    assert torch.equal(y_full[:, 2:6, 2:6, 2:6], y_crop)


def test_augment_volumes_draws_are_per_volume():
    """A volume's draws depend on its global index, not on the batch it
    arrives in: two halves with ``index_offset`` equal the whole batch."""
    x, y = _vols()
    cfg = AugmentConfig(rot90=True, intensity_scale=0.2, intensity_shift=0.1)
    xa, ya = augment_volumes(3, x, y, cfg)
    x1, y1 = augment_volumes(3, x[:3], y[:3], cfg)
    x2, y2 = augment_volumes(3, x[3:], y[3:], cfg, index_offset=3)
    assert torch.equal(torch.cat([y1, y2]), ya)
    assert torch.equal(torch.cat([x1, x2]), xa)
    # the identity config leaves everything alone
    none = AugmentConfig(hflip=False, vflip=False, dflip=False)
    xi, yi = augment_volumes(3, x, y, none)
    assert torch.equal(xi, x) and torch.equal(yi, y)


def test_augment_volumes_draw_distribution():
    """Four uniform draws in {0..3} per volume (the JAX module's
    ``randint(k, (4,), 0, 4)``): each flip fires with p = 1/2, the axial
    rotation count is uniform; the rotation stays in the H-W plane (the D
    profile of a volume is kept up to the D flip)."""
    bits, u = volume_draws(11, 4000)
    assert bits.shape == (4000, 4) and u.shape == (4000, 2)
    for col in range(4):
        counts = np.bincount(bits[:, col].numpy(), minlength=4) / 4000
        assert np.all(np.abs(counts - 0.25) < 0.03), (col, counts)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    x, y = _vols(n=8)
    cfg = AugmentConfig(rot90=True, dflip=False)
    xa, _ = augment_volumes(5, x, y, cfg)
    # without the D flip, each D slice keeps its own values (a turn or flip
    # of the H-W plane only permutes a slice in place)
    for i in range(8):
        for d in range(8):
            assert torch.equal(xa[i, d].flatten().sort().values, x[i, d].flatten().sort().values)


def test_train_step3d_augments_on_the_device(jparams, volumes):
    """With ``tc.augment`` the step trains on ``augment_volumes`` keyed by
    the seed and the step counter: the same loss as a plain step on the
    batch augmented by hand."""
    x, y = volumes
    yc = _cropped(y)
    aug = AugmentConfig(rot90=True, intensity_scale=0.1)
    tc = dataclasses.replace(TC, augment=aug)
    a, _ = create_train_state(jparams, tc, "cpu")
    b, _ = create_train_state(jparams, TC, "cpu")
    _, m = train3d.make_train_step3d(CFG, tc)(a, x[:2], yc[:2])
    xa, ya = augment_volumes(_mix(tc.seed, 0), torch.from_numpy(x[:2]),
                             torch.from_numpy(yc[:2]), aug)
    _, m2 = train3d.make_train_step3d(CFG, TC)(b, xa, ya)
    assert float(m.loss) == float(m2.loss)
