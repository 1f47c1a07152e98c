"""The rest of the 2-D model and the epoch trainer of the port on the CPU,
against the JAX package: ``sample_weights`` / ``forward_sampled``,
``cfg.remat``, ``vunpool`` / ``crop_to_match``, the shape chains, the
profiling helpers, and ``trainer.Trainer`` (against the JAX ``Trainer`` from
the same npz and data; resume, roll-back, trailing batches)."""

import dataclasses
import os
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
import supernet_tpu.trainer as jtrainer  # noqa: E402
from supernet_tpu import models as jmodels  # noqa: E402
from supernet_tpu.checkpoint import load_params_npz as jload  # noqa: E402
from supernet_tpu.checkpoint import save_params_npz as jsave  # noqa: E402
from supernet_tpu.data import PickleDataset as JPickleDataset  # noqa: E402
from supernet_tpu.ops import moments as jmoments  # noqa: E402
from supernet_tpu_torch import checkpoint as ckpt  # noqa: E402
from supernet_tpu_torch import configs, ops, profiling, train  # noqa: E402
from supernet_tpu_torch.data import PickleDataset, synthetic_dataset  # noqa: E402
from supernet_tpu_torch.models import (  # noqa: E402
    forward,
    forward_sampled,
    init_params,
    layer_names,
    sample_weights,
)
from supernet_tpu_torch.trainer import Trainer, _prep_batch  # noqa: E402
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


def _tiny(mod, name="hippocampus", **kw):
    exp = mod.get_config(name)
    size = {"hippocampus": dict(image_size=32, out_size=22),
            "brats": dict(image_size=140, out_size=122)}[name]
    return dataclasses.replace(exp.model, base_kernels=4, **size, **kw)


CFG, JCFG = _tiny(configs), _tiny(jconfigs)
BATCH = 4
EXP = configs.HIPPOCAMPUS.replace(
    model=CFG, train=dataclasses.replace(configs.HIPPOCAMPUS.train, batch_size=BATCH,
                                         epochs=2, log_every=1000))
JEXP = jconfigs.HIPPOCAMPUS.replace(
    model=JCFG, train=dataclasses.replace(jconfigs.HIPPOCAMPUS.train, batch_size=BATCH,
                                          epochs=2, log_every=1000))


def _quiet(*_):
    pass


def _ds(n, seed=0, cls=PickleDataset):
    x, y = synthetic_dataset(CFG, n, seed=seed)
    return cls(x, y, 1)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """One parameter file that both packages start from."""
    path = str(tmp_path_factory.mktemp("params") / "init.npz")
    jsave(path, jmodels.init_params(jax.random.PRNGKey(0), JCFG))
    return path


# ------------------------------------------------------ the rest of the model


@pytest.mark.parametrize("name", ["hippocampus", "brats"])
def test_forward_sampled_matches_jax(name):
    """The deterministic twin from the same concrete kernels (BraTS: the
    asymmetric bottleneck pad and an odd-sized pool), atol 2e-5."""
    cfg, jcfg = _tiny(configs, name), _tiny(jconfigs, name)
    jparams = jmodels.init_params(jax.random.PRNGKey(1), jcfg)
    jweights = jmodels.sample_weights(jparams, jax.random.PRNGKey(2))
    weights = {k: torch.from_numpy(np.array(v)) for k, v in jweights.items()}
    x = np.random.default_rng(0).normal(
        0, 1, (2, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(np.float32)
    got = forward_sampled(weights, torch.from_numpy(x), cfg).numpy()
    want = np.asarray(jmodels.forward_sampled(jweights, jnp.asarray(x), jcfg))
    assert got.shape == want.shape == (2, cfg.out_size ** 2, cfg.n_classes)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_sample_weights_distribution():
    """w ~ N(w_mu, softplus(w_sigma)) per output channel, like the JAX
    twin's draw (the streams differ: by distribution); one generator, one
    sequence."""
    params = {"a": {"w_mu": torch.full((3, 3, 40, 2), 0.5),
                    "w_sigma": torch.tensor([-1.0, 2.0])}}
    w = sample_weights(params, torch.Generator().manual_seed(0))["a"]
    jw = np.asarray(jmodels.sample_weights(
        {"a": {k: jnp.asarray(v.numpy()) for k, v in params["a"].items()}},
        jax.random.PRNGKey(0))["a"])
    var = np.logaddexp(0.0, np.array([-1.0, 2.0]))
    for draw in (w.numpy(), jw):
        assert draw.shape == (3, 3, 40, 2)
        np.testing.assert_allclose(draw.mean((0, 1, 2)), 0.5, atol=0.2)
        np.testing.assert_allclose(draw.var((0, 1, 2)), var, rtol=0.3)
    again = sample_weights(params, torch.Generator().manual_seed(0))["a"]
    assert torch.equal(w, again) and not w.requires_grad


def test_full_model_monte_carlo():
    """The port's counterpart of tests/test_moments.py's full-model check,
    at that test's parameters (the JAX init of PRNGKey(0), moved across):
    the moments of 4000 sampled forwards against one propagated forward
    (mean tight, variance median-calibrated and correlated pixel-wise; how
    well the method's approximations hold depends on the weights, so the
    weights are the JAX test's and only the sampling stream differs)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 32, 32, 1))
                         .astype(np.float32))
    params = ckpt.params_from_jax(jmodels.init_params(jax.random.PRNGKey(0), JCFG), "cpu")
    # shift the raw sigmas up so weight variance dominates the MC noise
    params = {k: {"w_mu": v["w_mu"], "w_sigma": v["w_sigma"] + 3.0}
              for k, v in params.items()}
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        probs, sigma = forward(params, x, CFG)
        outs = torch.stack([forward_sampled(sample_weights(params, gen), x, CFG)[0]
                            for _ in range(4000)])
    emp_mean, emp_var = outs.mean(0).numpy(), outs.var(0, unbiased=False).numpy()
    p, s = probs[0].numpy(), sigma[0].numpy()
    assert np.abs(emp_mean - p).max() < 0.03
    assert np.abs(emp_mean - p).mean() < 0.01
    assert np.corrcoef(emp_var.ravel(), s.ravel())[0, 1] > 0.6
    m = emp_var.ravel() > 1e-8
    assert 0.7 < np.median(s.ravel()[m] / emp_var.ravel()[m]) < 1.4


@pytest.mark.parametrize("name", ["hippocampus", "brats"])
def test_remat_same_loss_and_gradients(name):
    """cfg.remat recomputes each block in the backward pass: the same loss
    and gradients bit for bit, the same stage taps once each, and every
    rematerialised conv's forward run a second time (the launch counters of
    a step on the card read so)."""
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    cfg = _tiny(configs, name)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, cfg.image_size, cfg.image_size,
                                           cfg.in_channels)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (2, cfg.out_size, cfg.out_size)))
    tc = configs.get_config(name).train

    def run(remat):
        c = dataclasses.replace(cfg, remat=remat)
        state, _ = train.create_train_state(params, tc, "cpu")
        taps, calls = [], []
        plain = V.vdp_conv_plain

        def counted(*a, **k):
            calls.append(1)
            return plain(*a, **k)

        V.vdp_conv_plain = counted
        try:
            probs, sigma = forward(state.params, x, c, tap=lambda n, s: taps.append((n, s)))
            loss, _ = train.loss_fn(state.params, x, y, c, tc)
            n_forward = len(calls)
            grads = torch.autograd.grad(loss, train.leaves(state.params))
        finally:
            V.vdp_conv_plain = plain
        return loss.detach(), grads, taps, n_forward, len(calls) - n_forward

    loss0, g0, taps0, fwd0, bwd0 = run(False)
    loss1, g1, taps1, fwd1, bwd1 = run(True)
    assert torch.equal(loss0, loss1) and taps0 == taps1
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    n3 = sum(1 for _, k, _, _ in layer_names(cfg) if k == 3)
    assert fwd0 == fwd1 == 2 * n3 and bwd0 == 0
    assert bwd1 == n3 - 2  # every k=3 conv but conv_input and conv1
    with torch.no_grad():  # no gradients, no checkpoint
        p, _ = forward(params, x, dataclasses.replace(cfg, remat=True))
    assert torch.equal(p, forward(params, x, cfg)[0].detach())


def test_remat_matches_jax_remat():
    """The same loss as the JAX package's rematerialised forward."""
    from supernet_tpu import train as jtrain

    cfg, jcfg = dataclasses.replace(CFG, remat=True), dataclasses.replace(JCFG, remat=True)
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (2, 22, 22)).astype(np.int32)
    state, _ = train.create_train_state(ckpt.params_from_jax(jparams, "cpu"), EXP.train, "cpu")
    loss, _ = train.loss_fn(state.params, torch.from_numpy(x), torch.from_numpy(y), cfg,
                            EXP.train)
    jloss, _ = jtrain.loss_fn(jparams, jnp.asarray(x), jnp.asarray(y), jcfg, JEXP.train)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)


def test_vunpool_and_crop_to_match_equal_jax():
    rng = np.random.default_rng(2)
    mu = rng.normal(0, 1, (2, 5, 7, 3)).astype(np.float32)
    sigma = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    got = ops.vunpool(torch.from_numpy(mu), torch.from_numpy(sigma))
    want = jmoments.vunpool(jnp.asarray(mu), jnp.asarray(sigma))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 11, 15, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # unfused unpool + 2x2 conv is the fused vunpool_conv2
    w_mu = torch.from_numpy(rng.normal(0, 0.1, (2, 2, 3, 4)).astype(np.float32))
    w_sigma = torch.from_numpy(rng.uniform(-5, -3, 4).astype(np.float32))
    fused = ops.vunpool_conv2(torch.from_numpy(mu), torch.from_numpy(sigma), w_mu, w_sigma)
    unfused = ops.vconv(*got, w_mu, w_sigma)
    for a, b in zip(fused, unfused):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    like = np.zeros((2, 3, 4, 1), np.float32)
    got = ops.crop_to_match(torch.from_numpy(mu), torch.from_numpy(like))
    want = jmoments.crop_to_match(jnp.asarray(mu), jnp.asarray(like))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


LUNGS_CHAIN = [
    ("conv_input", 126), ("conv1", 124), ("pool0", 62), ("conv2", 60), ("conv3", 58),
    ("pool1", 29), ("conv4", 27), ("conv5", 25), ("up1_conv2x2", 50), ("up1_pad", 56),
    ("up1_concat", 56), ("up1_conv1", 54), ("up1_pad2", 58), ("up1_conv2", 56),
    ("up2_conv2x2", 112), ("up2_pad", 118), ("up2_concat", 118), ("up2_conv1", 116),
    ("up2_pad2", 120), ("up2_conv2", 118), ("conv_final", 118),
]


@pytest.mark.parametrize("name", ["hippocampus", "brats", "lungs"])
def test_shape_chain_matches_jax(name):
    """Every stage's shape through the ``tap`` hook at the config's real
    image size (2 base kernels), equal to the JAX forward's; lungs is pinned
    128 -> 118 stage by stage."""
    cfg = dataclasses.replace(configs.get_config(name).model, base_kernels=2)
    jcfg = dataclasses.replace(jconfigs.get_config(name).model, base_kernels=2)
    taps, jtaps = [], []
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.zeros(1, cfg.image_size, cfg.image_size, cfg.in_channels)
    with torch.no_grad():
        probs, sigma = forward(params, x, cfg, tap=lambda n, s: taps.append((n, s)))
        sampled = forward_sampled({k: v["w_mu"] for k, v in params.items()}, x, cfg)
    jparams = jax.eval_shape(lambda k: jmodels.init_params(k, jcfg), jax.random.PRNGKey(0))
    jax.eval_shape(
        lambda p, xx: jmodels.forward(p, xx, jcfg, tap=lambda n, s: jtaps.append((n, s))),
        jparams, jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32))
    assert taps == jtaps
    assert probs.shape == sigma.shape == sampled.shape == (1, cfg.out_size ** 2, cfg.n_classes)
    if name == "lungs":
        assert [(n, s[1]) for n, s in taps] == LUNGS_CHAIN
        assert all(s[1] == s[2] for _, s in taps) and cfg.out_size == 118


def test_step_timer_and_memory_stats():
    t = profiling.StepTimer()
    assert t.rate() == 0.0 and t.total_seconds() == 0.0
    for _ in range(4):
        t.tick()
    assert t.rate() > 0 and t.total_seconds() >= 0 and len(t.times) == 4
    t.sync({"a": {"w": torch.zeros(1)}})  # a CPU leaf: nothing to wait for
    t.sync()
    stats = profiling.device_memory_stats()
    assert stats == {} or all("bytes_in_use" in v for v in stats.values())


# ------------------------------------------------------------- the trainer


def test_prep_batch_crops_labels():
    x = np.zeros((2, 32, 32, 1), np.float32)
    y = np.arange(2 * 32 * 32).reshape(2, 32, 32)
    xb, yb = _prep_batch(x, y, 22, 3)
    assert xb is x and yb.shape == (2, 22, 22)
    np.testing.assert_array_equal(yb, y[:, 5:27, 5:27])
    np.testing.assert_array_equal(yb, jtrainer._prep_batch(x, y, 22, 3)[1])


def test_trainer_matches_jax_trainer(tmp_path, npz, monkeypatch):
    """2 epochs of both packages' ``Trainer`` on the same synthetic data
    from the same npz. Per-epoch mean losses within rtol 1e-4: single steps
    are held at 1e-5 (tests/test_torch_train.py) and an epoch mean over 12
    Adam steps, each turning rounding into +-lr where a gradient is near 0,
    gets ten times that. Parameters within 2 * lr * steps. The same history
    keys and artifact names."""
    monkeypatch.setattr(jtrainer, "init_params", lambda key, cfg: jload(npz))
    x, y = synthetic_dataset(CFG, 24, seed=0)
    xv, yv = synthetic_dataset(CFG, 6, seed=1)
    jtr = jtrainer.Trainer(JEXP, JPickleDataset(x, y, 1), JPickleDataset(xv, yv, 1),
                           out_dir=str(tmp_path / "jax"))
    jstate = jtr.run(log=_quiet)
    tr = Trainer(EXP, PickleDataset(x, y, 1), PickleDataset(xv, yv, 1),
                 out_dir=str(tmp_path / "torch"), device="cpu",
                 initial_params=ckpt.load_params_npz(npz, "cpu"))
    state = tr.run(log=_quiet)

    steps = 2 * (24 // BATCH)
    assert state.step == steps == int(jstate.step)
    assert tr.history.keys() == jtr.history.keys()
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(tr.history[key], jtr.history[key], rtol=1e-4)
    for key in ("train_acc", "val_acc", "val_dice", "train_dice_anterior",
                "val_dice_anterior", "train_haus_posterior", "val_haus_anterior"):
        np.testing.assert_allclose(tr.history[key], jtr.history[key], atol=2e-2)
    for layer, ws in state.params.items():
        for name, t in ws.items():
            d = np.abs(t.detach().numpy() - np.asarray(jstate.params[layer][name])).max()
            assert d <= 2 * EXP.train.lr * steps, (layer, name, d)

    def artifacts(root):
        return {f for f in os.listdir(root) if not f.startswith("epoch_")}

    assert artifacts(tmp_path / "torch") == artifacts(tmp_path / "jax")
    assert {"history.pkl", "Related_hyperparameters.txt",
            "training_validation_acc_error.pkl"} <= artifacts(tmp_path / "torch")
    assert ckpt.latest_epoch(str(tmp_path / "torch")) == 1
    with open(tmp_path / "torch" / "history.pkl", "rb") as f:
        assert pickle.load(f) == tr.history
    txt = (tmp_path / "torch" / "Related_hyperparameters.txt").read_text()
    jtxt = (tmp_path / "jax" / "Related_hyperparameters.txt").read_text()
    assert [line.split(":")[0] for line in txt.splitlines()] == \
        [line.split(":")[0] for line in jtxt.splitlines()]


def test_trainer_resume_is_bit_exact(tmp_path):
    """3 epochs in one run equal 2 epochs, a new process's worth of state
    (``continue_training`` from ``epoch_1``) and 1 more: parameters, Adam
    moments and step counters bit for bit. The augmentation key depends on
    the restored step counter, so augmentation is on."""
    exp = EXP.replace(train=dataclasses.replace(
        EXP.train, augment=configs.AugmentConfig(rot90=True, intensity_scale=0.1)))
    ds, val = _ds(16), _ds(4, seed=1)
    full = Trainer(exp, ds, val, out_dir=str(tmp_path / "full"), device="cpu")
    want = full.run(epochs=3, log=_quiet)
    assert "train_dice_anterior" not in full.history  # off under augmentation
    assert "val_dice_anterior" in full.history

    first = Trainer(exp, ds, val, out_dir=str(tmp_path / "cut"), device="cpu")
    first.run(epochs=2, log=_quiet)
    exp_c = exp.replace(train=dataclasses.replace(exp.train, continue_training=True))
    second = Trainer(exp_c, ds, val, out_dir=str(tmp_path / "cut"), device="cpu")
    got = second.run(epochs=3, log=_quiet)
    assert second.start_epoch == 2 and len(second.history["train_loss"]) == 1
    assert second.history["train_loss"][0] == full.history["train_loss"][2]
    a, b = ckpt.snapshot_state(got), ckpt.snapshot_state(want)
    assert (a["step"], a["adam_step"]) == (b["step"], b["adam_step"]) == (12, 12.0)
    for kind in ("params", "exp_avg", "exp_avg_sq"):
        for layer, ws in a[kind].items():
            for name, t in ws.items():
                assert torch.equal(t, b[kind][layer][name]), (kind, layer, name)
    # continue_training with nothing to continue from starts at epoch 0
    fresh = Trainer(exp_c, ds, None, out_dir=str(tmp_path / "fresh"), device="cpu")
    fresh.init_state()
    assert fresh.start_epoch == 0


class _PoisonedOnce:
    """A dataset whose first batch of one epoch is NaN."""

    def __init__(self, ds, epoch):
        self.ds, self.epoch = ds, epoch

    def batches(self, batch_size, epoch=0, **kw):
        for i, (x, y) in enumerate(self.ds.batches(batch_size, epoch=epoch, **kw)):
            yield (x * np.nan if epoch == self.epoch and i == 0 else x), y


def test_trainer_rolls_back_on_nonfinite_loss(tmp_path):
    """A diverged epoch (a NaN batch) restores the last good checkpoint and
    training goes on; with no checkpoint to go back to it raises."""
    logs = []
    tr = Trainer(EXP, _PoisonedOnce(_ds(8), 1), None, out_dir=str(tmp_path / "run"),
                 device="cpu")
    state = tr.run(epochs=3, log=lambda m: logs.append(str(m)))
    assert any("rolling back to epoch 0" in m for m in logs), logs
    losses = tr.history["train_loss"]
    assert np.isfinite(losses[0]) and not np.isfinite(losses[1]) and np.isfinite(losses[2])
    assert sorted(d for d in os.listdir(tmp_path / "run") if d.startswith("epoch_")) == \
        ["epoch_0", "epoch_2"]
    assert all(bool(torch.isfinite(t).all()) for t in train.leaves(state.params))
    assert state.step == 4  # epoch 0's two steps, then epoch 2's from its state
    tr = Trainer(EXP, _PoisonedOnce(_ds(8), 0), None, out_dir=str(tmp_path / "none"),
                 device="cpu")
    with pytest.raises(FloatingPointError, match="no checkpoint to roll back to"):
        tr.run(epochs=2, log=_quiet)


@pytest.mark.parametrize("curves", [True, False])
def test_steps_per_dispatch_trains_trailing_batches(tmp_path, curves):
    """5 batches with K=2: two chunks and one trailing batch through the
    single step; the same state and curves as K=1, bit for bit."""
    ds = _ds(5 * BATCH)
    runs = {}
    for k in (1, 2):
        logs = []
        tr = Trainer(EXP, ds, None, out_dir=str(tmp_path / f"k{k}"), steps_per_dispatch=k,
                     track_curves=curves, device="cpu")
        runs[k] = (tr, tr.run(epochs=1, log=lambda m: logs.append(str(m))), logs)
    (t1, s1, _), (t2, s2, logs2) = runs[1], runs[2]
    assert s1.step == s2.step == 5
    assert any("1 trailing batch(es)" in m for m in logs2)
    for a, b in zip(train.leaves(s1.params), train.leaves(s2.params)):
        assert torch.equal(a, b)
    hist1 = {k: v for k, v in t1.history.items() if k != "images_per_sec"}
    hist2 = {k: v for k, v in t2.history.items() if k != "images_per_sec"}
    assert hist1 == hist2 and ("train_dice_anterior" in hist1) == curves
    assert t2.history["images_per_sec"][0] > 0
    assert len(t2.timings["epoch_s"]) == 1 and t2.timings["checkpoint_s"][0] >= 0


def test_trainer_options(tmp_path, mesh1):
    # a mesh (a one-rank gloo world; more ranks in test_torch_parallel.py)
    # trains through make_sharded_train_step: the meshless epoch, bit for bit
    runs = [Trainer(EXP, _ds(8), _ds(4, seed=1), out_dir=str(tmp_path / f"m{i}"),
                    mesh=mesh, device="cpu") for i, mesh in enumerate((None, mesh1))]
    states = [r.run(epochs=1, log=_quiet) for r in runs]
    for key in ("train_loss", "val_loss", "train_dice_anterior", "val_dice"):
        assert runs[0].history[key] == runs[1].history[key], key
    for a, b in zip(train.leaves(states[0].params), train.leaves(states[1].params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        Trainer(EXP, _ds(4), mesh=mesh1, steps_per_dispatch=2, device="cpu")
    # adversarial training is an option of the trainer now: an epoch of it trains
    exp = EXP.replace(train=dataclasses.replace(EXP.train, adversarial_training="pgd",
                                                adv_steps=2, adv_epsilon=0.01))
    adv = Trainer(exp, _ds(8), out_dir=str(tmp_path / "adv"), device="cpu", track_curves=False)
    state = adv.run(epochs=1, log=_quiet)
    assert state.step == 2 and np.isfinite(adv.history["train_loss"][0])
    import inspect

    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    tr = Trainer(EXP, _ds(4), device="cpu")
    assert tr.out_dir.endswith(os.path.join("hippocampus", "saved_models_SUPER_u-Net"))
    assert tr.structures == ("anterior", "posterior")


def test_trainer_with_streaming_and_shard_datasets(tmp_path):
    """The trainer's uniform ``batches()`` call (shuffle, seed, epoch) is
    taken by every dataset class."""
    from supernet_tpu_torch.data import ShardDataset, StreamingPickleDataset, write_shards

    x, y = synthetic_dataset(CFG, 8, seed=0)
    for i in range(2):
        with open(tmp_path / f"training_batch_{i}.pkl", "wb") as f:
            pickle.dump((x[4 * i:4 * i + 4].transpose(0, 3, 1, 2), y[4 * i:4 * i + 4]), f)
    write_shards(str(tmp_path / "shards"), x, y, shard_size=4)
    for ds in (StreamingPickleDataset(str(tmp_path / "training_batch_*.pkl"), 1),
               ShardDataset(str(tmp_path / "shards"), use_native=False),
               ShardDataset(str(tmp_path / "shards"))):
        tr = Trainer(EXP, ds, ds, out_dir=str(tmp_path / "run"), device="cpu")
        tr.run(epochs=1, log=_quiet)
        assert np.isfinite(tr.history["train_loss"][0]) and np.isfinite(tr.history["val_loss"][0])
