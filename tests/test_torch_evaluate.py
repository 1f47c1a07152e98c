"""The port's evaluation runners (``supernet_tpu_torch/evaluate.py``) on the
CPU against ``supernet_tpu.evaluate``: the same npz parameters and the same
tiny synthetic test set through ``run_testing``, ``run_adversarial`` and
``run_noise_sweep`` of both packages.

Tolerances. The clean forward agrees to ``PROBS_ATOL`` per pixel, so the
metrics of a clean run agree to ``METRIC_ATOL`` (one argmax flip among the
4840 pixels of the set moves the accuracy by 2e-4). An adversarial run's
images differ between the packages on a small share of pixels (the sign of
a gradient near 0, see ``tests/test_torch_attacks.py``), and a noisy run's
draws differ altogether: those runs are held to the same result keys, the
same files and directory names, and to ``ADV_METRIC_ATOL`` or the noise's
expected SNR.
"""

import dataclasses
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import evaluate as jevaluate  # noqa: E402
from supernet_tpu.checkpoint import load_params_npz as jload  # noqa: E402
from supernet_tpu.checkpoint import save_params_npz as jsave  # noqa: E402
from supernet_tpu.data import PickleDataset as JPickleDataset  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import configs, evaluate, reports  # noqa: E402
from supernet_tpu_torch.checkpoint import load_params_npz  # noqa: E402
from supernet_tpu_torch.data import PickleDataset, synthetic_dataset  # noqa: E402
from supernet_tpu_torch.models import forward  # noqa: E402
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


PROBS_ATOL = 1e-5
METRIC_ATOL = 2e-3
ADV_METRIC_ATOL = 2e-2
N, BATCH = 10, 4  # two full batches and a partial one


def _exp(mod, name="hippocampus", **attack):
    base = mod.get_config(name)
    exp = base.replace(
        model=dataclasses.replace(base.model, image_size=32, out_size=22, base_kernels=4),
        train=dataclasses.replace(base.train, batch_size=BATCH))
    return exp.replace(attack=dataclasses.replace(exp.attack, **attack)) if attack else exp


EXP, JEXP = _exp(configs), _exp(jconfigs)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """One parameter file that both packages read."""
    path = str(tmp_path_factory.mktemp("params") / "init.npz")
    jsave(path, jinit(jax.random.PRNGKey(0), JEXP.model))
    return path


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(EXP.model, N, seed=1)


def _both_ds(data):
    x, y = data
    return PickleDataset(x, y, 1), JPickleDataset(x, y, 1)


def _numbers(res):
    return {k: v for k, v in res.items()
            if isinstance(v, (int, float)) and k != "test_time_per_batch_s"}


def _assert_metrics_close(got, want, atol):
    assert set(got) == set(want)
    a, b = _numbers(got), _numbers(want)
    for k in b:
        if isinstance(b[k], float) and math.isnan(b[k]):
            assert math.isnan(a[k]), k
        else:
            assert a[k] == pytest.approx(b[k], abs=atol, rel=atol), k


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if not f.endswith(".png"))


def test_run_testing_matches_jax(npz, data, tmp_path):
    """Clean run: result keys, metrics, files, and the artifact's arrays."""
    ds, jds = _both_ds(data)
    got = evaluate.run_testing(EXP, load_params_npz(npz, "cpu"), ds,
                               out_dir=str(tmp_path / "t"), device="cpu")
    want = jevaluate.run_testing(JEXP, jload(npz), jds, out_dir=str(tmp_path / "j"))
    _assert_metrics_close(got, want, METRIC_ATOL)
    assert got["snr_db"] == float("inf") and got["artifact_samples"] == N
    assert got["test_time_per_batch_s"] > 0
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == [
        "Predictive_variance_tasks.txt", "Related_hyperparameters.txt", "uncertainty_info.pkl"]
    a, b = (reports.load_uncertainty_artifact(r["artifact"]) for r in (got, want))
    assert a[0].shape == (N, 22, 22, 3) and a[2].shape == (N, 22, 22, 1)
    np.testing.assert_allclose(a[0], b[0], atol=PROBS_ATOL)
    np.testing.assert_allclose(a[1], b[1], atol=PROBS_ATOL * np.abs(b[1]).max())
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3], b[3])
    assert a[4] == got["accuracy"]


def test_run_testing_takes_numpy_params_and_caps_the_artifact(npz, data, tmp_path):
    """JAX-layout numpy parameters go in as they are; ``artifact_max_samples``
    caps the pickle's rows (at least one) and nothing else."""
    ds, _ = _both_ds(data)
    np_params = {k: {n: np.asarray(v) for n, v in ws.items()} for k, ws in jload(npz).items()}
    full = evaluate.run_testing(EXP, np_params, ds, out_dir=str(tmp_path / "a"), device="cpu")
    capped = evaluate.run_testing(EXP, np_params, ds, out_dir=str(tmp_path / "b"),
                                  artifact_max_samples=3, device="cpu")
    assert capped["artifact_samples"] == 3 and full["artifact_samples"] == N
    assert len(reports.load_uncertainty_artifact(capped["artifact"])[0]) == 3
    for k in ("accuracy", "dice_anterior", "mean_predictive_variance"):
        assert capped[k] == full[k]
    one = evaluate.run_testing(EXP, np_params, ds, out_dir=str(tmp_path / "c"),
                               artifact_max_samples=0, device="cpu")
    assert one["artifact_samples"] == 1


@pytest.mark.parametrize("kind,std,region,sub,artifact", [
    ("gaussian", 0.05, "A", "gaussian_0.05/on_anterior",
     "uncertainty_info_on_anterior_noise_0.05.pkl"),
    ("gaussian", 0.1, "all", "gaussian_0.1/on_all", "uncertainty_info_noise_0.1.pkl"),
    ("speckle", 0.1, "P", "speckle_0.1/on_posterior",
     "uncertainty_info_on_posterior_noise_0.1.pkl"),
])
def test_noisy_run_matches_jax_in_keys_files_and_snr(npz, data, tmp_path, kind, std, region,
                                                     sub, artifact):
    """The draws differ between the packages; the directory scheme, the
    artifact's name, the result keys and (to 1 dB: 10 images of noise) the
    SNR do not. The same seed gives the same run, another seed another."""
    ds, jds = _both_ds(data)
    nc = configs.NoiseConfig(kind=kind, std=std, region=region)
    jnc = jconfigs.NoiseConfig(kind=kind, std=std, region=region)
    exp = EXP.replace(out_dir=str(tmp_path / "t"))
    jexp = JEXP.replace(out_dir=str(tmp_path / "j"))
    got = evaluate.run_testing(exp, load_params_npz(npz, "cpu"), ds, nc, device="cpu")
    want = jevaluate.run_testing(jexp, jload(npz), jds, jnc)
    assert set(got) == set(want)
    for res, root in ((got, tmp_path / "t"), (want, tmp_path / "j")):
        assert res["out_dir"] == os.path.join(str(root), "hippocampus", "testing", sub)
        assert os.path.basename(res["artifact"]) == artifact
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert math.isfinite(got["snr_db"]) and abs(got["snr_db"] - want["snr_db"]) < 1.0
    again = evaluate.run_testing(exp, load_params_npz(npz, "cpu"), ds, nc, device="cpu")
    other = evaluate.run_testing(exp, load_params_npz(npz, "cpu"), ds, nc, seed=1, device="cpu")
    assert again["snr_db"] == got["snr_db"] and other["snr_db"] != got["snr_db"]
    assert _numbers(again) == _numbers(got)


@pytest.mark.parametrize("name,attack,pgd", [
    ("hippocampus", dict(epsilon=0.01, max_adv_step=3), True),  # targeted, adv_class 3
    ("hippocampus", dict(epsilon=0.01, max_adv_step=2, targeted=False), True),
    ("lungs", dict(epsilon=0.02), False),  # untargeted, not hippocampus: one FGSM step
])
def test_run_adversarial_matches_jax(tmp_path, name, attack, pgd, monkeypatch):
    """The default targeted Hippocampus attack relabels to class 3 of 3 and
    runs without an assert. PGD when targeted or Hippocampus, else FGSM.
    Keys, files and metrics against the JAX runner."""
    exp, jexp = _exp(configs, name, **attack), _exp(jconfigs, name, **attack)
    assert (exp.attack.targeted or name == "hippocampus") == pgd
    jparams = jinit(jax.random.PRNGKey(0), jexp.model)
    x, y = synthetic_dataset(exp.model, N, seed=1)
    made = []
    for kind in ("pgd", "fgsm"):
        orig = getattr(evaluate, f"make_{kind}_attack")
        monkeypatch.setattr(evaluate, f"make_{kind}_attack",
                            lambda *a, _o=orig, _k=kind, **kw: (made.append(_k), _o(*a, **kw))[1])
    got = evaluate.run_adversarial(exp, jparams, PickleDataset(x, y, 1),
                                   out_dir=str(tmp_path / "t"), device="cpu")
    assert made == ["pgd" if pgd else "fgsm"]
    want = jevaluate.run_adversarial(jexp, jparams, JPickleDataset(x, y, 1),
                                     out_dir=str(tmp_path / "j"))
    _assert_metrics_close(got, want, ADV_METRIC_ATOL)
    assert math.isfinite(got["snr_db"]) and abs(got["snr_db"] - want["snr_db"]) < 0.1
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == [
        "Predictive_variance_tasks.txt", "Related_hyperparameters_adversarial.txt",
        "uncertainty_info.pkl"]
    adv = reports.load_uncertainty_artifact(got["artifact"])[2]
    x_crop = x[:, 5:27, 5:27]
    assert adv.shape == x_crop.shape
    assert np.abs(adv - x_crop).max() <= np.float32(exp.attack.epsilon) + 1e-7
    assert np.abs(adv - x_crop).max() > 0


def test_run_adversarial_default_output_directory(npz, data, tmp_path):
    exp = _exp(configs, max_adv_step=1).replace(out_dir=str(tmp_path))
    ds, _ = _both_ds(data)
    res = evaluate.run_adversarial(exp, load_params_npz(npz, "cpu"), ds, device="cpu")
    assert res["out_dir"] == os.path.join(str(tmp_path), "hippocampus", "adversarial",
                                          "targeted_eps0.0001")
    assert "predictive_variance_" in " ".join(res)
    with pytest.raises(ValueError, match="ONE member"):
        evaluate.run_adversarial(exp, [load_params_npz(npz, "cpu")] * 2, ds, device="cpu")


def test_run_noise_sweep(npz, data, tmp_path):
    """Clean, then every level x region, each in its own directory."""
    exp = EXP.replace(out_dir=str(tmp_path), noise_levels=(0.05,), noise_regions=("A", "all"))
    ds, _ = _both_ds(data)
    results = evaluate.run_noise_sweep(exp, load_params_npz(npz, "cpu"), ds,
                                       artifact_max_samples=2, device="cpu")
    base = os.path.join(str(tmp_path), "hippocampus", "testing")
    assert [os.path.relpath(r["out_dir"], base) for r in results] == [
        "clean", "gaussian_0.05/on_anterior", "gaussian_0.05/on_all"]
    assert results[0]["snr_db"] == float("inf")
    assert all(math.isfinite(r["snr_db"]) for r in results[1:])
    # noise on one structure alone leaves more of the signal than noise everywhere
    assert results[1]["snr_db"] > results[2]["snr_db"]
    assert all(r["artifact_samples"] == 2 and os.path.isfile(r["artifact"]) for r in results)


def test_mc_mode(npz, data, tmp_path):
    """``mc_samples > 0``: N sampled forwards per batch, the empirical mean
    and variance in the VDP's shapes; deterministic per seed; close to the
    JAX package's MC run (other draws, the same distribution)."""
    ds, jds = _both_ds(data)
    params = load_params_npz(npz, "cpu")
    res = evaluate.run_testing(EXP, params, ds, out_dir=str(tmp_path / "mc"), mc_samples=8,
                               device="cpu")
    assert res["mc_samples"] == 8 and os.path.exists(res["artifact"])
    assert math.isfinite(res["accuracy"]) and math.isfinite(res["mean_predictive_variance"])
    assert res["mean_predictive_variance"] > 0
    again = evaluate.run_testing(EXP, params, ds, out_dir=str(tmp_path / "mc2"), mc_samples=8,
                                 device="cpu")
    assert _numbers(again) == _numbers(res)
    other = evaluate.run_testing(EXP, params, ds, out_dir=str(tmp_path / "mc3"), mc_samples=8,
                                 seed=1, device="cpu")
    assert other["mean_predictive_variance"] != res["mean_predictive_variance"]
    want = jevaluate.run_testing(JEXP, jload(npz), jds, out_dir=str(tmp_path / "j"), mc_samples=8)
    assert set(res) == set(want)

    fwd = evaluate.make_eval_forward(EXP.model, None, 4, 0, forward, evaluate.forward_sampled)
    x = torch.from_numpy(data[0][:2])
    p1, v1 = fwd(params, x)
    p2, _ = fwd(params, x)  # the run's second batch: other draws
    assert p1.shape == v1.shape == (2, 22 * 22, 3) and float(v1.min()) >= 0
    assert not torch.equal(p1, p2) and not p1.requires_grad
    np.testing.assert_allclose(p1.sum(-1).numpy(), 1.0, atol=1e-5)


def test_mc_moments_match_jax_for_its_draws(npz, data, monkeypatch):
    """The JAX MC forward's own weight draws (recovered from its key:
    ``split(fold_in(PRNGKey(seed), batch), N)``) fed to the port's MC
    forward in place of its draws: the same empirical mean and (population)
    variance."""
    from supernet_tpu.models import sample_weights as jsample

    n, x = 5, data[0][:3]
    jparams = jload(npz)
    jp, jv = jevaluate._forward_fn(JEXP.model, mc_samples=n, mc_seed=3)(jparams, jnp.asarray(x))
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0), n)
    # under jit, as in the JAX forward, a dict is walked in sorted key order
    draws = [{k: torch.from_numpy(np.array(v)) for k, v in jax.jit(jsample)(jparams, key).items()}
             for key in keys]
    monkeypatch.setattr(evaluate, "sample_weights", lambda params, gen: draws.pop(0))
    fwd = evaluate._forward_fn(EXP.model, mc_samples=n, mc_seed=3)
    p, v = fwd(load_params_npz(npz, "cpu"), torch.from_numpy(x))
    assert not draws
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=2e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2e-5 * float(np.asarray(jv).max())
                               + 1e-7)


def test_ensemble_mixture_matches_jax(data):
    """Uniform-mixture moments over three members against
    ``supernet_tpu.evaluate.ensemble_forward`` on the same members."""
    members = [jinit(jax.random.PRNGKey(k), JEXP.model) for k in range(3)]
    x = data[0][:3]
    jfwd, stacked = jevaluate.ensemble_forward(
        jax.jit(lambda p, xx: jforward(p, xx, JEXP.model)), members)
    want_p, want_s = jfwd(stacked, jnp.asarray(x))
    fwd, params = evaluate.eval_forward_and_params(EXP.model, members, "cpu")
    got_p, got_s = fwd(params, torch.from_numpy(x))
    assert not got_p.requires_grad
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=PROBS_ATOL)
    # (s + p^2) - mean^2 in float32 cancels: the error is a few roundings
    # of p^2 <= 1 (1.2e-7 each) whatever the variance's own size
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=2e-7)
    assert float(got_s.min()) >= 0
    # one member: the member's own moments
    one, p1 = evaluate.eval_forward_and_params(EXP.model, members[:1], "cpu")
    solo = forward(p1[0], torch.from_numpy(x), EXP.model)
    for a, b in zip(one(p1, torch.from_numpy(x)), solo):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=2e-7)
    with pytest.raises(ValueError, match="at least one member"):
        evaluate.ensemble_forward(fwd, [])


def test_ensemble_run_testing_and_rejected_modes(npz, data, tmp_path):
    ds, jds = _both_ds(data)
    members = [jinit(jax.random.PRNGKey(k), JEXP.model) for k in range(2)]
    got = evaluate.run_testing(EXP, members, ds, out_dir=str(tmp_path / "t"), device="cpu")
    want = jevaluate.run_testing(JEXP, members, jds, out_dir=str(tmp_path / "j"))
    _assert_metrics_close(got, want, METRIC_ATOL)
    with pytest.raises(ValueError, match="single-device VDP only"):
        evaluate.run_testing(EXP, members, ds, mc_samples=2, device="cpu")


@pytest.mark.parametrize("runner", ["run_testing", "run_adversarial", "run_noise_sweep"])
def test_a_mesh_names_its_roadmap_item(npz, data, runner, mesh1, tmp_path):
    """With a mesh (a one-rank gloo world here; two ranks and the uneven
    tail in test_torch_parallel.py) every forward and attack runs each
    rank's rows and gathers them: the single-device report, the partial
    final batch included. (Named for the stub it replaced, which raised
    naming ROADMAP's 'Parallelism'.)"""
    ds, _ = _both_ds(data)
    exp = _exp(configs, max_adv_step=2)
    run = getattr(evaluate, runner)
    p = load_params_npz(npz, "cpu")
    got = run(exp.replace(out_dir=str(tmp_path / "mesh")), p, ds, mesh=mesh1, device="cpu")
    want = run(exp.replace(out_dir=str(tmp_path / "one")), p, ds, device="cpu")
    for g, w in zip(*((r if isinstance(r, list) else [r]) for r in (got, want))):
        g = {k: v for k, v in g.items() if k not in ("out_dir", "artifact")}
        w = {k: v for k, v in w.items() if k not in ("out_dir", "artifact")}
        _assert_metrics_close(g, w, 1e-6)


def test_runners_default_to_the_card():
    import inspect

    from supernet_tpu_torch import calibration

    for fn in (evaluate.run_testing, evaluate.run_adversarial, evaluate.run_noise_sweep,
               calibration.run_calibration):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
