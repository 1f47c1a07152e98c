"""The port's uncertainty-quality analysis (``supernet_tpu_torch/calibration.py``)
on the CPU: the cases of ``tests/test_calibration.py`` on the port's copy,
every function equal to ``supernet_tpu.calibration`` on the same arrays
(host numpy in float64 in both: ``RTOL``), and ``run_calibration`` against
the JAX runner from the same npz (the forwards agree to 1e-5 per pixel:
``RUN_ATOL`` on the report's scalars).
"""

import dataclasses
import math
import os
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import calibration as jcal  # noqa: E402
from supernet_tpu.data import PickleDataset as JPickleDataset  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import calibration as cal  # noqa: E402
from supernet_tpu_torch import configs  # noqa: E402
from supernet_tpu_torch.data import PickleDataset, synthetic_dataset  # noqa: E402
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


RTOL = 1e-12
RUN_ATOL = 2e-3


def _model_outputs(seed, n=24, h=10, c=3):
    """Predictions wrong on a per-image share of pixels, and a sigma that is
    high exactly there."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, (n, h, h))
    pred = labels.copy()
    wrong = rng.uniform(size=(n, h, h)) < rng.uniform(0.05, 0.4, (n, 1, 1))
    pred[wrong] = (labels[wrong] + 1) % c
    probs = np.full((n, h, h, c), 0.05)
    np.put_along_axis(probs, pred[..., None], 0.9, axis=-1)
    sigma = np.full((n, h, h, c), 0.01)
    sigma[wrong] = 1.0
    return rng, labels, probs, sigma


def test_sparsification_perfect_ranking_has_zero_ause():
    rng = np.random.default_rng(0)
    errors = (rng.uniform(size=4000) < 0.3).astype(np.float64)
    np.testing.assert_allclose(cal.ause(errors, errors.copy()), 0.0, atol=1e-12)


def test_sparsification_anticorrelated_worse_than_random():
    rng = np.random.default_rng(1)
    errors = (rng.uniform(size=4000) < 0.3).astype(np.float64)
    bad = 1.0 - errors  # removes CORRECT pixels first
    flat = np.zeros_like(errors)  # uninformative (stable sort keeps order)
    assert cal.ause(errors, bad) > cal.ause(errors, flat) > 0.0
    for unc in (bad, flat, rng.uniform(size=4000)):
        np.testing.assert_allclose(cal.ause(errors, unc), jcal.ause(errors, unc), rtol=RTOL)


def test_sparsification_curve_monotone_for_perfect():
    errors = np.array([0, 0, 0, 0, 1, 1], np.float64)
    fracs, curve, oracle = cal.sparsification_curve(errors, errors.copy(), 7)
    np.testing.assert_allclose(curve, oracle)
    assert curve[0] == pytest.approx(2 / 6)
    assert curve[-1] == 0.0  # the two errors removed first
    for got, want in zip((fracs, curve, oracle),
                         jcal.sparsification_curve(errors, errors.copy(), 7)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="equal, non-empty"):
        cal.sparsification_curve(errors, errors[:3])


def test_trapezoid_of_this_numpy():
    """``np.trapezoid`` from numpy 2.0 on, ``np.trapz`` before: the copy
    takes whichever this numpy has."""
    assert cal._trapezoid in (getattr(np, "trapezoid", None), getattr(np, "trapz", None))
    assert cal._trapezoid(np.array([0.0, 1.0, 1.0]), np.array([0.0, 1.0, 3.0])) == 2.5


def test_ece_perfectly_calibrated_is_small():
    rng = np.random.default_rng(2)
    conf = rng.uniform(0.5, 1.0, 200_000)
    correct = (rng.uniform(size=conf.size) < conf).astype(np.float64)
    ece, rel = cal.expected_calibration_error(conf, correct, n_bins=10)
    assert ece < 0.01
    nz = rel["counts"] > 0
    np.testing.assert_allclose(rel["accuracy"][nz], rel["confidence"][nz], atol=0.02)
    jece, jrel = jcal.expected_calibration_error(conf, correct, n_bins=10)
    assert ece == pytest.approx(jece, rel=RTOL)
    for k in jrel:
        np.testing.assert_allclose(rel[k], jrel[k], rtol=RTOL)


def test_ece_overconfident_known_value():
    n = 10_000
    conf = np.full(n, 0.9)
    correct = np.zeros(n)
    correct[: int(0.6 * n)] = 1.0
    ece, _ = cal.expected_calibration_error(conf, correct, n_bins=10)
    assert ece == pytest.approx(0.3, abs=1e-9)


def test_analyze_prefers_informative_uncertainty():
    rng, labels, probs, sig_good = _model_outputs(3)
    good = cal.analyze(probs, sig_good, labels, "hippocampus")
    shuffled = sig_good.reshape(-1, 3)[rng.permutation(len(labels) * 100)].reshape(
        sig_good.shape)
    rand = cal.analyze(probs, shuffled, labels, "hippocampus")
    assert good["ause"] < rand["ause"]
    assert good["corr_pearson"] > 0.9
    assert good["mean_uncertainty_incorrect"] > good["mean_uncertainty_correct"]
    assert "corr_pearson_anterior" in good
    assert np.isfinite(good["mean_uncertainty_anterior"])


@pytest.mark.parametrize("dataset,c", [("hippocampus", 3), ("brats", 5), ("lungs", 2)])
def test_analyze_equals_jax_module(dataset, c):
    """Every key of the report, scalar or array, on the same arrays."""
    _, labels, probs, sigma = _model_outputs(4, n=12, h=8, c=c)
    probs = probs / probs.sum(-1, keepdims=True)
    got = cal.analyze(probs.astype(np.float32), sigma.astype(np.float32), labels, dataset,
                      n_bins=12, n_points=15)
    want = jcal.analyze(probs.astype(np.float32), sigma.astype(np.float32), labels, dataset,
                        n_bins=12, n_points=15)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            for kk in w:
                np.testing.assert_allclose(got[k][kk], w[kk], rtol=RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k)


def test_fit_variance_scale_recovers_known_misscale():
    rng = np.random.default_rng(0)
    n, h, w, c = 8, 12, 12, 3
    labels = rng.integers(0, c, (n, h, w))
    y = np.eye(c)[labels]
    true_sigma = 0.04
    probs = y + rng.normal(0, np.sqrt(true_sigma), y.shape)
    sigma = np.full(y.shape, true_sigma / 4.0)
    s = cal.fit_variance_scale(labels, probs, sigma)
    assert 3.0 < s < 5.0
    assert s == pytest.approx(jcal.fit_variance_scale(labels, probs, sigma), rel=RTOL)
    before = cal.gaussian_nll(labels, probs, sigma)
    after = cal.gaussian_nll(labels, probs, sigma * s)
    assert after < before
    assert before == pytest.approx(jcal.gaussian_nll(labels, probs, sigma), rel=RTOL)


def test_fit_temperature_recovers_overconfidence():
    rng = np.random.default_rng(1)
    n, c = 20000, 4
    z = rng.normal(0, 1.5, (n, c))

    def softmax(a):
        e = np.exp(a - a.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    p_true = softmax(z)
    labels = np.array([rng.choice(c, p=p) for p in p_true])
    probs = softmax(2.0 * z)  # over-confident model output
    t = cal.fit_temperature(labels, probs)
    assert 1.5 < t < 2.6
    assert t == pytest.approx(jcal.fit_temperature(labels, probs), rel=RTOL)
    correct = (np.argmax(probs, -1) == labels).astype(np.float64)
    ece_before, _ = cal.expected_calibration_error(probs.max(-1), correct)
    ece_after, _ = cal.expected_calibration_error(
        cal.apply_temperature(probs, t).max(-1), correct)
    assert ece_after < ece_before
    np.testing.assert_allclose(cal.apply_temperature(probs, t),
                               jcal.apply_temperature(probs, t), rtol=RTOL)


def test_analyze_reports_posthoc_fits():
    rng = np.random.default_rng(2)
    n, h, w, c = 4, 10, 10, 3
    labels = rng.integers(0, c, (n, h, w))
    probs = rng.dirichlet(np.ones(c), (n, h, w))
    sigma = np.abs(rng.normal(0.01, 0.005, (n, h, w, c)))
    res = cal.analyze(probs, sigma, labels, "hippocampus")
    assert res["fitted_variance_scale"] > 0
    assert res["fitted_temperature"] > 0
    assert res["gaussian_nll_rescaled"] <= res["gaussian_nll"] + 1e-9
    assert np.isfinite(res["ece_after_temperature"])


def _exps():
    def tiny(mod):
        exp = mod.HIPPOCAMPUS
        return exp.replace(
            model=dataclasses.replace(exp.model, image_size=32, out_size=22, base_kernels=4),
            train=dataclasses.replace(exp.train, batch_size=4))
    return tiny(configs), tiny(jconfigs)


def test_run_calibration_matches_jax(tmp_path):
    """Tiny model, 10 synthetic images (a partial last batch) through both
    runners from the same parameters: the scalars of the report, the
    artifact set, the pickle's arrays."""
    exp, jexp = _exps()
    x, y = synthetic_dataset(exp.model, 10, seed=0)
    jparams = jinit(jax.random.PRNGKey(0), jexp.model)
    out = str(tmp_path / "cal")
    res = cal.run_calibration(exp, jparams, PickleDataset(x, y, 1), out_dir=out, device="cpu")
    want = jcal.run_calibration(jexp, jparams, JPickleDataset(x, y, 1),
                                out_dir=str(tmp_path / "jcal"))
    assert set(res) == set(want) and res["out_dir"] == out
    for k, w in want.items():
        if isinstance(w, float):
            assert isinstance(res[k], float), k
            if math.isnan(w):
                assert math.isnan(res[k]), k
            else:
                assert res[k] == pytest.approx(w, abs=RUN_ATOL, rel=RUN_ATOL), k
    for k in ("ause", "ece", "pixel_error_rate", "fitted_temperature"):
        assert np.isfinite(res[k])
    have = set(os.listdir(out))
    assert {"calibration.pkl", "Calibration_report.txt"} <= have
    assert have == set(os.listdir(tmp_path / "jcal"))
    with open(os.path.join(out, "calibration.pkl"), "rb") as f:
        blob = pickle.load(f)
    assert len(blob["sparsification_curve"]) == 20
    with open(os.path.join(out, "Calibration_report.txt")) as f, \
            open(tmp_path / "jcal" / "Calibration_report.txt") as jf:
        lines, jlines = f.read().splitlines(), jf.read().splitlines()
    assert lines[:2] == jlines[:2] == ["Uncertainty quality report — hippocampus", "samples: 10"]
    assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in jlines]


def test_run_calibration_modes(tmp_path, mesh1):
    """MC mode, an ensemble, no out_dir, and the modes that are refused."""
    exp, jexp = _exps()
    x, y = synthetic_dataset(exp.model, 6, seed=0)
    ds = PickleDataset(x, y, 1)
    members = [jinit(jax.random.PRNGKey(k), jexp.model) for k in range(2)]
    res = cal.run_calibration(exp, members[0], ds, mc_samples=4, device="cpu")
    assert res["mc_samples"] == 4 and np.isfinite(res["ause"]) and "out_dir" not in res
    ens = cal.run_calibration(exp, members, ds, out_dir=str(tmp_path / "ens"), device="cpu")
    jens = jcal.run_calibration(jexp, members, JPickleDataset(x, y, 1))
    assert ens["ece"] == pytest.approx(jens["ece"], abs=RUN_ATOL)
    assert ens["mean_uncertainty"] == pytest.approx(jens["mean_uncertainty"], rel=RUN_ATOL)
    with pytest.raises(ValueError, match="single-device VDP only"):
        cal.run_calibration(exp, members, ds, mc_samples=2, device="cpu")
    # a mesh (a one-rank gloo world; more ranks in test_torch_parallel.py)
    # shards each batch and gathers it: the single-device report
    one = cal.run_calibration(exp, members[0], ds, out_dir=str(tmp_path / "one"),
                              device="cpu")
    sharded = cal.run_calibration(exp, members[0], ds, out_dir=str(tmp_path / "mesh"),
                                  mesh=mesh1, device="cpu")
    for k, v in one.items():
        if isinstance(v, float):
            assert sharded[k] == pytest.approx(v, rel=1e-6, abs=1e-9, nan_ok=True), k
