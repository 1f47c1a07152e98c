"""The port's volumetric evaluation (supernet_tpu_torch/evaluate3d.py), the
volumetric serving session and bundle (serving.py, tiling.predict_volume),
noise on volumes (perturb.py) and the 3-D subcommands of the CLI against the
JAX package, on the CPU, at the tiny config of its tests (cube 16, 2 base
kernels, depth 2), from one npz of parameters that both packages read.

Tolerances (those of tests/test_torch_evaluate.py): the clean forward agrees
to ``PROBS_ATOL`` per voxel, so the metrics of a clean run agree to
``METRIC_ATOL``; an adversarial run's volumes differ on a small share of
voxels (the sign of a gradient near 0), and a noisy run's draws differ
altogether (the random streams differ): those runs are held to the same
result keys, files and directories, to ``ADV_METRIC_ATOL``, and a noisy
run's SNR to ``SNR_ATOL`` dB. Noise arithmetic is held exactly on injected
draws."""

import dataclasses
import glob
import json
import math
import os
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu import cli as jcli  # noqa: E402
from supernet_tpu import evaluate3d as jev3  # noqa: E402
from supernet_tpu import perturb as jperturb  # noqa: E402
from supernet_tpu import serving as jserving  # noqa: E402
from supernet_tpu.checkpoint import load_params_npz as jload  # noqa: E402
from supernet_tpu.checkpoint import save_params_npz as jsave  # noqa: E402
from supernet_tpu.configs import HIPPOCAMPUS as JHIPPO  # noqa: E402
from supernet_tpu.configs import NoiseConfig as JNoise  # noqa: E402
from supernet_tpu.models import init_params as jinit2d  # noqa: E402
from supernet_tpu.models import init_params3d as jinit3d  # noqa: E402
from supernet_tpu_torch import cli, evaluate3d, perturb, serving  # noqa: E402
from supernet_tpu_torch.checkpoint import load_params_npz  # noqa: E402
from supernet_tpu_torch.configs import HIPPOCAMPUS, NoiseConfig  # noqa: E402
from supernet_tpu_torch.data import synthetic_volumes, write_nifti  # noqa: E402
from supernet_tpu_torch.ops.moments3d import crop_center3d  # noqa: E402
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


PROBS_ATOL = 2e-5
METRIC_ATOL = 2e-3
ADV_METRIC_ATOL = 2e-2
SNR_ATOL = 0.5
N, BATCH = 5, 2  # two full batches and a partial one
CFG = dataclasses.replace(HIPPOCAMPUS.model, image_size=16, out_size=10,
                          base_kernels=2, depth=2)
JCFG = dataclasses.replace(JHIPPO.model, image_size=16, out_size=10,
                           base_kernels=2, depth=2)
EXP = HIPPOCAMPUS.replace(model=CFG, train=dataclasses.replace(
    HIPPOCAMPUS.train, batch_size=BATCH))
JEXP = JHIPPO.replace(model=JCFG, train=dataclasses.replace(
    JHIPPO.train, batch_size=BATCH))
SHAPE3D = ["--cube-size", "16", "--base-kernels", "2", "--depth", "2",
           "--batch-size", str(BATCH)]


def _volumes(n=N, seed=0):
    """The volumes of tests/test_eval3d.py: a two-structure blob on noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.3, (n, 16, 16, 16, 1)).astype(np.float32)
    y = np.zeros((n, 16, 16, 16), np.int32)
    y[:, 5:11, 5:11, 5:11] = 1
    y[:, 7:9, 7:9, 7:9] = 2
    x[..., 0] += 0.5 * (y > 0)
    return x, y


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """One parameter file that both packages read: JAX's init."""
    path = str(tmp_path_factory.mktemp("params") / "init3d.npz")
    params = jinit3d(jax.random.PRNGKey(0), JCFG)
    jsave(path, params)
    return path


def _numbers(res):
    return {k: v for k, v in res.items()
            if isinstance(v, (int, float)) and k != "test_time_per_batch_s"}


def _assert_metrics_close(got, want, atol):
    assert set(got) == set(want)
    a, b = _numbers(got), _numbers(want)
    for k in b:
        if isinstance(b[k], float) and math.isnan(b[k]):
            assert math.isnan(a[k]), k
        elif k in ("snr_db",) and not math.isinf(b[k]):
            assert a[k] == pytest.approx(b[k], abs=SNR_ATOL), k
        elif k.startswith("hausdorff_") and atol > METRIC_ATOL:
            # one flipped voxel moves a distance by whole voxels
            assert a[k] == pytest.approx(b[k], abs=2.0), k
        else:
            assert a[k] == pytest.approx(b[k], abs=atol, rel=atol), k


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if not f.endswith(".png"))


# ------------------------------------------------------------------ noise


@pytest.mark.parametrize("kind", ["gaussian", "speckle", "salt_and_pepper"])
@pytest.mark.parametrize("region", ["A", "P", "all"])
def test_noise_on_volumes_matches_jax_on_injected_draws(kind, region):
    """The JAX package's draw injected into the port's ``apply_delta`` on
    [B, D, H, W, C] volumes: the noisy volumes and the SNR agree (the crop
    takes all three axes, the region mask is the label's)."""
    x, y = _volumes(2, seed=3)
    nc = NoiseConfig(kind=kind, std=0.5 if kind != "salt_and_pepper" else 0.2, region=region)
    jnc = JNoise(kind=kind, std=nc.std, region=region)
    key = jax.random.PRNGKey(1)
    want, wsnr = jperturb.apply_noise(key, jnp.asarray(x), jnp.asarray(y), jnc,
                                      "hippocampus", crop_size=10)
    jx = jnp.asarray(x)
    delta = {"gaussian": lambda: jperturb.gaussian_noise(key, jx, nc.std),
             "speckle": lambda: jperturb.speckle_noise(key, jx, nc.std),
             "salt_and_pepper": lambda: jperturb.salt_and_pepper(key, jx, nc.std, nc.sp_ratio),
             }[kind]()
    got, gsnr = perturb.apply_delta(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(np.array(delta)), nc,
                                    "hippocampus", crop_size=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(gsnr) == pytest.approx(float(wsnr), rel=1e-4)


def test_apply_noise_3d_crop_frame_semantics():
    """The port's draws on volumes (tests/test_eval3d.py's check): noise only
    in the region, the clip to the CROPPED clean range, the SNR on the
    cropped frames."""
    x, y = _volumes(2, seed=3)
    nc = NoiseConfig(kind="gaussian", std=5.0, region="A")
    noisy, snr = perturb.apply_noise(perturb.noise_generator(0, 0), torch.from_numpy(x),
                                     torch.from_numpy(y), nc, "hippocampus", crop_size=10)
    noisy = noisy.numpy()
    x_crop = crop_center3d(x, 10, 10, 10)
    mask = (y == 1)[..., None]
    np.testing.assert_array_equal(noisy[~mask], np.clip(x, x_crop.min(), x_crop.max())[~mask])
    assert noisy.max() <= x_crop.max() + 1e-6 and noisy.min() >= x_crop.min() - 1e-6
    n_crop = crop_center3d(noisy, 10, 10, 10)
    want = 10 * np.log10(np.sum(x_crop ** 2) / np.sum((x_crop - n_crop) ** 2))
    assert float(snr) == pytest.approx(float(want), rel=1e-4)


# ---------------------------------------------------------------- runners


def test_run_testing3d_clean_matches_jax(npz, tmp_path):
    x, y = _volumes()
    got = evaluate3d.run_testing3d(EXP, load_params_npz(npz, "cpu"), x, y,
                                   out_dir=str(tmp_path / "t"), images_n=1, device="cpu")
    want = jev3.run_testing3d(JEXP, jload(npz), x, y, out_dir=str(tmp_path / "j"),
                              images_n=1)
    _assert_metrics_close(got, want, METRIC_ATOL)
    assert got["snr_db"] == float("inf") and got["artifact_samples"] == N
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    with open(tmp_path / "t" / "uncertainty_info.pkl", "rb") as f:
        a = pickle.load(f)
    with open(tmp_path / "j" / "uncertainty_info.pkl", "rb") as f:
        b = pickle.load(f)
    assert a[0].shape == (N, 10, 10, 10, 3)
    np.testing.assert_allclose(a[0], b[0], atol=PROBS_ATOL)
    np.testing.assert_allclose(a[1], b[1], atol=PROBS_ATOL * np.abs(b[1]).max())
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3], b[3])


def test_run_testing3d_noise_and_cap(npz, tmp_path):
    """A region-masked noisy run: the JAX keys, files and directory scheme,
    its SNR near the JAX run's; ``artifact_max_samples`` caps the pickle."""
    x, y = _volumes()
    nc = NoiseConfig(kind="gaussian", std=0.3, region="A")
    got = evaluate3d.run_testing3d(EXP, load_params_npz(npz, "cpu"), x, y, nc,
                                   artifact_max_samples=2, device="cpu",
                                   images_n=0, seed=1)
    want = jev3.run_testing3d(JEXP.replace(out_dir=str(tmp_path / "j")), jload(npz), x, y,
                              JNoise(kind="gaussian", std=0.3, region="A"),
                              artifact_max_samples=2, images_n=0, seed=1)
    assert got["out_dir"].endswith(os.path.join("hippocampus_3d", "testing", "gaussian_0.3",
                                                 "on_anterior"))
    assert set(got) == set(want) and got["artifact_samples"] == 2
    assert got["snr_db"] == pytest.approx(want["snr_db"], abs=SNR_ATOL)
    # other draws: the per-structure rates of a 2-voxel-wide structure move
    # by whole voxels, the accuracy over all voxels does not
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=ADV_METRIC_ATOL)
    assert _files(got["out_dir"]) == _files(want["out_dir"])


def test_run_testing3d_mc_and_ensemble(npz, tmp_path, mesh1):
    """``mc_samples`` evaluates the Monte-Carlo baseline (finite, the same
    keys plus ``mc_samples``); an ensemble of two equal members gives the
    single member's metrics (the mixture of equal members is the member)."""
    x, y = _volumes(3)
    p = load_params_npz(npz, "cpu")
    mc = evaluate3d.run_testing3d(EXP, p, x, y, out_dir=str(tmp_path / "mc"),
                                  mc_samples=3, images_n=0, device="cpu")
    assert mc["mc_samples"] == 3 and math.isfinite(mc["mean_predictive_variance"])
    one = evaluate3d.run_testing3d(EXP, p, x, y, out_dir=str(tmp_path / "one"),
                                   images_n=0, device="cpu")
    ens = evaluate3d.run_testing3d(EXP, [p, p], x, y, out_dir=str(tmp_path / "ens"),
                                   images_n=0, device="cpu")
    for k in ("accuracy", "dice_anterior", "mean_predictive_variance"):
        assert ens[k] == pytest.approx(one[k], rel=1e-6)
    with pytest.raises(ValueError, match="single-device VDP"):
        evaluate3d.run_testing3d(EXP, [p, p], x, y, mc_samples=2, device="cpu")
    # a mesh (a one-rank gloo world) splits each volume's D axis over the
    # ranks (parallel.make_spatial_forward3d): the single-device metrics
    split = evaluate3d.run_testing3d(EXP, p, x, y, out_dir=str(tmp_path / "mesh"),
                                     images_n=0, mesh=mesh1, device="cpu")
    for k in ("accuracy", "dice_anterior", "mean_predictive_variance"):
        assert split[k] == pytest.approx(one[k], rel=1e-6)
    with pytest.raises(ValueError, match="single-device; drop mesh"):
        evaluate3d.run_testing3d(EXP, p, x, y, mesh=mesh1, mc_samples=2, device="cpu")


def test_run_adversarial3d_matches_jax(npz, tmp_path):
    """Targeted PGD (hippocampus' default): the JAX keys, files and metrics
    within ADV_METRIC_ATOL; every adversarial volume inside the epsilon-ball
    and the batch's range."""
    x, y = _volumes()
    exp = EXP.replace(attack=dataclasses.replace(EXP.attack, max_adv_step=3, epsilon=0.05,
                                                 step_size=0.02))
    jexp = JEXP.replace(attack=dataclasses.replace(JEXP.attack, max_adv_step=3,
                                                   epsilon=0.05, step_size=0.02))
    got = evaluate3d.run_adversarial3d(exp, load_params_npz(npz, "cpu"), x, y,
                                       out_dir=str(tmp_path / "t"), images_n=1, device="cpu")
    want = jev3.run_adversarial3d(jexp, jload(npz), x, y, out_dir=str(tmp_path / "j"),
                                  images_n=1)
    _assert_metrics_close(got, want, ADV_METRIC_ATOL)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    with open(tmp_path / "t" / "uncertainty_info.pkl", "rb") as f:
        adv = pickle.load(f)[2]
    for i in range(0, N, BATCH):
        xb, ab = x[i:i + BATCH], adv[i:i + BATCH]
        assert np.all(np.abs(ab - xb) <= 0.05 + 1e-6)
        assert ab.min() >= xb.min() - 1e-6 and ab.max() <= xb.max() + 1e-6
    with pytest.raises(ValueError, match="ONE member"):
        evaluate3d.run_adversarial3d(exp, [jload(npz)] * 2, x, y, device="cpu")


def test_run_calibration3d_matches_jax(npz, tmp_path):
    x, y = _volumes()
    got = evaluate3d.run_calibration3d(EXP, load_params_npz(npz, "cpu"), x, y,
                                       out_dir=str(tmp_path / "t"), device="cpu")
    want = jev3.run_calibration3d(JEXP, jload(npz), x, y, out_dir=str(tmp_path / "j"))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float) and not math.isnan(v):
            assert got[k] == pytest.approx(v, rel=METRIC_ATOL, abs=METRIC_ATOL), k
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


def test_run_noise_sweep3d_matches_jax(npz, tmp_path):
    """Clean + levels x regions (7 runs at the hippocampus config); the
    clean run within METRIC_ATOL."""
    x, y = _volumes(2)
    got = evaluate3d.run_noise_sweep3d(EXP.replace(out_dir=str(tmp_path / "t")),
                                       load_params_npz(npz, "cpu"), x, y, images_n=0,
                                       device="cpu")
    want = jev3.run_noise_sweep3d(JEXP.replace(out_dir=str(tmp_path / "j")), jload(npz),
                                  x, y, images_n=0)
    assert len(got) == len(want) == 7
    _assert_metrics_close(got[0], want[0], METRIC_ATOL)
    assert [os.path.relpath(r["out_dir"], tmp_path / "t") for r in got] == [
        os.path.relpath(r["out_dir"], tmp_path / "j") for r in want]


# ---------------------------------------------------------------- serving


def test_volumetric_session_and_predict_volume_match_jax(npz):
    """``InferenceSession(volumetric=True)``: a padded request of 3 cubes at
    batch 2, and ``predict_volume`` on a non-cube volume that needs two
    tiles along D, against the JAX session."""
    p = load_params_npz(npz, "cpu")
    sess = serving.InferenceSession(p, CFG, batch_size=2, device="cpu", volumetric=True)
    jsess = jserving.InferenceSession(jload(npz), JCFG, batch_size=2, volumetric=True)
    x, _ = _volumes(3, seed=5)
    got, want = sess.predict(x), jsess.predict(x)
    assert got[0].shape == (3, 10, 10, 10, 3)
    np.testing.assert_allclose(got[0], want[0], atol=PROBS_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=PROBS_ATOL * np.abs(want[1]).max())
    vol = np.random.default_rng(6).normal(0, 1, (23, 12, 14)).astype(np.float32)
    gp, gs = sess.predict_volume(vol, overlap=2)
    jp, js = jsess.predict_volume(vol, overlap=2)
    assert gp.shape == (23, 12, 14, 3)
    np.testing.assert_allclose(gp, jp, atol=PROBS_ATOL)
    np.testing.assert_allclose(gs, js, atol=PROBS_ATOL * np.abs(js).max())
    with pytest.raises(ValueError, match="predict_volume"):
        sess.predict_image(vol[0])
    with pytest.raises(ValueError, match="volumetric=True"):
        serving.InferenceSession(p, CFG, device="cpu").predict_volume(vol)
    empty = sess.predict(np.zeros((0, 16, 16, 16, 1), np.float32))
    assert empty[0].shape == (0, 10, 10, 10, 3)


def test_volumetric_ensemble_session_and_export(npz, tmp_path):
    """The volumetric ``EnsembleSession`` is the mixture of its members;
    ``export_bundle(volumetric=True)`` writes the JAX meta's keys and values
    and a ``model.pt2`` that answers as the session does."""
    p = load_params_npz(npz, "cpu")
    q = {k: {n: t * 0.9 for n, t in ws.items()} for k, ws in p.items()}
    x, _ = _volumes(2, seed=7)
    ens = serving.EnsembleSession([p, q], CFG, batch_size=2, device="cpu", volumetric=True)
    members = [serving.InferenceSession(m, CFG, batch_size=2, device="cpu",
                                        volumetric=True).predict(x) for m in (p, q)]
    mp, ms = serving.mixture([torch.from_numpy(a) for a, _ in members],
                             [torch.from_numpy(b) for _, b in members])
    ep, es = ens.predict(x)
    np.testing.assert_allclose(ep, mp.numpy(), atol=1e-6)
    np.testing.assert_allclose(es, ms.numpy(), rtol=1e-5, atol=1e-12)

    meta = serving.export_bundle(p, CFG, str(tmp_path / "t"), batch_size=2,
                                 config_name="hippocampus", volumetric=True)
    jmeta = jserving.export_bundle(jload(npz), JCFG, str(tmp_path / "j"), batch_size=2,
                                   config_name="hippocampus", volumetric=True)
    for k, v in jmeta.items():
        if k != "files":
            assert meta[k] == v, k
    assert meta["files"] == ["model.pt2", "params.npz"]
    program = torch.export.load(str(tmp_path / "t" / "model.pt2")).module()
    with torch.no_grad():
        pp, sp = program(torch.from_numpy(x))
    sess = serving.InferenceSession(p, CFG, batch_size=2, device="cpu", volumetric=True)
    sp_ref = sess.predict(x)
    np.testing.assert_allclose(pp.numpy(), sp_ref[0], atol=1e-7)
    np.testing.assert_allclose(sp.numpy(), sp_ref[1], rtol=1e-6, atol=1e-12)


# -------------------------------------------------------------------- cli


def _run(main, argv, capsys):
    assert main(argv) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()
            if ln.startswith("{")]


def test_cli_train3d_matches_jax(tmp_path, capsys):
    """``train3d --synthetic`` on both packages: the same JSON keys, finite
    values, the port's ``epoch_{N}/state.pt`` where the JAX package writes
    its ``epoch_{N}``; ``--init-from-2d`` inflates a 2-D npz of the same
    config; ``--continue-training`` adds one epoch."""
    argv = ["train3d", "--synthetic", "6", "--epochs", "1", *SHAPE3D]
    got = _run(cli.main, argv + ["--device", "cpu", "--out-dir", str(tmp_path / "t")],
               capsys)[-1]
    want = _run(jcli.main, argv + ["--out-dir", str(tmp_path / "j")], capsys)[-1]
    assert set(got) == set(want) and all(math.isfinite(v) for v in got.values())
    assert os.path.isfile(tmp_path / "t" / "epoch_0" / "state.pt")
    assert os.path.isdir(tmp_path / "j" / "epoch_0")
    top = lambda p: sorted(f for f in os.listdir(p) if not f.startswith("epoch_"))  # noqa: E731
    assert top(tmp_path / "t") == top(tmp_path / "j")
    again = _run(cli.main, ["train3d", "--synthetic", "6", "--epochs", "2", *SHAPE3D,
                            "--continue-training", "--device", "cpu",
                            "--out-dir", str(tmp_path / "t")], capsys)[-1]
    assert os.path.isfile(tmp_path / "t" / "epoch_1" / "state.pt") and set(again) == set(got)

    npz2d = str(tmp_path / "p2d.npz")
    jsave(npz2d, jinit2d(jax.random.PRNGKey(1), JCFG))
    inflated = _run(cli.main, argv + ["--device", "cpu", "--out-dir", str(tmp_path / "i"),
                                      "--init-from-2d", npz2d], capsys)[-1]
    assert set(inflated) == set(got)


@pytest.mark.parametrize("cmd,extra,atol", [
    ("eval3d", ["--images-n", "1"], METRIC_ATOL),
    ("eval3d", ["--sweep", "--images-n", "0"], METRIC_ATOL),
    ("attack3d", ["--max-adv-step", "2", "--epsilon", "0.05", "--step-size", "0.02",
                  "--images-n", "1"], ADV_METRIC_ATOL),
    ("calibrate3d", [], METRIC_ATOL),
    ("saliency3d", ["--images-n", "3"], 0.0),
], ids=["eval3d", "eval3d_sweep", "attack3d", "calibrate3d", "saliency3d"])
def test_cli_evaluation_commands_match_jax(cmd, extra, atol, npz, tmp_path, capsys):
    """Each 3-D evaluation subcommand on both packages from the same npz:
    the same JSON lines (the clean numbers within the stated tolerance) and
    the same files (PNGs aside)."""
    argv = [cmd, "--synthetic", "3", "--checkpoint", npz, *SHAPE3D, *extra]
    got = _run(cli.main, argv + ["--device", "cpu", "--out-dir", str(tmp_path / "t")], capsys)
    want = _run(jcli.main, argv + ["--out-dir", str(tmp_path / "j")], capsys)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        g = {k: v for k, v in g.items() if k != "out_dir"}
        w = {k: v for k, v in w.items() if k != "out_dir"}
        if cmd == "saliency3d":
            assert g == w
        elif "snr_db" in w and not math.isinf(w["snr_db"]) and cmd == "eval3d":
            assert set(g) == set(w)  # a noisy sweep run: other draws
        else:
            _assert_metrics_close(g, w, atol)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_cli_eval3d_ensemble_and_rejections(npz, tmp_path, capsys, mesh1):
    """A comma-separated --checkpoint is an ensemble for eval3d (equal
    members: the member's numbers) and refused by attack3d; unported modes
    name their ROADMAP.md item; Keras .h5 stays 2-D only."""
    base = ["--synthetic", "3", *SHAPE3D, "--device", "cpu"]
    one = _run(cli.main, ["eval3d", "--checkpoint", npz, *base,
                          "--out-dir", str(tmp_path / "a")], capsys)[0]
    two = _run(cli.main, ["eval3d", "--checkpoint", f"{npz},{npz}", *base,
                          "--out-dir", str(tmp_path / "b")], capsys)[0]
    assert two["accuracy"] == pytest.approx(one["accuracy"], rel=1e-6)
    with pytest.raises(SystemExit, match="ONE checkpoint"):
        cli.main(["attack3d", "--checkpoint", f"{npz},{npz}", *base])
    with pytest.raises(SystemExit, match="2-D-only"):
        cli.main(["eval3d", "--checkpoint", "w.h5", *base])
    # the sharding flags (ROADMAP's 'Parallelism', ported) in a one-rank
    # gloo world: each prints what the command prints without its flag
    vol = str(tmp_path / "v.npy")
    np.save(vol, np.random.default_rng(3).normal(0, 1, (18, 16, 16)).astype(np.float32))
    train = ["train3d", "--epochs", "1", "--val-frac", "0.4"]
    for i, (argv, flag) in enumerate((
            (train, ["--spatial-shard"]),
            (train, ["--hybrid-shard", "1"]),
            (train, ["--data-parallel"]),
            (train + ["--ensemble", "2", "--ensemble-mode", "sequential"],
             ["--spatial-shard"]),
            (["eval3d", "--checkpoint", npz], ["--data-parallel"]),
            (["predict3d", "--volume", vol, "--checkpoint", npz], ["--data-parallel"]))):
        want, got = (_run(cli.main, argv + f + base + ["--out-dir", str(tmp_path / f"{i}{j}")],
                          capsys) for j, f in enumerate(([], flag)))
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k, v in w.items():
                if isinstance(v, float) and "per_sec" not in k and "time" not in k:
                    assert g[k] == pytest.approx(v, rel=1e-5, abs=1e-7, nan_ok=True), (argv, k)
    with pytest.raises(SystemExit, match="must divide the device count"):
        cli.main(train + ["--hybrid-shard", "2"] + base)


def test_cli_predict3d_matches_jax(npz, tmp_path, capsys):
    """``predict3d`` on a non-cube .npy volume and a directory holding it
    and a NIfTI volume: the same JSON lines and output arrays."""
    vol = np.random.default_rng(8).normal(0, 1, (23, 12, 14)).astype(np.float32)
    src = tmp_path / "vols"
    src.mkdir()
    np.save(src / "a.npy", vol)
    write_nifti(str(src / "b.nii.gz"), vol[:, :, :12])
    for volume in (str(src / "a.npy"), str(src)):
        argv = ["predict3d", "--volume", volume, "--checkpoint", npz, *SHAPE3D,
                "--overlap", "2", "--save-probs"]
        tag = os.path.basename(volume)
        got = _run(cli.main, argv + ["--device", "cpu", "--out-dir", str(tmp_path / "t" / tag)],
                   capsys)
        want = _run(jcli.main, argv + ["--out-dir", str(tmp_path / "j" / tag)], capsys)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in ("input", "volume", "cube", "out_cube", "overlap", "blend"):
                assert g[k] == w[k], k
            assert g["mean_uncertainty"] == pytest.approx(w["mean_uncertainty"], rel=1e-3)
            assert sum(abs(a - b) for a, b in zip(g["class_voxels"], w["class_voxels"])) <= 4
            np.testing.assert_allclose(np.load(g["probs"]), np.load(w["probs"]),
                                       atol=PROBS_ATOL)
        assert sorted(os.listdir(tmp_path / "t" / tag)) == sorted(
            os.listdir(tmp_path / "j" / tag))


def test_cli_convert_to_cubes_then_train3d(tmp_path, capsys):
    """``convert --from-nifti --to-cubes`` of a task directory written here
    gives the JAX package's shards, bit for bit, and ``train3d --data`` trains
    from them (tests/test_eval3d.py:437's round trip)."""
    task = tmp_path / "task"
    (task / "imagesTr").mkdir(parents=True)
    (task / "labelsTr").mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        img = rng.normal(0, 1, (18, 15, 17)).astype(np.float32)
        lbl = np.zeros((18, 15, 17), np.int16)
        lbl[6:12, 5:10, 6:12] = 1 + (i % 2)
        write_nifti(str(task / "imagesTr" / f"v{i}.nii.gz"), img)
        write_nifti(str(task / "labelsTr" / f"v{i}.nii.gz"), lbl)
    argv = ["convert", "--from-nifti", "--to-cubes", "--data", str(task),
            "--cube-size", "16", "--shard-size", "2"]
    got = _run(cli.main, argv + ["--out", str(tmp_path / "t")], capsys)[0]
    want = _run(jcli.main, argv + ["--out", str(tmp_path / "j")], capsys)[0]
    assert {k: v for k, v in got.items() if k != "out"} == {
        k: v for k, v in want.items() if k != "out"} == {"shards": 2, "volumes": 3,
                                                         "cube": 16}
    for f in sorted(os.listdir(tmp_path / "j")):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f), np.load(tmp_path / "j" / f))
    res = _run(cli.main, ["train3d", "--data", str(tmp_path / "t"), "--epochs", "1",
                          "--val-frac", "0", *SHAPE3D, "--device", "cpu",
                          "--out-dir", str(tmp_path / "run")], capsys)[-1]
    assert math.isfinite(res["train_loss"])
    assert glob.glob(str(tmp_path / "run" / "epoch_0" / "state.pt"))
    with pytest.raises(SystemExit, match="--cube-size 16"):
        cli.main(["train3d", "--data", str(tmp_path / "t"), "--cube-size", "20",
                  "--depth", "2", "--device", "cpu"])


def test_cli_export_volumetric_matches_jax(npz, tmp_path, capsys):
    argv = ["export", "--volumetric", "--checkpoint", npz, *SHAPE3D,
            "--export-batch-size", "2"]
    got = _run(cli.main, argv + ["--device", "cpu", "--out-dir", str(tmp_path / "t")],
               capsys)[0]
    want = _run(jcli.main, argv + ["--out-dir", str(tmp_path / "j")], capsys)[0]
    for k, v in want.items():
        if k != "files":
            assert got[k] == v, k
    assert sorted(os.listdir(tmp_path / "t")) == ["export_meta.json", "model.pt2",
                                                  "params.npz"]
    with pytest.raises(SystemExit, match="ONE checkpoint"):
        cli.main(argv + ["--checkpoint", f"{npz},{npz}", "--device", "cpu"])


def test_3d_entry_points_default_to_the_card(npz):
    """Every 3-D entry point defaults to ``device="cuda"`` and nothing falls
    back to the CPU: on a host without a card each raises."""
    from supernet_tpu_torch.models import init_params3d
    from supernet_tpu_torch.train3d import Trainer3D

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    x, y = _volumes(2)
    p = load_params_npz(npz, "cpu")
    calls = [
        lambda: init_params3d(torch.Generator().manual_seed(0), CFG),
        lambda: Trainer3D(EXP, x, y).run(epochs=1, log=lambda *_: None),
        lambda: evaluate3d.run_testing3d(EXP, p, x, y),
        lambda: evaluate3d.run_calibration3d(EXP, p, x, y),
        lambda: serving.InferenceSession(p, CFG, volumetric=True),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()


def test_mc_forward3d_matches_jax_for_its_draws(npz, monkeypatch):
    """``_forward3d_fn(mc_samples=N)``: the JAX MC forward's own weight draws
    (``split(fold_in(PRNGKey(seed), batch), N)``) fed to the port's in place
    of its draws give the same empirical mean and (population) variance."""
    from supernet_tpu.models import sample_weights as jsample
    from supernet_tpu_torch import evaluate

    n, (x, _) = 4, _volumes(2, seed=9)
    jparams = jload(npz)
    jp, jv = jev3._forward3d_fn(JCFG, mc_samples=n, mc_seed=3)(jparams, jnp.asarray(x))
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0), n)
    draws = [{k: torch.from_numpy(np.array(v)) for k, v in jax.jit(jsample)(jparams, key).items()}
             for key in keys]
    monkeypatch.setattr(evaluate, "sample_weights", lambda params, gen: draws.pop(0))
    p, v = evaluate3d._forward3d_fn(CFG, mc_samples=n, mc_seed=3)(
        load_params_npz(npz, "cpu"), torch.from_numpy(x))
    assert not draws
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=2e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                               atol=2e-5 * float(np.asarray(jv).max()) + 1e-7)
