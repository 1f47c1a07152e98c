"""The port's command line (``supernet_tpu_torch/cli.py``) on the CPU: the
parser holds every subcommand and flag of the JAX package's; ``train``,
``convert``, ``eval``, ``sweep``, ``attack``, ``calibrate``, ``saliency`` and
``study`` run (at the tiny test size, through ``--device cpu``) and print the
JSON keys their twins print; every subcommand of the JAX CLI is ported
(``bench`` in ``tests/test_torch_bench.py``)."""

import argparse
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import supernet_tpu.configs.configs as jconfigs_mod  # noqa: E402
from supernet_tpu import cli as jcli  # noqa: E402
from supernet_tpu.data import nifti as jnifti  # noqa: E402
from supernet_tpu_torch import checkpoint as ckpt  # noqa: E402
from supernet_tpu_torch import cli, configs  # noqa: E402
from supernet_tpu_torch.data import ShardDataset, synthetic_dataset  # noqa: E402
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = configs.HIPPOCAMPUS.replace(
    model=dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                              base_kernels=4),
    train=dataclasses.replace(configs.HIPPOCAMPUS.train, batch_size=10))


@pytest.fixture
def tiny(monkeypatch):
    """``--config hippocampus`` at the tiny test size (32x32, 4 base
    kernels, batch 10)."""
    monkeypatch.setitem(configs._CONFIGS, "hippocampus", TINY)
    return TINY


def _subparsers(parser):
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(sub):
    """{option string: (type, default, choices, nargs, required)}."""
    return {opt: (a.type, a.default, None if a.choices is None else list(a.choices),
                  a.nargs, a.required)
            for a in sub._actions for opt in a.option_strings if opt not in ("-h", "--help")}


JSUBS = _subparsers(jcli.build_parser())
SUBS = _subparsers(cli.build_parser())


def test_parser_has_every_subcommand_of_the_jax_cli():
    assert sorted(SUBS) == sorted(JSUBS) and len(SUBS) == 17


@pytest.mark.parametrize("cmd", sorted(JSUBS))
def test_parser_options_equal_jax(cmd):
    """Every option string of the original with its type, default, choices
    and arity; ``--device`` (default ``cuda``) is the port's one addition,
    on every subcommand that takes the common flags and on ``profile``. The
    3-D subcommands' ``--config`` also names the port's 3-D layer plans'
    experiments (``models.unet3d.EXPERIMENTS3D``), after the original's."""
    from supernet_tpu_torch.models.unet3d import EXPERIMENTS3D

    want, got = _options(JSUBS[cmd]), _options(SUBS[cmd])
    device = got.pop("--device", None)
    if cmd.endswith("3d"):
        t, default, choices, nargs, required = want["--config"]
        want["--config"] = (t, default, choices + sorted(EXPERIMENTS3D), nargs, required)
    assert got == want
    if "--config" in want and "--data" in want or cmd in ("profile", "bench"):
        assert device == (None, "cuda", None, None, False)
    else:
        assert device is None


STUBS = sorted(cli._UNPORTED)
PORTED = sorted(set(SUBS) - set(STUBS))


def test_ported_subcommands():
    assert PORTED == ["attack", "attack3d", "bench", "calibrate", "calibrate3d", "convert",
                      "eval", "eval3d", "export", "predict3d", "profile", "saliency",
                      "saliency3d", "study", "sweep", "train", "train3d"]
    assert STUBS == []


@pytest.mark.parametrize("cmd", sorted(JSUBS))
def test_unported_subcommands_name_their_roadmap_item(cmd):
    """Every subcommand of ``supernet_tpu/cli.py:build_parser`` is ported
    (``bench`` the last of them): none is left to name its ROADMAP.md
    item."""
    assert cmd in PORTED and cmd not in cli._UNPORTED


_T1 = ["--epochs", "1"]
_T3 = ["--epochs", "1", "--cube-size", "16", "--base-kernels", "2", "--depth", "2",
       "--batch-size", "2"]


@pytest.mark.parametrize("argv,item", [
    (["train", "--synthetic", "20", *_T1, "--data-parallel"], "Parallelism"),
    pytest.param(["train", "--synthetic", "8", "--batch-size", "4", *_T1, "--ensemble", "2",
                  "--ensemble-mode", "vmap", "--data-parallel"],
                 "Parallelism", id="argv1-Ensembles"),
    (["eval", "--synthetic", "12", "--images-n", "0", "--data-parallel"], "Parallelism"),
    (["sweep", "--synthetic", "4", "--images-n", "0", "--data-parallel"], "Parallelism"),
    (["attack", "--synthetic", "12", "--max-adv-step", "2", "--images-n", "0",
      "--data-parallel"], "Parallelism"),
    (["calibrate", "--synthetic", "12", "--data-parallel"], "Parallelism"),
    (["saliency", "--synthetic", "4", "--images-n", "2", "--data-parallel"], "Parallelism"),
    (["study", "--synthetic", "10", *_T1, "--images-n", "0", "--data-parallel"],
     "Parallelism"),
    (["train3d", "--synthetic", "4", *_T3, "--spatial-shard"], "Parallelism"),
    pytest.param(["train3d", "--synthetic", "4", *_T3, "--ensemble", "2",
                  "--ensemble-mode", "sequential", "--spatial-shard"],
                 "Parallelism", id="argv9-Ensembles"),
])
def test_unported_options_name_their_roadmap_item(tiny, argv, item, tmp_path, capsys, mesh1):
    """Each sharding flag of ROADMAP.md's ported item (these cases raised
    naming it before it was ported; the name is kept) runs in a one-rank
    gloo world and prints what the command prints without the flag: the
    same keys, the same numbers (float32 summation order apart: the
    spatially sharded loss sums each rank's pixels). Multi-rank worlds are
    in test_torch_parallel.py."""
    flag = argv[-1]
    lines = []
    for cmd, out in ((argv[:-1], "one"), (argv, "mesh")):
        assert cli.main(cmd + ["--device", "cpu", "--out-dir", str(tmp_path / out)]) == 0
        lines.append([json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")])
    want, got = lines
    assert len(got) == len(want) >= 1, flag
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            skip = any(s in k for s in ("per_sec", "time", "seconds"))
            if isinstance(v, float) and not skip:
                assert g[k] == pytest.approx(v, rel=1e-5, abs=1e-7, nan_ok=True), k
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        assert f"**{item}" in f.read()


def test_to_cubes_needs_nifti():
    with pytest.raises(SystemExit, match="--from-nifti"):
        cli.main(["convert", "--out", "x", "--to-cubes"])


def test_get_exp_applies_the_flags_like_the_jax_cli():
    argv = ["train", "--config", "brats", "--epochs", "3", "--lr", "0.01", "--kl-factor",
            "0.5", "--batch-size", "6", "--continue-training", "--augment",
            "--augment-rot90", "--augment-intensity", "0.2", "--augment-noise-std", "0.01",
            "--adv-epsilon", "0.02", "--adv-alpha", "0.3", "--adv-steps", "2",
            "--adv-step-size", "0.004", "--data", "d", "--out-dir", "o"]
    got = cli._get_exp(cli.build_parser().parse_args(argv))
    want = jcli._get_exp(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.train.augment.intensity_shift == 0.1 and got.train.epochs == 3
    argv = ["attack", "--epsilon", "0.1", "--untargeted", "--max-adv-step", "3",
            "--step-size", "0.5"]
    got = cli._get_exp(cli.build_parser().parse_args(argv))
    want = jcli._get_exp(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert cli._get_exp(cli.build_parser().parse_args(["train"])) is configs.HIPPOCAMPUS


def test_train_synthetic_then_continue(tiny, tmp_path, capsys):
    """``train --synthetic 100 --epochs 1`` writes ``epoch_0``, the history
    pickle and the hyperparameter dump and prints the final history as one
    JSON line; ``--continue-training`` goes on from it."""
    out = str(tmp_path / "run")
    argv = ["train", "--config", "hippocampus", "--synthetic", "100", "--epochs", "1",
            "--device", "cpu", "--out-dir", out]
    assert cli.main(argv) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("train_loss", "train_acc", "val_loss", "val_acc", "val_dice",
                "images_per_sec", "train_dice_anterior", "val_haus_posterior"):
        assert np.isfinite(final[key]), key
    assert {"epoch_0", "history.pkl", "Related_hyperparameters.txt"} <= set(os.listdir(out))
    assert ckpt.latest_epoch(out) == 0
    first = ckpt.restore_state(out, 0, tiny.train, "cpu")
    assert first.step == 10

    assert cli.main(argv[:5] + ["--epochs", "2", "--steps-per-dispatch", "4",
                                "--continue-training"] + argv[7:]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert any("2 trailing batch(es)" in line for line in lines)
    assert not any(line.startswith("epoch 0") for line in lines)
    assert ckpt.latest_epoch(out) == 1
    assert ckpt.restore_state(out, 1, tiny.train, "cpu").step == 20
    with open(os.path.join(out, "history.pkl"), "rb") as f:
        assert len(pickle.load(f)["train_loss"]) == 1  # the resumed run's own epochs


def test_convert_pickle_then_train_from_shards(tiny, tmp_path, capsys):
    x, y = synthetic_dataset(tiny.model, 45, seed=2)
    pkl, shards = str(tmp_path / "h.pkl"), str(tmp_path / "shards")
    with open(pkl, "wb") as f:
        pickle.dump((x[:30, ..., 0], y[:30], x[30:, ..., 0], y[30:]), f)
    assert cli.main(["convert", "--config", "hippocampus", "--data", pkl, "--out", shards,
                     "--shard-size", "16"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "shards": 2, "out": shards}
    assert cli.main(["convert", "--data", pkl, "--out", str(tmp_path / "test"),
                     "--split", "test"]) == 0
    assert len(ShardDataset(str(tmp_path / "test"), use_native=False)) == 14
    ds = ShardDataset(shards, use_native=False)
    assert len(ds) == 30 and ds.x_shape == (32, 32, 1)

    out = str(tmp_path / "run")
    assert cli.main(["train", "--data", shards, "--val-data", str(tmp_path / "test"),
                     "--epochs", "1", "--device", "cpu", "--out-dir", out]) == 0
    captured = capsys.readouterr()
    final = json.loads(captured.out.strip().splitlines()[-1])
    assert np.isfinite(final["train_loss"]) and np.isfinite(final["val_dice_anterior"])
    assert "reuse the TRAINING data" not in captured.err
    assert cli.main(["train", "--data", shards, "--epochs", "1", "--device", "cpu",
                     "--out-dir", out]) == 0
    assert "reuse the TRAINING data" in capsys.readouterr().err


def test_convert_from_nifti(tiny, tmp_path, capsys):
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "task" / "imagesTr")
    os.makedirs(tmp_path / "task" / "labelsTr")
    for i in range(2):
        lab = np.zeros((20, 24, 6), np.uint8)
        lab[5:12, 6:15, 1:5] = 1 + i
        jnifti.write_nifti(str(tmp_path / "task" / "imagesTr" / f"c_{i}.nii.gz"),
                           rng.normal(100, 30, (20, 24, 6)).astype(np.float32))
        jnifti.write_nifti(str(tmp_path / "task" / "labelsTr" / f"c_{i}.nii.gz"), lab)
    shards = str(tmp_path / "shards")
    assert cli.main(["convert", "--data", str(tmp_path / "task"), "--out", shards,
                     "--from-nifti", "--max-volumes", "2"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["shards"] == 1
    ds = ShardDataset(shards, use_native=False)
    assert len(ds) == 8 and ds.x_shape == (32, 32, 1)


def test_hippocampus_pickle_path(tiny, tmp_path, capsys):
    x, y = synthetic_dataset(tiny.model, 31, seed=3)
    pkl = str(tmp_path / "h.pkl")
    with open(pkl, "wb") as f:
        pickle.dump((x[:20, ..., 0], y[:20], x[20:, ..., 0], y[20:]), f)
    args = cli.build_parser().parse_args(["train", "--data", pkl])
    exp = cli._get_exp(args)
    assert len(cli._load_data(exp, args, "train")) == 20
    assert len(cli._load_data(exp, args, "test")) == 10  # the last test sample dropped


# ---------------------------------------------------- the evaluation surface


@pytest.fixture
def jtiny(monkeypatch, tiny):
    """The same tiny size under ``--config hippocampus`` of the JAX CLI."""
    jt = jconfigs_mod.HIPPOCAMPUS.replace(
        model=dataclasses.replace(jconfigs_mod.HIPPOCAMPUS.model, image_size=32, out_size=22,
                                  base_kernels=4),
        train=dataclasses.replace(jconfigs_mod.HIPPOCAMPUS.train, batch_size=10))
    monkeypatch.setitem(jconfigs_mod._CONFIGS, "hippocampus", jt)
    return jt


def _npz(tmp_path, seed=0, name="params.npz"):
    from supernet_tpu_torch.models import init_params

    path = str(tmp_path / name)
    ckpt.save_params_npz(path, init_params(torch.Generator().manual_seed(seed), TINY.model, "cpu"))
    return path


def _json_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("cmd,extra,n_lines", [
    ("eval", ["--images-n", "2"], 1),
    ("eval", ["--images-n", "0", "--mc-samples", "2", "--artifact-max-samples", "3"], 1),
    ("attack", ["--images-n", "2", "--max-adv-step", "2", "--epsilon", "0.01"], 1),
    ("attack", ["--images-n", "0", "--max-adv-step", "1", "--untargeted"], 1),
    ("calibrate", ["--bins", "10"], 1),
    ("sweep", ["--images-n", "0", "--artifact-max-samples", "2"], 7),
])
def test_evaluation_subcommands_print_the_json_of_their_twins(
        jtiny, tmp_path, capsys, cmd, extra, n_lines):
    """Each subcommand on ``--device cpu`` from an npz checkpoint: as many
    JSON lines, with the same keys, as the JAX CLI prints for the same
    arguments, and the same files (PNGs aside) in the output directory."""
    argv = [cmd, "--config", "hippocampus", "--synthetic", "12", "--checkpoint",
            _npz(tmp_path)] + extra
    assert cli.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path / "t")]) == 0
    got = _json_lines(capsys)
    assert jcli.main(argv + ["--out-dir", str(tmp_path / "j")]) == 0
    want = _json_lines(capsys)
    assert len(got) == len(want) == n_lines
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert all(np.isfinite(v) or k == "snr_db" or np.isnan(w[k])
                   for k, v in g.items() if isinstance(v, float)), g

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(tmp_path / "t") == files(tmp_path / "j")
    assert files(tmp_path / "t")


def test_saliency_subcommand(jtiny, tmp_path, capsys):
    npz = _npz(tmp_path)
    for target, out in ((None, "all"), ("2", "posterior")):
        argv = ["saliency", "--synthetic", "12", "--checkpoint", npz, "--images-n", "3"]
        argv += ["--target-class", target] if target else []
        assert cli.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path / out)]) == 0
        assert _json_lines(capsys) == [{"saliency_maps": 3, "out_dir": str(tmp_path / out)}]
        assert sorted(os.listdir(tmp_path / out)) == [f"{i}_saliency.png" for i in range(3)]
    assert jcli.main(["saliency", "--synthetic", "12", "--checkpoint", npz, "--images-n", "3",
                      "--out-dir", str(tmp_path / "j")]) == 0
    assert set(_json_lines(capsys)[0]) == {"saliency_maps", "out_dir"}


def test_checkpoint_forms_and_ensemble_lists(tiny, tmp_path, capsys):
    """``--checkpoint``: an npz, a Keras h5, a run directory (its latest
    ``epoch_{N}/state.pt``), one ``epoch_{N}`` directory, none (random init,
    with a warning), a missing one; a comma-separated list is an ensemble
    for eval / calibrate / sweep and refused by attack / saliency."""
    from supernet_tpu_torch import train as T

    a, b = _npz(tmp_path, 0, "a.npz"), _npz(tmp_path, 1, "b.npz")
    pa = ckpt.load_params_npz(a, "cpu")
    h5 = str(tmp_path / "w.weights.h5")
    ckpt.export_keras_h5(h5, pa, tiny.model)
    run = str(tmp_path / "run")
    state, _ = T.create_train_state(pa, tiny.train, "cpu")
    ckpt.save_state(run, 0, state)
    state.params["conv1"]["w_mu"].data.add_(1.0)
    ckpt.save_state(run, 3, state)

    def load(src):
        args = cli.build_parser().parse_args(
            ["eval", "--device", "cpu"] + (["--checkpoint", src] if src else []))
        return cli._load_maybe_ensemble(cli._load_params, cli._get_exp(args), args)

    for src in (a, h5, os.path.join(run, "epoch_0")):
        got = load(src)
        assert all(torch.equal(got[k][n], pa[k][n]) and not got[k][n].requires_grad
                   for k in pa for n in pa[k]), src
    assert torch.equal(load(run)["conv1"]["w_mu"], pa["conv1"]["w_mu"] + 1.0)
    members = load(f"{a},{b}")
    assert isinstance(members, list) and len(members) == 2
    assert not torch.equal(members[0]["conv1"]["w_mu"], members[1]["conv1"]["w_mu"])
    assert set(load(None)) == set(pa) and "random init" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="no epoch_"):
        load(str(tmp_path / "nothing"))

    common = ["--synthetic", "10", "--checkpoint", f"{a},{b}", "--device", "cpu",
              "--out-dir", str(tmp_path / "o")]
    assert cli.main(["eval", "--images-n", "0"] + common) == 0
    assert cli.main(["calibrate"] + common) == 0
    assert len(_json_lines(capsys)) == 2
    for cmd in ("attack", "saliency"):
        with pytest.raises(SystemExit, match="takes ONE checkpoint"):
            cli.main([cmd] + common)


def test_study_runs_every_stage_and_writes_study_json(tiny, tmp_path, capsys):
    """train, then eval, sweep, attack and calibrate on its checkpoint, each
    through ``main()``; ``--skip-train`` reuses the checkpoints."""
    out = str(tmp_path / "study")
    argv = ["study", "--config", "hippocampus", "--synthetic", "20", "--epochs", "1",
            "--images-n", "0", "--artifact-max-samples", "2", "--device", "cpu",
            "--out-dir", out]
    assert cli.main(argv) == 0
    captured = capsys.readouterr()
    head = json.loads(captured.out.strip().splitlines()[-1])
    assert head["study"] == os.path.join(out, "study.json")
    for k in ("accuracy", "dice_anterior", "dice_posterior", "mean_predictive_variance",
              "ece", "ause", "total_seconds"):
        assert np.isfinite(head[k]), k
    assert "[study] attack: supernet_tpu_torch attack" in captured.err
    with open(head["study"]) as f:
        summary = json.load(f)
    assert list(summary["stages"]) == ["train", "eval", "sweep", "attack", "calibrate"]
    assert [len(s["results"]) for s in summary["stages"].values()] == [1, 1, 7, 1, 1]
    assert summary["stages"]["eval"]["results"][0]["accuracy"] == head["accuracy"]
    assert ckpt.latest_epoch(os.path.join(out, "train")) == 0
    for sub in ("eval", "attack", "calibration", "sweep/hippocampus/testing/clean"):
        assert os.listdir(os.path.join(out, sub)), sub

    assert cli.main(argv + ["--skip-train"]) == 0
    with open(head["study"]) as f:
        again = json.load(f)
    assert list(again["stages"]) == ["eval", "sweep", "attack", "calibrate"]
    for k, v in summary["stages"]["eval"]["results"][0].items():
        w = again["stages"]["eval"]["results"][0][k]
        nan = isinstance(v, float) and np.isnan(v) and np.isnan(w)  # an absent structure
        assert k == "test_time_per_batch_s" or nan or w == v, k


@pytest.mark.parametrize("mode", ["fgsm", "pgd"])
def test_train_with_adversarial_training(tiny, tmp_path, capsys, mode):
    out = str(tmp_path / "adv")
    assert cli.main(["train", "--synthetic", "20", "--epochs", "1", "--device", "cpu",
                     "--adversarial-training", mode, "--adv-epsilon", "0.01",
                     "--adv-steps", "2", "--out-dir", out]) == 0
    final = _json_lines(capsys)[-1]
    assert np.isfinite(final["train_loss"]) and np.isfinite(final["val_dice"])
    with open(os.path.join(out, "Related_hyperparameters.txt")) as f:
        assert f"adversarial_training : {mode}" in f.read()
    assert ckpt.restore_state(out, 0, tiny.train, "cpu").step == 2


def test_python_dash_m_entry_point_defaults_to_the_card(tmp_path):
    """``python -m supernet_tpu_torch.cli train`` with no ``--device`` asks
    for the card: where there is none (as here) it fails and does not go on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "supernet_tpu_torch.cli", "train", "--synthetic", "20",
         "--epochs", "1", "--out-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not os.path.exists(tmp_path / "epoch_0")
    assert "cuda" in out.stderr.lower()
    ok = subprocess.run([sys.executable, "-m", "supernet_tpu_torch.cli", "--help"],
                        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0 and "convert" in ok.stdout
