"""The port's command line (``supernet_tpu_torch/cli.py``) on the CPU: the
parser holds every subcommand and flag of the JAX package's, ``train`` and
``convert`` run (at the tiny test size, through ``--device cpu``), and every
subcommand or option that is not ported yet raises ``NotImplementedError``
naming its ``ROADMAP.md`` item."""

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

from supernet_tpu import cli as jcli  # noqa: E402
from supernet_tpu.data import nifti as jnifti  # noqa: E402
from supernet_tpu_torch import checkpoint as ckpt  # noqa: E402
from supernet_tpu_torch import cli, configs  # noqa: E402
from supernet_tpu_torch.data import ShardDataset, synthetic_dataset  # noqa: E402

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
    on every subcommand that takes the common flags."""
    want, got = _options(JSUBS[cmd]), _options(SUBS[cmd])
    device = got.pop("--device", None)
    assert got == want
    if "--config" in want and "--data" in want:
        assert device == (None, "cuda", None, None, False)
    else:
        assert device is None


STUBS = sorted(set(SUBS) - {"train", "convert"})
_REQUIRED = {"predict3d": ["--volume", "v.nii"]}


@pytest.mark.parametrize("cmd", STUBS)
def test_unported_subcommands_name_their_roadmap_item(cmd):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue 1: '") as e:
        cli.main([cmd] + _REQUIRED.get(cmd, []))
    item = str(e.value).split("Queue 1: '")[1].split("'")[0]
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        assert f"**{item}" in f.read(), item


@pytest.mark.parametrize("argv,item", [
    (["train", "--synthetic", "4", "--data-parallel"], "Parallelism"),
    (["train", "--synthetic", "4", "--ensemble", "2"], "Ensembles"),
    (["train", "--synthetic", "4", "--adversarial-training", "fgsm"], "Evaluation surface"),
    (["convert", "--out", "x", "--from-nifti", "--to-cubes"], "3-D family"),
])
def test_unported_options_name_their_roadmap_item(tiny, argv, item, tmp_path):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        cli.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path)])
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
