"""The port's benchmark (``supernet_tpu_torch/bench.py``, ``cli bench``) on
the CPU against the JAX package's ``bench.py``: the last-good merge on the
payload cases of ``tests/test_bench_merge.py``; every section's keys equal
``bench.py``'s less the three keys of XLA's cost analysis (read from
``bench.py``'s source: running it compiles the JAX steps); the counts it
reports equal ``supernet_tpu.flops``'s; ``cli bench --device cpu`` prints one
line with the headline keys; ``--device cuda`` without a card prints the
error line and exits 1. The sections run at the tiny test size (32x32, 4 base
kernels; a 16^3 cube at depth 2)."""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from supernet_tpu import configs as jconfigs  # noqa: E402
from supernet_tpu import flops as jflops  # noqa: E402
from supernet_tpu_torch import bench, cli, configs, ops  # noqa: E402
from test_bench_merge import FULL, THIN  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")
XLA_KEYS = {"xla_bytes_per_step_mb", "achieved_hbm_gbps", "hbm_utilization"}
KNOBS = ("SUPERNET_BENCH_ITERS", "SUPERNET_BENCH_DISPATCH", "SUPERNET_BENCH_BASELINE",
         "SUPERNET_BENCH_SCALING", "SUPERNET_BENCH_EXTRA", "SUPERNET_BENCH_3D",
         "SUPERNET_BENCH_ENSEMBLE", "SUPERNET_BENCH_INFER", "SUPERNET_BENCH_MODEL",
         "SUPERNET_PRECISION", "SUPERNET_ACT_DTYPE", "SUPERNET_BACKEND",
         "SUPERNET_CONV_FOLD", "SUPERNET_DATA_PARALLEL")

TINY = configs.HIPPOCAMPUS.replace(
    model=dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                              base_kernels=4),
    train=dataclasses.replace(configs.HIPPOCAMPUS.train, batch_size=2))
JTINY = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                            base_kernels=4)


@pytest.fixture
def tiny(monkeypatch):
    """``hippocampus`` at the tiny size (batch 2), the 3-D section on a 16^3
    cube at depth 2, one step per call, every knob unset but those given."""
    cfg3 = dataclasses.replace(TINY.model, base_kernels=2, depth=2)
    monkeypatch.setitem(configs._CONFIGS, "hippocampus", TINY)
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SUPERNET_BENCH_DISPATCH", "1")
    monkeypatch.setattr(bench, "CUBE_3D", 16)
    return cfg3


# ------------------------------------------------------------ bench.py's keys


def _jax_bench():
    spec = importlib.util.spec_from_file_location("bench_reference", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(path, fn_name):
    """The string keys a function of ``path`` puts in its result: the keys
    of a returned dict literal, of a dict literal assigned to ``out``, and
    of string subscripts assigned on ``out``, ``entry`` or ``v`` (the
    sections' dicts)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)

    def consts(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= consts(node.value)
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "out" and isinstance(node.value, ast.Dict):
                keys |= consts(node.value)
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id in ("out", "entry", "v")
                    and isinstance(t.slice, ast.Constant)):
                keys.add(t.slice.value)
    return keys


SECTIONS = [("_bench_model", "_bench_model"), ("main", "_measure"),
            ("_bench_inference", "_bench_inference"),
            ("_bench_ensemble", "_bench_ensemble"), ("_bench_3d", "_bench_3d")]


@pytest.mark.parametrize("jax_fn,port_fn", SECTIONS)
def test_section_keys_equal_bench_py(jax_fn, port_fn):
    """Each section's keys (the source's dict literals and assignments) are
    ``bench.py``'s less the three XLA keys."""
    want = _keys(BENCH_PY, jax_fn) - XLA_KEYS
    assert _keys(bench.__file__, port_fn) == want
    assert want  # the reader found the section


def test_constants_equal_bench_py():
    jb = _jax_bench()
    assert bench.SCALING_BATCHES == jb.SCALING_BATCHES
    assert bench.SCALING_BATCHES_3D == jb.SCALING_BATCHES_3D
    assert bench.REFERENCE_IMAGES_PER_SEC == jb.REFERENCE_IMAGES_PER_SEC
    assert bench._BEST_KEYS == tuple(k for k in jb._BEST_KEYS if k not in XLA_KEYS)
    assert bench.LAST_GOOD_PATH != jb.LAST_GOOD_PATH
    assert bench.LAST_GOOD_PATH == os.path.join(REPO, "build", "torch_bench_last_good.json")


# -------------------------------------------------------------- the merge


def _stale(p):
    return dict(p, stale=True)


MERGE_CASES = {
    "no_prior_capture_is_identity": (None, THIN),
    "thin_capture_retains_full_sections": (FULL, THIN),
    "degenerate_best_does_not_shadow_sweep_best": (FULL, THIN),
    "vs_baseline_recomputed_from_retained_denominator": (FULL, THIN),
    "full_capture_overwrites_everything": (THIN, dict(FULL, captured_at="2026-08-19T18:00:00Z")),
    "stale_prior_is_ignored": (_stale(FULL), THIN),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_last_good_equals_bench_py(case, tmp_path, monkeypatch):
    """``_merge_last_good`` gives ``bench.py``'s result on the payloads of
    ``tests/test_bench_merge.py``, each side reading its own prior file."""
    prior, fresh = MERGE_CASES[case]
    jb = _jax_bench()
    results = []
    for mod, name in ((jb, "jax.json"), (bench, "port.json")):
        path = str(tmp_path / name)
        monkeypatch.setattr(mod, "LAST_GOOD_PATH", path)
        if prior is not None:
            with open(path, "w") as f:
                json.dump(prior, f)
        results.append(mod._merge_last_good(dict(fresh)))
    assert results[1] == results[0]


# ----------------------------------------------------------- the sections


def test_bench_model_counts_equal_jax(tiny):
    """One tiny ``_bench_model`` run: its keys, and the counts it reports
    equal ``supernet_tpu.flops``'s at the same config (the activation bytes
    of the dtype in force)."""
    for act, nbytes in (("float32", 4), ("bfloat16", 2)):
        ops.set_act_dtype(act)
        try:
            s = bench._bench_model("hippocampus", 1, False, 0, "cpu")
        finally:
            ops.set_act_dtype("float32")
        assert set(s) == _keys(BENCH_PY, "_bench_model") - XLA_KEYS
        assert s["batch"] == 2 and s["devices"] == 1
        assert s["flops_per_image_g"] == round(jflops.forward_flops(JTINY, 1) * 3.0 / 1e9, 3)
        assert s["min_bytes_per_step_mb"] == round(
            jflops.train_step_min_bytes(JTINY, 2, nbytes) / 1e6, 1)
        assert s["mfu"] == 0.0 and s["hbm_utilization_min"] == 0.0  # no card
        assert s["images_per_sec"] > 0


def test_sections_run_at_a_tiny_size(tiny, monkeypatch):
    """The inference, ensemble and 3-D sections at the tiny size: each
    returns ``bench.py``'s keys; the ensemble times all three modes."""
    inf = bench._bench_inference(8, "cpu")
    assert set(inf) == _keys(BENCH_PY, "_bench_inference")
    assert inf["batch"] == 2 and inf["images_per_sec"] > 0
    ens = bench._bench_ensemble(1, 1.0, "cpu")
    assert set(ens) == _keys(BENCH_PY, "_bench_ensemble")
    assert ens["member_mode"] in ("vmap", "scan", "unroll") and ens["members"] == 4
    monkeypatch.setitem(configs._CONFIGS, "hippocampus", TINY.replace(model=tiny))
    v = bench._bench_3d(1, 2, "cpu")
    assert set(v) == _keys(BENCH_PY, "_bench_3d")
    assert v["cube"] == 16 and v["batch"] == 2 and v["vols_per_sec"] > 0


# ---------------------------------------------------------------- cli bench


HEADLINE = {"metric", "value", "unit", "vs_baseline_estimated", "mfu", "tflops_per_sec",
            "flops_per_image_g", "peak_tflops", "peak_hbm_gbps", "device_kind",
            "act_dtype", "backend", "precision", "batch", "step_ms",
            "min_bytes_per_step_mb", "hbm_utilization_min", "vs_baseline", "best"}


@pytest.mark.parametrize("baseline", ["0", "1"])
def test_cli_bench_on_the_cpu_prints_the_headline(tiny, monkeypatch, capsys, baseline):
    """``cli bench --device cpu`` with the sections off prints one line: the
    headline keys of ``bench.py``'s ``main``, the CPU's kind, peaks and
    shares at 0.0; with the baseline on, ``vs_baseline`` is measured
    through the naive backend. The knobs it set are restored."""
    for k in ("SCALING", "EXTRA", "3D", "ENSEMBLE", "INFER"):
        monkeypatch.setenv(f"SUPERNET_BENCH_{k}", "0")
    monkeypatch.setenv("SUPERNET_BENCH_ITERS", "1")
    monkeypatch.setenv("SUPERNET_BENCH_BASELINE", baseline)
    assert cli.main(["bench", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    extra = ({"baseline_measured_images_per_sec"} if baseline == "1"
             else {"vs_baseline_is_estimate"})
    assert set(out) == HEADLINE | extra
    assert HEADLINE | extra <= _keys(BENCH_PY, "main")
    assert out["metric"] == "hippocampus_train_throughput" and out["value"] > 0
    assert out["device_kind"].startswith("cpu")
    assert out["peak_tflops"] == out["peak_hbm_gbps"] == out["mfu"] == 0.0
    assert (out["act_dtype"], out["precision"], out["backend"]) == (
        "bfloat16", "default", "kernels")
    if baseline == "1":
        assert out["vs_baseline"] == round(
            out["value"] / out["baseline_measured_images_per_sec"], 3)
    assert ops.get_act_dtype() == torch.float32
    assert ops.get_mxu_precision() == "highest" and ops.get_backend() == "kernels"


def test_cli_bench_without_a_card_fails_and_never_runs_on_the_cpu():
    """The default device is the card: without one the bench prints the
    error line and exits 1, in a fresh process, having measured nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the failure path needs a host without one")
    proc = subprocess.run([sys.executable, "-m", "supernet_tpu_torch.cli", "bench"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 1
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["value"] == 0.0 and out["error"].startswith("CUDA device unavailable")
    assert out["metric"] == "images_per_sec"


@pytest.mark.slow
def test_cli_bench_every_section_on_the_cpu(tiny, monkeypatch, capsys):
    """The whole bench at the tiny size (the 3-D section on a 32^3 cube),
    every section on: each section's keys, the sweeps' batches, the naive
    baseline measured."""
    tiny_brats = configs.BRATS.replace(
        model=dataclasses.replace(configs.BRATS.model, base_kernels=2),
        train=dataclasses.replace(configs.BRATS.train, batch_size=1))
    monkeypatch.setitem(configs._CONFIGS, "brats", tiny_brats)
    monkeypatch.setattr(bench, "SCALING_BATCHES", {"hippocampus": (3,), "brats": (2,)})
    monkeypatch.setattr(bench, "SCALING_BATCHES_3D", (1,))
    monkeypatch.setattr(bench, "CUBE_3D", 32)  # the smallest side at depth 3: 29
    monkeypatch.setenv("SUPERNET_BENCH_ITERS", "2")
    assert cli.main(["bench", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == _keys(BENCH_PY, "main") - XLA_KEYS - {
        "devices", "global_images_per_sec", "vs_baseline_is_estimate"} | {"brats"}
    assert set(out["batch_scaling"]) == {"2", "3"}
    assert set(out["best"]) == set(bench._BEST_KEYS)
    assert set(out["brats"]) >= {"images_per_sec", "batch_scaling", "best"}
    assert set(out["unet3d"]) == _keys(BENCH_PY, "_bench_3d") | {"batch_scaling", "best"}
    assert set(out["ensemble_train"]) == _keys(BENCH_PY, "_bench_ensemble")
    assert set(out["inference"]) == _keys(BENCH_PY, "_bench_inference")
    assert not any("error" in v for v in out.values() if isinstance(v, dict))
