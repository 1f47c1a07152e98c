"""A configuration, a cell and a per-layer metric added only as files (and
entries in the manifest) are found by name; no existing file is edited."""

import hashlib
import json
import shutil
import time

from benchmark.core import manifest as M
from benchmark.core import runner

METRIC = '''"""Steps in the window, per second of it."""

LAYER = "train step"
UNIT = "steps/s"
SOURCE = "host_clock"
MOVES = "train_samples_per_s.hippo-narrow"


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.samples / ctx.window_s / 2
'''


def _digest(root):
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(M.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(M.MANIFEST, tmp_path / "BENCHMARK.json")
    before = _digest(M.BENCH_DIR)

    conf = M.load_json(bench / "configs" / "hippocampus.json")
    conf.update(name="hippo-narrow")
    conf["model"]["base_kernels"] = 4
    (bench / "configs" / "hippo-narrow.json").write_text(json.dumps(conf))
    work = M.load_json(bench / "workloads" / "brats-train-b20.json")
    work["params"].update(batch=2, pool_batches=3, trace_steps=2)
    (bench / "workloads" / "hippo-narrow-train.json").write_text(json.dumps(work))
    (bench / "metrics" / "steps_per_s.train.py").write_text(METRIC)

    man = M.load_manifest(tmp_path / "BENCHMARK.json")
    man["configs"].append({"name": "hippo-narrow", "source": "https://example.org/x",
                           "file": "benchmark/configs/hippo-narrow.json",
                           "reduced": ["base_kernels"], "why": "a test"})
    man["workloads"].append({"name": "hippo-narrow-train", "config": "hippo-narrow",
                             "traffic": "train-b2", "chips": 1, "why": "a test"})
    # a new end-to-end metric: the drivers' train_samples_per_s under a bound of its own
    man["end_to_end"].append({"name": "train_samples_per_s.hippo-narrow", "unit": "samples/s",
                              "better": "higher", "bound": 0.25, "source": "host_clock",
                              "workloads": ["hippo-narrow-train"]})
    man["per_layer"].append({"name": "steps_per_s.train", "unit": "steps/s", "better": "higher",
                             "source": "host_clock", "layer": "train step",
                             "moves": "train_samples_per_s.hippo-narrow",
                             "workloads": ["hippo-narrow-train"]})

    entry = M.cell(man, "hippo-narrow-train")
    found = M.workload_file("hippo-narrow-train", bench)
    config = M.config_file(M.config_entry(man, entry["config"]), tmp_path)
    assert config["model"]["base_kernels"] == 4
    for trace in (False, True):
        result = runner.execute(man, "hippo-narrow-train", config, found, 3, 0.3, trace,
                                "cpu", time.perf_counter(), bench_dir=bench)
        if trace:
            assert set(result["metrics"]) == {"steps_per_s.train"}
        else:
            assert set(result["metrics"]) == {"train_samples_per_s.hippo-narrow", "setup_s"}
    assert _digest(M.BENCH_DIR) == before
