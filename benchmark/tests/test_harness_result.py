"""The last line's shape, the exits without a result, the import check."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from _tiny import SERVE, TRAIN, tiny
from benchmark.core import manifest as M
from benchmark.core import runner

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [(TRAIN[0], False), (SERVE[0], True)])
def test_the_last_line_holds_exactly_the_keys(cell, trace, capsys):
    man, conf, work = tiny(cell)
    result = runner.execute(man, cell, conf, work, 2 ** 32 + 11, 0.5, trace, "cpu",
                            time.perf_counter())
    runner.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in M.end_to_end_of(man, cell)}
        assert set(line["metrics"]) == want
    # each number compared is printed beside its limit, last on stderr too
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(" limit " in t for t in tail)


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "brats-train-b20", "--seed", "1", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_without_a_card_there_is_no_result():
    proc = _run(M.ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_with_only_the_benchmark_files_there_is_no_result(tmp_path):
    shutil.copy(M.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(M.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_import_check_compares_whole_top_level_names():
    found = M.forbidden_modules(["supernet_tpu_torch", "supernet_tpu_torch.train",
                                 "jax_like", "jaxlib.xla_client", "flax",
                                 "supernet_tpu.ops", "benchmark.core"])
    assert found == ["flax", "jaxlib.xla_client", "supernet_tpu.ops"]


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.training; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(M.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "supernet_tpu", "supernet_tpu_torch"}
