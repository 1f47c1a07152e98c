"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<name>`` is ``workloads/<name>.json`` (its driver, the driver's
parameters and its limits); its configuration and traffic are its entry's in
``BENCHMARK.json`` alone, the configuration's file ``configs/<config>.json``; its traffic driver ``drivers/<driver>.py``; a
per-layer metric ``<metric>`` is ``metrics/<metric>.py``. Nothing here lists
cells, configurations or metrics: adding one is adding its files and its
entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")
# the top-level module names no run may hold (the JAX package and JAX)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "supernet_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(path: Path = MANIFEST) -> dict:
    return load_json(path)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def workload_file(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "workloads" / f"{name}.json")


def quantity(metric_name: str) -> str:
    """The driver's quantity an end-to-end metric reports: its name up to the
    first dot (``train_samples_per_s.brats`` reports ``train_samples_per_s``,
    with a bound of its own)."""
    return metric_name.split(".")[0]


def config_file(entry: dict, root: Path = ROOT) -> dict:
    return load_json(root / entry["file"])


def config_by_name(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``configs/<name>.json``, also of a configuration no cell runs yet."""
    return load_json(bench_dir / "configs" / f"{name}.json")


def load_module(path: Path, qualname: str) -> ModuleType:
    """Import the file at ``path`` as a module named ``qualname`` (metric
    files carry dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(qualname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "drivers" / f"{name}.py", f"bench_driver_{name}")


def metric_module(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


def reports(metric: dict, cell_name: str, manifest: dict) -> bool:
    """True when the cell ``cell_name`` reports ``metric``: it is listed
    under the metric's ``workloads``, or the metric has no such key and
    (per-layer) the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in manifest["end_to_end"] if m["name"] == metric["moves"])
        return reports(moved, cell_name, manifest)
    return True


def end_to_end_of(manifest: dict, cell_name: str) -> List[dict]:
    return [m for m in manifest["end_to_end"] if reports(m, cell_name, manifest)]


def per_layer_of(manifest: dict, cell_name: str) -> List[dict]:
    return [m for m in manifest["per_layer"] if reports(m, cell_name, manifest)]


def names_problems(manifest: dict) -> List[str]:
    """Every name and unit of the manifest that breaks the character rules
    (empty when all hold)."""
    bad: List[str] = []

    def name(v, where):
        if not isinstance(v, str) or not NAME_RE.fullmatch(v):
            bad.append(f"{where}: {v!r}")

    for c in manifest["configs"]:
        name(c["name"], "config")
        for k in c.get("reduced", []):
            name(k, "reduced")
    for w in manifest["workloads"]:
        name(w["name"], "workload")
        name(w["config"], "workload config")
        name(w["traffic"], "traffic")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        name(m["name"], "metric")
        if not UNIT_RE.fullmatch(m["unit"]):
            bad.append(f"unit: {m['unit']!r}")
    return bad


def forbidden_modules(modules) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN_MODULES` (``supernet_tpu_torch`` is not
    ``supernet_tpu``)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES)

