"""One run of one cell: the driver named by the cell's file, then the
per-layer readers, the import check and the result line.

``execute`` takes the files' contents as dictionaries, so a test can run
the whole of a run on the CPU at a small size; ``run.py`` looks for the
card before it calls it.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from benchmark.core import compare, counts
from benchmark.core import manifest as M


@dataclass
class Cell:
    """What a driver is given."""

    name: str
    config: dict  # configs/<config>.json
    work: dict  # workloads/<name>.json: driver, params, limits
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # time.perf_counter() when the process started
    log: Callable[[str], None] = lambda line: print(line, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What a driver returns."""

    metrics: Dict[str, float]  # end-to-end quantities (M.quantity) by name
    attempted: int
    failed: int
    numbers: Dict[str, float]  # the numbers compared
    memory_peak: int
    ctx: dict = field(default_factory=dict)  # what the per-layer readers read
    stretch: Optional[object] = None  # trace.Stretch of a --trace 1 run


def device_info(device, peak: int, stretch=None) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if stretch is not None:
        info["busy_s"] = stretch.busy_us() * 1e-6
        info["window_s"] = stretch.window_s
    return info


def per_layer(manifest: dict, cell_name: str, outcome: Outcome, bench_dir=M.BENCH_DIR) -> Dict[str, dict]:
    ctx = SimpleNamespace(**outcome.ctx, stretch=outcome.stretch)
    out = {}
    for m in M.per_layer_of(manifest, cell_name):
        value = M.metric_module(m["name"], bench_dir).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(manifest: dict, cell_name: str, config: dict, work: dict, seed: int,
            seconds: float, trace: bool, device, t_start: float,
            bench_dir=M.BENCH_DIR) -> dict:
    """Run the cell once and return the result as a dictionary (the last
    line's keys, ``checks`` last)."""
    cell = Cell(cell_name, config, work, seed, seconds, trace, torch.device(device), t_start)
    outcome = M.driver(work["driver"], bench_dir).run(cell)
    if trace:
        metrics = per_layer(manifest, cell_name, outcome, bench_dir)
    else:
        metrics = {}
        for m in M.end_to_end_of(manifest, cell_name):
            quantity = M.quantity(m["name"])
            if quantity not in outcome.metrics:
                raise KeyError(f"the driver reported no {quantity}")
            metrics[m["name"]] = {"value": outcome.metrics[quantity], "unit": m["unit"]}
    limits = work["limits"]
    result = {
        "correct": compare.judge(outcome.numbers, limits) and outcome.failed == 0,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device_info(device, outcome.memory_peak, outcome.stretch if trace else None),
    }
    if trace and outcome.stretch is not None:
        result["breakdown"] = {"device_ops": outcome.stretch.ops_by_name(),
                               "idle_gaps": outcome.stretch.idle_gaps()}
    for k, v in outcome.numbers.items():
        if k not in limits:
            cell.log(f"reading {k} {v!r} (not held to a limit)")
    result["checks"] = {k: {"value": outcome.numbers.get(k, float("nan")), "limit": v}
                        for k, v in limits.items()}
    return result


def check_lines(result: dict) -> List[str]:
    """The numbers compared, each beside its limit."""
    return [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in result["checks"].items()]


def emit(result: dict) -> None:
    """The check lines last on standard error; the result as the last line of
    standard output."""
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def peaks_for(config: dict, device) -> Optional[tuple]:
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    p = config["precision"]
    # float32 operands unless the activations or kernel 1's products are bf16
    operands = ("float32" if p["activations"] == "float32" and p["products"] != "default"
                else "bfloat16")
    return counts.peaks(torch.cuda.get_device_name(dev), operands)
