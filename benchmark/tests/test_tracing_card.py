"""On the card, the program's spans and counters (``supernet_tpu_torch/tracing.py``)
at the cells' sizes: a short traced run of each cell reports every per-layer
metric, the train step's device-timed phases fit in its device time, the
session's spans cover the device's idle time inside ``predict``, and kernel 1's
plan counters add up to its launches."""

import math
import time

import pytest

from benchmark.core import manifest as M
from benchmark.core import runner
from benchmark.core.trace import profile_stretch, union

SEED = 2 ** 31 + 21
CELLS = [w["name"] for w in M.load_manifest()["workloads"]]
SESSION = ("session.stage_in", "session.dispatch", "session.wait", "session.stage_out")


def _files(name):
    man = M.load_manifest()
    conf = M.config_file(M.config_entry(man, M.cell(man, name)["config"]))
    return man, conf, M.workload_file(name)


def _minus(spans, cuts):
    """The parts of the disjoint ``spans`` outside the disjoint ``cuts``."""
    out = []
    for a, b in spans:
        for s, e in cuts:
            if e <= a or s >= b:
                continue
            if s > a:
                out.append((a, s))
            a = max(a, e)
        if a < b:
            out.append((a, b))
    return out


def _length(spans):
    return sum(e - s for s, e in spans)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_every_per_layer_metric(card, cell):
    man, conf, work = _files(cell)
    result = runner.execute(man, cell, conf, work, SEED, 3.0, True, card, time.perf_counter())
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == {m["name"] for m in M.per_layer_of(man, cell)}
    assert all(math.isfinite(v) for v in metrics.values())
    if "backward_device_ms.train.brats" in metrics:
        busy_ms = 1e3 * result["device"]["busy_s"] / work["params"]["trace_steps"]
        backward = metrics["backward_device_ms.train.brats"]
        update = metrics["update_device_ms.train.brats"]
        assert 0 < update < busy_ms and 0 < backward < busy_ms
        assert backward + update < busy_ms


@pytest.mark.card
@pytest.mark.parametrize("cell", ["brats-serve-closed"])
def test_the_session_spans_cover_the_idle_time_inside_predict(card, cell):
    from benchmark.drivers.serve_open_loop import Server

    _, conf, work = _files(cell)
    server = Server(runner.Cell(cell, conf, work, SEED, 1.0, True, card, time.perf_counter()))
    st = profile_stretch(lambda: server.session.predict(server.scans[0]), 3)
    predict = union([(s, e) for n, s, e in st.host if n == "session.predict"])
    assert len(predict) == 3
    idle = _minus(predict, union([(s, e) for _, s, e in st.device]))
    named = union([(s, e) for n, s, e in st.host if n in SESSION])
    uncovered = _minus(idle, named)
    assert _length(uncovered) <= 0.1 * _length(idle), (_length(uncovered), _length(idle))
    gaps = dict(st.idle_gaps(top=1000))
    assert gaps.get("bench.unit", 0.0) < 0.1 * 1e-6 * _length(idle), gaps


@pytest.mark.card
def test_kernel1_plan_counters_add_up_to_its_launches(card):
    from benchmark.core import data
    from benchmark.drivers import train_steps
    from supernet_tpu_torch import tracing

    _, conf, _ = _files("brats-train-b20")
    gen = data.generator(SEED, card)
    weights = data.he_weights(conf["model"], gen, card)
    pool = train_steps.make_pool(conf["model"], 2, 1, gen, card)
    tracing.reset()
    train_steps.first_steps(conf, weights, pool, card)
    c = tracing.counters()
    paths = sum(v for k, v in c.items() if k.startswith("kernel1.path."))
    assert paths == c["vdp_conv.launches"] + c["vdp_conv.dgrad_launches"] > 0
    assert c["vdp_conv.reduce_launches"] + c["vdp_conv.dgrad_reduce_launches"] <= paths
