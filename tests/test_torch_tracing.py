"""The port's spans and counters (supernet_tpu_torch/tracing.py): off costs
no range and leaves no record, on records the nesting and the root of each
request and step, under torch.profiler the ranges and the records agree, and
the session's and the train step's sites, on the CPU at a tiny size."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from supernet_tpu_torch import configs, serving, tracing, train
from supernet_tpu_torch.models import forward, init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                          base_kernels=4)
TC = configs.HIPPOCAMPUS.train
SESSION = ("session.predict", "session.stage_in", "session.dispatch", "session.wait",
           "session.stage_out")
STEP = ("train.step", "train.forward", "train.backward", "train.update", "train.metrics")
COUNTERS = ("session.requests", "session.slices", "session.slices_computed",
            "session.buffer_grows", "session.answers_in_place", "session.answers_copied",
            "session.chunks_overlapped")


@pytest.fixture(autouse=True)
def _clean():
    """Each test starts and ends with tracing off and nothing kept, on one
    intra-op thread (the test workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(5), CFG, "cpu")


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (n, 32, 32, 1)).astype(np.float32)


def _batch(n=2):
    y = torch.from_numpy(np.random.default_rng(1).integers(0, CFG.n_classes, (n, 22, 22)))
    return torch.from_numpy(_x(n)), y.to(torch.int32)


def _work(params):
    """A forward, a train step and a request."""
    x, y = _batch()
    with torch.no_grad():
        forward(params, x, CFG)
    state, _ = train.create_train_state(params, TC, "cpu")
    train.make_train_step(CFG, TC)(state, x, y)
    serving.InferenceSession(params, CFG, batch_size=4, device="cpu").predict(_x(7))


def test_off_opens_no_range_and_leaves_no_record(params, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert tracing.span("a") is tracing.span("b", device=True)  # one shared no-op
    _work(params)
    assert opened == [] and tracing.records() == []
    assert tracing.counters()["session.requests"] == 1  # counters are always on


def test_on_records_the_nesting_and_the_roots():
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.span("d"):
            pass
    with tracing.span("e"):
        pass
    recs = {r["name"]: r for r in tracing.records()}
    assert [r["name"] for r in tracing.records()] == ["c", "b", "d", "a", "e"]  # by exit
    a, e = recs["a"], recs["e"]
    assert a["parent"] is None and a["root"] == a["id"]
    assert recs["b"]["parent"] == a["id"] and recs["d"]["parent"] == a["id"]
    assert recs["c"]["parent"] == recs["b"]["id"]
    assert {recs[n]["root"] for n in "abcd"} == {a["id"]}
    assert e["root"] == e["id"] != a["id"]
    for r in recs.values():
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None
    assert a["start_ns"] <= recs["b"]["start_ns"] <= recs["c"]["end_ns"] <= a["end_ns"]


def test_the_buffer_keeps_the_last_records():
    tracing.enable()
    for _ in range(tracing.CAP + 10):
        with tracing.span("s"):
            pass
    recs = tracing.records()
    assert len(recs) == tracing.CAP
    assert recs[-1]["id"] - recs[0]["id"] == tracing.CAP - 1


def test_threads_keep_their_own_nesting():
    import threading

    tracing.enable()

    def work(tag):
        for _ in range(50):
            with tracing.span(f"{tag}.outer"):
                with tracing.span(f"{tag}.inner"):
                    pass

    threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = tracing.records()
    by_id = {r["id"]: r for r in recs}
    assert len(recs) == 4 * 2 * 50
    for r in recs:
        if r["name"].endswith(".inner"):
            outer = by_id[r["parent"]]
            assert outer["name"] == r["name"].replace("inner", "outer")
            assert r["root"] == outer["id"]


def _ranges(prof):
    """The profiler's host ranges by name, each (start_ns, end_ns) on the
    Unix clock, in order of start."""
    origin = prof.profiler.kineto_results.trace_start_ns()
    out = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name, []).append(
                (origin + 1e3 * e.time_range.start, origin + 1e3 * e.time_range.end))
    return out


def _disagreements(prof, recs):
    """(name, start gap, end gap) in ns of every record against the range of
    its name, matched in order of start; raises where the counts differ."""
    ranges = _ranges(prof)
    by_name = {}
    for r in sorted(recs, key=lambda r: r["start_ns"]):
        by_name.setdefault(r["name"], []).append(r)
    out = []
    for name, rs in by_name.items():
        assert len(ranges.get(name, [])) == len(rs), name
        out += [(name, r["start_ns"] - start, r["end_ns"] - end)
                for r, (start, end) in zip(rs, ranges[name])]
    return out


def test_under_the_profiler_every_span_is_a_range_on_the_same_clock(params):
    acts = [torch.profiler.ProfilerActivity.CPU]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    session = serving.InferenceSession(params, CFG, batch_size=4, device="cpu")
    # a reading is late by the time the thread took to come back from the
    # range's call: up to three tries, so that a descheduled thread on a
    # busy host is not read as a clock that disagrees
    for _ in range(3):
        tracing.reset()
        with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
            session.predict(_x(5))  # the profiler's warm-up phase: spans are off
            assert tracing.records() == []
            prof.step()
            with tracing.span("first.range"):  # the process's first range costs more
                pass
            tracing.reset()
            session.predict(_x(5))
            with tracing.span("outside.the.program"):
                pass
        recs = tracing.records()
        names = {r["name"] for r in recs}
        assert set(SESSION) <= names and {"conv1", "outside.the.program"} <= names
        gaps = _disagreements(prof, recs)
        assert len(gaps) == len(recs)
        worst = max(max(abs(a), abs(b)) for _, a, b in gaps)
        if worst < 50e3:
            break
    assert worst < 50e3, sorted(gaps, key=lambda g: -max(abs(g[1]), abs(g[2])))[:5]


def test_a_request_has_five_session_spans_under_one_root(params):
    session = serving.InferenceSession(params, CFG, batch_size=4, device="cpu")
    tracing.enable()
    before = tracing.counters()
    session.predict(_x(7))
    recs = tracing.records()
    chunks = [r for r in recs if r["name"] == "session.stage_chunk"]
    top = [r for r in recs if r["name"].startswith("session.") and r not in chunks]
    # stage_in twice: the conversion outside the session's lock, the first
    # chunk's copy in it
    assert sorted(r["name"] for r in top) == sorted(SESSION + ("session.stage_in",))
    root = next(r for r in top if r["name"] == "session.predict")
    assert root["parent"] is None and {r["root"] for r in recs} == {root["id"]}
    inner = sorted((r for r in top if r is not root), key=lambda r: r["start_ns"])
    assert tuple(r["name"] for r in inner) == SESSION[1:2] + SESSION[1:]
    assert all(r["parent"] == root["id"] for r in inner)
    dispatch = inner[2]
    assert inner[1]["end_ns"] <= dispatch["start_ns"]
    layers = [r for r in recs if not r["name"].startswith("session.")]
    assert layers and all(r["parent"] == dispatch["id"] for r in layers)
    conv1 = sorted((r for r in layers if r["name"] == "conv1"), key=lambda r: r["start_ns"])
    assert len(conv1) == 2  # one per chunk
    # the second chunk's copy, inside the dispatch, after the first chunk's
    # forward and before its own
    (chunk,) = chunks
    assert chunk["parent"] == dispatch["id"]
    assert dispatch["start_ns"] <= chunk["start_ns"] <= chunk["end_ns"] <= dispatch["end_ns"]
    assert conv1[0]["end_ns"] <= chunk["start_ns"] and chunk["end_ns"] <= conv1[1]["start_ns"]
    after = tracing.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}
    assert delta == {"session.requests": 1, "session.slices": 7,
                     "session.slices_computed": 8, "session.buffer_grows": 1,
                     "session.answers_in_place": 1, "session.answers_copied": 0,
                     "session.chunks_overlapped": 1}
    session.predict(_x(6))  # the input buffer holds it: no growth
    again = tracing.counters()
    assert again["session.buffer_grows"] == after["session.buffer_grows"]
    assert again["session.slices_computed"] - after["session.slices_computed"] == 8


def test_the_answer_counters_add_up_to_the_non_empty_requests(params, monkeypatch):
    """Every non-empty request is answered in place or, over the budget,
    copied; the empty request is neither."""
    session = serving.InferenceSession(params, CFG, batch_size=4, device="cpu")
    before = tracing.counters()
    held = [session.predict(_x(5)), session.predict(_x(0))]
    monkeypatch.setattr(serving, "ANSWER_BUDGET", 0)
    held += [session.predict(_x(3)), session.predict(_x(0)), session.predict(_x(2))]
    after = tracing.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}
    assert delta["session.requests"] == 5
    assert (delta["session.answers_in_place"], delta["session.answers_copied"]) == (1, 2)
    assert delta["session.answers_in_place"] + delta["session.answers_copied"] == sum(
        len(p) > 0 for p, _ in held)


def test_a_request_is_made_float32_outside_the_sessions_lock(params):
    session = serving.InferenceSession(params, CFG, batch_size=4, device="cpu")
    held = []

    class Lock:
        def __enter__(self):
            held.append(time.time_ns())

        def __exit__(self, *exc):
            held.append(time.time_ns())

    session._lock = Lock()
    tracing.enable()
    session.predict(_x(5).astype(np.float64))  # the conversion has work to do
    convert, copy = sorted((r for r in tracing.records() if r["name"] == "session.stage_in"),
                           key=lambda r: r["start_ns"])
    stage_out = next(r for r in tracing.records() if r["name"] == "session.stage_out")
    assert convert["end_ns"] <= held[0] <= copy["start_ns"]
    assert stage_out["end_ns"] <= held[1]


@pytest.mark.parametrize("k_steps", [1, 2])
def test_a_train_step_has_its_phase_spans(params, k_steps):
    x, y = _batch()
    state, _ = train.create_train_state(params, TC, "cpu")
    tracing.enable()
    if k_steps == 1:
        train.make_train_step(CFG, TC)(state, x, y)
    else:
        train.make_multi_train_step(CFG, TC, k_steps)(
            state, x.expand(k_steps, *x.shape), y.expand(k_steps, *y.shape))
    recs = tracing.records()
    roots = [r for r in recs if r["name"] == "train.step"]
    assert len(roots) == k_steps and all(r["parent"] is None for r in roots)
    for root in roots:
        phases = sorted((r for r in recs if r["parent"] == root["id"]),
                        key=lambda r: r["start_ns"])
        assert tuple(r["name"] for r in phases) == STEP[1:]
        assert all(r["device_ms"] is None for r in phases)  # no CUDA here
        fwd = phases[0]
        assert {r["parent"] for r in recs if r["name"].startswith("conv")} >= {fwd["id"]}


def test_the_trace_variable_writes_records_and_counters_at_exit(tmp_path):
    out = tmp_path / "trace.jsonl"
    code = textwrap.dedent("""
        from supernet_tpu_torch import tracing
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
        tracing.count("things", 3)
    """)
    env = dict(os.environ, SUPERNET_TRACE=str(out), PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    inner, outer, last = lines
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == outer["id"] == inner["root"]
    assert last["counters"]["things"] == 3 and last["counters"]["vdp_conv.launches"] == 0
    assert set(inner) == {"name", "id", "parent", "root", "start_ns", "end_ns", "device_ms"}


def test_a_3d_step_has_its_phase_spans_and_counts_its_moment_products():
    """``train3d``'s step under the 2-D step's five spans, and one count
    per k > 1 moment product of its forward (the Cicek plan at base 4,
    depth 3: ten 3^3 convs, the first without a variance product)."""
    from supernet_tpu_torch import train3d
    from supernet_tpu_torch.models import unet3d

    cfg = dataclasses.replace(unet3d.CICEK3D.model, image_size=44, out_size=4,
                              base_kernels=4, depth=3)
    params = unet3d.init_params3d(torch.Generator().manual_seed(2), cfg, "cpu")
    state, _ = train.create_train_state(params, unet3d.CICEK3D.train, "cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (1, 44, 44, 44, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (1, 4, 4, 4)).astype(np.int32))
    step = train3d.make_train_step3d(cfg, unet3d.CICEK3D.train)
    tracing.enable()
    step(state, x, y)
    recs = tracing.records()
    (root,) = [r for r in recs if r["name"] == "train.step"]
    phases = sorted((r for r in recs if r["parent"] == root["id"]), key=lambda r: r["start_ns"])
    assert tuple(r["name"] for r in phases) == STEP[1:]
    assert {r["parent"] for r in recs if r["name"].startswith("up")} == {phases[0]["id"]}
    products = 2 * sum(1 for _, k, _, _ in unet3d.layer_names3d(cfg) if k == 3) - 1
    assert products == 19
    assert tracing.counters()["moments3d.products.conv3d"] == products
