"""The readers of the program's spans and counters (``core/spans.py`` and the
six metrics that name it) on synthetic stretches, records and counters, and
on a program without the spans, where each finds nothing and returns None."""

import builtins
import time
from types import SimpleNamespace

import pytest

from _tiny import SERVE, TRAIN, tiny
from benchmark.core import manifest as M
from benchmark.core import runner
from benchmark.core.trace import Stretch

SERVING = ("predict_stage_ms.serve", "predict_stage_ms.scan")
DEVICE = ("backward_device_ms.train.brats", "update_device_ms.train.brats")
NEW = SERVING + ("chunk_fill.serve",) + DEVICE


def _read(name, ctx):
    return M.metric_module(name).read(ctx)


def _serving_stretch():
    """Two requests (bench.unit) at 0-100 and 200-300 us; the program's ranges
    inside them, and one stage range outside any unit that counts nowhere."""
    host = [("bench.unit", 0, 100), ("session.predict", 1, 99),
            ("session.stage_in", 2, 12), ("session.dispatch", 12, 40),
            ("session.wait", 40, 70), ("session.stage_out", 70, 98),
            ("bench.unit", 200, 300), ("session.predict", 201, 299),
            ("session.stage_in", 202, 222), ("session.dispatch", 222, 250),
            ("session.wait", 250, 260), ("session.stage_out", 260, 298),
            ("session.stage_in", 400, 900)]
    return Stretch(0, 300, 2, [("k", 20, 60)], host, [(0, 100), (200, 300)])


@pytest.mark.parametrize("name,want", [("predict_stage_ms.serve", 0.048),
                                       ("predict_stage_ms.scan", 0.048)])
def test_the_session_readers_take_the_median_over_the_requests(name, want):
    ctx = SimpleNamespace(kind="serve", stretch=_serving_stretch())
    # stage: 10 + 28 and 20 + 38 us, median 48
    assert _read(name, ctx) == pytest.approx(want)
    assert _read(name, SimpleNamespace(kind="train", stretch=_serving_stretch())) is None


@pytest.mark.parametrize("name", SERVING)
def test_the_session_readers_find_nothing_without_the_spans(name):
    st = _serving_stretch()
    st.host = [h for h in st.host if not h[0].startswith("session.")]
    assert _read(name, SimpleNamespace(kind="serve", stretch=st)) is None
    assert _read(name, SimpleNamespace(kind="serve", stretch=None)) is None


UNIX_NS = 1_790_000_000_000_000_000  # the profiler's time 0 on the records' clock


def _step_records(first_id, forward_us, times):
    """One step's records: its forward's host range (us on the profiler's
    clock, read a few us late as a record reads it) and its phases'
    CUDA-event times in ms."""
    fwd, bwd, upd = times
    out, root = [], first_id
    start, end = (UNIX_NS + int(1e3 * t) + 3000 for t in forward_us)
    for i, (name, ms) in enumerate((("train.forward", fwd), ("train.backward", bwd),
                                    ("train.update", upd), ("train.metrics", None))):
        out.append(dict(name=name, id=root + 1 + i, parent=root, root=root,
                        start_ns=start if i == 0 else end, end_ns=end, device_ms=ms))
    out.append(dict(name="train.step", id=root, parent=None, root=root, start_ns=start,
                    end_ns=end, device_ms=None))
    return out


def _training():
    """Two profiled steps (host forward ranges at 10-20 and 110-120 us) after
    a left-out one; their phases' CUDA-event times and the device's records.
    Step 1 starts on an idle device; in step 2 a record begun before the
    forward's range runs to 115 us, where the step's work starts."""
    host = [("bench.unit", 0, 100), ("train.forward", 10, 20), ("train.backward", 20, 60),
            ("train.update", 60, 70), ("bench.unit", 100, 200), ("train.forward", 110, 120),
            ("train.backward", 120, 150), ("train.update", 150, 170)]
    device = [("f", 12, 28), ("b", 32, 50), ("b", 55, 68), ("u", 71, 75), ("x", 100, 115),
              ("f", 116, 124), ("b", 126, 150), ("u", 156, 160), ("u", 170, 180)]
    recs = (_step_records(1, (-90_000, -70_000), (0.5, 0.5, 0.5))
            + _step_records(10, (10, 20), (0.020, 0.040, 0.010))
            + _step_records(20, (110, 120), (0.010, 0.030, 0.020)))
    return Stretch(0, 200, 2, device, host, [(0, 100), (100, 200)]), recs


@pytest.mark.parametrize("name,want", [("backward_device_ms.train.brats", 0.0275),
                                       ("update_device_ms.train.brats", 0.0065)])
def test_the_device_readers_take_the_busy_time_of_each_phase(name, want, monkeypatch):
    # step 1: forward 10-30, backward 30-70 (busy 32-50, 55-68: 31 us), update 70-80 (4 us);
    # step 2 from 115: forward to 125, backward to 155 (126-150: 24 us), update to 175
    # (156-160 and 170-175: 9 us)
    from supernet_tpu_torch import tracing

    stretch, recs = _training()
    monkeypatch.setattr(tracing, "records", lambda: recs)
    assert _read(name, SimpleNamespace(kind="train", stretch=stretch)) == pytest.approx(want)
    assert _read(name, SimpleNamespace(kind="serve", stretch=stretch)) is None
    stretch.units = 3  # more profiled steps than forward ranges
    assert _read(name, SimpleNamespace(kind="train", stretch=stretch)) is None
    stretch, _ = _training()
    bare = [dict(r, device_ms=None) for r in recs]  # on the CPU: no device time
    monkeypatch.setattr(tracing, "records", lambda: bare)
    assert _read(name, SimpleNamespace(kind="train", stretch=stretch)) is None
    monkeypatch.setattr(tracing, "records", lambda: [])  # a program without the spans
    assert _read(name, SimpleNamespace(kind="train", stretch=stretch)) is None


@pytest.mark.parametrize("name,want", [("backward_device_ms.train.brats", 0.0275),
                                       ("update_device_ms.train.brats", 0.0065)])
def test_the_device_readers_take_the_profiled_steps_by_their_clock(name, want, monkeypatch):
    """Steps recorded after the stretch (tracing on outside the profiler) do
    not stand in for the profiled ones, a lag common to every start does not
    matter, and records off the stretch's ranges read nothing."""
    from supernet_tpu_torch import tracing

    stretch, recs = _training()
    later = recs + _step_records(30, (50_000, 50_004), (0.9, 0.9, 0.9))
    later += _step_records(40, (90_000, 90_006), (0.9, 0.9, 0.9))
    monkeypatch.setattr(tracing, "records", lambda: later)
    assert _read(name, SimpleNamespace(kind="train", stretch=stretch)) == pytest.approx(want)
    # every start read later than every end by the same lag: one offset each
    lagged = [dict(r, start_ns=r["start_ns"] + 700_000) for r in later]
    monkeypatch.setattr(tracing, "records", lambda: lagged)
    assert _read(name, SimpleNamespace(kind="train", stretch=stretch)) == pytest.approx(want)
    shifted = [dict(r, start_ns=r["start_ns"] + 20_000_000 * (r["root"] == 20)) for r in recs]
    monkeypatch.setattr(tracing, "records", lambda: shifted)
    assert _read(name, SimpleNamespace(kind="train", stretch=stretch)) is None


def test_chunk_fill_is_the_share_of_real_slices(monkeypatch):
    from supernet_tpu_torch import tracing

    name = "chunk_fill.serve"
    monkeypatch.setattr(tracing, "counters", lambda: {"session.slices": 155,
                                                      "session.slices_computed": 160})
    assert _read(name, SimpleNamespace(kind="serve", stretch=None)) == pytest.approx(96.875)
    assert _read(name, SimpleNamespace(kind="train", stretch=None)) is None
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert _read(name, SimpleNamespace(kind="serve", stretch=None)) is None


@pytest.mark.parametrize("name", ("chunk_fill.serve",) + DEVICE)
def test_a_program_without_the_tracing_module_gives_none(name, monkeypatch):
    real = builtins.__import__

    def no_tracing(mod, globals=None, locals=None, fromlist=(), level=0):
        if mod == "supernet_tpu_torch" and "tracing" in (fromlist or ()):
            raise ImportError("cannot import name 'tracing'")
        return real(mod, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    kind = "serve" if name.endswith(".serve") else "train"
    assert _read(name, SimpleNamespace(kind=kind, stretch=_training()[0])) is None


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_traced_cpu_run_reports_what_the_cpu_can_read(cell):
    """At the tiny size on the CPU: the session's spans and counters are read
    in the serving cells; the training phases have no device records there."""
    man, conf, work = tiny(cell)
    result = runner.execute(man, cell, conf, work, 2 ** 32 + 5, 0.3, True, "cpu",
                            time.perf_counter())
    mine = {m["name"] for m in M.per_layer_of(man, cell)} & set(NEW)
    cpu = mine - set(DEVICE)
    assert cpu <= set(result["metrics"]) and not set(DEVICE) & set(result["metrics"])
    for name in cpu:
        assert result["metrics"][name]["value"] > 0
    if "chunk_fill.serve" in cpu:
        assert 0 < result["metrics"]["chunk_fill.serve"]["value"] <= 100
