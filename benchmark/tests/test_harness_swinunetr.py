"""The swinunetr configuration's files: its counts against the port's, the
configuration against the port's experiment, the readers of its spans, and
a whole run of its training cell on the CPU at a small size (feature size
12, windows of 3 on a 32^3 cube): sound, it comes out correct; with part
of the attention's variance left out in the program, not correct. The
limits are the cell's own."""

import copy
import time

import pytest

from benchmark.core import counts_swin3d, runner
from benchmark.core import manifest as M

CELL = "swinunetr-train-b1"
LIMITS = M.workload_file(CELL)["limits"]
METRICS = ("step_mfu.train.swinunetr", "attention_roofline.train.swinunetr",
           "swin_encoder_device_ms.train.swinunetr", "cnn_device_ms.train.swinunetr",
           "backward_device_ms.train.swinunetr", "device_idle.train.swinunetr",
           "device_ops_per_step.train.swinunetr")


def _small():
    man = M.load_manifest()
    conf = copy.deepcopy(M.config_file(M.config_entry(man, "swinunetr")))
    conf["model"].update(image_size=32, out_size=32, feature_size=12, window_size=3)
    work = copy.deepcopy(M.workload_file(CELL))
    work["params"].update(pool_batches=3, trace_steps=2)
    return man, conf, work


def test_the_cell_its_configuration_and_its_metrics_are_found():
    man = M.load_manifest()
    entry = M.cell(man, CELL)
    assert entry["config"] == "swinunetr" and entry["chips"] == 1
    assert M.config_entry(man, "swinunetr")["reduced"] == []
    assert [m["name"] for m in M.end_to_end_of(man, CELL)] == [
        "train_samples_per_s.brats", "setup_s"]
    assert sorted(m["name"] for m in M.per_layer_of(man, CELL)) == sorted(METRICS)
    for name in METRICS:
        mod = M.metric_module(name)
        row = next(m for m in man["per_layer"] if m["name"] == name)
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            row["layer"], row["unit"], row["source"], row["moves"])
    assert M.workload_file(CELL)["driver"] == "train_steps_swin3d"


def test_the_counts_are_the_ports_and_the_published_totals():
    from supernet_tpu_torch import flops
    from supernet_tpu_torch.models import unet3d

    model = M.config_by_name("swinunetr")["model"]
    cfg = unet3d.SWINUNETR.model
    assert [l[:4] for l in counts_swin3d.layers(model)] == unet3d.layer_names3d(cfg)
    assert counts_swin3d.forward_flops(model) == flops.forward_flops3d(cfg)
    # 2320 windows a forward at 128^3 (1000, 125, 27, 8 per block, two blocks
    # a stage), 3.114 TFLOP a forward, 0.241 TFLOP of it in the attention spans
    assert sum(b[5] for b in counts_swin3d.attention_blocks(model)) == 2320
    assert round(counts_swin3d.forward_flops(model) / 1e12, 3) == 3.114
    assert round(sum(counts_swin3d.attention_flops(model).values()) / 1e12, 3) == 0.241
    # the attention is bounded by its operations at the card's peaks
    bound = counts_swin3d.attention_bound_s(model, 495e12, 3.35e12)
    assert bound == pytest.approx(sum(counts_swin3d.attention_flops(model).values()) / 495e12)


def test_the_configuration_is_the_ports_experiment():
    from supernet_tpu_torch.models import unet3d

    conf = M.config_by_name("swinunetr")
    assert conf["plan"] == "swinunetr" and conf["reduced"] == []
    cfg = unet3d.PLANS3D[conf["plan"]](**conf["model"])
    assert cfg == unet3d.SWINUNETR.model
    for k, v in conf["train"].items():
        assert getattr(unet3d.SWINUNETR.train, k) == v, k


def test_the_harness_weights_have_the_ports_layout():
    import torch

    from benchmark.core import data, data_swin3d
    from supernet_tpu_torch.models import swin_unetr3d, unet3d

    _, conf, _ = _small()
    got = data_swin3d.weights(conf["model"], data.generator(5, "cpu"), "cpu")
    cfg = unet3d.PLANS3D["swinunetr"](**conf["model"])
    want = swin_unetr3d.param_shapes(cfg)
    assert list(got) == list(want)
    assert {n: {k: tuple(v.shape) for k, v in p.items()} for n, p in got.items()} == want
    assert float(got["stage0_block0_norm1"]["gamma"].sum()) == 12.0
    assert 0 < float(torch.std(got["stage0_block0_attn"]["bias_table"])) < 0.02


def _run(trace=False):
    man, conf, work = _small()
    return runner.execute(man, CELL, conf, work, 2 ** 33 + 11, 0.3, trace, "cpu",
                          time.perf_counter())


def test_a_small_run_of_the_cell_is_correct():
    result = _run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == set(LIMITS)
    assert set(result["metrics"]) == {"train_samples_per_s.brats", "setup_s"}


def _one_step(recomputed=False):
    """One profiled step: host ranges (us) forward 10-20, backward 20-60;
    device records at 12-18, 22-30 and 40-50; the forward's CUDA events
    span 40 us from 10 us, its two swin.attention spans start 10 and 28 us
    after it and last 10 and 4 us (busy 8 and 2 us). With ``recomputed`` a
    third span lies in the backward, where it does not count."""
    from benchmark.core.trace import Stretch

    host = [("bench.unit", 0, 100), ("train.forward", 10, 20), ("train.backward", 20, 60),
            ("train.update", 60, 70)]
    device = [("a", 12, 18), ("b", 22, 30), ("c", 40, 50)]
    ns = 1_790_000_000_000_000_000

    def rec(name, i, parent, ms=None, off=None):
        return dict(name=name, id=i, parent=parent, root=1, start_ns=ns, end_ns=ns + 1,
                    device_ms=ms, device_start_ms=off)

    recs = [rec("swin.attention", 5, 4, 0.010, 0.010), rec("swin.attention", 6, 4, 0.004, 0.028),
            rec("swin.encoder", 4, 2, 0.030, 0.005), rec("train.forward", 2, 1, 0.040, 0.0),
            rec("train.backward", 3, 1, 0.020, 0.040), rec("train.step", 1, None)]
    if recomputed:
        recs.insert(0, rec("swin.attention", 7, 3, 0.020, 0.040))
    return Stretch(0, 100, 1, device, host, [(0, 100)]), recs


@pytest.mark.parametrize("recomputed", [False, True])
def test_the_span_readers_take_the_busy_time_inside_each_span(recomputed, monkeypatch):
    from types import SimpleNamespace

    from supernet_tpu_torch import tracing

    stretch, recs = _one_step(recomputed)
    monkeypatch.setattr(tracing, "records", lambda: recs)
    model = _small()[1]["model"]
    ctx = SimpleNamespace(kind="train", stretch=stretch, model=model, peaks=(495e12, 3.35e12),
                          stretch_samples=1)
    read = M.metric_module("swin_encoder_device_ms.train.swinunetr").read
    assert read(ctx) == pytest.approx(0.016)  # 15-45 us: 15-18, 22-30 and 40-45
    attn = M.metric_module("attention_roofline.train.swinunetr").read(ctx)
    bound = counts_swin3d.attention_bound_s(model, 495e12, 3.35e12)
    assert attn == pytest.approx(100.0 * bound / 10e-6)
    assert M.metric_module("cnn_device_ms.train.swinunetr").read(ctx) is None
    bare = [dict(r, device_start_ms=None) for r in recs]  # a program before the offsets
    monkeypatch.setattr(tracing, "records", lambda: bare)
    assert read(ctx) is None


def test_the_attention_variance_left_out_is_caught(monkeypatch):
    """The calibration's planted fault, in the program: the scores carry no
    variance and the values' own variance alone passes the products."""
    import torch

    from supernet_tpu_torch.ops import moments_swin

    monkeypatch.setattr(moments_swin, "score_moments",
                        lambda qm, qs, km, ks: (qm @ km.transpose(-1, -2),
                                                torch.zeros_like(qm @ km.transpose(-1, -2))))
    monkeypatch.setattr(moments_swin, "value_moments",
                        lambda p, sp, vm, vs: (p @ vm, (p * p) @ vs))
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_calibrations_planted_fault_changes_the_reference():
    """``calibrate_swin3d.py``'s fault: the reference's attention without the
    scores' variance and with the values' own alone; its means unchanged."""
    import torch

    from benchmark import calibrate_swin3d
    from benchmark.core import data, data_swin3d
    from benchmark.reference import swin_unetr3d as reference

    _, conf, _ = _small()
    model = conf["model"]
    gen = data.generator(7, "cpu")
    w = data_swin3d.weights(model, gen, "cpu")
    x = torch.randn((1, 32, 32, 32, 4), generator=gen)
    with torch.no_grad():
        p, s = reference.forward(w, x, model)
        with calibrate_swin3d.attention_variance_left_out(reference):
            p_f, s_f = reference.forward(w, x, model)
        p_again, _ = reference.forward(w, x, model)
    assert torch.equal(p, p_again)  # restored
    assert float((p - p_f).abs().max()) < 1e-5
    assert float(((s - s_f).abs() / s.abs()).median()) > 1e-3
