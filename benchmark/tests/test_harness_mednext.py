"""The mednext configuration's files: its counts against the port's and a
direct count, the configuration against the port's experiment, the
harness's weights against the port's layout, the readers of its spans, and
a whole run of its training cell on the CPU at a small size (``n_channels``
4, one block a stage, a 16^3 cube): sound, it comes out correct; with the
depthwise convs' window-sum term left out in the program, with a step that
leaves the state unchanged, or with half of each batch left out, not
correct. The limits are the cell's own."""

import copy
import time

import pytest

from benchmark.core import counts_mednext3d, runner
from benchmark.core import manifest as M

CELL = "mednext-train-b2"
LIMITS = M.workload_file(CELL)["limits"]
METRICS = ("step_mfu.train.mednext", "dwconv_roofline.train.mednext",
           "recompute_device_ms.train.mednext", "backward_device_ms.train.mednext",
           "device_idle.train.mednext", "device_ops_per_step.train.mednext")


def _small():
    man = M.load_manifest()
    conf = copy.deepcopy(M.config_file(M.config_entry(man, "mednext")))
    conf["model"].update(image_size=16, out_size=16, n_channels=4, block_counts=[1] * 9)
    work = copy.deepcopy(M.workload_file(CELL))
    work["params"].update(pool_batches=3, trace_steps=2)
    return man, conf, work


def test_the_cell_its_configuration_and_its_metrics_are_found():
    man = M.load_manifest()
    entry = M.cell(man, CELL)
    assert entry["config"] == "mednext" and entry["chips"] == 1
    assert M.config_entry(man, "mednext")["reduced"] == []
    assert [m["name"] for m in M.end_to_end_of(man, CELL)] == [
        "train_samples_per_s.brats", "setup_s"]
    assert sorted(m["name"] for m in M.per_layer_of(man, CELL)) == sorted(METRICS)
    for name in METRICS:
        mod = M.metric_module(name)
        row = next(m for m in man["per_layer"] if m["name"] == name)
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            row["layer"], row["unit"], row["source"], row["moves"])
    work = M.workload_file(CELL)
    assert work["driver"] == "train_steps_mednext3d"
    assert work["params"] == {"batch": 2, "pool_batches": 8, "trace_steps": 2}


def _direct_count(model):
    """The operations of one forward as PyTorch's flop counter sees the
    port's products at batch 1 (the 1^3 convs' matrix products, the
    depthwise convs' grouped ``conv3d`` and ``conv_transpose3d`` calls, the
    transposed ones on their input's grid), plus the one-tap window sum of
    every 1^3 conv, which is no product: 2 a voxel."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.core import data, data_mednext3d
    from supernet_tpu_torch.models import unet3d

    cfg = unet3d.PLANS3D["mednext"](**model)
    w = data_mednext3d.weights(model, data.generator(3, "cpu"), "cpu")
    s = model["image_size"]
    x = torch.randn((1, s, s, s, model["in_channels"]))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        unet3d.forward3d(w, x, cfg)
    window_sums = sum(2 * side ** 3 for _, k, _, _, side, kind in counts_mednext3d.layers(model)
                      if kind in ("input", "conv"))
    return counter.get_total_flops() + window_sums


def test_the_counts_are_the_ports_a_direct_count_and_the_published_totals():
    from supernet_tpu_torch import flops
    from supernet_tpu_torch.models import unet3d

    model = M.config_by_name("mednext")["model"]
    cfg = unet3d.MEDNEXT.model
    assert [l[:4] for l in counts_mednext3d.layers(model)] == unet3d.layer_names3d(cfg)
    assert counts_mednext3d.forward_flops(model) == flops.forward_flops3d(cfg)
    small = _small()[1]["model"]
    assert counts_mednext3d.forward_flops(small) == _direct_count(small)
    small_cfg = unet3d.PLANS3D["mednext"](**small)
    assert counts_mednext3d.forward_flops(small) == flops.forward_flops3d(small_cfg)
    assert len(counts_mednext3d.blocks(model)) == 62
    # 2.014 TFLOP a forward at 128^3, 0.106 of it in the depthwise convs,
    # which the bandwidth bounds at the card's peaks
    assert round(counts_mednext3d.forward_flops(model) / 1e12, 3) == 2.014
    dw = sum(v for n, v in counts_mednext3d.forward_flops_per_layer(model).items()
             if n.endswith("_dw"))
    assert round(dw / 1e12, 3) == 0.106
    nbytes = sum(counts_mednext3d.dwconv_bytes(model).values())
    bound = counts_mednext3d.dwconv_bound_s(model, 495e12, 3.35e12)
    assert bound == pytest.approx(nbytes / 3.35e12)


def test_the_configuration_is_the_ports_experiment():
    from supernet_tpu_torch.models import unet3d

    conf = M.config_by_name("mednext")
    assert conf["plan"] == "mednext" and conf["reduced"] == []
    cfg = unet3d.PLANS3D[conf["plan"]](**conf["model"])
    assert cfg == unet3d.MEDNEXT.model
    for k, v in conf["train"].items():
        assert getattr(unet3d.MEDNEXT.train, k) == v, k
    for key in ("vdp", "biases", "point_parameters", "norm_moments", "loss",
                "deep_supervision", "kernel_size", "weights", "weight_variance", "volumes",
                "remat"):
        assert key in conf["assumed"], key


def test_the_harness_weights_have_the_ports_layout():
    from benchmark.core import data, data_mednext3d
    from supernet_tpu_torch.models import mednext3d, unet3d

    _, conf, _ = _small()
    got = data_mednext3d.weights(conf["model"], data.generator(5, "cpu"), "cpu")
    cfg = unet3d.PLANS3D["mednext"](**conf["model"])
    want = mednext3d.param_shapes(cfg)
    assert list(got) == list(want)
    assert {n: {k: tuple(v.shape) for k, v in p.items()} for n, p in got.items()} == want
    assert float(got["enc0_block0_norm"]["gamma"].sum()) == 4.0
    assert float(got["out"]["w_sigma"].min()) >= conf["model"]["tight_sigma_min"]


def _run(trace=False):
    man, conf, work = _small()
    return runner.execute(man, CELL, conf, work, 2 ** 33 + 27, 0.3, trace, "cpu",
                          time.perf_counter())


def test_a_small_run_of_the_cell_is_correct():
    result = _run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == set(LIMITS)
    assert set(result["metrics"]) == {"train_samples_per_s.brats", "setup_s"}


def _one_step():
    """One profiled step: host ranges (us) forward 10-20, backward 20-60;
    device records at 12-18, 22-30 and 40-50. On the device the forward
    starts with its host range, at 10 us, and its CUDA events span 5 us,
    so the backward starts at 15. A dwconv span in the forward starts 5 us
    after it and lasts 4 (15-19: busy 15-18, 3 us). A block recomputed in
    the backward runs in autograd's thread: no parent, its own root, and
    its host interval (30-50 us) inside the backward's; its CUDA events
    span 10 us. A block in the forward is no recomputation."""
    from benchmark.core.trace import Stretch

    host = [("bench.unit", 0, 100), ("train.forward", 10, 20), ("train.backward", 20, 60),
            ("train.update", 60, 70)]
    device = [("a", 12, 18), ("b", 22, 30), ("c", 40, 50)]
    ns = 1_790_000_000_000_000_000

    def rec(name, i, parent, host_us, ms=None, off=None, root=1):
        return dict(name=name, id=i, parent=parent, root=root, start_ns=ns + 1000 * host_us[0],
                    end_ns=ns + 1000 * host_us[1], device_ms=ms, device_start_ms=off)

    recs = [rec("mednext.dwconv", 5, 4, (13, 14), 0.004, 0.005),
            rec("mednext.block", 4, 2, (12, 18), 0.010, 0.003),
            rec("mednext.block", 6, None, (30, 50), 0.010, 0.0, root=6),
            rec("train.forward", 2, 1, (10, 20), 0.005, 0.0),
            rec("train.backward", 3, 1, (20, 60), 0.030, 0.0),
            rec("train.step", 1, None, (0, 100))]
    return Stretch(0, 100, 1, device, host, [(0, 100)]), recs


def test_the_span_readers_take_the_busy_time_inside_each_span(monkeypatch):
    from types import SimpleNamespace

    from supernet_tpu_torch import tracing

    stretch, recs = _one_step()
    monkeypatch.setattr(tracing, "records", lambda: recs)
    model = _small()[1]["model"]
    ctx = SimpleNamespace(kind="train", stretch=stretch, model=model, peaks=(495e12, 3.35e12),
                          stretch_samples=2)
    recompute = M.metric_module("recompute_device_ms.train.mednext").read(ctx)
    assert recompute == pytest.approx(0.010)
    roof = M.metric_module("dwconv_roofline.train.mednext").read(ctx)
    bound = counts_mednext3d.dwconv_bound_s(model, 495e12, 3.35e12) * 2
    assert roof == pytest.approx(100.0 * bound / 3e-6)
    bare = [dict(r, device_start_ms=None, device_ms=None) for r in recs]  # no device times
    monkeypatch.setattr(tracing, "records", lambda: bare)
    assert M.metric_module("recompute_device_ms.train.mednext").read(ctx) is None
    assert M.metric_module("dwconv_roofline.train.mednext").read(ctx) is None
    forward_only = [r for r in recs if r["id"] != 6]  # nothing recomputed
    monkeypatch.setattr(tracing, "records", lambda: forward_only)
    assert M.metric_module("recompute_device_ms.train.mednext").read(ctx) is None


def test_the_window_sum_left_out_is_caught(monkeypatch):
    """The calibration's planted fault, in the program: the depthwise convs'
    variance without s sum_t (mu^2 + sigma)."""
    import torch

    from supernet_tpu_torch.ops import moments3d

    whole = moments3d._dw_moments

    def fault(mu, sigma, w_mu, w_sigma, stride, transposed):
        return whole(mu, sigma, w_mu, torch.full_like(w_sigma, -1e4), stride, transposed)

    monkeypatch.setattr(moments3d, "_dw_moments", fault)
    result = _run()
    assert not result["correct"], result["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from supernet_tpu_torch import train3d

    def no_update(state, tc):
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1

    monkeypatch.setattr(train3d, "_update", no_update)
    result = _run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["update_norm_gap"]["value"] > LIMITS["update_norm_gap"]


def test_half_the_batch_left_out_is_caught():
    """``calibrate_mednext3d.py``'s second fault, in the program: each step
    trains on the first of its two volumes alone, so the first loss is that
    volume's, and the gradient and Adam's update lose the other's part."""
    from benchmark import calibrate_mednext3d
    from supernet_tpu_torch import train3d

    whole = train3d._loss3d
    with calibrate_mednext3d.half_batch_left_out():
        result = _run()
    assert train3d._loss3d is whole  # restored
    assert not result["correct"], result["checks"]


def test_the_calibrations_planted_fault_changes_the_reference():
    """``calibrate_mednext3d.py``'s fault: the reference's depthwise convs
    without the window-sum term; its means unchanged."""
    import torch

    from benchmark import calibrate_mednext3d
    from benchmark.core import data, data_mednext3d
    from benchmark.reference import mednext3d as reference

    _, conf, _ = _small()
    model = conf["model"]
    gen = data.generator(7, "cpu")
    w = data_mednext3d.weights(model, gen, "cpu")
    x = torch.randn((1, 16, 16, 16, 4), generator=gen)
    with torch.no_grad():
        p, s = reference.forward(w, x, model)
        with calibrate_mednext3d.window_sum_left_out(reference):
            p_f, s_f = reference.forward(w, x, model)
        p_again, _ = reference.forward(w, x, model)
    assert torch.equal(p, p_again)  # restored
    assert float((p - p_f).abs().max()) < 1e-5
    # sigma is 0 where the class softmax saturates: each gap over the larger
    # of sigma and its median
    assert float(((s - s_f).abs() / s.abs().clamp_min(float(s.median()))).median()) > 1e-3
