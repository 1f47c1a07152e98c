"""The cicek3d configuration's files: its counts against the port's, the
configuration against the port's experiment, and the whole of a run of its
training cell on the CPU at a small size (the plan's rules at base 4,
depth 3 on a 44^3 cube): sound, it comes out correct; with the 3-D step
broken underneath (``test_harness_faults.py``'s faults on ``train3d``), not
correct. The limits are the cell's own."""

import copy
import time

import pytest

from benchmark.core import counts3d, runner
from benchmark.core import manifest as M

CELL = "cicek3d-train-b2"
LIMITS = M.workload_file(CELL)["limits"]


def _small():
    man = M.load_manifest()
    conf = copy.deepcopy(M.config_file(M.config_entry(man, "cicek3d")))
    conf["model"].update(image_size=44, out_size=4, base_kernels=4, depth=3)
    work = copy.deepcopy(M.workload_file(CELL))
    work["params"].update(pool_batches=3, trace_steps=2)
    return man, conf, work


def test_the_counts_are_the_ports_and_the_published_totals():
    from supernet_tpu_torch import flops
    from supernet_tpu_torch.models import unet3d

    model = M.config_by_name("cicek3d")["model"]
    cfg = unet3d.CICEK3D.model
    assert [l[:4] for l in counts3d.layers(model)] == unet3d.layer_names3d(cfg)
    assert counts3d.layers(model)[-1][5] == model["out_size"] == 44
    assert counts3d.forward_flops(model) == flops.forward_flops3d(cfg)
    # 1.303 TFLOP a volume's forward, conv1 464 GFLOP of it; 3.898 TFLOP of
    # conv work a training step
    assert round(counts3d.forward_flops(model) / 1e12, 3) == 1.303
    assert round(counts3d.forward_flops_per_layer(model)["conv1"] / 1e9) == 464
    assert round(sum(counts3d.train_flops_per_layer(model).values()) / 1e12, 3) == 3.898
    bound = counts3d.train_conv_bound_s(model, 495e12, 3.35e12)
    assert 3.898e12 / 495e12 <= bound


def test_the_configuration_is_the_ports_experiment():
    from supernet_tpu_torch.models import unet3d

    conf = M.config_by_name("cicek3d")
    assert conf["plan"] == "cicek" and conf["reduced"] == []
    cfg = unet3d.PLANS3D[conf["plan"]](**conf["model"])
    assert cfg == unet3d.CICEK3D.model
    for k, v in conf["train"].items():
        assert getattr(unet3d.CICEK3D.train, k) == v, k


def _run(trace=False):
    man, conf, work = _small()
    return runner.execute(man, CELL, conf, work, 2 ** 33 + 7, 0.3, trace, "cpu",
                          time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_of_the_cell_is_correct(trace):
    result = _run(trace)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == set(LIMITS)
    if not trace:
        assert set(result["metrics"]) == {"train_samples_per_s.brats", "setup_s"}


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from supernet_tpu_torch import train3d

    def no_update(state, tc):
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1

    monkeypatch.setattr(train3d, "_update", no_update)
    result = _run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["update_norm_gap"]["value"] > LIMITS["update_norm_gap"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from supernet_tpu_torch import train3d

    whole = train3d._loss3d

    def half(params, x, y1h, cfg, tc, constrain=None):
        n = x.shape[0] // 2
        return whole(params, x[:n], y1h[:n], cfg, tc, constrain)

    monkeypatch.setattr(train3d, "_loss3d", half)
    result = _run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["first_loss_gap"]["value"] > LIMITS["first_loss_gap"]
