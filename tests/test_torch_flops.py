"""The port's FLOP and byte counts (``supernet_tpu_torch/flops.py``) equal
the JAX package's (``supernet_tpu/flops.py``) at every config: the same
formulas over the same geometry, read here from a forward's stage taps and
there from ``jax.eval_shape``. Integers below 2^53: exact."""

import pytest

torch = pytest.importorskip("torch")

from supernet_tpu import configs as jconfigs  # noqa: E402
from supernet_tpu import flops as jflops  # noqa: E402
from supernet_tpu_torch import configs, flops  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["hippocampus", "brats", "lungs"])
def test_counts_equal_the_reference(name):
    cfg, jcfg = configs.get_config(name).model, jconfigs.get_config(name).model
    per_layer = flops.forward_flops_per_layer(cfg)
    assert per_layer == jflops.forward_flops_per_layer(jcfg)
    assert list(per_layer) == [n for n, _ in jflops._conv_shapes(jcfg)]
    for batch in (1, 3):
        assert flops.forward_flops(cfg, batch) == jflops.forward_flops(jcfg, batch)
        assert flops.train_step_flops(cfg, batch) == jflops.train_step_flops(jcfg, batch)
        for act_bytes in (2, 4):
            assert flops.forward_act_bytes(cfg, batch, act_bytes) == \
                jflops.forward_act_bytes(jcfg, batch, act_bytes)
            assert flops.train_step_min_bytes(cfg, batch, act_bytes) == \
                jflops.train_step_min_bytes(jcfg, batch, act_bytes)
    assert flops.forward_act_bytes(cfg) == jflops.forward_act_bytes(jcfg)
    for dtype_bytes in (2, 4):
        assert flops.param_bytes(cfg, dtype_bytes) == jflops.param_bytes(jcfg, dtype_bytes)


def test_remat_does_not_change_the_counts():
    import dataclasses

    cfg = configs.BRATS.model
    assert flops.forward_flops(dataclasses.replace(cfg, remat=True)) == flops.forward_flops(cfg)


@pytest.mark.parametrize("name,tflops,gbps", [
    ("NVIDIA H100 80GB HBM3", 989.0, 3350.0),
    ("NVIDIA H100 PCIe", 756.5, 2000.0),
    ("NVIDIA H100 NVL", 835.5, 3900.0),
    ("NVIDIA H200", 989.0, 4800.0),
    ("NVIDIA H200 NVL", 835.5, 4800.0),
    ("NVIDIA A100-SXM4-80GB", 0.0, 0.0),  # no row: unavailable, never wrong
])
def test_peaks_by_device_name(monkeypatch, name, tflops, gbps):
    """The bf16 dense peak and the HBM peak looked up by a substring of the
    card's name (``torch.cuda.get_device_name``); an unknown card reads 0.0
    and so do ``mfu`` and ``hbm_utilization``."""
    for var in ("SUPERNET_TPU_PEAK_TFLOPS", "SUPERNET_TPU_PEAK_HBM_GBPS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    for device in (None, "cuda", 0, torch.device("cuda", 0)):
        assert flops.peak_tflops(device) == tflops
        assert flops.peak_hbm_gbps(device) == gbps
    assert flops.mfu(tflops * 0.25e12) == (0.25 if tflops else 0.0)
    assert flops.hbm_utilization(gbps * 0.5e9) == (0.5 if gbps else 0.0)


def test_peaks_on_the_cpu_read_zero(monkeypatch):
    for var in ("SUPERNET_TPU_PEAK_TFLOPS", "SUPERNET_TPU_PEAK_HBM_GBPS"):
        monkeypatch.delenv(var, raising=False)
    for device in ("cpu", torch.device("cpu")):
        assert flops.peak_tflops(device) == 0.0 and flops.peak_hbm_gbps(device) == 0.0
        assert flops.mfu(1e15, device) == 0.0 and flops.hbm_utilization(1e12, device) == 0.0
    if not torch.cuda.is_available():
        assert flops.peak_tflops() == 0.0 and flops.peak_hbm_gbps() == 0.0


def test_env_overrides_and_utilizations_equal_jax(monkeypatch):
    """``SUPERNET_TPU_PEAK_TFLOPS`` / ``_HBM_GBPS`` override the table on
    any device, and with the same override on both sides ``mfu`` and
    ``hbm_utilization`` equal the JAX package's."""
    monkeypatch.setenv("SUPERNET_TPU_PEAK_TFLOPS", "123.5")
    monkeypatch.setenv("SUPERNET_TPU_PEAK_HBM_GBPS", "2048")
    assert flops.peak_tflops("cpu") == 123.5 and flops.peak_hbm_gbps("cpu") == 2048.0
    assert flops.peak_tflops() == jflops.peak_tflops()
    assert flops.peak_hbm_gbps() == jflops.peak_hbm_gbps()
    for rate in (0.0, 3.7e13, 9.9e14):
        assert flops.mfu(rate, "cpu") == pytest.approx(jflops.mfu(rate), rel=1e-15)
        assert flops.hbm_utilization(rate / 100, "cpu") == pytest.approx(
            jflops.hbm_utilization(rate / 100), rel=1e-15)
