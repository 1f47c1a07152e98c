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
