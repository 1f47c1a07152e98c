"""The frozen counts agree with the program's at both configurations."""

import pytest

from benchmark.core import counts
from benchmark.core import manifest as M


@pytest.mark.parametrize("name", ["hippocampus", "brats"])
def test_frozen_conv_count_matches_flops(name):
    from supernet_tpu_torch import configs, flops
    from supernet_tpu_torch.models import layer_names

    conf = M.config_by_name(name)
    cfg = configs.get_config(name).model
    assert counts.forward_flops_per_layer(conf["model"]) == flops.forward_flops_per_layer(cfg)
    assert [l[:4] for l in counts.layers(conf["model"])] == [tuple(l) for l in layer_names(cfg)]
    assert counts.layers(conf["model"])[-1][5] == conf["model"]["out_size"]


@pytest.mark.parametrize("name", ["hippocampus", "brats"])
def test_the_train_bound_exceeds_the_forward_bound(name):
    conf = M.config_by_name(name)
    ops, bw = counts.peaks("NVIDIA H100 80GB HBM3", "float32")
    assert ops == 495e12 and bw == 3.35e12
    fwd = counts.forward_conv_bound_s(conf["model"], ops, bw)
    assert 2 * fwd < counts.train_conv_bound_s(conf["model"], ops, bw) <= 3 * fwd + 1e-12


def test_peaks_follow_the_operands_and_the_card():
    assert counts.peaks("NVIDIA H100 80GB HBM3", "bfloat16")[0] == 989e12
    assert counts.peaks("NVIDIA H100 PCIe", "float32")[0] == 378e12
    assert counts.peaks("NVIDIA A100-SXM4-80GB", "float32") is None


def test_the_geometry_follows_the_model_block():
    model = dict(M.config_by_name("hippocampus")["model"])
    model.update(image_size=128, out_size=118)
    assert counts.layers(model)[-1][5] == 118
