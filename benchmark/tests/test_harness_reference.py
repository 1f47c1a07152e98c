"""The plain reference agrees with the port's CPU path at a small size:
``probs`` and ``sigma``, the loss, and the parameters after one step, at both
configurations' layer structure (base 4 kernels)."""

import copy

import pytest
import torch

from benchmark.core import compare, data
from benchmark.core import manifest as M
from benchmark.reference import vdp_unet


def _setup(name, seed=2 ** 32 + 3, batch=2):
    from benchmark.core import program

    conf = copy.deepcopy(M.config_by_name(name))
    conf["model"]["base_kernels"] = 4
    program.set_precision(conf)
    gen = data.generator(seed, "cpu")
    weights = data.he_weights(conf["model"], gen, "cpu")
    x, y = data.images(conf["model"], batch, gen, "cpu")
    return conf, program.model_config(conf), program.train_config(conf), weights, x, \
        data.center_crop(y, conf["model"]["out_size"]).contiguous()


@pytest.mark.parametrize("name", ["hippocampus", "brats"])
def test_forward_agrees(name):
    from supernet_tpu_torch.models import forward

    conf, mc, _, weights, x, _ = _setup(name)
    with torch.no_grad():
        p, s = forward(weights, x, mc)
        pr, sr = vdp_unet.forward(weights, x, conf["model"])
    assert p.shape == pr.shape == (2, conf["model"]["out_size"] ** 2, conf["model"]["n_classes"])
    assert (p - pr).abs().max() < 1e-5
    # sigma is discontinuous where a ReLU's mu lies within rounding of 0 (its
    # sigma passes or not), so a few pixels may part; the rest agree
    gap = (s - sr).abs() / sr.abs().clamp_min(sr.abs().median())
    assert gap.mean() < 1e-5 and (gap > 1e-3).float().mean() < 1e-4


@pytest.mark.parametrize("name", ["hippocampus", "brats"])
def test_loss_gradient_and_one_step_agree(name):
    from supernet_tpu_torch import train as T

    drv = M.driver("train_steps")
    conf, mc, tc, weights, x, y = _setup(name)
    state, _ = T.create_train_state(weights, tc, "cpu")
    state, m = T.make_train_step(mc, tc)(state, x, y)
    prog = compare.TrainReadings([float(m.loss)], drv.first_gradient(state),
                                 drv.changes(state, weights))
    ref = drv.reference_readings(weights, [(x, y)], conf["model"], conf["train"], steps=1)
    numbers = compare.train_numbers(prog, ref)
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_norm_gap"] < 1e-5, numbers
    assert numbers["update_norm_gap"] < 1e-4, numbers


def test_the_upsample_places_values_at_odd_indices():
    t = torch.arange(4.0).view(1, 1, 2, 2)
    u = vdp_unet.upsample(t)
    assert u.shape == (1, 1, 5, 5) and u[0, 0, 1::2, 1::2].equal(t[0, 0])
    assert u.sum() == t.sum()


def test_the_pool_keeps_sigma_at_the_first_maximal_tap():
    mu = torch.tensor([[[[1.0, 3.0, 0.0], [3.0, 2.0, 5.0], [0.0, 0.0, 0.0]]]])
    sigma = torch.arange(9.0).view(1, 1, 3, 3)
    m, s = vdp_unet.maxpool(mu, sigma)
    assert m.flatten().tolist() == [3.0, 5.0, 0.0, 0.0]
    assert s.flatten().tolist() == [1.0, 5.0, 6.0, 8.0]
