"""The control (the reference with TF32 on, the nearest precision below the
configurations' float32) comes out not correct against the cells' limits, on
the card, at sizes a test run holds: three seeds each, the training cells'
first three steps at batch 4 and the serving cells' numbers over one scan."""

import pytest
import torch

from _tiny import SERVE, TRAIN
from benchmark.core import compare, data
from benchmark.core import manifest as M
from benchmark.reference import arithmetic

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def _cell(name):
    man = M.load_manifest()
    work = M.workload_file(name)
    conf = M.config_file(M.config_entry(man, M.cell(man, name)["config"]))
    return conf, work, M.driver(work["driver"])


@pytest.mark.card
@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_training_control_fails(card, name, seed):
    conf, work, drv = _cell(name)
    gen = data.generator(seed, card)
    weights = data.he_weights(conf["model"], gen, card)
    pool = drv.make_pool(conf["model"], 4, 3, gen, card)
    ref = drv.reference_readings(weights, pool, conf["model"], conf["train"])
    control = drv.reference_readings(weights, pool, conf["model"], conf["train"], tf32=True)
    assert not compare.judge(compare.train_numbers(control, ref), work["limits"])


@pytest.mark.card
@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_serving_control_fails(card, name, seed):
    conf, work, _ = _cell(name)
    drv = M.driver("serve_open_loop")  # the reference's forward and blocks
    model, chunk = conf["model"], work["params"]["chunk"]
    gen = data.generator(seed, card)
    weights = data.he_weights(model, gen, card)
    scan = data.images(model, 2 * chunk, gen, card)[0].cpu().numpy()
    with torch.no_grad(), arithmetic(tf32=True):
        p, s = drv.reference_forward(weights, torch.from_numpy(scan).to(card), model)
    o, c = model["out_size"], model["n_classes"]
    answer = (p.reshape(-1, o, o, c).cpu().numpy(), s.reshape(-1, o, o, c).cpu().numpy())
    numbers = drv.reference_gaps(weights, [scan], [answer], model, chunk, card).numbers()
    assert not compare.judge(numbers, work["limits"])
