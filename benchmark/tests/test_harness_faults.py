"""A whole run on the CPU at a small size (the look for a card skipped),
with the timed path broken underneath, comes out not correct; unbroken it
comes out correct. The limits are the cells' own."""

import time

import pytest

from _tiny import SERVE, TRAIN, tiny
from benchmark.core import runner


def _run(cell, trace=False):
    man, conf, work = tiny(cell)
    return runner.execute(man, cell, conf, work, 2 ** 32 + 77, 0.4, trace, "cpu",
                          time.perf_counter())


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    from supernet_tpu_torch import train as T

    def no_update(state, tc):
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1

    monkeypatch.setattr(T, "_update", no_update)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_caught(cell, monkeypatch):
    from supernet_tpu_torch import train as T

    whole = T.training_loss

    def half(params, x, y, cfg, tc, x_range=None):
        n = x.shape[0] // 2
        return whole(params, x[:n], y[:n], cfg, tc, x_range)

    monkeypatch.setattr(T, "training_loss", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_made_is_caught(cell, monkeypatch):
    from supernet_tpu_torch.serving import InferenceSession

    made = InferenceSession._forward

    def altered(self, x):
        p, s = made(self, x)
        p = p.clone()
        p[0] = p[0].roll(1, dims=-1)  # one slice's classes rotated
        return p, s

    monkeypatch.setattr(InferenceSession, "_forward", altered)
    assert not _run(cell)["correct"]
