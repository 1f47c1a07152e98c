"""On the card, the session's answers as ``predict`` hands them over
(supernet_tpu_torch/serving.py): in the pinned memory the device copies
wrote, never written after ``predict`` returns them, the bits of the copy
made over the budget, and a hand-over that copies nothing. At the
hippocampus model's size. ``card`` marks each test: it needs a CUDA card and
skips without one. This file imports no JAX, so it runs where only the port
is installed: ``python -m pytest tests/test_torch_serving_card.py -q
-p no:randomly``."""

import statistics

import numpy as np
import pytest
import torch

from supernet_tpu_torch import serving, tracing
from supernet_tpu_torch.configs import HIPPOCAMPUS
from supernet_tpu_torch.models import init_params

CFG = HIPPOCAMPUS.model


@pytest.fixture
def session():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = init_params(torch.Generator().manual_seed(0), CFG, "cuda")
    return serving.InferenceSession(params, CFG, batch_size=20, device="cuda").warmup()


def _scan(n, seed):
    s = CFG.image_size
    return np.random.default_rng(seed).normal(0, 1, (n, s, s, CFG.in_channels)).astype(np.float32)


@pytest.mark.card
def test_held_answers_are_pinned_and_keep_their_bits(session, monkeypatch):
    held = session.predict(_scan(45, 0))
    assert all(torch.from_numpy(a).is_pinned() for a in held)
    assert all(np.isfinite(a).all() for a in held)
    bits = [a.copy() for a in held]
    for k in range(10):
        later = session.predict(_scan(45, 1 + k))
        assert not any(np.shares_memory(a, h) for a in later for h in held)
        assert not np.array_equal(later[0], held[0])
    for a, b in zip(held, bits):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(serving, "ANSWER_BUDGET", 0)
    copied = session.predict(_scan(45, 0))
    for a, b in zip(copied, bits):
        np.testing.assert_array_equal(a, b)


@pytest.mark.card
def test_the_hand_over_takes_under_2_ms(session):
    """``session.stage_out`` of a 48-slice request under tracing: the
    median of ten requests after two that fill the allocator's cache."""
    for k in range(2):
        session.predict(_scan(48, k))
    tracing.enable()
    try:
        for k in range(10):
            session.predict(_scan(48, 2 + k))
        out = [(r["end_ns"] - r["start_ns"]) / 1e6 for r in tracing.records()
               if r["name"] == "session.stage_out"]
    finally:
        tracing.disable()
        tracing.reset()
    assert len(out) == 10
    assert statistics.median(out) < 2.0, out
