"""On the card, the session's answers as ``predict`` hands them over
(supernet_tpu_torch/serving.py): in the pinned memory the device copies
wrote, never written after ``predict`` returns them, the bits of the copy
made over the budget, and a hand-over that copies nothing, at the
hippocampus model's size; and a BraTS scan of 155 slices at chunk 20, each
chunk copied into the pinned input buffer just before its dispatch: the
chunk-by-chunk forward's bits, no row written while its copy to the card is
in flight, and the card computing while the host copies. ``card`` marks
each test: it needs a CUDA card and skips without one. This file imports no
JAX, so it runs where only the port is installed: ``python -m pytest
tests/test_torch_serving_card.py -q -p no:randomly``."""

import math
import statistics
import threading

import numpy as np
import pytest
import torch

from supernet_tpu_torch import serving, tracing
from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS
from supernet_tpu_torch.models import init_params

CFG = HIPPOCAMPUS.model


@pytest.fixture
def session():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = init_params(torch.Generator().manual_seed(0), CFG, "cuda")
    return serving.InferenceSession(params, CFG, batch_size=20, device="cuda").warmup()


@pytest.fixture(scope="module")
def brats():
    """A BraTS session at chunk 20, its ``w_mu`` rescaled to He scale (at
    the raw init the logits reach 7.6e4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = init_params(torch.Generator().manual_seed(1), BRATS.model, "cpu")
    for p in params.values():
        k, _, cin, _ = p["w_mu"].shape
        p["w_mu"] *= math.sqrt(2.0 / (k * k * cin)) / p["w_mu"].std()
    return serving.InferenceSession(params, BRATS.model, batch_size=20,
                                    device="cuda").warmup()


def _scan(n, seed, cfg=CFG):
    s = cfg.image_size
    return np.random.default_rng(seed).normal(0, 1, (n, s, s, cfg.in_channels)).astype(np.float32)


def _chunk_by_chunk(session, x):
    """``x``'s answers with each chunk, the last padded with its final
    slice, sent through the session's forward alone and brought back."""
    bs = session.batch_size
    outs = [], []
    with torch.inference_mode():
        for i in range(0, len(x), bs):
            chunk = x[i : i + bs]
            b = len(chunk)
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - b, axis=0)])
            for out, a in zip(outs, session._forward(torch.from_numpy(chunk).to("cuda"))):
                out.append(a[:b].cpu().numpy())
    return tuple(np.concatenate(o) for o in outs)


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


@pytest.mark.card
def test_a_scan_staged_chunk_by_chunk_has_the_chunk_by_chunk_bits(brats):
    x = _scan(155, 2, BRATS.model)
    got = brats.predict(x)
    assert all(np.isfinite(a).all() for a in got)
    for g, w in zip(got, _chunk_by_chunk(brats, x)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.card
def test_back_to_back_scans_each_keep_their_own_bits(brats):
    """Two scans of 155 and 142 slices served alone, then back to back from
    two threads, three times each: every answer has the bits of its scan
    served alone, so no request wrote a row of the input buffer whose copy
    to the card was still in flight."""
    scans = [_scan(155, 3, BRATS.model), _scan(142, 4, BRATS.model)]
    alone = [tuple(a.copy() for a in brats.predict(x)) for x in scans]
    answers = [[], []]

    def serve(k):
        for _ in range(3):
            answers[k].append(brats.predict(scans[k]))

    threads = [threading.Thread(target=serve, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for want, got in zip(alone, answers):
        assert len(got) == 3
        for answer in got:
            for g, w in zip(answer, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.card
def test_the_card_computes_while_the_host_copies_the_later_chunks(brats):
    """Under the profiler, the first chunk's first operation on the device
    starts before the request's last ``session.stage_chunk`` range ends (the
    last request of three: the trace may lose the first kernels' records)."""
    x = _scan(155, 5, BRATS.model)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        brats.predict(x)
        prof.step()
        for _ in range(2):
            brats.predict(x)
    cuda = torch.autograd.DeviceType.CUDA
    host = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type != cuda]
    names = {n for n, _, _ in host}
    device = sorted(e.time_range.start for e in prof.events()
                    if e.device_type == cuda and e.name not in names
                    and not getattr(e, "is_user_annotation", False))
    a, b = max((s, e) for n, s, e in host if n == "session.predict")
    staged = [e for n, s, e in host if n == "session.stage_chunk" and a <= s and e <= b]
    assert len(staged) == 7
    first = next(s for s in device if s >= a)
    assert first < max(staged), (first, max(staged))
