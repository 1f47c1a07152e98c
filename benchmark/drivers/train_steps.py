"""Closed-loop training: ``train.make_train_step`` called once per batch, as
``cli train`` runs at ``--steps-per-dispatch 1``.

Set-up makes the weights and a pool of ``pool_batches`` batches of
``batch`` synthetic images on the device from the seed, builds one train
state and drives it through its first three steps on pool batches 0, 1, 2
(losses fetched; Adam's first moment after step 1 and the parameters after
step 3 kept as norms). That state goes on into the window: the steps run on
the pool's batches in turn, with no synchronisation but what a step forces
and one at the end. ``train_samples_per_s`` is every image of every step
over the window's time, synchronisation included.

With ``--trace 1`` ``trace_steps`` more steps are profiled after the window.
Then the peak memory is read, the program's state is freed, and the
reference takes the first three steps from the same weights and batches.
"""

from __future__ import annotations

import time

import torch

from benchmark.core import compare, data, program
from benchmark.core.runner import Outcome, peaks_for
from benchmark.core.trace import profile_stretch
from benchmark.reference import arithmetic
from benchmark.reference.training import Reference

FIRST_STEPS = 3


def _norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _leaves(params) -> dict:
    return {f"{n}/{k}": v for n, p in params.items() for k, v in p.items()}


def first_gradient(state) -> dict:
    """The norm of every leaf's gradient as the optimizer took it in the
    first step, from Adam's first moment after that step (m_1 = (1 - beta1) g);
    0 for a leaf the optimizer holds no state for."""
    opt = state.opt_state
    beta1 = opt.defaults["betas"][0]
    out = {}
    for key, t in _leaves(state.params).items():
        m = opt.state.get(t, {}).get("exp_avg")
        out[key] = 0.0 if m is None else float(torch.linalg.vector_norm(m.double())) / (1 - beta1)
    return out


def changes(state, weights) -> dict:
    """The norm of every leaf's change from the initial weights."""
    w0 = _leaves(weights)
    return {k: float(torch.linalg.vector_norm((t.detach() - w0[k]).double()))
            for k, t in _leaves(state.params).items()}


def reference_readings(weights, pool, model, train, steps=FIRST_STEPS,
                       tf32=False, chunks=1) -> compare.TrainReadings:
    """The reference's numbers from the same weights and batches (with
    ``tf32`` its control's; ``chunks`` as ``Reference.step`` takes it)."""
    ref = Reference(weights, model, train)
    losses, grads = [], None
    with arithmetic(tf32):
        for i in range(steps):
            x, y = pool[i]
            value, clipped = ref.step(x, y, chunks)
            losses.append(value)
            if grads is None:
                grads = _norms(clipped)
    w0 = _leaves(weights)
    deltas = {k: float(torch.linalg.vector_norm((t.detach() - w0[k]).double()))
              for k, t in ref.leaves()}
    return compare.TrainReadings(losses, grads, deltas)


def make_pool(model, batch, count, gen, device):
    pool = []
    for _ in range(count):
        x, y = data.images(model, batch, gen, device)
        pool.append((x, data.center_crop(y, model["out_size"]).contiguous()))
    return pool


def first_steps(conf, weights, pool, device):
    """One train state and step of the program, driven through its first
    three steps on pool batches 0, 1, 2: ``(state, step, readings)``."""
    from supernet_tpu_torch import train as T

    program.set_precision(conf)
    mc, tc = program.model_config(conf), program.train_config(conf)
    state, _ = T.create_train_state(weights, tc, device)
    step = T.make_train_step(mc, tc)
    losses, grads = [], None
    for i in range(FIRST_STEPS):
        state, m = step(state, *pool[i % len(pool)])
        losses.append(float(m.loss))
        grads = grads or first_gradient(state)
    return state, step, compare.TrainReadings(losses, grads, changes(state, weights))


def run(cell) -> Outcome:
    conf, work, dev = cell.config, cell.work, cell.device
    model, tcfg = conf["model"], conf["train"]
    params = work["params"]
    batch = params["batch"]
    gen = data.generator(cell.seed, dev)
    weights = data.he_weights(model, gen, dev)
    pool = make_pool(model, batch, params["pool_batches"], gen, dev)

    state, step, prog = first_steps(conf, weights, pool, dev)
    program.sync(dev)
    setup_s = time.perf_counter() - cell.t_start

    n, window_losses, ticks = 0, [], []
    t0 = time.perf_counter()
    while True:
        x, y = pool[(FIRST_STEPS + n) % len(pool)]
        state, m = step(state, x, y)
        window_losses.append(m.loss)
        n += 1
        ticks.append(time.perf_counter() - t0)
        if ticks[-1] >= cell.seconds:
            break
    program.sync(dev)
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    quarters = [sum(1 for t in ticks if q * window_s / 4 <= t < (q + 1) * window_s / 4)
                for q in range(4)]
    cell.log(f"window: {n} steps of {batch} in {window_s:.6f} s, "
             f"step {1e3 * window_s / n:.4f} ms, steps dispatched per quarter {quarters}, "
             f"setup {setup_s:.3f} s")

    stretch = None
    if cell.trace:
        k = [FIRST_STEPS + n]

        def unit():
            x, y = pool[k[0] % len(pool)]
            step(state, x, y)
            k[0] += 1

        stretch = profile_stretch(unit, params["trace_steps"])
    peak = program.memory_peak(dev)
    del state, step
    program.release(dev)

    ref = reference_readings(weights, pool, model, tcfg)
    numbers = compare.train_numbers(prog, ref)
    cell.log(f"losses program {prog.losses} reference {ref.losses}; {compare.look(prog, ref)}")
    ctx = {
        "kind": "train",
        "model": model,
        "peaks": peaks_for(conf, dev),
        "samples": n * batch,
        "window_s": window_s,
        "step_s": window_s / n,
        "stretch_samples": params["trace_steps"] * batch,
    }
    metrics = {"train_samples_per_s": n * batch / window_s, "setup_s": setup_s}
    return Outcome(metrics, n, failed, numbers, peak, ctx, stretch)
