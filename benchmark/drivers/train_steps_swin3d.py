"""Closed-loop training of Swin UNETR: ``train3d.make_train_step3d`` called
once per batch, as ``cli train3d --config swinunetr --steps-per-dispatch 1``
runs it (``train_steps3d.py`` on the configuration's layer plan).

The plan is looked up first: a program without it stops there, before any
volume is made. Set-up makes the weights (``core/data_swin3d.py``) and a
pool of ``pool_batches`` batches of ``batch`` synthetic volumes on the
device from the seed (``core/data3d.py``), builds one train state and drives
it through its first three steps on pool batches 0, 1, 2
(``train_steps3d.first_steps``). That state goes on into the window: the
steps run on the pool's batches in turn, with no synchronisation but what a
step forces and one at the end. ``train_samples_per_s`` is every volume of
every step over the window's time, synchronisation included.

With ``--trace 1`` ``trace_steps`` more steps are profiled after the window.
Then the peak memory is read, the program's state is freed, and the
reference (``reference/swin_unetr3d.py``) takes the first three steps from
the same weights and batches.
"""

from __future__ import annotations

import time

import torch

from benchmark.core import compare, data, data_swin3d, program
from benchmark.core import manifest as M
from benchmark.core.runner import Outcome, peaks_for
from benchmark.core.trace import profile_stretch
from benchmark.reference import swin_unetr3d as reference

BASE = M.driver("train_steps")
BASE3D = M.driver("train_steps3d")
FIRST_STEPS = BASE.FIRST_STEPS
make_pool = BASE3D.make_pool


def reference_readings(weights, pool, model, train, steps=FIRST_STEPS,
                       tf32=False) -> compare.TrainReadings:
    """The reference's numbers from the same weights and batches (with
    ``tf32`` its control's)."""
    ref = reference.Reference(weights, model, train)
    losses, grads = [], None
    with reference.arithmetic(tf32):
        for i in range(steps):
            x, y = pool[i]
            value, clipped = ref.step(x, y)
            losses.append(value)
            if grads is None:
                grads = BASE._norms(clipped)
    w0 = {f"{n}/{k}": v for n, p in weights.items() for k, v in p.items()}
    deltas = {k: float(torch.linalg.vector_norm((t.detach() - w0[k]).double()))
              for k, t in ref.leaves()}
    return compare.TrainReadings(losses, grads, deltas)


def run(cell) -> Outcome:
    conf, work, dev = cell.config, cell.work, cell.device
    model, tcfg = conf["model"], conf["train"]
    params = work["params"]
    batch = params["batch"]
    BASE3D.model_config(conf)  # a program without the configuration's plan stops here
    gen = data.generator(cell.seed, dev)
    weights = data_swin3d.weights(model, gen, dev)
    pool = make_pool(model, batch, params["pool_batches"], gen, dev)

    state, step, prog = BASE3D.first_steps(conf, weights, pool, dev)
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
    cell.log(f"peak memory {peak} bytes")
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
