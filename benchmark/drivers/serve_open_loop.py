"""Open-loop scan serving: requests of whole scans, each a stack of slices,
arrive on a fixed schedule and are answered FIFO by one
``serving.InferenceSession`` (its fixed chunk, the tail chunk padded).

Traffic parameters (the cell's file): ``rate_per_s`` (scans offered per
second), ``chunk``, ``pool_scans`` and ``slices`` (the scan lengths, spread
evenly over ``[min, max]``, a fixed set that every seed shares), and
``sample`` (how many answers the reference checks). The schedule has
``floor(rate * seconds)`` requests; their gaps are the quantiles of the
exponential distribution of that rate (a Poisson stream's gaps), shuffled
once, so every seed offers the same arrivals and the same scan lengths in
the same order; the seed draws the weights, the scans' contents and the
sample. A request's latency runs from its due time to ``predict``
returning its numpy ``(probs, sigma)``; the server sleeps until a request
is due when it is ahead, and how late it woke is reported apart
(generator lateness). ``serve_samples_per_s`` is every slice answered over
the time from the window's start to the last answer (at least the
window).

The scans are made on the device from the seed and kept on the host, as a
client would send them. With ``--trace 1`` ``trace_requests`` requests are
profiled back to back after the window. Then the peak memory is read, the
session is freed, and the reference answers the sampled requests (drawn from
the seed before the window, the longest among them) in blocks of ``chunk``
slices.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from benchmark.core import compare, data, program
from benchmark.core.runner import Outcome, peaks_for
from benchmark.core.trace import profile_stretch
from benchmark.reference import arithmetic
from benchmark.reference.vdp_unet import forward as reference_forward


ARRIVAL_SEED = 20240611  # the one arrival order of every cell of this driver


def scan_lengths(params) -> list:
    lo, hi = params["slices"]
    return [int(round(v)) for v in np.linspace(lo, hi, params["pool_scans"])]


def make_scans(model, lengths, gen, device) -> list:
    """One host array [n, S, S, C] per scan."""
    return [data.images(model, n, gen, device)[0].cpu().numpy() for n in lengths]


def schedule(params, seconds: float, seed: int):
    """``(due times in seconds from the window's start, scan index per
    request, sampled request indices)``. The arrivals and the order of the
    scans are the cell's own, the same for every seed (at a load near the
    knee the order of the gaps alone moves the tails by tens of percent);
    the seed draws the scans' contents and the sample."""
    rate, pool = params["rate_per_s"], params["pool_scans"]
    n = max(1, int(math.floor(rate * seconds)))
    fixed = np.random.default_rng(ARRIVAL_SEED)
    q = (np.arange(n) + 0.5) / n
    gaps = fixed.permutation(-np.log1p(-q) / rate)
    due = np.cumsum(gaps)
    order = fixed.permutation(np.resize(np.arange(pool), n))
    rng = np.random.default_rng(seed % (2 ** 63))
    lengths = np.array(scan_lengths(params))[order]
    k = min(params["sample"], n)
    longest = int(np.argmax(lengths))
    rest = rng.permutation([i for i in range(n) if i != longest])[:k - 1]
    return due, order, sorted({longest, *map(int, rest)})


def sleep_until(t: float) -> float:
    """Sleep until ``perf_counter() >= t``; return how late it woke."""
    while True:
        d = t - time.perf_counter()
        if d <= 0:
            return -d
        if d > 1.5e-3:  # the last millisecond is spun, not slept
            time.sleep(d - 1e-3)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def reference_gaps(weights, scans, answers, model, chunk, device) -> compare.ServeGaps:
    """The reference on every sampled scan, block by block, against the
    program's answers."""
    o, c = model["out_size"], model["n_classes"]
    gaps = compare.ServeGaps()
    with torch.no_grad(), arithmetic():
        for scan, (probs, sigma) in zip(scans, answers):
            for a in range(0, len(scan), chunk):
                x = torch.from_numpy(scan[a:a + chunk]).to(device)
                pr, sr = reference_forward(weights, x, model)
                b = x.shape[0]
                pr, sr = pr.reshape(b, o, o, c), sr.reshape(b, o, o, c)
                p = torch.from_numpy(probs[a:a + chunk]).to(device)
                s = torch.from_numpy(sigma[a:a + chunk]).to(device)
                gaps.add(p, s, pr, sr, float(sr.abs().median()))
    return gaps


class Server:
    """The program's session and the cell's scans, set up once from the
    seed; ``window`` serves one schedule (``sweep.py`` serves several)."""

    def __init__(self, cell):
        from supernet_tpu_torch.serving import InferenceSession

        conf, self.params, dev = cell.config, cell.work["params"], cell.device
        self.model, self.chunk, self.log = conf["model"], self.params["chunk"], cell.log
        program.set_precision(conf)
        gen = data.generator(cell.seed, dev)
        self.weights = data.he_weights(self.model, gen, dev)
        self.lengths = scan_lengths(self.params)
        self.scans = make_scans(self.model, self.lengths, gen, dev)
        mc = program.model_config(conf)
        self.session = InferenceSession(self.weights, mc, batch_size=self.chunk, device=dev).warmup()
        longest = self.scans[int(np.argmax(self.lengths))]
        for _ in range(2):  # the host buffers at their largest, every chunk shape
            self.session.predict(longest)
        program.sync(dev)

    def window(self, due, order, keep=()):
        """Serve the requests of ``due`` / ``order`` FIFO from now. Returns
        ``(latencies s, spans (start, end, slices), kept answers, failed,
        generator lateness s, time from the start to the last answer)``."""
        latencies, spans, late, kept, failed = [], [], [], {}, 0
        keep = set(keep)
        t0 = time.perf_counter()
        for i, (d, j) in enumerate(zip(due, order)):
            due_t = t0 + float(d)
            if time.perf_counter() < due_t:
                late.append(sleep_until(due_t))
            start = time.perf_counter()
            try:
                answer = self.session.predict(self.scans[j])
            except RuntimeError as e:  # an answer that never comes
                self.log(f"request {i} failed: {e}")
                failed += 1
                latencies.append(float("inf"))
                continue
            end = time.perf_counter()
            latencies.append(end - due_t)
            spans.append((start, end, self.lengths[j]))
            if i in keep:
                kept[i] = answer
        return latencies, spans, kept, failed, late, time.perf_counter() - t0


def run(cell) -> Outcome:
    conf, params, dev = cell.config, cell.work["params"], cell.device
    server = Server(cell)
    model, lengths, scans = server.model, server.lengths, server.scans
    due, order, sampled = schedule(params, cell.seconds, cell.seed)
    setup_s = time.perf_counter() - cell.t_start

    latencies, spans, kept, failed, late, span_s = server.window(due, order, sampled)
    window_s = max(cell.seconds, span_s)
    slices = int(sum(n for _, _, n in spans))
    cell.log(f"window: {len(due)} scans, {slices} slices in {span_s:.6f} s; "
             f"generator late p50 {1e3 * (statistics.median(late) if late else 0):.4f} ms "
             f"max {1e3 * (max(late) if late else 0):.4f} ms over {len(late)} waits; "
             f"setup {setup_s:.3f} s")

    stretch, stretch_slices = None, 0
    if cell.trace:
        count = params["trace_requests"]
        calls = [0]

        def unit():
            server.session.predict(scans[calls[0] % len(scans)])
            calls[0] += 1

        stretch = profile_stretch(unit, count)
        stretch_slices = sum(lengths[i % len(scans)] for i in range(2, 2 + count))
    peak = program.memory_peak(dev)
    server.session = None
    program.release(dev)

    answers = [kept[i] for i in sampled if i in kept]
    gaps = reference_gaps(server.weights, [scans[order[i]] for i in sampled if i in kept],
                          answers, model, server.chunk, dev)
    numbers = gaps.numbers() if len(answers) == len(sampled) else {
        k: float("inf") for k in compare.ServeGaps().numbers()}
    ms = [1e3 * v for v in latencies]
    ctx = {
        "kind": "serve",
        "model": model,
        "peaks": peaks_for(conf, dev),
        "predict_s": [e - s for s, e, _ in spans],
        "predict_slices": [n for _, _, n in spans],
        "stretch_samples": stretch_slices,
    }
    metrics = {
        "serve_p50_ms": percentile(ms, 50),
        "serve_p90_ms": percentile(ms, 90),
        "serve_samples_per_s": slices / window_s,
        "setup_s": setup_s,
    }
    return Outcome(metrics, len(due), failed, numbers, peak, ctx, stretch)
