"""Closed-loop scan serving: one client sends whole scans, each a stack of
slices, to one ``serving.InferenceSession`` and sends the next as soon as
``predict`` has returned the last one's numpy ``(probs, sigma)``. There is
no offered rate, so the server is never idle and no speed of the program
can outrun the traffic: ``serve_samples_per_s`` is the session's capacity.

Traffic parameters (the cell's file): ``chunk``, ``pool_scans`` and
``slices`` (the scan lengths, as ``serve_open_loop`` reads them), ``sample``
(how many answers the reference checks) and ``trace_requests``. The
requests take the pool's scans in turn. A request is sent while the
window's ``--seconds`` have not run out (and until the longest scan has been
served once); ``serve_samples_per_s`` is every slice answered over the time
from the window's start to the last answer.

Which answers are checked: the first request of the longest scan, and
``sample - 1`` more drawn from the seed over the stream as it comes
(reservoir sampling: the number of requests is not known before the window
ends). Set-up, the traced stretch, the peak memory and the reference are
those of ``serve_open_loop``.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.core import compare, program
from benchmark.core.runner import Outcome, peaks_for
from benchmark.core.trace import profile_stretch
from benchmark.drivers.serve_open_loop import Server, reference_gaps


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng(seed % (2 ** 63))

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        r = int(self.rng.integers(0, self.seen))
        if r < self.k:
            self.items[r] = item


def window(server, seconds: float, first_longest: int, reservoir: Reservoir):
    """Serve the pool's scans in turn, each request sent when the last is
    answered, until ``seconds`` have run out and the longest scan has been
    served once. Returns ``(requests, spans (start, end, slices), the longest
    scan's first answer, failed, time from the start to the last answer)``."""
    spans, failed, longest, i = [], 0, None, 0
    pool = len(server.scans)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or i <= first_longest:
        j = i % pool
        start = time.perf_counter()
        try:
            answer = server.session.predict(server.scans[j])
        except RuntimeError as e:  # an answer that never comes
            server.log(f"request {i} failed: {e}")
            failed += 1
            i += 1
            continue
        spans.append((start, time.perf_counter(), server.lengths[j]))
        if i == first_longest:
            longest = (j, answer)
        else:
            reservoir.offer((j, answer))
        i += 1
    return i, spans, longest, failed, time.perf_counter() - t0


def run(cell) -> Outcome:
    conf, params, dev = cell.config, cell.work["params"], cell.device
    server = Server(cell)
    model, lengths, scans = server.model, server.lengths, server.scans
    first_longest = int(np.argmax(lengths))
    reservoir = Reservoir(params["sample"] - 1, cell.seed)
    setup_s = time.perf_counter() - cell.t_start

    n, spans, longest, failed, window_s = window(server, cell.seconds, first_longest, reservoir)
    slices = int(sum(k for _, _, k in spans))
    cell.log(f"window: {n} scans, {slices} slices in {window_s:.6f} s, "
             f"{n / window_s:.4f} scans/s; setup {setup_s:.3f} s")

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

    checked = ([longest] if longest is not None else []) + reservoir.items
    gaps = reference_gaps(server.weights, [scans[j] for j, _ in checked],
                          [a for _, a in checked], model, server.chunk, dev)
    wanted = min(params["sample"], n)
    numbers = gaps.numbers() if longest is not None and len(checked) == wanted else {
        k: float("inf") for k in compare.ServeGaps().numbers()}
    ctx = {
        "kind": "serve",
        "model": model,
        "peaks": peaks_for(conf, dev),
        "predict_s": [e - s for s, e, _ in spans],
        "predict_slices": [k for _, _, k in spans],
        "stretch_samples": stretch_slices,
    }
    metrics = {"serve_samples_per_s": slices / window_s, "setup_s": setup_s}
    return Outcome(metrics, n, failed, numbers, peak, ctx, stretch)
