"""The open-loop schedule: the same arrivals and scans for every seed, a
sample drawn from the seed, latency timed from the due time, the generator's
lateness reported on its own line."""

import time

import numpy as np

from _tiny import SERVE, tiny
from benchmark.core import manifest as M
from benchmark.core import runner

DRV = M.driver("serve_open_loop")


def test_every_seed_offers_the_same_arrivals_and_draws_its_own_sample():
    params = {"rate_per_s": 4.0, "pool_scans": 32, "slices": [24, 48], "sample": 8}
    due_a, order_a, sample_a = DRV.schedule(params, 30, 2 ** 33 + 1)
    due_b, order_b, sample_b = DRV.schedule(params, 30, 7)
    assert len(due_a) == len(due_b) == 120
    assert np.array_equal(due_a, due_b) and np.array_equal(order_a, order_b)
    assert sample_a != sample_b
    gaps = np.diff(due_a, prepend=0.0)
    q = (np.arange(120) + 0.5) / 120
    assert np.allclose(np.sort(gaps), np.sort(-np.log1p(-q) / 4.0))  # exponential quantiles
    assert due_a[-1] <= 30 and abs(np.mean(gaps) - 0.25) < 0.02
    assert np.bincount(order_a, minlength=32).min() == 3  # every scan 3 or 4 times
    lengths = np.array(DRV.scan_lengths(params))
    assert len(sample_a) == 8 and lengths[order_a[sample_a]].max() == 48


class _SlowSession:
    """Answers after 50 ms, whatever it is asked."""

    def predict(self, x):
        time.sleep(0.05)
        return x, x


def test_latency_runs_from_the_due_time():
    server = DRV.Server.__new__(DRV.Server)
    server.session, server.scans, server.lengths = _SlowSession(), [np.zeros(1)], [1]
    server.log = print
    due = np.array([0.01, 0.011, 0.012])  # three due together: a queue forms
    lat, spans, _, failed, late, _ = server.window(due, [0, 0, 0])
    assert failed == 0 and len(late) == 1
    service = [e - s for s, e, _ in spans]
    assert lat[2] >= service[0] + service[1] + service[2] - 0.005
    assert lat[2] > 2.5 * service[2]


def test_the_lateness_line_comes_before_the_result(capsys):
    cell = SERVE[0]
    man, conf, work = tiny(cell)
    runner.emit(runner.execute(man, cell, conf, work, 5, 0.5, False, "cpu", time.perf_counter()))
    out, err = capsys.readouterr()
    lines = err.splitlines()
    late = [i for i, l in enumerate(lines) if "generator late" in l]
    checks = [i for i, l in enumerate(lines) if l.startswith("check ")]
    assert late and checks and late[0] < checks[0]
    assert out.strip().splitlines()[-1].startswith("{")
