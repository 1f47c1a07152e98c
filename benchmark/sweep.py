"""Find the highest rate a serving cell sustains, on the card.

    python3 benchmark/sweep.py --workload <serving cell> --seed <n> --seconds <s> \\
        --rates 2.5,3,3.5,4,4.5 [--out FILE]

sets up the cell's session and scans once from the seed, then serves one
open-loop window of ``--seconds`` at each rate in turn (``serve_open_loop``'s
schedule: the exponential gaps of that rate in one fixed order). A rate is
sustained when the backlog does not grow and the tail stays flat: the 90th
percentile of the window's second half is within 1.5x of its first half's,
and the median of its last quarter within 2x of its first quarter's. Prints
one JSON line per rate (``p50_ms``, ``p90_ms``, the halves' p90, the
service time per request, ``sustained``) and, last, the highest sustained
rate and 0.8 of it: the rate the cell's file takes as a number.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def judge(latencies) -> dict:
    n = len(latencies)
    half, quarter = n // 2, max(1, n // 4)
    first, second = latencies[:half], latencies[half:]
    p90 = [float(statistics.quantiles(v, n=10)[-1]) if len(v) > 1 else v[0]
           for v in (first, second)]
    q = [statistics.median(latencies[:quarter]), statistics.median(latencies[-quarter:])]
    return {
        "p90_first_ms": 1e3 * p90[0], "p90_second_ms": 1e3 * p90[1],
        "p50_first_quarter_ms": 1e3 * q[0], "p50_last_quarter_ms": 1e3 * q[1],
        "sustained": p90[1] <= 1.5 * p90[0] and q[1] <= 2.0 * q[0],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True, help="comma-separated scans per second")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark.core import manifest as M
    from benchmark.core.runner import Cell

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 3
    manifest = M.load_manifest()
    entry = M.cell(manifest, args.workload)
    work = M.workload_file(args.workload)
    config = M.config_file(M.config_entry(manifest, entry["config"]))
    drv = M.driver("serve_open_loop")  # any serving cell's session, scans and open-loop windows
    cell = Cell(args.workload, config, work, args.seed, args.seconds, False,
                torch.device("cuda", 0), time.perf_counter())
    server = drv.Server(cell)
    card = torch.cuda.get_device_name(0)
    lines, best = [], 0.0
    for rate in (float(r) for r in args.rates.split(",")):
        params = dict(work["params"], rate_per_s=rate)
        due, order, _ = drv.schedule(params, args.seconds, args.seed)
        lat, spans, _, failed, _, span_s = server.window(due, order)
        service = [e - s for s, e, _ in spans]
        line = {"rate_per_s": rate, "requests": len(due), "failed": failed,
                "p50_ms": 1e3 * statistics.median(lat),
                "p90_ms": 1e3 * float(np.percentile(lat, 90)),
                "service_ms": 1e3 * statistics.median(service),
                "capacity_per_s": 1.0 / statistics.mean(service),
                "span_s": span_s, **judge(lat), "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if line["sustained"] and failed == 0:
            best = max(best, rate)
    summary = {"workload": args.workload, "highest_sustained_per_s": best,
               "offered_per_s": 0.8 * best, "card": card}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(v) for v in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
