"""The readings a 3-D training cell's limits are set from, on the card, in
one process: ``calibrate.py`` for the cells of ``drivers/train_steps3d.py``.

    python3 benchmark/calibrate3d.py --workload <cell> --seeds 12 --control-seeds 3 \\
        [--first-seed N] [--seconds S] [--out FILE]

For each of ``--seeds`` seeds the cell runs as ``run.py`` runs it
(its set-up, a window of ``--seconds``, its comparison with the reference)
and prints the numbers compared: the lower readings. For each of
``--control-seeds`` more the control takes the program's place (the
reference with TF32 on in its matrix products, the nearest precision below
the configuration's float32), and the planted fault (the reference on the
first half of each batch) too, each compared with the reference as the
program is: the upper readings. A last line gives, per number, the largest
program reading and the smallest control and fault readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def train_control3d(drv, cell, seed):
    """``(control numbers, half-batch fault numbers)`` of one seed."""
    from benchmark.core import compare, data, data3d

    conf, params, dev = cell.config, cell.work["params"], cell.device
    model, tcfg = conf["model"], conf["train"]
    gen = data.generator(seed, dev)
    weights = data3d.he_weights(model, gen, dev)
    pool = drv.make_pool(model, params["batch"], drv.FIRST_STEPS, gen, dev)
    ref = drv.reference_readings(weights, pool, model, tcfg)
    half = [(x[: len(x) // 2], y[: len(y) // 2]) for x, y in pool]
    fault = drv.reference_readings(weights, half, model, tcfg)
    control = drv.reference_readings(weights, pool, model, tcfg, tf32=True)
    return compare.train_numbers(control, ref), compare.train_numbers(fault, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 3000)
    p.add_argument("--seconds", type=float, default=1.0, help="the program's window")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.core import manifest as M
    from benchmark.core.runner import Cell

    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 3
    manifest = M.load_manifest()
    entry = M.cell(manifest, args.workload)
    work = M.workload_file(args.workload)
    config = M.config_file(M.config_entry(manifest, entry["config"]))
    drv = M.driver(work["driver"])
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    lines = []

    def emit(kind, seed, numbers):
        line = {"kind": kind, "seed": seed, **numbers, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)

    seed = args.first_seed
    for _ in range(args.seeds):
        cell = Cell(args.workload, config, work, seed, args.seconds, False, dev,
                    time.perf_counter())
        emit("program", seed, drv.run(cell).numbers)
        seed += 1
    for _ in range(args.control_seeds):
        cell = Cell(args.workload, config, work, seed, args.seconds, False, dev, 0.0)
        control, fault = train_control3d(drv, cell, seed)
        emit("control", seed, control)
        emit("fault_half_batch", seed, fault)
        seed += 1
    summary = {"workload": args.workload}
    for kind, pick in (("program", max), ("control", min), ("fault_half_batch", min)):
        rows = [v for v in lines if v["kind"] == kind]
        if rows:
            keys = [k for k in rows[0] if k not in ("kind", "seed", "card")]
            summary[kind] = {k: pick(r[k] for r in rows) for k in keys}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(v) for v in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
