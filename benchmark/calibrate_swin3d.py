"""The readings the swinunetr training cell's limits are set from, on the
card, in one process: ``calibrate3d.py`` for ``drivers/train_steps_swin3d.py``.

    python3 benchmark/calibrate_swin3d.py --seeds 12 --control-seeds 3 \\
        [--workload swinunetr-train-b1] [--first-seed N] [--seconds S] [--out FILE]

For each of ``--seeds`` seeds the cell runs as ``run.py`` runs it (its
set-up, a window of ``--seconds``, its comparison with the reference) and
prints the numbers compared: the lower readings. For each of
``--control-seeds`` more the control takes the program's place (the
reference with TF32 on in its matrix products, the nearest precision below
the configuration's float32), and the planted fault too (the reference with
part of the attention's variance left out: the scores carry none, and the
values' own variance alone passes the products, sigma_O = P^2 sigma_V),
each compared with the reference as the program is: the upper readings. At
batch 1 the other cells' half-batch fault does not exist. A last line gives,
per number, the largest program reading and the smallest control and fault
readings.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def attention_variance_left_out(reference):
    """The reference's attention with sigma_S = 0 and sigma_O = P^2 sigma_V."""
    import torch

    whole = reference.attention_moments

    def fault(qm, qs, km, ks, vm, vs, add):
        p = torch.softmax(torch.einsum("bwhid,bwhjd->bwhij", qm, km) + add, dim=-1)
        return (torch.einsum("bwhij,bwhjd->bwhid", p, vm),
                torch.einsum("bwhij,bwhjd->bwhid", p * p, vs))

    reference.attention_moments = fault
    try:
        yield
    finally:
        reference.attention_moments = whole


def train_control_swin3d(drv, cell, seed):
    """``(control numbers, attention-variance fault numbers)`` of one seed."""
    from benchmark.core import compare, data, data_swin3d

    conf, params, dev = cell.config, cell.work["params"], cell.device
    model, tcfg = conf["model"], conf["train"]
    gen = data.generator(seed, dev)
    weights = data_swin3d.weights(model, gen, dev)
    pool = drv.make_pool(model, params["batch"], drv.FIRST_STEPS, gen, dev)
    ref = drv.reference_readings(weights, pool, model, tcfg)
    with attention_variance_left_out(drv.reference):
        fault = drv.reference_readings(weights, pool, model, tcfg)
    control = drv.reference_readings(weights, pool, model, tcfg, tf32=True)
    return compare.train_numbers(control, ref), compare.train_numbers(fault, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="swinunetr-train-b1")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 5000)
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
        control, fault = train_control_swin3d(drv, cell, seed)
        emit("control", seed, control)
        emit("fault_attention_variance", seed, fault)
        seed += 1
    summary = {"workload": args.workload}
    for kind, pick in (("program", max), ("control", min), ("fault_attention_variance", min)):
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
