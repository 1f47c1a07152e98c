"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \\
        [--first-seed N] [--seconds S] [--out FILE]

For each of ``--seeds`` seeds the cell's driver runs as ``run.py`` runs it
(its set-up, a short window of ``--seconds`` at the cell's own load, its
comparison with the reference) and prints the numbers compared: the lower
readings. For each of ``--control-seeds`` more the control takes the
program's place: the reference itself with TF32 on in its convolutions and
matrix products (``reference.arithmetic(tf32=True)``), the nearest precision
below the configuration's float32, compared with the reference as the
program is: the upper readings. Training
cells also read a planted fault, half of the batch left out and the mean
taken over the rest (the reference on the first half of each batch against
the reference on the whole). A last line gives, per number, the largest
program reading and the smallest control and fault readings.

With ``--float64`` a training cell instead reads, for ``--seeds`` seeds, the
program, the reference and the control against float64 on the card
(``float64_look``): the second witness of where a number's gaps come from.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def train_control(drv, cell, seed):
    """``(control numbers, half-batch fault numbers)`` of one seed."""
    from benchmark.core import compare, data

    conf, params, dev = cell.config, cell.work["params"], cell.device
    model, tcfg = conf["model"], conf["train"]
    gen = data.generator(seed, dev)
    weights = data.he_weights(model, gen, dev)
    pool = drv.make_pool(model, params["batch"], params["pool_batches"], gen, dev)
    ref = drv.reference_readings(weights, pool, model, tcfg)
    half = [(x[: len(x) // 2], y[: len(y) // 2]) for x, y in pool]
    fault = drv.reference_readings(weights, half, model, tcfg)
    control = drv.reference_readings(weights, pool, model, tcfg, tf32=True)
    return compare.train_numbers(control, ref), compare.train_numbers(fault, ref)


def serve_control(cell, seed):
    """The control's numbers of one seed on as many scans as a run of the
    cell samples, the longest first."""
    import torch

    from benchmark.core import data
    from benchmark.core import manifest as M
    from benchmark.reference import arithmetic

    drv = M.driver("serve_open_loop")  # the scans and the reference's blocks

    conf, params, dev = cell.config, cell.work["params"], cell.device
    model = conf["model"]
    gen = data.generator(seed, dev)
    weights = data.he_weights(model, gen, dev)
    lengths = drv.scan_lengths(params)
    scans = drv.make_scans(model, lengths, gen, dev)
    longest_first = sorted(range(len(scans)), key=lambda i: -lengths[i])
    picked = [scans[i] for i in longest_first[:params["sample"]]]
    answers = []
    with torch.no_grad(), arithmetic(tf32=True):
        for scan in picked:
            probs, sigma = [], []
            for a in range(0, len(scan), params["chunk"]):
                x = torch.from_numpy(scan[a:a + params["chunk"]]).to(dev)
                p, s = drv.reference_forward(weights, x, model)
                o, c = model["out_size"], model["n_classes"]
                probs.append(p.reshape(-1, o, o, c).cpu())
                sigma.append(s.reshape(-1, o, o, c).cpu())
            answers.append((torch.cat(probs).numpy(), torch.cat(sigma).numpy()))
    return drv.reference_gaps(weights, picked, answers, model, params["chunk"], dev).numbers()


def float64_look(drv, cell, seed, chunks=4) -> dict:
    """A training cell's first three steps against float64 on the card, the
    second witness: the program (as run, and with cuDNN off, another path of
    the program), the reference in float32, its TF32 control, and float64
    itself with the images moved by one float32 ulp (how far rounding of the
    inputs alone carries). Each row: every step's signed loss gap, the
    first gradient's and the change's widest leaf gaps (``compare``'s
    measure) with the leaf, and the median leaf's change gap."""
    import torch

    from benchmark.core import compare, data, program

    conf, params, dev = cell.config, cell.work["params"], cell.device
    model, tcfg = conf["model"], conf["train"]
    gen = data.generator(seed, dev)
    weights = data.he_weights(model, gen, dev)
    pool = drv.make_pool(model, params["batch"], drv.FIRST_STEPS, gen, dev)
    wide = {n: {k: v.double() for k, v in p.items()} for n, p in weights.items()}
    pool64 = [(x.double(), y) for x, y in pool]
    truth = drv.reference_readings(wide, pool64, model, tcfg, chunks=chunks)
    nudged = [(x * (1 + 2.0 ** -23), y) for x, y in pool64]

    def program_readings(cudnn):
        before = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn
        try:
            state, step, readings = drv.first_steps(conf, weights, pool, dev)
        finally:
            torch.backends.cudnn.enabled = before
        del state, step
        program.release(dev)
        return readings

    rows = {
        "program": program_readings(True),
        "program_cudnn_off": program_readings(False),
        "reference_f32": drv.reference_readings(weights, pool, model, tcfg),
        "control_tf32": drv.reference_readings(weights, pool, model, tcfg, tf32=True),
        "float64_ulp_input": drv.reference_readings(wide, nudged, model, tcfg, chunks=chunks),
    }
    out = {"truth_losses": truth.losses}
    keys = compare.moved(truth)
    for name, r in rows.items():
        g = compare.leaf_gaps(r.grad_norms, truth.grad_norms, sorted(truth.grad_norms))
        d = compare.leaf_gaps(r.delta_norms, truth.delta_norms, keys)
        gk, dk = max(g, key=g.get), max(d, key=d.get)
        out[name] = {
            "loss_gaps": [(a - b) / abs(b) for a, b in zip(r.losses, truth.losses)],
            "grad_norm_gap": g[gk], "grad_leaf": gk,
            "update_norm_gap": d[dk], "update_leaf": dk,
            "update_median_gap": compare.train_numbers(r, truth)["update_median_gap"],
        }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    p.add_argument("--seconds", type=float, default=None,
                   help="the program's window (default: long enough for the sample)")
    p.add_argument("--out", default=None)
    p.add_argument("--float64", action="store_true",
                   help="training cells: instead, the look against float64 for --seeds seeds")
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
    serving = "chunk" in work["params"]
    seconds = args.seconds
    if seconds is None:
        seconds = ((work["params"]["sample"] + 2) / work["params"].get("rate_per_s", 5.0)
                   if serving else 1.0)
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    lines = []

    def emit(kind, seed, numbers):
        line = {"kind": kind, "seed": seed, **numbers, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)

    seed = args.first_seed
    if args.float64:
        for _ in range(args.seeds):
            cell = Cell(args.workload, config, work, seed, 1.0, False, dev, 0.0)
            emit("float64_look", seed, float64_look(drv, cell, seed))
            seed += 1
        return 0
    for _ in range(args.seeds):
        cell = Cell(args.workload, config, work, seed, seconds, False, dev, time.perf_counter())
        emit("program", seed, drv.run(cell).numbers)
        seed += 1
    for _ in range(args.control_seeds):
        full = Cell(args.workload, config, work, seed, manifest["run_seconds"], False, dev, 0.0)
        if serving:
            emit("control", seed, serve_control(full, seed))
        else:
            control, fault = train_control(drv, full, seed)
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
