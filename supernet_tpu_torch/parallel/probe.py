"""Whether this machine's NCCL admits several ranks on one card:

    python -m supernet_tpu_torch.parallel.probe [--ranks 2] [--timeout 90]

spawns ``--ranks`` processes that all take ``cuda:0``, joins them in an NCCL
process group (a ``FileStore`` in a temporary directory), and has them run
one all-reduce and one ``batch_isend_irecv`` exchange with a neighbour.
Prints one JSON line: the torch, CUDA and NCCL versions, the card, and each
rank's outcome (what it completed, or NCCL's error text). Exits 0 when every
rank completed, 1 otherwise. ``chip_smoke.py`` phase 22 runs a world of one
because of what this reports on the H100 (``PERF.md`` section 7)."""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, world: int, store: str, out: str) -> None:
    done = []
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        done.append("init")
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        done.append(f"all_reduce {t[0].item()}")
        peer = (rank + 1) % world
        src = (rank - 1) % world
        s, r = torch.full((3,), float(rank), device="cuda"), torch.empty(3, device="cuda")
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, s, peer),
                                         dist.P2POp(dist.irecv, r, src)]):
            w.wait()
        torch.cuda.synchronize()
        done.append(f"exchange {r[0].item()}")
        dist.destroy_process_group()
        outcome = {"ok": True, "done": done}
    except Exception as e:  # reported: the point of the probe is NCCL's words
        text = "".join(traceback.format_exception_only(type(e), e)).strip()
        outcome = {"ok": False, "done": done, "error": text[:2000]}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(outcome, f)


def ranks_per_card(n_ranks: int = 2, timeout_s: float = 90.0) -> dict:
    """The probe's report (see the module docstring)."""
    report = {
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nccl": ".".join(str(v) for v in torch.cuda.nccl.version()),
        "card": torch.cuda.get_device_name(0), "ranks": n_ranks,
    }
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(n_ranks, os.path.join(tmp, "store"), tmp),
                                 nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        timed_out = False
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                timed_out = True
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                break
        outcomes = []
        for r in range(n_ranks):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    outcomes.append(json.load(f))
            else:
                outcomes.append({"ok": False, "done": [], "error": "no result"})
    report["timed_out"] = timed_out
    report["outcomes"] = outcomes
    report["admitted"] = not timed_out and all(o["ok"] for o in outcomes)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=90.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the probe runs on a card", file=sys.stderr)
        return 1
    report = ranks_per_card(args.ranks, args.timeout)
    print(json.dumps(report))
    return 0 if report["admitted"] else 1


if __name__ == "__main__":
    sys.exit(main())
