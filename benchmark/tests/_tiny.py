"""Small copies of the cells for CPU runs of the whole harness: the
published configurations at base 4 kernels (every layer, pad and skip as
published), batches of 2, scans of 3 to 6 slices."""

import copy

from benchmark.core import manifest as M


def cells(driver: str):
    """The manifest's cells whose file names ``driver``."""
    return [w["name"] for w in M.load_manifest()["workloads"]
            if M.workload_file(w["name"])["driver"] == driver]


TRAIN = cells("train_steps")
SERVE = cells("serve_open_loop") + cells("serve_closed_loop")


def tiny(cell: str, manifest=None, bench_dir=M.BENCH_DIR):
    manifest = manifest or M.load_manifest()
    entry = M.cell(manifest, cell)
    work = copy.deepcopy(M.workload_file(cell, bench_dir))
    conf = copy.deepcopy(M.config_file(M.config_entry(manifest, entry["config"])))
    conf["model"]["base_kernels"] = 4
    p = work["params"]
    if "batch" in p:
        p.update(batch=2, pool_batches=3, trace_steps=2)
    else:
        p.update(chunk=4, slices=[3, 6], pool_scans=3, sample=2, trace_requests=2)
        if "rate_per_s" in p:
            p.update(rate_per_s=4.0)
    return manifest, conf, work
