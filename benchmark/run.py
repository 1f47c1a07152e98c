"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names its
configuration; its file (``benchmark/workloads/<cell>.json``) names its
traffic driver, the driver's parameters and the limits of ``correct``.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (a profiled stretch after the
window). The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last: every number compared with its limit);
the last lines of standard error give the same numbers and limits.

Exits 3 without a result when there is no card or fewer cards than the cell
asks for, and 4 when a module of JAX or of the JAX package was loaded.
Caches (the kernel library, PyTorch's and Triton's kernel caches) stay in
``build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = (
    ("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
    ("TRITON_CACHE_DIR", "build/triton_cache"),
    ("PYTORCH_KERNEL_CACHE_PATH", "build/torch_kernel_cache"),
)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES:
        os.makedirs(ROOT / sub, exist_ok=True)
        os.environ[var] = str(ROOT / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark.core import manifest as M
    from benchmark.core import runner

    manifest = M.load_manifest()
    entry = M.cell(manifest, args.workload)
    work = M.workload_file(args.workload)
    config = M.config_file(M.config_entry(manifest, entry["config"]))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"no result: {args.workload} needs {entry['chips']} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = runner.execute(manifest, args.workload, config, work, args.seed,
                            args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = M.forbidden_modules(sys.modules)
    if found:
        print(f"no result: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
