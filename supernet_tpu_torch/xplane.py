"""Read a ``torch.profiler`` trace without extra dependencies: the
counterpart of ``supernet_tpu/xplane.py``, for the Chrome-trace JSON that
``profiling.trace`` writes (the JAX package reads an XSpace protobuf).

A trace is ``{"traceEvents": [...]}``; the events used here are the
complete ones (``"ph": "X"``) with a category:

    cpu_op           an operator on a host thread (``args``: "External id",
                     and "Sequence number" / "Fwd thread id" where autograd
                     recorded one)
    user_annotation  a ``record_function`` range (the models' layer names)
    cuda_runtime     a CUDA runtime call on a host thread, "correlation" in
    cuda_driver      ``args`` naming the device event it launched
    kernel           a kernel on the card (pid the device, tid the stream,
    gpu_memcpy       "correlation" in ``args``)
    gpu_memset

Usage:

    python -m supernet_tpu_torch.xplane TRACE_DIR [CATEGORY]

prints the time of the newest trace under TRACE_DIR by op class: the card's
events when it holds any, else the host's operators by their self time (the
time inside an operator and outside every operator it calls), which is how
a CPU trace is read.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class Event:
    """One complete event: ``name``, ``cat``, ``pid``, ``tid``, ``ts`` and
    ``dur`` in microseconds, ``args``; ``self_us`` is filled for host
    operators by :func:`self_times`."""

    __slots__ = ("name", "cat", "pid", "tid", "ts", "dur", "args", "self_us")

    def __init__(self, raw: dict):
        self.name = raw.get("name", "")
        self.cat = raw.get("cat", "")
        self.pid, self.tid = raw.get("pid"), raw.get("tid")
        self.ts, self.dur = float(raw.get("ts", 0.0)), float(raw.get("dur", 0.0))
        self.args = raw.get("args") or {}
        self.self_us = self.dur

    @property
    def end(self) -> float:
        return self.ts + self.dur


def newest_trace(trace_dir: str) -> str:
    """The newest ``*.json`` (or ``*.json.gz``) trace under ``trace_dir``."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)
             if os.path.basename(p) != "exact_join.json"]
    if not paths:
        raise FileNotFoundError(f"no trace JSON under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def load_trace(path: str) -> List[Event]:
    """The complete events of the Chrome-trace file ``path``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [Event(e) for e in events if e.get("ph") == "X"]


def device_events(events: List[Event]) -> List[Event]:
    """The card's kernels, copies and fills."""
    return [e for e in events if e.cat in DEVICE_CATEGORIES]


def self_times(ops: List[Event]) -> List[Event]:
    """Fill ``self_us`` of each host operator: its duration less that of
    the operators directly inside it on the same thread."""
    by_thread = collections.defaultdict(list)
    for e in ops:
        by_thread[(e.pid, e.tid)].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.ts, -e.dur))
        stack: List[Event] = []
        for e in evs:
            while stack and e.ts >= stack[-1].end:
                stack.pop()
            e.self_us = e.dur
            if stack:
                stack[-1].self_us -= e.dur
            stack.append(e)
    return ops


# op classes, in the order a name is tested against them
_KERNEL_WIN = re.compile(r"vdp_conv_kernel(_wgmma|_splitk_reduce)?<([^>]*)>")


def kernel1_mode(name: str) -> Optional[str]:
    """"forward" or "transposed" for an instance of kernel 1 (the template
    flag WIN, the window sum: off in VDPConv's transposed convolutions),
    None for any other kernel or a name without its template arguments."""
    m = _KERNEL_WIN.search(name)
    if not m:
        return None
    args = [a.strip() for a in m.group(2).split(",")]
    pos = {"": 3, "_wgmma": 4, "_splitk_reduce": 1}[m.group(1) or ""]
    if len(args) <= pos:
        return None
    win = args[pos] in ("true", "(bool)1", "1")
    return "forward" if win else "transposed"


KERNEL_CLASSES = {
    "forward": "kernel 1 vdp_conv, forward",
    "transposed": "kernel 1 vdp_conv, transposed",
}
POOL_FWD = "kernel 2 pool forward"
POOL_BWD = "kernel 3 pool backward"
SIGMA_BWD = "kernel 4 sigma-chain backward"
CONV_FWD = "conv forward (cuDNN)"
CONV_DGRAD = "conv dgrad (cuDNN)"
CONV_WGRAD = "conv wgrad (cuDNN)"
CONV_BWD = "conv backward, dgrad and wgrad (cuDNN)"
GEMM = "GEMM"
REDUCE = "reduce"
ELEMENTWISE = "elementwise"
COPY = "copy/layout"
MEM = "memset/memcpy"
OPTIMIZER = "optimizer (Adam)"

_CONV_OPS = ("conv", "cudnn_convolution", "mkldnn_convolution", "_convolution",
             "convolution")
_GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::matmul", "aten::einsum",
             "aten::baddbmm", "aten::linear")
_REDUCE_OPS = ("aten::sum", "aten::mean", "aten::amax", "aten::amin", "aten::max",
               "aten::min", "aten::norm", "aten::linalg_vector_norm", "aten::prod",
               "aten::any", "aten::all", "aten::argmax", "aten::std", "aten::var")
_COPY_OPS = ("aten::copy_", "aten::cat", "aten::contiguous", "aten::clone",
             "aten::stack", "aten::constant_pad_nd", "aten::pad", "aten::to",
             "aten::_to_copy", "aten::flip", "aten::repeat_interleave", "aten::index",
             "aten::narrow_copy", "aten::slice_scatter", "aten::select_scatter")
_MEM_OPS = ("aten::empty", "aten::empty_strided", "aten::empty_like", "aten::zeros",
            "aten::zeros_like", "aten::zero_", "aten::fill_", "aten::full",
            "aten::ones", "aten::ones_like", "aten::new_zeros", "aten::new_empty",
            "aten::new_ones", "aten::full_like", "aten::resize_")


def op_class(name: str, cat: str, backward: bool = False) -> str:
    """The class of one event from its name and category alone (a host
    operator on a CPU trace, a device event on the card); ``backward`` says
    that it ran for the backward pass, which splits an unnamed cuDNN conv
    kernel from a forward one. ``hlo_profile`` refines this with the
    launching operator."""
    low = name.lower()
    if cat == "gpu_memcpy" or cat == "gpu_memset" or "memcpy" in low or "memset" in low:
        return MEM
    if cat in DEVICE_CATEGORIES:
        mode = kernel1_mode(name)
        if mode is not None:
            return KERNEL_CLASSES[mode]
        if "vmaxpool_fwd" in low:
            return POOL_FWD
        if "vmaxpool_bwd" in low:
            return POOL_BWD
        if "sigma_bwd" in low:
            return SIGMA_BWD
        if "dgrad" in low:
            return CONV_DGRAD
        if "wgrad" in low:
            return CONV_WGRAD
        if "fprop" in low:
            return CONV_FWD
        if any(k in low for k in ("nchwtonhwc", "nhwctonchw", "transpose", "copy",
                                  "catarray")):
            return COPY
        if "conv" in low or "cudnn" in low or "winograd" in low or "fft" in low:
            return CONV_BWD if backward else CONV_FWD
        if "multi_tensor" in low or "adam" in low:
            return OPTIMIZER
        if "gemm" in low or "cutlass" in low or "gemv" in low or "dot_kernel" in low:
            return GEMM
        if "reduce" in low:
            return REDUCE
        return ELEMENTWISE
    # a host operator
    if name == "aten::convolution_backward" or (backward and any(k in name for k in _CONV_OPS)):
        return CONV_BWD
    if any(k in name for k in _CONV_OPS):
        return CONV_FWD
    if name in _GEMM_OPS:
        return GEMM
    if name in _REDUCE_OPS:
        return REDUCE
    if name in _COPY_OPS:
        return COPY
    if name in _MEM_OPS:
        return MEM
    if "adam" in low or "optimizer" in low:
        return OPTIMIZER
    return ELEMENTWISE


def op_buckets(trace_dir: str, line_filter: Optional[str] = None) -> Dict[str, tuple]:
    """``{op class: (total_ps, events)}`` over the newest trace under
    ``trace_dir`` (the JAX twin's units): its device events, or, when it
    holds none, its host operators by self time. ``line_filter`` picks the
    events of one category instead (``"kernel"``, ``"cpu_op"``, ...)."""
    events = load_trace(newest_trace(trace_dir))
    if line_filter is not None:
        picked = [e for e in events if e.cat == line_filter]
    else:
        picked = device_events(events) or [e for e in events if e.cat == "cpu_op"]
    if picked and picked[0].cat == "cpu_op":
        self_times(picked)
    agg: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
    for e in picked:
        b = agg[op_class(e.name, e.cat)]
        b[0] += int(round(e.self_us * 1e6))
        b[1] += 1
    return {k: (v[0], v[1]) for k, v in agg.items()}


def main(argv: List[str]) -> int:
    buckets = op_buckets(argv[1], argv[2] if len(argv) > 2 else None)
    total = sum(ps for ps, _ in buckets.values())
    print(f"{'bucket':40} {'ms':>10} {'events':>8} {'%':>6}")
    for name, (ps, n) in sorted(buckets.items(), key=lambda kv: -kv[1][0]):
        print(f"{name:40} {ps / 1e9:10.3f} {n:8d} {100 * ps / max(total, 1):6.1f}")
    print(f"{'TOTAL':40} {total / 1e9:10.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
