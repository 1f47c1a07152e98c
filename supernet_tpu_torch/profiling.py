"""Where the time of a training step or a serving request goes on the card.

    python -m supernet_tpu_torch.profiling --mode train --config hippocampus --batch 20
    python -m supernet_tpu_torch.profiling --mode serve --config brats --batch 2
    python -m supernet_tpu_torch.profiling --mode train --act-dtype bfloat16
    python -m supernet_tpu_torch.profiling --mode layers --config brats --batch 2
    python -m supernet_tpu_torch.profiling --mode train3d --config hippocampus --batch 4 [--remat]
    python -m supernet_tpu_torch.profiling --mode layers3d --config hippocampus --batch 4
    python -m supernet_tpu_torch.profiling --mode ensemble --members 4 --ensemble-mode vmap

builds a train state (or an ``InferenceSession``) from ``init_params``
(seeded; the time does not depend on the weights' values), runs WARMUP
steps (requests of 5 batches), times STEPS more with the host clock (each
ends in ``torch.cuda.synchronize()`` or the answer's copy to the host),
then traces STEPS more under ``torch.profiler`` and sorts the device time
of every kernel into the categories of :data:`CATEGORIES` (``port_kernels``
lists the hand-written kernels one by one, template instances apart). The
device's busy share is its traced kernel and copy time over the untraced
median step (request) time; the rest is idle (host dispatch,
synchronisation).
``--mode layers`` times three kernels alone at every layer shape of one
step, device time only (:func:`device_ms`: the stream is held by a sleep
while the host queues the calls, so no host time counts): the fused VDP conv
(kernel 1) at every k=3 conv, beside cuDNN's time for the mu product alone
(TF32 off; a yardstick the port never calls), the float32 and 3xTF32 bounds,
the path and the K slices; the sigma-chain backward (kernel 4, the whole
wrapper) at the same convs' outputs and the pool backward (kernel 3) at
every pool, each beside its byte bound and its plan; and an empty launch,
the floor under every small layer (:func:`layer_times`). It reads only the
wrappers' public functions, so it also times another checkout of the port
put first on ``PYTHONPATH``.
``--mode train3d`` profiles one volumetric step (``train3d.make_train_step3d``)
at the config's cube side, width and depth, with ``--remat`` checkpointing
the blocks; its convolutions are all cuDNN's ``conv3d`` (``conv3d_share``:
their device time over the step's). ``--mode layers3d`` times cuDNN's
``conv3d`` alone at every k=3 layer of that forward (:func:`conv3d_times`),
the forward and the forward with both gradients, in the port's layout and
in NCDHW.
``--mode ensemble`` profiles one K-member deep-ensemble step
(``train.make_ensemble_train_step``) in ``--ensemble-mode`` vmap (the
member axis through the kernels) or unroll (a loop of the single-model
forward and backward), or ``sequential``: one ``make_train_step`` step of
each of K single-model states in turn, the sequential path's work for the
same K member-steps; ``member_step_ms`` is the step over K.
``--act-dtype bfloat16`` runs the train and serve modes in the bf16
activation mode (``ops.set_act_dtype``). ``SUPERNET_PRECISION`` sets the
precision of the train, serve and ensemble modes (``set_mxu_precision``;
"highest" when unset, "default" for kernel 1 in one bf16 pass as ``cli
bench`` runs it). The train and serve modes also
count the dtype-conversion kernels of one step (request) from a trace with
the operators' input types (:func:`conversion_kernels`). Prints one JSON
object; ``--out DIR`` also writes it there. Needs a CUDA device: there is no
CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from supernet_tpu_torch import train
from supernet_tpu_torch import xplane as X
from supernet_tpu_torch.configs import get_config
from supernet_tpu_torch.models import forward, init_params, layer_names
from supernet_tpu_torch.ops import (get_act_dtype, get_mxu_precision, set_act_dtype,
                                   set_mxu_precision)
from supernet_tpu_torch.ops.moments import lowering
from supernet_tpu_torch.serving import InferenceSession

# (label, substrings of the kernel name), first match wins: the four
# hand-written kernels come before the generic convolution names, and the
# convolutions before cuBLAS' matrix products, since cuDNN's dgrad and
# wgrad kernels also say "gemm". cuDNN's FFT algorithms run FFTs and complex
# (cf32) products; the port itself computes nothing complex.
CATEGORIES = (
    ("vdp_conv (kernel 1)", ("vdp_conv_kernel",)),
    ("pool forward (kernel 2)", ("vmaxpool_fwd",)),
    ("pool backward (kernel 3)", ("vmaxpool_bwd",)),
    ("sigma backward (kernel 4)", ("sigma_bwd",)),
    ("cuDNN convolutions (VDPConv backward)", ("conv", "dgrad", "wgrad", "fprop", "cudnn", "fft", "cf32")),
    ("Adam", ("multi_tensor", "adam")),
    ("matmuls (1x1 head, unpool conv)", ("gemm",)),
    ("copies and fills", ("memcpy", "memset")),
)
OTHER = "other (elementwise, reductions, clip norms)"
_PORT_CATEGORIES = tuple(label for label, _ in CATEGORIES[:4])
WARMUP, STEPS = 3, 10
# H100 SXM peaks (NVIDIA's data sheet): device memory bandwidth, the CUDA
# cores' float32 rate and the tensor cores' dense TF32 and bf16 rates.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12


@contextlib.contextmanager
def recording(warmup: Optional[Callable[[], object]] = None, on_trace_ready=None,
              record_shapes: bool = False):
    """``torch.profiler`` over the block: the CPU ops, and the card's
    kernels and copies when there is a card. Yields the profiler.

    On the card the trace loses the device records of some of the first
    kernels launched after recording starts, their launch calls still in
    it (an H100 with PyTorch 2.11 and CUDA 12.8). The profiler's warm-up
    phase with launches in it makes that rarer, not rare enough for an
    exact count: the profiler starts in that phase, ``warmup()`` (one
    call of the traced work) runs there, its records are discarded, and
    recording starts at the block. A caller that needs every kernel
    recorded opens the block with a call it leaves out
    (``hlo_profile.SETTLE``). ``record_shapes`` records each operator's
    input shapes and types (the trace's "Input Dims" and "Input type")."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule,
                                on_trace_ready=on_trace_ready,
                                record_shapes=record_shapes) as prof:
        if warmup is not None:
            warmup()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.step()
        yield prof


@contextlib.contextmanager
def trace(log_dir: str, warmup: Optional[Callable[[], object]] = None):
    """``with profiling.trace(DIR):`` traces the block (:func:`recording`,
    with ``warmup`` run first and not recorded) and writes it into ``DIR`` as
    a Chrome-trace JSON, ``trace_<ns>.pt.trace.json``, which
    ``xplane.op_buckets`` and ``hlo_profile.join`` read and Perfetto or
    TensorBoard show (the counterpart of ``supernet_tpu/profiling.py:22-31``).
    Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.pt.trace.json")
    with recording(warmup, lambda prof: prof.export_chrome_trace(path)) as prof:
        yield prof


def _converts(op) -> bool:
    """True for an ``aten::copy_`` whose destination and source types (the
    first two "Input type"s of a trace with shapes) differ: a dtype
    conversion, such as ``.to(torch.bfloat16)`` or ``.float()``."""
    types = op.args.get("Input type") or []
    return (op.name == "aten::copy_" and len(types) >= 2 and bool(types[0])
            and bool(types[1]) and types[0] != types[1])


def count_conversions(events) -> int:
    """The dtype-conversion kernels in the events of a trace recorded with
    shapes (``xplane.load_trace``): the device kernels whose "External id"
    is that of a converting ``aten::copy_`` (:func:`_converts`). On a trace
    without device events (a CPU run) the converting operators themselves,
    each of which launches one kernel on the card."""
    ops = {e.args.get("External id") for e in events
           if e.cat == "cpu_op" and _converts(e)}
    device = X.device_events(events)
    if not device:
        return len(ops)
    return sum(1 for e in device if e.args.get("External id") in ops)


def conversion_kernels(run: Callable[[], object], calls: int = 2) -> float:
    """Dtype-conversion kernels per call of ``run``: ``calls`` calls traced
    with the operators' input types (after one untraced call in the
    profiler's warm-up phase, :func:`recording`), counted by
    :func:`count_conversions`."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with recording(warmup=run, on_trace_ready=lambda p: p.export_chrome_trace(path),
                       record_shapes=True):
            for _ in range(calls):
                run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        events = X.load_trace(path)
    return count_conversions(events) / calls


class _NaNCheck(torch.utils._python_dispatch.TorchDispatchMode):
    """Raises ``FloatingPointError`` when an op's floating output holds a
    NaN, naming the op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_NAN_CHECK: List[_NaNCheck] = []


def enable_nan_debugging(enabled: bool = True) -> None:
    """Make a NaN raise where it is made, the counterpart of the JAX
    package's ``jax_debug_nans`` (``supernet_tpu/profiling.py:91-97``): in
    the forward every op's output is checked (``FloatingPointError`` naming
    the op; a dispatch mode on this thread), in the backward autograd's
    anomaly mode checks every node's gradients (``RuntimeError`` naming the
    node and the forward op that made it). Each check synchronises with
    the card, so the program runs far slower. ``enabled=False`` turns both
    off again."""
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)
    if enabled and not _NAN_CHECK:
        mode = _NaNCheck()
        mode.__enter__()
        _NAN_CHECK.append(mode)
    elif not enabled and _NAN_CHECK:
        _NAN_CHECK.pop().__exit__(None, None, None)


def category(kernel_name: str) -> str:
    name = kernel_name.lower()
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return label
    return OTHER


def _device_events(prof) -> List:
    """The kernels, copies and fills on the device. The device timeline
    also carries each ``record_function`` range (the layer names, the
    optimizer step, the profiler's step) as an annotation spanning its
    kernels; those are left out, or their kernels would count twice."""
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host_names and not e.name.startswith("ProfilerStep")]


def _busy_us(events) -> float:
    """Length of the union of the events' time ranges."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -float("inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


class StepTimer:
    """Step boundaries of the epoch trainer: ``tick()`` marks one, and
    ``total_seconds()`` is the time from the first to the last. Kernels are
    queued asynchronously: call ``sync`` before a tick in code that has not
    already fetched a value of the step."""

    def __init__(self) -> None:
        self.times: List[float] = []

    def tick(self) -> None:
        self.times.append(time.perf_counter())

    @staticmethod
    def sync(x=None) -> None:
        """Wait for the device work queued so far (``x`` may be a tensor or
        a nest of tensors: only a CUDA leaf makes this wait)."""
        while isinstance(x, dict):
            x = next(iter(x.values()))
        if x is None or getattr(x, "is_cuda", False):
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def total_seconds(self) -> float:
        if len(self.times) < 2:
            return 0.0
        return self.times[-1] - self.times[0]


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_reserved}} of every
    visible card, from ``torch.cuda.memory_stats``; empty without one."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
        }
    return out


def _setup(config: str, seed: int):
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device; there is no CPU fallback")
    set_mxu_precision(os.environ.get("SUPERNET_PRECISION") or "highest")
    exp = get_config(config)
    params = init_params(torch.Generator().manual_seed(seed), exp.model, "cpu")
    return exp.model, exp.train, params, np.random.default_rng(seed)


def _profile(run, per: str, steps: int = STEPS) -> Dict:
    """Time ``run`` (one step or request, ending in a synchronise) ``steps``
    times untraced, then trace as many more (after one in the profiler's
    warm-up phase, :func:`recording`) and sort their device time."""
    for _ in range(WARMUP):
        run()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    with recording(warmup=run) as prof:
        for _ in range(steps):
            run()
    events = _device_events(prof)
    if not events:
        raise RuntimeError("torch.profiler recorded no device events")

    by_cat: Dict[str, float] = {}
    by_kernel: Dict[str, List[float]] = {}
    for e in events:
        us = e.time_range.elapsed_us()
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + us
        k = by_kernel.setdefault(e.name, [0.0, 0])
        k[0] += us
        k[1] += 1
    busy_ms = _busy_us(events) / 1e3 / steps
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    top = ranked[:15]
    # every hand-written kernel by name, however small its share
    ours = [kv for kv in ranked if category(kv[0]) in _PORT_CATEGORIES]
    return {
        "device": torch.cuda.get_device_name(0), "steps": steps,
        f"{per}_ms_median": 1e3 * step_s,
        f"device_ms_per_{per}": sum(by_cat.values()) / 1e3 / steps,
        f"device_events_per_{per}": len(events) / steps,
        f"device_busy_ms_per_{per}": busy_ms,
        "busy_share": busy_ms / (1e3 * step_s),
        "idle_share": 1.0 - busy_ms / (1e3 * step_s),
        "peak_memory_bytes": peak,
        f"categories_ms_per_{per}": {
            k: v / 1e3 / steps for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": n[:120], f"ms_per_{per}": t / 1e3 / steps, f"calls_per_{per}": c / steps}
            for n, (t, c) in top],
        "port_kernels": [
            {"name": n[:120], f"ms_per_{per}": t / 1e3 / steps, f"calls_per_{per}": c / steps}
            for n, (t, c) in ours],
    }


@functools.lru_cache(maxsize=None)
def stage_shapes(cfg) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """``(stage name, output shape)`` (batch 1) of every stage of one
    forward in order, from the taps of a float32 CPU forward (the JAX
    package's ``jax.eval_shape`` of its forward, done by running it), with
    the decoder glue explicit (its pads and concatenations are stages)."""
    cfg = dataclasses.replace(cfg, remat=False)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.zeros(1, cfg.image_size, cfg.image_size, cfg.in_channels)
    stages = []
    with torch.inference_mode(), lowering(glue_fold="none"):
        forward(params, x, cfg, tap=lambda name, shape: stages.append((name, shape)))
    return tuple(stages)


def layer_shapes(cfg) -> Tuple[List, List]:
    """The input shape (batch 1) of every k=3 conv and every pool of one
    forward, read from :func:`stage_shapes`: ([(name, shape, cout)],
    [(name, shape)])."""
    ksize = {name: (k, cout) for name, k, _, cout in layer_names(cfg)}
    convs, pools = [], []
    prev = (1, cfg.image_size, cfg.image_size, cfg.in_channels)
    for name, shape in stage_shapes(cfg):
        if name in ksize and ksize[name][0] == 3:
            convs.append((name, prev, ksize[name][1]))
        elif name.startswith("pool"):
            pools.append((name, prev))
        prev = shape
    return convs, pools


def vdp_conv_bounds(b, h, w, cin, cout, k, has_sigma, itemsize: int = 4) -> Dict:
    """The least time the card could take for one fused VDP conv: bytes
    (each input read once, each output written once; the moments in and
    out at ``itemsize`` bytes, 2 for bf16, the weights and ``win`` float32)
    over the memory rate, and the multiply-adds of both products as float32
    operations on the CUDA cores or as three TF32 passes on the tensor cores
    (3xTF32), or as one bf16 pass (``bound_bf16_ms``, the products of
    precision "default"). For bf16 moments also ``bound_2xtf32_ms``: a bf16
    value's small TF32 half is exactly 0, so two passes (big x big, big x
    the weight's small half) compute the same function."""
    ho, wo = h - k + 1, w - k + 1
    n_in = (2 if has_sigma else 1) * b * h * w * cin
    nbytes = (itemsize * (n_in + 2 * b * ho * wo * cout)
              + 4 * (k * k * cin * cout + cout + b * ho * wo))
    flops = (2 if has_sigma else 1) * 2 * k * k * cin * cout * b * ho * wo
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    out = {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
           "f32_ms": 1e3 * flops / F32_FLOPS_PER_S,
           "bound_ms": max(bytes_ms, 1e3 * flops / F32_FLOPS_PER_S),
           "bound_3xtf32_ms": max(bytes_ms, 1e3 * 3 * flops / TF32_FLOPS_PER_S),
           "bound_bf16_ms": max(bytes_ms, 1e3 * flops / BF16_FLOPS_PER_S)}
    if itemsize == 2:
        out["bound_2xtf32_ms"] = max(bytes_ms, 1e3 * 2 * flops / TF32_FLOPS_PER_S)
    return out


def device_ms(fn, runs: int = 20) -> float:
    """Device time of one call of ``fn`` in ms, without the host's share:
    after a warm-up the stream sleeps (``torch.cuda._sleep``) while the host
    queues ``runs`` calls behind it, and CUDA events bracket the calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~30 ms at 1.7 GHz: longer than the queueing
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def cold_device_ms(fn, runs: int = 20) -> float:
    """Median device time of one call of ``fn`` in ms with a cold L2: before
    each call the stream writes a buffer of twice the L2's size, and CUDA
    events bracket the call alone. The stream sleeps while the host queues
    the runs, so no host time counts."""
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    flush = torch.empty(2 * l2, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    events = []
    for _ in range(runs):
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bytes_ms(n_floats: int) -> float:
    """The least time the card takes to move ``n_floats`` float32 values."""
    return 1e3 * 4 * n_floats / HBM_BYTES_PER_S


def launch_floor_ms():
    """Device time of an empty kernel launch, queued back to back (None in a
    checkout whose library has no empty kernel)."""
    from supernet_tpu_torch.ops.kernels import _lib

    empty = getattr(_lib.load(), "supernet_empty_launch", None)
    if empty is None:
        return None
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    return device_ms(lambda: empty(stream), runs=200)


def _plan_fields(module, name: str, *shape) -> Dict:
    """The planner's path and grid for a layer ({} in a checkout without
    the planner)."""
    plan = getattr(module, name, None)
    if plan is None:
        return {}
    p = plan(*shape)
    return {"path": p.path, "blocks": p.blocks}


@contextlib.contextmanager
def act_dtype(name: str):
    """Run the block under activation dtype ``name``, then restore it."""
    before = get_act_dtype()
    set_act_dtype(name)
    try:
        yield
    finally:
        set_act_dtype("bfloat16" if before == torch.bfloat16 else "float32")


def layer_times(config: str, batch: int, seed: int = 0) -> Dict:
    """Kernels 1, 4 and 3 at every layer shape of one step at ``batch``, on
    seeded random inputs. ``layers``: vdp_conv at every k=3 conv, device ms
    of the kernel and of cuDNN's mu product alone (TF32 off), both bounds,
    and the plan (path, K slices). ``sigma_bwd``: the sigma-chain backward at
    the same convs' outputs; ``vmaxpool_bwd``: the pool backward at every
    pool; each with its device ms, its byte bound and its plan.
    ``launch_floor_ms``: an empty launch."""
    import torch.nn.functional as F

    from supernet_tpu_torch.ops.kernels import pool as P
    from supernet_tpu_torch.ops.kernels import sigma_bwd as S
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device; there is no CPU fallback")
    set_mxu_precision("highest")
    cfg = get_config(config).model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    convs, pools = layer_shapes(cfg)
    rows = []
    for layer, (_, h, w, cin), cout in convs:
        has_sigma = layer != "conv_input"
        mu = torch.randn(batch, h, w, cin, device="cuda", generator=gen)
        sigma = (0.05 * torch.randn(batch, h, w, cin, device="cuda", generator=gen).abs()
                 if has_sigma else None)
        w_mu = 0.1 * torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
        w_sigma = -4.0 + torch.randn(cout, device="cuda", generator=gen)
        plan = getattr(V, "plan", None)  # absent in the CUDA-core-only port
        p = plan(batch, h, w, cin, cout, 3) if plan else None
        with torch.inference_mode():
            ms = device_ms(lambda: V.vdp_conv(mu, sigma, w_mu, w_sigma, True))
            x, wt = mu.permute(0, 3, 1, 2), w_mu.permute(3, 2, 0, 1)
            cudnn_ms = device_ms(lambda: F.conv2d(x, wt))
        rows.append({
            "layer": layer, "shape": [batch, h, w, cin, cout, 3],
            "path": p.path if p else "simt", "splits": p.splits if p else 1,
            "device_ms": ms, "cudnn_mu_ms": cudnn_ms,
            **vdp_conv_bounds(batch, h, w, cin, cout, 3, has_sigma),
        })
    sigma_rows, pool_rows = [], []
    with torch.inference_mode():
        for layer, (_, h, w, _), c in convs:
            hp, wp = h - 2, w - 2
            g = torch.randn(batch, hp, wp, c, device="cuda", generator=gen)
            t = 10.0 * torch.randn(batch, hp, wp, device="cuda", generator=gen).abs()
            s_w = F.softplus(torch.randn(c, device="cuda", generator=gen) - 4.0)
            sigma_rows.append({
                "layer": layer, "shape": [batch, hp, wp, c, 3],
                **_plan_fields(S, "plan", batch, hp, wp, c, 3),
                "device_ms": device_ms(lambda: S.winsum_spread_bwd(g, t, s_w, 3)),
                "bound_ms": bytes_ms(g.numel() + t.numel() + batch * h * w + 2 * c),
            })
        for layer, (_, h, w, c) in pools:
            mu = torch.randn(batch, h, w, c, device="cuda", generator=gen)
            idx = P.vmaxpool(mu, mu.abs(), return_idx=True)[2]
            g_mu = torch.randn(idx.shape, device="cuda", generator=gen)
            g_sigma = torch.randn(idx.shape, device="cuda", generator=gen)
            pool_rows.append({
                "layer": layer, "shape": [batch, h, w, c],
                **_plan_fields(P, "plan_bwd", batch, h, w, c),
                "device_ms": device_ms(lambda: P.vmaxpool_bwd(idx, g_mu, g_sigma, h, w)),
                "bound_ms": bytes_ms(3 * idx.numel() + 2 * mu.numel()),
            })
    return {"mode": "layers", "config": config, "batch": batch,
            "device": torch.cuda.get_device_name(0), "layers": rows,
            "device_ms_sum": sum(r["device_ms"] for r in rows),
            "sigma_bwd": sigma_rows,
            "sigma_bwd_device_ms_sum": sum(r["device_ms"] for r in sigma_rows),
            "sigma_bwd_bound_ms_sum": sum(r["bound_ms"] for r in sigma_rows),
            "vmaxpool_bwd": pool_rows,
            "vmaxpool_bwd_device_ms_sum": sum(r["device_ms"] for r in pool_rows),
            "vmaxpool_bwd_bound_ms_sum": sum(r["bound_ms"] for r in pool_rows),
            "launch_floor_ms": launch_floor_ms()}


def profile_train_step(config: str, batch: int, seed: int = 0) -> Dict:
    """One ``make_train_step`` step on a batch that is already on the card."""
    cfg, tc, params, rng = _setup(config, seed)
    state, _ = train.create_train_state(params, tc, "cuda")
    step = train.make_train_step(cfg, tc)
    s, o = cfg.image_size, cfg.out_size
    x = torch.from_numpy(rng.normal(0, 1, (batch, s, s, cfg.in_channels))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (batch, o, o))
                         .astype(np.int32)).cuda()

    def run():
        step(state, x, y)
        torch.cuda.synchronize()

    out = _profile(run, "step")
    return {"mode": "train", "config": config, "batch": batch,
            "img_per_s": batch / (out["step_ms_median"] / 1e3), **out,
            "conversion_kernels_per_step": conversion_kernels(run)}


def ensemble_step_runner(config: str, batch: int, seed: int = 0, members: int = 4,
                         member_mode: str = "vmap"):
    """``run()``: one K-member ensemble step on batches already on the card,
    ending in a synchronise: the member-stacked step in ``member_mode`` vmap
    or unroll, or ``"sequential"`` (K single-model steps, one per member
    state). Members are initialised from ``seed + k``."""
    cfg, tc, _, rng = _setup(config, seed)
    states = [train.create_train_state(
        init_params(torch.Generator().manual_seed(seed + k), cfg, "cpu"), tc, "cuda")[0]
        for k in range(members)]
    s, o = cfg.image_size, cfg.out_size
    x = torch.from_numpy(rng.normal(0, 1, (members, batch, s, s, cfg.in_channels))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (members, batch, o, o))
                         .astype(np.int32)).cuda()
    if member_mode == "sequential":
        step = train.make_train_step(cfg, tc)

        def run():
            for k, state in enumerate(states):
                step(state, x[k], y[k])
            torch.cuda.synchronize()
    else:
        stacked = train.stack_trees(states)
        del states
        step = train.make_ensemble_train_step(cfg, tc, member_mode=member_mode)
        seeds = np.arange(members) + tc.seed

        def run():
            step(stacked, x, y, seeds)
            torch.cuda.synchronize()

    return run


def profile_ensemble_step(config: str, batch: int, seed: int = 0, members: int = 4,
                          member_mode: str = "vmap") -> Dict:
    """The profile of one :func:`ensemble_step_runner` step;
    ``member_step_ms`` is the step over the members."""
    run = ensemble_step_runner(config, batch, seed, members, member_mode)
    out = _profile(run, "step")
    return {"mode": "ensemble", "config": config, "batch": batch, "members": members,
            "member_mode": member_mode,
            "member_step_ms": out["step_ms_median"] / members,
            "img_per_s_per_member": batch / (out["step_ms_median"] / 1e3), **out}


def profile_train_step3d(config: str, batch: int, seed: int = 0,
                         remat: bool = False, steps: int = STEPS) -> Dict:
    """One ``train3d.make_train_step3d`` step on cubes already on the card,
    at the config's cube side, width and depth (``remat`` checkpoints each
    block), under the glue fold as it is set; ``steps`` timed and as
    many traced. Adds ``vols_per_s`` and ``conv3d_share``, the share of the
    step's device time in cuDNN's convolutions (every conv of the family)."""
    from supernet_tpu_torch import train3d
    from supernet_tpu_torch.models import init_params3d

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device; there is no CPU fallback")
    set_mxu_precision("highest")
    exp = get_config(config)
    cfg = dataclasses.replace(exp.model, remat=remat)
    cfg = dataclasses.replace(cfg, out_size=train3d.derive_out_size3d(cfg))
    params = init_params3d(torch.Generator().manual_seed(seed), cfg, "cpu")
    state, _ = train.create_train_state(params, exp.train, "cuda")
    step = train3d.make_train_step3d(cfg, exp.train)
    rng = np.random.default_rng(seed)
    s, o = cfg.image_size, cfg.out_size
    x = torch.from_numpy(rng.normal(0, 1, (batch, s, s, s, cfg.in_channels))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (batch, o, o, o))
                         .astype(np.int32)).cuda()

    def run():
        step(state, x, y)
        torch.cuda.synchronize()

    out = _profile(run, "step", steps)
    conv = out["categories_ms_per_step"].get(CATEGORIES[4][0], 0.0)
    return {"mode": "train3d", "config": config, "batch": batch, "remat": remat,
            "cube": s, "out_cube": o, "base_kernels": cfg.base_kernels,
            "depth": cfg.depth, "vols_per_s": batch / (out["step_ms_median"] / 1e3),
            "conv3d_share": conv / out["device_ms_per_step"], **out}


def conv3d_times(config: str, batch: int, seed: int = 0) -> Dict:
    """cuDNN's ``conv3d`` (TF32 off) at every k=3 layer of one volumetric
    forward at ``batch``, on seeded random inputs: device ms (:func:`device_ms`)
    of the forward and of the forward with the input and filter gradients,
    in the port's layout (NDHWC moments seen as ``channels_last_3d``) and in
    NCDHW, each with its TFLOP/s (2 x MACs; the backward's two products
    counted as twice the forward's). A vconv3d runs two such convs (mu and
    sigma; conv_input one)."""
    import torch.nn.functional as F

    from supernet_tpu_torch import train3d
    from supernet_tpu_torch.models.unet3d import layer_names3d, stage_shapes3d

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device; there is no CPU fallback")
    set_mxu_precision("highest")
    exp = get_config(config)
    cfg = dataclasses.replace(exp.model, out_size=train3d.derive_out_size3d(exp.model))
    ks = {n: (k, cin, cout) for n, k, cin, cout in layer_names3d(cfg)}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    layouts = (("channels_last_3d", torch.channels_last_3d), ("ncdhw", torch.contiguous_format))
    rows, sums = [], {}
    for name, shape in stage_shapes3d(cfg):
        if ks.get(name, (0,))[0] != 3:
            continue
        k, cin, cout = ks[name]
        o = shape[1]
        flops = 2.0 * batch * o ** 3 * cout * cin * k ** 3
        convs = 1 if name == "conv_input" else 2
        row = {"layer": name, "cin": cin, "cout": cout, "in_side": o + k - 1,
               "convs_per_layer": convs, "gflop": flops / 1e9}
        for label, fmt in layouts:
            def rand(*size, scale=1.0):
                t = scale * torch.randn(size, device="cuda", generator=gen)
                return t.contiguous(memory_format=fmt)

            x = rand(batch, cin, o + k - 1, o + k - 1, o + k - 1).requires_grad_(True)
            w = rand(cout, cin, k, k, k, scale=0.05).requires_grad_(True)
            g = rand(batch, cout, o, o, o)
            fwd = device_ms(lambda: F.conv3d(x, w), runs=10)
            both = device_ms(lambda: torch.autograd.grad(F.conv3d(x, w), (x, w), g), runs=10)
            row.update({f"{label}_fwd_ms": fwd, f"{label}_fwd_bwd_ms": both,
                        f"{label}_fwd_tflops": flops / fwd / 1e9,
                        f"{label}_fwd_bwd_tflops": 3 * flops / both / 1e9})
            for key, v in ((f"{label}_fwd_ms", fwd), (f"{label}_fwd_bwd_ms", both)):
                sums[key] = sums.get(key, 0.0) + convs * v
        rows.append(row)
    return {"mode": "layers3d", "config": config, "batch": batch,
            "device": torch.cuda.get_device_name(0), "layers": rows,
            "per_step_sums_ms": sums}


def profile_serving(config: str, batch: int, seed: int = 0) -> Dict:
    """One ``InferenceSession.predict`` request of 5 batches of numpy
    images (H2D copy, chunks of ``batch``, D2H copies included)."""
    cfg, _, params, rng = _setup(config, seed)
    sess = InferenceSession(params, cfg, batch_size=batch, device="cuda").warmup()
    s, images = cfg.image_size, 5 * batch
    x = rng.normal(0, 1, (images, s, s, cfg.in_channels)).astype(np.float32)
    out = _profile(lambda: sess.predict(x), "request")
    return {"mode": "serve", "config": config, "batch": batch, "images": images,
            "img_per_s": images / (out["request_ms_median"] / 1e3), **out,
            "conversion_kernels_per_request": conversion_kernels(lambda: sess.predict(x))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=("train", "serve", "layers", "train3d", "layers3d",
                                      "ensemble"),
                   default="train")
    p.add_argument("--config", default="hippocampus")
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--out", default=None, help="directory for the JSON")
    p.add_argument("--act-dtype", default="float32", choices=("float32", "bfloat16"),
                   help="activation dtype of the train and serve modes")
    p.add_argument("--remat", action="store_true",
                   help="train3d: checkpoint each block (cfg.remat)")
    p.add_argument("--members", type=int, default=4, help="ensemble: K")
    p.add_argument("--ensemble-mode", default="vmap",
                   choices=("vmap", "unroll", "sequential"),
                   help="ensemble: the member axis through the kernels, a loop "
                        "of the single-model forward and backward, or K "
                        "single-model steps")
    a = p.parse_args(argv)
    fn = {"train": profile_train_step, "serve": profile_serving,
          "layers": layer_times,
          "train3d": functools.partial(profile_train_step3d, remat=a.remat),
          "layers3d": conv3d_times,
          "ensemble": functools.partial(profile_ensemble_step, members=a.members,
                                        member_mode=a.ensemble_mode)}[a.mode]
    if a.mode in ("layers", "layers3d") and a.act_dtype != "float32":
        p.error("--act-dtype applies to the train and serve modes")
    with act_dtype(a.act_dtype):
        res = fn(a.config, a.batch)
    res["act_dtype"] = a.act_dtype
    res["precision"] = precision = get_mxu_precision()
    line = json.dumps(res)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        tag = ("" if a.act_dtype == "float32" else f"_{a.act_dtype}") + (
            "" if precision == "highest" else f"_{precision}") + (
            "_remat" if a.remat else "") + (
            f"_k{a.members}_{a.ensemble_mode}" if a.mode == "ensemble" else "")
        with open(os.path.join(a.out, f"profile_{a.mode}_{a.config}_b{a.batch}{tag}.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
