"""Where the time of a training step or a serving request goes on the card.

    python -m supernet_tpu_torch.profiling --mode train --config hippocampus --batch 20
    python -m supernet_tpu_torch.profiling --mode serve --config brats --batch 2

builds a train state (or an ``InferenceSession``) from ``init_params``
(seeded; the time does not depend on the weights' values), runs WARMUP
steps (requests of 5 batches), times STEPS more with the host clock (each
ends in ``torch.cuda.synchronize()`` or the answer's copy to the host),
then traces STEPS more under ``torch.profiler`` and sorts the device time
of every kernel into the categories of :data:`CATEGORIES`. The device's
busy share is its traced kernel and copy time over the untraced median
step (request) time; the rest is idle (host dispatch, synchronisation).
Prints one JSON object; ``--out DIR`` also writes it there. Needs a CUDA
device: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from supernet_tpu_torch import train
from supernet_tpu_torch.configs import get_config
from supernet_tpu_torch.models import init_params
from supernet_tpu_torch.ops import set_mxu_precision
from supernet_tpu_torch.serving import InferenceSession

# (label, substrings of the kernel name), first match wins: the four
# hand-written kernels come before the generic convolution names, and the
# convolutions before cuBLAS' matrix products, since cuDNN's dgrad and
# wgrad kernels also say "gemm". cuDNN's FFT algorithms run FFTs and complex
# (cf32) products; the port itself computes nothing complex.
CATEGORIES = (
    ("vdp_conv (kernel 1)", ("vdp_conv_kernel",)),
    ("pool forward (kernel 2)", ("vmaxpool_fwd_kernel",)),
    ("pool backward (kernel 3)", ("vmaxpool_bwd_kernel",)),
    ("sigma backward (kernel 4)", ("sigma_bwd_kernel",)),
    ("cuDNN convolutions (VDPConv backward)", ("conv", "dgrad", "wgrad", "fprop", "cudnn", "fft", "cf32")),
    ("Adam", ("multi_tensor", "adam")),
    ("matmuls (1x1 head, unpool conv)", ("gemm",)),
    ("copies and fills", ("memcpy", "memset")),
)
OTHER = "other (elementwise, reductions, clip norms)"
WARMUP, STEPS = 3, 10


def category(kernel_name: str) -> str:
    name = kernel_name.lower()
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return label
    return OTHER


def _device_events(prof) -> List:
    """The kernels, copies and fills on the device. The device timeline
    also carries each ``record_function`` range (the layer names, the
    optimizer step) as an annotation spanning its kernels; those are left
    out, or their kernels would count twice."""
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host_names]


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


def _setup(config: str, seed: int):
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device; there is no CPU fallback")
    set_mxu_precision("highest")
    exp = get_config(config)
    params = init_params(torch.Generator().manual_seed(seed), exp.model, "cpu")
    return exp.model, exp.train, params, np.random.default_rng(seed)


def _profile(run, per: str) -> Dict:
    """Time ``run`` (one step or request, ending in a synchronise) untraced,
    then trace as many more and sort their device time."""
    steps = STEPS
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
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        traced_s = time.perf_counter() - t0
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
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "device": torch.cuda.get_device_name(0), "steps": steps,
        f"{per}_ms_median": 1e3 * step_s,
        f"traced_{per}_ms": 1e3 * traced_s / steps,
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
    }


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
            "img_per_s": batch / (out["step_ms_median"] / 1e3), **out}


def profile_serving(config: str, batch: int, seed: int = 0) -> Dict:
    """One ``InferenceSession.predict`` request of 5 batches of numpy
    images (H2D copy, chunks of ``batch``, D2H copies included)."""
    cfg, _, params, rng = _setup(config, seed)
    sess = InferenceSession(params, cfg, batch_size=batch, device="cuda").warmup()
    s, images = cfg.image_size, 5 * batch
    x = rng.normal(0, 1, (images, s, s, cfg.in_channels)).astype(np.float32)
    out = _profile(lambda: sess.predict(x), "request")
    return {"mode": "serve", "config": config, "batch": batch, "images": images,
            "img_per_s": images / (out["request_ms_median"] / 1e3), **out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=("train", "serve"), default="train")
    p.add_argument("--config", default="hippocampus")
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--out", default=None, help="directory for the JSON")
    a = p.parse_args(argv)
    fn = profile_train_step if a.mode == "train" else profile_serving
    line = json.dumps(fn(a.config, a.batch))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, f"profile_{a.mode}_{a.config}_b{a.batch}.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
