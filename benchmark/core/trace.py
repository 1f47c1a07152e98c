"""A profiled stretch of a run and its reduction: device busy time, the
operations by kernel name and category, the idle gaps by what the host was
doing.

``profile_stretch(unit, count)`` runs ``unit`` (one training step, one
request) under ``torch.profiler``: once in the profiler's warm-up phase
(discarded), once more recorded and left out (the trace may lose the device
records of the first kernels after recording starts; see
``supernet_tpu_torch/profiling.py:recording``), then ``count`` times inside
the range ``bench.stretch``, each unit in a range ``bench.unit`` and the last
followed by a synchronisation. Only device records that start inside
``bench.stretch`` count. The trace stays in memory; nothing is written.

The categories are a frozen copy of ``supernet_tpu_torch/profiling.py``'s
``CATEGORIES`` (first match on a substring of the kernel name wins).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

CATEGORIES = (
    ("vdp_conv (kernel 1)", ("vdp_conv_kernel",)),
    ("pool forward (kernel 2)", ("vmaxpool_fwd",)),
    ("pool backward (kernel 3)", ("vmaxpool_bwd",)),
    ("sigma backward (kernel 4)", ("sigma_bwd",)),
    ("cuDNN convolutions", ("conv", "dgrad", "wgrad", "fprop", "cudnn", "fft", "cf32")),
    ("Adam", ("multi_tensor", "adam")),
    ("matmuls (1x1 head, unpool conv)", ("gemm",)),
    ("copies and fills", ("memcpy", "memset")),
)
OTHER = "other (elementwise, reductions, clip norms)"

Interval = Tuple[str, float, float]  # (name, start_us, end_us)


def category(kernel: str) -> str:
    name = kernel.lower()
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return label
    return OTHER


@dataclass
class Stretch:
    """What the profiler saw inside ``bench.stretch``."""

    start_us: float
    end_us: float
    units: int
    device: List[Interval] = field(default_factory=list)  # kernels, copies, fills
    host: List[Interval] = field(default_factory=list)  # CPU ops and ranges
    unit_spans: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def busy_us(self, within: List[Tuple[float, float]] = None) -> float:
        """The union of the device intervals, clipped to ``within`` (a list
        of disjoint spans) when given."""
        merged = union([(s, e) for _, s, e in self.device])
        if within is None:
            return sum(e - s for s, e in merged)
        total = 0.0
        for a, b in union(within):
            for s, e in merged:
                total += max(0.0, min(b, e) - max(a, s))
        return total

    def device_time_us(self, categories) -> float:
        """Summed device time of the kernels in ``categories``."""
        return sum(e - s for n, s, e in self.device if category(n) in categories)

    def ops_by_name(self, top: int = 10) -> List[List]:
        acc: Dict[str, float] = {}
        for n, s, e in self.device:
            key = f"{category(n)}: {n[:96]}"
            acc[key] = acc.get(key, 0.0) + (e - s)
        ranked = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v * 1e-6] for k, v in ranked]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time inside the stretch, summed by the
        innermost host range or operation running at each gap's middle."""
        merged = union([(s, e) for _, s, e in self.device])
        gaps, prev = [], self.start_us
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.end_us > prev:
            gaps.append((prev, self.end_us))
        # a sweep over the gaps' middles in order: the host intervals begun
        # so far on a heap by length; the shortest not yet ended contains
        # the middle and is the innermost
        host = sorted((s, e, n) for n, s, e in self.host)
        heap: List[Tuple[float, float, str]] = []
        acc: Dict[str, float] = {}
        i = 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][0] <= mid:
                s, e, n = host[i]
                heapq.heappush(heap, (e - s, e, n))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            key = heap[0][2] if heap else "host: between operations"
            acc[key] = acc.get(key, 0.0) + (b - a)
        ranked = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v * 1e-6] for k, v in ranked]


def union(spans) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_stretch(unit: Callable[[], object], count: int) -> Stretch:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        unit()
        _sync()
        prof.step()
        unit()
        _sync()
        with torch.profiler.record_function("bench.stretch"):
            for _ in range(count):
                with torch.profiler.record_function("bench.unit"):
                    unit()
            _sync()
    return reduce(prof.events(), count)


def reduce(events, count: int) -> Stretch:
    cuda = torch.autograd.DeviceType.CUDA
    host_names = set()
    host, units, stretch = [], [], None
    for e in events:
        if e.device_type == cuda:
            continue
        host_names.add(e.name)
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == "bench.stretch":
            stretch = span
        elif e.name == "bench.unit":
            units.append(span[1:])
        host.append(span)
    if stretch is None:
        raise RuntimeError("the trace holds no bench.stretch range")
    _, s0, s1 = stretch
    device = [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in events
              if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
              and e.name not in host_names and not e.name.startswith("ProfilerStep")
              and s0 <= e.time_range.start <= s1]
    inner = [h for h in host if s0 <= h[1] and h[2] <= s1 and h[0] != "bench.stretch"]
    return Stretch(s0, s1, count, device, inner, sorted(units))
