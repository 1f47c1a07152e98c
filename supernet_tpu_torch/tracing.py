"""Spans and counters of the program: where the time of a serving request or
a train step goes, on the clock of ``torch.profiler``'s events.

``span(name)`` marks a stage of the program::

    with tracing.span("session.wait"):
        torch.cuda.current_stream().synchronize()

Tracing is on while :func:`enable` holds (``SUPERNET_TRACE=<path>`` calls it
when this module is imported) or while a ``torch.profiler`` records (from its
first ``step()`` on: its warm-up phase records nothing). When it is off,
``span`` checks two flags and returns one shared context manager that does
nothing: no ``record_function``, no clock read, no allocation.

When it is on, each span appends a record at its exit to a buffer that
keeps the last :data:`CAP`. A record (:func:`records`) holds ``name``, ``id``,
``parent`` (the id of the span open around it in the same thread, or None),
``root`` (the id of the outermost span around it: every span of one request
or one step shares it), ``start_ns`` and ``end_ns`` on the profiler's clock
(the Unix clock in nanoseconds, ``time.time_ns``: the one kineto places its
events on), and ``device_ms``. While a profiler records, the span also opens
``torch.profiler.record_function(name)``, so its range lands in the trace
beside the device's kernels. A span made with ``device=True`` records a CUDA
event on the current stream at its entry and at its exit (once CUDA is
initialised); :func:`records` resolves the device time between them, waiting
for the exit event then and never on the hot path. ``device_ms`` is None for
every other span.

:func:`count` adds to a named counter; counters are always on.
:func:`counters` returns them with the hand-written kernels' launch counters,
read where they live (``ops/kernels``: ``vdp_conv.launches``,
``pool.bwd_launches``, ...).

``SUPERNET_TRACE=<path>`` writes the records and the counters to ``<path>`` as
JSON lines when the process exits: one object per record, oldest first, then
``{"counters": {...}}``.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

CAP = 100_000  # records kept: a server with tracing on does not grow
ENV = "SUPERNET_TRACE"

# the launch counters of ops/kernels, by module
KERNEL_COUNTERS = (
    ("vdp_conv", ("launches", "reduce_launches", "dgrad_launches",
                  "dgrad_reduce_launches", "bf16_launches")),
    ("pool", ("launches", "bwd_launches")),
    ("sigma_bwd", ("launches",)),
)

_enabled = False
_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=CAP)
_counts: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    """One open span (see the module's docstring)."""

    __slots__ = ("name", "device", "id", "parent", "root", "start_ns", "_range", "_start")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.root = outer.root if outer is not None else self.id
        stack.append(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        self._start = None
        if self.device and torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc):
        device = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            device = (self._start, end)
        if self._range is not None:
            self._range.__exit__(*exc)
        # the clock is read after the range opens and after it closes: the
        # range stamps its start and end inside those calls, a few
        # microseconds before each reading (the CUDA events lie outside both
        # readings' lag)
        end_ns = time.time_ns()
        _stack().pop()
        record = [self.name, self.id, self.parent, self.root, self.start_ns, end_ns, device]
        with _lock:
            _records.append(record)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, device: bool = False):
    """A context manager that marks the stage ``name`` (see the module's
    docstring); with ``device`` it also times the stage on the device."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def _kernel_modules():
    from supernet_tpu_torch.ops.kernels import pool, sigma_bwd, vdp_conv

    return {"vdp_conv": vdp_conv, "pool": pool, "sigma_bwd": sigma_bwd}


def counters() -> Dict[str, int]:
    """Every counter: the kernels' launch counters (``<module>.<name>``)
    and those of :func:`count`."""
    mods = _kernel_modules()
    out = {f"{m}.{a}": getattr(mods[m], a) for m, attrs in KERNEL_COUNTERS for a in attrs}
    with _lock:
        out.update(_counts)
    return out


def records() -> List[dict]:
    """The records kept, oldest first, each a new dict (see the module's
    docstring); a device-timed span's time is resolved here."""
    with _lock:
        kept = list(_records)
    out = []
    for r in kept:
        if isinstance(r[6], tuple):
            start, end = r[6]
            end.synchronize()
            r[6] = float(start.elapsed_time(end))
        out.append(dict(name=r[0], id=r[1], parent=r[2], root=r[3], start_ns=r[4],
                        end_ns=r[5], device_ms=r[6]))
    return out


def enable() -> None:
    """Tracing on, until :func:`disable`."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Tracing off (spans still record while a profiler does)."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop the records and set every counter to 0, the kernels' too."""
    mods = _kernel_modules()
    with _lock:
        _records.clear()
        _counts.clear()
        for m, attrs in KERNEL_COUNTERS:
            for a in attrs:
                setattr(mods[m], a, 0)


def export(path: str) -> None:
    """Write :func:`records` and :func:`counters` to ``path`` as JSON lines."""
    lines = [json.dumps(r) for r in records()]
    lines.append(json.dumps({"counters": counters()}))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


if os.environ.get(ENV):
    enable()
    atexit.register(export, os.environ[ENV])
