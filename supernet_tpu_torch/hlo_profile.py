"""Exact-join per-op profiling: trace a train step and attribute every device
event to the operator that launched it, and through that operator to an op
class and a layer. The counterpart of ``supernet_tpu/hlo_profile.py``.

Why the join (``supernet_tpu/hlo_profile.py:3-11``): bucketing device events
by name alone misattributes them. On the card a cuDNN kernel's name often
says nothing of whether it is a forward conv, an input gradient or a filter
gradient, and the backward's kernels run on autograd's thread, outside every
``record_function`` range the forward opened. So each event is joined
through what the ``torch.profiler`` trace records:

- a kernel, copy or fill carries a ``correlation`` id, the same as the CUDA
  runtime (or driver) call that launched it on a host thread;
- that call lies inside the operators that made it: the innermost is the
  launching operator, the ranges around it are its ancestry;
- a forward operator's layer is the ``record_function`` range around it
  (``models.forward`` and ``forward3d`` open one per layer name);
- a backward operator runs inside an autograd node whose ``Sequence number``
  is that of the forward operator that made the node (``Fwd thread id`` set),
  and takes that operator's layer.

An event whose launching call is not in the trace, or lies inside no
operator, is unjoined: it is reported on its own row, never folded into a
class. On a trace without device events (a CPU run) the host operators are
the events, each by its self time, joined to itself; that is how the tests
exercise the join.

Usage (on the card; ``--device cpu`` on a host without one):

    python -m supernet_tpu_torch.cli profile --config hippocampus --batch 20 --by-layer
    python -m supernet_tpu_torch.cli profile --config unet3d --batch 4

prints the class table (ms/step, events, %), the unjoined row, and with
``--by-layer`` the per-layer time of the matrix classes (kernel 1, cuDNN's
convs, GEMMs); writes the JSON twin to ``<out_dir>/exact_join.json`` with
the JAX twin's keys.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from supernet_tpu_torch import xplane as X

# the layer names of models.layer_names / layer_names3d, word-bounded
_LAYER_RE = re.compile(r"^(conv_input|up\d+_conv(?:2x2|\d)|conv\d+|conv_final)$")
_HOST_CATEGORIES = ("cpu_op", "user_annotation")
MATRIX_CLASSES = (X.KERNEL_CLASSES["forward"], X.KERNEL_CLASSES["transposed"],
                  X.CONV_FWD, X.CONV_DGRAD, X.CONV_WGRAD, X.CONV_BWD, X.GEMM)
# the range of run's settling call: the card's trace loses the device
# records of some of the first kernels launched after recording starts (an
# H100 with PyTorch 2.11 and CUDA 12.8; the profiler's warm-up phase makes
# it rarer, not rare enough for an exact count), so the trace opens with one
# call of the traced work in this range, which the join leaves out
SETTLE = "profile_settle"
# the launch counters of ops/kernels (chip_smoke.py's names): each counts
# one main kernel per call; kernel 1's split-K reduce and kernel 4's second
# kernel of its vec4 path are not calls, and kernel 1's weight-planes
# prologue is counted by ``vdp_conv.weight_plane_launches`` alone
COUNTERS = ("vdp_conv", "vdp_conv_reduce", "vmaxpool", "vmaxpool_bwd", "sigma_bwd",
            "vdp_conv_dgrad", "vdp_conv_dgrad_reduce", "vdp_norm", "vdp_norm_bwd")


def launch_counter(name: str) -> Optional[str]:
    """The launch counter a device event adds to, from its kernel name
    (None for every other kernel)."""
    mode = X.kernel1_mode(name)
    if mode is not None and "weight_planes" not in name:
        base = "vdp_conv" if mode == "forward" else "vdp_conv_dgrad"
        return base + "_reduce" if "splitk_reduce" in name else base
    if "vmaxpool_fwd" in name:
        return "vmaxpool"
    if "vmaxpool_bwd" in name:
        return "vmaxpool_bwd"
    if "sigma_bwd_dt" in name or "sigma_bwd_rows" in name:
        return "sigma_bwd"
    # a norm call's first kernel: its other kernels count as no call
    if "vdp_norm_row_fwd" in name or "vdp_norm_slice_mean" in name:
        return "vdp_norm"
    if "vdp_norm_row_bwd" in name or "vdp_norm_slice_bwd_sums" in name:
        return "vdp_norm_bwd"
    return None


def _nest(host: List[X.Event]) -> Dict[int, Optional[X.Event]]:
    """``{id(event): parent}`` of the host events (operators, ranges and
    launch calls), each thread's events nested by time."""
    parent: Dict[int, Optional[X.Event]] = {}
    by_thread = collections.defaultdict(list)
    for e in host:
        by_thread[(e.pid, e.tid)].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.ts, -e.dur))
        stack: List[X.Event] = []
        for e in evs:
            while stack and e.ts >= stack[-1].end:
                stack.pop()
            parent[id(e)] = stack[-1] if stack else None
            stack.append(e)
    return parent


class _Joiner:
    """Layer and backward attribution of host events."""

    def __init__(self, host: List[X.Event]):
        self.parent = _nest(host)
        self.layer_cache: Dict[int, str] = {}
        # forward operators by sequence number. Every operator records the
        # thread's next number, and the one that makes an autograd node
        # takes it: the last forward operator with a number made its node
        # (an earlier one, such as an input's cast, made none)
        self.fwd_by_seq: Dict[int, X.Event] = {}
        for e in sorted(host, key=lambda e: (e.ts, -e.dur)):
            seq = e.args.get("Sequence number")
            if e.cat == "cpu_op" and seq is not None and not e.args.get("Fwd thread id"):
                self.fwd_by_seq[int(seq)] = e

    def ancestry(self, e: X.Event):
        while e is not None:
            yield e
            e = self.parent.get(id(e))

    def backward_node(self, e: X.Event) -> Optional[X.Event]:
        """The nearest autograd node around ``e`` (an operator with a
        ``Fwd thread id``), or None in the forward."""
        for a in self.ancestry(e):
            if a.cat == "cpu_op" and a.args.get("Fwd thread id"):
                return a
        return None

    def layer(self, e: X.Event) -> str:
        """The layer of ``e``: the layer range around it, or for a backward
        operator that of the forward operator its node came from."""
        key = id(e)
        if key in self.layer_cache:
            return self.layer_cache[key]
        out = "(unscoped)"
        for a in self.ancestry(e):
            if a.cat == "user_annotation" and _LAYER_RE.match(a.name):
                out = a.name
                break
        else:
            node = self.backward_node(e)
            fwd = None if node is None else self.fwd_by_seq.get(
                int(node.args.get("Sequence number", -1)))
            if fwd is not None and fwd is not e:
                out = self.layer(fwd)
        self.layer_cache[key] = out
        return out

    def classify(self, name: str, cat: str, op: X.Event) -> str:
        """``xplane.op_class`` of the event, refined by the launching
        operator ``op``'s ancestry: an unnamed kernel under a convolution is
        the convolution's, anything under the optimizer's step range is the
        optimizer's."""
        chain = list(self.ancestry(op))
        backward = any(a.cat == "cpu_op" and a.args.get("Fwd thread id") for a in chain)
        cls = X.op_class(name, cat, backward)
        if cls in (X.GEMM, X.ELEMENTWISE, X.REDUCE):
            for a in chain:
                if a.name == "aten::convolution_backward":
                    return X.CONV_BWD
                if a.name in ("aten::cudnn_convolution", "aten::_convolution",
                              "aten::convolution", "aten::mkldnn_convolution"):
                    return X.CONV_BWD if backward else X.CONV_FWD
        if cls not in X.KERNEL_CLASSES.values() and any(
                a.name.startswith("Optimizer.step") for a in chain):
            return X.OPTIMIZER
        return cls


def _busy_us(events: List[X.Event]) -> float:
    """Length of the union of the events' time ranges."""
    busy, end = 0.0, -float("inf")
    for e in sorted(events, key=lambda e: e.ts):
        if e.ts > end:
            busy += e.dur
            end = e.end
        elif e.end > end:
            busy += e.end - end
            end = e.end
    return busy


def drop_settle(events: List[X.Event]) -> List[X.Event]:
    """The events less those of the settling call: every host event that
    starts inside a ``SETTLE`` range (on any thread: the call ends in a
    synchronise inside the range, so its backward ran there too) and every
    device event that a launch call among them made."""
    spans = [(e.ts, e.end) for e in events if e.cat == "user_annotation" and e.name == SETTLE]
    if not spans:
        return events

    def inside(e: X.Event) -> bool:
        return any(a <= e.ts <= b for a, b in spans)

    made = {e.args["correlation"] for e in events
            if e.cat in X.LAUNCH_CATEGORIES and "correlation" in e.args and inside(e)}
    return [e for e in events
            if (e.args.get("correlation") not in made if e.cat in X.DEVICE_CATEGORIES
                else not inside(e))]


def lost_launches(events: List[X.Event]) -> int:
    """The kernel launch calls in ``events`` whose kernel has no device
    event: records the trace lost (0 on a trace without device events)."""
    if not X.device_events(events):
        return 0
    made = {e.args.get("correlation") for e in X.device_events(events)}
    return sum(1 for e in events if e.cat in X.LAUNCH_CATEGORIES and "LaunchKernel" in e.name
               and e.args.get("correlation") not in made)


def join(events: List[X.Event], steps: int, by_layer: bool = False) -> Dict:
    """Join the events of one trace of ``steps`` train steps, less those
    of a settling call (:func:`drop_settle`). Returns the
    per-step tables: ``classes`` (class, ms_per_step, events, pct, and for
    kernels 1-4 ``launches``), ``unmatched_ms_per_step`` and ``unmatched``
    (the unjoined events by name), ``total_ms_per_step`` (joined +
    unjoined), ``device_busy_ms_per_step`` (the union of the device events'
    ranges; None on a CPU trace), ``kernel_launches`` (per counter, over the
    trace), ``lost_launches`` (:func:`lost_launches`), ``on_device``, and
    with ``by_layer`` ``layers_mxu`` (the matrix
    classes per layer) and ``layer_classes`` (every class per layer)."""
    events = drop_settle(events)
    host = [e for e in events if e.cat in _HOST_CATEGORIES + X.LAUNCH_CATEGORIES]
    joiner = _Joiner(host)
    device = X.device_events(events)
    agg = collections.defaultdict(lambda: [0.0, 0])
    lagg = collections.defaultdict(lambda: [0.0, 0])
    unmatched = collections.defaultdict(lambda: [0.0, 0])
    launches = dict.fromkeys(COUNTERS, 0)
    work = []  # (name, cat, us, launching operator or None)
    if device:
        by_corr = {e.args["correlation"]: e for e in host
                   if e.cat in X.LAUNCH_CATEGORIES and "correlation" in e.args}
        for e in device:
            call = by_corr.get(e.args.get("correlation"))
            op = None if call is None else joiner.parent.get(id(call))
            work.append((e.name, e.cat, e.dur, op))
            counter = launch_counter(e.name)
            if counter is not None:
                launches[counter] += 1
    else:
        ops = X.self_times([e for e in events if e.cat == "cpu_op"])
        work = [(e.name, e.cat, e.self_us, e) for e in ops]
    for name, cat, us, op in work:
        if op is None:
            key = re.sub(r"<.*", "", name.replace("void ", ""))[:60]
            unmatched[key][0] += us
            unmatched[key][1] += 1
            continue
        cls = joiner.classify(name, cat, op)
        agg[cls][0] += us
        agg[cls][1] += 1
        if by_layer:
            lay = joiner.layer(op)
            lagg[(lay, cls)][0] += us
            lagg[(lay, cls)][1] += 1
    total = sum(us for us, _ in agg.values()) + sum(us for us, _ in unmatched.values())

    def ms(us: float) -> float:
        return us / 1e3 / steps

    def pct(us: float) -> float:
        return 100.0 * us / total if total else 0.0

    kernel_launches = {
        X.KERNEL_CLASSES["forward"]: launches["vdp_conv"],
        X.KERNEL_CLASSES["transposed"]: launches["vdp_conv_dgrad"],
        X.POOL_FWD: launches["vmaxpool"], X.POOL_BWD: launches["vmaxpool_bwd"],
        X.SIGMA_BWD: launches["sigma_bwd"],
        X.NORM: launches["vdp_norm"] + launches["vdp_norm_bwd"]}
    rows = []
    for cls, (us, n) in sorted(agg.items(), key=lambda kv: -kv[1][0]):
        row = {"class": cls, "ms_per_step": ms(us), "events": n, "pct": pct(us)}
        if cls in kernel_launches:
            row["launches"] = kernel_launches[cls]
        rows.append(row)
    un_us = sum(us for us, _ in unmatched.values())
    out = {
        "on_device": bool(device),
        "classes": rows,
        "unmatched_ms_per_step": ms(un_us),
        "unmatched_events": sum(n for _, n in unmatched.values()),
        "unmatched": [{"name": k, "ms_per_step": ms(us), "events": n}
                      for k, (us, n) in sorted(unmatched.items(), key=lambda kv: -kv[1][0])],
        "total_ms_per_step": ms(total),
        "device_busy_ms_per_step": ms(_busy_us(device)) if device else None,
        "kernel_launches": launches,
        "lost_launches": lost_launches(events),
    }
    if by_layer:
        per_layer = collections.defaultdict(lambda: [0.0, 0])
        for (lay, cls), (us, n) in lagg.items():
            if cls in MATRIX_CLASSES:
                per_layer[lay][0] += us
                per_layer[lay][1] += n
        out["layers_mxu"] = [
            {"layer": lay, "ms_per_step": ms(us), "events": n, "pct": pct(us)}
            for lay, (us, n) in sorted(per_layer.items(), key=lambda kv: -kv[1][0])]
        out["layer_classes"] = [
            {"layer": lay, "class": cls, "ms_per_step": ms(us), "events": n}
            for (lay, cls), (us, n) in sorted(lagg.items())]
    return out


# --------------------------------------------------------------------------
# build step -> trace -> join
# --------------------------------------------------------------------------


def build_step(model: str, batch: int, device: str = "cuda"):
    """The bench's production path, as ``supernet_tpu/hlo_profile.py:175-248``
    builds it: ``make_multi_train_step`` with K steps per call (K from
    SUPERNET_BENCH_DISPATCH, default 8; 1 is ``make_train_step``), seeded
    ``init_params`` and a seeded batch on ``device``, every step of a call
    on the same batch; ``model`` a 2-D config name or ``unet3d`` (the
    hippocampus 3-D geometry, ``make_multi_train_step3d``). The caller
    sets the activation dtype. Returns ``(step, state, x, y, k_steps)``."""
    import torch

    from supernet_tpu_torch import train
    from supernet_tpu_torch.configs import get_config

    k_steps = int(os.environ.get("SUPERNET_BENCH_DISPATCH", "8"))
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    if model == "unet3d":
        from supernet_tpu_torch import train3d
        from supernet_tpu_torch.models import init_params3d

        exp = get_config("hippocampus")
        cfg = dataclasses.replace(exp.model, out_size=train3d.derive_out_size3d(exp.model))
        s, o = cfg.image_size, cfg.out_size
        x = rng.normal(0, 1, (batch, s, s, s, cfg.in_channels)).astype(np.float32)
        y = rng.integers(0, cfg.n_classes, (batch, o, o, o)).astype(np.int32)
        params = init_params3d(gen, cfg, device)
        multi, single = train3d.make_multi_train_step3d, train3d.make_train_step3d
    else:
        from supernet_tpu_torch.models import init_params

        exp = get_config(model)
        cfg = exp.model
        s, o = cfg.image_size, cfg.out_size
        x = rng.normal(0, 1, (batch, s, s, cfg.in_channels)).astype(np.float32)
        y = rng.integers(0, cfg.n_classes, (batch, o, o)).astype(np.int32)
        params = init_params(gen, cfg, device)
        multi, single = train.make_multi_train_step, train.make_train_step
    state, _ = train.create_train_state(params, exp.train, device)
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    if k_steps > 1:
        x = x.expand((k_steps,) + tuple(x.shape))
        y = y.expand((k_steps,) + tuple(y.shape))
        return multi(cfg, exp.train, k_steps), state, x, y, k_steps
    return single(cfg, exp.train), state, x, y, k_steps


def launch_counts() -> Dict[str, int]:
    """The kernel launch counters of ops/kernels, by ``COUNTERS`` name."""
    from supernet_tpu_torch.ops.kernels import pool as P
    from supernet_tpu_torch.ops.kernels import sigma_bwd as S
    from supernet_tpu_torch.ops.kernels import vdp_conv as V
    from supernet_tpu_torch.ops.kernels import vdp_norm as N

    return {"vdp_conv": V.launches, "vdp_conv_reduce": V.reduce_launches,
            "vmaxpool": P.launches, "vmaxpool_bwd": P.bwd_launches,
            "sigma_bwd": S.launches, "vdp_conv_dgrad": V.dgrad_launches,
            "vdp_conv_dgrad_reduce": V.dgrad_reduce_launches,
            "vdp_norm": N.launches, "vdp_norm_bwd": N.bwd_launches}


def run(model: str, batch: int, trace_dir: str, n_iters: int = 20,
        by_layer: bool = False, device: str = "cuda") -> Dict:
    """Build the step (bf16 activations unless SUPERNET_ACT_DTYPE says
    otherwise; the other SUPERNET_* knobs as set), run one call to warm up
    and one more in the profiler's warm-up phase, trace a settling call
    (``SETTLE``) and ``n_iters`` calls into ``trace_dir``
    (``profiling.trace``), join
    the trace (:func:`join`), print the tables and write them to
    ``<trace_dir>/exact_join.json``. The activation dtype is restored
    afterwards. ``counted_launches`` is the kernels' own launch counters
    over the traced calls, beside the trace's ``kernel_launches``;
    ``lost_launches`` and ``settle_lost_launches`` count the kernels whose
    records the trace lost in the traced calls and in the settling call."""
    import torch

    from supernet_tpu_torch import profiling
    from supernet_tpu_torch.ops import apply_env_overrides, get_act_dtype

    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"profile on {device!r} needs a CUDA device; pass "
                           "device='cpu' (--device cpu) to profile on the host")
    act = os.environ.get("SUPERNET_ACT_DTYPE", "bfloat16")
    with profiling.act_dtype(act):
        apply_env_overrides()
        step, state, x, y, k_steps = build_step(model, batch, device)

        def calls(n):
            nonlocal state
            for _ in range(n):
                state, metrics = step(state, x, y)
            float(metrics.loss.min())
            if device != "cpu":
                torch.cuda.synchronize()

        calls(1)  # warm-up call
        with profiling.trace(trace_dir, warmup=lambda: calls(1)):
            with torch.profiler.record_function(SETTLE):
                calls(1)
            before = launch_counts()
            t0 = time.perf_counter()
            calls(n_iters)
            wall = time.perf_counter() - t0
            after = launch_counts()
        act_name = "bfloat16" if get_act_dtype() == torch.bfloat16 else "float32"
    steps = n_iters * k_steps
    path = X.newest_trace(trace_dir)
    events = X.load_trace(path)
    res = join(events, steps, by_layer)
    out = {
        "model": model, "batch": batch, "k_steps": k_steps, "n_iters": n_iters,
        "wall_ms_per_step": 1e3 * wall / steps,
        # the union of the device events' ranges (the JAX twin reads its
        # "Steps" line); None on a CPU trace
        "device_steps_ms_per_step": res["device_busy_ms_per_step"],
        # a torch step has no device control-flow op to span its body
        "control_ms_per_step": 0.0,
        "classes": res["classes"],
        "unmatched_ms_per_step": res["unmatched_ms_per_step"],
        "total_ms_per_step": res["total_ms_per_step"],
        "device": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
        "act_dtype": act_name, "trace": os.path.basename(path),
        "unmatched_events": res["unmatched_events"], "unmatched": res["unmatched"][:8],
        "kernel_launches": res["kernel_launches"],
        "counted_launches": {k: after[k] - before[k] for k in COUNTERS},
        "lost_launches": res["lost_launches"],
        "settle_lost_launches": lost_launches(events) - res["lost_launches"],
    }
    if by_layer:
        out["layers_mxu"] = res["layers_mxu"]
        out["layer_classes"] = res["layer_classes"]
    _print(out, by_layer)
    with open(os.path.join(trace_dir, "exact_join.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def _print(out: Dict, by_layer: bool) -> None:
    steps = out["n_iters"] * out["k_steps"]
    print(f"\n== {out['model']} batch {out['batch']} (K={out['k_steps']} steps per "
          f"call, {out['n_iters']} calls = {steps} steps, {out['act_dtype']}, "
          f"{out['device']}) ==")
    busy = out["device_steps_ms_per_step"]
    print(f"device busy: {'-' if busy is None else f'{busy:.3f}'} ms/step | wall "
          f"(traced): {out['wall_ms_per_step']:.3f} ms/step")
    print(f"{'class':40} {'ms/step':>9} {'events':>8} {'%':>6}")
    for r in out["classes"]:
        print(f"{r['class']:40} {r['ms_per_step']:9.3f} {r['events']:8d} {r['pct']:6.1f}")
    un = out["unmatched_ms_per_step"]
    total = out["total_ms_per_step"]
    print(f"{'UNJOINED':40} {un:9.3f} {out['unmatched_events']:8d} "
          f"{100 * un / total if total else 0.0:6.1f}")
    for r in out["unmatched"]:
        print(f"  ? {r['name']:36} {r['ms_per_step']:9.3f} {r['events']:8d}")
    print(f"{'TOTAL':40} {total:9.3f}")
    print(f"kernel records lost by the trace: {out['lost_launches']} "
          f"(settling call: {out['settle_lost_launches']})")
    if by_layer:
        print("\n-- per-layer matrix time (kernel 1, convs, GEMMs; layer ranges "
              "and autograd sequence numbers) --")
        print(f"{'layer':18} {'ms/step':>9} {'events':>8} {'% of step':>9}")
        for r in out["layers_mxu"]:
            print(f"{r['layer']:18} {r['ms_per_step']:9.3f} {r['events']:8d} {r['pct']:9.1f}")


def main(raw_args=None) -> int:
    """``python -m supernet_tpu_torch.hlo_profile [MODEL [BATCH [DIR]]]
    [--by-layer] [--device DEV]``, the JAX twin's positional form."""
    raw = list(sys.argv[1:] if raw_args is None else raw_args)
    by_layer = "--by-layer" in raw
    raw = [a for a in raw if a != "--by-layer"]
    device = "cuda"
    if "--device" in raw:
        i = raw.index("--device")
        device = raw[i + 1]
        del raw[i:i + 2]
    model = raw[0] if raw else "hippocampus"
    batch = int(raw[1]) if len(raw) > 1 else 20
    trace_dir = raw[2] if len(raw) > 2 else os.path.join(
        tempfile.gettempdir(), f"ej_{model}_{batch}")
    os.makedirs(trace_dir, exist_ok=True)
    run(model, batch, trace_dir, by_layer=by_layer, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
