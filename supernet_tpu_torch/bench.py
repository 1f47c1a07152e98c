"""Benchmark of the port: VDP U-Net training throughput (images/sec per
card) with MFU and the HBM roofline, the counterpart of the JAX package's
``bench.py``. Run as ``python -m supernet_tpu_torch.cli bench`` (one line,
on ``--device``, default the card) or ``python -m supernet_tpu_torch.bench``
(the supervised run below).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "images/sec", "vs_baseline": N, ...}

with ``bench.py``'s sections and keys:

- the headline: ``SUPERNET_BENCH_MODEL``'s train step at its parity batch,
  ``SUPERNET_BENCH_DISPATCH`` (default 8) steps per call through
  ``train.make_multi_train_step`` (per step under the naive backend or data
  parallelism);
- ``vs_baseline``: the measured ratio against the reference's own
  algorithm, the same model trained on the same card through the naive
  backend (``ops.set_backend("naive")``: ``ops/naive.py``'s patch-matmul
  convs); ``vs_baseline_estimated`` against an estimate of the reference
  TF2 implementation's single-GPU rate (100 img/s on Hippocampus);
- ``batch_scaling`` and ``best``: the sweep over ``SCALING_BATCHES``;
- the other 2-D model (``brats`` or ``hippocampus``), ``unet3d`` (cube 64,
  batch 4, 4 steps per call through ``train3d.make_multi_train_step3d``, and
  its sweep), ``ensemble_train`` (K = 4 members in the vmap, scan and unroll
  modes of ``train.make_ensemble_train_step``) and ``inference`` (8 chained
  forwards per call under ``torch.no_grad()``, ``probs`` and ``sigma`` both
  fed back so that the variance path stays live).

MFU: the analytic FLOPs of ``flops.py`` (a train step is 3x the forward)
over the card's bf16 dense peak; ``hbm_utilization_min``: the analytic
minimum bytes of a step (``flops.train_step_min_bytes``) over its time,
against the card's peak HBM bandwidth. On an unknown card or the CPU the
peaks read 0.0 and so do both shares: never a device number. ``bench.py``'s
three keys from XLA's cost analysis (``xla_bytes_per_step_mb``,
``achieved_hbm_gbps``, ``hbm_utilization``) have no counterpart and are left
out, as ``bench.py`` leaves them out when that analysis answers nothing.

Completion is forced by a host fetch of the loss (``float``) after each
timed loop; no host clock is read without one.

Env knobs, as ``bench.py`` reads them: SUPERNET_BENCH_MODEL=hippocampus|
brats|lungs, SUPERNET_BENCH_ITERS (default 200), SUPERNET_BENCH_EXTRA,
SUPERNET_BENCH_BASELINE (default on for Hippocampus only),
SUPERNET_BENCH_SCALING, SUPERNET_BENCH_DISPATCH, SUPERNET_BENCH_3D,
SUPERNET_BENCH_ENSEMBLE, SUPERNET_BENCH_INFER (each "1" or "0", default
"1"), SUPERNET_PRECISION (default "default": TF32 allowed in PyTorch's own
matmuls and convolutions), SUPERNET_ACT_DTYPE (default bfloat16, the
production mode), SUPERNET_CONV_FOLD, SUPERNET_BACKEND (``naive`` runs the
headline through the naive backend), SUPERNET_DATA_PARALLEL=1 (with a world
of more than one rank, from torchrun or SUPERNET_COORDINATOR: the
data-parallel step, the batch times the ranks; on one card it is off).
The knobs hold for the run and are restored after it.

Device discovery is a bounded ``torch.cuda.init()`` and name query
(SUPERNET_BENCH_INIT_TIMEOUT seconds, default 300); when it fails or hangs
the line carries ``error`` and the exit code is 1. The bench never falls
back to the CPU: ``--device cpu`` asks for it.

``python -m supernet_tpu_torch.bench`` supervises: each attempt
(SUPERNET_BENCH_ATTEMPTS, default 4) is a child process; a successful line
is merged over the previous capture (``_merge_last_good``) and written to
``LAST_GOOD_PATH`` (``build/torch_bench_last_good.json`` under the
checkout, never the JAX package's record); when every attempt fails, that
capture is printed with ``stale: true``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import platform
import sys
import threading
import time

import numpy as np

REFERENCE_IMAGES_PER_SEC = 100.0  # estimated reference TF2 single-GPU rate

# bench.py's batch sweeps: BraTS activations are ~100x Hippocampus's per
# image, so its sweep stays small
SCALING_BATCHES = {
    "hippocampus": (64, 128, 256),
    "brats": (64, 128),
    "lungs": (64, 128),
}
SCALING_BATCHES_3D = (8, 16, 32)
CUBE_3D = 64  # the volumetric section's cube side (bench.py:638)

_BEST_KEYS = (
    "batch",
    "images_per_sec",
    "mfu",
    "hbm_utilization_min",
    "step_ms",
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST_GOOD_PATH = os.path.join(REPO, "build", "torch_bench_last_good.json")


def _exp(name):
    from supernet_tpu_torch.configs import get_config

    return get_config(name)


def _act_bytes() -> int:
    import torch

    from supernet_tpu_torch.ops import get_act_dtype

    return 2 if get_act_dtype() == torch.bfloat16 else 4


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _completed(loss) -> float:
    """The host fetch that forces completion of every queued step; a
    non-finite loss fails the measurement."""
    v = float(loss.min())
    if not v > -1e30:
        raise RuntimeError(f"the benchmarked step returned the loss {v}")
    return v


def _bench_model(
    name: str,
    n_iters: int,
    data_parallel: bool,
    batch_override: int = 0,
    device="cuda",
) -> dict:
    """Measure one model's train-step throughput; returns the stats dict."""
    import torch

    from supernet_tpu_torch import flops as F
    from supernet_tpu_torch.models import init_params
    from supernet_tpu_torch.ops import get_backend
    from supernet_tpu_torch.train import (
        create_train_state,
        make_multi_train_step,
        make_train_step,
        one_hot_flatten,
    )

    exp = _exp(name)
    cfg, tc = exp.model, exp.train
    batch = batch_override or tc.batch_size
    n_dev = _world() if data_parallel else 1
    batch *= n_dev
    # K steps per call: the trainer's steps_per_dispatch path
    k_steps = int(os.environ.get("SUPERNET_BENCH_DISPATCH", "8"))
    if data_parallel or get_backend() == "naive":
        k_steps = 1  # the mesh path and the naive transients stay per-step

    rng = np.random.default_rng(0)
    s, o = cfg.image_size, cfg.out_size
    x = torch.from_numpy(
        rng.normal(0, 1, (batch, s, s, cfg.in_channels)).astype(np.float32)).to(device)
    y_img = torch.from_numpy(
        rng.integers(0, cfg.n_classes, (batch, o, o)).astype(np.int32)).to(device)
    y = one_hot_flatten(y_img, cfg.n_classes)

    params = init_params(torch.Generator().manual_seed(0), cfg, device)
    state, _ = create_train_state(params, tc, device)
    if data_parallel:
        from supernet_tpu_torch.parallel import (
            make_mesh,
            make_sharded_train_step,
            replicate,
            shard_batch,
        )

        mesh = make_mesh()
        state = replicate(mesh, state)
        x, y = shard_batch(mesh, x, y)
        step = make_sharded_train_step(cfg, tc, mesh)
    elif k_steps > 1:
        x = x.expand(k_steps, *x.shape)
        y = y.expand(k_steps, *y.shape)
        step = make_multi_train_step(cfg, tc, k_steps)
    else:
        step = make_train_step(cfg, tc)

    state, metrics = step(state, x, y)  # warm-up
    _completed(metrics.loss)

    n_disp = max(1, n_iters // k_steps)
    t0 = time.perf_counter()
    for _ in range(n_disp):
        state, metrics = step(state, x, y)
    _completed(metrics.loss)
    dt = time.perf_counter() - t0
    n_iters = n_disp * k_steps

    ips = n_iters * batch / dt  # global
    step_s = dt / n_iters
    flops_img = F.forward_flops(cfg, 1) * 3.0  # train step, per image
    flops_s = ips * flops_img
    min_bytes = F.train_step_min_bytes(cfg, batch, _act_bytes())
    return {
        "images_per_sec": round(ips / n_dev, 2),  # per card
        "flops_per_image_g": round(flops_img / 1e9, 3),
        "tflops_per_sec": round(flops_s / n_dev / 1e12, 3),
        "mfu": round(F.mfu(flops_s / n_dev, device), 4),
        "batch": batch,
        "devices": n_dev,
        "global_images_per_sec": round(ips, 2),
        "step_ms": round(step_s * 1e3, 3),
        # the share of the card's peak bandwidth the analytic minimum
        # traffic needs at this rate (>= ~1.0: bandwidth-bound)
        "min_bytes_per_step_mb": round(min_bytes / 1e6, 1),
        "hbm_utilization_min": round(
            F.hbm_utilization(min_bytes / n_dev / step_s, device), 4
        ),
    }


def _scaling_study(model: str, base_stats: dict, n_iters: int, device="cuda"):
    """Sweep SCALING_BATCHES for one model (one card); returns the
    {batch: img/s} map and the best-throughput stats subset, seeded with
    the already-measured parity-batch run. A batch that fails (out of
    memory) is recorded as an error string and the sweep goes on."""
    scaling = {str(base_stats["batch"]): base_stats["images_per_sec"]}
    best = dict(base_stats)
    for b in SCALING_BATCHES.get(model, ()):
        try:
            s = _bench_model(model, n_iters, False, b, device)
        except Exception as e:  # OOM etc. — record and move on
            scaling[str(b)] = f"error: {str(e)[:80]}"
            _free(device)
            continue
        scaling[str(b)] = s["images_per_sec"]
        if s["images_per_sec"] > best["images_per_sec"]:
            best = s
    return scaling, {k: best[k] for k in _BEST_KEYS if k in best}


def _free(device) -> None:
    """Return the cached blocks of a failed (out-of-memory) run to the card."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _error_line(why: str) -> dict:
    return {
        "metric": "images_per_sec",
        "value": 0.0,
        "unit": "images/sec",
        "vs_baseline": 0.0,
        "error": f"CUDA device unavailable: {why[:200]}",
    }


def _discover(device) -> str:
    """The device's name, after a bounded ``torch.cuda.init()`` for a card.
    A failure or a hang prints the error line and exits 1."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return f"cpu ({platform.machine()})"
    timeout = float(os.environ.get("SUPERNET_BENCH_INIT_TIMEOUT", "300"))
    result: dict = {}

    def query():
        try:
            torch.cuda.init()
            result["name"] = torch.cuda.get_device_name(dev)
        except Exception as e:  # surfaced below as the error line
            result["error"] = e

    th = threading.Thread(target=query, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        print(json.dumps(_error_line(f"device init hung >{timeout:.0f}s")), flush=True)
        os._exit(1)  # the stuck init thread cannot be joined
    if "error" in result:
        print(json.dumps(_error_line(f"{type(result['error']).__name__}: {result['error']}")),
              flush=True)
        raise SystemExit(1)
    return result["name"]


@contextlib.contextmanager
def _knobs(precision: str, act_dtype: str, fold):
    """The bench's process-level knobs for the run, restored after it."""
    import torch

    from supernet_tpu_torch.ops import moments as M

    before = (M.get_mxu_precision(),
              "bfloat16" if M.get_act_dtype() == torch.bfloat16 else "float32",
              M.get_backend())
    M.set_mxu_precision(precision)
    M.set_act_dtype(act_dtype)
    try:
        with M.lowering(**({"conv_fold": fold} if fold else {})):
            yield
    finally:
        M.set_mxu_precision(before[0])
        M.set_act_dtype(before[1])
        M.set_backend(before[2])


def main(device="cuda") -> None:
    """Measure and print the one JSON line (see the module docstring)."""
    device_kind = _discover(device)
    from supernet_tpu_torch.ops import get_backend, set_backend

    # SUPERNET_PRECISION=highest|high|default: "default" lets PyTorch's own
    # matmuls and convolutions use TF32, the counterpart of the JAX bench's
    # one-pass bf16 MXU default; the kernels compute at float32 accuracy
    # whatever it says. SUPERNET_ACT_DTYPE: bf16 by default, the production
    # mode the JAX bench measures (bench.py:316).
    precision = os.environ.get("SUPERNET_PRECISION", "default")
    act_dtype = os.environ.get("SUPERNET_ACT_DTYPE", "bfloat16")
    backend = os.environ.get("SUPERNET_BACKEND", get_backend())
    if backend not in ("kernels", "naive"):
        backend = "kernels"  # xla | pallas | auto: no counterpart
    with _knobs(precision, act_dtype, os.environ.get("SUPERNET_CONV_FOLD")):
        set_backend(backend)
        out = _measure(device, device_kind, backend, precision, act_dtype)
    print(json.dumps(out), flush=True)


def _measure(device, device_kind, backend, precision, act_dtype) -> dict:
    """The line's sections (``bench.py:main``'s body after its set-up)."""
    from supernet_tpu_torch import flops as F
    from supernet_tpu_torch.ops import set_backend

    model = os.environ.get("SUPERNET_BENCH_MODEL", "hippocampus")
    n_iters = int(os.environ.get("SUPERNET_BENCH_ITERS", "200"))
    data_parallel = os.environ.get("SUPERNET_DATA_PARALLEL", "0") == "1"
    if data_parallel:
        from supernet_tpu_torch.parallel import initialize_from_env

        data_parallel = initialize_from_env(device) and _world() > 1

    stats = _bench_model(model, n_iters, data_parallel, 0, device)
    out = {
        "metric": f"{model}_train_throughput",
        "value": stats["images_per_sec"],
        "unit": "images/sec",
        # the measured same-card ratio is filled in below when the naive
        # baseline runs; the typed-in estimate is the fallback only
        "vs_baseline_estimated": round(
            stats["images_per_sec"] / REFERENCE_IMAGES_PER_SEC, 3
        ),
        "mfu": stats["mfu"],
        "tflops_per_sec": stats["tflops_per_sec"],
        "flops_per_image_g": stats["flops_per_image_g"],
        "peak_tflops": F.peak_tflops(device),
        "peak_hbm_gbps": F.peak_hbm_gbps(device),
        "device_kind": device_kind,
        # every reported rate is self-describing (numeric mode + kernels)
        "act_dtype": act_dtype,
        "backend": backend,
        "precision": precision,
        "batch": stats["batch"],
        "step_ms": stats["step_ms"],
        "min_bytes_per_step_mb": stats["min_bytes_per_step_mb"],
        "hbm_utilization_min": stats["hbm_utilization_min"],
    }
    if data_parallel:
        out["devices"] = stats["devices"]
        out["global_images_per_sec"] = stats["global_images_per_sec"]

    # measured same-card baseline: the reference's patch-matmul algorithm
    want_naive = os.environ.get(
        "SUPERNET_BENCH_BASELINE", "1" if model == "hippocampus" else "0"
    )
    if want_naive == "1" and not data_parallel:
        set_backend("naive")
        try:
            naive = _bench_model(model, max(10, n_iters // 10), False, 0, device)
        finally:
            set_backend(backend)
        out["baseline_measured_images_per_sec"] = naive["images_per_sec"]
        out["vs_baseline"] = round(
            stats["images_per_sec"] / naive["images_per_sec"], 3
        )
    else:
        out["vs_baseline"] = out["vs_baseline_estimated"]
        out["vs_baseline_is_estimate"] = True

    # batch scaling: the parity batch (20) underfills the card; "best" is
    # always present, the parity batch's stats when the sweep is skipped
    scale = os.environ.get("SUPERNET_BENCH_SCALING", "1") == "1"
    if scale and not data_parallel:
        scaling, best = _scaling_study(model, stats, max(20, n_iters // 4), device)
        out["batch_scaling"] = scaling
        out["best"] = best
    else:
        out["best"] = {k: stats[k] for k in _BEST_KEYS if k in stats}

    # the other 2-D model (same line, extra fields)
    if os.environ.get("SUPERNET_BENCH_EXTRA", "1") == "1":
        for other in ("brats",) if model != "brats" else ("hippocampus",):
            try:
                o = _bench_model(other, max(10, n_iters // 5), data_parallel, 0, device)
                entry = {
                    k: o[k]
                    for k in (
                        "images_per_sec",
                        "mfu",
                        "tflops_per_sec",
                        "flops_per_image_g",
                        "batch",
                        "step_ms",
                        "hbm_utilization_min",
                    )
                }
                # single-card rates would be incomparable with a
                # data-parallel headline
                if scale and not data_parallel:
                    scaling, best = _scaling_study(other, o, max(10, n_iters // 8), device)
                    entry["batch_scaling"] = scaling
                    entry["best"] = best
                out[other] = entry
            except Exception as e:  # never lose the headline number
                out[other] = {"error": str(e)[:200]}
                _free(device)

    # the volumetric family: parity point (batch 4) and its sweep
    if os.environ.get("SUPERNET_BENCH_3D", "1") == "1" and not data_parallel:
        try:
            v = _bench_3d(max(10, n_iters // 10), 0, device)
            best_keys = ("batch", "vols_per_sec", "mfu", "hbm_utilization_min", "step_ms")
            if scale:
                scaling = {str(v["batch"]): v["vols_per_sec"]}
                best = dict(v)
                for b3 in SCALING_BATCHES_3D:
                    try:
                        s = _bench_3d(max(6, n_iters // 20), b3, device)
                    except Exception as e:  # OOM etc.
                        scaling[str(b3)] = f"error: {str(e)[:80]}"
                        _free(device)
                        continue
                    scaling[str(b3)] = s["vols_per_sec"]
                    if s["vols_per_sec"] > best["vols_per_sec"]:
                        best = s
                v["batch_scaling"] = scaling
                v["best"] = {k: best[k] for k in best_keys if k in best}
            else:
                v["best"] = {k: v[k] for k in best_keys if k in v}
            out["unet3d"] = v
        except Exception as e:
            out["unet3d"] = {"error": str(e)[:200]}
            _free(device)

    # K-member ensemble training against K sequential steps
    if os.environ.get("SUPERNET_BENCH_ENSEMBLE", "1") == "1" and not data_parallel:
        try:
            out["ensemble_train"] = _bench_ensemble(
                max(10, n_iters // 10), stats["step_ms"], device
            )
        except Exception as e:
            out["ensemble_train"] = {"error": str(e)[:200]}
            _free(device)

    # the serving forward
    if os.environ.get("SUPERNET_BENCH_INFER", "1") == "1" and not data_parallel:
        try:
            out["inference"] = _bench_inference(max(20, n_iters), device)
        except Exception as e:
            out["inference"] = {"error": str(e)[:200]}
            _free(device)
    return out


def _bench_inference(n_iters: int, device="cuda") -> dict:
    """The forward's throughput at the training batch size, the rate a
    saturated ``InferenceSession`` sustains once requests are batched
    (host-device copies excluded). K = 8 forwards per call, each fed the
    last one's probs and sigma, and a scalar fetched after the timed loop:
    the completion discipline of the train bench."""
    import torch

    from supernet_tpu_torch.models import forward, init_params

    exp = _exp("hippocampus")
    cfg, tc = exp.model, exp.train
    b = tc.batch_size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(
        0, 1, (b, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(np.float32)).to(device)
    params = init_params(torch.Generator().manual_seed(0), cfg, device)
    k = 8

    @torch.no_grad()
    def fwd_k(c):
        for _ in range(k):
            probs, sigma = forward(params, c, cfg)
            # feed both outputs back: probs alone would leave the variance
            # path's result unread and overstate the serving rate
            c = c + 1e-6 * (probs[:, :1, :1] + sigma[:, :1, :1]).reshape(c.shape[0], 1, 1, 1)
        return c.sum()

    float(fwd_k(x))  # warm-up and completion
    n_calls = max(1, n_iters // k)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        s = fwd_k(x)
    _completed(s)
    dt = (time.perf_counter() - t0) / (n_calls * k)
    return {
        "model": "hippocampus",
        "batch": b,
        "images_per_sec": round(b / dt, 1),
        "batch_ms": round(dt * 1e3, 3),
    }


def _bench_ensemble(n_iters: int, single_step_ms: float, device="cuda") -> dict:
    """K = 4 Hippocampus members at the parity batch in one
    ``train.make_ensemble_train_step`` call, in each member mode (vmap: one
    member-stacked step through the kernels' member axis; scan and unroll:
    a loop of single-model passes), the fastest reported.
    ``sequential_step_ms`` is K x the measured single-model step, so
    ``speedup_per_step`` is the steady-state per-step ratio against K
    separate trainings."""
    import torch

    from supernet_tpu_torch.models import init_params
    from supernet_tpu_torch.train import (
        create_train_state,
        make_ensemble_train_step,
        stack_trees,
    )

    exp = _exp("hippocampus")
    cfg, tc = exp.model, exp.train
    k_members, b = 4, tc.batch_size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(
        0, 1, (k_members, b, cfg.image_size, cfg.image_size, cfg.in_channels),
    ).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(
        0, cfg.n_classes, (k_members, b, cfg.out_size, cfg.out_size)).astype(np.int32)).to(device)
    seeds = torch.arange(k_members, dtype=torch.int32)
    members = [init_params(torch.Generator().manual_seed(k), cfg, device)
               for k in range(k_members)]

    def run_mode(mode):
        # a fresh stacked state per mode: the step updates it in place
        state = stack_trees([create_train_state(p, tc, device)[0] for p in members])
        step = make_ensemble_train_step(cfg, tc, member_mode=mode)
        state, m = step(state, x, y, seeds)
        _completed(m.loss)  # warm-up and completion
        t0 = time.perf_counter()
        for _ in range(n_iters):
            state, m = step(state, x, y, seeds)
        _completed(m.loss)
        return (time.perf_counter() - t0) / n_iters

    dts = {mode: run_mode(mode) for mode in ("vmap", "scan", "unroll")}
    mode = min(dts, key=dts.get)
    dt = dts[mode]
    return {
        "members": k_members,
        "batch_per_member": b,
        "member_mode": mode,
        "step_ms": round(dt * 1e3, 3),
        "step_ms_vmap": round(dts["vmap"] * 1e3, 3),
        "step_ms_scan": round(dts["scan"] * 1e3, 3),
        "step_ms_unroll": round(dts["unroll"] * 1e3, 3),
        "sequential_step_ms": round(k_members * single_step_ms, 3),
        "speedup_per_step": round(k_members * single_step_ms / (dt * 1e3), 2),
        "member_images_per_sec": round(b / dt, 1),
    }


def _bench_3d(n_iters: int, batch_override: int = 0, device="cuda") -> dict:
    """Volumetric train-step throughput: ``CUBE_3D``-sided Hippocampus-config
    cubes at batch 4 by default (``batch_override`` drives the sweep),
    SUPERNET_BENCH_DISPATCH (default 4) steps per call."""
    import torch

    from supernet_tpu_torch import flops as F
    from supernet_tpu_torch.models import init_params3d
    from supernet_tpu_torch.train import create_train_state
    from supernet_tpu_torch.train3d import (
        derive_out_size3d,
        make_multi_train_step3d,
        make_train_step3d,
    )

    exp = _exp("hippocampus")
    cfg, tc = dataclasses.replace(exp.model, image_size=CUBE_3D), exp.train
    o = derive_out_size3d(cfg)
    b = batch_override or 4
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(
        0, 1, (b, CUBE_3D, CUBE_3D, CUBE_3D, cfg.in_channels)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (b, o, o, o)).astype(np.int32)).to(device)
    params = init_params3d(torch.Generator().manual_seed(0), cfg, device)
    state, _ = create_train_state(params, tc, device)
    k_steps = max(1, int(os.environ.get("SUPERNET_BENCH_DISPATCH", "4")))
    if k_steps > 1:
        step = make_multi_train_step3d(cfg, tc, k_steps)
        x, y = x.expand(k_steps, *x.shape), y.expand(k_steps, *y.shape)
        n_calls = max(1, n_iters // k_steps)
    else:
        step = make_train_step3d(cfg, tc)
        n_calls = n_iters
    state, m = step(state, x, y)
    _completed(m.loss)  # warm-up and completion
    t0 = time.perf_counter()
    for _ in range(n_calls):
        state, m = step(state, x, y)
    _completed(m.loss)
    dt = (time.perf_counter() - t0) / (n_calls * k_steps)
    return {
        "vols_per_sec": round(b / dt, 2),
        "step_ms": round(dt * 1e3, 2),
        "cube": CUBE_3D,
        "batch": b,
        "mfu": round(F.mfu(F.train_step_flops3d(cfg, b) / dt, device), 4),
        "hbm_utilization_min": round(
            F.hbm_utilization(F.train_step_min_bytes3d(cfg, b, _act_bytes()) / dt, device),
            4,
        ),
    }


def _merge_last_good(payload: dict) -> dict:
    """Union a fresh capture over the previous last-known-good payload
    (``bench.py:698-745``): keys the fresh run measured win; prior sections
    it skipped are kept, with their capture time under ``retained_from``; a
    sweep-derived prior ``best`` is not shadowed by a skipped sweep's; a
    retained measured baseline recomputes ``vs_baseline``."""
    try:
        with open(LAST_GOOD_PATH) as f:
            old = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return payload
    if not isinstance(old, dict) or old.get("stale"):
        return payload
    # vs_baseline_is_estimate qualifies the fresh vs_baseline only
    retained = {
        k: old.get("captured_at", "unknown")
        for k in old
        if k not in payload
        and k not in ("captured_at", "retained_from", "vs_baseline_is_estimate")
    }
    if "batch_scaling" in retained and "best" in old:
        retained["best"] = old.get("captured_at", "unknown")
        payload = {k: v for k, v in payload.items() if k != "best"}
    if not retained:
        return payload
    merged = dict(old)
    merged.pop("retained_from", None)
    if "vs_baseline_is_estimate" not in payload:
        merged.pop("vs_baseline_is_estimate", None)
    merged.update(payload)
    merged["retained_from"] = retained
    base = merged.get("baseline_measured_images_per_sec")
    if "baseline_measured_images_per_sec" in retained and base:
        merged["vs_baseline"] = round(merged["value"] / base, 3)
        merged.pop("vs_baseline_is_estimate", None)
    return merged


def _child_main() -> int:
    """One measurement attempt (in a subprocess). Returns the exit code."""
    try:
        main()
        return 0
    except RuntimeError as e:  # the CUDA runtime refused the card
        if "cuda" not in str(e).lower():
            raise
        print(json.dumps(_error_line(str(e))), flush=True)
        return 1


def _parse_json_tail(text: str):
    """Last parseable JSON line of a child's stdout, or None."""
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            return json.loads(line)
        except (json.JSONDecodeError, ValueError):
            continue
    return None


def supervise() -> int:
    """Retry the measurement in fresh subprocesses (SUPERNET_BENCH_ATTEMPTS,
    each within SUPERNET_BENCH_CHILD_TIMEOUT seconds, default 2700, its
    device discovery within SUPERNET_BENCH_INIT_TIMEOUT, default 150); write
    a successful line, merged, to ``LAST_GOOD_PATH``; on total failure print
    the last-known-good line marked ``stale: true``."""
    import subprocess

    attempts = max(1, int(os.environ.get("SUPERNET_BENCH_ATTEMPTS", "4")))
    init_timeout = float(os.environ.get("SUPERNET_BENCH_INIT_TIMEOUT", "150"))
    child_timeout = float(os.environ.get("SUPERNET_BENCH_CHILD_TIMEOUT", "2700"))
    failures = []
    for attempt in range(attempts):
        env = dict(os.environ)
        env["SUPERNET_BENCH_CHILD"] = "1"
        env["SUPERNET_BENCH_INIT_TIMEOUT"] = str(init_timeout)
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "supernet_tpu_torch.bench"],
                capture_output=True, text=True, timeout=child_timeout, env=env, cwd=REPO,
            )
            payload = _parse_json_tail(proc.stdout)
            if proc.returncode == 0 and payload and "error" not in payload:
                payload["captured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                payload = _merge_last_good(payload)
                try:
                    os.makedirs(os.path.dirname(LAST_GOOD_PATH), exist_ok=True)
                    with open(LAST_GOOD_PATH, "w") as f:
                        json.dump(payload, f, indent=1)
                except OSError:
                    pass  # read-only checkout: still print the live result
                print(json.dumps(payload))
                return 0
            why = (
                payload.get("error", f"rc={proc.returncode}")
                if payload
                else f"rc={proc.returncode}, no JSON in stdout "
                f"(stderr tail: {proc.stderr[-200:]!r})"
            )
        except subprocess.TimeoutExpired:
            why = f"child exceeded {child_timeout:.0f}s wall clamp"
        failures.append(f"attempt {attempt + 1}: {why}")
        print(f"bench attempt {attempt + 1}/{attempts} failed: {why}", file=sys.stderr)
        if attempt + 1 < attempts:
            time.sleep(min(60.0, 5.0 * 2 ** attempt))  # backoff before retry

    trace = "; ".join(failures)[:800]
    try:
        with open(LAST_GOOD_PATH) as f:
            stale = json.load(f)
    except (OSError, json.JSONDecodeError):
        stale = None
    if stale is not None:
        stale["stale"] = True
        stale["stale_captured_at"] = stale.pop("captured_at", "unknown")
        stale["error"] = f"CUDA device unavailable this run: {trace}"
        print(json.dumps(stale))
        return 0  # parseable last-known-good evidence, clearly labelled
    line = _error_line("")
    line["error"] = f"CUDA device unavailable and no last-known-good: {trace}"
    print(json.dumps(line))
    return 1


if __name__ == "__main__":
    if os.environ.get("SUPERNET_BENCH_CHILD") == "1":
        raise SystemExit(_child_main())
    raise SystemExit(supervise())
