#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``supernet_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

1. setup: needs a CUDA device (there is no CPU fallback); TF32 off; prints
   the torch/CUDA versions and the card's name and power limit; builds the
   kernels from ``supernet_tpu_torch/csrc`` and prints the build time.
2. kernels: every hand-written kernel against its plain PyTorch version on
   the card, at every layer shape of one hippocampus forward (batch 20) and
   one BraTS forward (batch 2), plus k=2/k=1 and odd-shape cases. vdp_conv
   must agree within 1e-4 of the plain output's max magnitude, and at every
   k=3 shape within 1e-5 of the max magnitude of the plain version run in
   float64 on the card (3xTF32 on the tensor cores meets that, single-pass
   TF32 does not); the pool bit for bit, including the tap index. Each is
   timed with CUDA events (median of 20 runs after a warm-up); vdp_conv
   also by its device time alone and beside cuDNN's mu product alone (TF32
   off, a yardstick the port never calls), with its path ("wgmma" or
   "simt"), K slices and its float32 and 3xTF32 bounds. One JSON line per
   shape.
3. serving, hippocampus at full width: ``InferenceSession`` (batch 20),
   with ``init_params`` weights rescaled to He scale, answers requests of
   20, 7 and 45 images; the kernel launch counters are zeroed just before
   and read just after, and must show every k=3 conv and every pool of
   every chunk, and a split-K reduce for every layer planned with K
   slices; the answers are checked for shape, finiteness, the simplex
   and sigma >= 0, and against the same session on the CPU.
4. serving, BraTS at full width (batch 2), the same checks.
5. backward kernels: the pool backward (kernel 3) and the sigma-chain
   backward (kernel 4) against their plain versions on the card, at every
   pool and k=3 conv shape of one hippocampus training step (batch 20) and
   one BraTS step (batch 2), plus ties, C=130 and odd-shape cases. The pool
   backward must be bit-exact; the sigma-chain backward's u and dsw within
   1e-5 of the plain output's max magnitude (the summation order differs).
   At every k=3 conv shape the gradients of ``VDPConv`` (kernel 1 forward,
   kernel 4 inside the backward) are held against autograd of
   ``vdp_conv_plain``, each within 1e-4 of that gradient's max magnitude.
   Each is timed with CUDA events beside its plain version.
6. training, hippocampus at full width, batch 20: 5 steps of
   ``train.make_train_step`` from He-scaled ``init_params`` on a seeded
   batch with integer labels. The launch counters are zeroed just before
   and read just after; per step they must read 10 vdp_conv, 2 pool
   forward, 2 pool backward and 10 sigma-chain backward launches, and one
   split-K reduce per layer planned with K slices. The same
   steps on the CPU from the same parameters: every step's loss within 1e-4
   relative, the step-1 gradients within 1e-3 of each leaf's max magnitude,
   the parameters after the last step within 2 * lr * steps. Prints the
   median step time of steps 2-5 (synchronised) and img/s.
7. training, BraTS at full width, batch 2: 2 steps, the same checks, with
   18 / 4 / 4 / 18 launches per step.

In phases 6-7 cuDNN runs its deterministic algorithms, and the CPU
reference of the step-1 gradients replays the card's ReLU masks and pool
taps (``_decisions``), so that rounding ties do not decide the comparison.

The last two lines of standard output are the kernels summary
``{"kernels": [...]}`` (all four kernels, with their launches in the
hippocampus training run, errors, times and bounds) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

SEED = 0
VDP_TOL = 1e-4  # max |kernel - plain| / max |plain|, per output
VDP_F64_TOL = 1e-5  # max |kernel - plain in float64| / max |float64|, k=3
SERVE_PROBS_ATOL = 1e-4
# sigma: |cuda - cpu| <= 1e-4 * max |cpu| on all but a small share of
# elements. A ReLU whose pre-activation rounds to 0 differently in two
# float32 summation orders switches that pixel's sigma on or off (mu is
# continuous there, so probs are not affected); that jump then spreads over
# the pixel's receptive field. The JAX package and the port on the CPU
# disagree the same way (about 0.06% of the elements of a hippocampus batch
# of 20), so an elementwise bound would reject any two correct
# implementations. A systematic error moves nearly every element.
SERVE_SIGMA_RTOL = 1e-4
SERVE_SIGMA_SHARE = 5e-3
SIGMA_BWD_TOL = 1e-5  # max |kernel - plain| / max |plain|, u and dsw
VDP_BWD_TOL = 1e-4  # per gradient, max |kernel path - plain| / max |plain|
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3  # step-1 gradient, per leaf, relative to its max
TIMING_RUNS = 20


def _die(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def _time_ms(torch, fn) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each of
    TIMING_RUNS calls, after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _bound(nbytes: float, flops: float):
    """(bound ms, bytes ms, operations ms): the least time the card could
    take to move ``nbytes`` and do ``flops`` float32 operations (the H100
    peaks of ``supernet_tpu_torch.profiling``)."""
    from supernet_tpu_torch.profiling import F32_FLOPS_PER_S, HBM_BYTES_PER_S

    b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    o_ms = 1e3 * flops / F32_FLOPS_PER_S
    return max(b_ms, o_ms), b_ms, o_ms


def _he_params(torch, cfg):
    """``init_params`` on the CPU from SEED with each w_mu rescaled to He
    scale, std sqrt(2 / fan_in). At the raw init (std 0.088 in every layer)
    the activations grow about 6x per BraTS layer: the logits reach 7.6e4,
    and on the CPU the JAX package and the port already differ by 3.6e-2 in
    probs, so no float32 comparison of two implementations is well-posed
    there. At He scale the logits stay below 10 in both configs."""
    from supernet_tpu_torch.models import init_params

    params = init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    for p in params.values():
        k, _, cin, _ = p["w_mu"].shape
        p["w_mu"] *= math.sqrt(2.0 / (k * k * cin)) / p["w_mu"].std()
    return params


def _split_layers(cfg, batch) -> int:
    """The k=3 convs of one forward at ``batch`` that vdp_conv's planner
    cuts into K slices: each launches the split-K reduce once."""
    from supernet_tpu_torch.ops.kernels.vdp_conv import plan
    from supernet_tpu_torch.profiling import layer_shapes

    return sum(plan(batch, h, w, cin, cout, 3).splits > 1
               for _, (_, h, w, cin), cout in layer_shapes(cfg)[0])


class KernelCheck:
    """Holds each kernel against its plain version and keeps the worst
    error and the summed times per kernel and config."""

    def __init__(self, torch):
        self.torch = torch
        self.gen = torch.Generator(device="cuda").manual_seed(SEED)
        self.worst = {}
        self.ms = {}
        self.vdp = {}  # (config) -> summed device, cuDNN and 3xTF32 bound ms

    def _randn(self, *shape):
        return self.torch.randn(shape, device="cuda", generator=self.gen)

    def vdp_conv(self, config, layer, b, h, w, cin, cout, k, has_sigma, relu):
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V

        from supernet_tpu_torch.profiling import device_ms, vdp_conv_bounds

        mu = self._randn(b, h, w, cin)
        sigma = 0.05 * self._randn(b, h, w, cin).abs() if has_sigma else None
        w_mu = 0.1 * self._randn(k, k, cin, cout)
        w_sigma = -4.0 + self._randn(cout)
        plan = V.plan(b, h, w, cin, cout, k)
        with torch.inference_mode():
            got = V.vdp_conv(mu, sigma, w_mu, w_sigma, fuse_relu=relu)
            want = V.vdp_conv_plain(mu, sigma, w_mu, w_sigma, fuse_relu=relu)
            torch.cuda.synchronize()
            abs_err, rel_err, flips = _vdp_errors(torch, got, want, relu, VDP_TOL)
            if rel_err > VDP_TOL:
                _die(f"vdp_conv {config}/{layer} disagrees with its plain "
                     f"version: relative error {rel_err:.3e} > {VDP_TOL}")
            f64_err = None
            if k == 3:
                want64 = V.vdp_conv_plain(
                    mu.double(), None if sigma is None else sigma.double(),
                    w_mu.double(), w_sigma.double(), fuse_relu=relu)
                _, f64_err, _ = _vdp_errors(torch, [g.double() for g in got],
                                            want64, relu, VDP_F64_TOL)
                if f64_err > VDP_F64_TOL:
                    _die(f"vdp_conv {config}/{layer} ({plan.path}) is not at "
                         f"float32 accuracy: relative error {f64_err:.3e} "
                         f"against float64 > {VDP_F64_TOL}")
                del want64
            ms = _time_ms(torch, lambda: V.vdp_conv(mu, sigma, w_mu, w_sigma, relu))
            plain_ms = _time_ms(
                torch, lambda: V.vdp_conv_plain(mu, sigma, w_mu, w_sigma, relu)
            )
            dev_ms = device_ms(lambda: V.vdp_conv(mu, sigma, w_mu, w_sigma, relu))
            cudnn_ms = device_ms(lambda: V._conv_valid(mu, w_mu))
        bounds = vdp_conv_bounds(b, h, w, cin, cout, k, has_sigma)
        acc = self.vdp.setdefault(config, [0.0, 0.0, 0.0])
        acc[0] += dev_ms
        acc[1] += cudnn_ms
        acc[2] += bounds["bound_3xtf32_ms"]
        self._record("vdp_conv", config, abs_err, rel_err, ms, plain_ms,
                     (bounds["bound_ms"], bounds["bytes_ms"], bounds["f32_ms"]), {
            "layer": layer, "shape": [b, h, w, cin, cout, k],
            "sigma": has_sigma, "relu": relu, "relu_ties": flips,
            "path": plan.path, "splits": plan.splits, "blocks": plan.blocks,
            "f64_max_rel_err": f64_err, "device_ms": dev_ms,
            "bound_3xtf32_ms": bounds["bound_3xtf32_ms"],
            "cudnn_mu_ms": cudnn_ms,
        })

    def vmaxpool(self, config, layer, b, h, w, c, ties=False):
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import pool as P

        mu = self._randn(b, h, w, c)
        if ties:
            mu = torch.round(3.0 * mu)
        sigma = self._randn(b, h, w, c).abs()
        with torch.inference_mode():
            got = P.vmaxpool(mu, sigma, return_idx=True)
            want = P.vmaxpool_plain(mu, sigma)
            torch.cuda.synchronize()
            for name, g, r in zip(("mx", "so", "idx"), got, want):
                if not torch.equal(g, r):
                    _die(f"vmaxpool {config}/{layer}: {name} is not bit-exact")
            ms = _time_ms(torch, lambda: P.vmaxpool(mu, sigma))
            plain_ms = _time_ms(torch, lambda: P.vmaxpool_plain(mu, sigma))
        n_out = got[0].numel()
        self._record("vmaxpool", config, 0.0, 0.0, ms, plain_ms,
                     _bound(4 * (2 * mu.numel() + 2 * n_out), 0), {
            "layer": layer, "shape": [b, h, w, c], "ties": ties,
        })

    def vmaxpool_bwd(self, config, layer, b, h, w, c, ties=False):
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import pool as P

        mu = self._randn(b, h, w, c)
        if ties:
            mu = torch.round(3.0 * mu)
        with torch.inference_mode():
            _, _, idx = P.vmaxpool(mu, self._randn(b, h, w, c).abs(), return_idx=True)
            g_mu = self._randn(*idx.shape)
            g_sigma = self._randn(*idx.shape)
            got = P.vmaxpool_bwd(idx, g_mu, g_sigma, h, w)
            want = P.vmaxpool_bwd_plain(idx, g_mu, g_sigma, h, w)
            torch.cuda.synchronize()
            for name, g, r in zip(("d_mu", "d_sigma"), got, want):
                if not torch.equal(g, r):
                    _die(f"vmaxpool_bwd {config}/{layer}: {name} is not bit-exact")
            ms = _time_ms(torch, lambda: P.vmaxpool_bwd(idx, g_mu, g_sigma, h, w))
            plain_ms = _time_ms(
                torch, lambda: P.vmaxpool_bwd_plain(idx, g_mu, g_sigma, h, w)
            )
        nbytes = 4 * (3 * idx.numel() + 2 * mu.numel())
        self._record("vmaxpool_bwd", config, 0.0, 0.0, ms, plain_ms,
                     _bound(nbytes, 0), {
            "layer": layer, "shape": [b, h, w, c], "ties": ties,
        })

    def sigma_bwd(self, config, layer, b, hp, wp, c, k):
        torch = self.torch
        import torch.nn.functional as F

        from supernet_tpu_torch.ops.kernels import sigma_bwd as S

        g = self._randn(b, hp, wp, c)
        t = 10.0 * self._randn(b, hp, wp).abs()
        s_w = F.softplus(self._randn(c) - 4.0)
        with torch.inference_mode():
            got = S.winsum_spread_bwd(g, t, s_w, k)
            want = S.winsum_spread_bwd_plain(g, t, s_w, k)
            torch.cuda.synchronize()
            abs_err = rel_err = 0.0
            for name, x, r in zip(("u", "dsw"), got, want):
                if x.shape != r.shape:
                    _die(f"sigma_bwd {config}/{layer}: {name} shape {tuple(x.shape)}")
                e = float((x - r).abs().max())
                rel = e / max(float(r.abs().max()), 1e-30)
                if not rel <= SIGMA_BWD_TOL:
                    _die(f"sigma_bwd {config}/{layer}: {name} disagrees with its "
                         f"plain version: relative error {rel:.3e} > {SIGMA_BWD_TOL}")
                abs_err, rel_err = max(abs_err, e), max(rel_err, rel)
            ms = _time_ms(torch, lambda: S.winsum_spread_bwd(g, t, s_w, k))
            plain_ms = _time_ms(torch, lambda: S.winsum_spread_bwd_plain(g, t, s_w, k))
        h, w = hp + k - 1, wp + k - 1
        nbytes = 4 * (g.numel() + t.numel() + 2 * c + b * h * w)
        flops = 4 * g.numel() + k * k * b * h * w
        self._record("sigma_bwd", config, abs_err, rel_err, ms, plain_ms,
                     _bound(nbytes, flops), {
            "layer": layer, "shape": [b, hp, wp, c, k],
        })

    def vdp_conv_bwd(self, config, layer, b, h, w, cin, cout, k, has_sigma, relu):
        """VDPConv's gradients (kernel 1 forward, kernel 4 in the backward)
        against autograd of the plain version on the same cotangents. Where
        the two ReLU masks differ (a pre-activation that rounds to 0 in one
        summation order only, checked to lie at mu = 0 as in _vdp_errors)
        the cotangents are set to 0, so both backward passes see one mask."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V

        mu = self._randn(b, h, w, cin).requires_grad_(has_sigma)
        sigma = (0.05 * self._randn(b, h, w, cin).abs()).requires_grad_() if has_sigma else None
        w_mu = (0.1 * self._randn(k, k, cin, cout)).requires_grad_()
        w_sigma = (-4.0 + self._randn(cout)).requires_grad_()
        inputs = [t for t in (mu, sigma, w_mu, w_sigma) if t is not None and t.requires_grad]
        got = V.VDPConv.apply(mu, sigma, w_mu, w_sigma, relu)
        want = V.vdp_conv_plain(mu, sigma, w_mu, w_sigma, relu)[:2]
        g1 = self._randn(*got[0].shape)
        g2 = self._randn(*got[0].shape)
        flips = 0
        if relu:
            m_got, m_want = got[0].detach(), want[0].detach()
            tie = (m_got > 0) != (m_want > 0)
            flips = int(tie.sum())
            if flips:
                bound = VDP_TOL * float(m_want.abs().max())
                if float(torch.maximum(m_got.abs(), m_want.abs())[tie].max()) > bound:
                    _die(f"vdp_conv_bwd {config}/{layer}: a ReLU mask differs away from mu = 0")
                g1 = torch.where(tie, 0.0, g1)
                g2 = torch.where(tie, 0.0, g2)

        def grads(out):
            return torch.autograd.grad(out, inputs, (g1, g2), retain_graph=True)

        d_got, d_want = grads(got), grads(want)
        torch.cuda.synchronize()
        abs_err = rel_err = 0.0
        names = [n for n, t in zip(("d_mu", "d_sigma", "d_w_mu", "d_w_sigma"),
                                   (mu, sigma, w_mu, w_sigma))
                 if t is not None and t.requires_grad]
        for name, x, r in zip(names, d_got, d_want):
            e = float((x - r).abs().max())
            rel = e / max(float(r.abs().max()), 1e-30)
            if not rel <= VDP_BWD_TOL:
                _die(f"vdp_conv_bwd {config}/{layer}: {name} disagrees with autograd "
                     f"of the plain version: relative error {rel:.3e} > {VDP_BWD_TOL}")
            abs_err, rel_err = max(abs_err, e), max(rel_err, rel)
        ms = _time_ms(torch, lambda: grads(got))
        plain_ms = _time_ms(torch, lambda: grads(want))
        self._record("vdp_conv_bwd", config, abs_err, rel_err, ms, plain_ms, None, {
            "layer": layer, "shape": [b, h, w, cin, cout, k],
            "sigma": has_sigma, "relu": relu, "relu_ties": flips,
        })

    def _record(self, kernel, config, abs_err, rel_err, ms, plain_ms, bound, extra):
        worst = self.worst.setdefault(kernel, [0.0, 0.0])
        worst[0] = max(worst[0], abs_err)
        worst[1] = max(worst[1], rel_err)
        t = self.ms.setdefault((kernel, config), [0.0] * 5)
        t[0] += ms
        t[1] += plain_ms
        line = {
            "kernel": kernel, "config": config, **extra,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": ms, "plain_ms": plain_ms,
        }
        if bound is not None:
            for i, v in enumerate(bound, start=2):
                t[i] += v
            line["bound_ms"] = bound[0]
        print(json.dumps(line), flush=True)


def _vdp_errors(torch, got, want, relu, tol):
    """(max abs error, max error / max |plain|, relu ties) over the three
    outputs. With the fused ReLU a pixel whose pre-activation rounds to 0 in
    one version and not in the other is masked differently; such a tie is
    accepted only where both mu outputs are within ``tol`` of mu's max
    magnitude, and its sigma is left out of the comparison."""
    g_mu, g_sig, g_win = got
    w_mu, w_sig, w_win = want
    keep = torch.ones_like(g_mu, dtype=torch.bool)
    flips = 0
    if relu:
        tie = (g_mu > 0) != (w_mu > 0)
        flips = int(tie.sum())
        if flips:
            bound = tol * float(w_mu.abs().max())
            if float(torch.maximum(g_mu.abs(), w_mu.abs())[tie].max()) > bound:
                _die("vdp_conv: a ReLU mask differs away from mu = 0")
            keep = ~tie
    abs_err = rel_err = 0.0
    for g, w, m in ((g_mu, w_mu, None), (g_sig, w_sig, keep), (g_win, w_win, None)):
        d = (g - w).abs()
        if m is not None:
            d = d[m]
        e = float(d.max()) if d.numel() else 0.0
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(float(w.abs().max()), 1e-30))
    return abs_err, rel_err, flips


def _zero_launches() -> None:
    from supernet_tpu_torch.ops.kernels import pool as P
    from supernet_tpu_torch.ops.kernels import sigma_bwd as S
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    V.launches = V.reduce_launches = P.launches = P.bwd_launches = S.launches = 0


def _read_launches() -> dict:
    from supernet_tpu_torch.ops.kernels import pool as P
    from supernet_tpu_torch.ops.kernels import sigma_bwd as S
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    return {"vdp_conv": V.launches, "vdp_conv_reduce": V.reduce_launches,
            "vmaxpool": P.launches, "vmaxpool_bwd": P.bwd_launches,
            "sigma_bwd": S.launches}


def _serve(torch, name, cfg, batch, sizes):
    """Answer requests of ``sizes`` images through the CUDA session with
    the launch counters zeroed before and read after; check the answers
    and compare them with the CPU session's. Returns (launches, img/s of
    the last request)."""
    import numpy as np

    from supernet_tpu_torch.models import layer_names
    from supernet_tpu_torch.serving import InferenceSession

    params = _he_params(torch, cfg)
    gpu = InferenceSession(params, cfg, batch_size=batch, device="cuda").warmup()
    cpu = InferenceSession(params, cfg, batch_size=batch, device="cpu")
    rng = np.random.default_rng(SEED)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    requests = [rng.normal(0.0, 1.0, (n,) + shape).astype(np.float32) for n in sizes]

    _zero_launches()
    answers = []
    for x in requests:
        t0 = time.perf_counter()
        probs, sigma = gpu.predict(x)
        answers.append((probs, sigma, time.perf_counter() - t0))
    launches = _read_launches()

    chunks = sum(math.ceil(n / batch) for n in sizes)
    want = {
        "vdp_conv": chunks * sum(1 for _, k, _, _ in layer_names(cfg) if k == 3),
        "vdp_conv_reduce": chunks * _split_layers(cfg, batch),
        "vmaxpool": chunks * (cfg.depth - 1),
        "vmaxpool_bwd": 0,
        "sigma_bwd": 0,
    }
    if launches != want:
        _die(f"{name}: kernel launches {launches}, expected {want}")

    o, c = cfg.out_size, cfg.n_classes
    worst_p = worst_s = 0.0
    n_off = n_all = 0
    for x, (probs, sigma, _) in zip(requests, answers):
        n = len(x)
        for what, a in (("probs", probs), ("sigma", sigma)):
            if a.shape != (n, o, o, c):
                _die(f"{name}: {what} shape {a.shape}, expected {(n, o, o, c)}")
            if not np.isfinite(a).all():
                _die(f"{name}: {what} has non-finite values")
        if np.abs(probs.sum(-1) - 1.0).max() > 1e-5:
            _die(f"{name}: probabilities do not sum to 1")
        if (sigma < 0).any():
            _die(f"{name}: negative sigma")
        ref_p, ref_s = cpu.predict(x)
        worst_p = max(worst_p, float(np.abs(probs - ref_p).max()))
        scale = max(float(np.abs(ref_s).max()), 1e-30)
        d = np.abs(sigma - ref_s) / scale
        worst_s = max(worst_s, float(d.max()))
        n_off += int((d > SERVE_SIGMA_RTOL).sum())
        n_all += d.size
    share = n_off / n_all
    if worst_p > SERVE_PROBS_ATOL or share > SERVE_SIGMA_SHARE:
        _die(f"{name}: CUDA session differs from the CPU session "
             f"(probs {worst_p:.3e}; sigma beyond {SERVE_SIGMA_RTOL} relative "
             f"on {share:.3%} of the elements, max {worst_s:.3e})")
    img_s = sizes[-1] / answers[-1][2]
    print(json.dumps({
        "serving": name, "batch": batch, "requests": list(sizes),
        "launches": launches, "chunks": chunks,
        "probs_max_abs_err_vs_cpu": worst_p, "sigma_max_rel_err_vs_cpu": worst_s,
        "sigma_share_beyond_rtol": share,
        "img_per_s_last_request": img_s,
        "request_s": [a[2] for a in answers],
    }), flush=True)
    return launches, img_s


@contextlib.contextmanager
def _decisions(torch, record=None, replay=None):
    """Record the discrete choices of the forwards run inside (each fused
    ReLU's mask, each pool's tap index) into the list ``record``, or make
    the forwards take the choices of ``replay`` instead of their own.

    Two float32 summation orders can round a pre-activation near 0, or two
    near-equal pool taps, differently; that choice moves the pixel's whole
    gradient path (one ReLU flip and one pool near-tie at hippocampus batch
    20 move a w_mu gradient by 1.4e-3 of its max). So the CPU reference of
    the gradient check replays the card's choices. A replayed choice that
    differs from the CPU's own must be a tie: |mu| within VDP_TOL of mu's
    max magnitude for a ReLU, the two taps within VDP_TOL of it for a pool.
    Yields the count of such ties."""
    from supernet_tpu_torch.ops.kernels import pool as P
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    conv_apply, pool_apply = V.VDPConv.apply, P.VMaxPool.apply
    queue = iter(replay) if replay is not None else None
    ties = {"relu": 0, "pool": 0}

    def tie_bound(x):
        return VDP_TOL * float(x.detach().abs().max())

    def conv(mu, sigma, w_mu, w_sigma, relu):
        if not relu:
            return conv_apply(mu, sigma, w_mu, w_sigma, relu)
        if queue is None:
            out = conv_apply(mu, sigma, w_mu, w_sigma, relu)
            record.append(out[0].detach() > 0)
            return out
        m, s = conv_apply(mu, sigma, w_mu, w_sigma, False)
        mask = next(queue).to(m.device)
        tie = mask != (m.detach() > 0)
        if tie.any():
            if float(m.detach()[tie].abs().max()) > tie_bound(m):
                _die("training: a ReLU mask differs away from mu = 0")
            ties["relu"] += int(tie.sum())
        return torch.where(mask, m, 0.0), torch.where(mask, s, 0.0)

    def pool(mu, sigma):
        if queue is None:
            out = pool_apply(mu, sigma)
            record.append(P.vmaxpool(mu.detach(), sigma.detach(), return_idx=True)[2])
            return out
        mx, _, own = P.vmaxpool_plain(mu.detach(), sigma.detach())
        idx = next(queue).to(mu.device)
        b, h, w, c = mu.shape
        pad = (0, 0, 0, w % 2, 0, h % 2)
        m_taps = P._taps(torch.nn.functional.pad(mu, pad, value=torch.finfo(mu.dtype).min))
        s_taps = P._taps(torch.nn.functional.pad(sigma, pad))
        sel = [idx == t for t in range(4)]
        m = sum(torch.where(q, x, 0.0) for q, x in zip(sel, m_taps))
        s = sum(torch.where(q, x, 0.0) for q, x in zip(sel, s_taps))
        tie = own != idx
        if tie.any():
            if float((mx - m.detach())[tie].abs().max()) > tie_bound(mu):
                _die("training: a pool tap differs between taps that are not tied")
            ties["pool"] += int(tie.sum())
        return m, s

    V.VDPConv.apply, P.VMaxPool.apply = conv, pool
    try:
        yield ties
    finally:
        del V.VDPConv.apply, P.VMaxPool.apply


def _max_rel(torch, got, want) -> float:
    """max |got - want| / max |want|, ``got`` moved to ``want``'s device."""
    d = float((got.detach().to(want.device) - want).abs().max())
    return d / max(float(want.abs().max()), 1e-30)


def _train(torch, name, cfg, tc, batch, steps):
    """``steps`` train steps on the card with the launch counters zeroed
    before and read after, held against the same steps on the CPU from the
    same parameters and batches. Returns (launches, median step seconds of
    steps 2.., per-step launches)."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.models import layer_names

    params = _he_params(torch, cfg)
    rng = np.random.default_rng(SEED)
    s, o = cfg.image_size, cfg.out_size
    x = rng.normal(0.0, 1.0, (steps, batch, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (steps, batch, o, o)).astype(np.int32)
    gpu, _ = T.create_train_state(params, tc, "cuda")
    cpu, _ = T.create_train_state(params, tc, "cpu")

    # step-1 gradients, outside the counted run; the CPU replays the card's
    # ReLU masks and pool taps (see _decisions)
    def grads(state):
        dev = state.params["conv_input"]["w_mu"].device
        loss, _ = T.loss_fn(state.params, torch.from_numpy(x[0]).to(dev),
                            torch.from_numpy(y[0]).to(dev), cfg, tc)
        return torch.autograd.grad(loss, T.leaves(state.params))

    choices = []
    with _decisions(torch, record=choices):
        g_gpu = grads(gpu)
    with _decisions(torch, replay=choices) as ties:
        g_cpu = grads(cpu)
    worst_g = 0.0
    for g, r in zip(g_gpu, g_cpu):
        worst_g = max(worst_g, _max_rel(torch, g, r))
    if not worst_g <= TRAIN_GRAD_TOL:
        _die(f"{name} training: step-1 gradients differ from the CPU's by "
             f"{worst_g:.3e} of a leaf's max > {TRAIN_GRAD_TOL}")

    step = T.make_train_step(cfg, tc)
    torch.cuda.synchronize()
    _zero_launches()
    times, metrics = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        gpu, m = step(gpu, x[i], y[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append([float(v) for v in m])
    launches = _read_launches()
    n3 = sum(1 for _, k, _, _ in layer_names(cfg) if k == 3)
    per_step = {"vdp_conv": n3, "vdp_conv_reduce": _split_layers(cfg, batch),
                "vmaxpool": cfg.depth - 1, "vmaxpool_bwd": cfg.depth - 1,
                "sigma_bwd": n3}
    if launches != {k: v * steps for k, v in per_step.items()}:
        _die(f"{name} training: kernel launches {launches} in {steps} steps, "
             f"expected {per_step} per step")

    cpu_metrics = []
    for i in range(steps):
        cpu, m = step(cpu, x[i], y[i])
        cpu_metrics.append([float(v) for v in m])
    loss_err = 0.0
    for i, (mg, mc) in enumerate(zip(metrics, cpu_metrics)):
        if not all(math.isfinite(v) for v in mg) or not 0.0 <= mg[3] <= 1.0:
            _die(f"{name} training: step {i + 1} metrics {mg}")
        loss_err = max(loss_err, abs(mg[0] - mc[0]) / abs(mc[0]))
    if not loss_err <= TRAIN_LOSS_RTOL:
        _die(f"{name} training: losses {[m[0] for m in metrics]} differ from "
             f"the CPU's {[m[0] for m in cpu_metrics]} by {loss_err:.3e} relative")
    param_err = max(
        float((a.detach().cpu() - b.detach()).abs().max())
        for a, b in zip(T.leaves(gpu.params), T.leaves(cpu.params))
    )
    limit = 2.0 * tc.lr * steps
    if not param_err <= limit:
        _die(f"{name} training: parameters after {steps} steps differ from the "
             f"CPU's by {param_err:.3e} > 2 * lr * steps = {limit:.3e}")
    step_s = statistics.median(times[1:]) if steps > 1 else times[0]
    print(json.dumps({
        "training": name, "batch": batch, "steps": steps, "launches": launches,
        "losses": [m[0] for m in metrics], "cpu_losses": [m[0] for m in cpu_metrics],
        "accuracy": [m[3] for m in metrics],
        "loss_max_rel_err_vs_cpu": loss_err, "grad_max_rel_err_vs_cpu": worst_g,
        "grad_ties_replayed": ties,
        "param_max_abs_err_vs_cpu": param_err, "param_limit": limit,
        "step_s": times, "median_step_s": step_s, "img_per_s": batch / step_s,
    }), flush=True)
    return launches, step_s, per_step


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False; this script drives the "
             "port on an NVIDIA card and has no CPU fallback")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS
        from supernet_tpu_torch.ops import set_mxu_precision
        from supernet_tpu_torch.ops.kernels import _lib
        from supernet_tpu_torch.profiling import layer_shapes
    except ModuleNotFoundError as e:
        _die(f"{e}: run chip_smoke.py from the root of a checkout")

    # 1. setup
    set_mxu_precision("highest")  # TF32 off for cuDNN and cuBLAS
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    so = _lib.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({os.path.relpath(so._name)})", flush=True)

    # 2. kernels at every layer shape of the two configs, then extra cases
    check = KernelCheck(torch)
    for config, cfg, batch in (("hippocampus", HIPPOCAMPUS.model, 20),
                               ("brats", BRATS.model, 2)):
        convs, pools = layer_shapes(cfg)
        for layer, (_, h, w, cin), cout in convs:
            check.vdp_conv(config, layer, batch, h, w, cin, cout, 3,
                           has_sigma=layer != "conv_input", relu=True)
        for layer, (_, h, w, c) in pools:
            check.vmaxpool(config, layer, batch, h, w, c)
    for k in (2, 1):
        for has_sigma in (True, False):
            for relu in (False, True):
                check.vdp_conv("extra", f"k{k}", 4, 33, 29, 24, 40, k, has_sigma, relu)
    check.vdp_conv("extra", "k3_no_relu", 3, 17, 19, 3, 96, 3, True, False)
    check.vmaxpool("extra", "ties", 20, 60, 60, 32, ties=True)
    check.vmaxpool("extra", "odd", 3, 13, 15, 36, ties=True)

    # 3-4. serving at full width
    serve_launches, img_s = _serve(torch, "hippocampus", HIPPOCAMPUS.model, 20, (20, 7, 45))
    _serve(torch, "brats", BRATS.model, 2, (3,))

    # 5. the backward kernels and the VDP conv's backward at every layer
    # shape of one training step, then extra cases
    for config, cfg, batch in (("hippocampus", HIPPOCAMPUS.model, 20),
                               ("brats", BRATS.model, 2)):
        convs, pools = layer_shapes(cfg)
        for layer, (_, h, w, cin), cout in convs:
            check.sigma_bwd(config, layer, batch, h - 2, w - 2, cout, 3)
            check.vdp_conv_bwd(config, layer, batch, h, w, cin, cout, 3,
                               has_sigma=layer != "conv_input", relu=True)
        for layer, (_, h, w, c) in pools:
            check.vmaxpool_bwd(config, layer, batch, h, w, c)
    check.vmaxpool_bwd("extra", "ties", 20, 60, 60, 32, ties=True)
    check.vmaxpool_bwd("extra", "c130", 3, 8, 8, 130, ties=True)
    check.vmaxpool_bwd("extra", "odd", 3, 13, 15, 36, ties=True)
    check.sigma_bwd("extra", "c130_odd", 3, 17, 19, 130, 3)
    check.sigma_bwd("extra", "k2", 4, 32, 28, 40, 2)
    check.vdp_conv_bwd("extra", "k3_no_relu_c130", 3, 17, 19, 24, 130, 3, True, False)
    check.vdp_conv_bwd("extra", "k2_relu", 4, 33, 29, 24, 40, 2, True, True)

    # 6-7. training at full width. Adam's first step turns a gradient's
    # rounding into +-lr wherever the gradient is near 0, so the card's
    # trajectory must not change from run to run: cuDNN's deterministic
    # algorithms for the backward convolutions (the kernels have no atomics).
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        train_launches, step_s, per_step = _train(
            torch, "hippocampus", HIPPOCAMPUS.model, HIPPOCAMPUS.train, 20, 5)
        _train(torch, "brats", BRATS.model, BRATS.train, 2, 2)

    sources = {
        "vdp_conv": ("supernet_tpu_torch/csrc/vdp_conv.cu",
                     "supernet_tpu/ops/pallas/vdp_conv.py:125"),
        "vmaxpool": ("supernet_tpu_torch/csrc/pool.cu",
                     "supernet_tpu/ops/pallas/pool.py:72"),
        "vmaxpool_bwd": ("supernet_tpu_torch/csrc/pool.cu",
                         "supernet_tpu/ops/pallas/pool.py:106"),
        "sigma_bwd": ("supernet_tpu_torch/csrc/sigma_bwd.cu",
                      "supernet_tpu/ops/pallas/sigma_bwd.py:66"),
    }
    # ms, plain_ms and bound_ms: summed over the shapes of one hippocampus
    # step at batch 20 (brats_*: one BraTS step at batch 2); launches: the
    # hippocampus training run of phase 6. vdp_conv's bound_ms is the CUDA
    # cores' float32 bound; bound_3xtf32_ms that of its tensor-core path.
    summary = []
    for kernel, (source, replaces) in sources.items():
        ms, plain_ms, bound_ms, bytes_ms, ops_ms = check.ms[(kernel, "hippocampus")]
        brats = check.ms[(kernel, "brats")]
        extra = {}
        if kernel == "vdp_conv":
            # device_ms, cudnn_mu_ms (the mu product alone, a yardstick the
            # port never calls) and the 3xTF32 bound, summed like ms; the
            # split-K reduce launches of the hippocampus training run
            (dev, cudnn, b3), (dev_b, cudnn_b, b3_b) = check.vdp["hippocampus"], check.vdp["brats"]
            extra = {"device_ms": dev, "cudnn_mu_ms": cudnn, "bound_3xtf32_ms": b3,
                     "brats_device_ms": dev_b, "brats_cudnn_mu_ms": cudnn_b,
                     "brats_bound_3xtf32_ms": b3_b,
                     "reduce_launches": train_launches["vdp_conv_reduce"]}
        summary.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[kernel],
            "launches_per_step": per_step[kernel],
            "serving_launches": serve_launches[kernel],
            "max_abs_err": check.worst[kernel][0],
            "max_rel_err": check.worst[kernel][1],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "library_ms": None,
            "brats_ms": brats[0], "brats_plain_ms": brats[1],
            "brats_bound_ms": brats[2], **extra,
        })
    bwd, bwd_b = check.ms[("vdp_conv_bwd", "hippocampus")], check.ms[("vdp_conv_bwd", "brats")]
    print(json.dumps({
        "vdp_conv_backward": "VDPConv.backward (kernel 4 + PyTorch convs)",
        "max_abs_err": check.worst["vdp_conv_bwd"][0],
        "max_rel_err": check.worst["vdp_conv_bwd"][1],
        "ms": bwd[0], "plain_ms": bwd[1],
        "brats_ms": bwd_b[0], "brats_plain_ms": bwd_b[1],
    }))
    print(f"hippocampus serving: {img_s:.1f} img/s (batch 20, 45-image request)")
    print(f"hippocampus training: {20 / step_s:.1f} img/s "
          f"(batch 20, median step {1e3 * step_s:.3f} ms)")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
