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
   one BraTS step (batch 2), plus ties, C=130 and odd-shape cases that
   reach both paths of each (16-byte and general). The pool backward must
   be bit-exact; the sigma-chain backward's u and dsw within 1e-5 of the
   plain output's max magnitude (the summation order differs) and the same
   bits in two runs (no atomics). Each line carries the planner's path and
   grid and the device time with the stream held (no host time).
   At every k=3 conv shape the gradients of ``VDPConv`` (kernel 1 forward,
   kernel 4 inside the backward) are held against autograd of
   ``vdp_conv_plain``, each within 1e-4 of that gradient's max magnitude:
   the input gradient too at ``conv_input`` (``sigma=None``), which every
   attack and saliency map is, and again with weights that require no
   gradient (the attack's case: the weight gradients are skipped).
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

8. epoch trainer, hippocampus at full width, batch 20: ``Trainer`` on the
   card, 200 synthetic training and 40 validation images, 3 epochs with a
   checkpoint after each and the per-structure curves on, from He-scaled
   parameters read from an npz. The history must hold every key the JAX
   trainer writes, all finite; the launch counters over the run (zeroed
   just before, read just after) must equal steps x (10, 2, 2, 10) plus
   validation batches x (10, 2) (and the split-K reduces alike);
   ``epoch_0..2``, ``Related_hyperparameters.txt`` and ``history.pkl`` must
   exist. The same run with ``device="cpu"`` from the same npz: each
   epoch's train and validation loss within 1e-3 relative (see
   ``EPOCH_LOSS_RTOL``), the final parameters within 2 * lr * steps. Prints the last epoch's images/sec
   (also with the curves off), the share of the epoch spent in host
   metrics and the checkpoint's blocking time, with the card's name and
   power limit.
9. resume: a second ``Trainer`` with ``continue_training`` on a copy of
   that directory cut after ``epoch_1`` trains epoch 2; its parameters,
   Adam moments and step counters must equal phase 8's bit for bit. Then
   the roll-back path: a dataset whose first batch of epoch 1 is NaN makes
   that epoch's loss non-finite, the trainer restores ``epoch_0`` and
   epoch 2 trains on.
10. the CLI, in process and on its default device: ``cli.main(["train",
   "--synthetic", "100", "--steps-per-dispatch", "2", ...])`` (the launch
   counters must show its 5 steps and 2 validation batches), then
   ``convert`` of a pickle written here into a shard directory and
   ``train --data <dir>`` for one epoch through ``ShardDataset`` (prints
   whether the native or the Python loader served).
11. augmentation and remat: one train step with rot90 and intensity
   augmentation on the card and on the CPU from the same state (the
   augmented batch bit-equal, the loss within 1e-4 relative); one BraTS
   batch-2 loss and gradient with ``remat=True`` against ``remat=False`` on
   the card (loss and every gradient bit-equal, the forward kernels of the
   16 rematerialised convs launched twice, a lower peak of allocated
   memory; both peaks printed with the card's name and power limit).

12. attack gradients: ``attacks.input_gradient`` (the gradient of the
   attack loss with respect to the image, before the sign) at full
   hippocampus width, batch 20, targeted labels (class 3 of 3: all-zero
   one-hot rows), and at full BraTS width, batch 2, from He-scaled
   parameters that require a gradient and get none. The counters per
   gradient must read (10, 2, 2, 10) and (18, 4, 4, 18) of kernels 1-4
   (a rematerialised config would launch its block forwards twice). Held
   against the CPU with the card's ReLU masks and pool taps replayed, within
   ``ATTACK_GRAD_TOL`` of the gradient's max; no sign may differ from that
   of the same gradient in float64 (CPU, the same choices) above
   ``ATTACK_SIGN_FLOOR`` of its max. Printed beside it: the share of pixels
   whose sign differs, each float32 run's distance from float64, and the
   card's with kernel 1 replaced by its plain version. Then the adversarial train step (FGSM) beside the
   plain one: launches per step 3x the forwards and backwards (one attack
   gradient, the clean and the adversarial branch), and both step times.
13. ``run_adversarial`` on the card: hippocampus, the default targeted
   attack (``adv_class = 3``, PGD, 20 steps), 40 synthetic images; BraTS
   untargeted (one FGSM step), 4 images at batch 2. The counters must equal
   batches x (steps x per-gradient + per-forward). Every adversarial image
   lies inside the epsilon-ball and the batch's range exactly; the card's
   adversarial images through the CPU forward give the card's ``probs`` /
   ``sigma`` within the serving tolerances (the CPU runs no PGD step of its
   own); every artifact file is there. Prints seconds per attacked batch.
14. ``run_testing``, ``run_noise_sweep`` (one level, one region) and
   ``run_calibration`` on the card against the same calls with
   ``device="cpu"`` (the same noise draws: a CPU generator keyed by seed and
   batch): the metrics within ``EVAL_METRIC_ATOL`` (Hausdorff distances
   aside: one flipped pixel moves them by pixels), the SNR within 1e-4
   relative; ``mc_samples=4`` runs and returns finite moments. Prints
   ``test_time_per_batch_s`` and the sweep's seconds.
15. the evaluation CLI, in process and on its default device: ``cli.main(
   ["study", "--synthetic", "40", "--epochs", "1", ...])`` (train, eval,
   sweep, attack, calibrate; ``study.json`` must hold all five stages and
   the counters the launches of all of them), one ``saliency`` run (one
   gradient), and one epoch of ``train --adversarial-training fgsm``.

In phases 6-15 cuDNN runs its deterministic algorithms, and in 6-7 and 12
the CPU reference of the gradients replays the card's ReLU masks and pool
taps (``_decisions``), so that rounding ties do not decide the comparison.

The last two lines of standard output are the kernels summary
``{"kernels": [...]}`` (all four kernels, with their launches in the
hippocampus training run, the epoch trainer's run, the CLI's run, one
attack gradient, the adversarial evaluation and the study, errors, times
and bounds) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# An epoch's mean loss, card against CPU, after up to 30 Adam steps. Two
# correct implementations part by up to 2 * lr per weight and step wherever a
# gradient's sign is decided by rounding, and the parting compounds: on an
# H100 the 3 epochs of phase 8 read 7e-6, 2e-5 and 2e-4 relative. Ten times
# the per-step limit; the parameters are still held to 2 * lr * steps.
EPOCH_LOSS_RTOL = 1e-3
# the attack loss's gradient with respect to the image, card against CPU
# with the card's ReLU and pool choices replayed, relative to its max. On an
# H100 it read 6.1e-6 at hippocampus batch 20 and 1.7e-3 at BraTS batch 2,
# where the CPU's float32 run is 2e-6 from the same gradient in float64: the
# loss divides by sigma, so the gradient takes the relative error that sigma
# gathers over 18 layers on the card (the phase prints where it comes from).
ATTACK_GRAD_TOL = 5e-3
# below this share of the gradient's max (twice the limit above) a sign may
# be decided by rounding
ATTACK_SIGN_FLOOR = 1e-2
# evaluation metrics (accuracy, Dice, rates, calibration scalars), card
# against CPU on the same images and draws: a few argmax flips among the
# 116,640 pixels of 40 hippocampus images
EVAL_METRIC_ATOL = 5e-3
EVAL_SNR_RTOL = 1e-4
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
        self.paths = {}  # kernel 3 or 4 -> the planner's paths its shapes took
        self.dev = {}  # (kernel 3 or 4, config) -> summed device ms

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
        from supernet_tpu_torch.profiling import device_ms

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
            dev_ms = device_ms(lambda: P.vmaxpool_bwd(idx, g_mu, g_sigma, h, w))
        plan = P.plan_bwd(b, h, w, c)
        self._seen("vmaxpool_bwd", config, plan.path, dev_ms)
        nbytes = 4 * (3 * idx.numel() + 2 * mu.numel())
        self._record("vmaxpool_bwd", config, 0.0, 0.0, ms, plain_ms,
                     _bound(nbytes, 0), {
            "layer": layer, "shape": [b, h, w, c], "ties": ties,
            "path": plan.path, "blocks": plan.blocks, "device_ms": dev_ms,
        })

    def sigma_bwd(self, config, layer, b, hp, wp, c, k):
        torch = self.torch
        import torch.nn.functional as F

        from supernet_tpu_torch.ops.kernels import sigma_bwd as S
        from supernet_tpu_torch.profiling import device_ms

        g = self._randn(b, hp, wp, c)
        t = 10.0 * self._randn(b, hp, wp).abs()
        s_w = F.softplus(self._randn(c) - 4.0)
        with torch.inference_mode():
            got = S.winsum_spread_bwd(g, t, s_w, k)
            again = S.winsum_spread_bwd(g, t, s_w, k)
            want = S.winsum_spread_bwd_plain(g, t, s_w, k)
            torch.cuda.synchronize()
            abs_err = rel_err = 0.0
            for name, x, x2, r in zip(("u", "dsw"), got, again, want):
                if not torch.equal(x, x2):
                    _die(f"sigma_bwd {config}/{layer}: {name} differs between "
                         f"two runs on the same input")
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
            dev_ms = device_ms(lambda: S.winsum_spread_bwd(g, t, s_w, k))
        plan = S.plan(b, hp, wp, c, k)
        self._seen("sigma_bwd", config, plan.path, dev_ms)
        h, w = hp + k - 1, wp + k - 1
        nbytes = 4 * (g.numel() + t.numel() + 2 * c + b * h * w)
        flops = 4 * g.numel() + k * k * b * h * w
        self._record("sigma_bwd", config, abs_err, rel_err, ms, plain_ms,
                     _bound(nbytes, flops), {
            "layer": layer, "shape": [b, hp, wp, c, k], "path": plan.path,
            "blocks": plan.blocks, "spread_blocks": plan.spread_blocks,
            "same_bits_in_two_runs": True, "device_ms": dev_ms,
        })

    def vdp_conv_bwd(self, config, layer, b, h, w, cin, cout, k, has_sigma, relu,
                     frozen=False):
        """VDPConv's gradients (kernel 1 forward, kernel 4 in the backward)
        against autograd of the plain version on the same cotangents. Where
        the two ReLU masks differ (a pre-activation that rounds to 0 in one
        summation order only, checked to lie at mu = 0 as in _vdp_errors)
        the cotangents are set to 0, so both backward passes see one mask.
        The input always requires a gradient (at ``sigma=None`` too: the
        image's gradient); with ``frozen`` the weights do not."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V

        mu = self._randn(b, h, w, cin).requires_grad_()
        sigma = (0.05 * self._randn(b, h, w, cin).abs()).requires_grad_() if has_sigma else None
        w_mu = (0.1 * self._randn(k, k, cin, cout)).requires_grad_(not frozen)
        w_sigma = (-4.0 + self._randn(cout)).requires_grad_(not frozen)
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
            "gradients": names,
        })

    def _seen(self, kernel, config, path, dev_ms):
        """Note the path a backward kernel's plan took and add its device
        time (the stream held by a sleep) to the config's sum."""
        self.paths.setdefault(kernel, set()).add(path)
        self.dev[(kernel, config)] = self.dev.get((kernel, config), 0.0) + dev_ms

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



def _per_forward(cfg, batch) -> dict:
    """Launches of one forward (vdp_conv, its split-K reduces, pool)."""
    from supernet_tpu_torch.models import layer_names

    return {"vdp_conv": sum(1 for _, k, _, _ in layer_names(cfg) if k == 3),
            "vdp_conv_reduce": _split_layers(cfg, batch),
            "vmaxpool": cfg.depth - 1}


def _expected_launches(cfg, batch, steps, eval_batches) -> dict:
    """Launches of ``steps`` train steps and ``eval_batches`` forwards."""
    f = _per_forward(cfg, batch)
    return {"vdp_conv": (steps + eval_batches) * f["vdp_conv"],
            "vdp_conv_reduce": (steps + eval_batches) * f["vdp_conv_reduce"],
            "vmaxpool": (steps + eval_batches) * f["vmaxpool"],
            "vmaxpool_bwd": steps * f["vmaxpool"],
            "sigma_bwd": steps * f["vdp_conv"]}


def _state_tensors(state):
    """(name, tensor) of every parameter and Adam moment of a TrainState,
    and its step counters."""
    from supernet_tpu_torch.checkpoint import snapshot_state

    snap = snapshot_state(state)
    out = [(f"{kind}/{layer}/{name}", t)
           for kind in ("params", "exp_avg", "exp_avg_sq")
           for layer, ws in snap[kind].items() for name, t in ws.items()]
    return out, (snap["adam_step"], snap["step"])


def _epoch_trainer(torch, smi, tmp):
    """Phase 8. Returns (launches, the card run's final state, its out dir,
    the experiment, the initial parameters' npz, the two datasets)."""
    import numpy as np

    from supernet_tpu_torch.checkpoint import load_params_npz, save_params_npz
    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.data import PickleDataset, synthetic_dataset
    from supernet_tpu_torch.metrics import dataset_structures
    from supernet_tpu_torch.train import leaves
    from supernet_tpu_torch.trainer import Trainer

    epochs, n_train, n_val, batch = 3, 200, 40, 20
    exp = HIPPOCAMPUS.replace(train=dataclasses.replace(
        HIPPOCAMPUS.train, epochs=epochs, batch_size=batch, checkpoint_every=1))
    cfg = exp.model
    npz = os.path.join(tmp, "init.npz")
    save_params_npz(npz, _he_params(torch, cfg))
    train_ds = PickleDataset(*synthetic_dataset(cfg, n_train, seed=0), cfg.in_channels)
    val_ds = PickleDataset(*synthetic_dataset(cfg, n_val, seed=1), cfg.in_channels)
    steps, val_batches = epochs * (n_train // batch), epochs * math.ceil(n_val / batch)

    def run(device, curves, n_epochs, sub):
        out = os.path.join(tmp, sub)
        tr = Trainer(exp, train_ds, val_ds if curves else None, out_dir=out,
                     track_curves=curves, device=device,
                     initial_params=load_params_npz(npz, "cpu"))
        state = tr.run(epochs=n_epochs, log=lambda *_: None)
        return tr, state, out

    torch.cuda.synchronize()
    _zero_launches()
    gpu, gpu_state, gpu_out = run("cuda", True, epochs, "trainer_cuda")
    launches = _read_launches()
    want = _expected_launches(cfg, batch, steps, val_batches)
    if launches != want:
        _die(f"epoch trainer: kernel launches {launches}, expected {want}")

    keys = ["train_loss", "train_acc", "val_loss", "val_acc", "val_dice", "images_per_sec"]
    for st in dataset_structures(exp.name):
        keys += [f"train_dice_{st}", f"train_haus_{st}", f"val_dice_{st}", f"val_haus_{st}"]
    for k in keys:
        v = gpu.history.get(k)
        if v is None or len(v) != epochs or not all(math.isfinite(a) for a in v):
            _die(f"epoch trainer: history[{k!r}] = {v}")
    for name in [f"epoch_{e}/state.pt" for e in range(epochs)] + [
            "Related_hyperparameters.txt", "history.pkl"]:
        if not os.path.isfile(os.path.join(gpu_out, name)):
            _die(f"epoch trainer: {name} was not written")

    cpu, cpu_state, _ = run("cpu", True, epochs, "trainer_cpu")
    loss_err = max(
        abs(a - b) / abs(b)
        for k in ("train_loss", "val_loss")
        for a, b in zip(gpu.history[k], cpu.history[k]))
    if not loss_err <= EPOCH_LOSS_RTOL:
        _die(f"epoch trainer: epoch losses {gpu.history['train_loss']} / "
             f"{gpu.history['val_loss']} differ from the CPU's "
             f"{cpu.history['train_loss']} / {cpu.history['val_loss']} by "
             f"{loss_err:.3e} relative")
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(leaves(gpu_state.params), leaves(cpu_state.params)))
    limit = 2.0 * exp.train.lr * steps
    if not param_err <= limit:
        _die(f"epoch trainer: parameters after {steps} steps differ from the "
             f"CPU's by {param_err:.3e} > 2 * lr * steps = {limit:.3e}")

    # the same epochs with the curves (and validation) off, for the rate
    bare, _, _ = run("cuda", False, 2, "trainer_bare")
    t = gpu.timings
    print(json.dumps({
        "epoch_trainer": "hippocampus", "card": smi, "batch": batch,
        "epochs": epochs, "steps": steps, "validation_batches": val_batches,
        "launches": launches,
        "train_loss": gpu.history["train_loss"], "cpu_train_loss": cpu.history["train_loss"],
        "val_loss": gpu.history["val_loss"], "cpu_val_loss": cpu.history["val_loss"],
        "val_dice": gpu.history["val_dice"],
        "loss_max_rel_err_vs_cpu": loss_err,
        "param_max_abs_err_vs_cpu": param_err, "param_limit": limit,
        "images_per_sec": gpu.history["images_per_sec"],
        "images_per_sec_last_epoch": gpu.history["images_per_sec"][-1],
        "images_per_sec_last_epoch_curves_off": bare.history["images_per_sec"][-1],
        "epoch_s": t["epoch_s"], "host_metric_s": t["host_metric_s"],
        "host_metric_share_last_epoch": t["host_metric_s"][-1] / t["epoch_s"][-1],
        "validate_s": t["validate_s"], "checkpoint_blocking_s": t["checkpoint_s"],
        "epoch_s_curves_off": bare.timings["epoch_s"],
        "cpu_images_per_sec_last_epoch": cpu.history["images_per_sec"][-1],
    }), flush=True)
    print(f"epoch trainer: {gpu.history['images_per_sec'][-1]:.1f} img/s in the last "
          f"epoch with the curves on, {bare.history['images_per_sec'][-1]:.1f} img/s "
          f"with them off (hippocampus, batch 20; {smi})", flush=True)
    return launches, gpu_state, gpu_out, exp, npz, (train_ds, val_ds)


class _PoisonedOnce:
    """A dataset whose first batch of one epoch is NaN."""

    def __init__(self, ds, epoch):
        self.ds, self.epoch = ds, epoch

    def __len__(self):
        return len(self.ds)

    def batches(self, batch_size, epoch=0, **kw):
        for i, (x, y) in enumerate(self.ds.batches(batch_size, epoch=epoch, **kw)):
            if epoch == self.epoch and i == 0:
                x = x * float("nan")
            yield x, y


def _resume_and_rollback(torch, tmp, final_state, trained_dir, exp, npz, datasets):
    """Phase 9."""
    from supernet_tpu_torch import checkpoint as ckpt
    from supernet_tpu_torch.data import PickleDataset
    from supernet_tpu_torch.trainer import Trainer

    train_ds, val_ds = datasets
    cut = os.path.join(tmp, "resumed")
    os.makedirs(cut)
    for e in (0, 1):
        shutil.copytree(os.path.join(trained_dir, f"epoch_{e}"),
                        os.path.join(cut, f"epoch_{e}"))
    # a half-written checkpoint (its file still under the temporary name)
    os.makedirs(os.path.join(cut, "epoch_7"))
    open(os.path.join(cut, "epoch_7", "state.pt.1.tmp"), "wb").close()
    if ckpt.latest_epoch(cut) != 1:
        _die(f"resume: latest_epoch sees {ckpt.latest_epoch(cut)}, expected 1")
    shutil.rmtree(os.path.join(cut, "epoch_7"))
    exp_c = exp.replace(train=dataclasses.replace(exp.train, continue_training=True))
    tr = Trainer(exp_c, train_ds, val_ds, out_dir=cut, device="cuda")
    state = tr.run(epochs=3, log=lambda *_: None)
    if tr.start_epoch != 2 or len(tr.history["train_loss"]) != 1:
        _die(f"resume: started at epoch {tr.start_epoch}")
    got, got_steps = _state_tensors(state)
    want, want_steps = _state_tensors(final_state)
    if got_steps != want_steps:
        _die(f"resume: step counters {got_steps}, expected {want_steps}")
    differing = [n for (n, a), (_, b) in zip(got, want) if not torch.equal(a, b)]
    if differing:
        _die(f"resume: {len(differing)} of {len(got)} state tensors are not "
             f"bit-equal to the uninterrupted run's, e.g. {differing[:3]}")

    small = PickleDataset(train_ds.x[:60], train_ds.y[:60], exp.model.in_channels)
    logs = []
    roll = os.path.join(tmp, "rollback")
    tr2 = Trainer(exp, _PoisonedOnce(small, 1), None, out_dir=roll, device="cuda",
                  initial_params=ckpt.load_params_npz(npz, "cpu"))
    state2 = tr2.run(epochs=3, log=lambda m: logs.append(str(m)))
    losses = tr2.history["train_loss"]
    if not any("rolling back to epoch 0" in m for m in logs):
        _die(f"roll-back: no roll-back in the log (epoch losses {losses})")
    if math.isfinite(losses[1]) or not (math.isfinite(losses[0]) and math.isfinite(losses[2])):
        _die(f"roll-back: epoch losses {losses}")
    if ckpt.latest_epoch(roll) != 2 or os.path.exists(os.path.join(roll, "epoch_1")):
        _die("roll-back: expected checkpoints of epochs 0 and 2 only")
    if not all(bool(torch.isfinite(t).all()) for _, t in _state_tensors(state2)[0]):
        _die("roll-back: the final state has non-finite values")
    print(json.dumps({
        "resume": "bit-exact", "state_tensors": len(got), "step_counters": list(got_steps),
        "rollback_epoch_losses": [l if math.isfinite(l) else None for l in losses],
    }), flush=True)


def _cli(torch, tmp):
    """Phase 10. Returns the launches of the first ``cli train``."""
    from supernet_tpu_torch import cli
    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.data import ShardDataset, synthetic_dataset

    cfg = HIPPOCAMPUS.model
    out1 = os.path.join(tmp, "cli_synthetic")
    torch.cuda.synchronize()
    _zero_launches()
    rc = cli.main(["train", "--config", "hippocampus", "--synthetic", "100",
                   "--epochs", "1", "--out-dir", out1, "--steps-per-dispatch", "2"])
    launches = _read_launches()
    want = _expected_launches(cfg, 20, 5, 5)
    if rc != 0 or launches != want:
        _die(f"cli train: rc {rc}, kernel launches {launches}, expected {want} "
             "(the default device must be the card)")
    for name in ("epoch_0/state.pt", "history.pkl", "Related_hyperparameters.txt"):
        if not os.path.isfile(os.path.join(out1, name)):
            _die(f"cli train: {name} was not written")

    x, y = synthetic_dataset(cfg, 121, seed=2)
    pkl, shards = os.path.join(tmp, "hippocampus.pkl"), os.path.join(tmp, "shards")
    with open(pkl, "wb") as f:
        pickle.dump((x[:100, ..., 0], y[:100], x[100:, ..., 0], y[100:]), f)
    rc = cli.main(["convert", "--config", "hippocampus", "--data", pkl,
                   "--out", shards, "--shard-size", "64"])
    ds = ShardDataset(shards)
    if rc != 0 or len(ds) != 100 or len(ds.pairs) != 2:
        _die(f"cli convert: rc {rc}, {len(ds)} samples in {len(ds.pairs)} shards")
    out2 = os.path.join(tmp, "cli_shards")
    _zero_launches()
    rc = cli.main(["train", "--config", "hippocampus", "--data", shards,
                   "--epochs", "1", "--out-dir", out2])
    shard_launches = _read_launches()
    if rc != 0 or shard_launches != want:
        _die(f"cli train --data <shards>: rc {rc}, kernel launches "
             f"{shard_launches}, expected {want}")
    with open(os.path.join(out2, "history.pkl"), "rb") as f:
        hist = pickle.load(f)
    if not all(math.isfinite(v[-1]) for v in hist.values() if v):
        _die(f"cli train --data <shards>: history {hist}")
    print(json.dumps({
        "cli": "train, convert, train --data", "launches": launches,
        "shard_launches": shard_launches,
        "shard_loader": "native" if ds.use_native else "python",
        "shard_train_loss": hist["train_loss"][-1],
    }), flush=True)
    return launches


def _augment_and_remat(torch, smi):
    """Phase 11."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS, AugmentConfig

    cfg = HIPPOCAMPUS.model
    tc = dataclasses.replace(HIPPOCAMPUS.train, augment=AugmentConfig(
        rot90=True, intensity_scale=0.1, intensity_shift=0.05))
    rng = np.random.default_rng(SEED)
    x = rng.normal(0.0, 1.0, (20, cfg.image_size, cfg.image_size, 1)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (20, cfg.out_size, cfg.out_size)).astype(np.int32)
    params = _he_params(torch, cfg)
    losses, batches = {}, {}
    for dev in ("cuda", "cpu"):
        state, _ = T.create_train_state(params, tc, dev)
        state.step = 3  # the draws are keyed by the step counter
        xa, ya = T.maybe_augment(state.step, torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev), cfg, tc)
        batches[dev] = (xa.cpu(), ya.cpu())
        state, m = T.make_train_step(cfg, tc)(state, x, y)
        losses[dev] = float(m.loss)
    for what, a, b in zip(("x", "y"), batches["cuda"], batches["cpu"]):
        if not torch.equal(a, b):
            _die(f"augmentation: the augmented {what} differs between the card and the CPU")
    if torch.equal(batches["cpu"][0], torch.from_numpy(x)) or torch.equal(
            batches["cpu"][1], torch.from_numpy(y)):
        _die("augmentation: the batch did not change")
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not loss_err <= TRAIN_LOSS_RTOL:
        _die(f"augmentation: loss {losses['cuda']} differs from the CPU's "
             f"{losses['cpu']} by {loss_err:.3e} relative")

    cfg = BRATS.model
    tc = BRATS.train
    xb = torch.from_numpy(rng.normal(0.0, 1.0, (2, cfg.image_size, cfg.image_size,
                                                cfg.in_channels)).astype(np.float32)).cuda()
    yb = torch.from_numpy(rng.integers(0, cfg.n_classes, (2, cfg.out_size, cfg.out_size))
                          .astype(np.int32)).cuda()
    state, _ = T.create_train_state(_he_params(torch, cfg), tc, "cuda")
    f = _per_forward(cfg, 2)
    outs = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        # remat leaves conv_input and conv1 alone and runs the forward of
        # every other k=3 conv a second time in the backward pass
        again = f["vdp_conv"] - 2 if remat else 0
        for attempt in range(2):  # the second one is measured
            loss = grads = None  # frees the first attempt's tensors
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _zero_launches()
            loss, _ = T.loss_fn(state.params, xb, yb, c, tc)
            grads = torch.autograd.grad(loss, T.leaves(state.params))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = _read_launches()
        if launches["vdp_conv"] != f["vdp_conv"] + again or launches[
                "sigma_bwd"] != f["vdp_conv"] or launches["vmaxpool"] != f["vmaxpool"]:
            _die(f"remat={remat}: kernel launches {launches}")
        outs[remat] = (loss.detach().cpu(), [g.cpu() for g in grads], peak,
                       peak - base, launches)
        loss = grads = None
    if not torch.equal(outs[True][0], outs[False][0]):
        _die(f"remat: loss {float(outs[True][0])} != {float(outs[False][0])}")
    differing = sum(not torch.equal(a, b) for a, b in zip(outs[True][1], outs[False][1]))
    if differing:
        _die(f"remat: {differing} of {len(outs[True][1])} gradients are not bit-equal")
    if not outs[True][2] < outs[False][2]:
        _die(f"remat: peak memory {outs[True][2]} is not below {outs[False][2]}")
    print(json.dumps({
        "augment_and_remat": "ok", "card": smi,
        "augment_loss": losses["cuda"], "augment_cpu_loss": losses["cpu"],
        "augment_loss_rel_err_vs_cpu": loss_err,
        "remat_loss": float(outs[True][0]),
        "brats_b2_peak_bytes": outs[False][2], "brats_b2_peak_bytes_remat": outs[True][2],
        "brats_b2_step_bytes": outs[False][3], "brats_b2_step_bytes_remat": outs[True][3],
        "remat_launches": outs[True][4],
    }), flush=True)
    print(f"BraTS batch 2, loss and gradient: peak {outs[False][2] / 2**20:.1f} MiB "
          f"allocated, {outs[True][2] / 2**20:.1f} MiB with remat ({smi})", flush=True)


def _per_gradient(cfg, batch) -> dict:
    """Launches of one forward and backward (a train step, or one gradient
    with respect to the image)."""
    return _expected_launches(cfg, batch, 1, 0)


def _scaled(launches: dict, n: int) -> dict:
    return {k: n * v for k, v in launches.items()}


def _summed(*parts: dict) -> dict:
    return {k: sum(p.get(k, 0) for p in parts) for k in parts[0]}


def _attack_batch(torch, cfg, batch, targeted, device):
    """A seeded batch on ``device`` and its one-hot flattened attack label
    (the targeted relabeling of class 2 to class 3 where asked)."""
    import numpy as np

    from supernet_tpu_torch.attacks import retarget_labels
    from supernet_tpu_torch.train import one_hot_flatten

    rng = np.random.default_rng(SEED)
    s, o = cfg.image_size, cfg.out_size
    x = torch.from_numpy(rng.normal(0.0, 1.0, (batch, s, s, cfg.in_channels))
                         .astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (batch, o, o))
                         .astype(np.int32)).to(device)
    if targeted:
        y = retarget_labels(y, 2, 3)
    return x, one_hot_flatten(y, cfg.n_classes)


def _attack_gradient(torch, name, exp, batch):
    """Phase 12, one config. Returns (launches of one gradient, seconds per
    gradient)."""
    from supernet_tpu_torch import attacks
    from supernet_tpu_torch import train as T

    cfg, ac = exp.model, exp.attack
    # a train state's parameters: they require a gradient and must get none
    state, _ = T.create_train_state(_he_params(torch, cfg), exp.train, "cuda")
    cpu, _ = T.create_train_state(_he_params(torch, cfg), exp.train, "cpu")
    x, y_flat = _attack_batch(torch, cfg, batch, ac.targeted, "cuda")
    if ac.targeted and not bool((y_flat.sum(-1) == 0).any()):
        _die(f"{name} attack gradient: the targeted label has no all-zero row")

    attacks.input_gradient(state.params, x, y_flat, cfg, ac)  # warm-up
    torch.cuda.synchronize()
    _zero_launches()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        g = attacks.input_gradient(state.params, x, y_flat, cfg, ac)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = _read_launches()
    want = _per_gradient(cfg, batch)
    if cfg.remat:  # every block but conv_input / conv1 runs forward twice
        want["vdp_conv"] += want["vdp_conv"] - 2
    if launches != _scaled(want, 5):
        _die(f"{name} attack gradient: kernel launches {launches} in 5 gradients, "
             f"expected {want} each")
    if any(t.grad is not None for t in T.leaves(state.params)):
        _die(f"{name} attack gradient: a parameter was given a gradient")

    choices = []
    with _decisions(torch, record=choices):
        g_rec = attacks.input_gradient(state.params, x, y_flat, cfg, ac)
    if not torch.equal(g, g_rec):
        _die(f"{name} attack gradient: two runs on the card differ")
    with _decisions(torch, replay=choices) as ties:
        g_cpu = attacks.input_gradient(cpu.params, x.cpu(), y_flat.cpu(), cfg, ac)
    if g.shape != x.shape or not bool(torch.isfinite(g).all()):
        _die(f"{name} attack gradient: shape {tuple(g.shape)} or non-finite values")
    err = _max_rel(torch, g, g_cpu)
    # the same gradient in float64 on the CPU (the same choices replayed; the
    # softmax head stays float32): how far each float32 run is from it
    p64 = {k: {n: t.detach().double() for n, t in ws.items()}
           for k, ws in cpu.params.items()}
    with _decisions(torch, replay=choices):
        g64 = attacks.input_gradient(p64, x.cpu().double(), y_flat.cpu().double(), cfg, ac)
    err_card64, err_cpu64 = _max_rel(torch, g.double(), g64), _max_rel(torch, g_cpu.double(), g64)
    if not err <= ATTACK_GRAD_TOL:
        _die(f"{name} attack gradient differs from the CPU's by {err:.3e} of its "
             f"max > {ATTACK_GRAD_TOL} (from float64 by {err_card64:.3e}, the "
             f"CPU's float32 by {err_cpu64:.3e})")
    # where the card's distance comes from: the same gradient on the card
    # with kernel 1 replaced by its plain version (cuDNN float32), the same
    # choices replayed; printed, not held to a limit
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    kernel_1 = V.vdp_conv
    V.vdp_conv = V.vdp_conv_plain
    try:
        with _decisions(torch, replay=choices):
            g_plain = attacks.input_gradient(state.params, x, y_flat, cfg, ac)
    finally:
        V.vdp_conv = kernel_1
    err_plain64 = _max_rel(torch, g_plain.double(), g64)
    scale = float(g_cpu.abs().max())
    clear = g64.abs() > ATTACK_SIGN_FLOOR * scale
    sign_off = torch.sign(g.cpu()) != torch.sign(g64)
    if bool((sign_off & clear).any()):
        _die(f"{name} attack gradient: a sign differs from the float64 gradient's where "
             f"|g| > {ATTACK_SIGN_FLOOR} of its max")
    sec = statistics.median(times)
    print(json.dumps({
        "attack_gradient": name, "batch": batch, "targeted": ac.targeted,
        "launches_per_gradient": want, "grad_max_rel_err_vs_cpu": err,
        "grad_max_rel_err_vs_float64": err_card64,
        "cpu_grad_max_rel_err_vs_float64": err_cpu64,
        "card_grad_with_plain_kernel_1_max_rel_err_vs_float64": err_plain64,
        "grad_max_abs": scale, "grad_ties_replayed": ties,
        "sign_share_differing": float(sign_off.float().mean()),
        "share_above_sign_floor": float(clear.float().mean()),
        "gradient_s": times, "median_gradient_s": sec,
    }), flush=True)
    return want, sec


def _adversarial_train_step(torch, smi):
    """Phase 12, the adversarial train step (FGSM) beside the plain one:
    launches per step and median step seconds of steps 2-5 of each."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.configs import HIPPOCAMPUS

    cfg, batch, steps = HIPPOCAMPUS.model, 20, 5
    rng = np.random.default_rng(SEED)
    x = rng.normal(0.0, 1.0, (batch, cfg.image_size, cfg.image_size, 1)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (batch, cfg.out_size, cfg.out_size)).astype(np.int32)
    out = {}
    for mode in ("none", "fgsm"):
        tc = dataclasses.replace(HIPPOCAMPUS.train, adversarial_training=mode)
        state, _ = T.create_train_state(_he_params(torch, cfg), tc, "cuda")
        step = T.make_train_step(cfg, tc)
        torch.cuda.synchronize()
        _zero_launches()
        times, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m.loss))
        launches = _read_launches()
        # fgsm: the attack's gradient, then the clean and the adversarial branch
        want = _scaled(_per_gradient(cfg, batch), steps * (3 if mode == "fgsm" else 1))
        if launches != want:
            _die(f"train step, adversarial_training={mode}: kernel launches "
                 f"{launches}, expected {want}")
        if not all(math.isfinite(v) for v in losses):
            _die(f"train step, adversarial_training={mode}: losses {losses}")
        out[mode] = (statistics.median(times[1:]), launches, losses)
    if not out["fgsm"][2][-1] < out["fgsm"][2][0]:
        _die(f"adversarial training: the loss did not fall: {out['fgsm'][2]}")
    print(json.dumps({
        "adversarial_train_step": "hippocampus, fgsm", "card": smi, "batch": batch,
        "steps": steps, "launches": out["fgsm"][1], "plain_launches": out["none"][1],
        "losses": out["fgsm"][2], "plain_losses": out["none"][2],
        "median_step_s": out["fgsm"][0], "plain_median_step_s": out["none"][0],
    }), flush=True)
    print(f"adversarial train step (FGSM) {1e3 * out['fgsm'][0]:.3f} ms beside "
          f"{1e3 * out['none'][0]:.3f} ms plain (hippocampus, batch 20; {smi})", flush=True)
    return out["fgsm"][0], out["none"][0]


def _eval_exp(name, batch):
    from supernet_tpu_torch.configs import get_config

    exp = get_config(name)
    return exp.replace(train=dataclasses.replace(exp.train, batch_size=batch))


def _synthetic_ds(cfg, n, seed=1):
    from supernet_tpu_torch.data import PickleDataset, synthetic_dataset

    return PickleDataset(*synthetic_dataset(cfg, n, seed=seed), cfg.in_channels)


def _run_adversarial(torch, smi, tmp, name, batch, n_images):
    """Phase 13, one config. Returns (launches, seconds per attacked batch)."""
    import numpy as np

    from supernet_tpu_torch import evaluate as E
    from supernet_tpu_torch import reports
    from supernet_tpu_torch.checkpoint import params_from_jax
    from supernet_tpu_torch.models import forward

    exp = _eval_exp(name, batch)
    cfg, ac = exp.model, exp.attack
    use_pgd = ac.targeted or name == "hippocampus"
    steps = ac.max_adv_step if use_pgd else 1
    params = _he_params(torch, cfg)
    ds = _synthetic_ds(cfg, n_images)
    batches = math.ceil(n_images / batch)
    out = os.path.join(tmp, f"adversarial_{name}")

    # keep every batch's clean and adversarial frames, and time the attack
    seen, attack_s = [], []
    which = "make_pgd_attack" if use_pgd else "make_fgsm_attack"
    make = getattr(E, which)

    def recording(*a, **kw):
        attack = make(*a, **kw)

        def run(p, x, y_flat, x_min, x_max):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            adv = attack(p, x, y_flat, x_min, x_max)
            torch.cuda.synchronize()
            attack_s.append(time.perf_counter() - t0)
            seen.append((x.cpu(), adv.cpu()))
            return adv

        return run

    setattr(E, which, recording)
    try:
        torch.cuda.synchronize()
        _zero_launches()
        res = E.run_adversarial(exp, params, ds, out_dir=out, images_n=2)
        launches = _read_launches()
    finally:
        setattr(E, which, make)
    want = _scaled(_summed(_scaled(_per_gradient(cfg, batch), steps),
                           _expected_launches(cfg, batch, 0, 1)), batches)
    if launches != want or len(seen) != batches:
        _die(f"run_adversarial {name}: kernel launches {launches}, expected {want} "
             f"({batches} batches x ({steps} gradients + 1 forward))")
    for f in ("uncertainty_info.pkl", "Predictive_variance_tasks.txt",
              "Related_hyperparameters_adversarial.txt"):
        if not os.path.isfile(os.path.join(out, f)):
            _die(f"run_adversarial {name}: {f} was not written")
    numbers = [v for k, v in res.items() if isinstance(v, float) and k.startswith(
        ("accuracy", "snr_db", "mean_predictive", "test_time"))]
    if not all(math.isfinite(v) for v in numbers) or res["artifact_samples"] != n_images:
        _die(f"run_adversarial {name}: result {res}")

    # the ball and the range exactly (the same float32 bounds the attack clips to)
    moved = 0.0
    for x, adv in seen:
        if not bool(((adv >= x - ac.epsilon) & (adv <= x + ac.epsilon)).all()):
            _die(f"run_adversarial {name}: an adversarial pixel lies outside the ball")
        if float(adv.min()) < float(x.min()) or float(adv.max()) > float(x.max()):
            _die(f"run_adversarial {name}: an adversarial pixel lies outside the range")
        moved = max(moved, float((adv - x).abs().max()))
    if not moved > 0:
        _die(f"run_adversarial {name}: the attack moved nothing")

    # the card's adversarial images through the CPU forward
    probs, sigma = reports.load_uncertainty_artifact(res["artifact"])[:2]
    cpu_params = params_from_jax(params, "cpu")
    with torch.no_grad():
        ref = [forward(cpu_params, adv, cfg) for _, adv in seen]
    shape = (n_images, cfg.out_size, cfg.out_size, cfg.n_classes)
    ref_p = torch.cat([p for p, _ in ref]).numpy().reshape(shape)
    ref_s = torch.cat([v for _, v in ref]).numpy().reshape(shape)
    worst_p = float(np.abs(probs - ref_p).max())
    d = np.abs(sigma - ref_s) / max(float(np.abs(ref_s).max()), 1e-30)
    share = float((d > SERVE_SIGMA_RTOL).mean())
    if worst_p > SERVE_PROBS_ATOL or share > SERVE_SIGMA_SHARE:
        _die(f"run_adversarial {name}: the card's forward of its adversarial images "
             f"differs from the CPU's (probs {worst_p:.3e}; sigma beyond "
             f"{SERVE_SIGMA_RTOL} relative on {share:.3%} of the elements)")
    sec = statistics.median(attack_s)
    print(json.dumps({
        "run_adversarial": name, "card": smi, "batch": batch, "images": n_images,
        "attack": "pgd" if use_pgd else "fgsm", "steps": steps, "targeted": ac.targeted,
        "epsilon": ac.epsilon, "launches": launches, "max_moved": moved,
        "accuracy": res["accuracy"], "snr_db": res["snr_db"],
        "mean_predictive_variance": res["mean_predictive_variance"],
        "probs_max_abs_err_vs_cpu": worst_p, "sigma_share_beyond_rtol": share,
        "cpu_pgd_steps": 0, "attacked_batch_s": attack_s,
        "median_attacked_batch_s": sec,
        "test_time_per_batch_s": res["test_time_per_batch_s"],
    }), flush=True)
    print(f"{name} attacked batch ({'PGD' if use_pgd else 'FGSM'}, {steps} step(s), "
          f"batch {batch}): {sec:.4f} s ({smi})", flush=True)
    return launches, sec


def _metrics_close(what, got, want) -> float:
    """Hold the numbers of two result dicts together; returns the worst
    difference. Hausdorff distances and wall times are left out."""
    worst = 0.0
    if set(got) != set(want):
        _die(f"{what}: result keys differ: {sorted(set(got) ^ set(want))}")
    for k, w in want.items():
        if not isinstance(w, float) or k.startswith(("hausdorff", "test_time")):
            continue
        g = got[k]
        if math.isnan(w) or math.isinf(w):
            if not (g == w or (math.isnan(g) and math.isnan(w))):
                _die(f"{what}: {k} = {g} on the card, {w} on the CPU")
            continue
        tol = EVAL_SNR_RTOL * abs(w) if k == "snr_db" else EVAL_METRIC_ATOL * max(1.0, abs(w))
        if not abs(g - w) <= tol:
            _die(f"{what}: {k} = {g} on the card, {w} on the CPU (limit {tol:.3e})")
        if k != "snr_db":
            worst = max(worst, abs(g - w) / max(1.0, abs(w)))
    return worst


def _evaluation(torch, smi, tmp):
    """Phase 14. Returns (launches of the three runners, test seconds per
    batch, sweep seconds)."""
    from supernet_tpu_torch import evaluate as E
    from supernet_tpu_torch.calibration import run_calibration

    n_images, batch = 40, 20
    exp = _eval_exp("hippocampus", batch).replace(
        noise_levels=(0.05,), noise_regions=("A",))
    cfg = exp.model
    params = _he_params(torch, cfg)
    ds = _synthetic_ds(cfg, n_images)
    batches = math.ceil(n_images / batch)

    def run(device):
        root = os.path.join(tmp, f"evaluation_{device}")
        e = exp.replace(out_dir=root)
        t0 = time.perf_counter()
        clean = E.run_testing(e, params, ds, out_dir=os.path.join(root, "clean"),
                              images_n=2, device=device)
        t1 = time.perf_counter()
        sweep = E.run_noise_sweep(e, params, ds, device=device)
        t2 = time.perf_counter()
        cal = run_calibration(e, params, ds, out_dir=os.path.join(root, "cal"),
                              device=device)
        return clean, sweep, cal, t1 - t0, t2 - t1, root

    torch.cuda.synchronize()
    _zero_launches()
    clean, sweep, cal, clean_s, sweep_s, root = run("cuda")
    launches = _read_launches()
    want = _expected_launches(cfg, batch, 0, batches * (1 + 2 + 1))
    if launches != want:
        _die(f"evaluation: kernel launches {launches}, expected {want}")
    r_clean, r_sweep, r_cal, _, _, _ = run("cpu")
    worst = _metrics_close("run_testing", clean, r_clean)
    if len(sweep) != 2 or not math.isfinite(sweep[1]["snr_db"]):
        _die(f"run_noise_sweep: {len(sweep)} runs, snr {sweep[-1]['snr_db']}")
    for i, (a, b) in enumerate(zip(sweep, r_sweep)):
        worst = max(worst, _metrics_close(f"run_noise_sweep[{i}]", a, b))
    scalars = (lambda r: {k: v for k, v in r.items() if isinstance(v, float)})
    worst = max(worst, _metrics_close("run_calibration", scalars(cal), scalars(r_cal)))
    for f in ("clean/uncertainty_info.pkl", "cal/calibration.pkl", "cal/Calibration_report.txt",
              "hippocampus/testing/gaussian_0.05/on_anterior/"
              "uncertainty_info_on_anterior_noise_0.05.pkl"):
        if not os.path.isfile(os.path.join(root, f)):
            _die(f"evaluation: {f} was not written")

    _zero_launches()
    mc = E.run_testing(exp, params, ds, out_dir=os.path.join(tmp, "mc"), mc_samples=4)
    if _read_launches()["vdp_conv"] != 0:
        _die("mc_samples: the sampled forward must not reach the VDP kernels")
    if mc["mc_samples"] != 4 or not (math.isfinite(mc["accuracy"]) and
                                     mc["mean_predictive_variance"] > 0 and
                                     math.isfinite(mc["mean_predictive_variance"])):
        _die(f"mc_samples=4: result {mc}")
    print(json.dumps({
        "evaluation": "run_testing, run_noise_sweep (0.05, A), run_calibration",
        "card": smi, "batch": batch, "images": n_images, "launches": launches,
        "worst_metric_diff_vs_cpu": worst, "accuracy": clean["accuracy"],
        "snr_db": sweep[1]["snr_db"], "cpu_snr_db": r_sweep[1]["snr_db"],
        "ece": cal["ece"], "ause": cal["ause"],
        "test_time_per_batch_s": clean["test_time_per_batch_s"],
        "noisy_test_time_per_batch_s": sweep[1]["test_time_per_batch_s"],
        "run_testing_s": clean_s, "noise_sweep_s": sweep_s,
        "mc_mean_predictive_variance": mc["mean_predictive_variance"],
        "mc_test_time_per_batch_s": mc["test_time_per_batch_s"],
    }), flush=True)
    print(f"clean forward with the fetch: {clean['test_time_per_batch_s']:.5f} s per batch "
          f"of {batch}; noise sweep (clean + 1 level x 1 region, {n_images} images, "
          f"artifacts and host metrics included): {sweep_s:.3f} s ({smi})", flush=True)
    return launches, clean["test_time_per_batch_s"], sweep_s


def _eval_cli(torch, tmp):
    """Phase 15. Returns the launches of ``cli study``."""
    from supernet_tpu_torch import cli
    from supernet_tpu_torch.configs import HIPPOCAMPUS

    exp, batch, n = HIPPOCAMPUS, 20, 40
    cfg = exp.model
    grad, fwd = _per_gradient(cfg, batch), _expected_launches(cfg, batch, 0, 1)
    batches = n // batch
    out = os.path.join(tmp, "study")
    torch.cuda.synchronize()
    _zero_launches()
    rc = cli.main(["study", "--config", "hippocampus", "--synthetic", str(n), "--epochs", "1",
                   "--images-n", "2", "--out-dir", out])
    launches = _read_launches()
    sweep_runs = 1 + len(exp.noise_levels) * len(exp.noise_regions)
    want = _summed(
        _scaled(grad, batches), _scaled(fwd, batches),  # train: steps, validation
        _scaled(fwd, batches * (1 + sweep_runs + 1)),  # eval, sweep, calibrate
        _scaled(grad, batches * exp.attack.max_adv_step), _scaled(fwd, batches))  # attack
    if rc != 0 or launches != want:
        _die(f"cli study: rc {rc}, kernel launches {launches}, expected {want} "
             "(the default device must be the card)")
    with open(os.path.join(out, "study.json")) as f:
        summary = json.load(f)
    stages = summary["stages"]
    if list(stages) != ["train", "eval", "sweep", "attack", "calibrate"] or [
            len(st["results"]) for st in stages.values()] != [1, 1, sweep_runs, 1, 1]:
        _die(f"cli study: stages {[(k, len(v['results'])) for k, v in stages.items()]}")
    for stage, key in (("eval", "accuracy"), ("attack", "snr_db"), ("calibrate", "ece")):
        if not math.isfinite(stages[stage]["results"][0][key]):
            _die(f"cli study: {stage} {key} = {stages[stage]['results'][0][key]}")

    _zero_launches()
    rc = cli.main(["saliency", "--config", "hippocampus", "--synthetic", str(n),
                   "--checkpoint", os.path.join(out, "train"), "--images-n", "4",
                   "--out-dir", os.path.join(tmp, "saliency")])
    sal = _read_launches()
    if rc != 0 or sal != grad:
        _die(f"cli saliency: rc {rc}, kernel launches {sal}, expected {grad}")

    _zero_launches()
    adv_out = os.path.join(tmp, "cli_adv")
    rc = cli.main(["train", "--config", "hippocampus", "--synthetic", str(n), "--epochs", "1",
                   "--adversarial-training", "fgsm", "--out-dir", adv_out])
    adv = _read_launches()
    # per step: the attack's gradient, the clean and the adversarial branch
    want_adv = _summed(_scaled(grad, 3 * batches), _scaled(fwd, batches))
    if rc != 0 or adv != want_adv or not os.path.isfile(
            os.path.join(adv_out, "epoch_0", "state.pt")):
        _die(f"cli train --adversarial-training fgsm: rc {rc}, kernel launches {adv}, "
             f"expected {want_adv}")
    print(json.dumps({
        "eval_cli": "study, saliency, train --adversarial-training fgsm",
        "study_launches": launches, "saliency_launches": sal,
        "adversarial_train_launches": adv,
        "study_seconds": {k: v["seconds"] for k, v in stages.items()},
        "study_accuracy": stages["eval"]["results"][0]["accuracy"],
        "study_attack_snr_db": stages["attack"]["results"][0]["snr_db"],
    }), flush=True)
    return launches


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
    check.vmaxpool_bwd("extra", "c64_odd", 2, 9, 7, 64, ties=True)
    check.vmaxpool_bwd("extra", "c130_odd", 3, 13, 15, 130, ties=True)
    check.sigma_bwd("extra", "c130_odd", 3, 17, 19, 130, 3)
    check.sigma_bwd("extra", "c36_odd", 3, 17, 19, 36, 3)
    check.sigma_bwd("extra", "k2", 4, 32, 28, 40, 2)
    for kernel, both in (("vmaxpool_bwd", {"vec4", "scalar"}),
                         ("sigma_bwd", {"vec4", "rows"})):
        if check.paths[kernel] != both:
            _die(f"{kernel}: the shapes reached the paths "
                 f"{sorted(check.paths[kernel])}, expected {sorted(both)}")
    # the attack's case: the image (or the activations) require a gradient,
    # the weights do not
    check.vdp_conv_bwd("extra", "hippocampus_conv_input_frozen", 20, 64, 64, 1, 32, 3,
                       False, True, frozen=True)
    check.vdp_conv_bwd("extra", "brats_conv_input_frozen", 2, 204, 204, 4, 32, 3,
                       False, True, frozen=True)
    check.vdp_conv_bwd("extra", "hippocampus_conv1_frozen", 20, 62, 62, 32, 32, 3,
                       True, True, frozen=True)
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

        # 8-11. the epoch trainer, resume and roll-back, the CLI,
        # augmentation and remat
        with tempfile.TemporaryDirectory() as tmp:
            trainer_launches, final_state, trained_dir, exp, npz, datasets = (
                _epoch_trainer(torch, smi, tmp))
            _resume_and_rollback(torch, tmp, final_state, trained_dir, exp, npz, datasets)
            del final_state
            cli_launches = _cli(torch, tmp)
        _augment_and_remat(torch, smi)

        # 12. the attack's gradient and the adversarial train step
        grad_launches, grad_s = _attack_gradient(torch, "hippocampus", HIPPOCAMPUS, 20)
        _attack_gradient(torch, "brats", BRATS, 2)
        adv_step_s, plain_step_s = _adversarial_train_step(torch, smi)

        # 13-15. adversarial evaluation, the testing protocol and the
        # calibration report against the CPU, the evaluation CLI
        with tempfile.TemporaryDirectory() as tmp:
            adv_launches, pgd_batch_s = _run_adversarial(
                torch, smi, tmp, "hippocampus", 20, 40)
            _, fgsm_batch_s = _run_adversarial(torch, smi, tmp, "brats", 2, 4)
            _, test_batch_s, sweep_s = _evaluation(torch, smi, tmp)
            study_launches = _eval_cli(torch, tmp)

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
    # hippocampus training run of phase 6; trainer_launches: the epoch
    # trainer's run of phase 8; cli_launches: the first cli train of phase 10;
    # attack_gradient_launches: one gradient with respect to a hippocampus
    # batch of 20 (phase 12); adversarial_eval_launches: run_adversarial on 40
    # hippocampus images (phase 13); study_launches: cli study (phase 15).
    # vdp_conv's bound_ms is the CUDA cores' float32 bound; bound_3xtf32_ms
    # that of its tensor-core path.
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
        elif kernel in check.paths:
            # the stream held by a sleep, so no host time counts; summed like ms
            extra = {"device_ms": check.dev[(kernel, "hippocampus")],
                     "brats_device_ms": check.dev[(kernel, "brats")],
                     "paths": sorted(check.paths[kernel])}
        summary.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[kernel],
            "launches_per_step": per_step[kernel],
            "trainer_launches": trainer_launches[kernel],
            "cli_launches": cli_launches[kernel],
            "serving_launches": serve_launches[kernel],
            "attack_gradient_launches": grad_launches[kernel],
            "adversarial_eval_launches": adv_launches[kernel],
            "study_launches": study_launches[kernel],
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
    print(f"evaluation: clean forward with the fetch {test_batch_s:.5f} s per batch of 20, "
          f"one attack gradient {grad_s:.5f} s, PGD 20 steps {pgd_batch_s:.4f} s per "
          f"hippocampus batch of 20, FGSM {fgsm_batch_s:.4f} s per BraTS batch of 2, "
          f"noise sweep (2 runs of 40 images) {sweep_s:.3f} s, adversarial train step "
          f"{1e3 * adv_step_s:.3f} ms beside {1e3 * plain_step_s:.3f} ms plain")
    print(f"card: {smi}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
