#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``supernet_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

or with ``--last-phase 7`` to stop after phase 7: the kernels, serving and
training (the last line is then ``{"ok": true, "last_phase": 7}``), or with
``--last-phase 23`` to stop before phase 24. Phase 24 alone, after the setup:

    python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.norm_phase())'

(the last line is then ``{"ok": true, "phase": 24}``).

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
   shape. Then the bf16 case at every layer shape (and extra k=2, k=1,
   C=130 and odd cases): kernels 1 (with its ReLU mask) and 2 on bf16
   moments must (a) equal, bit for bit, the same kernel on the float32
   upcast of those inputs with the outputs cast to their dtype (the mask
   the float32 ``mu_out > 0``), and (b) lie within the float32 limit of
   the plain version on the same bf16 inputs plus ``BF16_STEP`` of the
   element; each timed (CUDA events, device time) beside its bound at
   2-byte moments. Then kernel 1 in one bf16 pass (precision "default") at
   every layer shape in float32 and bf16 moments: one launch, counted in
   ``bf16_launches``; within 1e-5 of the max of the plain version's one
   pass run in float64 on the same rounded operands (a bf16 output also
   within ``BF16_STEP`` of the element); before the ReLU within
   ``BF16_PRODUCT`` of "highest" and not bit-equal to it; "high" bit-equal
   to "highest"; timed by device time beside its one-pass bound (989
   TFLOP/s) and cuDNN's bf16 conv of mu alone (a yardstick the port never
   calls); the member axis in one pass (K=4 hippocampus members on one
   stride-0 batch, K=2 BraTS members at a split-K layer). Kernel 2 in both
   dtypes: bit for bit the plain
   version's in both forms (NaN where it has NaN), served (mx, so) and
   training (with idx), each timed hot and L2-cold (a buffer of twice the
   L2 written before every call) beside its byte bound, with its plan's
   path, block size and blocks; every model pool takes the vector path,
   the ties, NaN, C=130, C=36 and odd-edge C=40 cases reach both paths in
   each dtype; at every model pool the training form also at every block
   size of ``plan_fwd``'s and through the scalar kernel, summed per step.
   Kernel 1 at every k=3 layer of a BraTS chunk of 20 (the serving cells'
   batch): the forward and the transposed pair within 1e-5 of the max of
   their plain versions in float64, each timed by device time beside its
   3xTF32 bound with the plan's path, tile and K slices, and on the tensor
   cores the prologue's weight planes (forward and flipped) bit for bit
   ``split_weight_planes_plain``'s; the sums on one line.
3. serving, hippocampus at full width: ``InferenceSession`` (batch 20),
   with ``init_params`` weights rescaled to He scale, answers requests of
   20, 7 and 45 images; the kernel launch counters are zeroed just before
   and read just after, and must show every k=3 conv and every pool of
   every chunk, and a split-K reduce for every layer planned with K
   slices; the answers are checked for shape, finiteness, the simplex
   and sigma >= 0, and against the same session on the CPU. Then the first
   request again under ``set_mxu_precision("default")`` (PyTorch's own
   products kept at float32 on the card, as on the CPU): one forward's
   launches per chunk at the one-pass plans, every kernel-1 launch in one
   bf16 pass and within 1e-5 of the max of its plain one pass in float64
   on its own inputs, the answer not bit-equal to the "highest" answer and
   near the CPU session's under "default", measured against how far the
   CPU's two precisions part (``DEFAULT_MAX_SHARE`` of their largest probs
   difference, ``DEFAULT_MEAN_SHARE`` of their mean probs and sigma
   differences: a float32 value a rounding apart lands on another bf16
   operand at every layer, so the whole answers are not compared closer).
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
   At every k=3 conv shape kernel 1 without its window sum, as
   ``VDPConv.backward`` runs its two transposed convolutions
   (``conv_t_pair``: one launch, one ``dgrad_launches``), against PyTorch's
   ``conv_transpose2d`` within 1e-4 and against float64 within 1e-5 of the
   max, timed beside the two cuDNN calls it replaced (deterministic
   flags). At every k=3 conv shape the gradients of ``VDPConv`` (kernel 1
   forward and transposed convolutions, kernel 4) are held against autograd of
   ``vdp_conv_plain``, each within 1e-4 of that gradient's max magnitude:
   the input gradient too at ``conv_input`` (``sigma=None``), which every
   attack and saliency map is, and again with weights that require no
   gradient (the attack's case: the weight gradients are skipped).
   Each is timed with CUDA events beside its plain version.
   Then the bf16 cases at the same shapes, held (a) and (b) as in phase 2:
   kernel 4 on a bf16 g with VDPConv's float32 t (and with a bf16 t), kernel
   1's transposed pair on bf16 cotangents (float32 out), kernel 3 on bf16
   (a 16-byte load holds 8 channels, so C = 36 takes the general kernel),
   and VDPConv's bf16 gradients against its float32 gradients on the
   upcast inputs (cuDNN deterministic) and autograd of the plain version.
   Then the transposed pair in one bf16 pass at every layer shape, in
   float32 and bf16 cotangents, held as phase 2 holds the forward; its
   yardstick cuDNN's bf16 ``conv_transpose2d`` of g1 alone.
6. training, hippocampus at full width, batch 20: 5 steps of
   ``train.make_train_step`` from He-scaled ``init_params`` on a seeded
   batch with integer labels. The launch counters are zeroed just before
   and read just after; per step they must read 10 vdp_conv, 2 pool
   forward, 2 pool backward and 10 sigma-chain backward launches, 9
   transposed-convolution launches of kernel 1 (every k=3 conv but
   conv_input, whose input needs no gradient), and one split-K reduce per
   layer planned with K slices (forward and transposed alike). The same
   steps on the CPU from the same parameters: every step's loss within 1e-4
   relative, the step-1 gradients within 1e-3 of each leaf's max magnitude
   (printed beside the same gradients with cuDNN's transposed convolutions),
   the parameters after the last step within 2 * lr * steps. Prints the
   median step time of steps 2-5 (synchronised) and img/s.
7. training, BraTS at full width, batch 2: 2 steps, the same checks, with
   18 / 4 / 4 / 18 launches per step and 17 transposed.

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
   gradient must read (10, 2, 2, 10) and (18, 4, 4, 18) of kernels 1-4 and
   10 / 18 transposed (a rematerialised config would launch its block
   forwards twice). Held against the CPU with the card's ReLU masks and
   pool taps replayed within ``ATTACK_GRAD_TOL`` of the gradient's max, and
   against the same gradient in float64 (CPU, the same choices) within
   ``ATTACK_F64_TOL``; no sign may differ from the float64 one above
   ``ATTACK_SIGN_FLOOR`` of its max. Printed beside it: the share of pixels
   whose sign differs, each float32 run's distance from float64, the
   card's with cuDNN's transposed convolutions (the path before kernel 1
   took them) and with kernel 1's forward replaced by its plain version.
   Then, at BraTS batch 2, every transposed convolution and filter gradient
   of one backward: each call's inputs recorded and run again through kernel
   1, through cuDNN and in float64, each output's distance and cuDNN's
   kernel names on one JSON line. Then the adversarial train step (FGSM)
   beside the plain one: launches per step one attack gradient and two
   train steps' forwards and backwards, and both step times.
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

16. bf16 activations (``act_dtype``): hippocampus b20 and BraTS b2 served
   at full width in bf16 against the card's float32 answer and the CPU's
   bf16 answer (``BF16_PROBS_ATOL``, ``BF16_AGREE``), and 5 / 2 train steps
   against the float32 steps (``BF16_LOSS_RTOL``; parameters, gradients and
   loss float32); the same in bf16 with the kernels fed float32 through
   casts (``_kernels_fed_float32``, the boundary before the kernels took
   bf16): its answer bit-equal to the bf16 kernels' and its losses within
   ``BF16_LOSS_RTOL``; launches equal to float32's in all three;
   ``profiling``'s serve and train profiles (wall, device time, idle share,
   peak memory, dtype-conversion kernels per request and per step) in the
   three.
17. ``EnsembleSession`` of 3 members at hippocampus b20 against the CPU
   (launches one forward's: the members run member-stacked, phase 19),
   ``cli export`` in process on its default
   device with ``model.pt2`` run on the CPU against the card's session (the
   serving limits), and one request of 45 images enqueued whole against a
   synchronisation per chunk (bit-equal; wall times in turns).

18. the 3-D family at full width (the hippocampus 3-D config: cube 64,
   base 32, depth 3, out 54, batch 4), with the counters of kernels 1-4
   zeroed at the start and read at the end: they must read 0, since the
   family runs cuDNN ``conv3d`` and PyTorch ops and no hand-written kernel.
   ``forward3d`` at batch 4 with volume 0 against the CPU (the serving
   limits); the step-1 loss at batch 4 against the CPU's (``TRAIN_LOSS_RTOL``)
   and the gradients on volume 0 (one volume: the CPU takes seconds per
   volume) against the CPU's with the card's ReLU masks, pool taps and sigma
   clips replayed (``_decisions3d``, ``TRAIN_GRAD_TOL``), under cuDNN's
   deterministic algorithms; three ``make_train_step3d`` steps; the train
   profile of ``profiling.profile_train_step3d`` with remat off and on
   (vols/s from the median of 10 steps, device time, idle share, peak
   memory, cuDNN's share of device time); then in process on the default
   device ``train3d --synthetic 12`` (one epoch, a checkpoint), ``eval3d``,
   ``attack3d`` (PGD, 2 steps: every volume inside the ball and the range
   exactly), ``calibrate3d``, ``saliency3d``, ``predict3d`` on a 100x50x50
   volume (two tiles along D) against the CPU session's tiled answer, and
   ``export --volumetric`` with ``model.pt2`` on the CPU against the card's
   session. Prints the phase's seconds.

19. deep ensembles: kernel 1 (forward with the ReLU, and without the window
   sum as VDPConv's transposed pair) and kernel 4 with a member axis against
   their plain versions (member by member) at every layer shape of a
   hippocampus step with K=4 at batch 20 and a BraTS step with K=2 at batch
   2, within the single-member checks' limits, timed (CUDA events and device
   time) against K single launches; the stride-0 input (one batch for every
   member) bit-equal to the same batch copied per member; the same member
   launches on bf16 held (a) and (b) as in phase 2, with their device time. Then, under
   cuDNN's deterministic algorithms, ``make_ensemble_train_step`` at full
   hippocampus width (K=4, batch 20, He-scaled members seeded SEED + k): the
   step-1 loss and gradients of the member-stacked loss against each
   member's single-model ones on the card with the stacked pass's ReLU
   masks, pool taps and clips replayed (``TRAIN_GRAD_TOL``), and 3 steps in
   vmap and in unroll against the single-model steps of every member
   (``TRAIN_LOSS_RTOL``, parameters within 2 * lr * steps), the counters per
   vmap step equal to one single-model step's (10 / 2 / 2 / 10, 9
   transposed, split-K reduces planned for K members), unroll 4x a single
   step's; BraTS K=2 at batch 2, one vmap step likewise;
   ``make_ensemble_train_step3d`` in vmap at the hippocampus 3-D width, K=2,
   2 steps, against ``make_train_step3d`` per member, kernels 1-4 at 0
   launches. A 3-member ``EnsembleSession`` chunk launches one forward's
   kernels and its mixture matches the members' own sessions mixed;
   ``cli train --ensemble 3 --ensemble-mode vmap`` (2 epochs of 60
   synthetic images: the launches of 6 steps and 6 validation batches),
   then ``cli eval`` of its three member directories (the launches of one
   member's eval). Last, ``profiling.profile_ensemble_step`` at hippocampus
   K=4 batch 20 in vmap, unroll and sequential (wall, device time, idle
   share, peak memory per member-step) and a sequential member's start-up:
   the constants of ``ensemble.choose_ensemble_mode``. Prints the phase's
   seconds and its parts'.

20. the glue fold on the card: hippocampus (batch 20) and BraTS (batch
   2) at full width from He-scaled parameters, the loss, probabilities,
   sigma and every gradient of one batch with the glue fold
   (``set_glue_fold("fold")``) against the explicit glue on the card, the
   explicit pass's ReLU masks, pool taps and clips replayed into the folded
   one, within the tolerances of ``tests/test_glue_fold.py`` (``FOLD_FWD_TOL``,
   ``FOLD_GRAD_TOL``); one train step in each mode with the counters: the
   fold's launches kernels 1 and 4 only at the convs it does not fold
   (hippocampus 6 of 10 k=3 convs per forward, BraTS 9 of 18); a K=2
   member-stacked step likewise; the card against the CPU under the fold at
   the tiny config. Then the 3-D family at the phase-18 width: the glue
   fold against the default (loss, probabilities, gradients, choices
   replayed), and the train profile of each mode (wall ms, device ms, idle
   share, peak memory) with the modes in turns; kernels 1-4 at 0 launches. Prints the phase's
   seconds and its parts'.
21. ``cli profile --by-layer`` in process: hippocampus batch 20 and
   ``--config unet3d --batch 4`` (K = 8 steps per call, bf16). Each writes
   ``exact_join.json``; the launches of kernels 1-4 joined from the trace
   equal the counters over the traced calls and the per-step counts times
   the steps, and no kernel of the traced calls lost its record; the
   joined classes and the unjoined row sum to the device busy time within
   1%; the class table, the unjoined row and the records lost in the
   settling call are printed.

22. parallelism on the card: a one-rank NCCL process group on cuda:0
   (NCCL refuses two ranks on one card: "Duplicate GPU detected"; the
   multi-rank worlds are proven on the CPU in gloo by the tests), its 1-D
   mesh and a (1, 1) (data, space) mesh. Under cuDNN's deterministic
   algorithms: hippocampus b20, 3 steps, through ``make_sharded_train_step``,
   ``make_spatial_train_step`` and ``make_hybrid_train_step``, and BraTS b2,
   2 steps, through ``make_sharded_train_step``, each counted (per step
   (10, 2, 2, 10) with 9 transposed / (18, 4, 4, 18) with 17, the split-K
   reduces as planned) and again with the choices of ``make_train_step``'s
   run on the card replayed (``_decisions``), both held against that run
   (``TRAIN_LOSS_RTOL``, parameters within 2 * lr * steps); at the phase-18
   width (cube 64, batch 4) ``make_dp_train_step3d`` and
   ``make_spatial_train_step3d``, 2 steps, against ``make_train_step3d``
   (``_decisions3d``), kernels 1-4 at 0 launches. Then in process: one epoch
   of ``Trainer(mesh=)`` on 200 synthetic images (launches of 10 steps and 2
   validation batches; history and parameters equal to the meshless epoch's
   bit for bit), ``cli train --data-parallel``, ``train3d --spatial-shard``
   and ``eval --data-parallel`` (equal to ``eval``), ``InferenceSession(
   mesh=)`` answering 20, 7 and 45 images and ``EnsembleSession(mesh=)`` of
   3 members (equal to the meshless sessions), ``EnsembleTrainer(mesh=)`` at
   K=3 (equal to the meshless trainer). Under the decoder glue fold: the
   spatial and hybrid steps at hippocampus b20 and BraTS b2, 2 steps each,
   counted (kernels 1 and 4 at the unfolded convs only: (6, 2, 2, 6) with 5
   transposed / (9, 4, 4, 9) with 8), then step 1 with ``make_train_step``'s
   choices under the fold replayed; both held against that run
   (``TRAIN_LOSS_RTOL``, parameters within 2 * lr per step), the replayed
   step's gradients within ``TRAIN_GRAD_TOL``, the weight where the
   parameters part most named with its gradient at each step. Prints the
   phase's seconds and its parts'.

23. the benchmark: ``cli.main(["bench"])`` in process at the bench's
   defaults but ``SUPERNET_BENCH_ITERS=40`` (bf16 activations, TF32 in
   PyTorch's own products, every section on), each ``_bench_model`` call
   counted. The line must parse, name the card and its peaks (989 TFLOP/s
   and 3350 GB/s on an H100 80GB HBM3), give positive rates in the
   headline, ``best``, ``brats``, ``unet3d``, ``ensemble_train`` and
   ``inference``, an MFU in (0, 1] and ``hbm_utilization_min`` in (0, 1.05],
   a measured ``vs_baseline``, and no section error (a sweep's
   out-of-memory entry is printed on a line of its own). The line's
   precision is "default", so every kernel-1 launch of the run, forward
   and transposed, must be one bf16 pass (``bf16_launches``). The
   hippocampus b20 headline launches one train step's kernels per step (at
   the one-pass plans); the naive baseline launches none. The kernels at
   the line's 2-D shapes: the
   kernel forward (one forward's launches) against the naive forward at
   hippocampus b20 and b256 and BraTS b2, b20 and b128 (He scale, TF32
   off) within the serving limits, and a train step's step-1 gradient at
   hippocampus b64 (one step's launches) against the CPU's with the card's
   choices replayed (``TRAIN_GRAD_TOL``). The same in bf16, which the
   bench runs by default: each forward bit-equal to the forward with the
   kernels fed float32 through casts and within ``BF16_PROBS_ATOL`` /
   ``BF16_AGREE`` of the naive one, and the b64 gradient bit-equal to the
   gradient with the kernels fed float32, its loss within
   ``BF16_LOSS_RTOL`` of float32's. These run at "highest"; then at the
   bench's "default" (TF32 off): the same forwards in both dtypes and the
   b64 gradient in bf16 and float32, counted at the one-pass plans, every
   kernel-1 call, forward and transposed, within 1e-5 of the max of its
   plain one pass in float64 on its own inputs, each answer not bit-equal
   to "highest", the bf16 ones bit-equal to the kernels fed float32.
   Prints the bench line and the phase's seconds.
24. the norm kernel pair (``ops/kernels/vdp_norm.py``) at every norm shape
   of one Swin UNETR forward and one MedNeXt forward at their published
   sizes (recorded on the meta device: 26 InstanceNorms and 25 LayerNorms
   at batch 1; 62 InstanceNorms with a gamma and beta per channel at batch
   2): forward and backward, gamma
   and beta gradients included, within ``NORM_TOL`` of the plain version run
   in float64 on the same float32 inputs, each timed by device time beside
   its byte bounds (the kernels' passes, and each input read once and each
   output written once) and the ratio to each, the plain version and
   autograd of the closed form (the path before the kernels). One line per
   shape, then the sums over one step's calls of each model and the phase's
   seconds.

In phases 6-15 cuDNN runs its deterministic algorithms, and in 6-7 and 12
the CPU reference of the gradients replays the card's ReLU masks and pool
taps (``_decisions``), so that rounding ties do not decide the comparison.

The last two lines of standard output are the kernels summary
``{"kernels": [...]}`` (all four kernels, with their launches in the
hippocampus training run, the epoch trainer's run, the CLI's run, one
attack gradient, the adversarial evaluation, the study, phase 18, one K=4
ensemble step and one ensemble session chunk, one step under the glue fold,
one step of ``cli profile``'s trace, one step of each sharded step of
phase 22 and of the spatial step under the fold, one step of the bench's
headline and its naive baseline run, errors, times and bounds, the bf16
case's times, plain times and bounds at 2-byte moments (``bf16_*``,
``brats_bf16_*``), for kernels 1 and 4 the member-axis times beside K
single launches, in float32 and bf16, and for kernel 1 the one-bf16-pass
sums ``[brats_][bf16_][dgrad_]default_*`` and the bench's one-pass launches
per step) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
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
# with the card's ReLU and pool choices replayed, relative to its max, and
# the card's against the same gradient in float64 (CPU, the same choices).
# With the backward's transposed convolutions in cuDNN the card read 1.7e-3
# from float64 at BraTS batch 2 on an H100 (the loss divides by sigma, so a
# relative error of sigma passes on in full); through kernel 1 every
# convolution of the input gradient is at float32 accuracy, as on the CPU
# (2e-6 from float64). The phase prints both paths and each call's distance.
ATTACK_GRAD_TOL = 1e-4
ATTACK_F64_TOL = 1e-4
# a replayed sigma clip may differ from the reference's own only where sigma
# lies this close to the bound, relative (rounding gathered over 18 layers)
CLIP_TIE_RTOL = 1e-3
# below this share of the gradient's max (twice the limit above) a sign may
# be decided by rounding
ATTACK_SIGN_FLOOR = 2e-4
# evaluation metrics (accuracy, Dice, rates, calibration scalars), card
# against CPU on the same images and draws: a few argmax flips among the
# 116,640 pixels of 40 hippocampus images
EVAL_METRIC_ATOL = 5e-3
EVAL_SNR_RTOL = 1e-4
# bf16 activations against float32 (the limits of the JAX package's
# tests/test_moments.py:test_act_dtype_bfloat16_mode): probabilities within
# 0.03, the per-pixel class the same on more than 99% of the pixels; the
# card's bf16 against the CPU's bf16 likewise (a float32 kernel output a
# rounding apart lands in another bf16 value)
BF16_PROBS_ATOL = 3e-2
BF16_AGREE = 0.99
# a train step's loss in bf16 against float32: bf16 rounds at 2^-9 (2e-3)
# relative and the loss is a mean over 58,320 (hippocampus b20) or 69,192
# (BraTS b2) pixels, so it moves by far less than one rounding; 1e-2 is five
BF16_LOSS_RTOL = 1e-2
# a bf16 case of phases 2, 5 and 19 against its plain version on the same
# bf16 inputs: the float32 limit of the kernel (VDP_TOL, SIGMA_BWD_TOL,
# VDP_BWD_TOL) of the plain output's max, plus, for a bf16 output, one bf16
# step of the element. The kernel and the plain version each round a
# float32 value to bf16 once (2^-8 of the element each), so two float32
# values within the limit land at most one step (2^-7) apart.
BF16_STEP = 2.0 ** -7
# kernel 1 in one bf16 pass (precision "default") against "highest", element
# by element: a bf16 operand lies within 2^-8 of its float32 value (round to
# nearest, 8 significant bits), so a product of two lies within 2^-7
# (+ 2^-16) of the exact one and a sum within that share of the sum of its
# terms' magnitudes (plus VDP_TOL of the max for the float32 orders, and
# BF16_STEP of the element for a bf16 output)
BF16_PRODUCT = 2.0 ** -7 * (1 + 2.0 ** -9)
# a served answer under "default" (one bf16 pass), card against CPU, as a
# share of how far the CPU's own "default" and "highest" answers part (the
# card's "highest" answer lies about 1.0 of it away): the largest probs
# difference, and the mean differences of probs and sigma. On an H100, four
# requests each read 0.36-0.45 / 0.13-0.16 / 0.16-0.19 of it at
# hippocampus and 0.50-0.59 / 0.46-0.47 / 0.59-0.62 at BraTS, where a
# one-ulp change of the input moves the CPU's own answer about as far
# (PERF.md, section 6)
DEFAULT_MAX_SHARE = 0.75
DEFAULT_MEAN_SHARE = 0.75
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


def _he_params(torch, cfg, seed=SEED):
    """``init_params`` on the CPU from SEED with each w_mu rescaled to He
    scale, std sqrt(2 / fan_in). At the raw init (std 0.088 in every layer)
    the activations grow about 6x per BraTS layer: the logits reach 7.6e4,
    and on the CPU the JAX package and the port already differ by 3.6e-2 in
    probs, so no float32 comparison of two implementations is well-posed
    there. At He scale the logits stay below 10 in both configs."""
    from supernet_tpu_torch.models import init_params

    params = init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    for p in params.values():
        k, _, cin, _ = p["w_mu"].shape
        p["w_mu"] *= math.sqrt(2.0 / (k * k * cin)) / p["w_mu"].std()
    return params


def _sms() -> int:
    """The card's SM count, what the planners fill at launch."""
    from supernet_tpu_torch.ops.kernels import _lib

    return _lib.sm_count("cuda")


def _split_layers(cfg, batch, members=1, skip=(), precision="highest") -> int:
    """The k=3 convs of one forward at ``batch`` (of ``members`` ensemble
    members in one launch) that vdp_conv's planner cuts into K slices on this
    card at ``precision``: each launches the split-K reduce once. Layers
    named in ``skip`` (the glue fold's, ``_folded_layers``) do not run
    kernel 1."""
    from supernet_tpu_torch.ops.kernels.vdp_conv import plan
    from supernet_tpu_torch.profiling import layer_shapes

    return sum(plan(batch, h, w, cin, cout, 3, members, _sms(), precision).splits > 1
               for name, (_, h, w, cin), cout in layer_shapes(cfg)[0] if name not in skip)


def _dgrad_split_layers(cfg, batch, with_input: bool, members=1, skip=(),
                        precision="highest") -> int:
    """The k=3 convs whose input gradient (kernel 1 without the window sum,
    a conv of [b, h+2, w+2, Cout] into Cin channels) the planner cuts into K
    slices at ``precision``; conv_input's counts only ``with_input`` (a
    gradient with respect to the image); layers in ``skip`` not at all."""
    from supernet_tpu_torch.ops.kernels.vdp_conv import plan
    from supernet_tpu_torch.profiling import layer_shapes

    return sum(plan(batch, h + 2, w + 2, cout, cin, 3, members, _sms(), precision).splits > 1
               for name, (_, h, w, cin), cout in layer_shapes(cfg)[0]
               if (with_input or name != "conv_input") and name not in skip)


def _folded_layers(cfg) -> frozenset:
    """The convs that ``set_glue_fold("fold")`` runs as ``vglue_conv_relu``
    (PyTorch's convs, not kernel 1): both convs of every decoder block and,
    where the config pre-pads its bottleneck, that block's first conv."""
    names = {f"up{j}_conv{i}" for j in range(1, cfg.depth) for i in (1, 2)}
    if cfg.bottleneck_pre_pad is not None:
        names.add(f"conv{2 * (cfg.depth - 1)}")
    return frozenset(names)


class KernelCheck:
    """Holds each kernel against its plain version and keeps the worst
    error and the summed times per kernel and config."""

    def __init__(self, torch):
        self.torch = torch
        self.gen = torch.Generator(device="cuda").manual_seed(SEED)
        self.worst = {}
        self.ms = {}
        # (config) -> summed device, cuDNN and 3xTF32 bound ms; (config,
        # "bf16") -> device ms, 0 and the 2xTF32 bound
        self.vdp = {}
        self.paths = {}  # kernel 3 or 4 -> the planner's paths its shapes took
        self.dev = {}  # (kernel 2, 3 or 4, config) -> summed device ms
        # (kernel 2 or its bf16 case, config) -> its other times, summed
        self.pool_fwd = {}
        # (config, dtype, kernel 2's path and block size) -> summed hot and
        # cold device ms of its training form
        self.blocks = {}
        # (config) -> the dgrad's summed device ms, cuDNN's conv_transpose2d
        # pair's and the dgrad's 3xTF32 bound; (config, "bf16") -> device ms,
        # 0 and the 2xTF32 bound
        self.dgrad_ms = {}
        # kernel 1 in one bf16 pass: (config, "float32" or "bf16", "forward"
        # or "dgrad") -> summed device ms, one-pass bound ms, cuDNN's bf16
        # yardstick ms, and the worst error against float64; the seconds its
        # cases took
        self.default = {}
        self.default_s = 0.0
        # kernel 1 at a serving chunk's layers: (config) -> summed forward
        # device ms and 3xTF32 bound, transposed pair device ms and bound
        self.chunk = {}

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
        plan = V.plan(b, h, w, cin, cout, k, 1, _sms())
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

    def vmaxpool(self, config, layer, b, h, w, c, ties=False, nan=False, bf16=False):
        """Kernel 2 on float32 or bf16 moments: mx, so and idx bit for bit
        the plain version's (NaN where it has NaN) in both forms, and on
        bf16 the float32 kernel's on the upcast inputs. Timed in both forms,
        served (mx, so) and training (with idx), each hot and L2-cold beside
        its byte bound (2 or 3 outputs)."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import pool as P
        from supernet_tpu_torch.profiling import cold_device_ms, device_ms

        kernel = "vmaxpool_bf16" if bf16 else "vmaxpool"
        what = f"{kernel} {config}/{layer}"
        mu = self._randn(b, h, w, c)
        if ties:
            mu = torch.round(3.0 * mu)
        if nan:
            mu.view(-1)[::7] = float("nan")
        sigma = self._randn(b, h, w, c).abs()
        if bf16:
            mu, sigma = mu.to(torch.bfloat16), sigma.to(torch.bfloat16)
        plan = P.plan_fwd(b, h, w, c, mu.element_size(), _sms())
        if config != "extra" and plan.path != "vec":
            _die(f"{what}: a model pool takes the {plan.path} path")
        with torch.inference_mode():
            got = P.vmaxpool(mu, sigma, return_idx=True)
            served = P.vmaxpool(mu, sigma)
            want = P.vmaxpool_plain(mu, sigma)
            torch.cuda.synchronize()
            for name, g, r in zip(("mx", "so", "idx", "served mx", "served so"),
                                  got + served, want + want[:2]):
                if g.dtype != mu.dtype or not _same_bits(torch, g, r):
                    _die(f"{what}: {name} is not bit-exact with the plain version")
            if bf16:
                ref = P.vmaxpool(mu.float(), sigma.float(), return_idx=True)
                for name, g, r in zip(("mx", "so", "idx"), got, ref):
                    if not _same_bits(torch, g, r.to(g.dtype)):
                        _die(f"{what}: {name} on bf16 inputs is not the float32 "
                             f"kernel's output on the upcast inputs, cast to bf16")
            ms = _time_ms(torch, lambda: P.vmaxpool(mu, sigma))
            plain_ms = _time_ms(torch, lambda: P.vmaxpool_plain(mu, sigma))
            times = {
                "device_ms": device_ms(lambda: P.vmaxpool(mu, sigma)),
                "cold_device_ms": cold_device_ms(lambda: P.vmaxpool(mu, sigma)),
                "train_device_ms": device_ms(lambda: P.vmaxpool(mu, sigma, True)),
                "train_cold_device_ms": cold_device_ms(lambda: P.vmaxpool(mu, sigma, True)),
            }
        n_in, n_out, size = mu.numel(), got[0].numel(), mu.element_size()
        times["train_bound_ms"] = _bound(size * (2 * n_in + 3 * n_out), 0)[0]
        self.paths.setdefault(kernel, set()).add(plan.path)
        self.dev[(kernel, config)] = self.dev.get((kernel, config), 0.0) + times["device_ms"]
        sums = self.pool_fwd.setdefault((kernel, config), dict.fromkeys(times, 0.0))
        for k, v in times.items():
            sums[k] += v
        self._record(kernel, config, 0.0, 0.0, ms, plain_ms,
                     _bound(size * (2 * n_in + 2 * n_out), 0), {
            "layer": layer, "shape": [b, h, w, c], "ties": ties, "nan": nan,
            "dtype": str(mu.dtype).replace("torch.", ""), "path": plan.path,
            "threads": plan.threads, "blocks": plan.blocks, **times,
            **({"equal_to_float32_on_upcast": True} if bf16 else {}),
        })

    def vmaxpool_blocks(self, config, layer, b, h, w, c):
        """Kernel 2's training form at one layer shape in float32 and bf16:
        the vector path in blocks of 256, 128, 64 and 32 threads (the plan
        picks from ``FWD_THREADS``) and the scalar kernel (one thread per
        output element, the only design before the vector path), each
        bit-exact with the plain version, hot and L2-cold device time. Sums
        go to ``self.blocks``."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import pool as P
        from supernet_tpu_torch.profiling import cold_device_ms, device_ms

        for dt in (torch.float32, torch.bfloat16):
            mu = self._randn(b, h, w, c).to(dt)
            sigma = self._randn(b, h, w, c).abs().to(dt)
            plan = P.plan_fwd(b, h, w, c, mu.element_size(), _sms())
            n_out = b * ((h + 1) // 2) * ((w + 1) // 2) * c
            variants = {f"vec{t}": plan._replace(threads=t, blocks=-(-plan.items // t))
                        for t in (256, 128, 64, 32)}
            variants["scalar"] = P.FwdPlan("scalar", 1, n_out, P.THREADS,
                                           -(-n_out // P.THREADS))
            dtype = str(dt).replace("torch.", "")
            line = {"kernel": "vmaxpool_blocks", "config": config, "layer": layer,
                    "shape": [b, h, w, c], "dtype": dtype, "plan_threads": plan.threads}
            with torch.inference_mode():
                want = P.vmaxpool_plain(mu, sigma)
                for name, p in variants.items():
                    got = P._launch(mu, sigma, True, p)
                    torch.cuda.synchronize()
                    if not all(_same_bits(torch, g, r) for g, r in zip(got, want)):
                        _die(f"vmaxpool {config}/{layer} {dtype} {name}: not bit-exact")
                    fn = lambda p=p: P._launch(mu, sigma, True, p)
                    hot, cold = device_ms(fn), cold_device_ms(fn)
                    line[name] = {"blocks": -(-p.items // p.threads),
                                  "device_ms": hot, "cold_device_ms": cold}
                    acc = self.blocks.setdefault((config, dtype, name), [0.0, 0.0])
                    acc[0] += hot
                    acc[1] += cold
            print(json.dumps(line), flush=True)

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
        plan = S.plan(b, hp, wp, c, k, 1, _sms())
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

    def dgrad(self, config, layer, b, h, w, cin, cout, with_sigma):
        """Kernel 1 without the window sum as VDPConv's backward runs it:
        ``conv_t_pair(g1, g2, w_mu)`` for a k=3 conv with input [b,h,w,cin]
        (one launch for both transposed convolutions; ``g2`` None at
        conv_input, the attack's case), against PyTorch's ``conv_transpose2d``
        (``_conv_t``, the plain version) within VDP_TOL and against the padded,
        flipped form in float64 within VDP_F64_TOL of the max. Timed beside
        the two cuDNN calls it replaced, under the deterministic flags that
        training runs them with; their own distance from float64 printed."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V
        from supernet_tpu_torch.profiling import TF32_FLOPS_PER_S, device_ms

        g1 = self._randn(b, h - 2, w - 2, cout)
        g2 = self._randn(b, h - 2, w - 2, cout) if with_sigma else None
        w_mu = 0.1 * self._randn(3, 3, cin, cout)
        plan = V.plan(b, h + 2, w + 2, cout, cin, 3, 1, _sms())

        def cudnn():
            return V._conv_t(g1, w_mu), None if g2 is None else V._conv_t(g2, w_mu * w_mu)

        with torch.inference_mode():
            _zero_launches()
            got = V.conv_t_pair(g1, g2, w_mu)
            torch.cuda.synchronize()
            launches = _read_launches()
            want_l = {k: 0 for k in launches}
            want_l.update(vdp_conv_dgrad=1, vdp_conv_dgrad_reduce=int(plan.splits > 1))
            if launches != want_l:
                _die(f"vdp_conv dgrad {config}/{layer}: launches {launches}")
            want = cudnn()
            want64 = V.conv_t_pair_plain(g1.double(), None if g2 is None else g2.double(),
                                         w_mu.double())
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True, allow_tf32=False):
                det = cudnn()
                abs_err = rel_err = f64_err = cudnn64 = 0.0
                for x, r, r64, d in zip(got, want, want64, det):
                    if r is None:
                        continue
                    e = float((x - r).abs().max())
                    abs_err = max(abs_err, e)
                    rel_err = max(rel_err, e / float(r.abs().max()))
                    f64_err = max(f64_err, _max_rel(torch, x.double(), r64))
                    cudnn64 = max(cudnn64, _max_rel(torch, d.double(), r64))
                if not rel_err <= VDP_TOL:
                    _die(f"vdp_conv dgrad {config}/{layer} disagrees with conv_transpose2d: "
                         f"relative error {rel_err:.3e} > {VDP_TOL}")
                if not f64_err <= VDP_F64_TOL:
                    _die(f"vdp_conv dgrad {config}/{layer} ({plan.path}) is not at float32 "
                         f"accuracy: {f64_err:.3e} of the max from float64 > {VDP_F64_TOL}")
                del want64
                ms = _time_ms(torch, lambda: V.conv_t_pair(g1, g2, w_mu))
                plain_ms = _time_ms(torch, lambda: V.conv_t_pair_plain(g1, g2, w_mu))
                dev_ms = device_ms(lambda: V.conv_t_pair(g1, g2, w_mu))
                cudnn_ms = device_ms(cudnn)
        n = 2 if with_sigma else 1
        m = b * h * w
        nbytes = 4 * (n * g1.numel() + 9 * cin * cout + n * m * cin)
        flops = n * 2 * 9 * cin * cout * m
        bound = _bound(nbytes, flops)
        acc = self.dgrad_ms.setdefault(config, [0.0, 0.0, 0.0])
        acc[0] += dev_ms
        acc[1] += cudnn_ms
        acc[2] += max(bound[1], 1e3 * 3 * flops / TF32_FLOPS_PER_S)
        self._record("vdp_conv_dgrad", config, abs_err, rel_err, ms, plain_ms, bound, {
            "layer": layer, "shape": [b, h, w, cin, cout, 3], "sigma": with_sigma,
            "path": plan.path, "splits": plan.splits, "blocks": plan.blocks,
            "f64_max_rel_err": f64_err, "cudnn_deterministic_f64_max_rel_err": cudnn64,
            "device_ms": dev_ms, "cudnn_conv_transpose_ms": cudnn_ms,
        })

    # ---- bf16 cases: (a) the kernel on bf16 inputs against the same kernel
    # on their float32 upcast, outputs cast (_equal_on_upcast); (b) against
    # the plain version on the same bf16 inputs (_bf16_errors)

    def vdp_conv_bf16(self, config, layer, b, h, w, cin, cout, k, has_sigma, relu):
        """Kernel 1 with the window sum on bf16 moments, with the ReLU's
        mask where ``relu``: bf16 mu_out and sig_out, float32 win, and the
        mask equal to the float32 call's ``mu_out > 0``."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V
        from supernet_tpu_torch.profiling import device_ms, vdp_conv_bounds

        bf = torch.bfloat16
        what = f"vdp_conv bf16 {config}/{layer}"
        mu = self._randn(b, h, w, cin).to(bf)
        sigma = (0.05 * self._randn(b, h, w, cin).abs()).to(bf) if has_sigma else None
        w_mu = 0.1 * self._randn(k, k, cin, cout)
        w_sigma = -4.0 + self._randn(cout)
        up = (mu.float(), None if sigma is None else sigma.float())
        plan = V.plan(b, h, w, cin, cout, k, 1, _sms())
        with torch.inference_mode():
            got = V.vdp_conv(mu, sigma, w_mu, w_sigma, relu, relu_mask=relu)
            ref = V.vdp_conv(*up, w_mu, w_sigma, relu, relu_mask=relu)
            want = V.vdp_conv_plain(mu, sigma, w_mu, w_sigma, relu)
            torch.cuda.synchronize()
            _equal_on_upcast(torch, what, got, ref)
            if relu and not torch.equal(got[3], ref[0] > 0):
                _die(f"{what}: the ReLU mask is not the float32 mu_out > 0")
            keep = None
            flips = 0
            if relu:
                tie = (got[0] > 0) != (want[0] > 0)
                flips = int(tie.sum())
                if flips and float(torch.maximum(got[0].float().abs(), want[0].float().abs())[tie]
                                   .max()) > VDP_TOL * float(want[0].float().abs().max()):
                    _die(f"{what}: a ReLU mask differs away from mu = 0")
                keep = [None, ~tie, None]
            abs_err, rel_err = _bf16_errors(torch, what, got[:3], want, VDP_TOL, keep)
            ms = _time_ms(torch, lambda: V.vdp_conv(mu, sigma, w_mu, w_sigma, relu))
            plain_ms = _time_ms(
                torch, lambda: V.vdp_conv_plain(mu, sigma, w_mu, w_sigma, relu))
            dev_ms = device_ms(lambda: V.vdp_conv(mu, sigma, w_mu, w_sigma, relu))
        bounds = vdp_conv_bounds(b, h, w, cin, cout, k, has_sigma, itemsize=2)
        acc = self.vdp.setdefault((config, "bf16"), [0.0, 0.0, 0.0])
        acc[0] += dev_ms
        acc[2] += bounds["bound_2xtf32_ms"]
        self._record("vdp_conv_bf16", config, abs_err, rel_err, ms, plain_ms,
                     (bounds["bound_ms"], bounds["bytes_ms"], bounds["f32_ms"]), {
            "layer": layer, "shape": [b, h, w, cin, cout, k], "dtype": "bfloat16",
            "sigma": has_sigma, "relu": relu, "relu_ties": flips,
            "path": plan.path, "splits": plan.splits, "equal_to_float32_on_upcast": True,
            "device_ms": dev_ms, "bound_2xtf32_ms": bounds["bound_2xtf32_ms"],
        })

    def vmaxpool_bwd_bf16(self, config, layer, b, h, w, c, ties=False):
        """Kernel 3 on bf16 idx and gradients: bf16 out, bit for bit the
        float32 kernel's on the upcast inputs and the plain version's."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import pool as P
        from supernet_tpu_torch.profiling import device_ms

        bf = torch.bfloat16
        what = f"vmaxpool_bwd bf16 {config}/{layer}"
        mu = self._randn(b, h, w, c)
        if ties:
            mu = torch.round(3.0 * mu)
        with torch.inference_mode():
            _, _, idx = P.vmaxpool(mu.to(bf), self._randn(b, h, w, c).abs().to(bf),
                                   return_idx=True)
            g_mu = self._randn(*idx.shape).to(bf)
            g_sigma = self._randn(*idx.shape).to(bf)
            got = P.vmaxpool_bwd(idx, g_mu, g_sigma, h, w)
            ref = P.vmaxpool_bwd(idx.float(), g_mu.float(), g_sigma.float(), h, w)
            want = P.vmaxpool_bwd_plain(idx, g_mu, g_sigma, h, w)
            torch.cuda.synchronize()
            _equal_on_upcast(torch, what, got, ref)
            if not all(g.dtype == bf and torch.equal(g, r) for g, r in zip(got, want)):
                _die(f"{what}: not bit-exact with the plain version")
            ms = _time_ms(torch, lambda: P.vmaxpool_bwd(idx, g_mu, g_sigma, h, w))
            plain_ms = _time_ms(
                torch, lambda: P.vmaxpool_bwd_plain(idx, g_mu, g_sigma, h, w))
            dev_ms = device_ms(lambda: P.vmaxpool_bwd(idx, g_mu, g_sigma, h, w))
        plan = P.plan_bwd(b, h, w, c, 2)
        self._seen("vmaxpool_bwd_bf16", config, plan.path, dev_ms)
        self._record("vmaxpool_bwd_bf16", config, 0.0, 0.0, ms, plain_ms,
                     _bound(2 * (3 * idx.numel() + 2 * b * h * w * c), 0), {
            "layer": layer, "shape": [b, h, w, c], "ties": ties, "dtype": "bfloat16",
            "path": plan.path, "blocks": plan.blocks, "device_ms": dev_ms,
            "equal_to_float32_on_upcast": True,
        })

    def sigma_bwd_bf16(self, config, layer, b, hp, wp, c, k, t_bf16=False):
        """Kernel 4 on a bf16 cotangent g with a float32 t (VDPConv's case:
        t is kernel 1's float32 win, so u stays float32), or with ``t_bf16``
        both in bf16 (u bf16). dsw is float32 either way; the same bits in
        two runs."""
        torch = self.torch
        import torch.nn.functional as F

        from supernet_tpu_torch.ops.kernels import sigma_bwd as S
        from supernet_tpu_torch.profiling import device_ms

        bf = torch.bfloat16
        what = f"sigma_bwd bf16 {config}/{layer}" + (" (t bf16)" if t_bf16 else "")
        g = self._randn(b, hp, wp, c).to(bf)
        t = 10.0 * self._randn(b, hp, wp).abs()
        if t_bf16:
            t = t.to(bf)
        s_w = F.softplus(self._randn(c) - 4.0)
        with torch.inference_mode():
            got = S.winsum_spread_bwd(g, t, s_w, k)
            again = S.winsum_spread_bwd(g, t, s_w, k)
            ref = S.winsum_spread_bwd(g.float(), t.float(), s_w, k)
            want = S.winsum_spread_bwd_plain(g, t, s_w, k)
            torch.cuda.synchronize()
            if got[0].dtype != t.dtype or got[1].dtype != torch.float32:
                _die(f"{what}: u {got[0].dtype}, dsw {got[1].dtype}")
            if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                _die(f"{what}: two runs on the same input differ")
            _equal_on_upcast(torch, what, got, ref)
            abs_err, rel_err = _bf16_errors(torch, what, got, want, SIGMA_BWD_TOL)
            ms = _time_ms(torch, lambda: S.winsum_spread_bwd(g, t, s_w, k))
            plain_ms = _time_ms(torch, lambda: S.winsum_spread_bwd_plain(g, t, s_w, k))
            dev_ms = device_ms(lambda: S.winsum_spread_bwd(g, t, s_w, k))
        plan = S.plan(b, hp, wp, c, k, 1, _sms())
        name = "sigma_bwd_bf16" + ("_t" if t_bf16 else "")
        self._seen(name, config, plan.path, dev_ms)
        h, w = hp + k - 1, wp + k - 1
        nbytes = (2 * g.numel() + t.element_size() * (t.numel() + b * h * w)
                  + 4 * 2 * c)
        flops = 4 * g.numel() + k * k * b * h * w
        self._record(name, config, abs_err, rel_err, ms, plain_ms,
                     _bound(nbytes, flops), {
            "layer": layer, "shape": [b, hp, wp, c, k], "dtype": "bfloat16",
            "t_dtype": str(t.dtype), "path": plan.path, "blocks": plan.blocks,
            "same_bits_in_two_runs": True, "equal_to_float32_on_upcast": True,
            "device_ms": dev_ms,
        })

    def dgrad_bf16(self, config, layer, b, h, w, cin, cout, with_sigma):
        """Kernel 1 without the window sum on bf16 cotangents, as VDPConv's
        backward runs it under bf16: float32 out, equal to the float32 pair
        on the upcast cotangents, against PyTorch's conv_transpose2d on them
        within VDP_TOL."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V
        from supernet_tpu_torch.profiling import TF32_FLOPS_PER_S, device_ms

        bf = torch.bfloat16
        what = f"vdp_conv dgrad bf16 {config}/{layer}"
        g1 = self._randn(b, h - 2, w - 2, cout).to(bf)
        g2 = self._randn(b, h - 2, w - 2, cout).to(bf) if with_sigma else None
        w_mu = 0.1 * self._randn(3, 3, cin, cout)
        up2 = None if g2 is None else g2.float()
        with torch.inference_mode():
            got = V.conv_t_pair(g1, g2, w_mu)
            ref = V.conv_t_pair(g1.float(), up2, w_mu)
            want = V.conv_t_pair_plain(g1, g2, w_mu)
            torch.cuda.synchronize()
            if any(x is not None and x.dtype != torch.float32 for x in got):
                _die(f"{what}: the outputs are not float32")
            _equal_on_upcast(torch, what, got, ref)
            abs_err, rel_err = _bf16_errors(torch, what, got, want, VDP_TOL)
            ms = _time_ms(torch, lambda: V.conv_t_pair(g1, g2, w_mu))
            plain_ms = _time_ms(torch, lambda: V.conv_t_pair_plain(g1, g2, w_mu))
            dev_ms = device_ms(lambda: V.conv_t_pair(g1, g2, w_mu))
        key = ("vdp_conv_dgrad_bf16", config)
        self.dev[key] = self.dev.get(key, 0.0) + dev_ms
        n = 2 if with_sigma else 1
        nbytes = 2 * n * g1.numel() + 4 * (9 * cin * cout + n * b * h * w * cin)
        flops = n * 2 * 9 * cin * cout * b * h * w
        bound = _bound(nbytes, flops)
        # the cotangents' small TF32 half is 0: two TF32 passes
        b2 = max(bound[1], 1e3 * 2 * flops / TF32_FLOPS_PER_S)
        acc = self.dgrad_ms.setdefault((config, "bf16"), [0.0, 0.0, 0.0])
        acc[0] += dev_ms
        acc[2] += b2
        plan = V.plan(b, h + 2, w + 2, cout, cin, 3, 1, _sms())
        self._record("vdp_conv_dgrad_bf16", config, abs_err, rel_err, ms, plain_ms, bound, {
            "layer": layer, "shape": [b, h, w, cin, cout, 3], "sigma": with_sigma,
            "dtype": "bfloat16", "path": plan.path, "splits": plan.splits,
            "equal_to_float32_on_upcast": True, "device_ms": dev_ms,
            "bound_2xtf32_ms": b2,
        })

    def vdp_conv_bwd_bf16(self, config, layer, b, h, w, cin, cout, k, has_sigma, relu):
        """VDPConv's gradients on bf16 moments (kernel 1 forward with its
        mask, kernel 4 and kernel 1's transposed pair on bf16 cotangents,
        cuDNN's filter gradients on float32 operands): bf16 input gradients
        and float32 weight gradients, equal to VDPConv's float32 gradients
        on the upcast inputs and cotangents, cast (cuDNN deterministic), and
        against autograd of the plain version on the bf16 inputs."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V

        bf = torch.bfloat16
        what = f"vdp_conv_bwd bf16 {config}/{layer}"
        mu0 = self._randn(b, h, w, cin).to(bf)
        sg0 = (0.05 * self._randn(b, h, w, cin).abs()).to(bf) if has_sigma else None
        w_mu = (0.1 * self._randn(k, k, cin, cout)).requires_grad_()
        w_sigma = (-4.0 + self._randn(cout)).requires_grad_()
        g1 = self._randn(b, h - k + 1, w - k + 1, cout).to(bf)
        g2 = self._randn(b, h - k + 1, w - k + 1, cout).to(bf)

        def leaves(dt):
            mu = mu0.to(dt).requires_grad_()
            sg = None if sg0 is None else sg0.to(dt).requires_grad_()
            return mu, sg, [t for t in (mu, sg, w_mu, w_sigma) if t is not None]

        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            mu, sg, ins = leaves(bf)
            got = V.VDPConv.apply(mu, sg, w_mu, w_sigma, relu)
            d_got = torch.autograd.grad(got, ins, (g1, g2), retain_graph=True)
            mu32, sg32, ins32 = leaves(torch.float32)
            d_ref = torch.autograd.grad(V.VDPConv.apply(mu32, sg32, w_mu, w_sigma, relu),
                                        ins32, (g1.float(), g2.float()))
            _equal_on_upcast(torch, what, d_got, d_ref)
            if [d.dtype for d in d_got] != [t.dtype for t in ins]:
                _die(f"{what}: gradient dtypes {[d.dtype for d in d_got]}")
        want = V.vdp_conv_plain(mu, sg, w_mu, w_sigma, relu)[:2]
        c1, c2 = g1, g2
        flips = 0
        if relu:
            tie = (got[0].detach() > 0) != (want[0].detach() > 0)
            flips = int(tie.sum())
            if flips:
                m_got, m_want = got[0].detach().float(), want[0].detach().float()
                if float(torch.maximum(m_got.abs(), m_want.abs())[tie].max()) > \
                        VDP_TOL * float(m_want.abs().max()):
                    _die(f"{what}: a ReLU mask differs away from mu = 0")
                c1, c2 = torch.where(tie, 0.0, g1), torch.where(tie, 0.0, g2)
                d_got = torch.autograd.grad(got, ins, (c1, c2), retain_graph=True)
        d_want = torch.autograd.grad(want, ins, (c1, c2), retain_graph=True)
        torch.cuda.synchronize()
        abs_err, rel_err = _bf16_errors(torch, what, d_got, d_want, VDP_BWD_TOL)
        ms = _time_ms(torch, lambda: torch.autograd.grad(got, ins, (c1, c2),
                                                         retain_graph=True))
        plain_ms = _time_ms(torch, lambda: torch.autograd.grad(want, ins, (c1, c2),
                                                               retain_graph=True))
        self._record("vdp_conv_bwd_bf16", config, abs_err, rel_err, ms, plain_ms, None, {
            "layer": layer, "shape": [b, h, w, cin, cout, k], "dtype": "bfloat16",
            "sigma": has_sigma, "relu": relu, "relu_ties": flips,
            "equal_to_float32_on_upcast": True,
        })

    # ---- kernel 1 in one bf16 pass (precision "default")

    def _one_pass_vs_highest(self, what, got, hi, terms, bf16):
        """``got`` (one bf16 pass) against ``hi`` ("highest") output by
        output: each element within BF16_PRODUCT of ``terms`` (the
        magnitudes it sums; None: no product) plus VDP_TOL of the max, plus
        BF16_STEP of the element for a bf16 output, and the first output not
        bit-equal. Returns the largest difference over the max."""
        torch = self.torch
        if torch.equal(got[0], hi[0]):
            _die(f'{what}: one bf16 pass equals "highest" bit for bit')
        worst = 0.0
        for i, (g, h, t) in enumerate(zip(got, hi, terms)):
            if g is None:
                continue
            half = bf16 and g.dtype == torch.bfloat16
            g, h = g.float(), h.float()
            d = (g - h).abs()
            scale = max(float(h.abs().max()), 1e-30)
            limit = VDP_TOL * scale + (0.0 if t is None else BF16_PRODUCT * t)
            if half:
                limit = limit + BF16_STEP * torch.maximum(g.abs(), h.abs())
            if not bool((d <= limit).all()):
                _die(f'{what}: output {i} differs from "highest" beyond the bf16 limit '
                     f"({float(d.max()) / scale:.3e} of its max)")
            worst = max(worst, float(d.max()) / scale)
        return worst

    def _add_default(self, key, dev_ms, bound_ms, lib_ms, err):
        acc = self.default.setdefault(key, [0.0, 0.0, 0.0, 0.0])
        acc[0] += dev_ms
        acc[1] += bound_ms
        acc[2] += lib_ms
        acc[3] = max(acc[3], err)

    def vdp_conv_default(self, config, layer, b, h, w, cin, cout, has_sigma, bf16=False):
        """Kernel 1 with the window sum and the ReLU in one bf16 pass
        (precision "default") on float32 or bf16 moments: one launch, counted
        as one pass; within VDP_F64_TOL of the max of the plain version's one
        bf16 pass run in float64 on the same inputs (the same rounded
        operands; a bf16 output also within BF16_STEP of the element); before
        the ReLU against "highest" within the bf16 limit
        (``_one_pass_vs_highest``) and not bit-equal, and "high" bit-equal to
        "highest". Device time beside the one-pass bound and cuDNN's bf16
        conv of mu alone (a yardstick the port never calls)."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V
        from supernet_tpu_torch.profiling import device_ms, vdp_conv_bounds

        t0 = time.perf_counter()
        dt = torch.bfloat16 if bf16 else torch.float32
        tag = "bf16" if bf16 else "float32"
        what = f"vdp_conv default {tag} {config}/{layer}"
        mu = self._randn(b, h, w, cin).to(dt)
        sigma = (0.05 * self._randn(b, h, w, cin).abs()).to(dt) if has_sigma else None
        w_mu = 0.1 * self._randn(3, 3, cin, cout)
        w_sigma = -4.0 + self._randn(cout)
        plan = V.plan(b, h, w, cin, cout, 3, 1, _sms(), "default")

        def wide(t):
            return None if t is None else t.double()

        with torch.inference_mode():
            _zero_launches()
            got = V.vdp_conv(mu, sigma, w_mu, w_sigma, True, precision="default")
            torch.cuda.synchronize()
            if (V.launches, V.bf16_launches) != (1, 1):
                _die(f"{what}: {V.launches} launches, {V.bf16_launches} in one bf16 pass")
            want = V.vdp_conv_plain(wide(mu), wide(sigma), w_mu.double(), w_sigma.double(),
                                    True, precision="default")
            tie = (got[0].double() > 0) != (want[0] > 0)
            flips = int(tie.sum())
            if flips and float(torch.maximum(got[0].double().abs(), want[0].abs())[tie]
                               .max()) > VDP_TOL * float(want[0].abs().max()):
                _die(f"{what}: a ReLU mask differs away from mu = 0")
            abs_err, f64_err = _bf16_errors(torch, what, got, want, VDP_F64_TOL,
                                            [None, ~tie, None])
            del want
            pre = V.vdp_conv(mu, sigma, w_mu, w_sigma, False, precision="default")
            hi = V.vdp_conv(mu, sigma, w_mu, w_sigma, False, precision="highest")
            high = V.vdp_conv(mu, sigma, w_mu, w_sigma, False, precision="high")
            if not all(torch.equal(x, y) for x, y in zip(high, hi)):
                _die(f'{what}: "high" is not "highest" bit for bit')
            terms = (V._conv_valid(mu.float().abs(), w_mu.abs()),
                     None if sigma is None else V._conv_valid(sigma.float(), w_mu * w_mu),
                     None)
            vs_highest = self._one_pass_vs_highest(what, pre, hi, terms, bf16)
            del pre, hi, high, terms
            dev_ms = device_ms(lambda: V.vdp_conv(mu, sigma, w_mu, w_sigma, True,
                                                  precision="default"))
            mu16, w16 = mu.to(torch.bfloat16), w_mu.to(torch.bfloat16)
            cudnn_ms = device_ms(lambda: V._conv_valid(mu16, w16))
        bound = vdp_conv_bounds(b, h, w, cin, cout, 3, has_sigma,
                                itemsize=2 if bf16 else 4)["bound_bf16_ms"]
        self._add_default((config, tag, "forward"), dev_ms, bound, cudnn_ms, f64_err)
        self.default_s += time.perf_counter() - t0
        print(json.dumps({
            "kernel": "vdp_conv_default", "config": config, "layer": layer, "dtype": tag,
            "shape": [b, h, w, cin, cout, 3], "path": plan.path, "splits": plan.splits,
            "relu_ties": flips, "max_abs_err": abs_err, "f64_max_rel_err": f64_err,
            "vs_highest_max_rel": vs_highest, "high_equals_highest": True,
            "device_ms": dev_ms, "bound_bf16_ms": bound, "cudnn_bf16_mu_ms": cudnn_ms,
        }), flush=True)

    def dgrad_default(self, config, layer, b, h, w, cin, cout, with_sigma, bf16=False):
        """Kernel 1's transposed pair in one bf16 pass (``conv_t_pair`` at
        precision "default") on float32 or bf16 cotangents, as
        :meth:`vdp_conv_default` holds the forward: one launch counted as one
        pass, within VDP_F64_TOL of the plain pair's one pass in float64,
        within the bf16 limit of "highest" and not bit-equal, "high"
        bit-equal to "highest"; device time beside the one-pass bound and
        cuDNN's bf16 conv_transpose2d of g1 alone."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V
        from supernet_tpu_torch.profiling import BF16_FLOPS_PER_S, device_ms

        t0 = time.perf_counter()
        dt = torch.bfloat16 if bf16 else torch.float32
        tag = "bf16" if bf16 else "float32"
        what = f"vdp_conv dgrad default {tag} {config}/{layer}"
        g1 = self._randn(b, h - 2, w - 2, cout).to(dt)
        g2 = self._randn(b, h - 2, w - 2, cout).to(dt) if with_sigma else None
        w_mu = 0.1 * self._randn(3, 3, cin, cout)
        plan = V.plan(b, h + 2, w + 2, cout, cin, 3, 1, _sms(), "default")
        with torch.inference_mode():
            _zero_launches()
            got = V.conv_t_pair(g1, g2, w_mu, "default")
            torch.cuda.synchronize()
            if (V.dgrad_launches, V.bf16_launches) != (1, 1):
                _die(f"{what}: {V.dgrad_launches} launches, {V.bf16_launches} in one bf16 pass")
            want = V.conv_t_pair_plain(g1.double(), None if g2 is None else g2.double(),
                                       w_mu.double(), "default")
            abs_err, f64_err = _bf16_errors(torch, what, got, want, VDP_F64_TOL)
            del want
            hi = V.conv_t_pair(g1, g2, w_mu, "highest")
            high = V.conv_t_pair(g1, g2, w_mu, "high")
            if not all(x is None or torch.equal(x, y) for x, y in zip(high, hi)):
                _die(f'{what}: "high" is not "highest" bit for bit')
            p1, p2, wf = V.dgrad_operands(g1.float().abs(),
                                          None if g2 is None else g2.float().abs(), w_mu.abs())
            terms = (V._conv_valid(p1, wf), None if p2 is None else V._conv_valid(p2, wf * wf))
            vs_highest = self._one_pass_vs_highest(what, got, hi, terms, False)
            del hi, high, terms, p1, p2
            dev_ms = device_ms(lambda: V.conv_t_pair(g1, g2, w_mu, "default"))
            g16, w16 = g1.to(torch.bfloat16), w_mu.to(torch.bfloat16)
            cudnn_ms = device_ms(lambda: V._conv_t(g16, w16))
        n = 2 if with_sigma else 1
        itemsize = 2 if bf16 else 4
        nbytes = itemsize * n * g1.numel() + 4 * (9 * cin * cout + n * b * h * w * cin)
        flops = n * 2 * 9 * cin * cout * b * h * w
        bound = max(_bound(nbytes, 0)[1], 1e3 * flops / BF16_FLOPS_PER_S)
        self._add_default((config, tag, "dgrad"), dev_ms, bound, cudnn_ms, f64_err)
        self.default_s += time.perf_counter() - t0
        print(json.dumps({
            "kernel": "vdp_conv_dgrad_default", "config": config, "layer": layer, "dtype": tag,
            "shape": [b, h, w, cin, cout, 3], "sigma": with_sigma, "path": plan.path,
            "splits": plan.splits, "max_abs_err": abs_err, "f64_max_rel_err": f64_err,
            "vs_highest_max_rel": vs_highest, "high_equals_highest": True,
            "device_ms": dev_ms, "bound_bf16_ms": bound,
            "cudnn_bf16_conv_transpose_g1_ms": cudnn_ms,
        }), flush=True)

    def default_members(self, config, layer, b, h, w, cin, cout, k_n, shared):
        """Kernel 1 in one bf16 pass with a member axis of ``k_n`` (a shared
        input read at member stride 0, or one batch per member), forward and
        transposed pair, against the plain version's one pass in float64
        member by member within VDP_F64_TOL."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V

        t0 = time.perf_counter()
        what = f"vdp_conv default members {config}/{layer}"
        if shared:
            mu = self._randn(b, h, w, cin).expand(k_n, b, h, w, cin)
            sigma = (0.05 * self._randn(b, h, w, cin).abs()).expand(k_n, b, h, w, cin)
        else:
            mu = self._randn(k_n, b, h, w, cin)
            sigma = 0.05 * self._randn(k_n, b, h, w, cin).abs()
        w_mu = 0.1 * self._randn(k_n, 3, 3, cin, cout)
        w_sigma = -4.0 + self._randn(k_n, cout)
        g1 = self._randn(k_n * b, h - 2, w - 2, cout)
        g2 = self._randn(k_n * b, h - 2, w - 2, cout)
        plan = V.plan(b, h, w, cin, cout, 3, k_n, _sms(), "default")
        with torch.inference_mode():
            _zero_launches()
            got = V.vdp_conv(mu, sigma, w_mu, w_sigma, True, precision="default")
            d = V.conv_t_pair(g1, g2, w_mu, "default")
            torch.cuda.synchronize()
            if (V.launches, V.dgrad_launches, V.bf16_launches) != (1, 1, 2):
                _die(f"{what}: launches {(V.launches, V.dgrad_launches, V.bf16_launches)}")
            want = V.vdp_conv_plain(mu.double(), sigma.double(), w_mu.double(),
                                    w_sigma.double(), True, precision="default")
            tie = (got[0].double() > 0) != (want[0] > 0)
            if tie.any() and float(torch.maximum(got[0].double().abs(), want[0].abs())[tie]
                                   .max()) > VDP_TOL * float(want[0].abs().max()):
                _die(f"{what}: a ReLU mask differs away from mu = 0")
            _, err = _bf16_errors(torch, what, got, want, VDP_F64_TOL, [None, ~tie, None])
            want_d = V.conv_t_pair_plain(g1.double(), g2.double(), w_mu.double(), "default")
            _, err_d = _bf16_errors(torch, what + " dgrad", d, want_d, VDP_F64_TOL)
        self.default_s += time.perf_counter() - t0
        print(json.dumps({
            "kernel": "vdp_conv_default_members", "config": config, "layer": layer,
            "members": k_n, "shared_input": shared, "path": plan.path, "splits": plan.splits,
            "f64_max_rel_err": err, "dgrad_f64_max_rel_err": err_d,
        }), flush=True)

    def _seen(self, kernel, config, path, dev_ms):
        """Note the path a backward kernel's plan took and add its device
        time (the stream held by a sleep) to the config's sum."""
        self.paths.setdefault(kernel, set()).add(path)
        self.dev[(kernel, config)] = self.dev.get((kernel, config), 0.0) + dev_ms

    def chunk_layer(self, config, layer, b, h, w, cin, cout, has_sigma):
        """Kernel 1 at one layer of a serving chunk: the forward with its
        ReLU and, but at the first layer, the transposed pair, each within
        VDP_F64_TOL of the max of the plain version in float64 (the forward
        before its ReLU), timed by device time beside its 3xTF32 bound, with
        the plan's path, tile and K slices. On the tensor cores the
        prologue's weight planes, forward and flipped, bit for bit those of
        ``split_weight_planes_plain``. One JSON line; the sums go to
        ``self.chunk``."""
        torch = self.torch
        from supernet_tpu_torch.ops.kernels import vdp_conv as V
        from supernet_tpu_torch.profiling import device_ms, vdp_conv_bounds

        what = f"vdp_conv {config}/{layer} at batch {b}"
        mu = self._randn(b, h, w, cin)
        sigma = 0.05 * self._randn(b, h, w, cin).abs() if has_sigma else None
        w_mu = 0.1 * self._randn(3, 3, cin, cout)
        w_sigma = -4.0 + self._randn(cout)
        g1, g2 = self._randn(b, h - 2, w - 2, cout), self._randn(b, h - 2, w - 2, cout)
        fwd = V.plan(b, h, w, cin, cout, 3, 1, _sms())
        dgrad = V.plan(b, h, w, cout, cin, 3, 1, _sms())
        line = {"kernel": "vdp_conv_chunk", "config": config, "layer": layer,
                "shape": [b, h, w, cin, cout], "path": fwd.path, "splits": fwd.splits,
                "tile": [fwd.tile_h, fwd.tile_w, fwd.tile_n]}

        def wide(t):
            return None if t is None else t.double()

        def rel(got, want):
            return float((got.double() - want).abs().max() / want.abs().max())

        with torch.inference_mode():
            got = V.vdp_conv(mu, sigma, w_mu, w_sigma)
            want = V.vdp_conv_plain(wide(mu), wide(sigma), w_mu.double(), w_sigma.double())
            line["f64_max_rel_err"] = max(rel(g, r) for g, r in zip(got, want))
            del got, want
            if has_sigma:
                got = V.conv_t_pair(g1, g2, w_mu)
                want = V.conv_t_pair_plain(g1.double(), g2.double(), w_mu.double())
                line["dgrad_f64_max_rel_err"] = max(rel(g, r) for g, r in zip(got, want))
                del got, want
            for key in ("f64_max_rel_err", "dgrad_f64_max_rel_err"):
                if line.get(key, 0.0) > VDP_F64_TOL:
                    _die(f"{what}: {key} {line[key]:.3e} > {VDP_F64_TOL}")
            if fwd.path == "wgmma":
                for flip, p, x, s in ((False, fwd, mu, sigma),
                                      (True, dgrad, *V._padded(g1, g2, 3))):
                    planes = torch.full((p.planes_bytes // 4,), -1, dtype=torch.int32,
                                        device="cuda")
                    V._launch(x, s, w_mu, None if flip else w_sigma, False, flip=flip,
                              planes=planes)
                    plain = V.split_weight_planes_plain(w_mu.cpu(), p.tile_n, flip=flip)
                    if not torch.equal(planes.cpu(), plain.reshape(-1)):
                        _die(f"{what}: the prologue's weight planes (flip {flip}) are "
                             f"not split_weight_planes_plain's")
                line["weight_planes_equal"] = True
            line["device_ms"] = device_ms(lambda: V.vdp_conv(mu, sigma, w_mu, w_sigma, True))
            if has_sigma:
                line["dgrad_path"] = dgrad.path
                line["dgrad_tile"] = [dgrad.tile_h, dgrad.tile_w, dgrad.tile_n]
                line["dgrad_device_ms"] = device_ms(lambda: V.conv_t_pair(g1, g2, w_mu))
        line["bound_3xtf32_ms"] = vdp_conv_bounds(b, h, w, cin, cout, 3,
                                                  has_sigma)["bound_3xtf32_ms"]
        if has_sigma:
            line["dgrad_bound_3xtf32_ms"] = vdp_conv_bounds(
                b, h + 2, w + 2, cout, cin, 3, True)["bound_3xtf32_ms"]
        acc = self.chunk.setdefault(config, [0.0, 0.0, 0.0, 0.0])
        acc[0] += line["device_ms"]
        acc[1] += line["bound_3xtf32_ms"]
        acc[2] += line.get("dgrad_device_ms", 0.0)
        acc[3] += line.get("dgrad_bound_3xtf32_ms", 0.0)
        print(json.dumps(line), flush=True)

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


def _equal_on_upcast(torch, what, got, ref) -> None:
    """Check (a) of a bf16 case: output by output, the kernel on bf16
    inputs returns the same kernel's outputs on their float32 upcast, cast
    to its own output's dtype (bit for bit; None outputs skipped)."""
    for i, (g, r) in enumerate(zip(got, ref)):
        if g is None and r is None:
            continue
        if g is None or r is None or not torch.equal(g, r.to(g.dtype)):
            _die(f"{what}: output {i} on bf16 inputs is not the float32 kernel's "
                 f"output on the upcast inputs, cast to its dtype")


def _same_bits(torch, got, want) -> bool:
    """``got`` equals ``want`` element for element, a NaN where it has a
    NaN (torch.equal calls two NaNs unequal)."""
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(
        got.nan_to_num(0.0), want.nan_to_num(0.0))


def _bf16_errors(torch, what, got, want, tol, keep=None):
    """Check (b) of a bf16 case: each output within ``tol`` of the plain
    version's max magnitude, plus BF16_STEP of the element where the output
    is bf16; ``keep`` (per output, a boolean mask or None) leaves elements
    out. Returns (max abs error, max error / max |plain|)."""
    abs_err = rel_err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        step = BF16_STEP if g.dtype == torch.bfloat16 else 0.0
        g, w = g.detach().float(), w.detach().float()
        scale = max(float(w.abs().max()), 1e-30)
        d = (g - w).abs()
        over = d - tol * scale - step * torch.maximum(g.abs(), w.abs())
        m = None if keep is None else keep[i]
        if m is not None:
            d, over = d[m], over[m]
        if not d.numel():
            continue
        if float(over.max()) > 0:
            _die(f"{what}: output {i} differs from its plain version by "
                 f"{float(d.max()):.3e} ({float(d.max()) / scale:.3e} of its max), "
                 f"beyond {tol} of the max plus {step} of the element")
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float(d.max()) / scale)
    return abs_err, rel_err


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
    V.dgrad_launches = V.dgrad_reduce_launches = V.bf16_launches = 0
    V.weight_plane_launches = 0


def _read_launches() -> dict:
    from supernet_tpu_torch.hlo_profile import launch_counts

    return launch_counts()


def _serve(torch, name, cfg, batch, sizes):
    """Answer requests of ``sizes`` images through the CUDA session with
    the launch counters zeroed before and read after; check the answers
    and compare them with the CPU session's. Returns (launches, img/s of
    the last request)."""
    import numpy as np

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
    want = _expected_launches(cfg, batch, 0, chunks)
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
    default = _serve_default(torch, name, cfg, batch, gpu, cpu, requests[0], answers[0])
    print(json.dumps({
        "serving": name, "batch": batch, "requests": list(sizes),
        "launches": launches, "chunks": chunks,
        "probs_max_abs_err_vs_cpu": worst_p, "sigma_max_rel_err_vs_cpu": worst_s,
        "sigma_share_beyond_rtol": share,
        "img_per_s_last_request": img_s,
        "request_s": [a[2] for a in answers],
        "default": default,
    }), flush=True)
    return launches, img_s


@contextlib.contextmanager
def _default_precision(torch):
    """``set_mxu_precision("default")`` with PyTorch's own products kept at
    float32 on the card (TF32 off for cuDNN and cuBLAS), as on the CPU, so
    that only kernel 1's arithmetic differs from "highest"; "highest" again
    on the way out."""
    from supernet_tpu_torch.ops import set_mxu_precision

    set_mxu_precision("default")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        set_mxu_precision("highest")


@contextlib.contextmanager
def _one_pass_checked(torch, what):
    """Inside, every kernel-1 call of ``VDPConv`` (its forward through
    ``vdp_conv``, its backward's transposed pair through ``conv_t_pair``)
    must run in one bf16 pass and is held, on its own inputs, against the
    plain version's one pass in float64 within VDP_F64_TOL of the max (a
    bf16 output also within BF16_STEP of the element); a ReLU mask may
    differ only where mu_out lies within VDP_TOL of the max of 0. So a
    whole forward or step is checked call by call at the plans its batch
    takes, where the layers' answers cannot be compared with a reference
    that sums in another order (an operand a rounding apart lands on
    another bf16 value, and the flips spread). Yields the calls, the worst
    error over the max and the ReLU ties."""
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    fwd, pair = V.vdp_conv, V.conv_t_pair
    seen = {"forward_calls": 0, "dgrad_calls": 0, "f64_max_rel_err": 0.0, "relu_ties": 0}

    def wide(t):
        return None if t is None else t.detach().double()

    def one_pass(precision, kind):
        if precision != "default":
            _die(f"{what}: a kernel-1 {kind} ran at {precision!r}, not one bf16 pass")

    def checked_fwd(mu, sigma, w_mu, w_sigma, fuse_relu=False, relu_mask=False,
                    precision="highest"):
        one_pass(precision, "forward")
        out = fwd(mu, sigma, w_mu, w_sigma, fuse_relu, relu_mask, precision)
        with torch.no_grad():
            want = V.vdp_conv_plain(wide(mu), wide(sigma), wide(w_mu), wide(w_sigma),
                                    fuse_relu, precision="default")
            got = out[0].detach().double()
            tie = (got > 0) != (want[0] > 0)
            if tie.any() and float(torch.maximum(got.abs(), want[0].abs())[tie].max()) \
                    > VDP_TOL * float(want[0].abs().max()):
                _die(f"{what}: a ReLU mask differs away from mu = 0")
            _, err = _bf16_errors(torch, what, out[:3], want, VDP_F64_TOL,
                                  [None, ~tie, None])
        seen["forward_calls"] += 1
        seen["relu_ties"] += int(tie.sum())
        seen["f64_max_rel_err"] = max(seen["f64_max_rel_err"], err)
        return out

    def checked_pair(g1, g2, w_mu, precision="highest"):
        one_pass(precision, "transposed pair")
        out = pair(g1, g2, w_mu, precision)
        with torch.no_grad():
            want = V.conv_t_pair_plain(wide(g1), wide(g2), wide(w_mu), "default")
            _, err = _bf16_errors(torch, what + " dgrad", out, want, VDP_F64_TOL)
        seen["dgrad_calls"] += 1
        seen["f64_max_rel_err"] = max(seen["f64_max_rel_err"], err)
        return out

    V.vdp_conv, V.conv_t_pair = checked_fwd, checked_pair
    try:
        yield seen
    finally:
        V.vdp_conv, V.conv_t_pair = fwd, pair


def _answer_gap(np, a, b) -> dict:
    """How far answer ``a`` = (probs, sigma) lies from ``b``: probs' largest
    and mean absolute difference, sigma's largest difference over the max
    of ``b``'s and its mean difference over the mean of ``b``'s."""
    dp, ds = np.abs(a[0] - b[0]), np.abs(a[1] - b[1])
    return {"probs_max": float(dp.max()), "probs_mean": float(dp.mean()),
            "sigma_max_rel": float(ds.max()) / max(float(np.abs(b[1]).max()), 1e-30),
            "sigma_mean_rel": float(ds.mean()) / max(float(np.abs(b[1]).mean()), 1e-30)}


def _serve_default(torch, name, cfg, batch, gpu, cpu, x, highest):
    """One request of ``x`` under "default" (``_default_precision``) through
    the CUDA session against the CPU session under "default": kernel 1 in
    one bf16 pass on the card, its plain version's one pass on the CPU.
    The launches must be one forward's per chunk at the one-pass plans,
    every kernel-1 launch one pass, and each call within VDP_F64_TOL of its
    plain one pass in float64 on its own inputs (``_one_pass_checked``).
    The answer must be finite, not bit-equal to the card's "highest" answer
    ``highest``, and near the CPU's "default" answer measured against how
    far the CPU's own two precisions part (``_answer_gap``, ``gap``): the
    largest probs difference within DEFAULT_MAX_SHARE of the gap's, probs'
    and sigma's mean differences within DEFAULT_MEAN_SHARE of the gap's.
    One bf16 pass turns a float32 rounding difference between two
    summation orders into an operand a bf16 step apart, and such flips
    spread layer by layer, so the largest difference is a large share of
    the gap: printed beside it, how far the CPU's own "default" answer
    moves when the input moves by one float32 ulp, the scale of those
    flips. Returns the readings and the launches."""
    import numpy as np

    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    t0 = time.perf_counter()
    ref_hi = cpu.predict(x)
    with _default_precision(torch):
        with _one_pass_checked(torch, f'{name} under "default"') as calls:
            _zero_launches()
            probs, sigma = gpu.predict(x)
            launches, bf16_pass = _read_launches(), V.bf16_launches
        ref = cpu.predict(x)
        ulp = cpu.predict(np.nextafter(x, np.float32(np.inf)))
    chunks = math.ceil(len(x) / batch)
    want = _expected_launches(cfg, batch, 0, chunks, precision="default")
    if launches != want or bf16_pass != launches["vdp_conv"]:
        _die(f"{name} under \"default\": launches {launches} ({bf16_pass} in one bf16 "
             f"pass), expected {want}, every kernel-1 launch in one pass")
    if not (np.isfinite(probs).all() and np.isfinite(sigma).all() and (sigma >= 0).all()):
        _die(f'{name} under "default": a non-finite or negative answer')
    if np.array_equal(probs, highest[0]) and np.array_equal(sigma, highest[1]):
        _die(f'{name} under "default": the answer is the "highest" one bit for bit')
    card, gap = _answer_gap(np, (probs, sigma), ref), _answer_gap(np, ref, ref_hi)
    limits = {"probs_max": DEFAULT_MAX_SHARE, "probs_mean": DEFAULT_MEAN_SHARE,
              "sigma_mean_rel": DEFAULT_MEAN_SHARE}
    over = {k: (card[k], gap[k]) for k, share in limits.items()
            if not card[k] <= share * gap[k]}
    if over:
        _die(f'{name} under "default": the CUDA session against the CPU session, '
             f"(card, the CPU's gap between the precisions) {over}, limits {limits} "
             f"of the gap")
    return {"images": len(x), "launches": launches, "bf16_pass_launches": bf16_pass,
            "checked_calls": calls, "vs_cpu": card, "cpu_gap_default_vs_highest": gap,
            "share_of_gap": {k: card[k] / max(gap[k], 1e-30) for k in card},
            "argmax_agreement_vs_cpu": float(np.mean(probs.argmax(-1) == ref[0].argmax(-1))),
            "vs_card_highest": _answer_gap(np, (probs, sigma), highest),
            "cpu_one_ulp_input": _answer_gap(np, ulp, ref),
            "seconds": time.perf_counter() - t0}


@contextlib.contextmanager
def _decisions(torch, record=None, replay=None, clips=True):
    """Record the discrete choices of the forwards run inside (each fused
    ReLU's mask, the glue fold's ReLU masks, each pool's tap index, which
    pixels the loss's sigma clip holds at a bound) into the list ``record``,
    or make the forwards take the choices of ``replay`` instead of their own
    (the clips too, unless ``clips`` is False). A ReLU is the same choice in
    either glue mode, so a pass without the fold replays into one with it.

    Two float32 summation orders can round a pre-activation near 0, or two
    near-equal pool taps, differently; that choice moves the pixel's whole
    gradient path (one ReLU flip and one pool near-tie at hippocampus batch
    20 move a w_mu gradient by 1.4e-3 of its max). So the CPU reference of
    the gradient check replays the card's choices. A replayed choice that
    differs from the CPU's own must be a tie: |mu| within VDP_TOL of mu's
    max magnitude for a ReLU, the two taps within VDP_TOL of it for a pool,
    sigma within CLIP_TIE_RTOL of the bound for a clip (at BraTS depth half
    the pixels' sigma lies above the upper bound of 1e3, and a pixel within
    rounding of it has its gradient on in one run and off in the other).
    Yields the count of such ties."""
    from supernet_tpu_torch import losses as L
    from supernet_tpu_torch.ops import moments as M
    from supernet_tpu_torch.ops.kernels import pool as P
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    conv_apply, pool_apply, clip_sigma = V.VDPConv.apply, P.VMaxPool.apply, L.clip_sigma
    relu = M.vrelu
    queue = iter(replay) if replay is not None else None
    ties = {"relu": 0, "pool": 0, "clip": 0}

    def tie_bound(x):
        return VDP_TOL * float(x.detach().abs().max())

    def vrelu(mu, sigma):
        # the ReLU of the glue fold's convs (ops.moments.vglue_conv_relu),
        # in the call order of the fused ReLUs it stands for
        if queue is None:
            record.append(mu.detach() > 0)
            return relu(mu, sigma)
        mask = next(queue).to(mu.device)
        tie = mask != (mu.detach() > 0)
        if tie.any():
            if float(mu.detach()[tie].abs().max()) > tie_bound(mu):
                _die("training: a ReLU mask differs away from mu = 0")
            ties["relu"] += int(tie.sum())
        return torch.where(mask, mu, 0.0), torch.where(mask, sigma, 0.0)

    def conv(mu, sigma, w_mu, w_sigma, relu, precision="highest"):
        if not relu:
            return conv_apply(mu, sigma, w_mu, w_sigma, relu, precision)
        if queue is None:
            out = conv_apply(mu, sigma, w_mu, w_sigma, relu, precision)
            record.append(out[0].detach() > 0)
            return out
        m, s = conv_apply(mu, sigma, w_mu, w_sigma, False, precision)
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

    def clip(sigma, lo, hi):
        if queue is None:
            record.append((sigma.detach() < lo, sigma.detach() > hi))
            return clip_sigma(sigma, lo, hi)
        below, above = (m.to(sigma.device) for m in next(queue))
        if not clips:
            return clip_sigma(sigma, lo, hi)
        s = sigma.detach()
        tie = (below != (s < lo)) | (above != (s > hi))
        if tie.any():
            near = torch.minimum((s - lo).abs() / abs(lo), (s - hi).abs() / abs(hi))
            if float(near[tie].max()) > CLIP_TIE_RTOL:
                _die("training: a sigma clip differs away from its bound")
            ties["clip"] += int(tie.sum())
        return torch.where(above, hi, torch.where(below, lo, sigma))

    V.VDPConv.apply, P.VMaxPool.apply, L.clip_sigma, M.vrelu = conv, pool, clip, vrelu
    try:
        yield ties
    finally:
        del V.VDPConv.apply, P.VMaxPool.apply
        L.clip_sigma, M.vrelu = clip_sigma, relu


@contextlib.contextmanager
def _cudnn_dgrad():
    """Run VDPConv's backward with its transposed convolutions through
    PyTorch's ``conv_transpose2d`` (cuDNN on the card), as before kernel 1
    took them: the yardstick of the repair."""
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    kernel = V.conv_t_pair
    V.conv_t_pair = lambda g1, g2, w, precision="highest": (
        V._conv_t(g1, w), None if g2 is None else V._conv_t(g2, w * w))
    try:
        yield
    finally:
        V.conv_t_pair = kernel


def _max_rel(torch, got, want) -> float:
    """max |got - want| / max |want|, ``got`` moved to ``want``'s device."""
    d = float((got.detach().to(want.device) - want).abs().max())
    return d / max(float(want.abs().max()), 1e-30)


def _gradient_vs_cpu(torch, name, cfg, tc, gpu, cpu, x, y):
    """The step-1 gradients of ``loss_fn`` from the train states ``gpu``
    (on the card) and ``cpu`` on one batch, the CPU replaying the card's
    ReLU masks, pool taps and sigma clips (``_decisions``), each leaf held
    to ``TRAIN_GRAD_TOL`` of its max. Returns the gradient function
    (``grads(state)``), the card's choices, both gradients, the worst
    leaf's error and the ties replayed."""
    from supernet_tpu_torch import train as T

    def grads(state):
        dev = state.params["conv_input"]["w_mu"].device
        loss, _ = T.loss_fn(state.params, torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev), cfg, tc)
        return torch.autograd.grad(loss, T.leaves(state.params))

    choices = []
    with _decisions(torch, record=choices):
        g_gpu = grads(gpu)
    with _decisions(torch, replay=choices) as ties:
        g_cpu = grads(cpu)
    worst = max(_max_rel(torch, g, r) for g, r in zip(g_gpu, g_cpu))
    if not worst <= TRAIN_GRAD_TOL:
        _die(f"{name} training: step-1 gradients differ from the CPU's by "
             f"{worst:.3e} of a leaf's max > {TRAIN_GRAD_TOL}")
    return {"grads": grads, "choices": choices, "card": g_gpu, "cpu": g_cpu,
            "max_rel_err": worst, "ties": ties}


def _train(torch, name, cfg, tc, batch, steps):
    """``steps`` train steps on the card with the launch counters zeroed
    before and read after, held against the same steps on the CPU from the
    same parameters and batches. Returns (launches, median step seconds of
    steps 2.., per-step launches)."""
    import numpy as np

    from supernet_tpu_torch import train as T

    params = _he_params(torch, cfg)
    rng = np.random.default_rng(SEED)
    s, o = cfg.image_size, cfg.out_size
    x = rng.normal(0.0, 1.0, (steps, batch, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (steps, batch, o, o)).astype(np.int32)
    gpu, _ = T.create_train_state(params, tc, "cuda")
    cpu, _ = T.create_train_state(params, tc, "cpu")

    # step-1 gradients, outside the counted run
    check = _gradient_vs_cpu(torch, name, cfg, tc, gpu, cpu, x[0], y[0])
    grads, choices, g_gpu, g_cpu = (check[k] for k in ("grads", "choices", "card", "cpu"))
    worst_g, ties = check["max_rel_err"], check["ties"]
    with _decisions(torch, replay=choices, clips=False):
        g_cpu_own_clips = grads(cpu)
    worst_own_clips = max(_max_rel(torch, g, r) for g, r in zip(g_gpu, g_cpu_own_clips))
    del g_cpu_own_clips
    # the same gradients on the card with the backward's transposed
    # convolutions through cuDNN instead of kernel 1 (the path before it),
    # the card's choices replayed: printed beside the limit, not held to it
    with _cudnn_dgrad(), _decisions(torch, replay=choices):
        g_old = grads(gpu)
    worst_old = max(_max_rel(torch, g, r) for g, r in zip(g_old, g_cpu))
    del g_old

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
    per_step = _expected_launches(cfg, batch, 1, 0)
    if launches != _scaled(per_step, steps):
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
        "grad_share_of_limit": worst_g / TRAIN_GRAD_TOL,
        "grad_max_rel_err_vs_cpu_own_clips": worst_own_clips,
        "grad_share_of_limit_own_clips": worst_own_clips / TRAIN_GRAD_TOL,
        "grad_max_rel_err_vs_cpu_cudnn_dgrad": worst_old,
        "grad_share_of_limit_cudnn_dgrad": worst_old / TRAIN_GRAD_TOL,
        "grad_ties_replayed": ties,
        "param_max_abs_err_vs_cpu": param_err, "param_limit": limit,
        "step_s": times, "median_step_s": step_s, "img_per_s": batch / step_s,
    }), flush=True)
    return launches, step_s, per_step



def _per_forward(cfg, batch, members=1, skip=(), precision="highest") -> dict:
    """Launches of one forward (vdp_conv, its split-K reduces, pool), of
    ``members`` ensemble members in one member-stacked forward, at
    ``precision``; the k=3 convs named in ``skip`` run no kernel (the glue
    fold's)."""
    from supernet_tpu_torch.models import layer_names

    return {"vdp_conv": sum(1 for name, k, _, _ in layer_names(cfg)
                            if k == 3 and name not in skip),
            "vdp_conv_reduce": _split_layers(cfg, batch, members, skip, precision),
            "vmaxpool": cfg.depth - 1}


def _expected_launches(cfg, batch, steps, eval_batches, input_grads=0, members=1,
                       skip=(), precision="highest") -> dict:
    """Launches of ``steps`` train steps (gradients of the weights alone),
    ``eval_batches`` forwards and ``input_grads`` gradients with respect to
    the image (the weights frozen), each of ``members`` ensemble members in
    one member-stacked pass. Every backward runs kernel 4 at each k=3
    conv and kernel 1 without the window sum at each k=3 conv whose input
    needs a gradient: all but conv_input in a train step, all of them in a
    gradient with respect to the image. The convs in ``skip`` (the glue
    fold's, never conv_input) run neither. ``precision``: the plans' (the
    split-K reduces follow the K step of the one-bf16-pass path)."""
    f = _per_forward(cfg, batch, members, skip, precision)
    fwd = steps + eval_batches + input_grads
    bwd = steps + input_grads
    return {"vdp_conv": fwd * f["vdp_conv"],
            "vdp_conv_reduce": fwd * f["vdp_conv_reduce"],
            "vmaxpool": fwd * f["vmaxpool"],
            "vmaxpool_bwd": bwd * f["vmaxpool"],
            "sigma_bwd": bwd * f["vdp_conv"],
            "vdp_conv_dgrad": steps * (f["vdp_conv"] - 1) + input_grads * f["vdp_conv"],
            "vdp_conv_dgrad_reduce": (
                steps * _dgrad_split_layers(cfg, batch, False, members, skip, precision)
                + input_grads * _dgrad_split_layers(cfg, batch, True, members, skip,
                                                    precision))}


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
    """Launches of one gradient with respect to the image (an attack step,
    a saliency map)."""
    return _expected_launches(cfg, batch, 0, 0, input_grads=1)


def _per_step(cfg, batch, precision="highest") -> dict:
    """Launches of one train step's forward and backward at ``precision``."""
    return _expected_launches(cfg, batch, 1, 0, precision=precision)


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
    # the same float64 gradient with its own sigma clips (the comparison
    # before the clips were replayed): printed, not held
    with _decisions(torch, replay=choices, clips=False):
        g64_own = attacks.input_gradient(p64, x.cpu().double(), y_flat.cpu().double(), cfg, ac)
    err_card64_own_clips = _max_rel(torch, g.double(), g64_own)
    del g64_own
    # the path before the repair: the backward's transposed convolutions in
    # cuDNN, the same choices replayed on the card
    with _cudnn_dgrad(), _decisions(torch, replay=choices):
        g_old = attacks.input_gradient(state.params, x, y_flat, cfg, ac)
    err_old64 = _max_rel(torch, g_old.double(), g64)
    del g_old
    if not (err <= ATTACK_GRAD_TOL and err_card64 <= ATTACK_F64_TOL):
        _die(f"{name} attack gradient differs from the CPU's by {err:.3e} of its "
             f"max (limit {ATTACK_GRAD_TOL}) and from float64 by {err_card64:.3e} "
             f"(limit {ATTACK_F64_TOL}); the CPU's float32 is {err_cpu64:.3e} from "
             f"float64, the card's with cuDNN's transposed convolutions {err_old64:.3e}")
    # the same gradient on the card with kernel 1's forward replaced by its
    # plain version (cuDNN float32), the same choices replayed; printed, not
    # held to a limit
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
        "grad_max_rel_err_vs_float64_own_clips": err_card64_own_clips,
        "card_grad_cudnn_dgrad_max_rel_err_vs_float64": err_old64,
        "card_grad_with_plain_kernel_1_forward_max_rel_err_vs_float64": err_plain64,
        "grad_max_abs": scale, "grad_ties_replayed": ties,
        "sign_share_differing": float(sign_off.float().mean()),
        "share_above_sign_floor": float(clear.float().mean()),
        "gradient_s": times, "median_gradient_s": sec,
    }), flush=True)
    return want, sec


def _backward_conv_calls(torch, name, exp, batch):
    """Phase 12: where a backward's error comes from. One loss and gradient
    (the image and every weight; the training loss) at ``batch`` records the
    inputs of each ``conv_t_pair`` (the transposed convolutions) and each
    ``_filter_grad`` (cuDNN's wgrad) call; each call is then run again in
    float32 through kernel 1 and through cuDNN (deterministic flags, as in
    training) and in float64 on the card, and the distances of each output
    from float64 (relative to its max) are printed with the names of the
    kernels the profiler saw cuDNN run. One JSON line."""
    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.ops.kernels import vdp_conv as V
    from supernet_tpu_torch.profiling import _device_events

    cfg = exp.model
    state, _ = T.create_train_state(_he_params(torch, cfg), exp.train, "cuda")
    x, y_flat = _attack_batch(torch, cfg, batch, exp.attack.targeted, "cuda")
    x.requires_grad_()
    dgrads, wgrads = [], []
    pair, fgrad = V.conv_t_pair, V._filter_grad

    def rec_pair(g1, g2, w, precision="highest"):
        dgrads.append((g1.detach().clone(), None if g2 is None else g2.detach().clone(),
                       w.detach().clone()))
        return pair(g1, g2, w, precision)

    def rec_fgrad(xx, g, shape):
        wgrads.append((xx.detach().clone(), g.detach().clone(), tuple(shape)))
        return fgrad(xx, g, shape)

    V.conv_t_pair, V._filter_grad = rec_pair, rec_fgrad
    try:
        loss, _ = T.loss_fn(state.params, x, y_flat, cfg, exp.train)
        torch.autograd.grad(loss, [x] + T.leaves(state.params))
    finally:
        V.conv_t_pair, V._filter_grad = pair, fgrad
    del loss, state

    def names(fn):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted({e.name[:90] for e in _device_events(prof)})

    rows_d, rows_w = [], []
    with torch.inference_mode():
        for g1, g2, w in dgrads:
            k = V.conv_t_pair(g1, g2, w)
            c = (V._conv_t(g1, w), None if g2 is None else V._conv_t(g2, w * w))
            r = V.conv_t_pair_plain(g1.double(), None if g2 is None else g2.double(),
                                    w.double())
            row = {"shape": list(g1.shape) + [w.shape[2]]}
            for tag, out in (("kernel", k), ("cudnn", c)):
                row[tag] = [None if o is None else _max_rel(torch, o.double(), ref)
                            for o, ref in zip(out, r)]
            row["cudnn_kernels"] = names(lambda: (V._conv_t(g1, w), None if g2 is None
                                                  else V._conv_t(g2, w * w)))
            rows_d.append(row)
        for xx, g, shape in wgrads:
            c = V._filter_grad(xx, g, shape)
            r = V._filter_grad(xx.double(), g.double(), shape)
            rows_w.append({"shape": list(xx.shape) + [shape[3]],
                           "cudnn": _max_rel(torch, c.double(), r),
                           "cudnn_kernels": names(lambda: V._filter_grad(xx, g, shape))})
    worst = {tag: max(v for row in rows_d for v in row[tag] if v is not None)
             for tag in ("kernel", "cudnn")}
    worst["wgrad_cudnn"] = max(row["cudnn"] for row in rows_w)
    print(json.dumps({"backward_conv_calls": name, "batch": batch,
                      "max_rel_err_vs_float64": worst, "dgrad": rows_d, "wgrad": rows_w}),
          flush=True)
    return worst


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
        want = _scaled(_per_step(cfg, batch), steps)
        if mode == "fgsm":
            want = _scaled(_summed(_per_gradient(cfg, batch),
                                   _scaled(_per_step(cfg, batch), 2)), steps)
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
    worst_p, _, share = _serving_close(
        f"run_adversarial {name}: the card's forward of its adversarial images against "
        "the CPU's", probs, sigma, ref_p, ref_s)
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


def _serving_close(name, probs, sigma, ref_p, ref_s):
    """Hold a card answer to a reference within the serving limits (probs
    absolute, sigma by the share of elements beyond SERVE_SIGMA_RTOL of its
    max); returns (probs error, sigma's max relative error, that share)."""
    import numpy as np

    if probs.shape != ref_p.shape or not (np.isfinite(probs).all() and np.isfinite(sigma).all()):
        _die(f"{name}: shape {probs.shape} (expected {ref_p.shape}) or non-finite values")
    worst_p = float(np.abs(probs - ref_p).max())
    d = np.abs(sigma - ref_s) / max(float(np.abs(ref_s).max()), 1e-30)
    share = float((d > SERVE_SIGMA_RTOL).mean())
    if worst_p > SERVE_PROBS_ATOL or share > SERVE_SIGMA_SHARE:
        _die(f"{name}: probs differ by {worst_p:.3e}; sigma beyond {SERVE_SIGMA_RTOL} "
             f"relative on {share:.3%} of the elements")
    return worst_p, float(d.max()), share


@contextlib.contextmanager
def _kernels_fed_float32(torch, on: bool):
    """With ``on``, the moment ops' boundary before the kernels took bf16:
    ``ops.moments`` upcasts bf16 moments before kernels 1 and 2 and casts
    their outputs back (its float16 rule widened to bf16), so every kernel
    computes on float32 tensors behind conversion kernels. Phase 16's
    baseline, run in the same call as the bf16 kernels."""
    from supernet_tpu_torch.ops import moments as M

    before = M._HALF
    if on:
        M._HALF = (torch.bfloat16, torch.float16)
    try:
        yield
    finally:
        M._HALF = before


def _bf16(torch, smi):
    """Phase 16. Returns {config: {"float32" | "bfloat16" |
    "bfloat16_upcast": train launches}}; "bfloat16_upcast" is bf16 with the
    kernels fed float32 (:func:`_kernels_fed_float32`)."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS
    from supernet_tpu_torch.profiling import act_dtype, profile_serving, profile_train_step
    from supernet_tpu_torch.serving import InferenceSession

    out = {}
    for name, exp, batch, steps in (("hippocampus", HIPPOCAMPUS, 20, 5), ("brats", BRATS, 2, 2)):
        cfg, tc = exp.model, exp.train
        params = _he_params(torch, cfg)
        rng = np.random.default_rng(SEED)
        s, o, c = cfg.image_size, cfg.out_size, cfg.in_channels
        xs = rng.normal(0.0, 1.0, (batch, s, s, c)).astype(np.float32)
        x = rng.normal(0.0, 1.0, (steps, batch, s, s, c)).astype(np.float32)
        y = rng.integers(0, cfg.n_classes, (steps, batch, o, o)).astype(np.int32)
        serve, train, prof = {}, {}, {}
        for dt in ("float32", "bfloat16", "bfloat16_upcast"):
            with act_dtype(dt.split("_")[0]), _kernels_fed_float32(torch, dt.endswith("upcast")):
                gpu = InferenceSession(params, cfg, batch, device="cuda").warmup()
                _zero_launches()
                answer = gpu.predict(xs)
                serve[dt] = (answer, _read_launches())
                state, _ = T.create_train_state(params, tc, "cuda")
                step = T.make_train_step(cfg, tc)
                torch.cuda.synchronize()
                _zero_launches()
                losses = []
                for i in range(steps):
                    state, m = step(state, x[i], y[i])
                    losses.append(float(m.loss))
                launches = _read_launches()
                loss, _ = T.loss_fn(state.params, torch.from_numpy(x[0]).cuda(),
                                    torch.from_numpy(y[0]).cuda(), cfg, tc)
                grads = torch.autograd.grad(loss, T.leaves(state.params))
                dtypes = sorted({str(t.dtype) for t in grads} |
                                {str(t.dtype) for t in T.leaves(state.params)} | {str(loss.dtype)})
                train[dt] = (losses, launches, dtypes)
                del state, grads, loss
                prof[dt] = {"serve": profile_serving(name, batch),
                            "train": profile_train_step(name, batch)}
        with act_dtype("bfloat16"):
            cpu16 = InferenceSession(params, cfg, batch, device="cpu").predict(xs)
        (p32, _), l32 = serve["float32"]
        (p16, s16), l16 = serve["bfloat16"]
        (pu, su), lu = serve["bfloat16_upcast"]
        if l16 != l32 or train["bfloat16"][1] != train["float32"][1]:
            _die(f"bf16 {name}: launches {l16} / {train['bfloat16'][1]} differ from "
                 f"float32's {l32} / {train['float32'][1]}")
        if lu != l32 or train["bfloat16_upcast"][1] != train["float32"][1]:
            _die(f"bf16 {name}, kernels fed float32: launches {lu} / "
                 f"{train['bfloat16_upcast'][1]} differ from float32's")
        # the kernels round once where the casts rounded: the same answer
        if not (np.array_equal(p16, pu) and np.array_equal(s16, su)):
            _die(f"bf16 {name}: the answer with bf16 kernels differs from the one "
                 f"with the kernels fed float32 (probs {float(np.abs(p16 - pu).max()):.3e}, "
                 f"sigma {float(np.abs(s16 - su).max()):.3e})")
        upcast_loss_err = max(abs(a - b) / abs(b) for a, b in
                              zip(train["bfloat16"][0], train["bfloat16_upcast"][0]))
        if not upcast_loss_err <= BF16_LOSS_RTOL:
            _die(f"bf16 {name}: losses {train['bfloat16'][0]} against the kernels fed "
                 f"float32 {train['bfloat16_upcast'][0]}")
        agree = {}
        for ref_name, ref in (("card_float32", p32), ("cpu_bfloat16", cpu16[0])):
            err = float(np.abs(p16 - ref).max())
            agree[ref_name] = (err, float(np.mean(p16.argmax(-1) == ref.argmax(-1))))
            if not (np.isfinite(p16).all() and np.isfinite(s16).all()) or \
                    err > BF16_PROBS_ATOL or not agree[ref_name][1] > BF16_AGREE:
                _die(f"bf16 {name} serving against {ref_name}: probs {err:.3e} "
                     f"(limit {BF16_PROBS_ATOL}), argmax agreement {agree[ref_name][1]:.5f}")
        l16s, l32s = train["bfloat16"][0], train["float32"][0]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l16s, l32s))
        if not all(math.isfinite(v) for v in l16s) or not loss_err <= BF16_LOSS_RTOL \
                or train["bfloat16"][2] != ["torch.float32"]:
            _die(f"bf16 {name} training: losses {l16s} against float32's {l32s} "
                 f"({loss_err:.3e} relative), dtypes {train['bfloat16'][2]}")
        keys = ("request_ms_median", "step_ms_median", "device_ms_per_request",
                "device_ms_per_step", "peak_memory_bytes", "idle_share",
                "conversion_kernels_per_request", "conversion_kernels_per_step")
        print(json.dumps({
            "bf16": name, "card": smi, "batch": batch, "steps": steps,
            "serve_launches": l16, "train_launches": train["bfloat16"][1],
            "probs_max_abs_err_vs_card_float32": agree["card_float32"][0],
            "argmax_agreement_vs_card_float32": agree["card_float32"][1],
            "probs_max_abs_err_vs_cpu_bfloat16": agree["cpu_bfloat16"][0],
            "argmax_agreement_vs_cpu_bfloat16": agree["cpu_bfloat16"][1],
            "losses": l16s, "float32_losses": l32s, "loss_max_rel_err_vs_float32": loss_err,
            "answer_equal_to_kernels_fed_float32": True,
            "loss_max_rel_err_vs_kernels_fed_float32": upcast_loss_err,
            "dtypes_of_params_grads_loss": train["bfloat16"][2],
            "profiles": {dt: {mode: {k: v for k, v in r.items() if k in keys}
                              for mode, r in pr.items()} for dt, pr in prof.items()},
        }), flush=True)
        out[name] = {dt: t[1] for dt, t in train.items()}
    return out


def _predict_per_chunk(torch, sess, x):
    """``InferenceSession.predict`` as it was before it enqueued a request
    whole: each chunk copied to the card from pageable memory, run, and its
    outputs copied back with a synchronisation per chunk."""
    import numpy as np

    bs, outs = sess.batch_size, ([], [])
    for i in range(0, len(x), bs):
        chunk = x[i : i + bs]
        b = len(chunk)
        if b < bs:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - b, axis=0)])
        with torch.inference_mode():
            answer = sess._forward(torch.from_numpy(np.ascontiguousarray(chunk)).to(sess.device))
        for out, a in zip(outs, answer):
            out.append(a[:b].cpu().numpy())
    return np.concatenate(outs[0]), np.concatenate(outs[1])


def _serving_rest(torch, smi, tmp):
    """Phase 17. Returns the launches of one ensemble chunk."""
    import io

    import numpy as np

    from supernet_tpu_torch import cli
    from supernet_tpu_torch.checkpoint import save_params_npz
    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.serving import EnsembleSession, InferenceSession

    cfg, batch = HIPPOCAMPUS.model, 20
    members = [_he_params(torch, cfg, seed) for seed in (SEED, SEED + 1, SEED + 2)]
    x = np.random.default_rng(SEED).normal(
        0.0, 1.0, (45, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(np.float32)
    ens = EnsembleSession(members, cfg, batch, device="cuda").warmup()
    _zero_launches()
    pe, se = ens.predict(x[:batch])
    launches = _read_launches()
    # one member-stacked forward serves the three members (phase 19)
    want = _expected_launches(cfg, batch, 0, 1, members=3)
    if launches != want:
        _die(f"EnsembleSession: kernel launches {launches}, expected {want}")
    ref = EnsembleSession(members, cfg, batch, device="cpu").predict(x[:batch])
    ens_err = _serving_close("EnsembleSession against the CPU", pe, se, *ref)

    # cli export in process, on its default device; model.pt2 on the CPU
    npz = os.path.join(tmp, "member0.npz")
    save_params_npz(npz, members[0])
    out = os.path.join(tmp, "export")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export", "--config", "hippocampus", "--checkpoint", npz,
                       "--out-dir", out, "--export-batch-size", str(batch)])
    export_s = time.perf_counter() - t0
    meta = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or sorted(os.listdir(out)) != ["export_meta.json", "model.pt2", "params.npz"] \
            or meta["batch_size"] != batch or meta["files"][0] != "model.pt2":
        _die(f"cli export: rc {rc}, files {sorted(os.listdir(out))}, meta {meta}")
    program = torch.export.load(os.path.join(out, "model.pt2")).module()
    with torch.no_grad():
        pp, sp = (t.numpy() for t in program(torch.from_numpy(x[:batch])))
    single = InferenceSession(members[0], cfg, batch, device="cuda").warmup()
    ps, ss = single.predict(x[:batch])
    export_err = _serving_close("model.pt2 on the CPU against the card's session", ps, ss, pp, sp)

    # one request of 45 images: the whole request enqueued against a
    # synchronisation per chunk, in turns (before, after, after, before)
    times = {"per_chunk": [], "enqueued": []}
    answers = {}
    single.predict(x)  # the session's host buffers are allocated once
    _predict_per_chunk(torch, single, x)
    for _ in range(3):
        for kind in ("per_chunk", "enqueued", "enqueued", "per_chunk"):
            t0 = time.perf_counter()
            answers[kind] = (_predict_per_chunk(torch, single, x) if kind == "per_chunk"
                             else single.predict(x))
            times[kind].append(time.perf_counter() - t0)
    if not all(np.array_equal(a, b) for a, b in zip(answers["per_chunk"], answers["enqueued"])):
        _die("InferenceSession: the enqueued request is not bit-equal to the per-chunk one")
    print(json.dumps({
        "serving_rest": "EnsembleSession (3 members), cli export, the 45-image request",
        "card": smi, "batch": batch, "ensemble_launches": launches,
        "ensemble_probs_max_abs_err_vs_cpu": ens_err[0],
        "ensemble_sigma_share_beyond_rtol": ens_err[2],
        "export_meta": meta, "export_s": export_s,
        "export_probs_max_abs_err_vs_card": export_err[0],
        "export_sigma_max_rel_err_vs_card": export_err[1],
        "export_sigma_share_beyond_rtol": export_err[2],
        "request_45_s_per_chunk_sync": times["per_chunk"],
        "request_45_s_enqueued": times["enqueued"],
        "request_45_median_s_per_chunk_sync": statistics.median(times["per_chunk"]),
        "request_45_median_s_enqueued": statistics.median(times["enqueued"]),
    }), flush=True)
    return launches


def _eval_cli(torch, tmp):
    """Phase 15. Returns the launches of ``cli study``."""
    from supernet_tpu_torch import cli
    from supernet_tpu_torch.configs import HIPPOCAMPUS

    exp, batch, n = HIPPOCAMPUS, 20, 40
    cfg = exp.model
    grad, fwd = _per_gradient(cfg, batch), _expected_launches(cfg, batch, 0, 1)
    step = _per_step(cfg, batch)
    batches = n // batch
    out = os.path.join(tmp, "study")
    torch.cuda.synchronize()
    _zero_launches()
    rc = cli.main(["study", "--config", "hippocampus", "--synthetic", str(n), "--epochs", "1",
                   "--images-n", "2", "--out-dir", out])
    launches = _read_launches()
    sweep_runs = 1 + len(exp.noise_levels) * len(exp.noise_regions)
    want = _summed(
        _scaled(step, batches), _scaled(fwd, batches),  # train: steps, validation
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
    want_adv = _summed(_scaled(grad, batches), _scaled(step, 2 * batches),
                       _scaled(fwd, batches))
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


@contextlib.contextmanager
def _decisions3d(torch, record=None, replay=None):
    """``_decisions`` for the 3-D family: record the discrete choices of the
    forwards run inside (each ReLU's mask, each pool's tap, each sigma clip)
    into ``record``, or make them take the choices of ``replay``. The 3-D
    ops are PyTorch's, so the seams are ``ops.moments3d.vrelu`` and
    ``VMaxPool3d.apply`` (ties checked as in ``_decisions``). Yields the
    count of replayed ties."""
    from supernet_tpu_torch import losses as L
    from supernet_tpu_torch.ops import moments3d as M3

    relu, pool_apply, clip_sigma = M3.vrelu, M3.VMaxPool3d.apply, L.clip_sigma
    queue = iter(replay) if replay is not None else None
    ties = {"relu": 0, "pool": 0, "clip": 0}

    def tie_bound(x):
        return VDP_TOL * float(x.detach().abs().max())

    def vrelu(mu, sigma):
        if queue is None:
            record.append(mu.detach() > 0)
            return relu(mu, sigma)
        mask = next(queue).to(mu.device)
        tie = mask != (mu.detach() > 0)
        if tie.any():
            if float(mu.detach()[tie].abs().max()) > tie_bound(mu):
                _die("3-D: a ReLU mask differs away from mu = 0")
            ties["relu"] += int(tie.sum())
        return torch.where(mask, mu, 0.0), torch.where(mask, sigma, 0.0)

    def pool(mu, sigma):
        if queue is None:
            record.append(M3.vmaxpool3d_plain(mu.detach(), sigma.detach())[2])
            return pool_apply(mu, sigma)
        mx, _, own = M3.vmaxpool3d_plain(mu.detach(), sigma.detach())
        idx = next(queue).to(mu.device)
        pm, ps = M3._pad_even(mu, sigma)
        sel = [idx == k for k in range(8)]
        m = sum(torch.where(q, t, 0.0) for q, t in zip(sel, M3._pool_taps3d(pm)))
        s = sum(torch.where(q, t, 0.0) for q, t in zip(sel, M3._pool_taps3d(ps)))
        tie = own != idx
        if tie.any():
            if float((mx - m.detach())[tie].abs().max()) > tie_bound(mu):
                _die("3-D: a pool tap differs between taps that are not tied")
            ties["pool"] += int(tie.sum())
        return m, s

    def clip(sigma, lo, hi):
        if queue is None:
            record.append((sigma.detach() < lo, sigma.detach() > hi))
            return clip_sigma(sigma, lo, hi)
        below, above = (m.to(sigma.device) for m in next(queue))
        s = sigma.detach()
        tie = (below != (s < lo)) | (above != (s > hi))
        if tie.any():
            near = torch.minimum((s - lo).abs() / abs(lo), (s - hi).abs() / abs(hi))
            if float(near[tie].max()) > CLIP_TIE_RTOL:
                _die("3-D: a sigma clip differs away from its bound")
            ties["clip"] += int(tie.sum())
        return torch.where(above, hi, torch.where(below, lo, sigma))

    M3.vrelu, M3.VMaxPool3d.apply, L.clip_sigma = vrelu, pool, clip
    try:
        yield ties
    finally:
        M3.vrelu, L.clip_sigma = relu, clip_sigma
        del M3.VMaxPool3d.apply


def _he_params3d(torch, cfg, seed=SEED):
    """``init_params3d`` with each w_mu rescaled to He scale (std
    sqrt(2 / fan_in)), for the reason ``_he_params`` gives."""
    from supernet_tpu_torch.models import init_params3d

    params = init_params3d(torch.Generator().manual_seed(seed), cfg, "cpu")
    for p in params.values():
        k, _, _, cin, _ = p["w_mu"].shape
        p["w_mu"] *= math.sqrt(2.0 / (k ** 3 * cin)) / p["w_mu"].std()
    return params


def _cli_json(cli, argv):
    """Run ``cli.main(argv)`` in process; its JSON lines."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        _die(f"cli {' '.join(argv)}: rc {rc}")
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


def _three_d(torch, smi, tmp):
    """Phase 18. Returns the kernel launches over the whole phase."""
    import numpy as np

    from supernet_tpu_torch import cli, profiling
    from supernet_tpu_torch import train as T
    from supernet_tpu_torch import train3d as T3
    from supernet_tpu_torch.checkpoint import save_params_npz
    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.flops import forward_flops3d, train_step_flops3d
    from supernet_tpu_torch.models import forward3d
    from supernet_tpu_torch.serving import InferenceSession

    t_phase = time.perf_counter()
    exp = HIPPOCAMPUS
    cfg = dataclasses.replace(exp.model, out_size=T3.derive_out_size3d(exp.model))
    tc, batch = exp.train, 4
    s, o, c = cfg.image_size, cfg.out_size, cfg.n_classes
    if (s, o, cfg.base_kernels, cfg.depth) != (64, 54, 32, 3):
        _die(f"3-D: hippocampus config {(s, o, cfg.base_kernels, cfg.depth)}")
    params = _he_params3d(torch, cfg)
    rng = np.random.default_rng(SEED)
    x = rng.normal(0.0, 1.0, (batch, s, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, c, (batch, o, o, o)).astype(np.int32)
    torch.cuda.synchronize()
    _zero_launches()

    # forward at batch 4, volume 0 against the CPU
    gpu_params = {k: {n: t.cuda() for n, t in w.items()} for k, w in params.items()}
    with torch.no_grad():
        pg, sg = forward3d(gpu_params, torch.from_numpy(x).cuda(), cfg)
        pc, sc = forward3d(params, torch.from_numpy(x[:1]), cfg)
    pg, sg = pg.cpu().numpy(), sg.cpu().numpy()
    if pg.shape != (batch, o ** 3, c) or not (np.isfinite(pg).all() and np.isfinite(sg).all()):
        _die(f"3-D forward: shape {pg.shape} or non-finite values")
    fwd_err = _serving_close("3-D forward, volume 0 against the CPU", pg[:1], sg[:1],
                             pc.numpy(), sc.numpy())

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        # step-1 loss at batch 4 and gradient on volume 0 against the CPU,
        # the card's ReLU masks, pool taps and clips replayed there
        def loss_of(state, xb, yb):
            dev = state.params["conv_input"]["w_mu"].device
            y1h = T.one_hot_flatten(torch.from_numpy(yb).to(dev), c)
            return T3._loss3d(state.params, torch.from_numpy(xb).to(dev), y1h, cfg, tc)[0]

        gpu, _ = T.create_train_state(params, tc, "cuda")
        cpu, _ = T.create_train_state(params, tc, "cpu")
        with torch.no_grad():
            loss_gpu = float(loss_of(gpu, x, y))
            loss_cpu = float(loss_of(cpu, x, y))
        loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        if not loss_err <= TRAIN_LOSS_RTOL:
            _die(f"3-D training: step-1 loss {loss_gpu} against the CPU's {loss_cpu}")
        choices = []
        with _decisions3d(torch, record=choices):
            g_gpu = torch.autograd.grad(loss_of(gpu, x[:1], y[:1]), T.leaves(gpu.params))
        with _decisions3d(torch, replay=choices) as ties:
            g_cpu = torch.autograd.grad(loss_of(cpu, x[:1], y[:1]), T.leaves(cpu.params))
        worst_g = max(_max_rel(torch, g, r) for g, r in zip(g_gpu, g_cpu))
        if not worst_g <= TRAIN_GRAD_TOL:
            _die(f"3-D training: gradients on volume 0 differ from the CPU's by "
                 f"{worst_g:.3e} of a leaf's max > {TRAIN_GRAD_TOL}")
        del g_gpu, g_cpu, cpu
        step = T3.make_train_step3d(cfg, tc)
        losses = []
        for _ in range(3):
            gpu, m = step(gpu, x, y)
            losses.append(float(m.loss))
        if not all(math.isfinite(v) for v in losses):
            _die(f"3-D training: losses {losses}")
        if abs(losses[0] - loss_gpu) > TRAIN_LOSS_RTOL * abs(loss_gpu):
            _die(f"3-D training: step 1 loss {losses[0]} against its forward's {loss_gpu}")
        del gpu

    # throughput: profiling's train profile (3 warm-up, median of 10, 10
    # traced), remat off and on
    profiles = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        prof = profiling.profile_train_step3d("hippocampus", batch, SEED, remat=remat)
        profiles["remat" if remat else "plain"] = {
            k: prof[k] for k in ("vols_per_s", "step_ms_median", "device_ms_per_step",
                                 "device_busy_ms_per_step", "idle_share",
                                 "peak_memory_bytes", "conv3d_share",
                                 "device_events_per_step", "categories_ms_per_step")}
    flops_step = train_step_flops3d(cfg, batch)

    # the CLI in process, on its default device
    run = os.path.join(tmp, "train3d")
    b = ["--batch-size", str(batch)]
    t0 = time.perf_counter()
    trained = _cli_json(cli, ["train3d", "--synthetic", "12", "--epochs", "1", *b,
                              "--out-dir", run])[-1]
    train_s = time.perf_counter() - t0
    if not os.path.isfile(os.path.join(run, "epoch_0", "state.pt")) or not all(
            math.isfinite(v) for v in trained.values()):
        _die(f"cli train3d: {trained}, files {sorted(os.listdir(run))}")
    ck = ["--checkpoint", run, "--synthetic", str(batch), *b]
    ev = _cli_json(cli, ["eval3d", *ck, "--images-n", "1", "--out-dir",
                         os.path.join(tmp, "eval3d")])[0]
    atk_dir = os.path.join(tmp, "attack3d")
    eps = exp.attack.epsilon
    atk = _cli_json(cli, ["attack3d", *ck, "--max-adv-step", "2", "--images-n", "1",
                          "--out-dir", atk_dir])[0]
    with open(os.path.join(atk_dir, "uncertainty_info.pkl"), "rb") as f:
        adv = pickle.load(f)[2]
    from supernet_tpu_torch.data import synthetic_volumes

    x_eval, _ = synthetic_volumes(cfg, batch, seed=1)  # what attack3d drew
    # the ball and the range exactly, in the attack's own float32 arithmetic
    if adv.shape != x_eval.shape or not (
            np.all(adv >= x_eval - eps) and np.all(adv <= x_eval + eps)
            and adv.min() >= x_eval.min() and adv.max() <= x_eval.max()):
        _die("cli attack3d: an adversarial volume leaves the epsilon-ball or the range")
    cal = _cli_json(cli, ["calibrate3d", *ck, "--out-dir", os.path.join(tmp, "cal3d")])[0]
    sal = _cli_json(cli, ["saliency3d", *ck, "--images-n", "2", "--out-dir",
                          os.path.join(tmp, "sal3d")])[0]
    for name, res, key in (("eval3d", ev, "accuracy"), ("attack3d", atk, "snr_db"),
                           ("calibrate3d", cal, "ece")):
        if not math.isfinite(res[key]):
            _die(f"cli {name}: {key} = {res[key]}")
    if sal["saliency_maps"] != 2:
        _die(f"cli saliency3d: {sal}")

    # predict3d on a non-cube volume (two tiles along D) against the CPU's
    # tiled answer, from the He-scaled parameters in an npz: at the raw init
    # (which the CLI's two train steps barely move) the 3-D activations grow
    # about 2x per layer and the softmax saturates, so no float32 comparison
    # of two implementations is well-posed there (see _he_params)
    npz = os.path.join(tmp, "three_d.npz")
    save_params_npz(npz, params)
    vol = rng.normal(0.0, 1.0, (100, 50, 50)).astype(np.float32)
    vol_path = os.path.join(tmp, "volume.npy")
    np.save(vol_path, vol)
    pred = _cli_json(cli, ["predict3d", "--volume", vol_path, "--checkpoint", npz, *b,
                           "--save-probs", "--out-dir", os.path.join(tmp, "pred3d")])[0]
    norm = (vol - vol.min()) / max(float(vol.max() - vol.min()), 1e-8)
    cpu_sess = InferenceSession(params, cfg, batch_size=2, device="cpu", volumetric=True)
    ref_p, ref_s = cpu_sess.predict_volume(norm, overlap=8)
    pred_err = _serving_close("cli predict3d against the CPU's tiled answer",
                              np.load(pred["probs"]), np.load(pred["sigma"]), ref_p, ref_s)

    # export --volumetric; model.pt2 on the CPU against the card's session
    out = os.path.join(tmp, "export3d")
    meta = _cli_json(cli, ["export", "--volumetric", "--checkpoint", npz,
                           "--export-batch-size", "2", "--out-dir", out])[0]
    if sorted(os.listdir(out)) != ["export_meta.json", "model.pt2", "params.npz"] \
            or meta["output_shape"] != [2, o, o, o, c]:
        _die(f"cli export --volumetric: {meta}")
    program = torch.export.load(os.path.join(out, "model.pt2")).module()
    with torch.no_grad():
        ep, es = (t.numpy() for t in program(torch.from_numpy(x[:2])))
    card = InferenceSession(params, cfg, batch_size=2, device="cuda",
                            volumetric=True).predict(x[:2])
    export_err = _serving_close("model.pt2 on the CPU against the card's 3-D session",
                                card[0], card[1], ep, es)

    launches = _read_launches()
    if any(launches.values()):
        _die(f"3-D: the 2-D kernels were launched in the 3-D phase: {launches}")
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({
        "three_d": "forward3d, train3d, the 3-D CLI (hippocampus 3-D: cube 64, "
                   "base 32, depth 3, out 54, batch 4)",
        "card": smi, "batch": batch, "launches_of_kernels_1_4": launches,
        "forward_gflop_per_volume": forward_flops3d(cfg, 1) / 1e9,
        "train_step_tflop": flops_step / 1e12,
        "forward_probs_max_abs_err_vs_cpu": fwd_err[0],
        "forward_sigma_share_beyond_rtol": fwd_err[2],
        "step1_loss": loss_gpu, "step1_loss_rel_err_vs_cpu_batch4": loss_err,
        "grad_max_rel_err_vs_cpu_volume0": worst_g,
        "grad_share_of_limit": worst_g / TRAIN_GRAD_TOL, "grad_ties_replayed": ties,
        "losses_3_steps": losses,
        "profile": profiles,
        "tflop_per_s_plain": flops_step / (profiles["plain"]["step_ms_median"] / 1e3) / 1e12,
        "cli_train3d": trained, "cli_train3d_s": train_s,
        "cli_eval3d_accuracy": ev["accuracy"], "cli_attack3d_snr_db": atk["snr_db"],
        "cli_calibrate3d_ece": cal["ece"],
        "predict3d": {k: pred[k] for k in ("volume", "class_voxels", "mean_uncertainty")},
        "predict3d_probs_max_abs_err_vs_cpu": pred_err[0],
        "predict3d_sigma_share_beyond_rtol": pred_err[2],
        "export3d_probs_max_abs_err_vs_card": export_err[0],
        "export3d_sigma_share_beyond_rtol": export_err[2],
        "phase_s": phase_s,
    }), flush=True)
    return launches


# ------------------------------------------------------------- phase 19


def _member_choices(choices, k, members):
    """Member ``k``'s share of the discrete choices ``_decisions`` recorded
    in a member-stacked pass: a ReLU mask or pool tap [K*B, ...] gives its
    rows, a clip pair [K, B, ...] its slice."""
    return [tuple(m[k] for m in c) if isinstance(c, tuple)
            else c.unflatten(0, (members, -1))[k] for c in choices]


def _member_kernels(torch):
    """Phase 19, kernels: kernel 1 (with the window sum and the fused ReLU,
    and without it as VDPConv's backward runs its transposed pair) and
    kernel 4, each with a member axis, against their plain versions (the
    single-member plain version member by member) at every layer shape of a
    hippocampus step with K=4 at batch 20 and of a BraTS step with K=2 at
    batch 2, within the single-member checks' limits; the stride-0 input
    (one batch for every member) at hippocampus conv_input against the same
    batch copied per member, bit for bit. Each member launch is timed (CUDA
    events, and device time with the stream held) against K single-member
    launches. Returns {(kernel, config): [ms, k_single_ms, device_ms,
    k_single_device_ms, max_abs_err, max_rel_err]}."""
    import torch.nn.functional as F

    from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS
    from supernet_tpu_torch.ops.kernels import sigma_bwd as S
    from supernet_tpu_torch.ops.kernels import vdp_conv as V
    from supernet_tpu_torch.profiling import device_ms, layer_shapes

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    sums = {}

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    def record(kernel, config, layer, shape, members, errs, run, singles, extra):
        ms, s_ms = _time_ms(torch, run), _time_ms(torch, singles)
        dev, s_dev = device_ms(run), device_ms(singles)
        acc = sums.setdefault((kernel, config), [0.0] * 6)
        for i, v in enumerate((ms, s_ms, dev, s_dev)):
            acc[i] += v
        acc[4], acc[5] = max(acc[4], errs[0]), max(acc[5], errs[1])
        print(json.dumps({
            "member_kernel": kernel, "config": config, "layer": layer,
            "members": members, "shape": shape, "max_abs_err": errs[0],
            "max_rel_err": errs[1], "ms": ms, "k_single_ms": s_ms,
            "device_ms": dev, "k_single_device_ms": s_dev, **extra}), flush=True)

    def rel_errs(got, want, tol, what):
        abs_err = rel_err = 0.0
        for x, r in zip(got, want):
            if r is None:
                continue
            e = float((x - r).abs().max())
            abs_err, rel_err = max(abs_err, e), max(rel_err, e / max(float(r.abs().max()), 1e-30))
        if not rel_err <= tol:
            _die(f"{what} disagrees with its plain version: relative error "
                 f"{rel_err:.3e} > {tol}")
        return abs_err, rel_err

    def member_bf16(config, layer, shape, k_n, mu, sigma, w_mu, w_sigma, g1, g2, t, s_w):
        """The member launches of kernels 1 (both forms) and 4 on bf16
        moments and cotangents: (a) equal to the float32 member launch on
        the upcast inputs, cast; (b) within the single-member checks' limits
        of the plain versions plus one bf16 step; the stride-0 input at
        hippocampus conv_input bit-equal to the copied batch. Device time
        of each bf16 member launch."""
        bf = torch.bfloat16
        mb, sb = mu.to(bf), None if sigma is None else sigma.to(bf)
        g1b, g2b = g1.to(bf), None if g2 is None else g2.to(bf)
        up = (mb.float(), None if sb is None else sb.float())
        what = f"member-axis bf16 {config}/{layer}"
        line = {"member_kernel_bf16": what, "members": k_n, "shape": shape}
        got = V.vdp_conv(mb, sb, w_mu, w_sigma, True, relu_mask=True)
        _equal_on_upcast(torch, what + " vdp_conv", got,
                         V.vdp_conv(*up, w_mu, w_sigma, True, relu_mask=True))
        want = V.vdp_conv_plain(mb, sb, w_mu, w_sigma, True)
        tie = (got[0] > 0) != (want[0] > 0)
        if tie.any() and float(torch.maximum(got[0].float().abs(), want[0].float().abs())[tie]
                               .max()) > VDP_TOL * float(want[0].float().abs().max()):
            _die(f"{what}: a ReLU mask differs away from mu = 0")
        fwd_err = _bf16_errors(torch, what + " vdp_conv", got[:3], want, VDP_TOL,
                               [None, ~tie, None])
        line["vdp_conv"] = {"max_rel_err": fwd_err[1], "relu_ties": int(tie.sum()),
                            "device_ms": device_ms(
                                lambda: V.vdp_conv(mb, sb, w_mu, w_sigma, True))}
        if config == "hippocampus" and layer == "conv_input":
            x = mb.unflatten(0, (k_n, -1))[0]
            shared = V.vdp_conv(x.expand(k_n, *x.shape), None, w_mu, w_sigma, True)
            copied = V.vdp_conv(x.repeat(k_n, 1, 1, 1), None, w_mu, w_sigma, True)
            if not all(torch.equal(a, b) for a, b in zip(shared, copied)):
                _die(f"{what}: the stride-0 bf16 input differs from the copied batch")
            line["stride0_bit_equal_to_copied_batch"] = True
        got = V.conv_t_pair(g1b, g2b, w_mu)
        _equal_on_upcast(torch, what + " dgrad", got,
                         V.conv_t_pair(g1b.float(), None if g2b is None else g2b.float(), w_mu))
        d_err = _bf16_errors(torch, what + " dgrad", got, V.conv_t_pair_plain(g1b, g2b, w_mu),
                             VDP_TOL)
        line["vdp_conv_dgrad"] = {"max_rel_err": d_err[1], "device_ms": device_ms(
            lambda: V.conv_t_pair(g1b, g2b, w_mu))}
        got = S.winsum_spread_bwd(g1b, t, s_w, 3)
        _equal_on_upcast(torch, what + " sigma_bwd", got,
                         S.winsum_spread_bwd(g1b.float(), t, s_w, 3))
        s_err = _bf16_errors(torch, what + " sigma_bwd", got,
                             S.winsum_spread_bwd_plain(g1b, t, s_w, 3), SIGMA_BWD_TOL)
        line["sigma_bwd"] = {"max_rel_err": s_err[1], "device_ms": device_ms(
            lambda: S.winsum_spread_bwd(g1b, t, s_w, 3))}
        for kernel in ("vdp_conv", "vdp_conv_dgrad", "sigma_bwd"):
            acc = sums.setdefault((kernel + "_bf16", config), [0.0, 0.0])
            acc[0] += line[kernel]["device_ms"]
            acc[1] = max(acc[1], line[kernel]["max_rel_err"])
        line["equal_to_float32_on_upcast"] = True
        print(json.dumps(line), flush=True)

    for config, cfg, batch, k_n in (("hippocampus", HIPPOCAMPUS.model, 20, 4),
                                    ("brats", BRATS.model, 2, 2)):
        for layer, (_, h, w, cin), cout in layer_shapes(cfg)[0]:
            has_sigma = layer != "conv_input"
            shape = [batch, h, w, cin, cout, 3]
            mu = randn(k_n * batch, h, w, cin)
            sigma = 0.05 * randn(k_n * batch, h, w, cin).abs() if has_sigma else None
            w_mu, w_sigma = 0.1 * randn(k_n, 3, 3, cin, cout), -4.0 + randn(k_n, cout)
            mus = mu.unflatten(0, (k_n, -1))
            sgs = None if sigma is None else sigma.unflatten(0, (k_n, -1))
            what = f"member-axis vdp_conv {config}/{layer}"
            with torch.inference_mode():
                got = V.vdp_conv(mu, sigma, w_mu, w_sigma, fuse_relu=True)
                want = V.vdp_conv_plain(mu, sigma, w_mu, w_sigma, fuse_relu=True)
                abs_err, rel_err, flips = _vdp_errors(torch, got, want, True, VDP_TOL)
                if not rel_err <= VDP_TOL:
                    _die(f"{what} disagrees with its plain version: relative error "
                         f"{rel_err:.3e} > {VDP_TOL}")
                plan = V.plan(batch, h, w, cin, cout, 3, k_n, _sms())
                record("vdp_conv", config, layer, shape, k_n, (abs_err, rel_err),
                       lambda: V.vdp_conv(mu, sigma, w_mu, w_sigma, True),
                       lambda: [V.vdp_conv(mus[i], None if sgs is None else sgs[i],
                                           w_mu[i], w_sigma[i], True) for i in range(k_n)],
                       {"relu_ties": flips, "path": plan.path, "splits": plan.splits,
                        "blocks": plan.blocks})
                if config == "hippocampus" and layer == "conv_input":
                    # one batch for every member: the serving and eval case
                    x = mus[0]
                    shared = V.vdp_conv(x.expand(k_n, *x.shape), None, w_mu, w_sigma, True)
                    copied = V.vdp_conv(x.repeat(k_n, 1, 1, 1), None, w_mu, w_sigma, True)
                    if not all(torch.equal(a, b) for a, b in zip(shared, copied)):
                        _die("member-axis vdp_conv: the stride-0 input differs from "
                             "the same batch copied per member")
                    errs = _vdp_errors(torch, shared, V.vdp_conv_plain(
                        x.expand(k_n, *x.shape), None, w_mu, w_sigma, True), True, VDP_TOL)
                    if not errs[1] <= VDP_TOL:
                        _die(f"member-axis vdp_conv, stride-0 input: {errs[1]:.3e}")
                    record("vdp_conv_shared_input", config, layer, shape, k_n, errs[:2],
                           lambda: V.vdp_conv(x.expand(k_n, *x.shape), None, w_mu,
                                              w_sigma, True),
                           lambda: [V.vdp_conv(x, None, w_mu[i], w_sigma[i], True)
                                    for i in range(k_n)],
                           {"member_stride": 0, "bit_equal_to_copied_batch": True})

                g1 = randn(k_n * batch, h - 2, w - 2, cout)
                g2 = randn(k_n * batch, h - 2, w - 2, cout) if has_sigma else None
                g1s = g1.unflatten(0, (k_n, -1))
                g2s = None if g2 is None else g2.unflatten(0, (k_n, -1))
                errs = rel_errs(V.conv_t_pair(g1, g2, w_mu),
                                V.conv_t_pair_plain(g1, g2, w_mu), VDP_TOL,
                                f"member-axis vdp_conv dgrad {config}/{layer}")
                dplan = V.plan(batch, h + 2, w + 2, cout, cin, 3, k_n, _sms())
                record("vdp_conv_dgrad", config, layer, shape, k_n, errs,
                       lambda: V.conv_t_pair(g1, g2, w_mu),
                       lambda: [V.conv_t_pair(g1s[i], None if g2s is None else g2s[i],
                                              w_mu[i]) for i in range(k_n)],
                       {"sigma": has_sigma, "path": dplan.path, "splits": dplan.splits})

                t = 10.0 * randn(k_n * batch, h - 2, w - 2).abs()
                s_w = F.softplus(randn(k_n, cout) - 4.0)
                ts = t.unflatten(0, (k_n, -1))
                got = S.winsum_spread_bwd(g1, t, s_w, 3)
                again = S.winsum_spread_bwd(g1, t, s_w, 3)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    _die(f"member-axis sigma_bwd {config}/{layer}: two runs differ")
                errs = rel_errs(got, S.winsum_spread_bwd_plain(g1, t, s_w, 3), SIGMA_BWD_TOL,
                                f"member-axis sigma_bwd {config}/{layer}")
                splan = S.plan(batch, h - 2, w - 2, cout, 3, k_n, _sms())
                record("sigma_bwd", config, layer, [batch, h - 2, w - 2, cout, 3], k_n, errs,
                       lambda: S.winsum_spread_bwd(g1, t, s_w, 3),
                       lambda: [S.winsum_spread_bwd(g1s[i], ts[i], s_w[i], 3)
                                for i in range(k_n)],
                       {"path": splan.path, "blocks_per_member": splan.blocks,
                        "same_bits_in_two_runs": True})
                member_bf16(config, layer, shape, k_n, mu, sigma, w_mu, w_sigma, g1, g2,
                            t, s_w)
    return sums


def _ensemble_train(torch, smi, name, exp, batch, k_n, steps, modes):
    """Phase 19, training: ``make_ensemble_train_step`` at full width with
    K members from He-scaled parameters seeded SEED + k. The step-1
    gradients of the member-stacked loss against each member's single-model
    gradients on the card with the stacked pass's ReLU masks, pool taps and
    clips replayed (``_decisions``, TRAIN_GRAD_TOL); then ``steps`` steps in
    each of ``modes`` against the single-model steps of every member (losses
    within TRAIN_LOSS_RTOL, parameters within 2 * lr * steps), with the
    launches of each counted run: a vmap step launches what one
    single-model step does (its split-K reduces planned for K members), an
    unroll step K times that. Returns the vmap run's launches per step."""
    import numpy as np

    from supernet_tpu_torch import train as T

    cfg, tc = exp.model, exp.train
    members = [_he_params(torch, cfg, SEED + k) for k in range(k_n)]
    rng = np.random.default_rng(SEED + 19)
    s, o = cfg.image_size, cfg.out_size
    x = rng.normal(0.0, 1.0, (steps, k_n, batch, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (steps, k_n, batch, o, o)).astype(np.int32)
    seeds = np.arange(k_n) + tc.seed

    def states():
        return [T.create_train_state(p, tc, "cuda")[0] for p in members]

    stacked = T.stack_trees(states())
    xg, yg = torch.from_numpy(x[0]).cuda(), torch.from_numpy(y[0]).cuda()
    y1 = T.one_hot_flatten(yg.flatten(0, 1), cfg.n_classes).unflatten(0, (k_n, -1))
    choices = []
    with _decisions(torch, record=choices):
        loss, _ = T._members_loss(stacked.params, xg, y1, cfg, tc)
        g_stack = torch.autograd.grad(loss.sum(), T.leaves(stacked.params))
        loss = loss.detach()
    del stacked
    singles = states()
    worst_g = loss1_err = 0.0
    ties_all = {"relu": 0, "pool": 0, "clip": 0}
    for k in range(k_n):
        with _decisions(torch, replay=_member_choices(choices, k, k_n)) as ties:
            lk, _ = T.loss_fn(singles[k].params, xg[k], yg[k], cfg, tc)
            gk = torch.autograd.grad(lk, T.leaves(singles[k].params))
        for key in ties_all:
            ties_all[key] += ties[key]
        lk = float(lk.detach())
        loss1_err = max(loss1_err, abs(float(loss[k]) - lk) / abs(lk))
        for a, r in zip(g_stack, gk):
            worst_g = max(worst_g, _max_rel(torch, a[k], r))
    del g_stack, choices
    if not worst_g <= TRAIN_GRAD_TOL or not loss1_err <= TRAIN_LOSS_RTOL:
        _die(f"{name} ensemble: the member-stacked step-1 loss / gradients differ from "
             f"the single-model ones by {loss1_err:.3e} / {worst_g:.3e} of a leaf's max")

    per_single = _expected_launches(cfg, batch, 1, 0)
    per_vmap = _expected_launches(cfg, batch, 1, 0, members=k_n)
    one = T.make_train_step(cfg, tc)
    single_losses = np.zeros((steps, k_n))
    for i in range(steps):
        for k in range(k_n):
            singles[k], m = one(singles[k], x[i][k], y[i][k])
            single_losses[i, k] = float(m.loss)
    out = {"ensemble_training": name, "card": smi, "members": k_n, "batch": batch,
           "steps": steps, "step1_loss_max_rel_err": loss1_err,
           "step1_grad_max_rel_err": worst_g,
           "step1_grad_share_of_limit": worst_g / TRAIN_GRAD_TOL,
           "grad_ties_replayed": ties_all, "single_losses": single_losses.tolist(),
           "launches_per_single_step": per_single}
    limit = 2.0 * tc.lr * steps
    for mode in modes:
        state = T.stack_trees(states())
        step = T.make_ensemble_train_step(cfg, tc, member_mode=mode)
        torch.cuda.synchronize()
        _zero_launches()
        losses = []
        for i in range(steps):
            state, m = step(state, x[i], y[i], seeds)
            losses.append(m.loss.cpu().numpy())
        launches = _read_launches()
        want = _scaled(per_vmap if mode == "vmap" else per_single,
                       steps * (1 if mode == "vmap" else k_n))
        if launches != want:
            _die(f"{name} ensemble ({mode}): kernel launches {launches} in {steps} steps, "
                 f"expected {want}")
        losses = np.array(losses)
        loss_err = float((np.abs(losses - single_losses) / np.abs(single_losses)).max())
        param_err = max(float((a.detach()[k] - b.detach()).abs().max())
                        for k in range(k_n)
                        for a, b in zip(T.leaves(state.params), T.leaves(singles[k].params)))
        if not loss_err <= TRAIN_LOSS_RTOL or not param_err <= limit:
            _die(f"{name} ensemble ({mode}): losses {loss_err:.3e} relative / parameters "
                 f"{param_err:.3e} from the single-model steps (limits {TRAIN_LOSS_RTOL}, "
                 f"{limit:.3e})")
        out[mode] = {"launches": launches, "losses": losses.tolist(),
                     "loss_max_rel_err_vs_single": loss_err,
                     "param_max_abs_err_vs_single": param_err, "param_limit": limit}
        del state
    print(json.dumps(out), flush=True)
    return per_vmap


def _ensemble_profiles(torch, smi):
    """Phase 19, the member-step times of the three ways to train K=4
    hippocampus members at batch 20 (``profiling.ensemble_step_runner``):
    wall time from 10 steps of each taken in turns (vmap, unroll,
    sequential, sequential, unroll, vmap; the host's speed moves between
    calls), device time and busy share from 3 traced steps, peak memory as
    the mode's own resident tensors plus its step's transient; and a
    sequential member's start-up in this warm process: its parameters, state
    and first step beyond a steady step. These are the constants of
    ``ensemble.choose_ensemble_mode``."""
    import numpy as np

    from supernet_tpu_torch import profiling
    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.configs import HIPPOCAMPUS

    modes, k_n = ("vmap", "unroll", "sequential"), 4
    runners, resident = {}, {}
    for mode in modes:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        runners[mode] = profiling.ensemble_step_runner("hippocampus", 20, SEED, k_n, mode)
        for _ in range(3):
            runners[mode]()
        resident[mode] = torch.cuda.memory_allocated() - before
    times = {mode: [] for mode in modes}
    for mode in modes + modes[::-1]:
        for _ in range(5):
            t0 = time.perf_counter()
            runners[mode]()
            times[mode].append(time.perf_counter() - t0)
    rows = {}
    for mode in modes:
        rest = torch.cuda.memory_allocated()
        r = profiling._profile(runners[mode], "step", steps=3)
        step_ms = 1e3 * statistics.median(times[mode])
        rows[mode] = {
            "step_ms_median": step_ms, "member_step_ms": step_ms / k_n,
            "step_ms_runs": [1e3 * t for t in times[mode]],
            "device_ms_per_step": r["device_ms_per_step"],
            "member_device_ms": r["device_ms_per_step"] / k_n,
            "device_busy_ms_per_step": r["device_busy_ms_per_step"],
            "idle_share": 1.0 - r["device_busy_ms_per_step"] / step_ms,
            "peak_memory_bytes": resident[mode] + r["peak_memory_bytes"] - rest,
            "device_events_per_step": r["device_events_per_step"]}
    runners.clear()
    seq = rows["sequential"]["member_step_ms"] / 1e3
    cfg, tc = HIPPOCAMPUS.model, HIPPOCAMPUS.train
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(0, 1, (20, cfg.image_size, cfg.image_size, 1))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 3, (20, cfg.out_size, cfg.out_size))
                         .astype(np.int32)).cuda()
    step = T.make_train_step(cfg, tc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = T.create_train_state(_he_params(torch, cfg, SEED + 99), tc, "cuda")[0]
    step(state, x, y)
    torch.cuda.synchronize()
    startup = time.perf_counter() - t0 - seq
    best = min(("vmap", "unroll"), key=lambda m: rows[m]["member_step_ms"])
    line = {"ensemble_modes": "hippocampus, K=4, batch 20", "card": smi, **rows,
            "sequential_step_s": seq, "one_program_mode": best,
            "one_program_step_ratio": (rows[best]["member_step_ms"]
                                       / rows["sequential"]["member_step_ms"]),
            "member_startup_s": startup}
    print(json.dumps(line), flush=True)
    return line


def _ensemble_cli(torch, tmp):
    """Phase 19, the CLI: ``train --ensemble 3 --ensemble-mode vmap`` on 60
    synthetic images for 2 epochs (the launches of 6 steps and 6 validation
    batches of one member-stacked pass each), then ``eval --checkpoint
    member_0,member_1,member_2``, whose launches are those of ``eval`` of one
    member (the members served together)."""
    from supernet_tpu_torch import checkpoint as ckpt
    from supernet_tpu_torch import cli
    from supernet_tpu_torch.configs import HIPPOCAMPUS

    cfg = HIPPOCAMPUS.model
    out = os.path.join(tmp, "ensemble")
    torch.cuda.synchronize()
    _zero_launches()
    line = _cli_json(cli, ["train", "--config", "hippocampus", "--synthetic", "60",
                           "--epochs", "2", "--ensemble", "3", "--ensemble-mode", "vmap",
                           "--out-dir", out])[-1]
    launches = _read_launches()
    want = _expected_launches(cfg, 20, 6, 6, members=3)
    dirs = [os.path.join(out, f"member_{k}") for k in range(3)]
    if sorted(line) != ["checkpoint_arg", "dirs", "final", "members", "mode"] \
            or line["mode"] != "vmap" or line["dirs"] != dirs or launches != want:
        _die(f"cli train --ensemble 3: {line}, launches {launches}, expected {want}")
    for d, final in zip(dirs, line["final"]):
        if ckpt.latest_epoch(d) != 1 or not os.path.isfile(
                os.path.join(d, "Related_hyperparameters.txt")) \
                or not all(math.isfinite(v) for v in final.values()):
            _die(f"cli train --ensemble 3: {d} {final}")
    evals = {}
    for what, ckpts in (("one", dirs[0]), ("three", line["checkpoint_arg"])):
        _zero_launches()
        evals[what] = _cli_json(cli, ["eval", "--config", "hippocampus", "--synthetic",
                                      "20", "--checkpoint", ckpts, "--out-dir",
                                      os.path.join(tmp, f"ensemble_eval_{what}")])[-1]
        evals[what + "_launches"] = _read_launches()
    ev, ev_launches = evals["three"], evals["three_launches"]
    forwards = evals["one_launches"]["vdp_conv"] // 10
    want_ev = _expected_launches(cfg, 20, 0, forwards, members=3)
    if forwards < 1 or ev_launches != want_ev or not math.isfinite(ev["accuracy"]):
        _die(f"cli eval of 3 members: launches {ev_launches}, expected {want_ev} "
             f"(one checkpoint's forwards: {forwards}); {ev}")
    return {"cli_train": line, "cli_train_launches": launches,
            "cli_eval_accuracy": ev["accuracy"], "cli_eval_launches": ev_launches}


def _ensemble_session(torch):
    """Phase 19, serving: a 3-member EnsembleSession chunk at hippocampus
    batch 20 launches one forward's kernels (phase 17's member loop launched
    three forwards' worth); its mixture against the mixture of the members'
    own sessions on the card (the serving limits). Returns its launches."""
    import numpy as np

    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.serving import EnsembleSession, InferenceSession, mixture

    cfg, batch = HIPPOCAMPUS.model, 20
    members = [_he_params(torch, cfg, SEED + k) for k in range(3)]
    x = np.random.default_rng(SEED + 19).normal(
        0.0, 1.0, (batch, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(np.float32)
    ens = EnsembleSession(members, cfg, batch, device="cuda").warmup()
    _zero_launches()
    pe, se = ens.predict(x)
    launches = _read_launches()
    want = _expected_launches(cfg, batch, 0, 1, members=3)
    if launches != want:
        _die(f"vmapped EnsembleSession: kernel launches {launches}, expected {want}")
    outs = [InferenceSession(p, cfg, batch, device="cuda").predict(x) for p in members]
    lp, ls = mixture([torch.from_numpy(p) for p, _ in outs],
                     [torch.from_numpy(s) for _, s in outs])
    err = _serving_close("vmapped EnsembleSession against the member loop", pe, se,
                         lp.numpy(), ls.numpy())
    return launches, err


def _ensemble_3d(torch, smi):
    """Phase 19, 3-D: ``make_ensemble_train_step3d`` in vmap at the
    hippocampus 3-D width (cube 64, base 32, depth 3, batch 4), K=2, 2 steps,
    against ``make_train_step3d`` per member on the card; kernels 1-4 read
    0 launches over it."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch import train3d as T3
    from supernet_tpu_torch.configs import HIPPOCAMPUS

    exp = HIPPOCAMPUS
    cfg = dataclasses.replace(exp.model, out_size=T3.derive_out_size3d(exp.model))
    tc, batch, k_n, steps = exp.train, 4, 2, 2
    s, o = cfg.image_size, cfg.out_size
    members = [_he_params3d(torch, cfg, SEED + k) for k in range(k_n)]
    rng = np.random.default_rng(SEED + 19)
    x = rng.normal(0.0, 1.0, (steps, k_n, batch, s, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (steps, k_n, batch, o, o, o)).astype(np.int32)
    torch.cuda.synchronize()
    _zero_launches()
    state = T.stack_trees([T.create_train_state(p, tc, "cuda")[0] for p in members])
    step = T3.make_ensemble_train_step3d(cfg, tc, member_mode="vmap")
    singles = [T.create_train_state(p, tc, "cuda")[0] for p in members]
    one = T3.make_train_step3d(cfg, tc)
    loss_err, times, single_times = 0.0, [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, x[i], y[i], np.arange(k_n) + tc.seed)
        got = m.loss.cpu().numpy()
        times.append(time.perf_counter() - t0)
        for k in range(k_n):
            t0 = time.perf_counter()
            singles[k], mk = one(singles[k], x[i][k], y[i][k])
            lk = float(mk.loss)
            single_times.append(time.perf_counter() - t0)
            loss_err = max(loss_err, abs(float(got[k]) - lk) / abs(lk))
    launches = _read_launches()
    param_err = max(float((a.detach()[k] - b.detach()).abs().max())
                    for k in range(k_n)
                    for a, b in zip(T.leaves(state.params), T.leaves(singles[k].params)))
    limit = 2.0 * tc.lr * steps
    if not loss_err <= TRAIN_LOSS_RTOL or not param_err <= limit:
        _die(f"3-D ensemble: losses {loss_err:.3e} relative / parameters {param_err:.3e} "
             "from make_train_step3d per member")
    if any(launches.values()):
        _die(f"3-D ensemble: the 2-D kernels were launched: {launches}")
    return {"members": k_n, "batch": batch, "cube": s, "steps": steps,
            "loss_max_rel_err_vs_single": loss_err, "param_max_abs_err_vs_single": param_err,
            "param_limit": limit, "step_s": times, "single_step_s": single_times,
            "member_step_ratio": times[-1] / (k_n * statistics.median(single_times[k_n:])),
            "launches": launches}


def _ensembles(torch, smi, tmp):
    """Phase 19. Returns (member kernel sums, vmap launches per hippocampus
    step, the session chunk's launches, the mode profile)."""
    from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS

    t_phase = time.perf_counter()
    parts = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        return out

    sums = timed("kernels", _member_kernels, torch)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        per_step = timed("train_hippocampus", _ensemble_train, torch, smi, "hippocampus",
                         HIPPOCAMPUS, 20, 4, 3, ("vmap", "unroll"))
        timed("train_brats", _ensemble_train, torch, smi, "brats", BRATS, 2, 2, 1, ("vmap",))
        three_d = timed("three_d", _ensemble_3d, torch, smi)
    session, session_err = timed("session", _ensemble_session, torch)
    cli_out = timed("cli", _ensemble_cli, torch, tmp)
    modes = timed("profiles", _ensemble_profiles, torch, smi)
    print(json.dumps({
        "ensembles": "phase 19", "card": smi,
        "vmap_launches_per_step_hippocampus_k4": per_step,
        "session_chunk_launches_k3": session,
        "session_probs_max_abs_err_vs_member_loop": session_err[0],
        "session_sigma_share_beyond_rtol": session_err[2],
        "three_d": three_d, **cli_out,
        "phase_s": time.perf_counter() - t_phase, "parts_s": parts,
    }), flush=True)
    return sums, per_step, session, modes


# ------------------------------------------------------------- phase 20

# the glue fold against the default, the
# tolerances of tests/test_glue_fold.py:147-158: forward rtol 3e-5 / atol
# 3e-6, gradients rtol 2e-4 / atol 2e-5. The JAX test's values are O(1) at
# its tiny width; here the atol is taken relative to each tensor's max
# magnitude, so that it means the same at the published widths.
FOLD_FWD_TOL = (3e-5, 3e-6)
FOLD_GRAD_TOL = (2e-4, 2e-5)


def _tol_ratio(torch, got, want, tol) -> float:
    """max over the elements of |got - want| / (rtol |want| + atol max
    |want|): at most 1 within ``tol = (rtol, atol)``."""
    rtol, atol = tol
    g = got.detach().to(want.device).double()
    w = want.detach().double()
    bound = rtol * w.abs() + atol * max(float(w.abs().max()), 1e-30)
    return float(((g - w).abs() / bound).max())


def _glue_fold_2d(torch, smi, name, exp, batch):
    """Phase 20, 2-D: at full width from He-scaled parameters, the loss,
    probabilities, sigma and every gradient of one batch with the glue fold
    against the explicit glue on the card (the explicit pass's ReLU masks,
    pool taps and clips replayed into the folded one, ``_decisions``), then
    one ``make_train_step`` step in each mode with the counters zeroed just
    before and read just after: the fold's step launches kernel 1 and
    kernel 4 only at the convs it does not fold (``_folded_layers``).
    Returns the fold step's launches."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.ops.moments import lowering

    cfg, tc = exp.model, exp.train
    params = _he_params(torch, cfg)
    rng = np.random.default_rng(SEED + 20)
    s, o = cfg.image_size, cfg.out_size
    x = torch.from_numpy(rng.normal(0.0, 1.0, (batch, s, s, cfg.in_channels))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (batch, o, o)).astype(np.int32)).cuda()
    state, _ = T.create_train_state(params, tc, "cuda")

    def grads(fold, **dec):
        with lowering(glue_fold=fold), _decisions(torch, **dec) as ties:
            loss, (_, _, probs, sigma) = T.loss_fn(state.params, x, y, cfg, tc)
            g = torch.autograd.grad(loss, T.leaves(state.params))
        return float(loss.detach()), probs, sigma, g, ties

    choices = []
    l0, p0, s0, g0, _ = grads("none", record=choices)
    l1, p1, s1, g1, ties = grads("fold", replay=choices)
    res = {
        "loss_rel_err": abs(l1 - l0) / abs(l0),
        "probs_tol_ratio": _tol_ratio(torch, p1, p0, FOLD_FWD_TOL),
        "sigma_tol_ratio": _tol_ratio(torch, s1, s0, FOLD_FWD_TOL),
        "grad_tol_ratio": max(_tol_ratio(torch, a, b, FOLD_GRAD_TOL) for a, b in zip(g1, g0)),
        "grad_max_rel_err": max(_max_rel(torch, a, b) for a, b in zip(g1, g0)),
    }
    del g0, g1, choices
    if (res["loss_rel_err"] > FOLD_FWD_TOL[0] or res["probs_tol_ratio"] > 1
            or res["sigma_tol_ratio"] > 1 or res["grad_tol_ratio"] > 1):
        _die(f"{name} glue fold: against the explicit glue {res}")

    skip = _folded_layers(cfg)
    step = T.make_train_step(cfg, tc)
    steps = {}
    for fold, want in (("none", _expected_launches(cfg, batch, 1, 0)),
                       ("fold", _expected_launches(cfg, batch, 1, 0, skip=skip))):
        st, _ = T.create_train_state(params, tc, "cuda")
        with lowering(glue_fold=fold):
            torch.cuda.synchronize()
            _zero_launches()
            st, m = step(st, x, y)
            loss = float(m.loss)
            launches = _read_launches()
        if launches != want:
            _die(f"{name} glue fold ({fold}): kernel launches {launches}, expected {want}")
        steps[fold] = {"launches": launches, "loss": loss}
        del st
    if abs(steps["fold"]["loss"] - steps["none"]["loss"]) > TRAIN_LOSS_RTOL * abs(
            steps["none"]["loss"]):
        _die(f"{name} glue fold: step losses {steps}")
    print(json.dumps({"glue_fold": name, "card": smi, "batch": batch,
                      "folded_layers": sorted(skip), **res, "ties_replayed": ties,
                      "steps": steps}), flush=True)
    return steps["fold"]["launches"]


def _glue_fold_members(torch, smi, exp, batch, k_n):
    """Phase 20, member axis: one ``make_ensemble_train_step`` (vmap) step of
    K members without and with the glue fold; the fold's launches are the
    unfolded convs' for K members in one launch, the member losses equal."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.ops.moments import lowering

    cfg, tc = exp.model, exp.train
    members = [_he_params(torch, cfg, SEED + k) for k in range(k_n)]
    rng = np.random.default_rng(SEED + 21)
    s, o = cfg.image_size, cfg.out_size
    x = rng.normal(0.0, 1.0, (k_n, batch, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (k_n, batch, o, o)).astype(np.int32)
    step = T.make_ensemble_train_step(cfg, tc, member_mode="vmap")
    out = {}
    for fold, skip in (("none", ()), ("fold", _folded_layers(cfg))):
        state = T.stack_trees([T.create_train_state(p, tc, "cuda")[0] for p in members])
        with lowering(glue_fold=fold):
            torch.cuda.synchronize()
            _zero_launches()
            state, m = step(state, x, y, np.arange(k_n) + tc.seed)
            losses = m.loss.cpu().numpy()
            launches = _read_launches()
        want = _expected_launches(cfg, batch, 1, 0, members=k_n, skip=skip)
        if launches != want:
            _die(f"glue fold, K={k_n} members ({fold}): launches {launches}, expected {want}")
        out[fold] = {"launches": launches, "losses": losses.tolist()}
        del state
    err = float(np.abs(np.array(out["fold"]["losses"]) - out["none"]["losses"]).max()
                / np.abs(out["none"]["losses"]).max())
    if err > TRAIN_LOSS_RTOL:
        _die(f"glue fold, K={k_n} members: losses {out}")
    return {"members": k_n, "batch": batch, "loss_max_rel_err": err, **out}


def _glue_fold_cpu(torch):
    """Phase 20, the card against the CPU under the fold at the tiny config
    (32x32, 4 base kernels, batch 4): the forward within the serving limits,
    the gradients within TRAIN_GRAD_TOL with the card's choices replayed."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.ops.moments import lowering

    cfg = dataclasses.replace(HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4)
    tc = HIPPOCAMPUS.train
    params = _he_params(torch, cfg)
    rng = np.random.default_rng(SEED + 22)
    x = torch.from_numpy(rng.normal(0.0, 1.0, (4, 32, 32, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (4, 22, 22)).astype(np.int32))

    def run(device, **dec):
        state, _ = T.create_train_state(params, tc, device)
        with lowering(glue_fold="fold"), _decisions(torch, **dec) as ties:
            loss, (_, _, probs, sigma) = T.loss_fn(state.params, x.to(device), y.to(device),
                                                   cfg, tc)
            g = torch.autograd.grad(loss, T.leaves(state.params))
        return probs.cpu().numpy(), sigma.cpu().numpy(), g, ties

    choices = []
    pg, sg, gg, _ = run("cuda", record=choices)
    pc, sc, gc, ties = run("cpu", replay=choices)
    fwd = _serving_close("glue fold, card against the CPU (tiny)", pg.reshape(4, 22, 22, 3),
                         sg.reshape(4, 22, 22, 3), pc.reshape(4, 22, 22, 3),
                         sc.reshape(4, 22, 22, 3))
    worst_g = max(_max_rel(torch, a, b) for a, b in zip(gg, gc))
    if not worst_g <= TRAIN_GRAD_TOL:
        _die(f"glue fold, card against the CPU: gradients {worst_g:.3e} of a leaf's max")
    return {"probs_max_abs_err": fwd[0], "sigma_share_beyond_rtol": fwd[2],
            "grad_max_rel_err": worst_g, "ties_replayed": ties}


# the glue fold mode of each 3-D mode
_MODES3D = {"default": "none", "fold": "fold"}


def _lowerings_3d(torch, smi):
    """Phase 20, 3-D at the phase-18 width (cube 64, base 32, depth 3,
    batch 4), the family without a hand-written kernel: the glue fold
    against the default, the loss, probabilities and every gradient, the
    default pass's ReLU masks, pool taps and clips replayed
    (``_decisions3d``), under cuDNN's deterministic algorithms; then the
    train profile of each mode (wall, device time, idle share, peak memory)
    with the modes in turns; kernels 1-4 at 0 launches."""
    import numpy as np

    from supernet_tpu_torch import profiling
    from supernet_tpu_torch import train as T
    from supernet_tpu_torch import train3d as T3
    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.ops.moments import lowering

    exp = HIPPOCAMPUS
    cfg = dataclasses.replace(exp.model, out_size=T3.derive_out_size3d(exp.model))
    tc, batch = exp.train, 4
    s, o, c = cfg.image_size, cfg.out_size, cfg.n_classes
    params = _he_params3d(torch, cfg)
    rng = np.random.default_rng(SEED + 23)
    x = torch.from_numpy(rng.normal(0.0, 1.0, (batch, s, s, s, cfg.in_channels))
                         .astype(np.float32)).cuda()
    y1h = T.one_hot_flatten(torch.from_numpy(
        rng.integers(0, c, (batch, o, o, o)).astype(np.int32)).cuda(), c)
    torch.cuda.synchronize()
    _zero_launches()
    state, _ = T.create_train_state(params, tc, "cuda")

    def grads(mode, **dec):
        torch.cuda.reset_peak_memory_stats()
        with lowering(glue_fold=_MODES3D[mode]), _decisions3d(torch, **dec) as ties:
            loss, _, probs = T3._loss3d(state.params, x, y1h, cfg, tc)
            g = torch.autograd.grad(loss, T.leaves(state.params))
        return float(loss.detach()), probs, g, ties, torch.cuda.max_memory_allocated()

    equal = {}
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        choices = []
        l0, p0, g0, _, peak0 = grads("default", record=choices)
        equal["default"] = {"loss": l0, "grad_pass_peak_bytes": peak0}
        l1, p1, g1, ties, peak = grads("fold", replay=choices)
        res = {"loss": l1, "loss_rel_err": abs(l1 - l0) / abs(l0),
               "probs_tol_ratio": _tol_ratio(torch, p1, p0, FOLD_FWD_TOL),
               "grad_tol_ratio": max(_tol_ratio(torch, a, b, FOLD_GRAD_TOL)
                                     for a, b in zip(g1, g0)),
               "grad_max_rel_err": max(_max_rel(torch, a, b) for a, b in zip(g1, g0)),
               "ties_replayed": ties, "grad_pass_peak_bytes": peak}
        del g1, p1
        equal["fold"] = res
        if (res["loss_rel_err"] > FOLD_FWD_TOL[0] or res["probs_tol_ratio"] > 1
                or res["grad_tol_ratio"] > 1):
            _die(f"3-D fold: against the default {res}")
        del g0, p0, choices, state
    torch.cuda.empty_cache()
    equality_s = time.perf_counter() - t0

    # 3 warm-up steps, 2 timed, 2 traced per profile; each mode twice
    keys = ("step_ms_median", "device_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "peak_memory_bytes", "conv3d_share")
    timing = {m: {k: [] for k in keys + ("profile_s",)} for m in _MODES3D}
    for mode in ("default", "fold", "fold", "default"):
        t0 = time.perf_counter()
        with lowering(glue_fold=_MODES3D[mode]):
            prof = profiling.profile_train_step3d("hippocampus", batch, SEED, steps=2)
        for k in keys:
            timing[mode][k].append(prof[k])
        timing[mode]["profile_s"].append(time.perf_counter() - t0)
        torch.cuda.empty_cache()
    launches = _read_launches()
    if any(launches.values()):
        _die(f"3-D lowerings: the 2-D kernels were launched: {launches}")
    return {"card": smi, "batch": batch, "cube": s, "equality": equal, "timing": timing,
            "equality_s": equality_s, "launches_of_kernels_1_4": launches}


def _lowerings(torch, smi):
    """Phase 20. Returns the hippocampus fold step's launches."""
    from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS

    t_phase = time.perf_counter()
    parts = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        return out

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        fold_launches = timed("hippocampus", _glue_fold_2d, torch, smi, "hippocampus",
                              HIPPOCAMPUS, 20)
        timed("brats", _glue_fold_2d, torch, smi, "brats", BRATS, 2)
        members = timed("members", _glue_fold_members, torch, smi, HIPPOCAMPUS, 20, 2)
        cpu = timed("cpu", _glue_fold_cpu, torch)
    three_d = timed("three_d", _lowerings_3d, torch, smi)
    print(json.dumps({"lowerings": "phase 20", "card": smi, "members_k2": members,
                      "card_vs_cpu_tiny": cpu, "three_d": three_d,
                      "phase_s": time.perf_counter() - t_phase, "parts_s": parts}),
          flush=True)
    return fold_launches


# ------------------------------------------------------------- phase 21


def _profile_cli(torch, smi, tmp):
    """Phase 21: ``cli profile --by-layer`` in process on the default
    device, hippocampus at batch 20 and the 3-D step at batch 4 (K = 8 steps
    per call, bf16 activations, the JAX twin's defaults).
    ``exact_join.json`` is written; the launches of kernels 1-4 joined from
    the trace equal the kernels' own counters over the traced calls and the
    per-step counts times the steps (0 in 3-D); no kernel of the traced calls
    lost its record (``cli profile`` leaves out the settling call before
    them, where the profiler loses some); the joined classes and the
    unjoined row sum to the profiler's device busy time within 1%. Returns
    the hippocampus run's launches per step."""
    from supernet_tpu_torch import cli
    from supernet_tpu_torch import xplane as X
    from supernet_tpu_torch.configs import HIPPOCAMPUS

    t_phase = time.perf_counter()
    per_step = None
    for config, batch, iters in (("hippocampus", 20, 2), ("unet3d", 4, 1)):
        out_dir = os.path.join(tmp, f"profile_{config}")
        t0 = time.perf_counter()
        if cli.main(["profile", "--config", config, "--batch", str(batch), "--iters",
                     str(iters), "--by-layer", "--out-dir", out_dir]) != 0:
            _die(f"cli profile --config {config}: rc != 0")
        seconds = time.perf_counter() - t0
        path = os.path.join(out_dir, "exact_join.json")
        if not os.path.isfile(path):
            _die(f"cli profile --config {config}: no exact_join.json")
        with open(path) as f:
            ej = json.load(f)
        steps = ej["k_steps"] * ej["n_iters"]
        if config == "unet3d":
            want = {k: 0 for k in ej["counted_launches"]}
        else:
            want = _scaled(_expected_launches(HIPPOCAMPUS.model, batch, 1, 0), steps)
            per_step = _expected_launches(HIPPOCAMPUS.model, batch, 1, 0)
        if ej["kernel_launches"] != ej["counted_launches"] or ej["counted_launches"] != want:
            _die(f"cli profile --config {config}: launches in the trace "
                 f"{ej['kernel_launches']}, counted {ej['counted_launches']}, expected {want}")
        # every kernel 2 launch filed under its own class, none elsewhere
        pool = next((r for r in ej["classes"] if r["class"] == X.POOL_FWD), None)
        if (pool["events"] if pool else 0) != ej["counted_launches"]["vmaxpool"]:
            _die(f"cli profile --config {config}: {pool} under {X.POOL_FWD}, counted "
                 f"{ej['counted_launches']['vmaxpool']} kernel 2 launches")
        if ej["lost_launches"]:
            _die(f"cli profile --config {config}: the trace lost the records of "
                 f"{ej['lost_launches']} kernels of the traced calls")
        busy, total = ej["device_steps_ms_per_step"], ej["total_ms_per_step"]
        if not abs(total - busy) <= 0.01 * busy:
            _die(f"cli profile --config {config}: joined + unjoined {total} ms/step against "
                 f"the device busy time {busy} ms/step")
        print(json.dumps({
            "cli_profile": config, "card": smi, "batch": batch, "k_steps": ej["k_steps"],
            "n_iters": ej["n_iters"], "act_dtype": ej["act_dtype"],
            "wall_ms_per_step": ej["wall_ms_per_step"], "device_busy_ms_per_step": busy,
            "total_ms_per_step": total, "total_over_busy": total / busy,
            "unmatched_ms_per_step": ej["unmatched_ms_per_step"],
            "unmatched": ej["unmatched"], "classes": ej["classes"],
            "layers_mxu": ej.get("layers_mxu"), "kernel_launches": ej["kernel_launches"],
            "lost_launches": ej["lost_launches"],
            "settle_lost_launches": ej["settle_lost_launches"],
            "seconds": seconds}), flush=True)
    print(json.dumps({"profile": "phase 21", "phase_s": time.perf_counter() - t_phase}),
          flush=True)
    return per_step


def _parallel_steps(torch, P, name, exp, batch, steps, meshes, kinds):
    """Phase 22's 2-D steps: ``steps`` steps of each sharded step in
    ``kinds`` on a world of one, counted (launches per step) and then with
    the choices of ``make_train_step``'s run on the same card replayed
    (``_decisions``), both held against that run: every step's loss within
    ``TRAIN_LOSS_RTOL``, the parameters after the steps within
    ``2 * lr * steps``. Returns {kind: launches per step} and a summary."""
    import numpy as np

    from supernet_tpu_torch import train as T

    cfg, tc = exp.model, exp.train
    params = _he_params(torch, cfg)
    rng = np.random.default_rng(SEED)
    s, o = cfg.image_size, cfg.out_size
    x = rng.normal(0.0, 1.0, (steps, batch, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (steps, batch, o, o)).astype(np.int32)

    ref, _ = T.create_train_state(params, tc, "cuda")
    step = T.make_train_step(cfg, tc)
    choices, ref_losses = [], []
    with _decisions(torch, record=choices):
        for i in range(steps):
            ref, m = step(ref, x[i], y[i])
            ref_losses.append(float(m.loss))
    makers = {
        "data": lambda: P.make_sharded_train_step(cfg, tc, meshes["data"]),
        "spatial": lambda: P.make_spatial_train_step(cfg, tc, meshes["data"]),
        "hybrid": lambda: P.make_hybrid_train_step(cfg, tc, meshes["hybrid"]),
    }
    per_step = _expected_launches(cfg, batch, 1, 0)
    limit = 2.0 * tc.lr * steps
    out, summary = {}, {"losses": ref_losses, "param_limit": limit}
    for kind in kinds:
        mesh = meshes["hybrid" if kind == "hybrid" else "data"]
        fn = makers[kind]()

        def feed(i):
            if kind == "data":  # the rows shard_batch gives this rank
                return P.shard_batch(mesh, x[i], y[i])
            return x[i], y[i]

        for replay in (False, True):
            state = P.replicate(mesh, T.create_train_state(params, tc, "cuda")[0])
            ctx = (_decisions(torch, replay=choices) if replay
                   else contextlib.nullcontext({}))
            torch.cuda.synchronize()
            _zero_launches()
            times, losses = [], []
            with ctx as ties:
                for i in range(steps):
                    t0 = time.perf_counter()
                    state, m = fn(state, *feed(i))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    losses.append(float(m.loss))
            launches = _read_launches()
            if not replay and launches != _scaled(per_step, steps):
                _die(f"{name} {kind} sharded training: kernel launches {launches} in "
                     f"{steps} steps, expected {per_step} per step")
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            if not loss_err <= TRAIN_LOSS_RTOL:
                _die(f"{name} {kind} sharded training: losses {losses} against "
                     f"make_train_step's {ref_losses}")
            param_err = max(float((a - b).detach().abs().max()) for a, b in
                            zip(T.leaves(state.params), T.leaves(ref.params)))
            if not param_err <= limit:
                _die(f"{name} {kind} sharded training: parameters differ from "
                     f"make_train_step's by {param_err:.3e} > 2 * lr * steps")
            tag = f"{kind}_replayed" if replay else kind
            summary[tag] = {"loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
                            "median_step_ms": 1e3 * statistics.median(times)}
            if replay:
                summary[tag]["ties_replayed"] = dict(ties)
            else:
                out[kind] = {k: v // steps for k, v in launches.items()}
            del state
    return out, summary


@contextlib.contextmanager
def _step_grads(into: list):
    """Append to ``into`` the gradients of each train step taken inside,
    before the clip and Adam: ``train._update`` wrapped (``make_train_step``
    looks it up at each step, ``make_rows_step`` when it is made, so a
    sharded step is made inside)."""
    from supernet_tpu_torch import train as T

    real = T._update

    def update(state, tc):
        into.append([t.grad.detach().clone() for t in T.leaves(state.params)])
        real(state, tc)

    T._update = update
    try:
        yield into
    finally:
        T._update = real


def _parallel_fold_steps(torch, P, name, exp, batch, steps, meshes):
    """Phase 22 under the decoder glue fold: ``steps`` steps of the spatial
    and the hybrid step on the world of one with ``glue_fold="fold"``,
    counted (kernels 1 and 4 launch at the unfolded convs only,
    ``_folded_layers``), then step 1 again with the choices of
    ``make_train_step``'s run under the fold on the same card replayed
    (``_decisions``; after step 1 the runs' parameters part, and a later
    choice is no longer a tie). Both are held against that run: every
    step's loss within ``TRAIN_LOSS_RTOL``, the parameters within
    ``2 * lr`` per step, and the replayed step's gradients before the clip
    and Adam within ``TRAIN_GRAD_TOL`` of each leaf's max. Adam's first step
    moves a weight by lr * g / (|g| + eps), about lr whatever |g| is, so
    where g is a rounding of zero two correct runs part by up to 2 * lr:
    the summary names the weight where the parameters part most, its
    gradient at each step in both runs and its leaf's largest.
    Returns {kind: launches per step} and a summary."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.ops.moments import lowering

    cfg, tc = exp.model, exp.train
    params = _he_params(torch, cfg)
    rng = np.random.default_rng(SEED + 22)
    s, o = cfg.image_size, cfg.out_size
    x = rng.normal(0.0, 1.0, (steps, batch, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (steps, batch, o, o)).astype(np.int32)
    per_step = _expected_launches(cfg, batch, 1, 0, skip=_folded_layers(cfg))
    limit = 2.0 * tc.lr * steps
    names = [f"{layer}/{k}" for layer, p in params.items() for k in p]
    with lowering(glue_fold="fold"):
        ref, _ = T.create_train_state(params, tc, "cuda")
        choices, ref_losses = [], []
        with _decisions(torch, record=choices), _step_grads([]) as ref_g:
            step = T.make_train_step(cfg, tc)
            for i in range(steps):
                ref, m = step(ref, x[i], y[i])
                ref_losses.append(float(m.loss))
                if i == 0:  # the parameters after step 1, for the replayed step
                    ref1 = [t.detach().clone() for t in T.leaves(ref.params)]
        out, summary = {}, {"losses": ref_losses, "param_limit": limit,
                            "adam_eps": tc.adam_eps}
        makers = {"spatial": lambda: P.make_spatial_train_step(cfg, tc, meshes["data"]),
                  "hybrid": lambda: P.make_hybrid_train_step(cfg, tc, meshes["hybrid"])}
        for kind, make in makers.items():
            mesh = meshes["hybrid" if kind == "hybrid" else "data"]
            for replay in (False, True):
                with _step_grads([]) as got_g:
                    fn = make()
                state = P.replicate(mesh, T.create_train_state(params, tc, "cuda")[0])
                ctx = (_decisions(torch, replay=choices) if replay
                       else contextlib.nullcontext({}))
                torch.cuda.synchronize()
                _zero_launches()
                times, losses = [], []
                n = 1 if replay else steps
                with ctx as ties:
                    for i in range(n):
                        t0 = time.perf_counter()
                        state, m = fn(state, x[i], y[i])
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        losses.append(float(m.loss))
                launches = _read_launches()
                if not replay and launches != _scaled(per_step, steps):
                    _die(f"{name} {kind} sharded training under the glue fold: kernel "
                         f"launches {launches} in {steps} steps, expected {per_step} per step")
                loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
                diffs = [(a - b).detach().abs() for a, b in
                         zip(T.leaves(state.params), ref1 if replay else T.leaves(ref.params))]
                leaf = max(range(len(diffs)), key=lambda i: float(diffs[i].max()))
                param_err = float(diffs[leaf].max())
                grad_err = max(_max_rel(torch, g, r) for g, r in zip(got_g[0], ref_g[0]))
                if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= 2.0 * tc.lr * n) or (
                        replay and not grad_err <= TRAIN_GRAD_TOL):
                    _die(f"{name} {kind} sharded training under the glue fold"
                         f"{' (choices replayed)' if replay else ''}: losses {losses} against "
                         f"{ref_losses}, parameters {param_err:.3e} apart, step-1 gradients "
                         f"{grad_err:.3e} of a leaf's max")
                at = int(diffs[leaf].argmax())
                tag = f"{kind}_replayed" if replay else kind
                summary[tag] = {
                    "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
                    "grad_max_rel_err": grad_err,
                    "worst_weight": {
                        "leaf": names[leaf], "index": at,
                        "grads_ref": [float(g[leaf].flatten()[at]) for g in ref_g[:n]],
                        "grads": [float(g[leaf].flatten()[at]) for g in got_g],
                        "leaf_max_grads_ref": [float(g[leaf].abs().max()) for g in ref_g[:n]]},
                    "median_step_ms": 1e3 * statistics.median(times)}
                if replay:
                    summary[tag]["ties_replayed"] = dict(ties)
                else:
                    out[kind] = {k: v // steps for k, v in launches.items()}
                del state, got_g, diffs
    return out, summary


def _parallel_3d(torch, P, meshes):
    """Phase 22's 3-D steps at the phase-18 width: ``make_dp_train_step3d``
    and ``make_spatial_train_step3d``, 2 steps each, counted (kernels 1-4
    at 0) and with ``make_train_step3d``'s choices replayed
    (``_decisions3d``), held against its run on the card."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch import train3d as T3
    from supernet_tpu_torch.configs import HIPPOCAMPUS

    exp = HIPPOCAMPUS
    cfg = dataclasses.replace(exp.model, out_size=T3.derive_out_size3d(exp.model))
    tc, batch, steps = exp.train, 4, 2
    s, o, c = cfg.image_size, cfg.out_size, cfg.n_classes
    params = _he_params3d(torch, cfg)
    rng = np.random.default_rng(SEED)
    x = rng.normal(0.0, 1.0, (steps, batch, s, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, c, (steps, batch, o, o, o)).astype(np.int32)
    ref, _ = T.create_train_state(params, tc, "cuda")
    step = T3.make_train_step3d(cfg, tc)
    choices, ref_losses = [], []
    with _decisions3d(torch, record=choices):
        for i in range(steps):
            ref, m = step(ref, x[i], y[i])
            ref_losses.append(float(m.loss))
    limit = 2.0 * tc.lr * steps
    summary = {"losses": ref_losses, "param_limit": limit}
    mesh = meshes["data"]
    for kind, make in (("data", P.make_dp_train_step3d),
                       ("spatial", P.make_spatial_train_step3d)):
        fn = make(cfg, tc, mesh)
        for replay in (False, True):
            state = P.replicate(mesh, T.create_train_state(params, tc, "cuda")[0])
            ctx = (_decisions3d(torch, replay=choices) if replay
                   else contextlib.nullcontext({}))
            torch.cuda.synchronize()
            _zero_launches()
            losses = []
            with ctx:
                for i in range(steps):
                    xb, yb = ((P.shard_batch(mesh, x[i], y[i])) if kind == "data"
                              else (x[i], y[i]))
                    state, m = fn(state, xb, yb)
                    losses.append(float(m.loss))
            launches = _read_launches()
            if any(launches.values()):
                _die(f"3-D {kind} sharded training launched kernels 1-4: {launches}")
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            param_err = max(float((a - b).detach().abs().max()) for a, b in
                            zip(T.leaves(state.params), T.leaves(ref.params)))
            if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= limit):
                _die(f"3-D {kind} sharded training: losses {losses} against "
                     f"{ref_losses}, parameters {param_err:.3e} (limit {limit:.3e})")
            summary[f"{kind}_replayed" if replay else kind] = {
                "loss_max_rel_err": loss_err, "param_max_abs_err": param_err}
            del state
    return summary


def _parallel_entry_points(torch, P, meshes, tmp):
    """Phase 22's entry points in process: an epoch of ``Trainer(mesh=)``,
    ``cli train --data-parallel``, ``train3d --spatial-shard``, ``eval
    --data-parallel``, ``InferenceSession(mesh=)``, ``EnsembleSession(mesh=)``
    and ``EnsembleTrainer(mesh=)`` at K=3, each against its meshless run on
    the card. Returns (the trainer's launches, a summary)."""
    import numpy as np

    from supernet_tpu_torch import cli, ensemble
    from supernet_tpu_torch.checkpoint import load_params_npz, save_params_npz
    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.data import PickleDataset, synthetic_dataset
    from supernet_tpu_torch.serving import EnsembleSession, InferenceSession
    from supernet_tpu_torch.train import leaves
    from supernet_tpu_torch.trainer import Trainer

    mesh = meshes["data"]
    batch = 20
    exp = HIPPOCAMPUS.replace(train=dataclasses.replace(
        HIPPOCAMPUS.train, epochs=1, batch_size=batch, log_every=1000))
    cfg = exp.model
    npz = os.path.join(tmp, "init.npz")
    save_params_npz(npz, _he_params(torch, cfg))
    train_ds = PickleDataset(*synthetic_dataset(cfg, 200, seed=0), cfg.in_channels)
    val_ds = PickleDataset(*synthetic_dataset(cfg, 40, seed=1), cfg.in_channels)
    parts, summary = {}, {}

    def timed(part):
        parts[part] = time.perf_counter()

    def done(part):
        parts[part] = time.perf_counter() - parts[part]

    # an epoch of the trainer on the mesh against the meshless epoch
    timed("trainer")
    runs = {}
    for sub, m in (("meshless", None), ("mesh", mesh)):
        tr = Trainer(exp, train_ds, val_ds, out_dir=os.path.join(tmp, f"tr_{sub}"),
                     mesh=m, initial_params=load_params_npz(npz, "cpu"), device="cuda")
        torch.cuda.synchronize()
        _zero_launches()
        state = tr.run(log=lambda *_: None)
        runs[sub] = (tr, state, _read_launches())
    launches = runs["mesh"][2]
    want = _expected_launches(cfg, batch, 10, 2)
    if launches != want:
        _die(f"Trainer(mesh=): kernel launches {launches}, expected {want}")
    hist = {k: (runs["mesh"][0].history[k], runs["meshless"][0].history[k])
            for k in ("train_loss", "val_loss", "val_dice")}
    if any(a != b for a, b in hist.values()):
        _die(f"Trainer(mesh=): history {hist} differs from the meshless epoch's")
    param_err = max(float((a - b).detach().abs().max()) for a, b in
                    zip(leaves(runs["mesh"][1].params), leaves(runs["meshless"][1].params)))
    if param_err != 0.0:
        _die(f"Trainer(mesh=): parameters differ from the meshless epoch's by {param_err}")
    summary["trainer"] = {"launches": launches, "train_loss": hist["train_loss"][0],
                          "images_per_sec": runs["mesh"][0].history["images_per_sec"],
                          "meshless_images_per_sec":
                              runs["meshless"][0].history["images_per_sec"]}
    del runs
    done("trainer")

    # the CLI's sharding flags, in process, on the default device
    timed("cli")
    line = _cli_json(cli, ["train", "--config", "hippocampus", "--synthetic", "100",
                           "--epochs", "1", "--data-parallel", "--device", "cuda",
                           "--out-dir", os.path.join(tmp, "cli_dp")])[-1]
    line3 = _cli_json(cli, ["train3d", "--config", "hippocampus", "--synthetic", "10",
                            "--epochs", "1", "--batch-size", "4", "--spatial-shard",
                            "--device", "cuda",
                            "--out-dir", os.path.join(tmp, "cli_3d")])[-1]
    evals = [_cli_json(cli, ["eval", "--config", "hippocampus", "--synthetic", "40",
                             "--checkpoint", npz, "--images-n", "0", *flag,
                             "--device", "cuda",
                             "--out-dir", os.path.join(tmp, f"cli_eval{i}")])[-1]
             for i, flag in enumerate(([], ["--data-parallel"]))]
    for what, v in (("train", line["train_loss"]), ("train3d", line3["train_loss"])):
        if not math.isfinite(v):
            _die(f"cli {what} with a sharding flag: train_loss {v}")
    for k in ("accuracy", "dice_anterior", "mean_predictive_variance"):
        if evals[0][k] != evals[1][k]:
            _die(f"cli eval --data-parallel: {k} {evals[1][k]} against {evals[0][k]}")
    summary["cli"] = {"train_loss": line["train_loss"], "train3d_loss": line3["train_loss"],
                      "eval_accuracy": evals[1]["accuracy"]}
    done("cli")

    # the sessions: requests of 20, 7 and 45 images, members over the mesh
    timed("sessions")
    params = load_params_npz(npz, "cpu")
    rng = np.random.default_rng(SEED)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    sess = {m: InferenceSession(params, cfg, batch_size=batch, device="cuda", mesh=mm)
            for m, mm in (("meshless", None), ("mesh", mesh))}
    for n in (20, 7, 45):
        xr = rng.normal(0.0, 1.0, (n,) + shape).astype(np.float32)
        for a, b in zip(sess["mesh"].predict(xr), sess["meshless"].predict(xr)):
            if not np.array_equal(a, b):
                _die(f"InferenceSession(mesh=): a request of {n} differs from the "
                     f"meshless session's by {float(np.abs(a - b).max()):.3e}")
    members = [_he_params(torch, cfg, seed=SEED + k) for k in range(3)]
    xr = rng.normal(0.0, 1.0, (7,) + shape).astype(np.float32)
    got = EnsembleSession(members, cfg, batch_size=batch, device="cuda", mesh=mesh).predict(xr)
    want = EnsembleSession(members, cfg, batch_size=batch, device="cuda").predict(xr)
    ens_err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    if ens_err != 0.0:
        _die(f"EnsembleSession(mesh=) differs from the meshless session by {ens_err:.3e}")
    done("sessions")

    # the ensemble trainer with its member axis over the mesh, K=3
    timed("ensemble_trainer")
    small = PickleDataset(*synthetic_dataset(cfg, 40, seed=2), cfg.in_channels)
    ens = {}
    for sub, m in (("meshless", None), ("mesh", mesh)):
        tr = ensemble.EnsembleTrainer(exp, 3, small, out_dir=os.path.join(tmp, f"ens_{sub}"),
                                      mesh=m, track_curves=False, device="cuda")
        ens[sub] = (tr.run(log=lambda *_: None), tr.histories)
    e_err = max(float((a - b).detach().abs().max()) for a, b in
                zip(leaves(ens["mesh"][0].params), leaves(ens["meshless"][0].params)))
    losses = [[h["train_loss"] for h in ens[sub][1]] for sub in ("mesh", "meshless")]
    if e_err != 0.0 or losses[0] != losses[1]:
        _die(f"EnsembleTrainer(mesh=) differs from the meshless trainer by {e_err:.3e}")
    summary["ensemble_trainer"] = {"train_loss": losses[0]}
    done("ensemble_trainer")
    return launches, summary, parts


def _parallel(torch, smi, tmp):
    """Phase 22. Returns the launches per step of the hippocampus
    data-parallel step."""
    import torch.distributed as dist

    from supernet_tpu_torch import parallel as P
    from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS

    t_phase = time.perf_counter()
    # NCCL admits one rank per card: a second rank on cuda:0 is refused at
    # its first collective ("Duplicate GPU detected : rank 0 and rank 1 both
    # on CUDA device", PERF.md section 7), so the card runs a world of one;
    # the multi-rank worlds are the CPU tests' (tests/test_torch_parallel.py,
    # _spatial, _hybrid, _multihost, in gloo)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        meshes = {"data": P.make_mesh(), "hybrid": P.make_mesh2d(1, 1)}
        if str(meshes["data"].device_type) != "cuda":
            _die(f"phase 22: the mesh's device type is {meshes['data'].device_type}")
        parts = {}
        t0 = time.perf_counter()
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            hip, hip_sum = _parallel_steps(torch, P, "hippocampus", HIPPOCAMPUS, 20, 3, meshes,
                                           ("data", "spatial", "hybrid"))
            parts["steps_2d_hippocampus"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            brats, brats_sum = _parallel_steps(torch, P, "brats", BRATS, 2, 2, meshes,
                                               ("data",))
            parts["steps_2d_brats"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            fold, fold_sum = _parallel_fold_steps(torch, P, "hippocampus", HIPPOCAMPUS, 20, 2,
                                                  meshes)
            fold_b, fold_b_sum = _parallel_fold_steps(torch, P, "brats", BRATS, 2, 2, meshes)
            parts["steps_2d_glue_fold"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            three_d = _parallel_3d(torch, P, meshes)
            parts["steps_3d"] = time.perf_counter() - t0
            trainer_launches, entry, entry_parts = _parallel_entry_points(torch, P, meshes, tmp)
            parts.update(entry_parts)
    finally:
        dist.destroy_process_group()
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({
        "parallel": "one-rank NCCL world on cuda:0", "card": smi,
        "hippocampus_b20": hip_sum, "brats_b2": brats_sum, "three_d_b4": three_d,
        "glue_fold": {"hippocampus_b20": fold_sum, "brats_b2": fold_b_sum},
        "launches_per_step": {"hippocampus": hip, "brats": brats,
                              "glue_fold_hippocampus": fold, "glue_fold_brats": fold_b},
        "entry_points": entry, "trainer_launches": trainer_launches,
        "phase_s": phase_s, "parts_s": parts,
    }), flush=True)
    print(f"parallel (phase 22): {phase_s:.1f} s; hippocampus b20 step data "
          f"{hip_sum['data']['median_step_ms']:.3f} ms, spatial "
          f"{hip_sum['spatial']['median_step_ms']:.3f} ms, hybrid "
          f"{hip_sum['hybrid']['median_step_ms']:.3f} ms; under the glue fold spatial "
          f"{fold_sum['spatial']['median_step_ms']:.3f} ms, hybrid "
          f"{fold_sum['hybrid']['median_step_ms']:.3f} ms ({smi})", flush=True)
    return hip, brats, fold


BENCH_ITERS = "40"  # phase 23's SUPERNET_BENCH_ITERS; every other knob at its default
# the bench line's peaks on an H100 80GB HBM3, the SXM part (flops.py's table)
BENCH_PEAKS = {"NVIDIA H100 80GB HBM3": (989.0, 3350.0)}


def _bench_scaling_errors(out):
    """Every error entry of the bench line's batch sweeps, as (section,
    batch, message); any other section error fails the phase."""
    errors = []
    for section, v in [("headline", out)] + [(k, v) for k, v in out.items()
                                             if isinstance(v, dict)]:
        if section != "headline" and "error" in v:
            _die(f"bench: the {section} section failed: {v['error']}")
        for b, rate in v.get("batch_scaling", {}).items() if isinstance(v, dict) else ():
            if isinstance(rate, str):
                if "out of memory" not in rate.lower():
                    _die(f"bench: {section} at batch {b}: {rate}")
                errors.append((section, b, rate))
    return errors


# (config, batch) of phase 23's naive-against-kernels forwards: the parity
# batches of phase 3 and each 2-D sweep's first and last batch (the
# planners cut no conv into K slices from hippocampus b64 and BraTS b64 on;
# BraTS b20 still cuts one)
BENCH_FORWARDS = (("hippocampus", "HIPPOCAMPUS", 20), ("hippocampus", "HIPPOCAMPUS", 256),
                  ("brats", "BRATS", 2), ("brats", "BRATS", 20), ("brats", "BRATS", 128))
NAIVE_CHUNK = 32  # images per naive forward: its patch matrices at BraTS


def _bench_inputs(torch, exp_name, batch):
    """The model config, He-scaled parameters and a batch of images on the
    card for phase 23's forwards at ``batch``."""
    import numpy as np

    from supernet_tpu_torch import configs

    c = getattr(configs, exp_name).model
    params = {n: {k: t.cuda() for k, t in p.items()} for n, p in _he_params(torch, c).items()}
    x = torch.from_numpy(np.random.default_rng(SEED + 23).normal(
        0.0, 1.0, (batch, c.image_size, c.image_size, c.in_channels))
        .astype(np.float32)).cuda()
    return c, params, x


def _bench_forward_default(torch, cname, exp_name, batch, dtype):
    """The bench's own arithmetic at a batch of ``BENCH_FORWARDS``: the
    kernel forward of :func:`_naive_agreement`'s model and images under
    precision "default" (``_default_precision``) in activation dtype
    ``dtype``, counted (one forward's launches at the one-pass plans, every
    kernel-1 launch one pass), every kernel-1 call within VDP_F64_TOL of
    its plain one pass in float64 on its own inputs (``_one_pass_checked``);
    the answer finite and not bit-equal to the same forward at "highest"
    (its distance printed); bf16: bit-equal to the same forward with the
    kernels fed float32 through casts. Returns the readings."""
    import numpy as np

    from supernet_tpu_torch.models import forward
    from supernet_tpu_torch.ops.kernels import vdp_conv as V
    from supernet_tpu_torch.profiling import act_dtype

    t0 = time.perf_counter()
    what = f'bench: the {cname} b{batch} forward in {dtype} under "default"'
    c, params, x = _bench_inputs(torch, exp_name, batch)
    out = {}
    with torch.no_grad(), act_dtype(dtype):
        hi_p, hi_s = forward(params, x, c)
        with _default_precision(torch):
            with _one_pass_checked(torch, what) as calls:
                torch.cuda.synchronize()
                _zero_launches()
                p, sg = forward(params, x, c)
                torch.cuda.synchronize()
                launches, bf16_pass = _read_launches(), V.bf16_launches
            if dtype == "bfloat16":
                with _kernels_fed_float32(torch, True):
                    up_p, up_s = forward(params, x, c)
                if not (torch.equal(p, up_p) and torch.equal(sg, up_s)):
                    _die(f"{what} differs from the one with the kernels fed float32 (probs "
                         f"{float((p.float() - up_p.float()).abs().max()):.3e})")
                out["equal_to_kernels_fed_float32"] = True
                del up_p, up_s
    want = _expected_launches(c, batch, 0, 1, precision="default")
    if launches != want or bf16_pass != launches["vdp_conv"]:
        _die(f"{what} launched {launches} ({bf16_pass} in one bf16 pass), expected "
             f"{want}, every kernel-1 launch in one pass")
    if calls["forward_calls"] != launches["vdp_conv"]:
        _die(f"{what}: {calls['forward_calls']} calls checked of {launches['vdp_conv']}")
    p, sg = p.float().cpu().numpy(), sg.float().cpu().numpy()
    hi = (hi_p.float().cpu().numpy(), hi_s.float().cpu().numpy())
    if not (np.isfinite(p).all() and np.isfinite(sg).all() and (sg >= 0).all()):
        _die(f"{what}: a non-finite or negative answer")
    if np.array_equal(p, hi[0]) and np.array_equal(sg, hi[1]):
        _die(f'{what}: the answer is the "highest" one bit for bit')
    del params, x
    torch.cuda.empty_cache()
    return {**out, "kernel_launches": launches, "bf16_pass_launches": bf16_pass,
            "checked_calls": calls, "vs_highest": _answer_gap(np, (p, sg), hi),
            "seconds": time.perf_counter() - t0}


def _naive_agreement(torch, cname, exp_name, batch, dtype="float32"):
    """The kernel forward of a He-scaled model at ``batch`` on the card
    under activation dtype ``dtype``, counted (one forward's launches),
    against the naive backend's forward of the same images (in chunks of
    ``NAIVE_CHUNK``, no kernel launched); TF32 off. float32: within the
    serving limits. bfloat16 (the bench's default): the answer bit-equal to
    the same forward with the kernels fed float32 through casts
    (``_kernels_fed_float32``; check (a) of phase 2 over the whole model, at
    the plans this batch takes), and the naive forward within
    ``BF16_PROBS_ATOL`` and ``BF16_AGREE``. Returns the errors."""
    import numpy as np

    from supernet_tpu_torch.models import forward
    from supernet_tpu_torch.ops import set_backend
    from supernet_tpu_torch.profiling import act_dtype

    what = f"bench: the {cname} b{batch} forward in {dtype}"
    c, params, x = _bench_inputs(torch, exp_name, batch)
    out = {}
    with torch.no_grad(), act_dtype(dtype):
        torch.cuda.synchronize()
        _zero_launches()
        ref_p, ref_s = forward(params, x, c)
        torch.cuda.synchronize()
        kernel_launches = _read_launches()
        if dtype == "bfloat16":
            with _kernels_fed_float32(torch, True):
                up_p, up_s = forward(params, x, c)
            if not (torch.equal(ref_p, up_p) and torch.equal(ref_s, up_s)):
                _die(f"{what} differs from the one with the kernels fed float32 (probs "
                     f"{float((ref_p.float() - up_p.float()).abs().max()):.3e})")
            out["equal_to_kernels_fed_float32"] = True
            del up_p, up_s
        torch.cuda.synchronize()
        _zero_launches()
        set_backend("naive")
        try:
            parts = [forward(params, x[i:i + NAIVE_CHUNK], c)
                     for i in range(0, batch, NAIVE_CHUNK)]
            torch.cuda.synchronize()
        finally:
            set_backend("kernels")
        naive_launches = _read_launches()
    want = _expected_launches(c, batch, 0, 1)
    if kernel_launches != want or any(naive_launches.values()):
        _die(f"{what} launched {kernel_launches} (kernels, expected {want}) and "
             f"{naive_launches} (naive, expected none)")
    p = torch.cat([q[0] for q in parts]).float().cpu().numpy()
    sg = torch.cat([q[1] for q in parts]).float().cpu().numpy()
    ref_p, ref_s = ref_p.float().cpu().numpy(), ref_s.float().cpu().numpy()
    if dtype == "float32":
        err_p, err_s, share = _serving_close(f"naive {cname} b{batch} forward", p, sg,
                                             ref_p, ref_s)
        out.update({"probs_max_abs_err": err_p, "sigma_max_rel_err": err_s,
                    "sigma_share_beyond": share})
    else:
        err_p = float(np.abs(p - ref_p).max())
        agree = float(np.mean(p.argmax(-1) == ref_p.argmax(-1)))
        if ref_p.shape != p.shape or not (np.isfinite(ref_p).all() and np.isfinite(ref_s).all()) \
                or err_p > BF16_PROBS_ATOL or not agree > BF16_AGREE:
            _die(f"{what} against the naive forward: shape {ref_p.shape}, probs "
                 f"{err_p:.3e} (limit {BF16_PROBS_ATOL}), argmax agreement {agree:.5f} "
                 f"(limit {BF16_AGREE})")
        out.update({"probs_max_abs_err": err_p, "argmax_agreement": agree})
    del params, x, parts
    torch.cuda.empty_cache()
    return {**out, "kernel_launches": kernel_launches}


def _bench_gradient(torch, exp, batch):
    """A train step's step-1 gradient at a batch of the bench's sweep on
    the card, counted (one step's launches, outside the bench's counts),
    against the CPU's with the card's choices replayed (``_gradient_vs_cpu``,
    ``TRAIN_GRAD_TOL``). Returns the error and the launches."""
    import numpy as np

    from supernet_tpu_torch import train as T

    cfg, tc = exp.model, exp.train
    params = _he_params(torch, cfg)
    rng = np.random.default_rng(SEED + 24)
    s, o = cfg.image_size, cfg.out_size
    x = rng.normal(0.0, 1.0, (batch, s, s, cfg.in_channels)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (batch, o, o)).astype(np.int32)
    gpu, _ = T.create_train_state(params, tc, "cuda")
    cpu, _ = T.create_train_state(params, tc, "cpu")
    torch.cuda.synchronize()
    _zero_launches()
    check = _gradient_vs_cpu(torch, f"bench hippocampus b{batch}", cfg, tc, gpu, cpu, x, y)
    launches = _read_launches()
    want = _per_step(cfg, batch)
    want["vmaxpool"] *= 2  # _decisions' record pools again for the taps
    if launches != want:
        _die(f"bench: the hippocampus b{batch} gradient launched {launches}, expected {want}")
    del check["grads"], check["choices"], check["card"], check["cpu"], gpu, cpu
    torch.cuda.empty_cache()
    return {"grad_max_rel_err_vs_cpu": check["max_rel_err"],
            "grad_share_of_limit": check["max_rel_err"] / TRAIN_GRAD_TOL,
            "ties_replayed": dict(check["ties"]), "launches": launches}


def _bench_gradient_bf16(torch, exp, batch, precision="highest"):
    """The bf16 twin of :func:`_bench_gradient` (bf16 is the bench's
    default): the step-1 gradient at ``batch`` under bf16 activations,
    counted (one step's launches), bit-equal to the same gradient with the
    kernels fed float32 through casts (each kernel rounds once where the
    casts rounded; cuDNN deterministic for the float32 filter gradients),
    and its loss within ``BF16_LOSS_RTOL`` of the float32 loss. Under
    ``precision="default"`` (the bench's, ``_default_precision``) the
    launches are at the one-pass plans, every kernel-1 launch one pass, and
    every kernel-1 call of the bf16 and the float32 gradient, forward and
    transposed pair, is held to its plain one pass in float64 on its own
    inputs (``_one_pass_checked``). Returns the loss error and the
    launches."""
    import numpy as np

    from supernet_tpu_torch import train as T
    from supernet_tpu_torch.ops.kernels import vdp_conv as V
    from supernet_tpu_torch.profiling import act_dtype

    cfg, tc = exp.model, exp.train
    rng = np.random.default_rng(SEED + 24)
    s, o = cfg.image_size, cfg.out_size
    x = torch.from_numpy(rng.normal(0.0, 1.0, (batch, s, s, cfg.in_channels))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (batch, o, o)).astype(np.int32)).cuda()
    state, _ = T.create_train_state(_he_params(torch, cfg), tc, "cuda")
    default = precision == "default"
    what = f"bench: the hippocampus b{batch} bf16 gradient" + (
        ' under "default"' if default else "")

    def grads(dtype, fed_float32=False):
        with act_dtype(dtype), _kernels_fed_float32(torch, fed_float32):
            loss, _ = T.loss_fn(state.params, x, y, cfg, tc)
            return float(loss.detach()), torch.autograd.grad(loss, T.leaves(state.params))

    def checked():
        return _one_pass_checked(torch, what) if default else contextlib.nullcontext({})

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False), \
            (_default_precision(torch) if default else contextlib.nullcontext()):
        torch.cuda.synchronize()
        _zero_launches()
        with checked() as calls16:
            loss16, g16 = grads("bfloat16")
        torch.cuda.synchronize()
        launches, bf16_pass = _read_launches(), V.bf16_launches
        loss_up, g_up = grads("bfloat16", fed_float32=True)
        with checked() as calls32:
            loss32, _ = grads("float32")
    want = _per_step(cfg, batch, precision)
    kernel1 = launches["vdp_conv"] + launches["vdp_conv_dgrad"]
    if launches != want or bf16_pass != (kernel1 if default else 0):
        _die(f"{what} launched {launches} ({bf16_pass} in one bf16 pass), expected {want}")
    if default and (calls16["forward_calls"], calls16["dgrad_calls"]) != (
            launches["vdp_conv"], launches["vdp_conv_dgrad"]):
        _die(f"{what}: {calls16} checked of the launches {launches}")
    if loss16 != loss_up or not all(torch.equal(a, b) for a, b in zip(g16, g_up)):
        worst = max(_max_rel(torch, a, b) for a, b in zip(g16, g_up))
        _die(f"{what} differs from the one with the kernels fed float32: losses "
             f"{loss16} / {loss_up}, {worst:.3e} of a leaf's max")
    loss_err = abs(loss16 - loss32) / abs(loss32)
    if not (all(bool(torch.isfinite(g).all()) for g in g16) and loss_err <= BF16_LOSS_RTOL):
        _die(f"{what}: loss {loss16} against float32's {loss32} ({loss_err:.3e} relative) "
             f"or a non-finite gradient")
    del state, g16, g_up
    torch.cuda.empty_cache()
    out = {"equal_to_kernels_fed_float32": True, "loss_max_rel_err_vs_float32": loss_err,
           "launches": launches}
    if default:
        out.update({"bf16_pass_launches": bf16_pass, "checked_calls_bf16": calls16,
                    "checked_calls_float32": calls32})
    return out


def _bench(torch, smi):
    """Phase 23: ``cli.main(["bench"])`` in process at the bench's defaults
    but ``SUPERNET_BENCH_ITERS=40``, every ``_bench_model`` call counted
    (the launches between its start and its end). The line must parse and
    name the card, the card's peaks, positive rates in every section, an
    MFU in (0, 1], ``hbm_utilization_min`` in (0, 1.05], a measured
    ``vs_baseline``, and no section error; a sweep's out-of-memory entry is
    allowed and printed on its own line. The hippocampus b20 headline run
    launches ``_per_step(cfg, 20, "default")`` per step, every kernel-1
    launch of the run in one bf16 pass; the naive baseline launches no
    kernel; the naive forward agrees with the kernel forward at
    ``BENCH_FORWARDS`` from He-scaled parameters, in float32 and bf16, and
    the hippocampus b64 gradient holds (``_bench_gradient`` and its bf16
    twin), at "highest"; and at the bench's "default" the same forwards and
    the bf16 gradient hold call by call against the plain one pass
    (``_bench_forward_default``, ``_bench_gradient_bf16``). Returns the
    headline's launches per step and the naive run's launches."""
    import io

    from supernet_tpu_torch import bench, cli
    from supernet_tpu_torch import flops as F
    from supernet_tpu_torch.configs import HIPPOCAMPUS
    from supernet_tpu_torch.ops import get_backend
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    t_phase = time.perf_counter()
    calls = []
    real = bench._bench_model

    def counted(name, n_iters, data_parallel, batch_override=0, device="cuda"):
        before, before_bf16 = _read_launches(), V.bf16_launches
        stats = real(name, n_iters, data_parallel, batch_override, device)
        after = _read_launches()
        calls.append({"model": name, "batch": stats["batch"], "n_iters": n_iters,
                      "backend": get_backend(),
                      "launches": {k: after[k] - before[k] for k in after},
                      "bf16_pass_launches": V.bf16_launches - before_bf16})
        return stats

    saved = os.environ.get("SUPERNET_BENCH_ITERS")
    os.environ["SUPERNET_BENCH_ITERS"] = BENCH_ITERS
    bench._bench_model = counted
    buf = io.StringIO()
    try:
        torch.cuda.synchronize()
        _zero_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench"])
        launches, bf16_pass = _read_launches(), V.bf16_launches
    finally:
        bench._bench_model = real
        if saved is None:
            os.environ.pop("SUPERNET_BENCH_ITERS")
        else:
            os.environ["SUPERNET_BENCH_ITERS"] = saved
    bench_s = time.perf_counter() - t_phase
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    if rc != 0 or len(lines) != 1:
        _die(f"bench: exit {rc}, printed {lines}")
    print(lines[0], flush=True)
    out = json.loads(lines[0])

    name = torch.cuda.get_device_name(0)
    peaks = BENCH_PEAKS.get(name) or (F.peak_tflops(0), F.peak_hbm_gbps(0))
    if out["device_kind"] != name or (out["peak_tflops"], out["peak_hbm_gbps"]) != peaks:
        _die(f"bench: device_kind {out['device_kind']!r}, peaks {out['peak_tflops']} / "
             f"{out['peak_hbm_gbps']}, expected {name!r} and {peaks}")
    rates = {"value": out["value"], "best": out["best"]["images_per_sec"],
             "brats": out["brats"].get("images_per_sec", 0.0),
             "unet3d": out["unet3d"].get("vols_per_sec", 0.0),
             "ensemble_train": out["ensemble_train"].get("member_images_per_sec", 0.0),
             "inference": out["inference"].get("images_per_sec", 0.0)}
    oom = _bench_scaling_errors(out)
    for section, b, msg in oom:
        print(json.dumps({"bench_batch_scaling_error": section, "batch": b, "error": msg}),
              flush=True)
    if not all(v > 0 for v in rates.values()):
        _die(f"bench: a rate is not positive: {rates}")
    if not (0 < out["mfu"] <= 1 and 0 < out["hbm_utilization_min"] <= 1.05):
        _die(f"bench: mfu {out['mfu']}, hbm_utilization_min {out['hbm_utilization_min']}")
    if out.get("vs_baseline_is_estimate") or "baseline_measured_images_per_sec" not in out:
        _die("bench: vs_baseline was not measured")

    cfg = HIPPOCAMPUS.model
    head = calls[0]
    k = int(os.environ.get("SUPERNET_BENCH_DISPATCH", "8"))
    steps = (1 + max(1, head["n_iters"] // k)) * k  # the warm-up call and the timed ones
    # the bench runs precision "default": kernel 1 in one bf16 pass, at the
    # plans (and split-K reduces) of that path; every kernel-1 launch of the
    # run, forward and transposed, must have taken it
    if out["precision"] != "default":
        _die(f"bench: precision {out['precision']!r}, expected the default \"default\"")
    kernel1 = launches["vdp_conv"] + launches["vdp_conv_dgrad"]
    head_k1 = head["launches"]["vdp_conv"] + head["launches"]["vdp_conv_dgrad"]
    if bf16_pass != kernel1 or head["bf16_pass_launches"] != head_k1 or not head_k1:
        _die(f"bench: {bf16_pass} of the run's {kernel1} kernel-1 launches and "
             f"{head['bf16_pass_launches']} of the headline's {head_k1} took one bf16 pass")
    want = _per_step(cfg, 20, precision="default")
    per_step = {kk: v // steps for kk, v in head["launches"].items()}
    if (head["model"], head["batch"], head["backend"]) != ("hippocampus", 20, "kernels") or (
            head["launches"] != _scaled(want, steps)):
        _die(f"bench: the headline run {head['model']} b{head['batch']} "
             f"({head['backend']}) launched {head['launches']} in {steps} steps, expected "
             f"{want} per step")
    naive_calls = [c for c in calls if c["backend"] == "naive"]
    naive = {kk: sum(c["launches"][kk] for c in naive_calls) for kk in want}
    if len(naive_calls) != 1 or any(naive.values()):
        _die(f"bench: the naive baseline runs {naive_calls}")
    for kernel in ("vdp_conv", "vmaxpool", "vmaxpool_bwd", "sigma_bwd"):
        if not launches[kernel] > 0:
            _die(f"bench: kernel {kernel} was not launched in the run: {launches}")

    # the kernels against plain versions at the line's 2-D shapes: the
    # kernels' plans (split-K slices, tiles per SM) follow the batch, and
    # the bench runs them on bf16 moments (its default) and on float32
    # (SUPERNET_ACT_DTYPE=float32), so both dtypes at the bench's batches
    agree = {f"{c}_b{b}{sfx}": _naive_agreement(torch, c, exp, b, dt)
             for c, exp, b in BENCH_FORWARDS
             for dt, sfx in (("float32", ""), ("bfloat16", "_bf16"))}
    agree["gradient_hippocampus_b64"] = _bench_gradient(torch, HIPPOCAMPUS, 64)
    agree["gradient_hippocampus_b64_bf16"] = _bench_gradient_bf16(torch, HIPPOCAMPUS, 64)
    # and at the bench's own precision, "default": kernel 1 in one bf16 pass,
    # call by call against its plain one pass, at the same batches
    t_default = time.perf_counter()
    default = {f"{c}_b{b}{sfx}": _bench_forward_default(torch, c, exp, b, dt)
               for c, exp, b in BENCH_FORWARDS
               for dt, sfx in (("float32", ""), ("bfloat16", "_bf16"))}
    default["gradient_hippocampus_b64_bf16"] = _bench_gradient_bf16(
        torch, HIPPOCAMPUS, 64, precision="default")
    default_s = time.perf_counter() - t_default
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({
        "bench": "cli bench in process", "card": smi, "iters": int(BENCH_ITERS),
        "headline_launches_per_step": per_step, "headline_steps": steps,
        "naive_launches": naive, "run_launches": launches,
        "run_bf16_pass_launches": bf16_pass,
        "headline_bf16_pass_launches_per_step": head["bf16_pass_launches"] // steps,
        "calls": [{kk: c[kk] for kk in ("model", "batch", "n_iters", "backend")}
                  for c in calls],
        "batch_scaling_errors": len(oom), "naive_vs_kernels": agree,
        "default_one_pass": default, "default_checks_s": default_s,
        "bench_s": bench_s, "phase_s": phase_s,
    }), flush=True)
    print(f"bench (phase 23): {phase_s:.1f} s (cli bench {bench_s:.1f} s); hippocampus b20 "
          f"{out['value']} img/s, mfu {out['mfu']}, vs_baseline {out['vs_baseline']} "
          f"({smi})", flush=True)
    return {**per_step, "bf16_pass": head["bf16_pass_launches"] // steps}, naive


def _pool_forward_checks(check, smi) -> None:
    """Phase 2's kernel 2: every pool of a hippocampus (b20) and a BraTS
    (b2) step in float32 and bf16 (the vector path), the block sizes and
    the scalar kernel at the same shapes, then ties, NaN, C = 130 (the
    scalar path in both dtypes), C = 36 (vector in float32, scalar in bf16)
    and C = 40 at an odd edge (vector in both). Prints the block sizes'
    sums per config and dtype."""
    from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS
    from supernet_tpu_torch.profiling import layer_shapes

    for config, cfg, batch in (("hippocampus", HIPPOCAMPUS.model, 20),
                               ("brats", BRATS.model, 2)):
        for layer, (_, h, w, c) in layer_shapes(cfg)[1]:
            check.vmaxpool(config, layer, batch, h, w, c)
            check.vmaxpool(config, layer, batch, h, w, c, bf16=True)
            check.vmaxpool_blocks(config, layer, batch, h, w, c)
    for bf16 in (False, True):
        check.vmaxpool("extra", "ties", 20, 60, 60, 32, ties=True, bf16=bf16)
        check.vmaxpool("extra", "nan", 20, 60, 60, 32, ties=True, nan=True, bf16=bf16)
        check.vmaxpool("extra", "odd", 3, 13, 15, 36, ties=True, bf16=bf16)
        check.vmaxpool("extra", "c40_odd", 3, 13, 15, 40, ties=True, nan=True, bf16=bf16)
        check.vmaxpool("extra", "c130", 3, 8, 8, 130, ties=True, bf16=bf16)
        check.vmaxpool("extra", "c130_odd", 3, 13, 15, 130, ties=True, bf16=bf16)
    for kernel in ("vmaxpool", "vmaxpool_bf16"):
        if check.paths[kernel] != {"vec", "scalar"}:
            _die(f"{kernel}: the shapes reached the paths {sorted(check.paths[kernel])}")
    sums = {}
    for (config, dtype, name), (hot, cold) in check.blocks.items():
        sums.setdefault(f"{config}_{dtype}", {})[name] = {"device_ms": hot,
                                                          "cold_device_ms": cold}
    print(json.dumps({"vmaxpool_blocks": "kernel 2, training form, summed over a step's "
                      "pools", "card": smi, "sums": sums}), flush=True)


# ------------------------------------------------------------- phase 24
# the norm kernel pair against its float64 plain version, like
# tests/test_torch_vdp_norm_card.py's TOL: an output or input gradient
# within NORM_TOL of the float64 result's largest magnitude, a gamma or beta
# gradient within NORM_TOL of the largest sum over the tokens of its terms'
# magnitudes (its terms have both signs, and their rounding scales with them)
NORM_TOL = 1e-5
# passes over the normalised tensor's size: what the kernels move (the
# slices' forward reads mu for the mean, mu and sigma for the sums, mu and
# sigma again for the outputs it writes) and each input read once, each
# output written once
NORM_PASSES = {"slices": (7, 10), "rows": (4, 6)}
NORM_IO_PASSES = (4, 6)
# the norms of one forward: Swin UNETR's 26 InstanceNorms and 25 LayerNorms,
# MedNeXt's 62 GroupNorm(C, C)s
NORMS_PER_FORWARD = {"swinunetr": 51, "mednext": 62}


def _norm_shapes(torch):
    """``{(model, shape, dims, affine): calls}`` of one forward of each plan
    with norms at its published size, recorded on the meta device: Swin
    UNETR at batch 1, MedNeXt at batch 2 (its GroupNorm(C, C), an
    InstanceNorm with a gamma and beta per channel)."""
    from supernet_tpu_torch import configs
    from supernet_tpu_torch.models import mednext3d, swin_unetr3d, unet3d
    from supernet_tpu_torch.ops import moments_swin

    seen = collections.Counter()
    plain = moments_swin.vnorm
    users = (moments_swin, mednext3d)  # the modules that call vnorm by name
    for model, cfg, module, batch in (("swinunetr", configs.SWINUNETR.model, swin_unetr3d, 1),
                                      ("mednext", configs.MEDNEXT.model, mednext3d, 2)):

        def record(mu, sigma, dims, gamma=None, beta=None, eps=moments_swin.NORM_EPS):
            seen[(model, tuple(mu.shape), tuple(dims), gamma is not None)] += 1
            return plain(mu, sigma, dims, gamma, beta, eps)

        params = {name: {key: torch.empty(shape, device="meta") for key, shape in p.items()}
                  for name, p in module.param_shapes(cfg).items()}
        s = cfg.image_size
        for user in users:
            user.vnorm = record
        try:
            with torch.no_grad():
                unet3d.forward3d(params, torch.empty((batch, s, s, s, cfg.in_channels),
                                                     device="meta"), cfg)
        finally:
            for user in users:
                user.vnorm = plain
    return dict(seen)


def _affine_scales(wide, gamma, stats, dims):
    """The scales of a norm's gamma and beta gradients in float64: the
    largest over the channels of the sum over the tokens of each term's
    magnitude (``g_mu' x`` and ``2 gamma g_sigma' inner / s^2``; ``g_mu'``),
    N the size of the normalised ``dims``. ``wide``: mu, sigma, g_mu,
    g_sigma."""
    mu, sigma, g_mu, g_sigma = wide
    m, s, a, b, d = stats
    n = math.prod(mu.shape[i] for i in dims)
    x = (mu - m) / s
    inner = sigma * (1.0 - 2.0 * (1.0 + x * x) / n) + (a + 2.0 * x * b + x * x * d) / n ** 2
    terms = (g_mu * x).abs() + (2.0 * gamma * g_sigma * inner / (s * s)).abs()
    return (float(terms.sum_to_size(gamma.shape).max()),
            float(g_mu.abs().sum_to_size(gamma.shape).max()))


def _vdp_norm_phase(torch, smi):
    """Phase 24: at every norm shape of one Swin UNETR step and one MedNeXt
    step (its slices with a gamma and beta per channel), the kernel pair
    (``ops/kernels/vdp_norm.py``) within NORM_TOL of its plain version run
    in float64 on the same float32 inputs, both directions, and timed by
    device time beside its byte bounds, its plain version (the closed form
    and its closed-form backward in PyTorch operations) and autograd of the
    closed form (the path before the kernels); one line per shape, then the
    sums over a step of each model. No single PyTorch call computes these moments, so
    ``library_ms`` is null."""
    from supernet_tpu_torch.ops import moments_swin as MS
    from supernet_tpu_torch.ops.kernels import vdp_norm as N
    from supernet_tpu_torch.profiling import HBM_BYTES_PER_S, device_ms

    t_phase = time.perf_counter()
    shapes = _norm_shapes(torch)
    for model, want in NORMS_PER_FORWARD.items():
        made = sum(calls for key, calls in shapes.items() if key[0] == model)
        if made != want:
            _die(f"vdp_norm: one {model} forward made {made} norms, not {want}")
    totals = {model: collections.Counter() for model in NORMS_PER_FORWARD}
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    for (model, shape, dims, affine), calls in sorted(shapes.items(),
                                                      key=lambda kv: -math.prod(kv[0][1])):
        kind = N.layout(shape, dims)
        c = shape[-1]
        mu = torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5
        sigma = torch.rand(shape, device="cuda", generator=g) * 0.1 + 1e-3
        g_mu, g_sigma = (torch.randn(shape, device="cuda", generator=g) for _ in range(2))
        gamma = torch.randn(c, device="cuda", generator=g) if affine else None
        beta = torch.randn(c, device="cuda", generator=g) if affine else None
        bshape = None if beta is None else beta.shape
        eps = MS.NORM_EPS
        out = N.norm_fwd(mu, sigma, dims, gamma, beta, eps)
        grads = N.norm_bwd(mu, sigma, g_mu, g_sigma, gamma, bshape, out[2], dims, affine)
        wide = [t.double() for t in (mu, sigma, g_mu, g_sigma)]
        w_gamma = None if gamma is None else gamma.double()
        r_mu, r_sigma, r_stats = N.norm_fwd_plain(wide[0], wide[1], dims, w_gamma,
                                                  None if beta is None else beta.double(), eps)
        r_grads = N.norm_bwd_plain(*wide, w_gamma, bshape, r_stats, dims)
        errs = {}
        for name, got, want in (("mu", out[0], r_mu), ("sigma", out[1], r_sigma),
                                ("d_mu", grads[0], r_grads[0]),
                                ("d_sigma", grads[1], r_grads[1])):
            errs[name] = float((got.double() - want).abs().max() / want.abs().max())
        if affine:
            scale_g, scale_b = _affine_scales(wide, w_gamma, r_stats, dims)
            errs["d_gamma"] = float((grads[2].double() - r_grads[2]).abs().max()) / scale_g
            errs["d_beta"] = float((grads[3].double() - r_grads[3]).abs().max()) / scale_b
        del wide, r_mu, r_sigma, r_stats, r_grads
        if not all(math.isfinite(v) and v < NORM_TOL for v in errs.values()):
            _die(f"vdp_norm {model} {shape} {dims}: {errs} against float64 (limit {NORM_TOL})")
        fwd_ms = device_ms(lambda: N.norm_fwd(mu, sigma, dims, gamma, beta, eps))
        bwd_ms = device_ms(lambda: N.norm_bwd(mu, sigma, g_mu, g_sigma, gamma, bshape, out[2],
                                              dims, affine))
        plain_fwd_ms = device_ms(lambda: N.norm_fwd_plain(mu, sigma, dims, gamma, beta, eps),
                                 runs=5)
        p_stats = N.norm_fwd_plain(mu, sigma, dims, gamma, beta, eps)[2]
        plain_bwd_ms = device_ms(lambda: N.norm_bwd_plain(mu, sigma, g_mu, g_sigma, gamma, bshape,
                                                          p_stats, dims), runs=5)
        leaves = [t.clone().requires_grad_() for t in (mu, sigma, gamma, beta) if t is not None]

        def autograd_step():
            it = iter(leaves)
            m_, s_ = next(it), next(it)
            g_, b_ = (next(it), next(it)) if affine else (None, None)
            torch.autograd.backward(N.norm_fwd_plain(m_, s_, dims, g_, b_, eps)[:2],
                                    [g_mu, g_sigma])

        autograd_ms = device_ms(autograd_step, runs=5)
        del leaves, p_stats
        nbytes = 4 * mu.numel()
        fwd_passes, bwd_passes = NORM_PASSES[kind]
        line = {
            "kernel": "vdp_norm", "model": model, "layout": kind, "shape": list(shape),
            "affine": affine,
            "calls_per_forward": calls, "max_rel_err_vs_float64": errs,
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "bound_fwd_ms": 1e3 * fwd_passes * nbytes / HBM_BYTES_PER_S,
            "bound_bwd_ms": 1e3 * bwd_passes * nbytes / HBM_BYTES_PER_S,
            "io_bound_fwd_ms": 1e3 * NORM_IO_PASSES[0] * nbytes / HBM_BYTES_PER_S,
            "io_bound_bwd_ms": 1e3 * NORM_IO_PASSES[1] * nbytes / HBM_BYTES_PER_S,
            "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
            "autograd_ms": autograd_ms, "library_ms": None,
        }
        line["fwd_over_bound"] = fwd_ms / line["bound_fwd_ms"]
        line["bwd_over_bound"] = bwd_ms / line["bound_bwd_ms"]
        line["fwd_over_io_bound"] = fwd_ms / line["io_bound_fwd_ms"]
        line["bwd_over_io_bound"] = bwd_ms / line["io_bound_bwd_ms"]
        print(json.dumps(line), flush=True)
        for key in ("fwd_ms", "bwd_ms", "bound_fwd_ms", "bound_bwd_ms", "io_bound_fwd_ms",
                    "io_bound_bwd_ms", "plain_fwd_ms", "plain_bwd_ms", "autograd_ms"):
            totals[model][key] += calls * line[key]
        del mu, sigma, g_mu, g_sigma, out, grads
        torch.cuda.empty_cache()
    for model, sums in totals.items():
        per_step = dict(sums)
        for way in ("fwd", "bwd"):
            per_step[f"{way}_over_bound"] = per_step[f"{way}_ms"] / per_step[f"bound_{way}_ms"]
            per_step[f"{way}_over_io_bound"] = (per_step[f"{way}_ms"]
                                                / per_step[f"io_bound_{way}_ms"])
        print(json.dumps({"kernel": "vdp_norm", "model": model, "per_step": per_step,
                          "card": smi}), flush=True)
    print(json.dumps({"kernel": "vdp_norm", "phase_s": time.perf_counter() - t_phase}),
          flush=True)


def norm_phase() -> int:
    """Phase 24 alone: the setup's checks, then :func:`_vdp_norm_phase`."""
    import torch

    smi = _setup(torch)
    _vdp_norm_phase(torch, smi)
    print(json.dumps({"ok": True, "phase": 24}), flush=True)
    return 0


def _setup(torch) -> str:
    """Phase 1: the card is there, the package imports, TF32 is off, the
    kernels build and load. Returns the card's name and power limit."""
    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False; this script drives the "
             "port on an NVIDIA card and has no CPU fallback")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from supernet_tpu_torch.ops import set_mxu_precision
        from supernet_tpu_torch.ops.kernels import _lib
    except ModuleNotFoundError as e:
        _die(f"{e}: run chip_smoke.py from the root of a checkout")

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
    return smi


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Drive the port on one NVIDIA card.")
    parser.add_argument("--last-phase", type=int, choices=(7, 23, 24), default=24,
                        help="7: stop after the kernels, serving and training (phases 2-7); "
                             "23: stop before the norm kernel pair (phase 24)")
    last_phase = parser.parse_args().last_phase
    smi = _setup(torch)  # 1. setup
    from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS
    from supernet_tpu_torch.profiling import layer_shapes

    # 2. kernels at every layer shape of the two configs, then extra cases
    check = KernelCheck(torch)
    for config, cfg, batch in (("hippocampus", HIPPOCAMPUS.model, 20),
                               ("brats", BRATS.model, 2)):
        convs = layer_shapes(cfg)[0]
        for layer, (_, h, w, cin), cout in convs:
            check.vdp_conv(config, layer, batch, h, w, cin, cout, 3,
                           has_sigma=layer != "conv_input", relu=True)
            check.vdp_conv_bf16(config, layer, batch, h, w, cin, cout, 3,
                                has_sigma=layer != "conv_input", relu=True)
            for bf16 in (False, True):
                check.vdp_conv_default(config, layer, batch, h, w, cin, cout,
                                       has_sigma=layer != "conv_input", bf16=bf16)
    # one bf16 pass with a member axis: K=4 hippocampus members reading one
    # batch (member stride 0), K=2 BraTS members at a split-K layer
    for config, cfg, batch, layer, k_n, shared in (
            ("hippocampus", HIPPOCAMPUS.model, 20, "conv1", 4, True),
            ("brats", BRATS.model, 2, "conv8", 2, False)):
        (_, h, w, cin), cout = {n: (shp, c) for n, shp, c in layer_shapes(cfg)[0]}[layer]
        check.default_members(config, layer, batch, h, w, cin, cout, k_n, shared)
    for k in (2, 1):
        for has_sigma in (True, False):
            for relu in (False, True):
                check.vdp_conv("extra", f"k{k}", 4, 33, 29, 24, 40, k, has_sigma, relu)
    check.vdp_conv("extra", "k3_no_relu", 3, 17, 19, 3, 96, 3, True, False)
    check.vdp_conv_bf16("extra", "k2", 4, 33, 29, 24, 40, 2, True, True)
    check.vdp_conv_bf16("extra", "k1_input", 4, 33, 29, 24, 40, 1, False, False)
    check.vdp_conv_bf16("extra", "k3_no_relu", 3, 17, 19, 3, 96, 3, True, False)
    check.vdp_conv_bf16("extra", "k3_c130", 3, 17, 19, 24, 130, 3, True, True)
    # kernel 1 at every k=3 layer of a BraTS chunk of 20, the serving cells'
    # batch
    for layer, (_, h, w, cin), cout in layer_shapes(BRATS.model)[0]:
        check.chunk_layer("brats_chunk20", layer, 20, h, w, cin, cout,
                          has_sigma=layer != "conv_input")
    print(json.dumps({"kernel": "vdp_conv_chunk", "config": "brats_chunk20",
                      "sums": dict(zip(("device_ms", "bound_3xtf32_ms", "dgrad_device_ms",
                                        "dgrad_bound_3xtf32_ms"),
                                       check.chunk["brats_chunk20"]))}), flush=True)
    _pool_forward_checks(check, smi)

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
            check.dgrad(config, layer, batch, h, w, cin, cout,
                        with_sigma=layer != "conv_input")
            check.vdp_conv_bwd(config, layer, batch, h, w, cin, cout, 3,
                               has_sigma=layer != "conv_input", relu=True)
            check.sigma_bwd_bf16(config, layer, batch, h - 2, w - 2, cout, 3)
            check.dgrad_bf16(config, layer, batch, h, w, cin, cout,
                             with_sigma=layer != "conv_input")
            for bf16 in (False, True):
                check.dgrad_default(config, layer, batch, h, w, cin, cout,
                                    with_sigma=layer != "conv_input", bf16=bf16)
            check.vdp_conv_bwd_bf16(config, layer, batch, h, w, cin, cout, 3,
                                    has_sigma=layer != "conv_input", relu=True)
        for layer, (_, h, w, c) in pools:
            check.vmaxpool_bwd(config, layer, batch, h, w, c)
            check.vmaxpool_bwd_bf16(config, layer, batch, h, w, c)
    check.vmaxpool_bwd("extra", "ties", 20, 60, 60, 32, ties=True)
    check.vmaxpool_bwd("extra", "c130", 3, 8, 8, 130, ties=True)
    check.vmaxpool_bwd("extra", "odd", 3, 13, 15, 36, ties=True)
    check.vmaxpool_bwd("extra", "c64_odd", 2, 9, 7, 64, ties=True)
    check.vmaxpool_bwd("extra", "c130_odd", 3, 13, 15, 130, ties=True)
    check.sigma_bwd("extra", "c130_odd", 3, 17, 19, 130, 3)
    check.sigma_bwd("extra", "c36_odd", 3, 17, 19, 36, 3)
    check.sigma_bwd("extra", "k2", 4, 32, 28, 40, 2)
    # bf16: a 16-byte load holds 8 channels, so C = 36 takes the pool
    # backward's general kernel; kernel 4 keeps the float32 plan
    check.vmaxpool_bwd_bf16("extra", "ties", 20, 60, 60, 32, ties=True)
    check.vmaxpool_bwd_bf16("extra", "c130", 3, 8, 8, 130, ties=True)
    check.vmaxpool_bwd_bf16("extra", "odd", 3, 13, 15, 36, ties=True)
    check.vmaxpool_bwd_bf16("extra", "c64_odd", 2, 9, 7, 64, ties=True)
    check.sigma_bwd_bf16("extra", "c130_odd", 3, 17, 19, 130, 3)
    check.sigma_bwd_bf16("extra", "c36_odd", 3, 17, 19, 36, 3, t_bf16=True)
    check.sigma_bwd_bf16("extra", "c130_odd", 3, 17, 19, 130, 3, t_bf16=True)
    check.sigma_bwd_bf16("extra", "hippocampus_conv1", 20, 60, 60, 32, 3, t_bf16=True)
    check.dgrad_bf16("extra", "k3_c130", 3, 17, 19, 130, 24, True)
    check.vdp_conv_bwd_bf16("extra", "k3_no_relu_c130", 3, 17, 19, 24, 130, 3, True, False)
    check.vdp_conv_bwd_bf16("extra", "k2_relu", 4, 33, 29, 24, 40, 2, True, True)
    for kernel, both in (("vmaxpool_bwd", {"vec4", "scalar"}),
                         ("sigma_bwd", {"vec4", "rows"}),
                         ("vmaxpool_bwd_bf16", {"vec4", "scalar"}),
                         ("sigma_bwd_bf16", {"vec4", "rows"}),
                         ("sigma_bwd_bf16_t", {"vec4", "rows"})):
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
        if last_phase == 7:
            print(json.dumps({"ok": True, "last_phase": 7}), flush=True)
            return 0

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
        conv_calls = _backward_conv_calls(torch, "brats", BRATS, 2)
        adv_step_s, plain_step_s = _adversarial_train_step(torch, smi)

        # 13-15. adversarial evaluation, the testing protocol and the
        # calibration report against the CPU, the evaluation CLI
        with tempfile.TemporaryDirectory() as tmp:
            adv_launches, pgd_batch_s = _run_adversarial(
                torch, smi, tmp, "hippocampus", 20, 40)
            _, fgsm_batch_s = _run_adversarial(torch, smi, tmp, "brats", 2, 4)
            _, test_batch_s, sweep_s = _evaluation(torch, smi, tmp)
            study_launches = _eval_cli(torch, tmp)

    # 16. bf16 activations; 17. the ensemble session, cli export and the
    # enqueued request
    bf16_launches = _bf16(torch, smi)
    with tempfile.TemporaryDirectory() as tmp:
        ensemble_launches = _serving_rest(torch, smi, tmp)

    # 18. the 3-D family at full width
    with tempfile.TemporaryDirectory() as tmp:
        three_d_launches = _three_d(torch, smi, tmp)

    # 19. deep ensembles: the member axis of kernels 1 and 4, the ensemble
    # steps, the CLI, the session, the 3-D step and the modes' times
    with tempfile.TemporaryDirectory() as tmp:
        member_sums, ens_per_step, ens_session, ens_modes = _ensembles(torch, smi, tmp)

    # 20. the glue fold on the card, in 2-D and 3-D; 21. cli profile
    fold_launches = _lowerings(torch, smi)
    with tempfile.TemporaryDirectory() as tmp:
        profile_per_step = _profile_cli(torch, smi, tmp)

    # 22. parallelism on the card: the sharded steps, the 3-D ones and the
    # entry points on a one-rank NCCL mesh
    with tempfile.TemporaryDirectory() as tmp:
        par_hip, par_brats, par_fold = _parallel(torch, smi, tmp)

    # 23. the benchmark: cli bench in process, its launches per step, the
    # naive baseline at 0 launches, the naive forward against the kernels'
    bench_hip, bench_naive = _bench(torch, smi)

    # 24. the norm kernel pair at the Swin UNETR and MedNeXt steps' shapes
    if last_phase == 24:
        _vdp_norm_phase(torch, smi)

    sources = {
        "vdp_conv": ("supernet_tpu_torch/csrc/vdp_conv.cuh",
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
    # hippocampus images (phase 13); study_launches: cli study (phase 15);
    # three_d_launches: the whole of phase 18 (0: the 3-D family has no
    # hand-written kernel); ensemble_train_launches_per_step: one K=4 vmap
    # step at hippocampus batch 20 (phase 19); ensemble_session_chunk_launches:
    # one chunk of a 3-member EnsembleSession (phase 19);
    # glue_fold_train_launches_per_step: one hippocampus step (batch 20) under
    # the glue fold (phase 20); cli_profile_launches_per_step: one step of
    # cli profile's hippocampus run, joined from its trace (phase 21);
    # parallel_train_launches_per_step: one hippocampus data-parallel step
    # (batch 20) on the one-rank NCCL mesh, parallel_spatial_* and
    # parallel_hybrid_* the spatial and hybrid steps', brats_parallel_* one
    # BraTS data-parallel step, parallel_spatial_fold_* one hippocampus
    # spatial step under the glue fold (phase 22);
    # bench_train_launches_per_step: one step of cli bench's hippocampus b20
    # headline run, bench_naive_launches: its naive baseline run (phase 23).
    # member_axis_*: the
    # member-axis launch summed over the layers of one hippocampus step (K=4,
    # batch 20; brats_member_axis_*: BraTS, K=2, batch 2) beside K single
    # launches, CUDA events and device time.
    # vdp_conv's bound_ms is the CUDA cores' float32 bound; bound_3xtf32_ms
    # that of its tensor-core path, and bf16_bound_2xtf32_ms that path's on
    # bf16 moments, whose small TF32 half is 0 (two passes).
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
            # the form without the window sum (VDPConv's transposed
            # convolutions): launches in the hippocampus training run, per
            # step and per attack gradient; its times and error summed over
            # the layer shapes of one step like the forward's, beside the
            # two cuDNN conv_transpose2d calls it replaced
            d_h, d_b = check.ms[("vdp_conv_dgrad", "hippocampus")], check.ms[("vdp_conv_dgrad", "brats")]
            (dd, dc, db3), (dd_b, dc_b, db3_b) = check.dgrad_ms["hippocampus"], check.dgrad_ms["brats"]
            extra.update({
                "dgrad_launches": train_launches["vdp_conv_dgrad"],
                "dgrad_reduce_launches": train_launches["vdp_conv_dgrad_reduce"],
                "dgrad_launches_per_step": per_step["vdp_conv_dgrad"],
                "attack_gradient_dgrad_launches": grad_launches["vdp_conv_dgrad"],
                "dgrad_max_rel_err": check.worst["vdp_conv_dgrad"][1],
                "dgrad_ms": d_h[0], "dgrad_plain_ms": d_h[1], "dgrad_bound_ms": d_h[2],
                "dgrad_device_ms": dd, "dgrad_cudnn_conv_transpose_ms": dc,
                "dgrad_bound_3xtf32_ms": db3,
                "brats_dgrad_ms": d_b[0], "brats_dgrad_plain_ms": d_b[1],
                "brats_dgrad_bound_ms": d_b[2], "brats_dgrad_device_ms": dd_b,
                "brats_dgrad_cudnn_conv_transpose_ms": dc_b,
                "brats_dgrad_bound_3xtf32_ms": db3_b,
                "backward_conv_max_rel_err_vs_float64": conv_calls,
            })
            # one bf16 pass (precision "default", phases 2 and 5), summed
            # over the layer shapes like device_ms: device time, the bound at
            # 989 TFLOP/s, cuDNN's bf16 conv of mu alone (conv_transpose2d of
            # g1 alone for the transposed pair), the worst error against the
            # plain version's one pass in float64; and the one-pass launches
            # per step of the bench's headline (phase 23)
            for config, cpre in (("hippocampus", ""), ("brats", "brats_")):
                for tag, dpre in (("float32", ""), ("bf16", "bf16_")):
                    for mode, mpre in (("forward", ""), ("dgrad", "dgrad_")):
                        dev, bound, lib, err = check.default[(config, tag, mode)]
                        key = f"{cpre}{dpre}{mpre}default_"
                        extra.update({key + "device_ms": dev, key + "bound_bf16_ms": bound,
                                      key + "cudnn_bf16_ms": lib,
                                      key + "max_rel_err_vs_float64": err})
            extra["bench_bf16_pass_launches_per_step"] = bench_hip["bf16_pass"]
            # the seconds the one-pass cases of phases 2 and 5 took (phases 3
            # and 4 print their request's under "default" / "seconds")
            extra["default_checks_s"] = check.default_s
        else:
            # the stream held by a sleep, so no host time counts; summed like ms
            extra = {"device_ms": check.dev[(kernel, "hippocampus")],
                     "brats_device_ms": check.dev[(kernel, "brats")]}
            if kernel in check.paths:
                extra["paths"] = sorted(check.paths[kernel])
        if kernel == "vmaxpool":
            # kernel 2's other times, summed like device_ms: L2-cold, and the
            # training form (idx written) hot and cold beside its own bound
            extra["bf16_paths"] = sorted(check.paths["vmaxpool_bf16"])
            for config, pre in (("hippocampus", ""), ("brats", "brats_")):
                for k2, pre2 in (("vmaxpool", ""), ("vmaxpool_bf16", "bf16_")):
                    for key, v in check.pool_fwd[(k2, config)].items():
                        if key != "device_ms":
                            extra[f"{pre}{pre2}{key}"] = v
        # the bf16 case of phases 2 and 5 at the same shapes: the kernel on
        # bf16 inputs (equal to its float32 run on their upcast) beside its
        # plain version and its bound at 2-byte moments
        for config, pre in (("hippocampus", "bf16_"), ("brats", "brats_bf16_")):
            b_ms, b_plain, b_bound = check.ms[(kernel + "_bf16", config)][:3]
            extra.update({f"{pre}ms": b_ms, f"{pre}plain_ms": b_plain,
                          f"{pre}bound_ms": b_bound})
            if kernel == "vdp_conv":
                extra[f"{pre}device_ms"] = check.vdp[(config, "bf16")][0]
                extra[f"{pre}bound_2xtf32_ms"] = check.vdp[(config, "bf16")][2]
                d = check.ms[("vdp_conv_dgrad_bf16", config)]
                extra.update({f"{pre}dgrad_ms": d[0], f"{pre}dgrad_plain_ms": d[1],
                              f"{pre}dgrad_bound_ms": d[2],
                              f"{pre}dgrad_device_ms": check.dev[("vdp_conv_dgrad_bf16",
                                                                  config)],
                              f"{pre}dgrad_bound_2xtf32_ms":
                                  check.dgrad_ms[(config, "bf16")][2]})
            else:
                extra[f"{pre}device_ms"] = check.dev[(kernel + "_bf16", config)]
        extra["bf16_max_rel_err"] = check.worst[kernel + "_bf16"][1]
        extra["bf16_equal_to_float32_on_upcast"] = True
        for mk, prefix in ((kernel, "member_axis_"), ("vdp_conv_dgrad", "member_axis_dgrad_")):
            if (mk, "hippocampus") not in member_sums or (
                    mk == "vdp_conv_dgrad" and kernel != "vdp_conv"):
                continue
            for config, pre in (("hippocampus", ""), ("brats", "brats_")):
                m_ms, k_ms, m_dev, k_dev, m_abs, m_rel = member_sums[(mk, config)]
                extra.update({f"{pre}{prefix}ms": m_ms, f"{pre}{prefix}k_single_ms": k_ms,
                              f"{pre}{prefix}device_ms": m_dev,
                              f"{pre}{prefix}k_single_device_ms": k_dev,
                              f"{pre}{prefix}max_rel_err": m_rel})
        # the member launches on bf16 (phase 19), summed over the layers
        for mk, prefix in ((kernel, "member_axis_bf16_"),
                           ("vdp_conv_dgrad", "member_axis_dgrad_bf16_")):
            if (mk + "_bf16", "hippocampus") not in member_sums or (
                    mk == "vdp_conv_dgrad" and kernel != "vdp_conv"):
                continue
            for config, pre in (("hippocampus", ""), ("brats", "brats_")):
                dev, err = member_sums[(mk + "_bf16", config)]
                extra.update({f"{pre}{prefix}device_ms": dev, f"{pre}{prefix}max_rel_err": err})
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
            "bf16_train_launches": bf16_launches["hippocampus"]["bfloat16"][kernel],
            "ensemble_chunk_launches": ensemble_launches[kernel],
            "three_d_launches": three_d_launches[kernel],
            "ensemble_train_launches_per_step": ens_per_step[kernel],
            "ensemble_session_chunk_launches": ens_session[kernel],
            "glue_fold_train_launches_per_step": fold_launches[kernel],
            "cli_profile_launches_per_step": profile_per_step[kernel],
            "parallel_train_launches_per_step": par_hip["data"][kernel],
            "parallel_spatial_train_launches_per_step": par_hip["spatial"][kernel],
            "parallel_hybrid_train_launches_per_step": par_hip["hybrid"][kernel],
            "brats_parallel_train_launches_per_step": par_brats["data"][kernel],
            "parallel_spatial_fold_launches_per_step": par_fold["spatial"][kernel],
            "bench_train_launches_per_step": bench_hip[kernel],
            "bench_naive_launches": bench_naive[kernel],
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
        "vdp_conv_backward": "VDPConv.backward (kernel 4, kernel 1 without the window "
                             "sum, cuDNN's filter gradients)",
        "max_abs_err": check.worst["vdp_conv_bwd"][0],
        "max_rel_err": check.worst["vdp_conv_bwd"][1],
        "ms": bwd[0], "plain_ms": bwd[1],
        "brats_ms": bwd_b[0], "brats_plain_ms": bwd_b[1],
        "bf16_max_rel_err": check.worst["vdp_conv_bwd_bf16"][1],
        "bf16_ms": check.ms[("vdp_conv_bwd_bf16", "hippocampus")][0],
        "bf16_plain_ms": check.ms[("vdp_conv_bwd_bf16", "hippocampus")][1],
        "brats_bf16_ms": check.ms[("vdp_conv_bwd_bf16", "brats")][0],
        "brats_bf16_plain_ms": check.ms[("vdp_conv_bwd_bf16", "brats")][1],
        "bf16_equal_to_float32_on_upcast": True,
    }))
    print(f"hippocampus serving: {img_s:.1f} img/s (batch 20, 45-image request)")
    print(f"hippocampus training: {20 / step_s:.1f} img/s "
          f"(batch 20, median step {1e3 * step_s:.3f} ms)")
    print("hippocampus ensemble, K=4, batch 20, per member-step: " + ", ".join(
        f"{m} {ens_modes[m]['member_step_ms']:.3f} ms" for m in ("vmap", "unroll", "sequential")))
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
