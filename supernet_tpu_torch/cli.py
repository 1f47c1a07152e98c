"""Command-line interface of the port: the subcommands and flags of
``supernet_tpu/cli.py``, plus ``--device``.

    python -m supernet_tpu_torch.cli train --config hippocampus --data X.pkl
    python -m supernet_tpu_torch.cli train --config hippocampus --synthetic 100
    python -m supernet_tpu_torch.cli convert --config hippocampus --data X.pkl --out SHARDS
    python -m supernet_tpu_torch.cli eval   --config hippocampus --checkpoint RUN --synthetic 100
    python -m supernet_tpu_torch.cli attack --config brats --checkpoint RUN --data 'batches/*.pkl'
    python -m supernet_tpu_torch.cli study  --config hippocampus --synthetic 400 --epochs 5
    python -m supernet_tpu_torch.cli export --config hippocampus --checkpoint RUN --out-dir BUNDLE
    python -m supernet_tpu_torch.cli train3d --config hippocampus --synthetic 40 --epochs 2
    python -m supernet_tpu_torch.cli eval3d --config hippocampus --checkpoint RUN3D --synthetic 8
    python -m supernet_tpu_torch.cli predict3d --config hippocampus --checkpoint RUN3D --volume V.nii.gz
    python -m supernet_tpu_torch.cli profile --config hippocampus --batch 20 --by-layer

``train``, ``convert`` (``--to-cubes`` too), ``eval``, ``sweep``,
``attack``, ``calibrate``, ``saliency``, ``study``, ``export``
(``--volumetric`` too) and the 3-D family's ``train3d``, ``predict3d``,
``eval3d``, ``attack3d``, ``calibrate3d`` and ``saliency3d`` run, each
printing the JSON line(s) and writing the files of its twin; ``profile``
traces K-step train calls and prints and writes the exact-join tables
(``hlo_profile.run``). ``bench`` parses its flags and then raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it, as do
``--data-parallel``, ``--spatial-shard`` and ``--hybrid-shard``. ``train --ensemble K`` and
``train3d --ensemble K`` (K > 1) train a deep ensemble into
``member_{k}/`` (``--ensemble-mode``: ``vmap``, ``unroll`` / ``scan``,
``sequential``, or ``auto``, which ``ensemble.choose_ensemble_mode``
decides with the card's numbers).
``--checkpoint`` takes a run directory (its latest ``epoch_{N}/state.pt``),
one ``epoch_{N}`` directory, an ``.npz`` or (2-D only) a Keras ``.h5``;
``eval``, ``calibrate``, ``sweep``, ``eval3d``, ``calibrate3d`` and
``predict3d`` also a comma-separated list of them, the members of a deep
ensemble. The 3-D commands take ``--cube-size``, ``--base-kernels`` and
``--depth`` and derive the output cube from the geometry. ``--device``
defaults to ``cuda``: nothing falls back to the CPU when no card is found.
``--synthetic N`` substitutes a generated dataset for the real data.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# subcommand -> the ROADMAP.md item (Queue 1) that ports it
_UNPORTED = {
    "bench": "'Port bench and FLOP counts' (supernet_tpu_torch.bench)",
}


_UNSET = object()


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: {item})"
    )


def _add_common(
    p: argparse.ArgumentParser,
    dp_help: str = "shard the batch over all visible devices",
) -> None:
    p.add_argument("--config", default="hippocampus",
                   choices=["hippocampus", "brats", "lungs"])
    p.add_argument("--data", default=None, help="dataset pickle/pattern")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic samples instead of real data")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint root (restores the latest "
                        "epoch_{N}), a specific .../epoch_{N} dir, "
                        ".npz params, or Keras .h5 weights")
    p.add_argument("--data-parallel", action="store_true", help=dp_help)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; there "
                        "is no fallback to the CPU)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="supernet_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a VDP U-Net")
    _add_common(t)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--kl-factor", type=float, default=None)
    t.add_argument("--continue-training", action="store_true")
    t.add_argument("--val-data", default=None,
                   help="separate validation dataset (shard dir / pickle "
                        "glob); required for meaningful validation when "
                        "--data is a shard directory or glob")
    t.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K>1 runs K train steps per call on one stacked "
                        "chunk - one copy and one metric fetch per chunk")
    t.add_argument("--adversarial-training", default=None,
                   choices=["none", "fgsm", "pgd"],
                   help="train on adv_alpha*L(clean)+(1-adv_alpha)*L(adv) "
                        "with FGSM/PGD examples generated in the step")
    t.add_argument("--adv-epsilon", type=float, default=None,
                   help="L-inf radius for adversarial training")
    t.add_argument("--ensemble", type=int, default=1, metavar="K",
                   help="K>1 trains K independent members (init seeds "
                        "seed..seed+K-1, independent data shuffles) into "
                        "member_{k}/ subdirectories; serve them with a "
                        "comma-separated --checkpoint list")
    t.add_argument("--ensemble-mode", default="auto",
                   choices=["auto", "vmap", "scan", "unroll", "sequential"],
                   help="auto (default): all K members train in one step, "
                        "unrolled over the member axis single-device, vmap "
                        "with --data-parallel (members shard over the "
                        "devices); vmap/scan/unroll force that lowering; "
                        "sequential: K separate full trainings")
    t.add_argument("--adv-alpha", type=float, default=None,
                   help="clean-loss weight (0 = train on adversarial only)")
    t.add_argument("--adv-steps", type=int, default=None,
                   help="PGD iteration count for --adversarial-training pgd")
    t.add_argument("--adv-step-size", type=float, default=None,
                   help="PGD per-step size for --adversarial-training pgd")
    def _add_augment(p: argparse.ArgumentParser) -> None:
        p.add_argument("--augment", action="store_true",
                       help="on-device augmentation inside the train step "
                            "(axis flips by default; see --augment-* knobs)")
        p.add_argument("--augment-rot90", action="store_true",
                       help="also rotate by a random multiple of 90 degrees "
                            "(volumes: in the axial H-W plane)")
        p.add_argument("--augment-intensity", type=float, default=0.0,
                       help="intensity jitter: scale U[1±v] and shift "
                            "U[±v/2]")
        p.add_argument("--augment-noise-std", type=float, default=0.0,
                       help="additive Gaussian pixel-noise std")

    _add_augment(t)

    def _add_3d_shape(p: argparse.ArgumentParser) -> None:
        p.add_argument("--cube-size", type=int, default=0,
                       help="input cube side (default: the config's "
                            "image_size, e.g. 64 -> 54^3 output)")
        p.add_argument("--base-kernels", type=int, default=0,
                       help="override the config's channel width")
        p.add_argument("--depth", type=int, default=0,
                       help="override the config's encoder depth")

    t3 = sub.add_parser(
        "train3d",
        help="train the volumetric VDP U-Net on cubes (NIfTI task dir or "
             "--synthetic); out_size is derived from the geometry",
    )
    _add_common(t3)
    _add_3d_shape(t3)
    _add_augment(t3)
    t3.add_argument("--epochs", type=int, default=None)
    t3.add_argument("--lr", type=float, default=None)
    t3.add_argument("--kl-factor", type=float, default=None)
    t3.add_argument("--continue-training", action="store_true")
    t3.add_argument("--val-frac", type=float, default=0.2,
                    help="trailing fraction of volumes held out")
    t3.add_argument("--spatial-shard", action="store_true",
                    help="shard each volume's scan (D) axis over the mesh "
                         "instead of the batch (whole-volume regime); "
                         "implies a mesh over all devices")
    t3.add_argument("--hybrid-shard", type=int, default=0, metavar="N_DATA",
                    help="hybrid sharding: a 2-D (N_DATA x "
                         "devices/N_DATA) mesh with the batch over the "
                         "data axis AND each volume's scan (D) axis over "
                         "the space axis, in the same step")
    t3.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K>1 runs K train steps per call on one stacked "
                         "chunk - one copy and one metric fetch per chunk")
    t3.add_argument("--ensemble", type=int, default=1, metavar="K",
                    help="K>1 trains K independent members (init seeds "
                         "seed..seed+K-1, independent data shuffles) into "
                         "member_{k}/ subdirectories; predict3d serves "
                         "them via a comma-separated --checkpoint list")
    t3.add_argument("--ensemble-mode", default="auto",
                    choices=["auto", "vmap", "scan", "unroll",
                             "sequential"],
                    help="auto (default): all K members train as ONE "
                         "compiled program — unrolled over the member "
                         "axis single-device, vmap with --data-parallel "
                         "(members shard over the devices); "
                         "vmap/scan/unroll force that lowering; "
                         "sequential: K separate full trainings")
    t3.add_argument("--init-from-2d", metavar="CKPT", default=None,
                    help="transfer init: inflate a trained 2-D checkpoint "
                         "(epoch dir / .npz / Keras .h5) of the SAME "
                         "config into the 3-D model (I3D-style: mean "
                         "kernel tiled over depth / k, weight variance / "
                         "k; see models.inflate_params3d)")

    _DP3D_HELP = (
        "spatial sharding for the 3-D family: the volume's scan (D) axis "
        "is split over all devices (NOT batch DP — whole-volume regime)"
    )

    e3 = sub.add_parser(
        "eval3d",
        help="volumetric clean/noise evaluation: the 2-D testing protocol "
             "on whole volumes (region-masked noise, SNR, per-structure "
             "metrics, center-slice artifacts)",
    )
    _add_common(e3, dp_help=_DP3D_HELP)
    _add_3d_shape(e3)
    e3.add_argument("--val-frac", type=float, default=0.2,
                    help="evaluate only the trailing fraction of the "
                         "volumes — the same trailing split train3d holds "
                         "out, so metrics are on unseen data; 0 = all "
                         "volumes (ignored with --synthetic, which draws "
                         "a fresh set)")
    e3.add_argument("--noise-kind", default="none",
                    choices=["none", "gaussian", "speckle",
                             "salt_and_pepper"])
    e3.add_argument("--noise-std", type=float, default=0.0)
    e3.add_argument("--noise-region", default="all",
                    help="A/P (hippocampus), O/B (brats/lungs), or all")
    e3.add_argument("--sweep", action="store_true",
                    help="clean + every configured noise level x region")
    e3.add_argument("--images-n", type=int, default=4)
    e3.add_argument("--mc-samples", type=int, default=0,
                    help="N>0: evaluate the Monte-Carlo weight-sampling "
                         "baseline (N forwards/batch) instead of the VDP "
                         "propagated moments")
    e3.add_argument("--artifact-max-samples", type=int, default=None,
                    help="cap the rows kept for the full-set "
                         "uncertainty_info.pkl artifact (metrics and the "
                         "variance report still cover ALL samples; "
                         "default: keep all)")

    a3 = sub.add_parser(
        "attack3d", help="FGSM/PGD adversarial evaluation on volumes"
    )
    _add_common(a3, dp_help=_DP3D_HELP)
    _add_3d_shape(a3)
    a3.add_argument("--val-frac", type=float, default=0.2,
                    help="attack only the trailing (held-out) fraction of "
                         "the volumes; 0 = all (ignored with --synthetic)")
    a3.add_argument("--epsilon", type=float, default=None)
    a3.add_argument("--targeted", action="store_true")
    a3.add_argument("--untargeted", action="store_true")
    a3.add_argument("--max-adv-step", type=int, default=None)
    a3.add_argument("--step-size", type=float, default=None)
    a3.add_argument("--images-n", type=int, default=4)
    a3.add_argument("--artifact-max-samples", type=int, default=None,
                    help="cap the rows kept for the full-set "
                         "uncertainty_info.pkl artifact (metrics and the "
                         "variance report still cover ALL samples; "
                         "default: keep all)")

    c3 = sub.add_parser(
        "calibrate3d",
        help="voxel-wise uncertainty-quality report for the 3-D family "
             "(sparsification/AUSE, ECE + reliability)",
    )
    _add_common(c3, dp_help=_DP3D_HELP)
    _add_3d_shape(c3)
    c3.add_argument("--bins", type=int, default=15)
    c3.add_argument("--val-frac", type=float, default=0.2,
                    help="calibrate only on the trailing (held-out) "
                         "fraction of the volumes; 0 = all (ignored with "
                         "--synthetic)")
    c3.add_argument("--mc-samples", type=int, default=0,
                    help="N>0: score the MC weight-sampling baseline's "
                         "uncertainty instead of the VDP propagation")

    e = sub.add_parser("eval", help="clean evaluation + uncertainty report")
    _add_common(e)
    e.add_argument("--images-n", type=int, default=10)
    e.add_argument("--mc-samples", type=int, default=0,
                   help="N>0: evaluate the Monte-Carlo weight-sampling "
                        "baseline (N forwards/batch) instead of the VDP "
                        "propagated moments")
    e.add_argument("--artifact-max-samples", type=int, default=None,
                    help="cap the rows kept for the full-set "
                         "uncertainty_info.pkl artifact (metrics and the "
                         "variance report still cover ALL samples; "
                         "default: keep all)")

    cal = sub.add_parser(
        "calibrate",
        help="uncertainty-quality report: sparsification/AUSE, ECE + "
             "reliability diagram, uncertainty-error correlation",
    )
    _add_common(cal)
    cal.add_argument("--bins", type=int, default=15,
                     help="confidence bins for ECE/reliability")
    cal.add_argument("--mc-samples", type=int, default=0,
                     help="N>0: score the MC weight-sampling baseline's "
                          "uncertainty instead of the VDP propagation")

    a = sub.add_parser("attack", help="FGSM/PGD adversarial evaluation")
    _add_common(a)
    a.add_argument("--epsilon", type=float, default=None)
    a.add_argument("--targeted", action="store_true")
    a.add_argument("--untargeted", action="store_true")
    a.add_argument("--max-adv-step", type=int, default=None)
    a.add_argument("--step-size", type=float, default=None)
    a.add_argument("--images-n", type=int, default=10)
    a.add_argument("--artifact-max-samples", type=int, default=None,
                    help="cap the rows kept for the full-set "
                         "uncertainty_info.pkl artifact (metrics and the "
                         "variance report still cover ALL samples; "
                         "default: keep all)")

    st = sub.add_parser(
        "study",
        help="training-to-convergence study: train at reference scale, "
             "then the FULL eval surface on the trained weights (clean "
             "eval, noise sweep, adversarial attack, calibration) - one "
             "command, one artifact tree, study.json summary",
    )
    _add_common(st)
    st.add_argument("--epochs", type=int, default=None)
    st.add_argument("--continue-training", action="store_true")
    st.add_argument("--skip-train", action="store_true",
                    help="reuse <out-dir>/train checkpoints; run only the "
                         "eval surface")
    st.add_argument("--images-n", type=int, default=10)
    st.add_argument("--artifact-max-samples", type=int, default=None)

    s = sub.add_parser("sweep", help="noise-robustness sweep (levels x regions)")
    _add_common(s)
    s.add_argument("--images-n", type=int, default=10)
    s.add_argument("--artifact-max-samples", type=int, default=None,
                   help="cap the rows kept for EACH run's full-set "
                        "uncertainty_info.pkl artifact (the sweep runs "
                        "clean + levels x regions passes; metrics still "
                        "cover ALL samples; default: keep all)")

    sl = sub.add_parser(
        "saliency", help="gradient saliency maps (Brats.py:598-609)"
    )
    _add_common(sl)
    sl.add_argument("--target-class", type=int, default=None,
                    help="class whose probability mass is differentiated; "
                         "default: all foreground classes")
    sl.add_argument("--images-n", type=int, default=4)

    sl3 = sub.add_parser(
        "saliency3d",
        help="gradient saliency on volumes (center-slice renders of the "
             "3-D input gradient)",
    )
    _add_common(sl3, dp_help=_DP3D_HELP)
    _add_3d_shape(sl3)
    sl3.add_argument("--val-frac", type=float, default=0.2,
                     help="render saliency only for the trailing (held-out) "
                          "fraction of the volumes; 0 = all (ignored with "
                          "--synthetic)")
    sl3.add_argument("--target-class", type=int, default=None,
                     help="class whose probability mass is differentiated; "
                          "default: all foreground classes")
    sl3.add_argument("--images-n", type=int, default=4)

    p3 = sub.add_parser(
        "predict3d",
        help="sliding-window whole-volume inference: one NIfTI/.npy volume "
             "of ANY spatial shape in, full-frame segmentation + "
             "uncertainty maps out (overlapping model cubes batched "
             "through one compiled program, per-voxel moment blending); "
             "a comma-separated --checkpoint list serves the deep "
             "ensemble (member disagreement enters the variance map)",
    )
    _add_common(p3)
    _add_3d_shape(p3)
    p3.add_argument("--volume", required=True,
                    help="input volume (.nii / .nii.gz / .npy, [D,H,W] or "
                         "[D,H,W,C]) OR a directory of such volumes (e.g. "
                         "an MSD imagesTs/); per-modality min-max "
                         "normalized like the training ingestion")
    p3.add_argument("--overlap", type=int, default=8,
                    help="tile overlap in OUTPUT voxels (0 = abutting)")
    p3.add_argument("--blend", default="gaussian",
                    choices=["gaussian", "uniform"],
                    help="per-voxel tile weighting")
    p3.add_argument("--pad-mode", default="reflect",
                    help="np.pad mode for the volume border (the VALID "
                         "margins + grid tail)")
    p3.add_argument("--save-probs", action="store_true",
                    help="also write the full probs/sigma arrays (.npy, "
                         "D*H*W*classes floats each)")
    p3.add_argument("--variance-scale", type=float, default=1.0,
                    help="fitted post-hoc variance scale (cli calibrate)")
    p3.add_argument("--temperature", type=float, default=1.0,
                    help="fitted probability temperature (cli calibrate)")

    c = sub.add_parser(
        "convert",
        help="convert reference pickles OR raw NIfTI volumes to .npy shards",
    )
    _add_common(c)
    c.add_argument("--shard-size", type=int, default=256)
    c.add_argument("--split", default="train", choices=["train", "test"])
    c.add_argument("--out", required=True, help="shard output directory")
    c.add_argument("--from-nifti", action="store_true",
                   help="--data is a Medical-Segmentation-Decathlon task "
                        "dir (imagesTr/labelsTr of .nii.gz volumes); "
                        "extract+normalize 2D slices per the paper protocol")
    c.add_argument("--keep-empty", action="store_true",
                   help="with --from-nifti: keep slices whose label has "
                        "no foreground")
    c.add_argument("--max-volumes", type=int, default=0,
                   help="with --from-nifti: cap the volumes read (smoke runs)")
    c.add_argument("--to-cubes", action="store_true",
                   help="with --from-nifti: write size^3 CUBE shards for "
                        "the 3-D family (train3d/eval3d read the shard "
                        "dir directly) instead of 2-D slices")
    c.add_argument("--cube-size", type=int, default=0,
                   help="with --to-cubes: cube side (default: the "
                        "config's image_size)")

    x = sub.add_parser(
        "export",
        help="serving bundle: exported forward + npz params + metadata",
    )
    _add_common(x)
    x.add_argument("--export-batch-size", type=int, default=8,
                   help="static batch size the module is compiled for "
                        "(serving pads/chunks requests to it)")
    x.add_argument("--volumetric", action="store_true",
                   help="export the 3-D family's forward (cube in/out); "
                        "--checkpoint must be a train3d epoch dir or .npz")
    _add_3d_shape(x)  # --cube-size / --base-kernels / --depth
    x.add_argument("--variance-scale", type=float, default=1.0,
                   help="bake a fitted post-hoc variance scale (cli "
                        "calibrate's fitted_variance_scale) into the "
                        "exported computation")
    x.add_argument("--temperature", type=float, default=1.0,
                   help="bake a fitted probability temperature (cli "
                        "calibrate's fitted_temperature) into the "
                        "exported computation")

    b = sub.add_parser("bench", help="throughput benchmark")
    pr = sub.add_parser(
        "profile",
        help="exact-join device profile of the train step (per-op class "
             "table joined against the executed executable's HLO; "
             "docs/PERFORMANCE.md 'Round 5')")
    pr.add_argument("--config", default="hippocampus",
                    help="hippocampus | brats | lungs | unet3d "
                         "(unet3d = the volumetric family)")
    pr.add_argument("--batch", type=int, default=20)
    pr.add_argument("--iters", type=int, default=20,
                    help="traced dispatches (each runs the K-step scan)")
    pr.add_argument("--by-layer", action="store_true",
                    help="add per-layer MXU-conv attribution "
                         "(the layer names the forward records)")
    pr.add_argument("--out-dir", default=None,
                    help="trace + exact_join.json destination "
                         "(default <tempdir>/ej_<config>_<batch>)")
    pr.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; there "
                         "is no fallback to the CPU)")
    return ap


def _get_exp(args):
    from supernet_tpu_torch.configs import AugmentConfig, get_config

    exp = get_config(args.config)
    tkw, ekw = {}, {}
    for flag in ("epochs", "lr", "kl_factor", "batch_size",
                 "adversarial_training", "adv_epsilon", "adv_alpha",
                 "adv_steps", "adv_step_size"):
        if getattr(args, flag, None) is not None:
            tkw[flag] = getattr(args, flag)
    if getattr(args, "continue_training", False):
        tkw["continue_training"] = True
    if getattr(args, "augment", False):
        v = getattr(args, "augment_intensity", 0.0)
        tkw["augment"] = AugmentConfig(
            rot90=getattr(args, "augment_rot90", False),
            intensity_scale=v,
            intensity_shift=v / 2.0,
            noise_std=getattr(args, "augment_noise_std", 0.0),
        )
    if tkw:
        ekw["train"] = dataclasses.replace(exp.train, **tkw)
    akw = {}
    for flag in ("epsilon", "max_adv_step", "step_size"):
        if getattr(args, flag, None) is not None:
            akw[flag] = getattr(args, flag)
    if getattr(args, "targeted", False):
        akw["targeted"] = True
    if getattr(args, "untargeted", False):
        akw["targeted"] = False
    if akw:
        ekw["attack"] = dataclasses.replace(exp.attack, **akw)
    if args.data:
        ekw["data_path"] = args.data
    if args.out_dir:
        ekw["out_dir"] = args.out_dir
    return exp.replace(**ekw) if ekw else exp


def _load_data(exp, args, split="test"):
    from supernet_tpu_torch.data import (
        PickleDataset,
        ShardDataset,
        StreamingPickleDataset,
        load_hippocampus_pickle,
        synthetic_dataset,
    )

    if args.synthetic:
        x, y = synthetic_dataset(exp.model, args.synthetic,
                                 seed=0 if split == "train" else 1)
        return PickleDataset(x, y, exp.model.in_channels)
    if exp.data_path and os.path.isdir(exp.data_path):
        # .npy shard directory (cli convert output): native C++ streaming
        return ShardDataset(exp.data_path, shuffle=(split == "train"))
    if exp.name == "brats" and "*" in (exp.data_path or ""):
        return StreamingPickleDataset(exp.data_path, exp.model.in_channels)
    xtr, ytr, xte, yte = load_hippocampus_pickle(exp.data_path)
    if split == "train":
        return PickleDataset(xtr, ytr, exp.model.in_channels)
    return PickleDataset(xte, yte, exp.model.in_channels)


def _cfg3d(exp, args):
    """Apply the 3-D shape overrides and derive out_size from the
    volumetric geometry (shared by every 3-D command, so an evaluated model
    matches its training shape)."""
    from supernet_tpu_torch.train3d import derive_out_size3d

    cfg = exp.model
    if args.cube_size:
        cfg = dataclasses.replace(cfg, image_size=args.cube_size)
    if args.base_kernels:
        cfg = dataclasses.replace(cfg, base_kernels=args.base_kernels)
    if args.depth:
        cfg = dataclasses.replace(cfg, depth=args.depth, bottleneck_pre_pad=None)
    cfg = dataclasses.replace(cfg, out_size=derive_out_size3d(cfg))
    return dataclasses.replace(exp, model=cfg)


def _load_volumes(exp, args, seed=0):
    """Cube dataset for the 3-D family: ``--synthetic N`` blobs, a cube
    .npy shard directory (``convert --to-cubes`` output), or a NIfTI task
    directory (imagesTr/labelsTr of .nii[.gz]) cut to ``cfg.image_size``
    cubes by ``data.volume_to_cube``."""
    import glob

    import numpy as np

    cfg = exp.model
    if args.synthetic:
        from supernet_tpu_torch.data import synthetic_volumes

        return synthetic_volumes(cfg, args.synthetic, seed=seed)
    src = args.data or exp.data_path
    if src and glob.glob(os.path.join(src, "x_*.npy")):
        from supernet_tpu_torch.data import shard_pairs

        pairs = shard_pairs(src)
        x = np.concatenate([np.load(xp) for xp, _ in pairs])
        y = np.concatenate([np.load(yp) for _, yp in pairs])
        if x.shape[1] != cfg.image_size:
            raise SystemExit(
                f"cube shards in {src} are {x.shape[1]}^3 but the config "
                f"expects {cfg.image_size}^3; re-convert or pass "
                f"--cube-size {x.shape[1]}"
            )
        return x, y
    from supernet_tpu_torch.data import read_nifti, volume_to_cube

    img_dir = (os.path.join(src, "imagesTr")
               if os.path.isdir(os.path.join(src, "imagesTr")) else src)
    lbl_dir = os.path.join(os.path.dirname(img_dir), "labelsTr")
    xs, ys = [], []
    max_volumes = getattr(args, "max_volumes", 0)
    for p in sorted(glob.glob(os.path.join(img_dir, "*.nii*"))):
        if os.path.basename(p).startswith("._"):
            continue
        if max_volumes and len(xs) >= max_volumes:
            break
        lp = os.path.join(lbl_dir, os.path.basename(p))
        if not os.path.exists(lp):
            # never score or train against silently zeroed labels
            raise SystemExit(
                f"no label for volume {p} (expected {lp}); the 3-D "
                "commands need labelsTr to match imagesTr"
            )
        cx, cy = volume_to_cube(read_nifti(p)[0], read_nifti(lp)[0], cfg.image_size)
        xs.append(cx)
        ys.append(cy)
    if not xs:
        raise SystemExit(f"no .nii[.gz] volumes under {img_dir}")
    return np.stack(xs), np.stack(ys)


def _val_count(n: int, frac: float, batch: int) -> int:
    """train3d's trailing hold-out: a nonzero fraction is rounded up to one
    full batch, capped so that one training batch always remains. The 3-D
    evaluation commands use the same formula, so their --val-frac tail is
    the set train3d never trained on."""
    n_val = int(n * frac)
    if n_val > 0:
        n_val = max(n_val, batch)
    return min(n_val, max(n - batch, 0))


def _convert(exp, args) -> int:
    if args.to_cubes and not args.from_nifti:
        raise SystemExit(
            "--to-cubes reads raw NIfTI volumes; pass --from-nifti "
            "with a Medical-Segmentation-Decathlon task directory"
        )
    if args.to_cubes and (args.split != "train" or args.keep_empty):
        raise SystemExit(
            "--split/--keep-empty apply to 2-D slice extraction only; "
            "the cube path reads every imagesTr volume whole (cap the "
            "count with --max-volumes)"
        )
    if args.to_cubes:
        from supernet_tpu_torch.data import write_shards

        if args.cube_size:
            exp = exp.replace(model=dataclasses.replace(
                exp.model, image_size=args.cube_size))
        x, y = _load_volumes(exp, args, seed=0)
        pairs = write_shards(args.out, x, y, shard_size=args.shard_size,
                             volumetric=True)
        print(json.dumps({
            "shards": len(pairs), "out": args.out,
            "volumes": int(len(x)), "cube": int(x.shape[1]),
        }))
        return 0
    if args.from_nifti:
        from supernet_tpu_torch.data import convert_nifti_dir

        pairs = convert_nifti_dir(
            exp.data_path,
            args.out,
            image_size=exp.model.image_size,
            split=args.split,
            shard_size=args.shard_size,
            keep_empty=args.keep_empty,
            max_volumes=args.max_volumes,
        )
    else:
        from supernet_tpu_torch.data import convert_pickles

        pairs = convert_pickles(
            exp.data_path,
            args.out,
            in_channels=exp.model.in_channels,
            shard_size=args.shard_size,
            split=args.split,
        )
    print(json.dumps({"shards": len(pairs), "out": args.out}))
    return 0


def _checkpoint_list(args):
    """Comma-separated ``--checkpoint`` = deep-ensemble member list."""
    return [s for s in (getattr(args, "checkpoint", None) or "").split(",")
            if s]


def _load_maybe_ensemble(load_one, exp, args, cmd_ok=True):
    """Load one checkpoint, or a LIST of members for a comma-separated
    --checkpoint (the eval runners mix them via
    `evaluate.ensemble_forward`). ``cmd_ok=False`` rejects the list for
    single-member commands (saliency/attack) with a legible error."""
    srcs = _checkpoint_list(args)
    if len(srcs) > 1:
        if not cmd_ok:
            raise SystemExit(
                f"{args.cmd} takes ONE checkpoint; a comma-separated "
                "ensemble list is served by eval/calibrate/sweep "
                "(2-D and 3-D) and predict3d"
            )
        return [load_one(exp, args, src=s) for s in srcs]
    return load_one(exp, args)


def _load_params(exp, args, src=_UNSET):
    """2-D params on ``args.device`` from ``args.checkpoint`` (or an
    explicit ``src``): random init, Keras .h5, .npz, or the latest
    ``epoch_{N}/state.pt`` of a run directory."""
    import torch

    from supernet_tpu_torch import checkpoint as ckpt
    from supernet_tpu_torch.models import init_params

    cfg = exp.model
    if src is _UNSET:
        src = args.checkpoint
    if src is None:
        print("warning: no --checkpoint; using random init", file=sys.stderr)
        return init_params(torch.Generator().manual_seed(0), cfg, args.device)
    if src.endswith(".h5"):
        return ckpt.import_keras_h5(src, cfg, args.device)
    if src.endswith(".npz"):
        return ckpt.load_params_npz(src, args.device)
    root, epoch = ckpt.resolve_checkpoint(src)
    if epoch is None:
        raise FileNotFoundError(f"no epoch_{{N}} checkpoints under {src}")
    state = ckpt.restore_state(root, epoch, exp.train, args.device)
    return {layer: {name: t.detach() for name, t in ws.items()}
            for layer, ws in state.params.items()}


def _load_params3d(exp, args, src=_UNSET):
    """Volumetric params on ``args.device``: random init, .npz, or the
    latest ``epoch_{N}/state.pt`` under --checkpoint (what train3d
    writes)."""
    import torch

    from supernet_tpu_torch import checkpoint as ckpt
    from supernet_tpu_torch.models import init_params3d

    if src is _UNSET:
        src = args.checkpoint
    if src is None:
        print("warning: no --checkpoint; using random init", file=sys.stderr)
        return init_params3d(torch.Generator().manual_seed(0), exp.model, args.device)
    if src.endswith(".h5"):
        raise SystemExit(
            "Keras .h5 import is 2-D-only; the 3-D family restores from "
            "epoch_{N} dirs or .npz params"
        )
    if src.endswith(".npz"):
        return ckpt.load_params_npz(src, args.device)
    root, epoch = ckpt.resolve_checkpoint(src)
    if epoch is None:
        raise FileNotFoundError(f"no epoch_{{N}} checkpoints under {src}")
    state = ckpt.restore_state(root, epoch, exp.train, args.device)
    return {layer: {name: t.detach() for name, t in ws.items()}
            for layer, ws in state.params.items()}


def _run_study(exp, args) -> int:
    """The training-to-convergence study, one command: reference-scale
    training (epochs/batch/lr from the config, e.g. 120 epochs for
    Hippocampus, `Hippocampus.py:426`) followed by the complete eval surface
    on the trained weights: clean eval + uncertainty artifacts, the
    module-level noise sweep, the adversarial protocol, and the calibration
    report. Every stage is the real subcommand invoked through `main()` (so
    the study exercises exactly what users run), its JSON line(s) captured
    into <out-dir>/study.json."""
    import contextlib
    import io
    import time

    out = args.out_dir or f"{exp.out_dir}/{exp.name}/study"
    train_dir = os.path.join(out, "train")
    common = ["--config", args.config, "--device", args.device]
    if args.synthetic:
        common += ["--synthetic", str(args.synthetic)]
    if args.data:
        common += ["--data", args.data]
    if args.batch_size:
        common += ["--batch-size", str(args.batch_size)]

    summary = {"out_dir": out, "stages": {}}

    def run_stage(name, argv):
        print(f"[study] {name}: supernet_tpu_torch {' '.join(argv)}",
              file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        text = buf.getvalue()
        sys.stdout.write(text)  # stage output stays visible
        if rc:
            raise SystemExit(f"study stage {name!r} failed (rc={rc})")
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        summary["stages"][name] = {
            "seconds": round(time.perf_counter() - t0, 2),
            "results": [json.loads(ln) for ln in lines],
        }

    if not args.skip_train:
        targs = ["train", *common, "--out-dir", train_dir]
        if args.epochs is not None:
            targs += ["--epochs", str(args.epochs)]
        if args.continue_training:
            targs += ["--continue-training"]
        run_stage("train", targs)
    ckpt = ["--checkpoint", train_dir]
    cap = ([] if args.artifact_max_samples is None
           else ["--artifact-max-samples", str(args.artifact_max_samples)])
    n = ["--images-n", str(args.images_n)]
    run_stage("eval", ["eval", *common, *ckpt, *n, *cap,
                       "--out-dir", os.path.join(out, "eval")])
    run_stage("sweep", ["sweep", *common, *ckpt, *n, *cap,
                        "--out-dir", os.path.join(out, "sweep")])
    run_stage("attack", ["attack", *common, *ckpt, *n, *cap,
                         "--out-dir", os.path.join(out, "attack")])
    run_stage("calibrate", ["calibrate", *common, *ckpt,
                            "--out-dir", os.path.join(out, "calibration")])

    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "study.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    # headline line: clean dice / ECE / AUSE / wall time
    head = {"study": path}
    ev = summary["stages"].get("eval", {}).get("results", [])
    if ev:
        for k in ("accuracy", "dice_anterior", "dice_posterior",
                  "dice_tumor", "dice_core", "dice_enhancing",
                  "mean_predictive_variance"):
            if k in ev[0]:
                head[k] = ev[0][k]
    cal = summary["stages"].get("calibrate", {}).get("results", [])
    if cal:
        for k in ("ece", "ause", "corr_pearson", "corr_spearman"):
            if k in cal[0]:
                head[k] = cal[0][k]
    head["total_seconds"] = round(
        sum(s["seconds"] for s in summary["stages"].values()), 2
    )
    print(json.dumps(head))
    return 0


def _scalars(res) -> str:
    """The JSON line of a result: its numbers and strings."""
    return json.dumps({k: v for k, v in res.items()
                       if isinstance(v, (int, float, str))})


def _saliency(exp, args, params, ds) -> int:
    import numpy as np
    import torch

    from supernet_tpu_torch.attacks import make_saliency_map
    from supernet_tpu_torch.reports import save_saliency_maps

    cfg = exp.model
    sal = make_saliency_map(cfg)
    cmask = torch.zeros(cfg.n_classes, device=args.device)
    if args.target_class is None:  # all foreground ("all tumor")
        cmask[1:] = 1.0
    else:
        cmask[args.target_class] = 1.0
    out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}/saliency"
    count = 0
    for x, _ in ds.batches(exp.train.batch_size):
        xb = torch.as_tensor(x, dtype=torch.float32, device=args.device)
        g, g_relu = (t.cpu().numpy() for t in sal(params, xb, cmask))
        for i in range(len(x)):
            if count >= args.images_n:
                break
            save_saliency_maps(out_dir, np.asarray(x[i]), g[i], g_relu[i], index=count)
            count += 1
        if count >= args.images_n:
            break
    print(json.dumps({"saliency_maps": count, "out_dir": out_dir}))
    return 0


def _evaluate(exp, args) -> int:
    """eval, calibrate, attack, saliency and sweep: a checkpoint (or, for
    eval/calibrate/sweep, an ensemble of them) on the test split."""
    if args.data_parallel:
        raise _unported(f"{args.cmd} --data-parallel",
                        "'Parallelism' (parallel/data_parallel.py)")
    params = _load_maybe_ensemble(
        _load_params, exp, args,
        cmd_ok=args.cmd in ("eval", "calibrate", "sweep"),
    )
    ds = _load_data(exp, args, "test")

    if args.cmd == "eval":
        from supernet_tpu_torch.evaluate import run_testing

        print(_scalars(run_testing(
            exp, params, ds, images_n=args.images_n, out_dir=args.out_dir,
            mc_samples=args.mc_samples,
            artifact_max_samples=args.artifact_max_samples,
            device=args.device)))
    elif args.cmd == "calibrate":
        from supernet_tpu_torch.calibration import run_calibration

        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}/calibration"
        print(_scalars(run_calibration(
            exp, params, ds, out_dir=out_dir, n_bins=args.bins,
            mc_samples=args.mc_samples, device=args.device)))
    elif args.cmd == "attack":
        from supernet_tpu_torch.evaluate import run_adversarial

        print(_scalars(run_adversarial(
            exp, params, ds, images_n=args.images_n, out_dir=args.out_dir,
            artifact_max_samples=args.artifact_max_samples,
            device=args.device)))
    elif args.cmd == "saliency":
        return _saliency(exp, args, params, ds)
    else:
        from supernet_tpu_torch.evaluate import run_noise_sweep

        for r in run_noise_sweep(
                exp, params, ds, images_n=args.images_n,
                artifact_max_samples=args.artifact_max_samples,
                device=args.device):
            print(_scalars(r))
    return 0


def _export(exp, args) -> int:
    from supernet_tpu_torch.serving import export_bundle

    if args.volumetric:
        # the 3-D bundle: the cube geometry, a 3-D checkpoint
        exp = _cfg3d(exp, args)
        params = _load_maybe_ensemble(_load_params3d, exp, args, cmd_ok=False)
        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}_3d/export"
    else:
        params = _load_maybe_ensemble(_load_params, exp, args)
        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}/export"
    meta = export_bundle(
        params,
        exp.model,
        out_dir,
        batch_size=args.export_batch_size,
        config_name=exp.name,
        volumetric=args.volumetric,
        variance_scale=args.variance_scale,
        temperature=args.temperature,
    )
    print(json.dumps(meta))
    return 0


def _train(exp, args) -> int:
    from supernet_tpu_torch.trainer import Trainer

    if args.data_parallel:
        raise _unported("train --data-parallel",
                        "'Parallelism' (parallel/data_parallel.py)")
    train_ds = _load_data(exp, args, "train")
    if getattr(args, "val_data", None):
        val_ds = _load_data(exp.replace(data_path=args.val_data), args, "test")
    else:
        if not args.synthetic and exp.data_path and (
            os.path.isdir(exp.data_path) or "*" in exp.data_path
        ):
            print("warning: validation will reuse the TRAINING data; "
                  "pass --val-data for a held-out split", file=sys.stderr)
        val_ds = _load_data(exp, args, "test")
    if args.ensemble > 1:
        return _train_ensemble(exp, args, train_ds, val_ds)
    tr = Trainer(exp, train_ds, val_ds, out_dir=args.out_dir,
                 steps_per_dispatch=args.steps_per_dispatch,
                 device=args.device)
    tr.run()
    print(json.dumps({k: v[-1] for k, v in tr.history.items() if v}))
    return 0


def _finals(histories):
    return [{m: v[-1] for m, v in h.items() if v} for h in histories]


def _ensemble_mode(args, total_steps, step_s=None, step_ratio=None) -> str:
    """``--ensemble-mode``, with ``auto`` decided by
    ``ensemble.choose_ensemble_mode`` (the note goes to stderr)."""
    if args.ensemble_mode != "auto":
        return args.ensemble_mode
    from supernet_tpu_torch.ensemble import choose_ensemble_mode

    mode, why = choose_ensemble_mode(args.ensemble, total_steps, step_s=step_s,
                                     step_ratio=step_ratio)
    print(f"ensemble auto mode -> {mode} ({why})", file=sys.stderr)
    return mode


def _note_steps_per_dispatch(args) -> None:
    if args.steps_per_dispatch > 1:
        print("note: --steps-per-dispatch is ignored in one-program ensemble "
              "mode (the member axis already batches the device work)",
              file=sys.stderr)


def _train_ensemble(exp, args, train_ds, val_ds) -> int:
    """``train --ensemble K``: K members (seeds seed..seed+K-1, which also
    drive each member's shuffle) into ``member_{k}/``, as one stacked
    ensemble or, ``sequential``, K full ``Trainer`` runs."""
    from supernet_tpu_torch.trainer import Trainer

    base = args.out_dir or f"{exp.out_dir}/{exp.name}/ensemble"
    try:
        total_steps = exp.train.epochs * (len(train_ds) // exp.train.batch_size)
    except TypeError:  # an unsized stream
        total_steps = None
    mode = _ensemble_mode(args, total_steps)
    if mode != "sequential":
        from supernet_tpu_torch.ensemble import EnsembleTrainer

        _note_steps_per_dispatch(args)
        tr = EnsembleTrainer(exp, args.ensemble, train_ds, val_ds, out_dir=base,
                             member_mode=mode, device=args.device)
        tr.run()
        dirs, finals = tr.member_dirs, _finals(tr.histories)
    else:
        dirs, finals = [], []
        for k in range(args.ensemble):
            exp_k = exp.replace(train=dataclasses.replace(
                exp.train, seed=exp.train.seed + k))
            member_dir = f"{base}/member_{k}"
            print(f"ensemble member {k}/{args.ensemble} -> {member_dir}",
                  file=sys.stderr)
            tr = Trainer(exp_k, train_ds, val_ds, out_dir=member_dir,
                         steps_per_dispatch=args.steps_per_dispatch,
                         device=args.device)
            tr.run()
            dirs.append(member_dir)
            finals += _finals([tr.history])
    print(json.dumps({"members": args.ensemble, "mode": mode, "dirs": dirs,
                      "checkpoint_arg": ",".join(dirs), "final": finals}))
    return 0


def _train3d(exp, args) -> int:
    from supernet_tpu_torch.train3d import Trainer3D

    if args.checkpoint:
        raise SystemExit(
            "train3d resumes via --continue-training from --out-dir; "
            "--checkpoint is not used here"
        )
    for flag, on in (("--spatial-shard", args.spatial_shard),
                     ("--hybrid-shard", args.hybrid_shard),
                     ("--data-parallel", args.data_parallel)):
        if on:
            raise _unported(f"train3d {flag}", "'Parallelism' (parallel/spatial.py, "
                            "parallel/hybrid.py, parallel/data_parallel.py)")
    exp = _cfg3d(exp, args)
    x, y = _load_volumes(exp, args, seed=0)
    # --val-frac 0 means no validation (see _val_count)
    n_val = _val_count(len(x), args.val_frac, exp.train.batch_size)
    if n_val > 0:
        x_tr, y_tr, x_val, y_val = x[:-n_val], y[:-n_val], x[-n_val:], y[-n_val:]
    else:
        x_tr, y_tr, x_val, y_val = x, y, None, None
    init3d = None
    if args.init_from_2d:
        from supernet_tpu_torch.models import inflate_params3d

        # the 2-D checkpoint must match this config's layer map
        # (inflate_params3d checks it layer by layer)
        init3d = inflate_params3d(_load_params(exp, args, src=args.init_from_2d),
                                  exp.model)
        print(f"transfer init: inflated 2-D checkpoint {args.init_from_2d} "
              "into the 3-D model", file=sys.stderr)
    if args.ensemble > 1:
        return _train3d_ensemble(exp, args, (x_tr, y_tr, x_val, y_val), init3d)
    tr = Trainer3D(exp, x_tr, y_tr, x_val, y_val, out_dir=args.out_dir,
                   initial_params=init3d,
                   steps_per_dispatch=args.steps_per_dispatch, device=args.device)
    tr.run()
    print(json.dumps({k: v[-1] for k, v in tr.history.items() if v}))
    return 0


def _train3d_ensemble(exp, args, data, init3d) -> int:
    """``train3d --ensemble K``: K members (seeds seed..seed+K-1) into
    ``member_{k}/``; a shared ``--init-from-2d`` inflation starts every
    member from the same weights, so diversity then comes from the shuffle
    alone."""
    from supernet_tpu_torch.ensemble import ONE_PROGRAM_STEP3D_RATIO, SEQUENTIAL_STEP3D_S
    from supernet_tpu_torch.train3d import Trainer3D

    x_tr, y_tr, x_val, y_val = data
    base = args.out_dir or f"{exp.out_dir}/{exp.name}_3d/ensemble"
    # the 3-D step's own measured ratio: its vmap gains nothing on the card
    mode = _ensemble_mode(args, exp.train.epochs * (len(x_tr) // exp.train.batch_size),
                          step_s=SEQUENTIAL_STEP3D_S, step_ratio=ONE_PROGRAM_STEP3D_RATIO)
    if mode != "sequential":
        from supernet_tpu_torch.ensemble import EnsembleTrainer3D

        _note_steps_per_dispatch(args)
        tr = EnsembleTrainer3D(exp, args.ensemble, x_tr, y_tr, x_val, y_val,
                               out_dir=base, member_mode=mode,
                               initial_params=init3d, device=args.device)
        tr.run()
        print(json.dumps({"members": args.ensemble, "mode": mode,
                          "dirs": tr.member_dirs,
                          "checkpoint_arg": ",".join(tr.member_dirs),
                          "final": _finals(tr.histories)}))
        return 0
    dirs, finals = [], []
    for k in range(args.ensemble):
        exp_k = exp.replace(train=dataclasses.replace(exp.train, seed=exp.train.seed + k))
        member_dir = f"{base}/member_{k}"
        print(f"ensemble member {k}/{args.ensemble} -> {member_dir}", file=sys.stderr)
        tr = Trainer3D(exp_k, x_tr, y_tr, x_val, y_val, out_dir=member_dir,
                       initial_params=init3d,
                       steps_per_dispatch=args.steps_per_dispatch, device=args.device)
        tr.run()
        dirs.append(member_dir)
        finals += _finals([tr.history])
    print(json.dumps({"members": args.ensemble, "dirs": dirs,
                      "checkpoint_arg": ",".join(dirs), "final": finals}))
    return 0


def _load_volume_file(path, cfg, name):
    """One .nii[.gz] / .npy volume as [D, H, W, C] float32, each modality
    min-max normalized like the training ingestion
    (``data.volume_to_cube``); returns ``(volume, is_nifti)``."""
    import numpy as np

    if path.endswith((".nii", ".nii.gz")):
        from supernet_tpu_torch.data import read_nifti

        vol, nifti = read_nifti(path)[0], True
    elif path.endswith(".npy"):
        vol, nifti = np.load(path), False
    else:
        raise SystemExit(f"unsupported volume format: {path} "
                         "(.nii / .nii.gz / .npy)")
    vol = np.asarray(vol, np.float32)
    if vol.ndim == 3:
        vol = vol[..., None]
    if vol.ndim != 4:
        raise SystemExit(f"{path}: expected a 3-D volume, got shape {vol.shape}")
    if vol.shape[-1] != cfg.in_channels:
        raise SystemExit(
            f"{path}: volume has {vol.shape[-1]} modalities; "
            f"config {name} expects {cfg.in_channels}"
        )
    flat = vol.reshape(-1, vol.shape[-1])
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    return (vol - lo) / np.maximum(hi - lo, 1e-8), nifti


def _predict3d(exp, args) -> int:
    import glob

    import numpy as np

    from supernet_tpu_torch.serving import EnsembleSession, InferenceSession

    if args.data_parallel:
        raise _unported("predict3d --data-parallel",
                        "'Parallelism' (parallel/data_parallel.py)")
    exp = _cfg3d(exp, args)
    cfg = exp.model
    if os.path.isdir(args.volume):
        paths = sorted(
            p for pat in ("*.nii", "*.nii.gz", "*.npy")
            for p in glob.glob(os.path.join(args.volume, pat))
            if not os.path.basename(p).startswith(".")
        )
        if not paths:
            raise SystemExit(f"no .nii/.nii.gz/.npy volumes under {args.volume}")
    else:
        paths = [args.volume]
    # one session for every volume; a comma-separated --checkpoint serves
    # the deep ensemble (member disagreement enters the variance map)
    common = dict(batch_size=args.batch_size or 4, volumetric=True,
                  variance_scale=args.variance_scale,
                  temperature=args.temperature, device=args.device)
    srcs = _checkpoint_list(args)
    if len(srcs) > 1:
        sess = EnsembleSession([_load_params3d(exp, args, src=s) for s in srcs],
                               cfg, **common)
    else:
        sess = InferenceSession(_load_params3d(exp, args), cfg, **common)
    out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}_3d/predict"
    os.makedirs(out_dir, exist_ok=True)
    multi = len(paths) > 1
    for path in paths:
        vol, is_nifti = _load_volume_file(path, cfg, exp.name)
        probs, sigma = sess.predict_volume(
            vol, overlap=args.overlap, weight=args.blend, pad_mode=args.pad_mode)
        seg = np.argmax(probs, axis=-1).astype(np.int32)
        # the predictive variance at the predicted class
        unc = np.take_along_axis(sigma, seg[..., None], axis=-1)[..., 0]
        stem = os.path.basename(path)
        for suf in (".nii.gz", ".nii", ".npy"):
            if stem.endswith(suf):
                stem = stem[: -len(suf)]
                break
        pre = f"{stem}_" if multi else ""
        ext = ".nii.gz" if is_nifti else ".npy"
        seg_path = os.path.join(out_dir, f"{pre}segmentation{ext}")
        unc_path = os.path.join(out_dir, f"{pre}uncertainty{ext}")
        if is_nifti:
            from supernet_tpu_torch.data import write_nifti

            write_nifti(seg_path, seg)
            write_nifti(unc_path, unc.astype(np.float32))
        else:
            np.save(seg_path, seg)
            np.save(unc_path, unc.astype(np.float32))
        extra = {}
        if args.save_probs:
            pp = os.path.join(out_dir, f"{pre}probs.npy")
            sp = os.path.join(out_dir, f"{pre}sigma.npy")
            np.save(pp, probs)
            np.save(sp, sigma)
            extra = {"probs": pp, "sigma": sp}
        counts = np.bincount(seg.ravel(), minlength=cfg.n_classes)
        print(json.dumps({
            "input": path,
            "volume": list(vol.shape),
            "cube": cfg.image_size,
            "out_cube": cfg.out_size,
            "overlap": args.overlap,
            "blend": args.blend,
            "class_voxels": [int(c) for c in counts],
            "mean_uncertainty": float(unc.mean()),
            "max_uncertainty": float(unc.max()),
            "segmentation": seg_path,
            "uncertainty": unc_path,
            **extra,
        }))
    return 0


def _saliency3d(exp, args, params, x) -> dict:
    import torch

    from supernet_tpu_torch.attacks import make_saliency_map
    from supernet_tpu_torch.models import forward3d
    from supernet_tpu_torch.reports import save_saliency_maps

    cfg = exp.model
    sal = make_saliency_map(cfg, forward_fn=forward3d)
    cmask = torch.zeros(cfg.n_classes, device=args.device)
    if args.target_class is None:  # all foreground
        cmask[1:] = 1.0
    else:
        cmask[args.target_class] = 1.0
    out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}_3d/saliency"
    count = 0
    b = exp.train.batch_size
    for i in range(0, len(x), b):
        x_np = x[i : i + b]
        xb = torch.as_tensor(x_np, device=args.device)
        g, g_relu = (t.cpu().numpy() for t in sal(params, xb, cmask))
        mid = xb.shape[1] // 2
        for j in range(len(x_np)):
            if count >= args.images_n:
                break
            # the center axial slice of the volumetric gradient
            save_saliency_maps(out_dir, x_np[j, mid], g[j, mid], g_relu[j, mid],
                               index=count)
            count += 1
        if count >= args.images_n:
            break
    return {"saliency_maps": count, "out_dir": out_dir}


def _evaluate3d(exp, args) -> int:
    """eval3d, attack3d, calibrate3d and saliency3d on cubes: a checkpoint
    (or, for eval3d / calibrate3d, an ensemble of them) on held-out
    volumes."""
    if args.data_parallel:
        raise _unported(f"{args.cmd} --data-parallel (the scan-axis sharding)",
                        "'Parallelism' (parallel/spatial.py)")
    exp = _cfg3d(exp, args)
    x, y = _load_volumes(exp, args, seed=1)
    # score the held-out volumes only: the trailing train3d --val-frac
    # split (synthetic data draws a fresh set already)
    if not args.synthetic and getattr(args, "val_frac", 0) > 0:
        n_val = _val_count(len(x), args.val_frac, exp.train.batch_size)
        if n_val > 0:
            x, y = x[-n_val:], y[-n_val:]
            print(
                f"note: scoring the trailing {n_val} held-out volumes "
                f"(--val-frac {args.val_frac}); pass --val-frac 0 to "
                "score everything incl. training volumes",
                file=sys.stderr,
            )
    params = _load_maybe_ensemble(_load_params3d, exp, args,
                                  cmd_ok=args.cmd in ("eval3d", "calibrate3d"))
    from supernet_tpu_torch import evaluate3d as E3

    if args.cmd == "eval3d":
        if args.sweep:
            for r in E3.run_noise_sweep3d(
                    exp, params, x, y, images_n=args.images_n,
                    mc_samples=args.mc_samples,
                    artifact_max_samples=args.artifact_max_samples,
                    device=args.device):
                print(_scalars(r))
            return 0
        from supernet_tpu_torch.configs import NoiseConfig

        nc = NoiseConfig(kind=args.noise_kind, std=args.noise_std,
                         region=args.noise_region)
        res = E3.run_testing3d(exp, params, x, y, nc, out_dir=args.out_dir,
                               images_n=args.images_n, mc_samples=args.mc_samples,
                               artifact_max_samples=args.artifact_max_samples,
                               device=args.device)
    elif args.cmd == "attack3d":
        res = E3.run_adversarial3d(exp, params, x, y, out_dir=args.out_dir,
                                   images_n=args.images_n,
                                   artifact_max_samples=args.artifact_max_samples,
                                   device=args.device)
    elif args.cmd == "saliency3d":
        res = _saliency3d(exp, args, params, x)
    else:
        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}_3d/calibration"
        res = E3.run_calibration3d(exp, params, x, y, out_dir=out_dir,
                                   n_bins=args.bins, mc_samples=args.mc_samples,
                                   device=args.device)
    print(_scalars(res))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the process-level knobs (SUPERNET_ACT_DTYPE, SUPERNET_PRECISION), as
    # supernet_tpu/cli.py:773-775 reads them
    from supernet_tpu_torch.ops import apply_env_overrides

    apply_env_overrides()
    if args.cmd in _UNPORTED:
        raise _unported(f"the '{args.cmd}' subcommand", _UNPORTED[args.cmd])
    if args.cmd == "profile":
        import tempfile

        from supernet_tpu_torch.hlo_profile import run as profile_run

        out_dir = args.out_dir or os.path.join(
            tempfile.gettempdir(), f"ej_{args.config}_{args.batch}")
        os.makedirs(out_dir, exist_ok=True)
        profile_run(args.config, args.batch, out_dir, n_iters=args.iters,
                    by_layer=args.by_layer, device=args.device)
        return 0
    exp = _get_exp(args)
    if args.cmd == "study":
        if args.data_parallel:
            raise _unported("study --data-parallel",
                            "'Parallelism' (parallel/data_parallel.py)")
        return _run_study(exp, args)
    if args.cmd == "convert":
        return _convert(exp, args)
    if args.cmd == "train":
        return _train(exp, args)
    if args.cmd == "export":
        return _export(exp, args)
    if args.cmd == "train3d":
        return _train3d(exp, args)
    if args.cmd == "predict3d":
        return _predict3d(exp, args)
    if args.cmd in ("eval3d", "attack3d", "calibrate3d", "saliency3d"):
        return _evaluate3d(exp, args)
    return _evaluate(exp, args)


if __name__ == "__main__":
    sys.exit(main())
