"""Command-line interface of the port: the subcommands and flags of
``supernet_tpu/cli.py``, plus ``--device``.

    python -m supernet_tpu_torch.cli train --config hippocampus --data X.pkl
    python -m supernet_tpu_torch.cli train --config hippocampus --synthetic 100
    python -m supernet_tpu_torch.cli convert --config hippocampus --data X.pkl --out SHARDS
    python -m supernet_tpu_torch.cli eval   --config hippocampus --checkpoint RUN --synthetic 100
    python -m supernet_tpu_torch.cli attack --config brats --checkpoint RUN --data 'batches/*.pkl'
    python -m supernet_tpu_torch.cli study  --config hippocampus --synthetic 400 --epochs 5

``train``, ``convert``, ``eval``, ``sweep``, ``attack``, ``calibrate``,
``saliency`` and ``study`` run, each printing the JSON line(s) of its twin;
every other subcommand parses its flags and then raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it, as do
``--data-parallel``, ``train --ensemble K`` (K > 1) and ``convert
--to-cubes``. ``--checkpoint`` takes a run directory (its latest
``epoch_{N}/state.pt``), one ``epoch_{N}`` directory, an ``.npz`` or a Keras
``.h5``; ``eval``, ``calibrate`` and ``sweep`` also a comma-separated list of
them, the members of a deep ensemble. ``--device`` defaults to ``cuda``:
nothing falls back to the CPU when no card is found. ``--synthetic N``
substitutes a generated dataset for the real pickles.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# subcommand -> the ROADMAP.md item (Queue 1) that ports it
_UNPORTED = {
    "export": "'Serving, rest' (the export bundle)",
    "train3d": "'3-D family' (train3d.py)",
    "eval3d": "'3-D family' (evaluate3d.py)",
    "attack3d": "'3-D family' (evaluate3d.py)",
    "calibrate3d": "'3-D family' (evaluate3d.py)",
    "saliency3d": "'3-D family' (evaluate3d.py)",
    "predict3d": "'3-D family' (tiling.predict_volume)",
    "bench": "'Port bench and FLOP counts' (supernet_tpu_torch.bench)",
    "profile": "'CLI and profiling, rest' (python -m "
               "supernet_tpu_torch.profiling is the port's profiler until then)",
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
                         "(default /tmp/ej_<config>_<batch>)")
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


def _convert(exp, args) -> int:
    if args.to_cubes and not args.from_nifti:
        raise SystemExit(
            "--to-cubes reads raw NIfTI volumes; pass --from-nifti "
            "with a Medical-Segmentation-Decathlon task directory"
        )
    if args.to_cubes:
        raise _unported("convert --to-cubes", "'3-D family' (cube shards)")
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
                "ensemble list is served by eval/calibrate/sweep"
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


def _train(exp, args) -> int:
    from supernet_tpu_torch.trainer import Trainer

    if args.data_parallel:
        raise _unported("train --data-parallel",
                        "'Parallelism' (parallel/data_parallel.py)")
    if args.ensemble > 1:
        raise _unported("train --ensemble K > 1", "'Ensembles' (ensemble.py)")
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
    tr = Trainer(exp, train_ds, val_ds, out_dir=args.out_dir,
                 steps_per_dispatch=args.steps_per_dispatch,
                 device=args.device)
    tr.run()
    print(json.dumps({k: v[-1] for k, v in tr.history.items() if v}))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in _UNPORTED:
        raise _unported(f"the '{args.cmd}' subcommand", _UNPORTED[args.cmd])
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
    return _evaluate(exp, args)


if __name__ == "__main__":
    sys.exit(main())
