"""On the card, one training step of the Cicek et al. 3D U-Net at its
published size (``models/unet3d.py:CICEK3D``: 132^3 x 3 volumes, batch 2):
its peak memory, the lowering of every moment product (cuDNN ``conv3d``),
the step's five spans, and one volume's ``probs`` and ``sigma`` against the
plain reference (``reference/vdp_unet3d.py``). ``card`` marks each test: it
needs a CUDA card and skips without one. This file imports no JAX:
``python -m pytest tests/test_torch_unet3d_card.py -q -p no:randomly``."""

import importlib.util
import math
import os

import pytest
import torch

from supernet_tpu_torch import tracing, train, train3d
from supernet_tpu_torch.models import unet3d
from supernet_tpu_torch.ops import set_act_dtype, set_mxu_precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = unet3d.CICEK3D
CFG, TC = EXP.model, EXP.train
STEP = ("train.step", "train.forward", "train.backward", "train.update", "train.metrics")


def _reference():
    path = os.path.join(REPO, "reference", "vdp_unet3d.py")
    spec = importlib.util.spec_from_file_location("reference_vdp_unet3d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_act_dtype("float32")
    set_mxu_precision("highest")
    params = unet3d.init_params3d(torch.Generator().manual_seed(2 ** 31 + 17), CFG, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2 ** 31 + 17)
    s, o = CFG.image_size, CFG.out_size
    x = torch.randn((2, s, s, s, CFG.in_channels), device="cuda", generator=gen)
    y = torch.randint(0, CFG.n_classes, (2, o, o, o), device="cuda", generator=gen,
                      dtype=torch.int32)
    yield params, x, y
    tracing.disable()
    tracing.reset()
    torch.cuda.empty_cache()


@pytest.mark.card
def test_one_published_step_fits_runs_cudnn_and_has_its_spans(setup):
    params, x, y = setup
    state, _ = train.create_train_state(params, TC, "cuda")
    step = train3d.make_train_step3d(CFG, TC)
    step(state, x, y)  # cuDNN's algorithms chosen outside the count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    tracing.enable()
    _, m = step(state, x, y)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"peak memory of a 132^3 b2 step: {peak} bytes; loss {float(m.loss)!r}")
    assert math.isfinite(float(m.loss))
    assert peak < 70e9
    counts = tracing.counters()
    # 14 convs of 3^3 per forward, the first without a variance product
    assert counts.get("moments3d.products.conv3d") == 27
    recs = tracing.records()
    (root,) = [r for r in recs if r["name"] == "train.step"]
    phases = sorted((r for r in recs if r["parent"] == root["id"]), key=lambda r: r["start_ns"])
    assert tuple(r["name"] for r in phases) == STEP[1:]
    assert all(r["device_ms"] > 0 for r in phases[:3])


@pytest.mark.card
def test_one_volume_matches_the_reference(setup):
    """cuDNN's float32 conv3d against the reference's shifted float32
    products (TF32 off on both sides): the widest probability gap, and the
    mean of sigma's gap over the larger of its reference and the
    reference's median (its widest gap swings by nature: a ReLU mask flipped
    where mu lies within rounding of 0 passes or stops that voxel's sigma,
    as the serving cells' ``sigma_max_gap``)."""
    params, x, _ = setup
    R = _reference()
    with torch.no_grad():
        probs, sigma = unet3d.forward3d(params, x[:1], CFG)
        with R.arithmetic(tf32=False):
            probs_r, sigma_r = R.forward(params, x[:1], {
                "in_channels": CFG.in_channels, "n_classes": CFG.n_classes,
                "base_kernels": CFG.base_kernels, "depth": CFG.depth})
    assert probs.shape == probs_r.shape == (1, 44 ** 3, 3)
    p_gap = float((probs - probs_r).abs().max())
    scale = sigma_r.abs().median()
    s_gaps = (sigma - sigma_r).abs() / sigma_r.abs().clamp_min(scale)
    s_gap = float(s_gaps.double().mean())
    print(f"probs max gap {p_gap!r}, sigma mean gap {s_gap!r}, widest {float(s_gaps.max())!r}")
    assert p_gap < 1e-4
    assert s_gap < 1e-4
