"""On the card, one training step of Swin UNETR at its published size
(``configs.SWINUNETR``: 128^3 x 4 volumes, batch 1): its peak memory, the
counters of one forward (windows, attention products, norms and the norms
that took the kernel pair, cuDNN ``conv3d`` products), the model's device-timed spans inside the step's
forward, and one volume's ``probs`` and ``sigma`` against the plain
reference (``reference/swin_unetr3d.py``). ``card`` marks each test: it
needs a CUDA card and skips without one. This file imports no JAX:
``python -m pytest tests/test_torch_swin_unetr_card.py -q -p no:randomly``."""

import importlib.util
import math
import os

import pytest
import torch

from supernet_tpu_torch import configs, tracing, train, train3d
from supernet_tpu_torch.models import unet3d
from supernet_tpu_torch.ops import set_act_dtype, set_mxu_precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG, TC = configs.SWINUNETR.model, configs.SWINUNETR.train


def _reference():
    path = os.path.join(REPO, "reference", "swin_unetr3d.py")
    spec = importlib.util.spec_from_file_location("reference_swin_unetr3d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_act_dtype("float32")
    set_mxu_precision("highest")
    params = unet3d.init_params3d(torch.Generator().manual_seed(2 ** 31 + 25), CFG, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2 ** 31 + 25)
    s = CFG.image_size
    x = torch.randn((1, s, s, s, CFG.in_channels), device="cuda", generator=gen)
    y = torch.randint(0, CFG.n_classes, (1, s, s, s), device="cuda", generator=gen,
                      dtype=torch.int32)
    yield params, x, y
    tracing.disable()
    tracing.reset()
    torch.cuda.empty_cache()


@pytest.mark.card
def test_one_published_step_fits_and_has_its_spans_and_counters(setup):
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
    print(f"peak memory of a 128^3 b1 step: {peak} bytes; loss {float(m.loss)!r}")
    assert math.isfinite(float(m.loss))
    assert peak < 78e9
    counts = tracing.counters()
    # 1000 + 125 + 27 + 8 windows a block, two blocks a stage; six products
    # an attention; 25 LayerNorms and 26 InstanceNorms; the 3^3 convs' and
    # the patch embedding's moment products (the first of each on the volume
    # without a variance product)
    assert counts.get("swin.windows") == 2320
    assert counts.get("swin.attention_products") == 48
    assert counts.get("moments.norms") == 51
    # every norm through the kernel pair: one forward and one backward call each
    assert counts.get("moments.norms_fused") == counts.get("moments.norms") == 51
    assert counts["vdp_norm.launches"] == counts["vdp_norm.bwd_launches"] == 51
    assert counts.get("moments3d.products.conv3d") == 40
    recs = tracing.records()
    (fwd,) = [r for r in recs if r["name"] == "train.forward"]
    attn = [r for r in recs if r["name"] == "swin.attention"]
    (enc,) = [r for r in recs if r["name"] == "swin.encoder"]
    (cnn,) = [r for r in recs if r["name"] == "unetr.cnn"]
    assert len(attn) == 8 and all(r["parent"] == enc["id"] for r in attn)
    assert enc["parent"] == cnn["parent"] == fwd["id"]
    for r in attn + [enc, cnn]:
        assert r["device_ms"] > 0 and r["device_start_ms"] > 0
    assert fwd["device_start_ms"] == 0.0
    # the spans lie inside the forward on the device, in order
    assert enc["device_start_ms"] + enc["device_ms"] <= cnn["device_start_ms"]
    assert cnn["device_start_ms"] + cnn["device_ms"] <= fwd["device_ms"] + 1e-3


@pytest.mark.card
def test_one_volume_matches_the_reference(setup):
    """cuDNN's float32 conv3d and the batched products against the
    reference's shifted float32 products and einsums (TF32 off on both
    sides): the widest probability gap, and the mean of sigma's gap over the
    larger of its reference and the reference's median (its widest gap
    swings by nature: a LeakyReLU mask flipped where mu lies within rounding
    of 0 moves that voxel's sigma by 1e4)."""
    params, x, _ = setup
    R = _reference()
    model = {k: getattr(CFG, k) for k in ("in_channels", "n_classes", "feature_size", "depths",
                                           "num_heads", "window_size", "patch_size",
                                           "mlp_ratio")}
    with torch.no_grad():
        probs, sigma = unet3d.forward3d(params, x, CFG)
        with R.arithmetic(tf32=False):
            probs_r, sigma_r = R.forward(params, x, model)
    assert probs.shape == probs_r.shape == (1, 128 ** 3, 3)
    p_gap = float((probs - probs_r).abs().max())
    scale = sigma_r.abs().median()
    s_gaps = (sigma - sigma_r).abs() / sigma_r.abs().clamp_min(scale)
    s_gap = float(s_gaps.double().mean())
    print(f"probs max gap {p_gap!r}, sigma mean gap {s_gap!r}, widest {float(s_gaps.max())!r}")
    assert p_gap < 1e-4
    assert s_gap < 1e-4
