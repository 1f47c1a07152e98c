"""On the card, MedNeXt: one training step at its published size
(``configs.MEDNEXT``: 128^3 x 4 volumes, batch 2, every block recomputed):
its peak memory, the counters of a forward and of the step (blocks,
depthwise convs, norms and the norms that took the kernel pair), the
block spans of the forward and of the backward's recomputation; and at a
small size (``n_channels`` 8, one block a stage, a 32^3 cube) the forward
and the first gradient against the plain reference
(``reference/mednext3d.py``), and recomputation against none. ``card``
marks each test: it needs a CUDA card and skips without one. This file
imports no JAX: ``python -m pytest tests/test_torch_mednext_card.py -q -p
no:randomly``."""

import dataclasses
import importlib.util
import math
import os
import statistics

import pytest
import torch

from supernet_tpu_torch import configs, tracing, train, train3d
from supernet_tpu_torch.models import unet3d
from supernet_tpu_torch.ops import set_act_dtype, set_mxu_precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG, TC = configs.MEDNEXT.model, configs.MEDNEXT.train
SMALL = dataclasses.replace(CFG, image_size=32, out_size=32, n_channels=8,
                            block_counts=(1,) * 9)
MODEL_KEYS = ("in_channels", "n_classes", "n_channels", "exp_r", "block_counts",
              "kernel_size")
TRAIN = {k: getattr(TC, k) for k in ("lr", "kl_factor", "clipnorm", "adam_eps",
                                     "sigma_clip_min", "sigma_clip_max")}


def _reference():
    path = os.path.join(REPO, "reference", "mednext3d.py")
    spec = importlib.util.spec_from_file_location("reference_mednext3d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_act_dtype("float32")
    set_mxu_precision("highest")
    yield
    tracing.disable()
    tracing.reset()
    torch.cuda.empty_cache()


def _setup(cfg, seed, batch=2):
    params = unet3d.init_params3d(torch.Generator().manual_seed(seed), cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for entry in params.values():  # gamma and beta off 1 and 0
        for key in ("gamma", "beta"):
            if key in entry:
                entry[key] = entry[key] + 0.2 * torch.randn(
                    entry[key].shape, device="cuda", generator=gen)
    s = cfg.image_size
    x = torch.randn((batch, s, s, s, cfg.in_channels), device="cuda", generator=gen)
    y = torch.randint(0, cfg.n_classes, (batch, s, s, s), device="cuda", generator=gen,
                      dtype=torch.int32)
    return params, x, y


@pytest.mark.card
def test_one_published_step_fits_and_has_its_spans_and_counters(cuda):
    params, x, y = _setup(CFG, 2 ** 31 + 27)
    tracing.reset()
    with torch.no_grad():
        unet3d.forward3d(params, x, CFG)
    counts = tracing.counters()
    # 62 blocks, each one depthwise conv and one norm, every norm through
    # the kernel pair
    assert counts["mednext.blocks"] == counts["moments3d.dwconv3d"] == 62
    assert counts["moments.norms_fused"] == counts["moments.norms"] == 62
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
    print(f"peak memory of a 128^3 b2 step with recomputation: {peak} bytes; "
          f"loss {float(m.loss)!r}")
    assert math.isfinite(float(m.loss))
    assert peak < 78e9
    counts = tracing.counters()
    # the forward's and the backward's recomputed bodies
    assert counts["mednext.blocks"] == counts["moments3d.dwconv3d"] == 124
    assert counts["moments.norms_fused"] == counts["moments.norms"] == 124
    assert counts["vdp_norm.launches"] == 124 and counts["vdp_norm.bwd_launches"] == 62
    recs = tracing.records()
    phases = [r for r in recs if r["name"] in ("train.forward", "train.backward")]

    def phase(r):
        """The phase whose host interval holds the record: a block that
        autograd's thread recomputes has no parent there."""
        return next((p["name"] for p in phases
                     if p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]), None)

    blocks = [r for r in recs if r["name"] == "mednext.block"]
    where = [phase(r) for r in blocks]
    assert where.count("train.forward") == where.count("train.backward") == 62
    (bwd,) = [r for r in recs if r["name"] == "train.backward"]
    assert all(r["device_ms"] > 0 for r in blocks)
    assert all(r["device_start_ms"] > 0 for r in blocks if phase(r) == "train.forward")
    recomputed = sum(r["device_ms"] for r in blocks if phase(r) == "train.backward")
    assert recomputed < bwd["device_ms"]


def _gaps(got, want):
    """Each leaf's largest gap over the larger of its own and the median
    leaf's largest reference element."""
    med = statistics.median(float(g.abs().max()) for g in want.values())
    return {k: float((got[k] - g).abs().max()) / max(float(g.abs().max()), med)
            for k, g in want.items()}


@pytest.mark.card
@pytest.mark.parametrize("k", [3, 5])
def test_a_small_network_matches_the_reference(cuda, k):
    """PyTorch's depthwise kernels, cuDNN's grouped transposed convs, the
    GEMMs and kernel 5 against the reference's tap-by-tap products (TF32 and
    cuDNN off there): the
    probabilities within 2e-5, sigma's mean gap over the larger of its
    reference and the reference's median within 1e-4 (its widest gap
    swings: the class softmax saturates, tests/test_torch_mednext.py), the
    ELBO within 2e-5 of itself and every leaf of its gradient within 1e-3 of
    the larger of its own and the median leaf's largest element (the CPU's
    float32 gaps: 1.2e-5)."""
    cfg = dataclasses.replace(SMALL, kernel_size=k, remat=False)
    params, x, y = _setup(cfg, 2 ** 31 + 270 + k)
    R = _reference()
    model = {key: getattr(cfg, key) for key in MODEL_KEYS}
    with torch.no_grad():
        probs, sigma = unet3d.forward3d(params, x, cfg)
        with R.arithmetic(tf32=False):
            probs_r, sigma_r = R.forward(params, x, model)
    p_gap = float((probs - probs_r).abs().max())
    scale = sigma_r.abs().median()
    s_gap = float(((sigma - sigma_r).abs() / sigma_r.abs().clamp_min(scale)).double().mean())
    leaves = {f"{n}/{key}": t.requires_grad_() for n, e in params.items()
              for key, t in e.items()}
    y1h = train.one_hot_flatten(y, cfg.n_classes)
    loss, _, _ = train3d._loss3d(params, x, y1h, cfg, TC)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with R.arithmetic(tf32=False):
        ref = R.loss(params, x, y, model, TRAIN)
        want = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    l_gap = abs(float(loss.detach()) - float(ref.detach())) / abs(float(ref.detach()))
    g_gap = max(_gaps(got, want).values())
    print(f"k={k}: probs {p_gap!r}, sigma mean {s_gap!r}, loss {l_gap!r}, gradient {g_gap!r}")
    assert p_gap < 2e-5 and s_gap < 1e-4
    assert l_gap < 2e-5 and g_gap < 1e-3


@pytest.mark.card
def test_recomputation_matches_none_on_the_card(cuda):
    """Every block under ``torch.utils.checkpoint`` against none: the same
    loss bit for bit, and each leaf of the gradient within 2e-5 of its
    largest element: the depthwise convs' and cuDNN's filter gradients may
    sum in another order from one backward to the next (observed 1.9e-6 of
    a leaf's largest element)."""
    grads, losses = [], []
    params, x, y = _setup(SMALL, 2 ** 31 + 271)
    y1h = train.one_hot_flatten(y, SMALL.n_classes)
    for remat in (False, True):
        cfg = dataclasses.replace(SMALL, remat=remat)
        leaves = {f"{n}/{key}": t.detach().clone().requires_grad_()
                  for n, e in params.items() for key, t in e.items()}
        tree = {}
        for name, t in leaves.items():
            layer, key = name.split("/")
            tree.setdefault(layer, {})[key] = t
        loss, _, _ = train3d._loss3d(tree, x, y1h, cfg, TC)
        losses.append(float(loss.detach()))
        grads.append(dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))))
    assert losses[0] == losses[1]
    for key, g in grads[0].items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((grads[1][key] - g).abs().max()) <= 2e-5 * scale, key
