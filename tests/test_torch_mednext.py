"""The MedNeXt layer plan of the port (``models/mednext3d.py``, the
depthwise moment convs of ``ops/moments3d.py``, ``configs.MEDNEXT``): its
parameters at the published size, each depthwise form against a per-tap
loop in float64, and at a small size on the CPU the whole network against
the plain reference (``reference/mednext3d.py``) through ``train3d``'s entry
points, recomputation on and off, and the spans and counters.

The small size is ``n_channels`` 4 with the L model's ratios and one block a
stage on a 16^3 cube, the smallest the plan takes (four halvings): the
levels run at 16, 8, 4 and 2 and the bottleneck at 1^3, where a GroupNorm
over one voxel gives beta and no gradient flows back through it."""

import dataclasses
import importlib.util
import itertools
import os
import statistics

import pytest
import torch
import torch.nn.functional as F

from supernet_tpu_torch import configs, train, train3d, tracing
from supernet_tpu_torch.flops import forward_flops3d
from supernet_tpu_torch.models import mednext3d, unet3d
from supernet_tpu_torch.ops import moments3d as M3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = configs.MEDNEXT.model
TC = configs.MEDNEXT.train
SMALL = dataclasses.replace(FULL, image_size=16, out_size=16, n_channels=4,
                            block_counts=(1,) * 9, remat=False)
MODEL_KEYS = ("in_channels", "n_classes", "n_channels", "exp_r", "block_counts",
              "kernel_size")
TRAIN = {k: getattr(TC, k) for k in ("lr", "kl_factor", "clipnorm", "adam_eps",
                                     "sigma_clip_min", "sigma_clip_max")}


def _model(cfg):
    return {k: getattr(cfg, k) for k in MODEL_KEYS}


def _reference():
    path = os.path.join(REPO, "reference", "mednext3d.py")
    spec = importlib.util.spec_from_file_location("reference_mednext3d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _reference()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small(k: int, **kw):
    return dataclasses.replace(SMALL, kernel_size=k, **kw)


def _params(cfg, seed: int, dtype=torch.float32):
    """The plan's init with gamma and beta moved off 1 and 0, so that their
    gradients and the affine path are held too."""
    g = torch.Generator().manual_seed(seed)
    p = unet3d.init_params3d(g, cfg, "cpu")
    for entry in p.values():
        for key in ("gamma", "beta"):
            if key in entry:
                entry[key] = entry[key] + 0.2 * torch.randn(entry[key].shape, generator=g)
    return {n: {k: v.to(dtype) for k, v in e.items()} for n, e in p.items()}


def _batch(seed: int, side: int = 16):
    g = torch.Generator().manual_seed(1000 + seed)
    return (torch.randn((2, side, side, side, 4), generator=g),
            torch.randint(0, 4, (2, side, side, side), generator=g, dtype=torch.int32))


# ------------------------------------------------------------- the plan


def test_the_published_plan():
    assert unet3d.PLANS3D["mednext"] is configs.MedNeXtConfig
    assert unet3d.EXPERIMENTS3D["mednext"] is configs.get_config("mednext")
    assert unet3d.own_plan(FULL).forward is mednext3d.forward_mednext
    assert not unet3d.is_swin(FULL) and not unet3d.is_cicek(FULL)
    assert FULL.remat and FULL.kernel_size == 3 and TC.batch_size == 2
    assert train3d.derive_out_size3d(FULL) == 128
    sides = [(n, s[1], s[-1]) for n, s in unet3d.stage_shapes3d(FULL)]
    assert sides == [("stem", 128, 32), ("enc0", 128, 32), ("enc1", 64, 64), ("enc2", 32, 128),
                     ("enc3", 16, 256), ("bottleneck", 8, 512), ("dec3", 16, 256),
                     ("dec2", 32, 128), ("dec1", 64, 64), ("dec0", 128, 32), ("out", 128, 4)]
    assert len(mednext3d.blocks(FULL)) == 62


@pytest.mark.parametrize("k,weights", [(3, 61_633_312), (5, 62_846_944)])
def test_the_parameter_count_needs_no_allocation(k, weights):
    """``w_mu`` elements of MedNeXt-L with 4 classes, from the shapes alone:
    the paper's 61.8 M (kernel 3) and 63.0 M (kernel 5) with the biases."""
    cfg = dataclasses.replace(FULL, kernel_size=k)
    shapes = mednext3d.param_shapes(cfg)
    assert sum(torch.Size(p["w_mu"]).numel() for p in shapes.values() if "w_mu" in p) == weights
    points = sum(torch.Size(s).numel() for _, _, s in mednext3d.point_params_mednext(cfg))
    assert points == 24_768
    assert next(iter(shapes)) == "stem"  # train._to_device reads the first entry


def test_the_reference_has_the_ports_layers():
    for cfg in (FULL, _small(3), _small(5)):
        assert R.layers(_model(cfg)) == unet3d.layer_names3d(cfg)
        assert R.points(_model(cfg)) == mednext3d.point_params_mednext(cfg)


def test_the_reference_copies_are_byte_identical():
    with open(os.path.join(REPO, "reference", "mednext3d.py"), "rb") as a, \
            open(os.path.join(REPO, "benchmark", "reference", "mednext3d.py"), "rb") as b:
        assert a.read() == b.read()


def test_the_row_split_refuses_the_plan():
    from supernet_tpu_torch.parallel.spatial import _RowNet

    with pytest.raises(NotImplementedError, match="MedNeXt"):
        _RowNet(SMALL, None, three_d=True)


def test_the_config_refuses_a_variance_in_the_pads():
    with pytest.raises(ValueError, match="sigma_fill"):
        dataclasses.replace(FULL, sigma_fill=0.02)


def test_the_kl_takes_k_cubed_for_a_depthwise_conv_and_leaves_out_the_norms():
    p = _params(_small(5), 0)
    gauss = {n: e for n, e in p.items() if "w_mu" in e}
    assert float(unet3d.kl_regularizer3d(p)) == float(unet3d.kl_regularizer3d(gauss))
    one = {"enc0_block0_dw": p["enc0_block0_dw"]}
    f_s = F.softplus(one["enc0_block0_dw"]["w_sigma"])
    want = (one["enc0_block0_dw"]["w_mu"] ** 2).sum() - 125 * (1 + torch.log(f_s) - f_s).mean()
    assert float(unet3d.kl_regularizer3d(one)) == pytest.approx(float(want), rel=1e-6)


def test_the_forward_count_at_the_published_size():
    # VDP operations of one 128^3 volume: 2.014 TFLOP, 1.95 of them in the
    # 1^3 convs; benchmark/core/counts_mednext3d.py counts the same
    assert round(forward_flops3d(FULL) / 1e12, 3) == 2.014


# ------------------------------------------------ the depthwise moment convs
#
# Against a loop over the taps in float64: the same sums in another order,
# agreement to rounding (1e-12 of the largest output).


def _taps_forward(mu, sigma, w, s, stride):
    k = w.shape[0]
    p = k // 2
    mp, sp = F.pad(mu, (0, 0) + (p, p) * 3), F.pad(sigma, (0, 0) + (p, p) * 3)
    n = mu.shape[1]
    o = (n + 2 * p - k) // stride + 1
    out_m = torch.zeros(mu.shape[:1] + (o, o, o) + mu.shape[-1:], dtype=mu.dtype)
    out_s = torch.zeros_like(out_m)
    for z, y, x in itertools.product(range(o), repeat=3):
        for a, b, c in itertools.product(range(k), repeat=3):
            i, j, l = z * stride + a, y * stride + b, x * stride + c
            out_m[:, z, y, x] += w[a, b, c, 0] * mp[:, i, j, l]
            out_s[:, z, y, x] += (s * (mp[:, i, j, l] ** 2 + sp[:, i, j, l])
                                  + w[a, b, c, 0] ** 2 * sp[:, i, j, l])
    return out_m, out_s


def _taps_transposed(mu, sigma, w, s):
    k = w.shape[0]
    p = k // 2
    n = mu.shape[1]
    o = 2 * n - 1
    out_m = torch.zeros(mu.shape[:1] + (o, o, o) + mu.shape[-1:], dtype=mu.dtype)
    out_s = torch.zeros_like(out_m)
    for z, y, x in itertools.product(range(n), repeat=3):
        for a, b, c in itertools.product(range(k), repeat=3):
            i, j, l = 2 * z + a - p, 2 * y + b - p, 2 * x + c - p
            if 0 <= i < o and 0 <= j < o and 0 <= l < o:
                out_m[:, i, j, l] += w[a, b, c, 0] * mu[:, z, y, x]
                out_s[:, i, j, l] += (s * (mu[:, z, y, x] ** 2 + sigma[:, z, y, x])
                                      + w[a, b, c, 0] ** 2 * sigma[:, z, y, x])
    return out_m, out_s


def _moments(seed, n, c, k):
    g = torch.Generator().manual_seed(seed)
    mu = torch.randn((2, n, n, n, c), generator=g, dtype=torch.float64)
    sigma = torch.rand(mu.shape, generator=g, dtype=torch.float64)
    w = torch.randn((k, k, k, 1, c), generator=g, dtype=torch.float64)
    w_sigma = torch.randn((c,), generator=g, dtype=torch.float64)
    return mu, sigma, w, w_sigma


def _close(a, b, rel=1e-12):
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= rel * float(b.abs().max()), float((a - b).abs().max())


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("form", ["stride1", "stride2", "transposed"])
def test_the_depthwise_moment_conv_against_a_loop_over_the_taps(form, k):
    mu, sigma, w, w_sigma = _moments(k, 5, 3, k)
    s = F.softplus(w_sigma)
    tracing.reset()
    if form == "transposed":
        got = M3.vdwconv3d_transpose(mu, sigma, w, w_sigma)
        want = _taps_transposed(mu, sigma, w, s)
    else:
        stride = 2 if form == "stride2" else 1
        got = M3.vdwconv3d(mu, sigma, w, w_sigma, stride)
        want = _taps_forward(mu, sigma, w, s, stride)
    for a, b in zip(got, want):
        _close(a, b)
    assert tracing.counters()["moments3d.dwconv3d"] == 1
    tracing.reset()


def test_the_stride2_and_transposed_1x1_convs():
    """The down block's residual: the 1^3 conv of every other voxel; the up
    block's: the 1^3 product at the odd positions of the 2n grid (the even
    ones of the 2n - 1 grid, padded (1, 0)), exactly (0, 0) elsewhere."""
    mu, sigma, _, _ = _moments(7, 4, 3, 1)
    g = torch.Generator().manual_seed(8)
    w = torch.randn((1, 1, 1, 3, 5), generator=g, dtype=torch.float64)
    ws = torch.randn((5,), generator=g, dtype=torch.float64)
    one = M3.vconv3d(mu, sigma, w, ws)
    down = M3.vconv3d(mu, sigma, w, ws, stride=2)
    for a, b in zip(down, one):
        _close(a, b[:, ::2, ::2, ::2])
    up = M3.vconv3d_transpose_1x1(mu, sigma, w, ws)
    for a, b in zip(up, one):
        assert a.shape == (2, 8, 8, 8, 5)
        assert torch.equal(a[:, 1::2, 1::2, 1::2], b)
        a = a.clone()
        a[:, 1::2, 1::2, 1::2] = 0
        assert not a.any()


# ------------------------------------------- the port against the reference
#
# Tolerances. In float64 the port and the reference are the same sums in
# another order: agreement to 1e-10 (observed 1.5e-11 of sigma's median, the
# norm's closed form over 8-voxel slices). In float32 (the precision the
# program runs) both lie up to about 1e-2 of sigma's median from float64 at
# kernel 5 and 5e-4 at kernel 3 (measured: the reference's own float32 gap is
# as large as the port's), where the class softmax saturates and its
# Jacobian's closed form cancels ((1 - 2p) sigma_c + p^2 sigma_c with p near
# 1); so float32 is held to 5e-2 of the median there and the probabilities to
# 2e-5 (observed 3.3e-6). A dropped variance term moves sigma by its own size.


def _sigma_gap(sigma, sigma_ref):
    scale = sigma_ref.abs().median()
    return float(((sigma - sigma_ref).abs() / sigma_ref.abs().clamp_min(scale)).max())


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_matches_the_reference(k, dtype):
    cfg = _small(k)
    p = _params(cfg, 0, dtype)
    x = _batch(0)[0].to(dtype)
    with torch.no_grad():
        probs, sigma = unet3d.forward3d(p, x, cfg)
        probs_r, sigma_r = R.forward(p, x, _model(cfg))
    assert probs.shape == probs_r.shape == (2, 16 ** 3, 4) and probs.dtype == dtype
    exact = dtype == torch.float64
    assert float((probs - probs_r).abs().max()) < (1e-12 if exact else 2e-5)
    assert _sigma_gap(sigma, sigma_r) < (1e-10 if exact else 5e-2)


def _leaf_gaps(got, want):
    """Each leaf's largest gap over the larger of its own and the median
    leaf's largest reference element (leaves behind the 1^3 bottleneck's
    norms have none)."""
    med = statistics.median(float(g.abs().max()) for g in want.values())
    return {key: float((got[key] - g).abs().max()) / max(float(g.abs().max()), med)
            for key, g in want.items()}


@pytest.mark.parametrize("k", [3, 5])
def test_the_gradient_of_every_leaf_matches_the_reference_in_float64(k):
    """The ELBO's gradient through ``train3d``'s loss against autograd of the
    reference's, each leaf within 1e-9 (the same sums in another order)."""
    cfg = _small(k)
    p = _params(cfg, 2, torch.float64)
    x, y = _batch(2)
    x = x.double()
    y1h = train.one_hot_flatten(y, cfg.n_classes).double()
    leaves = {f"{n}/{key}": t.requires_grad_() for n, e in p.items() for key, t in e.items()}
    loss, _, _ = train3d._loss3d(p, x, y1h, cfg, TC)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref = R.loss(p, x, y, _model(cfg), TRAIN)
    want = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    assert abs(float(loss.detach()) - float(ref.detach())) <= 1e-12 * abs(float(ref.detach()))
    gaps = _leaf_gaps(got, want)
    assert max(gaps.values()) < 1e-9, max(gaps.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("k", [3, 5])
def test_three_adam_steps_match_the_reference(k):
    cfg = _small(k)
    p = _params(cfg, 1)
    state, _ = train.create_train_state(p, TC, "cpu")
    step = train3d.make_train_step3d(cfg, TC)
    ref = R.Reference(p, _model(cfg), TRAIN)
    for i in range(3):
        x, y = _batch(i)
        _, m = step(state, x, y)
        loss_r, clipped = ref.step(x, y)
        # the ELBO: observed under 2.3e-7 of itself
        assert abs(float(m.loss) - loss_r) <= 2e-5 * abs(loss_r), i
        if i == 0:
            got = {key: state.opt_state.state[state.params[key.split("/")[0]][
                key.split("/")[1]]]["exp_avg"] / 0.1 for key in clipped}  # m_1 = (1 - b1) g
            # the first clipped gradient: observed under 1.2e-5
            gaps = _leaf_gaps(got, clipped)
            assert max(gaps.values()) < 1e-3, max(gaps.items(), key=lambda kv: kv[1])
    for key, t_r in ref.leaves():
        layer, leaf = key.split("/")
        moved = state.params[layer][leaf].detach() - p[layer][leaf]
        moved_r = t_r.detach() - p[layer][leaf]
        norm_r = torch.linalg.vector_norm(moved_r)
        if float(norm_r) == 0.0:  # behind the 1^3 bottleneck's norm: no gradient
            assert float(torch.linalg.vector_norm(moved)) == 0.0, key
            continue
        # Adam's first steps are about lr * sign(g): an element whose
        # gradient lies within rounding of Adam's epsilon moves by a share
        # of lr either way, so the change is held by its norm per leaf
        # (observed under 2.4e-4 of itself)
        gap = torch.linalg.vector_norm(moved - moved_r) / norm_r
        assert float(gap) < 2e-2, key


def test_recomputation_gives_the_same_gradients():
    """Every block under ``torch.utils.checkpoint`` or not: the same
    gradients bit for bit (the CPU's recomputation repeats the forward's
    arithmetic)."""
    grads = []
    x, y = _batch(3)
    for remat in (False, True):
        cfg = _small(3, remat=remat)
        p = _params(cfg, 3)
        leaves = [t.requires_grad_() for e in p.values() for t in e.values()]
        loss, _, _ = train3d._loss3d(p, x, train.one_hot_flatten(y, 4), cfg, TC)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------ spans and counters


def test_the_counters_at_the_published_block_counts():
    """62 blocks, depthwise convs and norms a forward; 124 block bodies and
    depthwise convs a training step with recomputation (the forward's and
    the backward's), and the backward's block spans inside
    ``train.backward``'s host interval."""
    cfg = dataclasses.replace(FULL, image_size=16, out_size=16, n_channels=2)
    p = _params(cfg, 4)
    x, y = _batch(4)
    tracing.reset()
    with torch.no_grad():
        unet3d.forward3d(p, x, cfg)
    counts = tracing.counters()
    assert counts["mednext.blocks"] == counts["moments3d.dwconv3d"] == 62
    assert counts["moments.norms"] == 62 and counts.get("moments.norms_fused", 0) == 0
    tracing.reset()
    state, _ = train.create_train_state(p, TC, "cpu")
    step = train3d.make_train_step3d(cfg, TC)
    tracing.enable()
    try:
        step(state, x, y)
        recs = tracing.records()
    finally:
        tracing.disable()
    counts = tracing.counters()
    assert counts["mednext.blocks"] == counts["moments3d.dwconv3d"] == 124
    phases = [r for r in recs if r["name"] in ("train.forward", "train.backward")]

    def phase(r):
        """The phase whose host interval holds the record, as
        ``benchmark/core/readers_mednext3d.py`` reads it."""
        return next((p["name"] for p in phases
                     if p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]), None)

    for name, each in (("mednext.block", 62), ("mednext.dwconv", 62)):
        where = [phase(r) for r in recs if r["name"] == name]
        assert where.count("train.forward") == where.count("train.backward") == each, name
    tracing.reset()
