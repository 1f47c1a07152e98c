"""The Cicek et al. 3D U-Net layer plan of the port (``models/unet3d.py``:
``CicekConfig``, ``CICEK3D``): its layers at the published size on the
``meta`` device, and at a small size on the CPU the port's forward, ELBO,
gradients and Adam steps against the plain reference
(``reference/vdp_unet3d.py``), through the entry points the 3-D family has
(``train3d``, ``InferenceSession(volumetric=True)``). The small size is the
plan's rules at base 4 and depth 3 on a 44^3 cube, which gives 4^3."""

import contextlib
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from supernet_tpu_torch import configs, serving, train, train3d
from supernet_tpu_torch.models import unet3d
from supernet_tpu_torch.ops.moments import lowering
from supernet_tpu_torch.ops import moments3d as M3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CICEK = unet3d.CICEK3D.model
CFG = dataclasses.replace(CICEK, image_size=44, out_size=4, base_kernels=4, depth=3)
TC = unet3d.CICEK3D.train
MODEL = {k: getattr(CFG, k) for k in ("in_channels", "n_classes", "base_kernels", "depth")}
TRAIN = {k: getattr(TC, k) for k in ("lr", "kl_factor", "clipnorm", "adam_eps",
                                     "sigma_clip_min", "sigma_clip_max")}
# (name, k, in, out, output side at 132): the plan of arXiv:1606.06650, Fig. 1
PUBLISHED = [
    ("conv_input", 3, 3, 32, 130), ("conv1", 3, 32, 64, 128),
    ("conv2", 3, 64, 64, 62), ("conv3", 3, 64, 128, 60),
    ("conv4", 3, 128, 128, 28), ("conv5", 3, 128, 256, 26),
    ("conv6", 3, 256, 256, 11), ("conv7", 3, 256, 512, 9),
    ("up1_conv2x2", 2, 512, 512, 18), ("up1_conv1", 3, 768, 256, 16),
    ("up1_conv2", 3, 256, 256, 14),
    ("up2_conv2x2", 2, 256, 256, 28), ("up2_conv1", 3, 384, 128, 26),
    ("up2_conv2", 3, 128, 128, 24),
    ("up3_conv2x2", 2, 128, 128, 48), ("up3_conv1", 3, 192, 64, 46),
    ("up3_conv2", 3, 64, 64, 44),
    ("conv_final", 1, 64, 3, 44),
]


def _reference():
    path = os.path.join(REPO, "reference", "vdp_unet3d.py")
    spec = importlib.util.spec_from_file_location("reference_vdp_unet3d", path)
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


def _params(seed: int):
    """The plan's own init (``init_params3d``): He-scale ``w_mu``, ``w_sigma``
    uniform on the config's ranges."""
    return unet3d.init_params3d(torch.Generator().manual_seed(seed), CFG, "cpu")


def _batches(seed: int, n: int = 2, b: int = 2):
    g = torch.Generator().manual_seed(1000 + seed)
    s, o = CFG.image_size, CFG.out_size
    return [(torch.randn((b, s, s, s, CFG.in_channels), generator=g),
             torch.randint(0, CFG.n_classes, (b, o, o, o), generator=g, dtype=torch.int32))
            for _ in range(n)]


def _sigma_gap(sigma, sigma_ref):
    """|sigma - sigma_ref| over the larger of |sigma_ref| and its median: a
    variance near 0 differs by float32 rounding of its larger neighbours."""
    scale = sigma_ref.abs().median()
    return float(((sigma - sigma_ref).abs() / sigma_ref.abs().clamp_min(scale)).max())


# ------------------------------------------------------------- the plan


def test_the_published_plan_on_the_meta_device():
    names = unet3d.layer_names3d(CICEK)
    assert [n[:4] for n in names] == [p[:4] for p in PUBLISHED]
    assert sum(k ** 3 * cin * cout for _, k, cin, cout in names) == 19_067_616
    assert train3d.derive_out_size3d(CICEK) == 44
    sides = {name: shape[1] for name, shape in unet3d.stage_shapes3d(CICEK)}
    assert [sides[p[0]] for p in PUBLISHED] == [p[4] for p in PUBLISHED]
    assert "pre_pad" not in sides
    assert configs.get_config("cicek3d") is unet3d.CICEK3D


def test_the_small_plan_gives_a_4_cube_and_the_reference_the_same_layers():
    assert train3d.derive_out_size3d(CFG) == 4
    assert R.layers(MODEL) == unet3d.layer_names3d(CFG)
    assert R.layers({"in_channels": 3, "n_classes": 3, "base_kernels": 32, "depth": 4}) == \
        unet3d.layer_names3d(CICEK)


def test_the_supernet_family_is_unchanged_at_cube_64():
    """SUPER-Net's 3-D schedule at the hippocampus config, stage by stage:
    the decoder's (3,3) and (2,2) pads are still there."""
    cfg = configs.HIPPOCAMPUS.model
    assert train3d.derive_out_size3d(cfg) == 54
    sides = [(name, shape[1], shape[-1]) for name, shape in unet3d.stage_shapes3d(cfg)]
    assert sides == [
        ("conv_input", 62, 32), ("conv1", 60, 32), ("pool0", 30, 32), ("conv2", 28, 64),
        ("conv3", 26, 64), ("pool1", 13, 64), ("conv4", 11, 128), ("conv5", 9, 128),
        ("up1_conv2x2", 18, 64), ("up1_concat", 24, 128), ("up1_conv1", 22, 64),
        ("up1_conv2", 24, 64), ("up2_conv2x2", 48, 32), ("up2_concat", 54, 64),
        ("up2_conv1", 52, 32), ("up2_conv2", 54, 32), ("conv_final", 54, 3)]
    assert not unet3d.is_cicek(cfg)


def test_the_reference_copies_are_byte_identical():
    with open(os.path.join(REPO, "reference", "vdp_unet3d.py"), "rb") as a, \
            open(os.path.join(REPO, "benchmark", "reference", "vdp_unet3d.py"), "rb") as b:
        assert a.read() == b.read()


def test_the_row_split_refuses_the_plan():
    with pytest.raises(NotImplementedError, match="Cicek"):
        from supernet_tpu_torch.parallel.spatial import _RowNet

        _RowNet(CFG, None, three_d=True)


# ------------------------------------------- the port against the reference
#
# Tolerances. Both sides compute in float32 and differ by summation order
# (PyTorch's conv3d against the reference's 27 shifted products). Against
# float64 either side's first gradient reads up to about 4e-5 of the leaf's
# largest element, and sigma up to 9e-4 of itself where the softmax
# Jacobian cancels: each tolerance below is some 5-10x the widest gap of
# the two sides over these seeds, and far under what a wrong equation gives
# (a missing variance term moves sigma by its own size, a dropped skip the
# probs by 1e-2 and more).


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_the_reference(seed):
    p = _params(seed)
    x, _ = _batches(seed, 1)[0]
    with torch.no_grad():
        probs, sigma = unet3d.forward3d(p, x, CFG)
        probs_r, sigma_r = R.forward(p, x, MODEL)
    assert probs.shape == probs_r.shape == (2, 4 ** 3, 3)
    # probabilities: the observed gaps are under 3e-6
    assert float((probs - probs_r).abs().max()) < 1e-5
    # sigma, relative to its median where it is small: observed under 2e-5
    assert _sigma_gap(sigma, sigma_r) < 2e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_every_gradient_match_the_reference(seed):
    p = _params(seed)
    x, y = _batches(seed, 1)[0]
    state, _ = train.create_train_state(p, TC, "cpu")
    loss, _, _ = train3d._loss3d(state.params, x, train.one_hot_flatten(y, 3), CFG, TC)
    loss.backward()
    ref = R.Reference(p, MODEL, TRAIN)
    loss_r = R.loss(ref.params, x, y, MODEL, TRAIN)
    grads_r = torch.autograd.grad(loss_r, [t for _, t in ref.leaves()])
    # the ELBO: observed under 2e-6 of itself
    assert abs(float(loss.detach()) - float(loss_r)) <= 5e-5 * abs(float(loss_r))
    for (key, _), g_r in zip(ref.leaves(), grads_r):
        layer, leaf = key.split("/")
        g = state.params[layer][leaf].grad
        # each leaf over its largest element: observed under 3e-5, and each
        # side about 4e-5 from float64
        assert float((g - g_r).abs().max()) <= 3e-4 * float(g_r.abs().max()), key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_adam_steps_match_the_reference(seed):
    p = _params(seed)
    batches = _batches(seed, 2)
    state, _ = train.create_train_state(p, TC, "cpu")
    step = train3d.make_train_step3d(CFG, TC)
    ref = R.Reference(p, MODEL, TRAIN)
    for x, y in batches:
        _, m = step(state, x, y)
        loss_r, _ = ref.step(x, y)
        assert abs(float(m.loss) - loss_r) <= 5e-5 * abs(loss_r)
    for key, t_r in ref.leaves():
        layer, leaf = key.split("/")
        moved = state.params[layer][leaf].detach() - p[layer][leaf]
        moved_r = t_r.detach() - p[layer][leaf]
        # the change over two steps, per leaf by its norm: Adam's first
        # steps are about lr * sign(g), so an element whose gradient lies
        # within rounding of Adam's epsilon moves by a share of lr either
        # way (observed under 7e-4 of the leaf's change)
        gap = torch.linalg.vector_norm(moved - moved_r) / torch.linalg.vector_norm(moved_r)
        assert float(gap) < 5e-3, key
        # and no element more than half a step apart (observed under 0.06 lr)
        assert float((moved - moved_r).abs().max()) < 0.5 * TC.lr, key


# -------------------------------------------------- lowerings and entry points


@contextlib.contextmanager
def _im2col():
    M3.set_conv3d_impl("im2col")
    try:
        yield
    finally:
        M3.set_conv3d_impl("conv")


@pytest.mark.parametrize("lowered", [lambda: lowering(glue_fold="fold"), _im2col],
                         ids=["glue_fold", "im2col"])
def test_the_lowerings_run_the_plan(lowered):
    """The glue fold (which takes each decoder block's first conv with its
    skip; the plan has no pads to fold) and the im2col lowering give the
    default path's moments."""
    p = _params(3)
    x, _ = _batches(3, 1)[0]
    with torch.no_grad():
        probs, sigma = unet3d.forward3d(p, x, CFG)
        with lowered():
            probs_l, sigma_l = unet3d.forward3d(p, x, CFG)
    assert float((probs - probs_l).abs().max()) < 1e-5
    assert _sigma_gap(sigma_l, sigma) < 2e-4


def test_trainer3d_trains_the_plan():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 44, 44, 44, 3)).astype(np.float32)
    y = rng.integers(0, 3, (4, 44, 44, 44)).astype(np.int32)
    exp = unet3d.CICEK3D.replace(model=CFG, train=dataclasses.replace(TC, epochs=1))
    tr = train3d.Trainer3D(exp, x, y, out_dir=None, device="cpu")
    tr.out_dir = None
    state = tr.init_state()
    xb, yb = torch.from_numpy(x[:2]), torch.from_numpy(tr.y_crop[:2])
    _, m = tr.step_fn(state, xb, yb)
    assert np.isfinite(float(m.loss)) and state.step == 1


def test_predict_volume_tiles_a_volume_that_is_not_a_multiple_of_the_tile():
    p = _params(4)
    sess = serving.InferenceSession(p, CFG, batch_size=4, volumetric=True, device="cpu")
    vol = np.random.default_rng(4).normal(0, 1, (9, 6, 7, 3)).astype(np.float32)
    probs, sigma = sess.predict_volume(vol, overlap=0, weight="uniform", pad_mode="constant")
    assert probs.shape == sigma.shape == (9, 6, 7, 3)
    assert np.isfinite(probs).all() and np.isfinite(sigma).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    # the corner [0, 2)^3 lies in the first tile alone: its input cube is the
    # volume behind a 20-voxel zero margin (44 -> 4)
    cube = np.zeros((1, 44, 44, 44, 3), np.float32)
    cube[0, 20:29, 20:26, 20:27] = vol
    with torch.no_grad():
        probs_r, sigma_r = R.forward(p, torch.from_numpy(cube), MODEL)
    probs_r = probs_r.reshape(4, 4, 4, 3)[:2, :2, :2].numpy()
    sigma_r = sigma_r.reshape(4, 4, 4, 3)[:2, :2, :2].numpy()
    np.testing.assert_allclose(probs[:2, :2, :2], probs_r, atol=1e-5)
    np.testing.assert_allclose(sigma[:2, :2, :2], sigma_r, rtol=2e-4,
                               atol=2e-4 * float(np.median(np.abs(sigma_r))))
