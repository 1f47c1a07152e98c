"""The Swin UNETR layer plan of the port (``models/swin_unetr3d.py``,
``ops/moments_swin.py``, ``configs.SWINUNETR``): its layers at the
published size, each moment closed form against the diagonal of
J diag(sigma) J^T from autograd's Jacobian in float64, and at a small size
on the CPU the whole network against the plain reference
(``reference/swin_unetr3d.py``) through ``train3d``'s entry points.

The small size is feature size 12 and heads (3, 6, 12, 24) on a 32^3 cube,
the smallest the plan takes (five halvings): the stages run at 16, 8, 4 and
2. Under windows of 3 every stage's cube is padded to whole windows, the
last stage's window shrinks to its side and the shifted blocks take the
region mask; one forward also runs the published window of 7."""

import dataclasses
import importlib.util
import os

import pytest
import torch
from torch.autograd.functional import jacobian

from supernet_tpu_torch import configs, train, train3d, tracing
from supernet_tpu_torch.flops import forward_flops3d
from supernet_tpu_torch.models import swin_unetr3d as swin
from supernet_tpu_torch.models import unet3d
from supernet_tpu_torch.ops import moments_swin as MS
from supernet_tpu_torch.ops.moments import vsoftmax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = configs.SWINUNETR.model
TC = configs.SWINUNETR.train
CFG7 = dataclasses.replace(FULL, feature_size=12, image_size=32, out_size=32)
CFG = dataclasses.replace(CFG7, window_size=3)
MODEL_KEYS = ("in_channels", "n_classes", "feature_size", "depths", "num_heads",
              "window_size", "patch_size", "mlp_ratio")
TRAIN = {k: getattr(TC, k) for k in ("lr", "kl_factor", "clipnorm", "adam_eps",
                                     "sigma_clip_min", "sigma_clip_max")}


def _model(cfg):
    return {k: getattr(cfg, k) for k in MODEL_KEYS}


def _reference():
    path = os.path.join(REPO, "reference", "swin_unetr3d.py")
    spec = importlib.util.spec_from_file_location("reference_swin_unetr3d", path)
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


def _params(cfg, seed: int):
    """The plan's init with the point parameters moved off 1 and 0, so that
    their gradients and the affine path are held too."""
    g = torch.Generator().manual_seed(seed)
    p = unet3d.init_params3d(g, cfg, "cpu")
    for entry in p.values():
        for key in ("gamma", "beta"):
            if key in entry:
                entry[key] = entry[key] + 0.2 * torch.randn(entry[key].shape, generator=g)
    return p


def _batch(seed: int):
    g = torch.Generator().manual_seed(1000 + seed)
    return (torch.randn((1, 32, 32, 32, 4), generator=g),
            torch.randint(0, 3, (1, 32, 32, 32), generator=g, dtype=torch.int32))


# ------------------------------------------------------------- the plan


def test_the_published_plan():
    assert unet3d.PLANS3D["swinunetr"] is configs.SwinUNETRConfig
    assert unet3d.EXPERIMENTS3D["swinunetr"] is configs.get_config("swinunetr")
    names = unet3d.layer_names3d(FULL)
    assert sum(k ** 3 * cin * cout for _, k, cin, cout in names) == 61_963_920
    assert sum(torch.Size(s).numel() for _, _, s in swin.point_params_swin(FULL)) == 215_010
    assert train3d.derive_out_size3d(FULL) == 128
    sides = [(n, s[1], s[-1]) for n, s in unet3d.stage_shapes3d(FULL)]
    assert sides == [("patch_embed", 64, 48), ("hidden1", 32, 96), ("hidden2", 16, 192),
                     ("hidden3", 8, 384), ("hidden4", 4, 768), ("out", 128, 3)]
    assert unet3d.is_swin(FULL) and not unet3d.is_cicek(FULL)


def test_the_reference_has_the_ports_layers():
    for cfg in (FULL, CFG):
        assert R.layers(_model(cfg)) == unet3d.layer_names3d(cfg)
        assert R.points(_model(cfg)) == swin.point_params_swin(cfg)
    tree = swin.param_shapes(FULL)
    assert next(iter(tree)) == "patch_embed"  # train._to_device reads the first entry


def test_the_reference_copies_are_byte_identical():
    with open(os.path.join(REPO, "reference", "swin_unetr3d.py"), "rb") as a, \
            open(os.path.join(REPO, "benchmark", "reference", "swin_unetr3d.py"), "rb") as b:
        assert a.read() == b.read()


def test_the_row_split_refuses_the_plan():
    from supernet_tpu_torch.parallel.spatial import _RowNet

    with pytest.raises(NotImplementedError, match="Swin UNETR"):
        _RowNet(CFG, None, three_d=True)


def test_the_kl_leaves_out_the_point_parameters():
    p = _params(CFG, 0)
    gauss = {n: e for n, e in p.items() if "w_mu" in e}
    assert float(unet3d.kl_regularizer3d(p)) == float(unet3d.kl_regularizer3d(gauss))


def test_the_forward_count_at_the_published_size():
    # VDP operations (mean and variance products): 2.79 TFLOP in the CNN
    # blocks (decoder1's 1.62 of it), 0.12 in the Swin encoder's layers with
    # weights, 0.20 in the window attention (six products and the score
    # passes); benchmark/core/counts_swin3d.py counts the same
    assert round(forward_flops3d(FULL) / 1e12, 3) == 3.114


# ------------------------------------------------- the closed forms
#
# Each moment map against diag(J diag(sigma) J^T) of its mean map, in
# float64, where the map is first-order exact: agreement to rounding.


def _first_order(f, mu, sigma):
    j = jacobian(f, mu).reshape(f(mu).numel(), mu.numel())
    return ((j * j) @ sigma.reshape(-1)).reshape(f(mu).shape)


def _close(a, b):
    assert torch.allclose(a, b, rtol=1e-10, atol=1e-14 * float(b.abs().max())), \
        float((a - b).abs().max())


def _g(seed):
    return torch.Generator().manual_seed(seed)


def test_layer_norm_moments():
    g = _g(1)
    mu = torch.randn((2, 2, 3, 2, 8), generator=g, dtype=torch.float64)
    sigma = torch.rand(mu.shape, generator=g, dtype=torch.float64)
    gamma = torch.randn(8, generator=g, dtype=torch.float64)
    beta = torch.randn(8, generator=g, dtype=torch.float64)
    m, s = MS.vlayer_norm(mu, sigma, gamma, beta)
    _close(m, torch.nn.functional.layer_norm(mu, (8,), gamma, beta))
    _close(s, _first_order(lambda t: MS.vlayer_norm(t, t, gamma, beta)[0], mu, sigma))


def test_instance_norm_moments():
    g = _g(2)
    mu = torch.randn((2, 3, 2, 4, 3), generator=g, dtype=torch.float64)
    sigma = torch.rand(mu.shape, generator=g, dtype=torch.float64)
    m, s = MS.vinstance_norm3d(mu, sigma)
    ref = torch.nn.functional.instance_norm(mu.permute(0, 4, 1, 2, 3), eps=1e-5)
    _close(m, ref.permute(0, 2, 3, 4, 1))
    _close(s, _first_order(lambda t: MS.vinstance_norm3d(t, t)[0], mu, sigma))


@pytest.mark.parametrize("fn,plain", [
    (MS.vgelu, torch.nn.functional.gelu),
    (MS.vleaky_relu, lambda t: torch.nn.functional.leaky_relu(t, 0.01)),
])
def test_elementwise_moments(fn, plain):
    g = _g(3)
    mu = torch.randn((3, 40), generator=g, dtype=torch.float64)
    sigma = torch.rand(mu.shape, generator=g, dtype=torch.float64)
    m, s = fn(mu, sigma)
    _close(m, plain(mu))
    _close(s, _first_order(plain, mu, sigma))


def test_softmax_moments_along_the_keys():
    g = _g(4)
    mu = torch.randn((2, 3, 7), generator=g, dtype=torch.float64)
    sigma = torch.rand(mu.shape, generator=g, dtype=torch.float64)
    p, s = vsoftmax(mu, sigma, axis=-1)
    assert p.dtype == torch.float64 and p.shape == mu.shape
    _close(s, _first_order(lambda t: torch.softmax(t, -1), mu, sigma))
    p1, s1 = vsoftmax(mu.transpose(1, 2), sigma.transpose(1, 2), axis=1)
    _close(s1.transpose(1, 2), s)
    # the attention's Function keeps p and sigma alone; its backward is the
    # closed form's autograd
    assert torch.autograd.gradcheck(MS.SoftmaxMoments.apply,
                                    (mu.requires_grad_(), sigma.requires_grad_()))


@pytest.mark.parametrize("product", ["scores", "values"])
def test_the_attention_products(product):
    """Q K^T and P V of independent Gaussian entries: the first-order part
    of each variance is the Jacobian's, the rest the product of the two
    variances (exact for a product of independent variables)."""
    g = _g(5)
    a_m, b_m = (torch.randn((2, 3, 5, 4), generator=g, dtype=torch.float64) for _ in range(2))
    a_s, b_s = (torch.rand((2, 3, 5, 4), generator=g, dtype=torch.float64) for _ in range(2))
    if product == "scores":
        fn, mean = MS.score_moments, lambda a, b: a @ b.transpose(-1, -2)
        second = a_s @ b_s.transpose(-1, -2)
    else:
        a_m, a_s = a_m @ b_m.transpose(-1, -2), a_s @ b_s.transpose(-1, -2)  # [.., 5, 5]
        fn, mean = MS.value_moments, lambda a, b: a @ b
        second = a_s @ b_s
    m, s = fn(a_m, a_s, b_m, b_s)
    _close(m, mean(a_m, b_m))
    both = torch.cat([a_m.reshape(-1), b_m.reshape(-1)])
    var = torch.cat([a_s.reshape(-1), b_s.reshape(-1)])
    n = a_m.numel()

    def f(t):
        return mean(t[:n].reshape(a_m.shape), t[n:].reshape(b_m.shape))

    _close(s, _first_order(f, both, var) + second)


@pytest.mark.parametrize("side,window", [(3, 3), (5, 3)])
def test_the_window_attention_with_variance_on_the_values(side, window):
    """With sigma on v alone the scores carry no variance and the window
    attention's output variance is first-order exact, so it is the
    Jacobian's through the padding, the shift, the windows, the bias and the
    mask. Side 3 is one window; side 5 is padded to 6, eight windows,
    shifted by 1 with the region mask."""
    g = _g(5)
    heads, c = 2, 4
    mu = torch.randn((1, side, side, side, 3 * c), generator=g, dtype=torch.float64)
    sigma = torch.zeros_like(mu)
    sigma[..., 2 * c:] = torch.rand((1, side, side, side, c), generator=g, dtype=torch.float64)
    table = 0.1 * torch.randn(((2 * window - 1) ** 3, heads), generator=g, dtype=torch.float64)
    shift = 1 if side > window else 0

    def mean(t):
        return MS.window_attention(t, torch.zeros_like(t), heads, window, shift, table)[0]

    _, s = MS.window_attention(mu, sigma, heads, window, shift, table)
    _close(s, _first_order(mean, mu, sigma))


def test_the_attention_counts_its_windows_and_products():
    tracing.reset()
    mu = torch.randn((1, 5, 5, 5, 12))
    MS.window_attention(mu, mu.abs(), 2, 3, 1, torch.zeros((125, 2)))
    counts = tracing.counters()
    assert counts["swin.windows"] == 8 and counts["swin.attention_products"] == 6


# ------------------------------------------- the port against the reference
#
# Tolerances. Both sides compute in float32 and differ by summation order
# (PyTorch's conv3d and batched products against the reference's shifted
# products and einsums); in float64 the two forwards agree to 1e-14 in
# probs and 1.5e-12 of sigma. The probabilities' observed float32 gap is
# under 2e-6; sigma, relative to its median where it is small, under 1e-4:
# where the class softmax saturates its Jacobian's closed form cancels
# ((1 - 2p) sigma_c + p^2 sigma_c with p near 1), so a rounding of p moves
# sigma by a share of itself. A dropped variance term moves sigma by its own
# size, a wrong mask or bias the probs by 1e-3 and more.


def _sigma_gap(sigma, sigma_ref):
    scale = sigma_ref.abs().median()
    return float(((sigma - sigma_ref).abs() / sigma_ref.abs().clamp_min(scale)).max())


@pytest.mark.parametrize("cfg", [CFG, CFG7], ids=["window3", "window7"])
def test_forward_matches_the_reference(cfg):
    p = _params(cfg, 0)
    x, _ = _batch(0)
    with torch.no_grad():
        probs, sigma = unet3d.forward3d(p, x, cfg)
        probs_r, sigma_r = R.forward(p, x, _model(cfg))
    assert probs.shape == probs_r.shape == (1, 32 ** 3, 3)
    assert float((probs - probs_r).abs().max()) < 2e-5
    assert _sigma_gap(sigma, sigma_r) < 1e-3


def test_loss_gradient_and_three_adam_steps_match_the_reference():
    p = _params(CFG, 1)
    state, _ = train.create_train_state(p, TC, "cpu")
    step = train3d.make_train_step3d(CFG, TC)
    ref = R.Reference(p, _model(CFG), TRAIN)
    for i in range(3):
        x, y = _batch(i)
        _, m = step(state, x, y)
        loss_r, clipped = ref.step(x, y)
        # the ELBO: observed under 1e-6 of itself
        assert abs(float(m.loss) - loss_r) <= 2e-5 * abs(loss_r), i
        if i == 0:
            for key, g_r in clipped.items():
                layer, leaf = key.split("/")
                t = state.params[layer][leaf]
                g = state.opt_state.state[t]["exp_avg"] / 0.1  # m_1 = (1 - beta1) g
                # the first clipped gradient over the leaf's largest element:
                # observed under 1e-4
                assert float((g - g_r).abs().max()) <= 1e-3 * float(g_r.abs().max()), key
    for key, t_r in ref.leaves():
        layer, leaf = key.split("/")
        moved = state.params[layer][leaf].detach() - p[layer][leaf]
        moved_r = t_r.detach() - p[layer][leaf]
        # Adam's first steps are about lr * sign(g): an element whose
        # gradient lies within rounding of Adam's epsilon moves by a share of
        # lr either way, up to a whole step (decoder5's up-conv sees one
        # voxel at this size), so the change is held by its norm per leaf
        # (observed under 1.8e-3 of itself)
        gap = torch.linalg.vector_norm(moved - moved_r) / torch.linalg.vector_norm(moved_r)
        assert float(gap) < 2e-2, key
