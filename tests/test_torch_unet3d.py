"""The port's volumetric VDP U-Net (supernet_tpu_torch/models/unet3d.py),
inflation (models/inflate.py), the 3-D FLOP and byte counts (flops.py) and
the cube geometry (train3d.derive_out_size3d) against the JAX package, on the
CPU, at the tiny config of its tests (cube 16, 2 base kernels, depth 2).

Tolerances: forward outputs within ``ATOL`` (the golden file's 2e-5);
gradients within ``GRAD_RTOL`` of each leaf's max magnitude (twelve convs
of float32 sums in another order); counts and shapes exact."""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu import flops as jflops  # noqa: E402
from supernet_tpu.configs import BRATS as JBRATS  # noqa: E402
from supernet_tpu.configs import HIPPOCAMPUS as JHIPPO  # noqa: E402
from supernet_tpu.losses import elbo_loss as jelbo  # noqa: E402
from supernet_tpu.models import forward3d as jforward3d  # noqa: E402
from supernet_tpu.models import forward_sampled3d as jsampled3d  # noqa: E402
from supernet_tpu.models import inflate_params3d as jinflate  # noqa: E402
from supernet_tpu.models import init_params as jinit2d  # noqa: E402
from supernet_tpu.models import init_params3d as jinit3d  # noqa: E402
from supernet_tpu.models import kl_regularizer3d as jkl3d  # noqa: E402
from supernet_tpu.models import layer_names3d as jlayer_names3d  # noqa: E402
from supernet_tpu.train import one_hot_flatten as jone_hot  # noqa: E402
from supernet_tpu.train3d import derive_out_size3d as jderive  # noqa: E402
from supernet_tpu_torch import flops  # noqa: E402
from supernet_tpu_torch.checkpoint import params_from_jax  # noqa: E402
from supernet_tpu_torch.configs import BRATS, HIPPOCAMPUS  # noqa: E402
from supernet_tpu_torch.losses import elbo_loss  # noqa: E402
from supernet_tpu_torch.models import (  # noqa: E402
    forward3d,
    forward_sampled3d,
    inflate_params3d,
    init_params3d,
    kl_regularizer3d,
    layer_names3d,
    softplus_inverse,
)
from supernet_tpu_torch.models.unet3d import stage_shapes3d  # noqa: E402
from supernet_tpu_torch.train import one_hot_flatten  # noqa: E402
from supernet_tpu_torch.train3d import derive_out_size3d  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN3D = os.path.join(os.path.dirname(__file__), "golden", "unet3d_tiny.npz")
CFG = dataclasses.replace(HIPPOCAMPUS.model, image_size=16, out_size=10,
                          base_kernels=2, depth=2)
JCFG = dataclasses.replace(JHIPPO.model, image_size=16, out_size=10,
                           base_kernels=2, depth=2)
ATOL = 2e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def jparams():
    """The golden file's parameters: JAX ``init_params3d(PRNGKey(42))``."""
    return jinit3d(jax.random.PRNGKey(42), JCFG)


def _x(shape, seed=42):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _forward(params_np, x, cfg=CFG, **kw):
    with torch.inference_mode():
        p, s = forward3d(params_from_jax(params_np, "cpu"), torch.from_numpy(x), cfg, **kw)
    return p.numpy(), s.numpy()


def test_golden_forward3d(jparams):
    """The golden pin of tests/test_golden.py: JAX's init carried across,
    the same input, the committed (probs, sigma) within 2e-5."""
    probs, sigma = _forward(jparams, _x((2, 16, 16, 16, 1)))
    with np.load(GOLDEN3D) as f:
        np.testing.assert_allclose(probs, f["probs"], atol=ATOL)
        np.testing.assert_allclose(sigma, f["sigma"], atol=ATOL)


def test_forward3d_matches_jax_with_taps(jparams):
    x = _x((3, 16, 16, 16, 1), seed=1)
    jtaps, ttaps = [], []
    # jit: the taps fire while tracing, and eager dispatch is slow
    jp, js = jax.jit(lambda p, xx: jforward3d(
        p, xx, JCFG, tap=lambda n, s: jtaps.append((n, tuple(s)))))(jparams, jnp.asarray(x))
    tp, ts = _forward(jparams, x, tap=lambda n, s: ttaps.append((n, s)))
    assert ttaps == jtaps
    np.testing.assert_allclose(tp, np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(ts, np.asarray(js), atol=ATOL)
    assert tuple(s for n, s in stage_shapes3d(CFG)) == tuple(
        (1,) + s[1:] for n, s in jtaps)


def test_constrain_hook_sees_the_jax_call_sequence(jparams):
    """``constrain`` runs at the JAX forward's call sites (after conv1,
    every encoder block, every pool, every decoder block); the identity hook
    leaves the outputs bit-equal."""
    x = _x((1, 16, 16, 16, 1), seed=2)
    jseen, tseen = [], []

    def jrec(m, s):
        jseen.append((tuple(m.shape), tuple(s.shape)))
        return m, s

    def trec(m, s):
        tseen.append((tuple(m.shape), tuple(s.shape)))
        return m, s

    jforward3d(jparams, jnp.asarray(x), JCFG, constrain=jrec)
    with_hook = _forward(jparams, x, constrain=trec)
    assert tseen == jseen and len(tseen) == 4
    without = _forward(jparams, x)
    for a, b in zip(with_hook, without):
        np.testing.assert_array_equal(a, b)


def _jloss(params, x, y1h):
    probs, sigma = jforward3d(params, x, JCFG)
    return jelbo(y1h, probs, sigma, jkl3d(params), 1e-3, 1e-12, 1e3)


def _tloss(params, x, y1h, cfg=CFG):
    probs, sigma = forward3d(params, x, cfg)
    return elbo_loss(y1h, probs, sigma, kl_regularizer3d(params), 1e-3, 1e-12, 1e3)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    x = _x((2, 16, 16, 16, 1), seed=3)
    y = rng.integers(0, 3, (2, 10, 10, 10)).astype(np.int32)
    return x, y


def test_loss_and_every_gradient_match_jax_grad(jparams, batch):
    x, y = batch
    jl, jg = jax.jit(jax.value_and_grad(_jloss))(jparams, jnp.asarray(x),
                                                 jone_hot(jnp.asarray(y), 3))
    params = params_from_jax(jparams, "cpu")
    leaves = [t.requires_grad_(True) for p in params.values() for t in p.values()]
    loss = _tloss(params, torch.from_numpy(x), one_hot_flatten(torch.from_numpy(y), 3))
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    want = [np.asarray(jg[layer][name]) for layer in params for name in params[layer]]
    for g, w in zip(grads, want):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_RTOL * scale


def test_remat_same_loss_and_gradients(jparams, batch):
    """``cfg.remat`` checkpoints the blocks: the same loss and gradients,
    bit for bit, and the taps fire once."""
    x, y = batch
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        params = params_from_jax(jparams, "cpu")
        leaves = [t.requires_grad_(True) for p in params.values() for t in p.values()]
        taps = []
        probs, sigma = forward3d(params, torch.from_numpy(x), cfg,
                                 tap=lambda n, s: taps.append(n))
        y1h = one_hot_flatten(torch.from_numpy(y), 3)
        loss = elbo_loss(y1h, probs, sigma, kl_regularizer3d(params), 1e-3)
        out.append((float(loss.detach()), torch.autograd.grad(loss, leaves), taps))
    assert out[0][0] == out[1][0] and out[0][2] == out[1][2]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_forward_sampled3d_matches_jax(jparams):
    """The deterministic twin on the same concrete weights (odd sides on the
    way, so the SAME-padded pool is exercised)."""
    cfg = dataclasses.replace(CFG, image_size=17)
    jcfg = dataclasses.replace(JCFG, image_size=17)
    weights = {name: np.array(p["w_mu"]) for name, p in jparams.items()}
    x = _x((2, 17, 17, 17, 1), seed=4)
    want = np.asarray(jsampled3d({k: jnp.asarray(v) for k, v in weights.items()},
                                 jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = forward_sampled3d({k: torch.from_numpy(v) for k, v in weights.items()},
                                torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_layer_names_and_kl_match_jax(jparams):
    for base in (CFG, HIPPOCAMPUS.model, BRATS.model):
        jbase = {CFG: JCFG, HIPPOCAMPUS.model: JHIPPO.model, BRATS.model: JBRATS.model}[base]
        assert layer_names3d(base) == jlayer_names3d(jbase)
    got = float(kl_regularizer3d(params_from_jax(jparams, "cpu")))
    assert got == pytest.approx(float(jkl3d(jparams)), rel=1e-6)


def test_init_params3d_distribution():
    """Shapes as JAX's; w_mu a normal cut at 2 std; raw w_sigma uniform on
    the configured range, the tighter one on the leading decoder 2^3 convs
    and the head. Streams differ, so by distribution."""
    cfg = dataclasses.replace(HIPPOCAMPUS.model, depth=3)
    p = init_params3d(torch.Generator().manual_seed(0), cfg, "cpu")
    jp = jax.jit(lambda k: jinit3d(k, dataclasses.replace(JHIPPO.model, depth=3)))(
        jax.random.PRNGKey(0))
    assert {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in p.items()} == {
        k: {n: tuple(t.shape) for n, t in v.items()} for k, v in jp.items()}
    w = torch.cat([v["w_mu"].flatten() for v in p.values()])
    assert float(w.abs().max()) <= 2 * cfg.mean_sigma + 1e-6
    assert abs(float(w.mean())) < 2e-3
    jw = np.concatenate([np.asarray(v["w_mu"]).ravel() for v in jp.values()])
    assert float(w.std()) == pytest.approx(float(jw.std()), rel=2e-2)
    for name in ("up1_conv2x2", "up2_conv2x2", "conv_final"):
        s = p[name]["w_sigma"]
        assert cfg.tight_sigma_min <= float(s.min()) and float(s.max()) <= cfg.tight_sigma_max
    s = p["conv1"]["w_sigma"]
    assert cfg.sigma_min <= float(s.min()) and float(s.max()) <= cfg.sigma_max
    p2 = init_params3d(torch.Generator().manual_seed(0), cfg, "cpu")
    assert all(torch.equal(p[k]["w_mu"], p2[k]["w_mu"]) for k in p)


def test_inflate_params3d_matches_jax():
    cfg = dataclasses.replace(CFG, base_kernels=4)
    jcfg = dataclasses.replace(JCFG, base_kernels=4)
    p2 = jinit2d(jax.random.PRNGKey(5), jcfg)
    want = jinflate(p2, jcfg)
    got = inflate_params3d({k: {n: np.asarray(v) for n, v in w.items()}
                            for k, w in p2.items()}, cfg)
    assert set(got) == set(want)
    for layer in want:
        for name in ("w_mu", "w_sigma"):
            np.testing.assert_allclose(got[layer][name].numpy(),
                                       np.asarray(want[layer][name]), rtol=1e-6,
                                       atol=1e-7)
    # tensors go in as they are; the inflated tree runs through forward3d
    got_t = inflate_params3d(params_from_jax(p2, "cpu"), cfg)
    assert torch.equal(got_t["conv1"]["w_mu"], got["conv1"]["w_mu"])
    with torch.no_grad():
        probs, _ = forward3d(got_t, torch.zeros(1, 16, 16, 16, 1), cfg)
    assert probs.shape == (1, 1000, 3)
    y = np.array([1e-4, 0.1, 1.0, 20.0], np.float32)
    np.testing.assert_allclose(torch.nn.functional.softplus(softplus_inverse(y)).numpy(),
                               y, rtol=1e-5)
    with pytest.raises(ValueError, match="missing"):
        inflate_params3d({}, cfg)
    bad = {k: dict(v) for k, v in got.items()}
    bad["conv1"] = {"w_mu": np.zeros((3, 3, 1, 1), np.float32),
                    "w_sigma": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="do not match"):
        inflate_params3d(bad, cfg)


@pytest.mark.parametrize("name", ["tiny", "hippocampus", "brats64"])
def test_flops_and_bytes_equal_the_reference(name):
    cfgs = {
        "tiny": (CFG, JCFG),
        "hippocampus": (HIPPOCAMPUS.model, JHIPPO.model),
        "brats64": (dataclasses.replace(BRATS.model, image_size=64, depth=3,
                                        bottleneck_pre_pad=None),
                    dataclasses.replace(JBRATS.model, image_size=64, depth=3,
                                        bottleneck_pre_pad=None)),
    }
    cfg, jcfg = cfgs[name]
    assert flops.forward_flops3d(cfg, 3) == jflops.forward_flops3d(jcfg, 3)
    assert flops.train_step_flops3d(cfg, 4) == jflops.train_step_flops3d(jcfg, 4)
    for ab in (2, 4):
        assert flops.forward_act_bytes3d(cfg, 2, ab) == jflops.forward_act_bytes3d(jcfg, 2, ab)
        assert flops.train_step_min_bytes3d(cfg, 4, ab) == pytest.approx(
            jflops.train_step_min_bytes3d(jcfg, 4, ab), rel=1e-12)


GEOMETRY = [(2, s) for s in (12, 13, 14, 15, 16, 21)] + \
           [(3, s) for s in (28, 29, 30, 33, 64)] + [(4, s) for s in (60, 61, 64)]


@pytest.mark.parametrize("depth,side", GEOMETRY)
def test_derive_out_size3d_matches_jax(depth, side):
    """The output side, or the same error naming the smallest valid side,
    over cube sizes around each depth's threshold; the port computes it on
    the meta device."""
    cfg = dataclasses.replace(HIPPOCAMPUS.model, image_size=side, depth=depth)
    jcfg = dataclasses.replace(JHIPPO.model, image_size=side, depth=depth)
    try:
        want = jderive(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            derive_out_size3d(cfg)
        assert str(e).split("volumetric U-Net")[1] == str(got.value).split("volumetric U-Net")[1]
        return
    assert derive_out_size3d(cfg) == want


def test_derive_out_size3d_brats_pre_pad():
    """BraTS' asymmetric bottleneck pre-pad (1, 0) at its depth 5."""
    for side in (124, 125, 128):
        cfg = dataclasses.replace(BRATS.model, image_size=side)
        jcfg = dataclasses.replace(JBRATS.model, image_size=side)
        try:
            want = jderive(jcfg)
        except ValueError:
            with pytest.raises(ValueError):
                derive_out_size3d(cfg)
            continue
        assert derive_out_size3d(cfg) == want
