"""The port's VDP U-Net (supernet_tpu_torch/models/unet.py) against the JAX
model: the golden pin, the Pallas-backend forward in interpret mode, the
BraTS geometry, the init distribution and the npz layout across packages."""

import dataclasses
import functools
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.configs import BRATS, HIPPOCAMPUS  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu.models import layer_names as jlayer_names  # noqa: E402
from supernet_tpu_torch.checkpoint import (  # noqa: E402
    load_params_npz,
    params_from_jax,
    save_params_npz,
)
from supernet_tpu_torch.models import (  # noqa: E402
    VDPUNet,
    forward,
    init_params,
    kl_regularizer,
    layer_names,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hippo_tiny.npz")
CFG = dataclasses.replace(HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4)
ATOL = 1e-5


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _forward(params_np, x, cfg, tap=None):
    with torch.inference_mode():
        p, s = forward(params_from_jax(params_np, "cpu"), torch.from_numpy(x),
                       cfg, tap=tap)
    return p.numpy(), s.numpy()


def test_golden_forward():
    """tests/test_golden.py:_compute through the port, at the golden's own
    tolerance."""
    probs, sigma = _forward(jinit(jax.random.PRNGKey(42), CFG), _x((2, 32, 32, 1), 42), CFG)
    with np.load(GOLDEN) as f:
        np.testing.assert_allclose(probs, f["probs"], atol=2e-5)
        np.testing.assert_allclose(sigma, f["sigma"], atol=2e-5)


def test_forward_matches_jax_pallas_backend():
    """As tests/test_pallas.py:66-98, with the pool kernel too."""
    from supernet_tpu.ops import moments
    from supernet_tpu.ops.pallas import pool as jpool
    from supernet_tpu.ops.pallas import vdp_conv as real_vdp_conv
    import supernet_tpu.ops.pallas as pk

    params = jinit(jax.random.PRNGKey(0), CFG)
    x = _x((2, 32, 32, 1), 0)
    orig = pk.vdp_conv
    pk.vdp_conv = functools.partial(real_vdp_conv, interpret=True)
    moments.set_backend("pallas")
    moments.set_pool_impl("pallas")
    jpool.set_interpret(True)
    try:
        pj, sj = jforward(params, jnp.asarray(x), CFG)
    finally:
        jpool.set_interpret(False)
        moments.set_pool_impl("xla")
        moments.set_backend("xla")
        pk.vdp_conv = orig
    pt, st = _forward(params, x, CFG)
    np.testing.assert_allclose(pt, np.asarray(pj), atol=ATOL)
    np.testing.assert_allclose(st, np.asarray(sj), atol=ATOL)


def test_brats_geometry_and_forward():
    """BraTS geometry (204x204x4, depth 5, (1,0) bottleneck pre-pad) at base
    2: every stage shape equals the JAX forward's tap, and the outputs
    agree."""
    cfg = dataclasses.replace(BRATS.model, base_kernels=2)
    params = jinit(jax.random.PRNGKey(1), cfg)
    x = _x((1, 204, 204, 4), 1)
    jtaps, ttaps = [], []
    # jit: the taps fire while tracing, and eager dispatch at 204x204 is slow
    pj, sj = jax.jit(lambda p, x: jforward(
        p, x, cfg, tap=lambda n, s: jtaps.append((n, tuple(s)))
    ))(params, jnp.asarray(x))
    pt, st = _forward(params, x, cfg, tap=lambda n, s: ttaps.append((n, s)))
    assert ttaps == jtaps
    assert ("pre_pad", (1, 10, 10, 16)) in ttaps
    assert pt.shape == (1, 186 * 186, 5)
    np.testing.assert_allclose(pt, np.asarray(pj), atol=ATOL)
    np.testing.assert_allclose(st, np.asarray(sj), atol=ATOL)


def test_layer_names_match_jax():
    for cfg in (HIPPOCAMPUS.model, BRATS.model, CFG):
        assert layer_names(cfg) == jlayer_names(cfg)


def test_init_params_distribution():
    """torch.Generator and jax.random give different draws: check the
    distribution. Truncated normal at 2 std has std 0.8796 * mean_sigma."""
    cfg = HIPPOCAMPUS.model
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tight = {"up1_conv2x2", "up2_conv2x2", "conv_final"}
    assert list(params) == [n for n, *_ in layer_names(cfg)]
    for name, k, cin, cout in layer_names(cfg):
        w_mu, w_sigma = params[name]["w_mu"], params[name]["w_sigma"]
        assert w_mu.shape == (k, k, cin, cout) and w_sigma.shape == (cout,)
        assert w_mu.dtype == torch.float32 and w_sigma.dtype == torch.float32
        assert w_mu.abs().max() <= 2 * cfg.mean_sigma
        lo, hi = ((cfg.tight_sigma_min, cfg.tight_sigma_max) if name in tight
                  else (cfg.sigma_min, cfg.sigma_max))
        assert lo <= w_sigma.min() and w_sigma.max() <= hi
    all_mu = torch.cat([p["w_mu"].flatten() for p in params.values()])
    assert all_mu.numel() > 100_000
    assert abs(float(all_mu.mean()) - cfg.mean_mu) < 0.01 * cfg.mean_sigma
    assert abs(float(all_mu.std()) / cfg.mean_sigma - 0.8796) < 0.01
    wide = torch.cat([params[n]["w_sigma"] for n in params if n not in tight])
    mid = (cfg.sigma_min + cfg.sigma_max) / 2
    assert abs(float(wide.mean()) - mid) < 0.1 * (cfg.sigma_max - cfg.sigma_min)
    again = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert all(torch.equal(again[n]["w_mu"], params[n]["w_mu"]) for n in params)


def test_kl_regularizer_matches_jax():
    from supernet_tpu.models import kl_regularizer as jkl

    params = jinit(jax.random.PRNGKey(5), CFG)
    got = kl_regularizer(params_from_jax(params, "cpu"))
    np.testing.assert_allclose(float(got), float(jkl(params)), rtol=1e-5)


def test_npz_round_trip_across_packages(tmp_path):
    from supernet_tpu.checkpoint import load_params_npz as jload
    from supernet_tpu.checkpoint import save_params_npz as jsave

    params = jinit(jax.random.PRNGKey(7), CFG)
    jsave(str(tmp_path / "jax.npz"), params)
    ported = load_params_npz(str(tmp_path / "jax.npz"), "cpu")
    save_params_npz(str(tmp_path / "torch.npz"), ported)
    back = jload(str(tmp_path / "torch.npz"))
    assert set(back) == set(params)
    for layer in params:
        for name in ("w_mu", "w_sigma"):
            np.testing.assert_array_equal(ported[layer][name].numpy(),
                                          np.asarray(params[layer][name]))
            np.testing.assert_array_equal(np.asarray(back[layer][name]),
                                          np.asarray(params[layer][name]))


def test_vdpunet_module_loads_jax_params():
    params = jinit(jax.random.PRNGKey(42), CFG)
    model = VDPUNet(CFG, "cpu", torch.Generator().manual_seed(0))
    assert model.n_params == sum(int(np.prod(v.shape)) for p in params.values()
                                 for v in p.values())
    model.load_jax_params(params)
    with torch.inference_mode():
        probs, sigma = model(torch.from_numpy(_x((2, 32, 32, 1), 42)))
    with np.load(GOLDEN) as f:
        np.testing.assert_allclose(probs.numpy(), f["probs"], atol=2e-5)
        np.testing.assert_allclose(sigma.numpy(), f["sigma"], atol=2e-5)


def test_kl_regularizer_grad_matches_jax():
    from supernet_tpu.models import kl_regularizer as jkl

    params = jinit(jax.random.PRNGKey(5), CFG)
    want = jax.grad(jkl)(params)
    tparams = params_from_jax(params, "cpu")
    leaves = [t.requires_grad_() for p in tparams.values() for t in p.values()]
    got = torch.autograd.grad(kl_regularizer(tparams), leaves)
    names = [(layer, n) for layer, p in tparams.items() for n in p]
    for g, (layer, n) in zip(got, names):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[layer][n]), rtol=1e-5,
                                   atol=1e-7)


def test_vdpunet_trains_like_the_functional_forward():
    """VDPUNet's parameters are trainable leaves: a backward through the
    module gives every parameter the gradient of the functional forward."""
    params = jinit(jax.random.PRNGKey(2), CFG)
    model = VDPUNet(CFG, "cpu", torch.Generator().manual_seed(0))
    model.load_jax_params(params)
    x = torch.from_numpy(_x((2, 32, 32, 1), 3))
    c = torch.from_numpy(_x((2, 22 * 22, 3), 4))
    probs, sigma = model(x)
    ((probs + sigma) * c).sum().backward()
    tparams = params_from_jax(params, "cpu")
    leaves = [t.requires_grad_() for p in tparams.values() for t in p.values()]
    p2, s2 = forward(tparams, x, CFG)
    want = torch.autograd.grad(((p2 + s2) * c).sum(), leaves)
    got = [getattr(model.layers[layer], n).grad for layer, p in tparams.items() for n in p]
    assert all(g is not None for g in got)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_constrain_hook_sees_the_jax_call_sequence():
    """``forward(..., constrain=)`` runs the hook at the JAX forward's call
    sites (after conv1, every encoder block, every pool and every decoder
    block, `supernet_tpu/models/unet.py:146-273`): a recording hook sees the
    same sequence of shapes in both packages, and the identity hook leaves
    the outputs bit-equal. BraTS geometry at reduced width: five levels and
    the asymmetric bottleneck pre-pad."""
    cfg = dataclasses.replace(BRATS.model, base_kernels=2)
    params = jinit(jax.random.PRNGKey(3), cfg)
    x = _x((1, 204, 204, 4), 3)
    jseen, tseen = [], []

    def jrec(m, s):
        jseen.append((tuple(m.shape), tuple(s.shape)))
        return m, s

    def trec(m, s):
        tseen.append((tuple(m.shape), tuple(s.shape)))
        return m, s

    jax.jit(lambda p, xx: jforward(p, xx, cfg, constrain=jrec))(params, jnp.asarray(x))
    with torch.inference_mode():
        tp = params_from_jax(params, "cpu")
        hooked = forward(tp, torch.from_numpy(x), cfg, constrain=trec)
        plain = forward(tp, torch.from_numpy(x), cfg)
    assert tseen == jseen and len(tseen) == 1 + 4 + 4 + 4
    for a, b in zip(hooked, plain):
        assert torch.equal(a, b)
