"""The bf16 activation mode of the port (``ops.set_act_dtype``,
``SUPERNET_ACT_DTYPE``) on the CPU: the port's bf16 forward against the JAX
package's bf16 forward on the same parameters and input, the dtypes of every
moment op and of the gradients (after ``tests/test_moments.py:
test_act_dtype_bfloat16_mode``), the float32 kernel boundary, and the
environment knobs."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.configs import HIPPOCAMPUS as JHIPPOCAMPUS  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu.models.unet import forward as jforward  # noqa: E402
from supernet_tpu.ops import moments as jmoments  # noqa: E402
from supernet_tpu_torch import cli, ops, train  # noqa: E402
from supernet_tpu_torch.checkpoint import params_from_jax  # noqa: E402
from supernet_tpu_torch.configs import HIPPOCAMPUS  # noqa: E402
from supernet_tpu_torch.models import forward  # noqa: E402
from supernet_tpu_torch.ops import moments  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(image_size=32, out_size=22, base_kernels=4)
CFG = dataclasses.replace(HIPPOCAMPUS.model, **TINY)
JCFG = dataclasses.replace(JHIPPOCAMPUS.model, **TINY)
# the limits of test_act_dtype_bfloat16_mode: probabilities within 0.03
# absolute (bf16 keeps about three decimal digits), the per-pixel class
# agreeing on more than 99% of the pixels
PROBS_ATOL = 0.03
AGREE = 0.99


@pytest.fixture
def bf16():
    """Both packages in bf16 for the test, float32 again after it."""
    moments.set_act_dtype("bfloat16")
    jmoments.set_act_dtype("bfloat16")
    yield
    moments.set_act_dtype("float32")
    jmoments.set_act_dtype("float32")


def _x(n=2, seed=0, size=32):
    return np.random.default_rng(seed).normal(0, 1, (n, size, size, 1)).astype(np.float32)


def _agree(a, b) -> float:
    return float(np.mean(np.argmax(a, -1) == np.argmax(b, -1)))


def test_set_act_dtype_names():
    assert ops.get_act_dtype() == torch.float32
    for name, want in (("bf16", torch.bfloat16), ("f32", torch.float32),
                       ("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        ops.set_act_dtype(name)
        assert ops.get_act_dtype() == want
    with pytest.raises(ValueError, match="unknown activation dtype"):
        ops.set_act_dtype("float16")


def test_bf16_forward_matches_jax_bf16_forward():
    """The same JAX-initialised parameters and numpy input through both
    packages, float32 and bf16. Probabilities: PROBS_ATOL and AGREE between
    the two bf16 forwards. Sigma: the JAX package's bf16 forward rounds the
    weights of every conv and its outputs to bf16 and lands 0.2 of sigma's
    max from its own float32 forward at this size; the port's kernels keep
    float32 weights and compute in float32 between the bf16 roundings, so
    its bf16 sigma must lie no farther from the float32 sigma than JAX's."""
    params = jinit(jax.random.PRNGKey(3), JCFG)
    x = _x()
    tp = params_from_jax(params, "cpu")

    def both():
        jp, js = jforward(params, jnp.asarray(x), JCFG)
        with torch.no_grad():
            p, s = forward(tp, torch.from_numpy(x), CFG)
        assert p.dtype == s.dtype == torch.float32
        return np.asarray(jp), np.asarray(js), p.numpy(), s.numpy()

    jp32, js32, p32, s32 = both()
    moments.set_act_dtype("bfloat16")
    jmoments.set_act_dtype("bfloat16")
    try:
        jp16, js16, p16, s16 = both()
    finally:
        moments.set_act_dtype("float32")
        jmoments.set_act_dtype("float32")
    np.testing.assert_allclose(p16, jp16, atol=PROBS_ATOL)
    assert _agree(p16, jp16) > AGREE
    np.testing.assert_allclose(p16, p32, atol=PROBS_ATOL)
    scale = np.abs(js32).max()
    port_err = np.abs(s16 - js32).max() / scale
    jax_err = np.abs(js16 - js32).max() / scale
    assert port_err <= jax_err, (port_err, jax_err)
    assert np.abs(s16 - s32).max() / scale <= jax_err


def test_full_width_bf16_mode_like_jax(bf16):
    """After test_act_dtype_bfloat16_mode, at its size (hippocampus, full
    width, 2 images of 64x64, PRNGKey(3)): the head emits float32, the bf16
    forward lies within PROBS_ATOL and AGREE of the float32 one, and every
    gradient comes back float32 and finite."""
    cfg = HIPPOCAMPUS.model
    params = params_from_jax(jinit(jax.random.PRNGKey(3), JHIPPOCAMPUS.model), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 64, 64, 1))
                         .astype(np.float32))
    moments.set_act_dtype("float32")
    with torch.no_grad():
        p32, _ = forward(params, x, cfg)
    moments.set_act_dtype("bfloat16")
    for t in train.leaves(params):
        t.requires_grad_(True)
    p16, s16 = forward(params, x, cfg)
    assert p16.dtype == s16.dtype == torch.float32
    np.testing.assert_allclose(p16.detach().numpy(), p32.numpy(), atol=PROBS_ATOL)
    assert _agree(p16.detach().numpy(), p32.numpy()) > AGREE
    loss = torch.mean(torch.square(p16)) + torch.mean(s16)
    grads = torch.autograd.grad(loss, train.leaves(params))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)


def test_moment_op_dtypes_and_float32_kernel_boundary(bf16, monkeypatch):
    """Every moment op keeps bf16 between layers (the pool and the pads
    their input's dtype), channel sums run in float32, the softmax head
    returns float32, and the two kernel ops are reached with float32
    moments only."""
    from supernet_tpu_torch.ops.kernels import pool as P
    from supernet_tpu_torch.ops.kernels import vdp_conv as V

    seen = []
    conv, pool = V.VDPConv.apply, P.VMaxPool.apply
    monkeypatch.setattr(V.VDPConv, "apply", lambda mu, sg, *a: (
        seen.append((mu.dtype, None if sg is None else sg.dtype)) or conv(mu, sg, *a)))
    monkeypatch.setattr(P.VMaxPool, "apply", lambda mu, sg: (
        seen.append((mu.dtype, sg.dtype)) or pool(mu, sg)))
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))  # noqa: E731
    x, w3, w2, w1 = t(2, 10, 10, 3), 0.3 * t(3, 3, 3, 8), 0.3 * t(2, 2, 8, 4), 0.3 * t(1, 1, 8, 5)
    ws8, ws4, ws5 = t(8) - 3, t(4) - 3, t(5) - 3
    bf = torch.bfloat16
    m, s = ops.vconv_input_relu(x, w3, ws8)
    assert m.dtype == s.dtype == bf
    m2, s2 = ops.vconv_relu(m, s, 0.3 * t(3, 3, 8, 8), ws8)
    assert m2.dtype == s2.dtype == bf
    for out in (ops.vconv(m, s, 0.3 * t(3, 3, 8, 8), ws8), ops.vconv(m, s, w1, ws5),
                ops.vconv_input(x, w3, ws8), ops.vconv_input(x, 0.3 * t(1, 1, 3, 8), ws8),
                ops.vmaxpool(m, s), ops.vunpool_conv2(m, s, w2, ws4),
                ops.vpad(m, s, (2, 2), 0.02), ops.vcrop_concat(m2, s2, m, s)):
        assert out[0].dtype == out[1].dtype == bf
    p, v = ops.vsoftmax(*ops.vconv(m, s, w1, ws5))
    assert p.dtype == v.dtype == torch.float32
    assert seen and all(d in (torch.float32, None) for pair in seen for d in pair)
    assert ops.chan_sum(m).dtype == torch.float32


def test_train_step_under_bf16(bf16):
    """One train step in bf16: parameters, Adam moments and gradients stay
    float32, the loss is finite and float32."""
    state, _ = train.create_train_state(jinit(jax.random.PRNGKey(0), JCFG),
                                        HIPPOCAMPUS.train, "cpu")
    x = _x(4, seed=2)
    y = np.random.default_rng(3).integers(0, 3, (4, 22, 22)).astype(np.int32)
    loss, _ = train.loss_fn(state.params, torch.from_numpy(x), torch.from_numpy(y),
                            CFG, HIPPOCAMPUS.train)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    state, m = train.make_train_step(CFG, HIPPOCAMPUS.train)(state, x, y)
    assert np.isfinite(float(m.loss)) and state.step == 1
    for p in train.leaves(state.params):
        assert p.dtype == torch.float32
        st = state.opt_state.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


def test_apply_env_overrides(monkeypatch, capsys):
    """SUPERNET_ACT_DTYPE, SUPERNET_PRECISION and the A/B knobs take
    effect; the three kernel switches of the JAX package, when set, are
    named on stderr with their reason."""
    monkeypatch.setenv("SUPERNET_ACT_DTYPE", "bfloat16")
    monkeypatch.setenv("SUPERNET_PRECISION", "high")
    monkeypatch.setenv("SUPERNET_BACKEND", "pallas")
    monkeypatch.setenv("SUPERNET_CONV_FOLD", "sigma")
    monkeypatch.setenv("SUPERNET_CONV3D", "conv")
    monkeypatch.delenv("SUPERNET_WINSUM", raising=False)
    try:
        ops.apply_env_overrides()
        assert ops.get_act_dtype() == torch.bfloat16
        assert ops.get_mxu_precision() == "high"
        assert ops.get_conv_fold() == "sigma"
    finally:
        ops.set_act_dtype("float32")
        ops.set_mxu_precision("highest")
        ops.set_conv_fold("none")
    err = capsys.readouterr().err
    assert "SUPERNET_BACKEND=pallas has no counterpart" in err
    assert "SUPERNET_CONV_FOLD" not in err  # ported
    assert "SUPERNET_CONV3D" not in err
    assert "SUPERNET_WINSUM" not in err and "SUPERNET_ACT_DTYPE" not in err
    monkeypatch.setenv("SUPERNET_ACT_DTYPE", "float16")
    with pytest.raises(ValueError):
        ops.apply_env_overrides()


def test_cli_reads_the_knobs_first(monkeypatch):
    """``cli.main`` applies the knobs before it dispatches
    (supernet_tpu/cli.py:773-775), ``bench`` included (run here as a stub:
    the bench itself is tests/test_torch_bench.py's)."""
    from supernet_tpu_torch import bench

    calls = []
    monkeypatch.setattr(ops, "apply_env_overrides", lambda: calls.append("knobs"))
    monkeypatch.setattr(bench, "main", lambda device="cuda": calls.append(("bench", device)))
    assert cli.main(["bench"]) == 0
    assert calls == ["knobs", ("bench", "cuda")]
