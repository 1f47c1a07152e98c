"""The port's losses, configs and train/eval steps (supernet_tpu_torch/
{losses,configs,train}.py) on the CPU against their JAX twins: the same npz
parameters and the same numpy batches through both packages."""

import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import losses as jlosses  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.checkpoint import load_params_npz as jload  # noqa: E402
from supernet_tpu.checkpoint import save_params_npz as jsave  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import configs, losses, train  # noqa: E402
from supernet_tpu_torch.checkpoint import (  # noqa: E402
    load_params_npz,
    params_from_jax,
    save_params_npz,
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


CFG = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                          base_kernels=4)
JCFG = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                           base_kernels=4)
TC = configs.HIPPOCAMPUS.train
JTC = jconfigs.HIPPOCAMPUS.train
STEPS, BATCH = 5, 4


def _data(k, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (k, b, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (k, b, 22, 22)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """One parameter file that both packages start from."""
    path = str(tmp_path_factory.mktemp("params") / "init.npz")
    jsave(path, jinit(jax.random.PRNGKey(0), JCFG))
    return path


def _pairs(tparams, jparams):
    """(port tensor, JAX array as numpy) of each leaf, matched by name: JAX
    returns dicts with sorted keys."""
    return [(t, np.asarray(jparams[layer][name]))
            for layer, ws in tparams.items() for name, t in ws.items()]


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("name", ["hippocampus", "brats", "lungs"])
def test_configs_equal_jax(name):
    """The port's copy of the configs equals the JAX package's, field for
    field, so the two cannot drift."""
    assert dataclasses.asdict(configs.get_config(name)) == dataclasses.asdict(
        jconfigs.get_config(name))


def _field_spec(cls):
    def default(f):
        if f.default_factory is not dataclasses.MISSING:
            return ("factory", dataclasses.asdict(f.default_factory()))
        return f.default
    return [(f.name, str(f.type), default(f)) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("cls", ["ModelConfig", "AugmentConfig", "TrainConfig",
                                 "AttackConfig", "NoiseConfig", "ExperimentConfig"])
def test_config_classes_equal_jax(cls):
    """Field names, types and defaults of each config class."""
    assert configs.__all__ == jconfigs.__all__
    assert _field_spec(getattr(configs, cls)) == _field_spec(getattr(jconfigs, cls))


# ------------------------------------------------------------------ losses


def _loss_inputs(seed, sigma_scale=1.0):
    rng = np.random.default_rng(seed)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 30))]
    mu = rng.dirichlet(np.ones(3), (2, 30)).astype(np.float32)
    sigma = (sigma_scale * rng.uniform(0, 1, (2, 30, 3))).astype(np.float32)
    return y, mu, sigma


@pytest.mark.parametrize("case", ["plain", "tiny_sigma", "nan_scrub", "inf_scrub"])
def test_nll_gaussian_matches_jax(case):
    """Including the scrub: a NaN or Inf quadratic term counts as 0, and
    the log term stays."""
    y, mu, sigma = _loss_inputs(1, 1e-5 if case == "tiny_sigma" else 1.0)
    if case.endswith("scrub"):
        mu[0, 0, 0] = np.nan if case == "nan_scrub" else np.inf
    got = float(losses.nll_gaussian(*map(torch.from_numpy, (y, mu, sigma))))
    want = float(jlosses.nll_gaussian(*map(jnp.asarray, (y, mu, sigma))))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if case.endswith("scrub"):
        log_term = np.log(sigma.astype(np.float64) + losses.NLL_EPS).sum(-1).mean()
        np.testing.assert_allclose(got, 0.5 * log_term, rtol=1e-6)


def test_elbo_loss_clips_and_matches_jax_grad():
    """sigma outside [1e-12, 1e3] is clipped before the NLL; loss and the
    gradients with respect to mu and sigma equal JAX's."""
    y, mu, sigma = _loss_inputs(2)
    sigma[0, :4, 0] = [5e3, 2e3, 0.0, -1.0]
    kl = np.float32(123.0)

    def jloss(m, s):
        return jlosses.elbo_loss(jnp.asarray(y), m, s, kl, JTC.kl_factor, 1e-12, 1e3)

    want = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(sigma))
    tm, ts = (torch.from_numpy(a).requires_grad_() for a in (mu, sigma))
    got = losses.elbo_loss(torch.from_numpy(y), tm, ts, torch.tensor(kl), TC.kl_factor)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want[0]), rtol=1e-6)
    for g, r in zip((tm.grad, ts.grad), want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)
    assert (ts.grad[0, :4, 0] == 0).all()  # clipped: no gradient through the clip


# ------------------------------------------------------------ train pieces


def test_clip_by_per_tensor_norm_matches_optax_twin():
    rng = np.random.default_rng(3)
    grads = [rng.normal(0, s, shape).astype(np.float32)
             for s, shape in ((1.0, (3, 3, 2, 4)), (0.01, (4,)), (5.0, (7,)), (0.0, (2,)))]
    clip = jtrain.clip_by_per_tensor_norm(1.0)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    got = [torch.from_numpy(g.copy()) for g in grads]
    train.clip_by_per_tensor_norm(got, 1.0)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
        assert float(torch.linalg.vector_norm(g)) <= 1.0 + 1e-6
    # one global norm (clip_grad_norm_) would scale the small tensor too
    np.testing.assert_array_equal(got[1].numpy(), grads[1])


def test_one_hot_and_ensure_one_hot():
    y = np.random.default_rng(4).integers(0, 3, (2, 5, 5)).astype(np.int32)
    got = train.ensure_one_hot(torch.from_numpy(y), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtrain.one_hot_flatten(y, 3)))
    assert got.dtype == torch.float32 and got.shape == (2, 25, 3)
    assert train.ensure_one_hot(got, 3) is got


def test_unported_options_raise():
    """No option of the step makers is left unported: adversarial
    training builds in all three and a step of it trains (the mixed
    objective itself is held against JAX in tests/test_torch_attacks.py);
    augmentation builds (tests/test_torch_data.py runs it)."""
    tc = dataclasses.replace(TC, adversarial_training="fgsm", adv_epsilon=0.01)
    for build in (lambda: train.make_train_step(CFG, tc),
                  lambda: train.make_multi_train_step(CFG, tc, 2),
                  lambda: train.make_accum_train_step(CFG, tc, 2)):
        assert callable(build())
    x, y = _data(1, 2, seed=8)
    params = {k: {n: torch.from_numpy(np.array(v)) for n, v in ws.items()}
              for k, ws in jinit(jax.random.PRNGKey(0), JCFG).items()}
    state, _ = train.create_train_state(params, tc, "cpu")
    state, m = train.make_train_step(CFG, tc)(state, x[0], y[0])
    assert state.step == 1 and all(np.isfinite(float(v)) for v in m)
    assert not torch.equal(state.params["conv1"]["w_mu"].detach(), params["conv1"]["w_mu"])
    tc = dataclasses.replace(TC, augment=configs.AugmentConfig())
    assert callable(train.make_train_step(CFG, tc))
    assert callable(train.make_multi_train_step(CFG, tc, 2))


def test_entry_points_default_to_the_card():
    from supernet_tpu_torch.models import init_params
    from supernet_tpu_torch.serving import InferenceSession

    for fn, arg in ((init_params, "device"), (load_params_npz, "device"),
                    (params_from_jax, "device"), (InferenceSession, "device"),
                    (train.create_train_state, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda", fn


# ------------------------------------------------------- steps against JAX


def test_train_step_matches_jax(npz):
    """5 steps from the same npz parameters and batches: losses and metrics
    (rtol 1e-5), step-1 gradients per leaf (1e-4 of its max), predictions,
    and the parameters after 5 steps (atol 2 * lr * 5, and 99.9% of the
    elements within 1e-6)."""
    x, y = _data(STEPS, BATCH)
    jparams = jload(npz)
    state, _ = train.create_train_state(load_params_npz(npz, "cpu"), TC, "cpu")

    jgrads = jax.grad(lambda p: jtrain.loss_fn(
        p, jnp.asarray(x[0]), jtrain.ensure_one_hot(jnp.asarray(y[0]), 3), JCFG, JTC)[0]
    )(jparams)
    loss, _ = train.loss_fn(state.params, torch.from_numpy(x[0]), torch.from_numpy(y[0]),
                            CFG, TC)
    tgrads = torch.autograd.grad(loss, train.leaves(state.params))
    for g, (_, r) in zip(tgrads, _pairs(state.params, jgrads)):
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()

    jstate, _ = jtrain.create_train_state(jparams, JTC)
    jstep = jtrain.make_train_step(JCFG, JTC, with_pred=True)
    step = train.make_train_step(CFG, TC, with_pred=True)
    for i in range(STEPS):
        jstate, jm, jpred = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]))
        state, m, pred = step(state, x[i], y[i])
        np.testing.assert_allclose([float(v) for v in m], [float(v) for v in jm], rtol=1e-5)
        assert (pred.numpy() != np.asarray(jpred)).mean() < 1e-3
    assert state.step == STEPS and int(jstate.step) == STEPS
    diffs = np.concatenate([
        np.abs(a.detach().numpy() - b).ravel()
        for a, b in _pairs(state.params, jstate.params)])
    assert diffs.max() <= 2 * TC.lr * STEPS
    assert (diffs <= 1e-6).mean() >= 0.999


def test_multi_train_step_equals_single_steps(npz):
    """K steps per call are K single steps, metrics stacked."""
    x, y = _data(3, 2, seed=5)
    s1, _ = train.create_train_state(load_params_npz(npz, "cpu"), TC, "cpu")
    s2, _ = train.create_train_state(load_params_npz(npz, "cpu"), TC, "cpu")
    step = train.make_train_step(CFG, TC)
    want = [step(s1, x[i], y[i])[1] for i in range(3)]
    s2, ms, preds = train.make_multi_train_step(CFG, TC, 3, with_pred=True)(s2, x, y)
    assert preds.shape == (3, 2, 22 * 22)
    for field, stacked in zip(ms, zip(*want)):
        torch.testing.assert_close(field, torch.stack(stacked), rtol=0, atol=0)
    for a, b in zip(train.leaves(s1.params), train.leaves(s2.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_accum_train_step_matches_jax(npz):
    """One update from 2 microbatches of 2, against JAX's accumulation
    step (tests/test_multistep.py:62)."""
    x, y = _data(2, 2, seed=1)
    jstate, _ = jtrain.create_train_state(jload(npz), JTC)
    jstate, jm = jtrain.make_accum_train_step(JCFG, JTC, 2)(
        jstate, jnp.asarray(x), jnp.asarray(y))
    state, _ = train.create_train_state(load_params_npz(npz, "cpu"), TC, "cpu")
    state, m = train.make_accum_train_step(CFG, TC, 2)(state, x, y)
    np.testing.assert_allclose([float(v) for v in m], [float(v) for v in jm], rtol=1e-5)
    for a, b in _pairs(state.params, jstate.params):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=2e-6)


def test_eval_step_matches_jax(npz):
    x, y = _data(1, 3, seed=6)
    want = jtrain.make_eval_step(JCFG, JTC)(jload(npz), jnp.asarray(x[0]), jnp.asarray(y[0]))
    got = train.make_eval_step(CFG, TC)(load_params_npz(npz, "cpu"), x[0], y[0])
    for g, r in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, dtype=np.float64),
                                   np.asarray(r, dtype=np.float64), rtol=1e-5, atol=1e-6)


def test_trained_params_round_trip_into_jax(npz, tmp_path):
    """Parameters after a port train step load into the JAX package."""
    state, _ = train.create_train_state(load_params_npz(npz, "cpu"), TC, "cpu")
    x, y = _data(1, 2, seed=7)
    state, _ = train.make_train_step(CFG, TC)(state, x[0], y[0])
    path = str(tmp_path / "trained.npz")
    save_params_npz(path, state.params)
    back = jload(path)
    assert set(back) == set(state.params)
    for a, b in _pairs(state.params, back):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    probs, _ = jtrain.make_eval_step(JCFG, JTC)(back, jnp.asarray(x[0]), jnp.asarray(y[0]))[:2]
    assert np.isfinite(np.asarray(probs)).all()


# ---------------------------------------------------------------- profiling


def test_profiling_categories_and_busy_union():
    """The profile's kernel categories (the hand-written kernels before the
    generic convolution names) and the busy time as a union of spans."""
    from types import SimpleNamespace

    from supernet_tpu_torch import profiling

    cases = {
        "void (anonymous namespace)::vdp_conv_kernel<64, true, true>(float const*)": "vdp_conv (kernel 1)",
        "(anonymous namespace)::sigma_bwd_kernel(float const*, float*)": "sigma backward (kernel 4)",
        "vmaxpool_bwd_kernel": "pool backward (kernel 3)",
        "vmaxpool_fwd_kernel": "pool forward (kernel 2)",
        "void wgrad_alg0_engine_NHWC<float, 128>(int)": "cuDNN convolutions (VDPConv backward)",
        "sm80_xmma_dgrad_implicit_gemm_f32f32": "cuDNN convolutions (VDPConv backward)",
        "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n": "matmuls (1x1 head, unpool conv)",
        "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n": "cuDNN convolutions (VDPConv backward)",
        "void fft2d_r2c_32x32<float, false, 0u, false>(float2*)": "cuDNN convolutions (VDPConv backward)",
        "void at::native::multi_tensor_apply_kernel<...>": "Adam",
        "ampere_sgemm_128x64_nn": "matmuls (1x1 head, unpool conv)",
        "Memcpy HtoD (Pageable -> Device)": "copies and fills",
        "void at::native::elementwise_kernel<128, 2>": profiling.OTHER,
    }
    for name, want in cases.items():
        assert profiling.category(name) == want, name
    spans = [(0, 10), (5, 12), (20, 25), (21, 22)]
    events = [SimpleNamespace(time_range=SimpleNamespace(start=s, end=e)) for s, e in spans]
    assert profiling._busy_us(events) == 17


def test_profiling_needs_a_card():
    from supernet_tpu_torch import profiling

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    for call in (lambda: profiling.profile_train_step("hippocampus", 2),
                 lambda: profiling.profile_serving("hippocampus", 2, 2)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
