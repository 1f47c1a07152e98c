"""The port's attacks (``supernet_tpu_torch/attacks.py``) and adversarial
training (``supernet_tpu_torch/train.py``) on the CPU against
``supernet_tpu.attacks`` and ``supernet_tpu.train``: the same parameters
(carried across with ``params_from_jax``) and the same numpy batches through
both packages.

Tolerances. A gradient with respect to the input is held to ``GRAD_TOL`` of
its own max magnitude, before the sign. The sign is compared only where the
gradient is above ``SIGN_FLOOR`` of its max: below that its sign is decided
by float32 rounding, and with a step that saturates the epsilon-ball one such
pixel parts two correct implementations by 2 * epsilon. So adversarial
images are compared by the share of pixels that differ (``ADV_SHARE``), and
the ball and the data range exactly.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import attacks as jattacks  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu_torch import attacks, configs, train  # noqa: E402
from supernet_tpu_torch.checkpoint import params_from_jax  # noqa: E402


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
TC = dataclasses.replace(configs.HIPPOCAMPUS.train, batch_size=4)
JTC = dataclasses.replace(jconfigs.HIPPOCAMPUS.train, batch_size=4)

GRAD_TOL = 2e-5  # max |port - jax| / max |jax|, gradients w.r.t. the input
SIGN_FLOOR = 1e-3  # signs are compared where |g| > SIGN_FLOOR * max |g|
ADV_SHARE = 0.01  # share of pixels of an adversarial image that may differ
LOSS_RTOL = 1e-5
PARAM_GRAD_TOL = 1e-4  # per leaf, relative to the leaf's max magnitude


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.PRNGKey(1), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jparams, "cpu")


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (b, 22, 22)).astype(np.int32)
    return x, y


def _flat(y, n=3):
    return train.one_hot_flatten(torch.from_numpy(y), n)


def _jflat(y, n=3):
    return jtrain.one_hot_flatten(jnp.asarray(y), n)


def _ac(mod, **kw):
    return mod.AttackConfig(**kw)


# ------------------------------------------------------------------ labels


def test_one_hot_of_an_out_of_range_class_is_a_zero_row():
    """Labels {-1, 0, 1, 2, 3} at depth 3: the classes outside [0, 3) give
    all-zero rows as ``jax.nn.one_hot`` does, and nothing raises (the
    default targeted Hippocampus attack relabels class 2 to class 3)."""
    y = np.array([[[0, 1, 2, 3], [3, 2, -1, 0]]], np.int32)
    got = train.one_hot_flatten(torch.from_numpy(y), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jflat(y)))
    assert got.dtype == torch.float32 and got.shape == (1, 8, 3)
    assert got[0, 3].sum() == 0 and got[0, 6].sum() == 0
    assert train.ensure_one_hot(torch.from_numpy(y), 3).shape == (1, 8, 3)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_retarget_labels_matches_jax(dtype):
    y = np.random.default_rng(0).integers(0, 3, (2, 5, 5)).astype(dtype)
    got = attacks.retarget_labels(torch.from_numpy(y), 2, 3)
    want = jattacks.retarget_labels(jnp.asarray(y.astype(np.int32)), 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.from_numpy(y).dtype
    np.testing.assert_array_equal(
        attacks.retarget_labels(torch.tensor([[0, 2, 1, 2]]), 2, 3).numpy(), [[0, 3, 1, 3]])


# ------------------------------------------------- the loss and its gradient


def _targets(y, targeted):
    if not targeted:
        return _flat(y), _jflat(y)
    yt = attacks.retarget_labels(torch.from_numpy(y), 2, 3)
    return train.one_hot_flatten(yt, 3), _jflat(yt.numpy())


@pytest.mark.parametrize("targeted", [False, True])
def test_attack_loss_and_input_gradient_match_jax(params, jparams, targeted):
    """The loss (the attack's own sigma clip [-1e4, 1e3]) and the gradient
    before the sign; the sign itself away from 0. With the targeted labels
    the rows of class 3 are all zero."""
    x, y = _batch()
    ty, jy = _targets(y, targeted)
    ac, jac = _ac(configs), _ac(jconfigs)
    got = attacks.attack_loss(params, torch.from_numpy(x), ty, CFG, ac)
    want = jattacks.attack_loss(jparams, jnp.asarray(x), jy, JCFG, jac)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)

    g = attacks.input_gradient(params, torch.from_numpy(x), ty, CFG, ac).numpy()
    jg = np.asarray(jax.grad(jattacks.attack_loss, argnums=1)(
        jparams, jnp.asarray(x), jy, JCFG, jac))
    scale = np.abs(jg).max()
    assert g.shape == x.shape and scale > 0
    assert np.abs(g - jg).max() <= GRAD_TOL * scale
    clear = np.abs(jg) > SIGN_FLOOR * scale
    assert clear.mean() > 0.5
    sign = attacks.fgsm_sign(params, torch.from_numpy(x), ty, CFG, ac).numpy()
    jsign = np.asarray(jattacks.fgsm_sign(jparams, jnp.asarray(x), jy, JCFG, jac))
    np.testing.assert_array_equal(sign[clear], jsign[clear])
    assert set(np.unique(sign)) <= {-1.0, 0.0, 1.0}
    assert (sign != jsign).mean() <= ADV_SHARE


def test_input_gradient_leaves_the_parameters_alone(params):
    """Parameters that require a gradient (a train state's) get none, the
    caller's input is not turned into a leaf, and the result is detached;
    it also works under ``no_grad``."""
    x, y = _batch()
    live = {k: {n: t.clone().requires_grad_() for n, t in ws.items()}
            for k, ws in params.items()}
    tx = torch.from_numpy(x)
    with torch.no_grad():
        g = attacks.input_gradient(live, tx, _flat(y), CFG, _ac(configs))
    assert not g.requires_grad and not tx.requires_grad
    assert all(t.grad is None for ws in live.values() for t in ws.values())
    want = attacks.input_gradient(params, tx, _flat(y), CFG, _ac(configs))
    assert torch.equal(g, want)


def test_forward_fn_selects_the_model(params):
    """``forward_fn`` reaches the loss, the sign, both attacks and the
    saliency map (the 3-D family will pass its own)."""
    calls = []

    def fwd(p, xx, cfg):
        calls.append(xx.shape)
        return attacks.forward(p, xx, cfg)

    x, y = _batch()
    tx, ty, ac = torch.from_numpy(x), _flat(y), _ac(configs, max_adv_step=2)
    attacks.attack_loss(params, tx, ty, CFG, ac, forward_fn=fwd)
    attacks.fgsm_sign(params, tx, ty, CFG, ac, forward_fn=fwd)
    attacks.make_fgsm_attack(CFG, ac, forward_fn=fwd)(params, tx, ty, -5.0, 5.0)
    attacks.make_pgd_attack(CFG, ac, forward_fn=fwd)(params, tx, ty, -5.0, 5.0)
    attacks.make_saliency_map(CFG, forward_fn=fwd)(params, tx, torch.ones(3))
    assert len(calls) == 1 + 1 + 1 + 2 + 1


# ----------------------------------------------------------------- attacks


def _attack_pair(kind, ac_kw):
    make, jmake = {
        "fgsm": (attacks.make_fgsm_attack, jattacks.make_fgsm_attack),
        "pgd": (attacks.make_pgd_attack, jattacks.make_pgd_attack),
    }[kind]
    return make(CFG, _ac(configs, **ac_kw)), jmake(JCFG, _ac(jconfigs, **ac_kw))


@pytest.mark.parametrize("kind,ac_kw", [
    ("fgsm", dict(epsilon=0.05, targeted=False)),
    ("pgd", dict(epsilon=0.01, step_size=0.5, max_adv_step=3)),
    ("pgd", dict(epsilon=0.02, step_size=0.005, max_adv_step=4)),
])
def test_attacks_stay_in_ball_and_range_raise_the_loss_and_match_jax(
        params, jparams, kind, ac_kw):
    x, y = _batch()
    tx, ty = torch.from_numpy(x), _flat(y)
    atk, jatk = _attack_pair(kind, ac_kw)
    ac = _ac(configs, **ac_kw)
    # a range inside the data's, so that the second clip acts
    lo, hi = float(np.quantile(x, 0.01)), float(np.quantile(x, 0.99))
    adv = atk(params, tx, ty, lo, hi)
    assert not adv.requires_grad and adv.shape == tx.shape
    inside = (tx >= lo) & (tx <= hi)
    eps32 = np.float32(ac.epsilon)
    assert float((adv - tx).abs()[inside].max()) <= float(eps32) + 1e-7
    assert float(adv.min()) >= np.float32(lo) and float(adv.max()) <= np.float32(hi)
    # the data range as tensors (what the runners pass) gives the same image
    again = atk(params, tx, ty, torch.tensor(lo), torch.tensor(hi))
    assert torch.equal(adv, again)

    full = atk(params, tx, ty, tx.min(), tx.max())
    assert float((full - tx).abs().max()) <= float(eps32) + 1e-7
    assert float((full - tx).abs().max()) > 0
    l0 = float(attacks.attack_loss(params, tx, ty, CFG, ac))
    l1 = float(attacks.attack_loss(params, full, ty, CFG, ac))
    assert l1 >= l0

    jadv = np.asarray(jatk(jparams, jnp.asarray(x), _jflat(y),
                           jnp.min(jnp.asarray(x)), jnp.max(jnp.asarray(x))))
    differ = np.abs(full.numpy() - jadv) > 1e-6
    assert differ.mean() <= ADV_SHARE, differ.mean()
    # the port's image through the JAX loss gives the port's loss
    jl1 = float(jattacks.attack_loss(jparams, jnp.asarray(full.numpy()), _jflat(y),
                                     JCFG, _ac(jconfigs, **ac_kw)))
    np.testing.assert_allclose(l1, jl1, rtol=LOSS_RTOL)


def test_saliency_matches_jax(params, jparams):
    """``(g, relu(g))`` of the foreground probability mass, and of one
    class."""
    x, _ = _batch(seed=3)
    for mask in ([0.0, 1.0, 1.0], [0.0, 0.0, 1.0]):
        g, gr = attacks.make_saliency_map(CFG)(
            params, torch.from_numpy(x), torch.tensor(mask))
        jg, jgr = jattacks.make_saliency_map(JCFG)(
            jparams, jnp.asarray(x), jnp.asarray(mask, jnp.float32))
        scale = np.abs(np.asarray(jg)).max()
        assert scale > 0 and not g.requires_grad
        assert np.abs(g.numpy() - np.asarray(jg)).max() <= GRAD_TOL * scale
        assert np.abs(gr.numpy() - np.asarray(jgr)).max() <= GRAD_TOL * scale
        assert torch.equal(gr, torch.relu(g))


@pytest.mark.parametrize("make", ["make_pgd_attack", "make_fgsm_attack", "make_saliency_map"])
def test_a_mesh_names_its_roadmap_item(make):
    args = (CFG,) if make == "make_saliency_map" else (CFG, _ac(configs))
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*'Parallelism'"):
        getattr(attacks, make)(*args, mesh=object())


# ------------------------------------------------------ adversarial training


def _adv_tc(mod, base, mode, **kw):
    kw = {"adv_epsilon": 0.05, "adv_steps": 3, "adv_step_size": 0.02, **kw}
    return dataclasses.replace(base, adversarial_training=mode, **kw)


@pytest.mark.parametrize("mode", ["fgsm", "pgd"])
def test_adversarial_examples_stay_in_ball(params, mode):
    x, y = _batch(b=4)
    tx = torch.from_numpy(x)
    adv = train.make_adversarial_examples(params, tx, _flat(y), CFG,
                                          _adv_tc(configs, TC, mode))
    d = (adv - tx).abs()
    assert not adv.requires_grad
    assert 0.0 < float(d.max()) <= 0.05 + 1e-6
    assert float(adv.max()) <= float(tx.max()) and float(adv.min()) >= float(tx.min())


@pytest.mark.parametrize("mode", ["fgsm", "pgd"])
def test_mixed_objective_matches_jax_given_the_same_examples(params, jparams, mode):
    """``adv_alpha * L(clean) + (1 - adv_alpha) * L(adv)`` on the JAX
    package's own adversarial examples: the value and every parameter
    gradient of ``supernet_tpu.train.value_and_grad_step``; the auxiliaries
    are the clean branch's. The port's own examples differ from JAX's on at
    most ADV_SHARE of the pixels."""
    x, y = _batch(b=4)
    tc, jtc = _adv_tc(configs, TC, mode, adv_alpha=0.3), _adv_tc(jconfigs, JTC, mode, adv_alpha=0.3)
    jx, jy = jnp.asarray(x), _jflat(y)
    (jloss, (jnll, _, jprobs, _)), jgrads = jtrain.value_and_grad_step(jparams, jx, jy, JCFG, jtc)
    jadv = np.array(jtrain.make_adversarial_examples(jparams, jx, jy, JCFG, jtc))

    live = {k: {n: t.clone().requires_grad_() for n, t in ws.items()}
            for k, ws in params.items()}
    tx, ty = torch.from_numpy(x), _flat(y)
    loss, (nll, _, probs, _) = train.mixed_loss(live, tx, torch.from_numpy(jadv), ty, CFG, tc)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(nll), float(jnll), rtol=LOSS_RTOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
    grads = torch.autograd.grad(loss, train.leaves(live))
    names = [(layer, name) for layer, ws in live.items() for name in ws]
    for g, (layer, name) in zip(grads, names):
        r = np.asarray(jgrads[layer][name])
        assert np.abs(g.numpy() - r).max() <= PARAM_GRAD_TOL * np.abs(r).max(), (layer, name)

    loss_c, (nll_c, _, probs_c, _) = train.loss_fn(live, tx, ty, CFG, tc)
    loss_a, _ = train.loss_fn(live, torch.from_numpy(jadv), ty, CFG, tc)
    assert float(loss.detach()) == pytest.approx(
        0.3 * float(loss_c.detach()) + 0.7 * float(loss_a.detach()), rel=1e-6)
    assert torch.equal(nll, nll_c) and torch.equal(probs, probs_c)

    own = train.make_adversarial_examples(live, tx, ty, CFG, tc).numpy()
    assert (np.abs(own - jadv) > 1e-6).mean() <= ADV_SHARE
    # training_loss makes its own examples and mixes the same way
    total, _ = train.training_loss(live, tx, ty, CFG, tc)
    own_loss, _ = train.mixed_loss(live, tx, torch.from_numpy(own), ty, CFG, tc)
    assert torch.equal(total, own_loss)


def test_adv_alpha_one_is_the_clean_gradient(params):
    x, y = _batch(b=4, seed=1)
    live = {k: {n: t.clone().requires_grad_() for n, t in ws.items()}
            for k, ws in params.items()}
    tx, ty = torch.from_numpy(x), _flat(y)
    tc = _adv_tc(configs, TC, "fgsm", adv_alpha=1.0)
    mixed, _ = train.training_loss(live, tx, ty, CFG, tc)
    clean, _ = train.training_loss(live, tx, ty, CFG, TC)
    g_clean = torch.autograd.grad(clean, train.leaves(live))
    for a, b in zip(torch.autograd.grad(mixed, train.leaves(live)), g_clean):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    half, _ = train.training_loss(live, tx, ty, CFG, _adv_tc(configs, TC, "fgsm", adv_alpha=0.5))
    g_half = torch.autograd.grad(half, train.leaves(live))
    assert max(float((a - b).abs().max()) for a, b in zip(g_half, g_clean)) > 0


@pytest.mark.parametrize("maker", ["single", "multi", "accum"])
def test_unknown_adversarial_mode_raises(params, maker):
    """As the reference does: a ``ValueError`` when the step runs."""
    tc = dataclasses.replace(TC, adversarial_training="bogus")
    x, y = _batch(b=2)
    state, _ = train.create_train_state(params, tc, "cpu")
    step, args = {
        "single": (train.make_train_step(CFG, tc), (x, y)),
        "multi": (train.make_multi_train_step(CFG, tc, 1), (x[None], y[None])),
        "accum": (train.make_accum_train_step(CFG, tc, 1), (x[None], y[None])),
    }[maker]
    with pytest.raises(ValueError, match="adversarial_training"):
        step(state, *args)


@pytest.mark.parametrize("mode", ["fgsm", "pgd"])
@pytest.mark.parametrize("maker", ["single", "multi", "accum"])
def test_adversarial_train_steps_train(params, maker, mode):
    """Every step maker takes the option: the step runs, the metrics are
    finite and those of the clean branch, the parameters move and differ
    from a standard step's."""
    tc = _adv_tc(configs, TC, mode, adv_steps=2)
    x, y = _batch(b=2, seed=2)
    outs = {}
    for name, cfg_tc in (("adv", tc), ("plain", TC)):
        state, _ = train.create_train_state(params, cfg_tc, "cpu")
        if maker == "single":
            state, m = train.make_train_step(CFG, cfg_tc)(state, x, y)
        elif maker == "multi":
            state, m = train.make_multi_train_step(CFG, cfg_tc, 2)(
                state, np.stack([x, x]), np.stack([y, y]))
        else:
            state, m = train.make_accum_train_step(CFG, cfg_tc, 2)(
                state, np.stack([x[:1], x[1:]]), np.stack([y[:1], y[1:]]))
        outs[name] = (state, m)
    (s_adv, m_adv), (s_plain, m_plain) = outs["adv"], outs["plain"]
    assert s_adv.step == s_plain.step == (2 if maker == "multi" else 1)
    assert all(bool(torch.isfinite(v).all()) for v in m_adv)
    first = (lambda v: v.reshape(-1)[0])
    # clean-branch metrics: nll, kl and accuracy of the first step are the
    # standard step's; the loss is not
    for field in ("nll", "kl", "accuracy"):
        np.testing.assert_allclose(float(first(getattr(m_adv, field))),
                                   float(first(getattr(m_plain, field))), rtol=1e-6)
    assert float(first(m_adv.loss)) != float(first(m_plain.loss))
    moved = [not torch.equal(a, b) for a, b in
             zip(train.leaves(s_adv.params), train.leaves(params))]
    assert all(moved)
    assert any(not torch.equal(a, b) for a, b in
               zip(train.leaves(s_adv.params), train.leaves(s_plain.params)))


def test_adversarial_train_step_matches_jax(params, jparams):
    """Three FGSM-trained steps from the same parameters and batches: the
    mixed loss and the clean metrics of every step (rtol 1e-4: the examples
    differ on a few pixels), the parameters within 2 * lr * steps."""
    tc = _adv_tc(configs, TC, "fgsm", adv_epsilon=0.01)
    jtc = _adv_tc(jconfigs, JTC, "fgsm", adv_epsilon=0.01)
    state, _ = train.create_train_state(params, tc, "cpu")
    jstate, _ = jtrain.create_train_state(jparams, jtc)
    step, jstep = train.make_train_step(CFG, tc), jtrain.make_train_step(JCFG, jtc)
    for i in range(3):
        x, y = _batch(b=4, seed=10 + i)
        state, m = step(state, x, y)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose([float(v) for v in m], [float(v) for v in jm], rtol=1e-4)
    for layer, ws in state.params.items():
        for name, t in ws.items():
            d = np.abs(t.detach().numpy() - np.asarray(jstate.params[layer][name])).max()
            assert d <= 2 * tc.lr * 3, (layer, name)
