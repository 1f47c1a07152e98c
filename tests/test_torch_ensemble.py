"""Deep ensembles in the port (supernet_tpu_torch/{train,ensemble,serving,
evaluate,cli}.py and the member axis of ops/kernels) on the CPU against the
JAX package: the member-axis plain versions of kernels 1 and 4 against
``jax.vmap`` of the Pallas functions in interpret mode, the ensemble train
and eval steps against JAX's from the same stacked npz parameters, the
vmapped step against the port's own single-model step per member with
augmentation on, the per-member clip, ``choose_ensemble_mode``, the epoch
trainer and the CLI."""

import dataclasses
import importlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu import ensemble as jensemble  # noqa: E402
from supernet_tpu import serving as jserving  # noqa: E402
from supernet_tpu import train as jtrain  # noqa: E402
from supernet_tpu.checkpoint import save_params_npz as jsave  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu.ops import moments as jmoments  # noqa: E402
from supernet_tpu.ops.pallas import sigma_bwd as jsigma_bwd  # noqa: E402
from supernet_tpu_torch import checkpoint as ckpt  # noqa: E402
from supernet_tpu_torch import cli, configs, ensemble, evaluate, serving, train  # noqa: E402
from supernet_tpu_torch.checkpoint import load_params_npz  # noqa: E402
from supernet_tpu_torch.data import PickleDataset, synthetic_dataset  # noqa: E402
from supernet_tpu_torch.models import forward  # noqa: E402
from supernet_tpu_torch.ops.kernels import sigma_bwd, vdp_conv  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the module, not the function the package re-exports under the same name
jvdp_module = importlib.import_module("supernet_tpu.ops.pallas.vdp_conv")

CFG = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                          base_kernels=4)
JCFG = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                           base_kernels=4)
TC = configs.HIPPOCAMPUS.train
JTC = jconfigs.HIPPOCAMPUS.train
EXP = configs.HIPPOCAMPUS.replace(
    model=CFG, train=dataclasses.replace(TC, batch_size=4, epochs=2, log_every=100))
K, BATCH, STEPS = 2, 3, 2
GOLDEN_ATOL = 2e-5  # the golden tolerance (tests/test_torch_model.py)
LOSS_RTOL = 1e-5  # a step's loss and metrics, as tests/test_torch_train.py holds them


def _quiet(*_):
    pass


def _sum_leaves(tree):
    return [t for ws in tree.values() for t in ws.values()]


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """K npz parameter files that both packages start from."""
    root = tmp_path_factory.mktemp("members")
    paths = []
    for k in range(K):
        path = str(root / f"m{k}.npz")
        jsave(path, jinit(jax.random.PRNGKey(k), JCFG))
        paths.append(path)
    return paths


def _data(steps, k, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (steps, k, b, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 3, (steps, k, b, 22, 22)).astype(np.int32)
    return x, y


# ------------------------------------------------- kernels with a member axis


def _conv_members(cin, cout, h, has_sigma, seed=0, k_members=K, b=2):
    rng = np.random.default_rng(seed)

    def t(*s):
        return rng.normal(0, 1, s).astype(np.float32)

    mu = t(k_members, b, h, h, cin)
    sigma = np.abs(t(k_members, b, h, h, cin)) if has_sigma else None
    return mu, sigma, 0.3 * t(k_members, 3, 3, cin, cout), t(k_members, cout) - 5.0


@pytest.mark.parametrize("cin,fuse,has_sigma,shared", [
    (8, True, True, False),   # the probe's case: B=2, 10x10, Cin 8, Cout 16
    (8, False, True, False),
    (8, True, True, True),    # one batch for every member: in_axes None
    (4, True, False, True),   # conv_input of the serving and eval paths
])
def test_member_axis_vdp_conv_plain_matches_vmapped_pallas(cin, fuse, has_sigma, shared):
    """Kernel 1 with the window sum: ``vdp_conv`` on [K,B,...] inputs (a
    stride-0 view for the shared batch) and stacked weights against
    ``jax.vmap`` of the Pallas ``_pallas_forward`` in interpret mode."""
    mu, sigma, w_mu, w_sigma = _conv_members(cin, 16, 10, has_sigma)
    if shared:
        mu = mu[0]
        sigma = None if sigma is None else sigma[0]
    axes = (None if shared else 0, None if shared or sigma is None else 0, 0, 0)

    def one(m, s, w, ws):
        return jvdp_module._pallas_forward(m, s, w, ws, fuse_relu=fuse,
                                           precision="highest", interpret=True)

    want = jax.vmap(one, in_axes=axes)(*(None if a is None else jnp.asarray(a)
                                         for a in (mu, sigma, w_mu, w_sigma)))
    tm = torch.from_numpy(mu)
    ts = None if sigma is None else torch.from_numpy(sigma)
    if shared:
        tm = tm.expand(K, *tm.shape)
        ts = None if ts is None else ts.expand(K, *ts.shape)
    got = vdp_conv.vdp_conv(tm, ts, torch.from_numpy(w_mu), torch.from_numpy(w_sigma),
                            fuse_relu=fuse)
    assert vdp_conv.launches == 0  # CPU tensors never reach the kernel
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == (w.shape[0] * w.shape[1],) + w.shape[2:]
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), atol=GOLDEN_ATOL)


@pytest.mark.parametrize("has_sigma", [True, False])
def test_member_axis_transposed_pair_matches_vmapped_vjp(has_sigma):
    """Kernel 1 without the window sum, as ``VDPConv.backward`` runs its two
    transposed convolutions (``conv_t_pair``, the padded and flipped form of
    ``conv_t_pair_plain``), against ``jax.vmap`` over the members of
    ``jax.vjp`` of the JAX package's VALID convolution."""
    rng = np.random.default_rng(3)
    g1, g2 = (rng.normal(0, 1, (K, 2, 8, 8, 16)).astype(np.float32) for _ in range(2))
    w = (0.3 * rng.normal(0, 1, (K, 3, 3, 8, 16))).astype(np.float32)

    def one(g1k, g2k, wk):
        x = jnp.zeros((2, 10, 10, 8), jnp.float32)
        _, v1 = jax.vjp(lambda a: jmoments._conv_valid(a, wk), x)
        _, v2 = jax.vjp(lambda a: jmoments._conv_valid(a, jnp.square(wk)), x)
        return v1(g1k)[0], v2(g2k)[0]

    want1, want2 = jax.vmap(one)(*(jnp.asarray(a) for a in (g1, g2, w)))
    t1, t2 = (torch.from_numpy(a).flatten(0, 1) for a in (g1, g2))
    for fn in (vdp_conv.conv_t_pair_plain, vdp_conv.conv_t_pair):
        d1, d2 = fn(t1, t2 if has_sigma else None, torch.from_numpy(w))
        assert d1.shape == (K * 2, 10, 10, 8)
        np.testing.assert_allclose(d1.numpy(), np.asarray(want1).reshape(d1.shape),
                                   atol=GOLDEN_ATOL)
        if has_sigma:
            np.testing.assert_allclose(d2.numpy(), np.asarray(want2).reshape(d2.shape),
                                       atol=GOLDEN_ATOL)
        else:
            assert d2 is None


@pytest.mark.parametrize("c", [16, 6])
def test_member_axis_sigma_bwd_plain_matches_vmapped_pallas(c):
    """Kernel 4 with ``s_w`` [K, C]: ``u`` [K*B, ...] and ``dsw`` [K, C]
    against ``jax.vmap`` of the Pallas ``_bwd_call`` in interpret mode; no
    member's ``dsw`` takes another's pixels."""
    rng = np.random.default_rng(1)
    g = rng.normal(0, 1, (K, 2, 8, 8, c)).astype(np.float32)
    t = rng.normal(0, 1, (K, 2, 8, 8)).astype(np.float32)
    s_w = rng.uniform(0.01, 0.2, (K, c)).astype(np.float32)
    want_u, want_dsw = jax.vmap(lambda a, b, s: jsigma_bwd._bwd_call(a, b, s, 3, interpret=True))(
        *(jnp.asarray(a) for a in (g, t, s_w)))
    u, dsw = sigma_bwd.winsum_spread_bwd(torch.from_numpy(g).flatten(0, 1),
                                         torch.from_numpy(t).flatten(0, 1),
                                         torch.from_numpy(s_w), 3)
    assert sigma_bwd.launches == 0
    assert u.shape == (K * 2, 10, 10) and dsw.shape == (K, c)
    np.testing.assert_allclose(u.numpy(), np.asarray(want_u).reshape(u.shape), atol=GOLDEN_ATOL)
    np.testing.assert_allclose(dsw.numpy(), np.asarray(want_dsw), rtol=1e-5, atol=GOLDEN_ATOL)


@pytest.mark.parametrize("shared", [False, True])
def test_member_axis_backward_matches_vmapped_pallas_vjp(shared):
    """``VDPConv``'s backward with stacked weights (kernel 4, the transposed
    pair, the filter gradients per member) against ``jax.vmap`` of
    ``jax.vjp`` of the Pallas ``vdp_conv`` in interpret mode; a shared
    input's gradient is the sum over the members."""
    mu, sigma, w_mu, w_sigma = _conv_members(8, 16, 10, True, seed=2)
    rng = np.random.default_rng(4)
    g1, g2 = (rng.normal(0, 1, (K, 2, 8, 8, 16)).astype(np.float32) for _ in range(2))
    if shared:
        mu, sigma = mu[0], sigma[0]
    axes = (None, None, 0, 0, 0, 0) if shared else (0, 0, 0, 0, 0, 0)

    def one(m, s, w, ws, c1, c2):
        _, vjp = jax.vjp(lambda *a: jvdp_module.vdp_conv(*a, fuse_relu=True, interpret=True),
                         m, s, w, ws)
        return vjp((c1, c2))

    want = jax.vmap(one, in_axes=axes)(*(jnp.asarray(a) for a in
                                         (mu, sigma, w_mu, w_sigma, g1, g2)))
    if shared:  # vmap gives each member's input gradient; the input is one
        want = tuple(np.asarray(w).sum(0) if i < 2 else w for i, w in enumerate(want))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (mu, sigma, w_mu, w_sigma)]
    tm, ts = leaves[:2]
    if shared:
        tm, ts = tm.expand(K, *tm.shape), ts.expand(K, *ts.shape)
    m, s = vdp_conv.VDPConv.apply(tm, ts, leaves[2], leaves[3], True)
    torch.autograd.backward((m, s), (torch.from_numpy(g1).flatten(0, 1),
                                     torch.from_numpy(g2).flatten(0, 1)))
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w.reshape(leaf.shape),
                                   atol=1e-4 * max(1.0, np.abs(w).max()))


# ------------------------------------------------------- trees and the clip


def test_stack_and_index_trees_round_trip(members):
    """Parameters, Adam moments and step counters survive stack_trees and
    index_tree; members that took different steps are refused."""
    states = [train.create_train_state(load_params_npz(p, "cpu"), TC, "cpu")[0]
              for p in members]
    step = train.make_train_step(CFG, TC)
    x, y = _data(1, K, BATCH)
    for k, s in enumerate(states):
        step(s, x[0][k], y[0][k])
    stacked = train.stack_trees(states)
    assert stacked.step == 1 and train.n_members(stacked.params) == K
    want = [ckpt.snapshot_state(s) for s in states]
    for k in range(K):
        got = ckpt.snapshot_state(train.index_tree(stacked, k))
        assert got["step"] == 1 and got["adam_step"] == 1.0
        for kind in ("params", "exp_avg", "exp_avg_sq"):
            for a, b in zip(_sum_leaves(got[kind]), _sum_leaves(want[k][kind])):
                assert torch.equal(a, b)
        for a, b in zip(_sum_leaves(train.index_tree(stacked.params, k)),
                        _sum_leaves(states[k].params)):
            assert torch.equal(a, b)
    fresh = train.create_train_state(load_params_npz(members[0], "cpu"), TC, "cpu")[0]
    with pytest.raises(ValueError, match="different steps"):
        train.stack_trees([states[0], fresh])
    jstacked = jtrain.stack_trees([jinit(jax.random.PRNGKey(k), JCFG) for k in range(K)])
    tstacked = train.stack_trees([jinit(jax.random.PRNGKey(k), JCFG) for k in range(K)])
    for layer, ws in tstacked.items():
        for name, t in ws.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jstacked[layer][name]))


def test_per_member_clip():
    """One member's gradients exceed clipnorm, the other's do not: the
    first is clipped by its own norm, the second steps exactly as it would
    alone. Clipping the stacked tensor as one would scale both."""
    rng = np.random.default_rng(0)
    big = torch.from_numpy(rng.normal(0, 3, (5, 7)).astype(np.float32))
    small = torch.from_numpy(rng.normal(0, 0.01, (5, 7)).astype(np.float32))
    g = torch.stack([big, small])
    train.clip_by_per_member_norm([g], TC.clipnorm)
    alone = big.clone()
    train.clip_by_per_tensor_norm([alone], TC.clipnorm)
    torch.testing.assert_close(g[0], alone, rtol=1e-6, atol=0)
    assert torch.equal(g[1], small)
    joint = torch.stack([big, small])
    train.clip_by_per_tensor_norm([joint], TC.clipnorm)
    assert not torch.equal(joint[1], small)  # the trap this test guards

    # through the optimizer: the unclipped member's Adam step is its own
    w = torch.zeros((K, 5, 7), requires_grad=True)
    w_alone = torch.zeros((5, 7), requires_grad=True)
    opt = torch.optim.Adam([w], lr=TC.lr, eps=TC.adam_eps)
    opt_alone = torch.optim.Adam([w_alone], lr=TC.lr, eps=TC.adam_eps)
    w.grad, w_alone.grad = torch.stack([big, small]), small.clone()
    train.clip_by_per_member_norm([w.grad], TC.clipnorm)
    train.clip_by_per_tensor_norm([w_alone.grad], TC.clipnorm)
    opt.step()
    opt_alone.step()
    assert torch.equal(w[1].detach(), w_alone.detach())


# ------------------------------------------------------ steps against JAX


@pytest.fixture(scope="module")
def jax_run(members):
    """JAX's vmapped ensemble step, STEPS steps from the stacked npz
    parameters (augmentation off), and its eval step on one shared batch."""
    from supernet_tpu.checkpoint import load_params_npz as jload

    x, y = _data(STEPS, K, BATCH)
    jstate = jtrain.stack_trees([jtrain.create_train_state(jload(p), JTC)[0]
                                 for p in members])
    jstep = jtrain.make_ensemble_train_step(JCFG, JTC, with_pred=True, member_mode="vmap")
    seeds = jnp.arange(K, dtype=jnp.int32) + JTC.seed
    metrics = []
    for i in range(STEPS):
        jstate, jm, jpred = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]), seeds)
        metrics.append(([np.asarray(v) for v in jm], np.asarray(jpred)))
    jeval = jtrain.make_ensemble_eval_step(JCFG, JTC)
    ev = [np.asarray(v) for v in jeval(jstate.params, jnp.asarray(x[0][0]),
                                         jnp.asarray(y[0][0]))]
    return metrics, jax.device_get(jstate.params), ev


@pytest.mark.parametrize("mode", ["vmap", "unroll", "scan"])
def test_ensemble_train_step_matches_jax(members, jax_run, mode):
    """Per-member loss, nll, kl and accuracy of every step within LOSS_RTOL,
    predictions, and the parameters after the steps within 2 * lr * steps."""
    want_metrics, want_params, _ = jax_run
    x, y = _data(STEPS, K, BATCH)
    state = train.stack_trees([train.create_train_state(load_params_npz(p, "cpu"), TC,
                                                        "cpu")[0] for p in members])
    step = train.make_ensemble_train_step(CFG, TC, with_pred=True, member_mode=mode)
    for i in range(STEPS):
        state, m, pred = step(state, x[i], y[i], np.arange(K) + TC.seed)
        (jm, jpred) = want_metrics[i]
        for got, want in zip(m, jm):
            assert got.shape == (K,)
            np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)
        assert pred.shape == (K, BATCH, 22 * 22)
        assert (pred.numpy() != jpred).mean() < 1e-3
    assert state.step == STEPS
    for layer, ws in state.params.items():
        for name, t in ws.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(want_params[layer][name]),
                                       atol=2 * TC.lr * STEPS)


def test_ensemble_eval_step_matches_jax(members, jax_run):
    """Per-member (probs, sigma, pred, loss, acc) on one shared batch."""
    from supernet_tpu.checkpoint import load_params_npz as jload

    _, want_params, _ = jax_run
    x, y = _data(1, K, BATCH)
    params = train.stack_trees([load_params_npz(p, "cpu") for p in members])
    got = train.make_ensemble_eval_step(CFG, TC)(params, x[0][0], y[0][0])
    jstacked = jtrain.stack_trees([jload(p) for p in members])
    want = jtrain.make_ensemble_eval_step(JCFG, JTC)(jstacked, jnp.asarray(x[0][0]),
                                                      jnp.asarray(y[0][0]))
    probs, sigma, pred, loss, acc = got
    assert probs.shape == (K, BATCH, 22 * 22, 3) and loss.shape == (K,)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want[0]), atol=GOLDEN_ATOL)
    s = np.asarray(want[1])
    np.testing.assert_allclose(sigma.numpy(), s, atol=GOLDEN_ATOL * np.abs(s).max())
    assert (pred.numpy() != np.asarray(want[2])).mean() < 1e-3
    np.testing.assert_allclose(loss.numpy(), np.asarray(want[3]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want[4]), rtol=LOSS_RTOL)


def test_vmap_step_matches_single_steps_with_augment(members):
    """With augmentation on, member k of the vmapped step equals the port's
    single-model step with ``tc.seed + k`` on member k's parameters and
    batch (the random streams differ from JAX's, so this is where
    augmentation is held)."""
    tc = dataclasses.replace(TC, augment=configs.AugmentConfig(rot90=True,
                                                               intensity_scale=0.1))
    x, y = _data(STEPS, K, BATCH, seed=5)
    state = train.stack_trees([train.create_train_state(load_params_npz(p, "cpu"), tc,
                                                        "cpu")[0] for p in members])
    step = train.make_ensemble_train_step(CFG, tc, member_mode="vmap")
    losses = []
    for i in range(STEPS):
        state, m = step(state, x[i], y[i], np.arange(K) + tc.seed)
        losses.append(m.loss.numpy())
    for k, path in enumerate(members):
        tck = dataclasses.replace(tc, seed=tc.seed + k)
        single = train.create_train_state(load_params_npz(path, "cpu"), tck, "cpu")[0]
        one = train.make_train_step(CFG, tck)
        for i in range(STEPS):
            single, m = one(single, x[i][k], y[i][k])
            np.testing.assert_allclose(losses[i][k], float(m.loss), rtol=LOSS_RTOL)
        for a, b in zip(train.leaves(train.index_tree(state.params, k)),
                        train.leaves(single.params)):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       atol=2 * tc.lr * STEPS)


@pytest.mark.parametrize("combo", ["remat", "fgsm", "pgd", "bf16", "glue_fold"])
def test_vmap_step_matches_single_steps_per_member(members, combo):
    """The vmapped step equals the port's single-model step of every member
    (loss per step within LOSS_RTOL, parameters within 2 * lr * steps)
    under each combination ROADMAP.md's Queue 3 checked by hand: blocks
    rematerialised, FGSM and PGD adversarial training, bf16 activations and
    the decoder glue fold."""
    from supernet_tpu_torch import ops

    cfg, tc = CFG, TC
    if combo == "remat":
        cfg = dataclasses.replace(CFG, remat=True)
    elif combo in ("fgsm", "pgd"):
        tc = dataclasses.replace(TC, adversarial_training=combo, adv_steps=2)
    x, y = _data(STEPS, K, BATCH, seed=6)
    knobs = {"glue_fold": "fold"} if combo == "glue_fold" else {}
    if combo == "bf16":
        ops.set_act_dtype("bfloat16")
    try:
        with ops.moments.lowering(**knobs):
            state = train.stack_trees([train.create_train_state(
                load_params_npz(p, "cpu"), tc, "cpu")[0] for p in members])
            step = train.make_ensemble_train_step(cfg, tc, member_mode="vmap")
            losses = []
            for i in range(STEPS):
                state, m = step(state, x[i], y[i], np.arange(K) + tc.seed)
                losses.append(m.loss.numpy())
            for k, path in enumerate(members):
                tck = dataclasses.replace(tc, seed=tc.seed + k)
                single = train.create_train_state(load_params_npz(path, "cpu"), tck, "cpu")[0]
                one = train.make_train_step(cfg, tck)
                for i in range(STEPS):
                    single, m = one(single, x[i][k], y[i][k])
                    np.testing.assert_allclose(losses[i][k], float(m.loss), rtol=LOSS_RTOL)
                for a, b in zip(train.leaves(train.index_tree(state.params, k)),
                                train.leaves(single.params)):
                    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                               atol=2 * tc.lr * STEPS)
    finally:
        ops.set_act_dtype("float32")


def test_member_mode_and_mesh_are_checked():
    with pytest.raises(ValueError, match="member_mode"):
        train.make_ensemble_train_step(CFG, TC, member_mode="pmap")
    with pytest.raises(NotImplementedError, match="ROADMAP.*'Parallelism'"):
        train.make_ensemble_train_step(CFG, TC, mesh=object())


# ------------------------------------------------- serving and the mixture


def test_vmapped_session_matches_jax_and_the_member_loop(members):
    """The member-stacked EnsembleSession against JAX's vmapped session and
    against the mixture of the members' own forwards (serving.mixture)."""
    from supernet_tpu.checkpoint import load_params_npz as jload

    x = np.random.default_rng(7).normal(0, 1, (5, 32, 32, 1)).astype(np.float32)
    sess = serving.EnsembleSession([load_params_npz(p, "cpu") for p in members], CFG,
                                   batch_size=2, device="cpu")
    got_p, got_s = sess.predict(x)
    jsess = jserving.EnsembleSession([jload(p) for p in members], JCFG, batch_size=2)
    want_p, want_s = jsess.predict(x)
    np.testing.assert_allclose(got_p, np.asarray(want_p), atol=GOLDEN_ATOL)
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=2e-7)
    with torch.no_grad():
        outs = [forward(load_params_npz(p, "cpu"), torch.from_numpy(x), CFG) for p in members]
    loop_p, loop_s = serving.mixture([p for p, _ in outs], [s for _, s in outs])
    np.testing.assert_allclose(got_p.reshape(5, -1, 3), loop_p.numpy(), atol=1e-7)
    np.testing.assert_allclose(got_s.reshape(5, -1, 3), loop_s.numpy(), atol=1e-7)
    # the eval runners' mixture is the same one, and keeps its stack
    fwd, params = evaluate.eval_forward_and_params(CFG, [load_params_npz(p, "cpu")
                                                         for p in members], "cpu")
    p1, s1 = fwd(params, torch.from_numpy(x))
    np.testing.assert_allclose(p1.numpy(), loop_p.numpy(), atol=1e-7)
    np.testing.assert_allclose(s1.numpy(), loop_s.numpy(), atol=1e-7)


# ------------------------------------------------------ choose_ensemble_mode


@pytest.mark.parametrize("k_members", [2, 4, 8])
@pytest.mark.parametrize("total_steps", [None, 1, 300, 100000])
def test_choose_ensemble_mode_matches_jax(k_members, total_steps, monkeypatch):
    """The JAX rule over a grid of (K, total_steps, c, t, r) passed
    explicitly: the same decision and reason, the port naming its
    one-program mode where JAX names 'unroll'; the environment override."""
    monkeypatch.delenv("SUPERNET_ENSEMBLE_MODE", raising=False)
    for c in (0.0, 0.4, 35.0):
        for t in (0.01, 0.03):
            for r in (0.8, 1.0, 1.05, 1.5):
                got = ensemble.choose_ensemble_mode(k_members, total_steps, compile_s=c,
                                                    step_s=t, step_ratio=r)
                want = jensemble.choose_ensemble_mode(k_members, total_steps, compile_s=c,
                                                      step_s=t, step_ratio=r)
                assert got[1] == want[1]
                assert got[0] == (ensemble.ONE_PROGRAM_MODE if want[0] == "unroll"
                                  else want[0])
    monkeypatch.setenv("SUPERNET_ENSEMBLE_MODE", "unroll")
    assert ensemble.choose_ensemble_mode(k_members, total_steps) == \
        jensemble.choose_ensemble_mode(k_members, total_steps)
    assert ensemble.choose_ensemble_mode(k_members, total_steps, mesh=object()) == (
        "unroll", "SUPERNET_ENSEMBLE_MODE=unroll")
    monkeypatch.delenv("SUPERNET_ENSEMBLE_MODE")
    assert ensemble.choose_ensemble_mode(k_members, 10, mesh=object())[0] == "vmap"


# ------------------------------------------------------------- the trainer


def _ds(n=8, seed=0):
    x, y = synthetic_dataset(CFG, n, seed=seed)
    return PickleDataset(x, y, 1)


def test_trainer_matches_sequential_runs(tmp_path):
    """Member k of EnsembleTrainer (vmap) against a ``Trainer`` seeded
    ``seed + k``: the same init, shuffle and curves."""
    from supernet_tpu_torch.trainer import Trainer

    ens = ensemble.EnsembleTrainer(EXP, K, _ds(), None, out_dir=str(tmp_path / "e"),
                                   track_curves=False, member_mode="vmap", device="cpu")
    state = ens.run(epochs=2, log=_quiet)
    for k in range(K):
        exp_k = EXP.replace(train=dataclasses.replace(EXP.train, seed=EXP.train.seed + k))
        tr = Trainer(exp_k, _ds(), None, out_dir=str(tmp_path / f"s{k}"),
                     track_curves=False, device="cpu")
        single = tr.run(epochs=2, log=_quiet)
        np.testing.assert_allclose(ens.histories[k]["train_loss"], tr.history["train_loss"],
                                   rtol=1e-5)
        for a, b in zip(train.leaves(train.index_tree(state.params, k)),
                        train.leaves(single.params)):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       atol=2 * TC.lr * 4)


def test_trainer_checkpoints_and_resume(tmp_path):
    """member_{k}/epoch_{N} checkpoints, history, hyperparameters;
    continue_training resumes from the newest epoch every member has, bit
    for bit; a mixed resume, one member, and a mesh are refused."""
    base = str(tmp_path / "ens")
    kw = dict(out_dir=base, track_curves=False, device="cpu")
    full = ensemble.EnsembleTrainer(EXP, K, _ds(), _ds(4, seed=1), **kw)
    want = full.run(epochs=2, log=_quiet)
    for k in range(K):
        d = os.path.join(base, f"member_{k}")
        assert ckpt.latest_epoch(d) == 1
        assert {"history.pkl", "Related_hyperparameters.txt", "epoch_0",
                "epoch_1"} <= set(os.listdir(d))
        with open(os.path.join(d, "Related_hyperparameters.txt")) as f:
            text = f.read()
        assert f"ensemble_member : {k}" in text and f"ensemble_size : {K}" in text
        assert len(full.histories[k]["val_dice"]) == 2
        assert ckpt.restore_state(d, 1, TC, "cpu").step == 4

    cut = str(tmp_path / "cut")
    for k in range(K):
        os.makedirs(os.path.join(cut, f"member_{k}"))
        os.rename(os.path.join(base, f"member_{k}", "epoch_0"),
                  os.path.join(cut, f"member_{k}", "epoch_0"))
    resume = EXP.replace(train=dataclasses.replace(EXP.train, continue_training=True))
    ens2 = ensemble.EnsembleTrainer(resume, K, _ds(), _ds(4, seed=1), out_dir=cut,
                                    track_curves=False, device="cpu")
    got = ens2.run(epochs=2, log=_quiet)
    assert ens2.start_epoch == 1
    for a, b in zip(train.leaves(got.params), train.leaves(want.params)):
        assert torch.equal(a, b)

    import shutil

    shutil.rmtree(os.path.join(cut, "member_1", "epoch_1"))
    shutil.rmtree(os.path.join(cut, "member_1", "epoch_0"))
    with pytest.raises(FileNotFoundError, match="mixed resume"):
        ensemble.EnsembleTrainer(resume, K, _ds(), None, out_dir=cut, device="cpu").run(
            epochs=3, log=_quiet)
    with pytest.raises(ValueError, match="n_members >= 2"):
        ensemble.EnsembleTrainer(EXP, 1, _ds(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*'Parallelism'"):
        ensemble.EnsembleTrainer(EXP, 2, _ds(), mesh=object(), device="cpu")


# --------------------------------------------------------------------- CLI

# the keys of supernet_tpu/cli.py's `train --ensemble K` JSON line
CLI_KEYS = {"members", "mode", "dirs", "checkpoint_arg", "final"}


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(configs._CONFIGS, "hippocampus", EXP)
    return EXP


@pytest.mark.parametrize("mode", ["vmap", "unroll", "scan", "sequential", "auto"])
def test_cli_train_ensemble(tiny, tmp_path, capsys, mode):
    """``train --ensemble 2 --ensemble-mode MODE`` writes member_0/ and
    member_1/ with epoch_0 and prints the JAX CLI's keys; its dirs are what
    ``eval --checkpoint a,b`` reads."""
    out = str(tmp_path / "ens")
    assert cli.main(["train", "--synthetic", "8", "--batch-size", "4", "--epochs", "1",
                     "--ensemble", "2", "--ensemble-mode", mode, "--device", "cpu",
                     "--out-dir", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == CLI_KEYS and line["members"] == 2
    assert line["mode"] == (ensemble.ONE_PROGRAM_MODE if mode == "auto" else mode)
    assert line["dirs"] == [f"{out}/member_0", f"{out}/member_1"]
    assert line["checkpoint_arg"] == ",".join(line["dirs"])
    for d, final in zip(line["dirs"], line["final"]):
        assert ckpt.latest_epoch(d) == 0 and np.isfinite(final["train_loss"])
        assert {"history.pkl", "Related_hyperparameters.txt"} <= set(os.listdir(d))
    if mode == "vmap":
        assert cli.main(["eval", "--synthetic", "4", "--checkpoint", line["checkpoint_arg"],
                         "--device", "cpu", "--out-dir", str(tmp_path / "ev")]) == 0
        assert np.isfinite(json.loads(capsys.readouterr().out.strip().splitlines()[-1])
                           ["accuracy"])


def test_cli_ensemble_with_a_mesh_names_parallelism(tiny, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.*'Parallelism'"):
        cli.main(["train", "--synthetic", "8", "--ensemble", "2", "--data-parallel",
                  "--device", "cpu", "--out-dir", str(tmp_path)])
