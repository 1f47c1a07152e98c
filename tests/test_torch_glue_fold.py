"""The decoder glue fold of the port (``ops.moments.vglue_conv_relu``,
``ops.moments3d.vglue_conv3d_relu`` and their dispatch in ``models/unet.py``
and ``models/unet3d.py``) on the CPU, mirroring ``tests/test_glue_fold.py``:
the fold against the explicit pad -> [crop-concat ->] conv -> relu
choreography and against the JAX package's fold on the same numpy inputs,
for the op and for the whole model, forward and gradients.

Tolerances: the fold against the explicit form within the JAX test's
numbers (``tests/test_glue_fold.py:147-158``): rtol 3e-5 / atol 3e-6 on the
forward (2e-5 / 2e-6 for the op alone), rtol 2e-4 / atol 2e-5 on gradients.
The port against JAX within ``ATOL`` on outputs and ``GRAD_RTOL`` of each
gradient's max magnitude, as ``tests/test_torch_ops.py`` and
``tests/test_torch_unet3d.py`` hold the default lowering."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import supernet_tpu.configs as jconfigs  # noqa: E402
from supernet_tpu.models import forward as jforward  # noqa: E402
from supernet_tpu.models import forward3d as jforward3d  # noqa: E402
from supernet_tpu.models import init_params as jinit  # noqa: E402
from supernet_tpu.models import init_params3d as jinit3d  # noqa: E402
from supernet_tpu.ops import moments as jm  # noqa: E402
from supernet_tpu.ops import moments3d as jm3  # noqa: E402
from supernet_tpu_torch import configs, flops  # noqa: E402
from supernet_tpu_torch.checkpoint import params_from_jax  # noqa: E402
from supernet_tpu_torch.models import forward, forward3d  # noqa: E402
from supernet_tpu_torch.ops import moments as tm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5
GRAD_RTOL = 1e-4


def _rand_pair(rng, shape):
    return (rng.normal(0, 1, shape).astype(np.float32),
            rng.uniform(1e-4, 0.3, shape).astype(np.float32))


def _explicit(mu, sigma, w_mu, w_sigma, pad, fill, enc=None):
    m, s = tm.vpad(mu, sigma, pad, fill)
    if enc is not None:
        m, s = tm.vcrop_concat(m, s, enc[0], enc[1])
    return tm.vrelu(*tm.vconv(m, s, w_mu, w_sigma))


def _op_case(pad, with_enc, seed=0):
    rng = np.random.default_rng(seed)
    c_d = 6
    mu, sigma = _rand_pair(rng, (2, 10, 10, c_d))
    enc = _rand_pair(rng, (2, 21, 21, c_d)) if with_enc else None
    c_in = 2 * c_d if with_enc else c_d
    w_mu = (0.1 * rng.normal(0, 1, (3, 3, c_in, 5))).astype(np.float32)
    w_sigma = rng.uniform(-6.0, -4.0, 5).astype(np.float32)
    return mu, sigma, w_mu, w_sigma, enc


OP_CASES = [((3, 3), 0.02, True), ((2, 2), 0.1, False), ((1, 0), 0.1, False)]


@pytest.mark.parametrize("winsum", ["shift", "conv"])
@pytest.mark.parametrize("pad,fill,with_enc", OP_CASES)
def test_op_equality(pad, fill, with_enc, winsum):
    """The fold equals the explicit choreography (the JAX test's op
    tolerance) and the JAX package's fold under each of its window-sum
    lowerings; the skip crop (21 -> 16) has an odd difference, so it is one
    pixel wider at the high end."""
    mu, sigma, w_mu, w_sigma, enc = _op_case(pad, with_enc)
    t = [torch.from_numpy(a) for a in (mu, sigma, w_mu, w_sigma)]
    te = None if enc is None else [torch.from_numpy(a) for a in enc]
    ref = _explicit(*t, pad, fill, te)
    got = tm.vglue_conv_relu(*t, pad, fill, *(te or (None, None)))
    jm.set_winsum(winsum)
    try:
        want = jm.vglue_conv_relu(*map(jnp.asarray, (mu, sigma, w_mu, w_sigma)), pad, fill,
                                  *(map(jnp.asarray, enc) if enc else (None, None)))
    finally:
        jm.set_winsum("shift")
    for g, r, w in zip(got, ref, want):
        assert g.shape == r.shape == w.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("pad,fill,with_enc", OP_CASES)
def test_op_gradients_match_jax_grad(pad, fill, with_enc):
    """Autograd of the fold against ``jax.grad`` of JAX's fold on the same
    cotangents, for every input (the encoder's moments too)."""
    mu, sigma, w_mu, w_sigma, enc = _op_case(pad, with_enc, seed=1)
    args = [mu, sigma, w_mu, w_sigma] + (list(enc) if enc else [])
    rng = np.random.default_rng(2)

    def jfn(m, s, wm, ws, *e):
        return jm.vglue_conv_relu(m, s, wm, ws, pad, fill, *(e or (None, None)))

    cots = [rng.normal(0, 1, o.shape).astype(np.float32)
            for o in jfn(*map(jnp.asarray, args))]
    want = jax.grad(lambda *a: sum(jnp.sum(o * c) for o, c in zip(jfn(*a), cots)),
                    argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    out = tm.vglue_conv_relu(*t[:4], pad, fill, *(t[4:] or (None, None)))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots)).backward()
    for x, r in zip(t, want):
        r = np.asarray(r)
        assert np.abs(x.grad.numpy() - r).max() <= GRAD_RTOL * np.abs(r).max()


def test_op_member_stacked_is_per_member():
    """Member-stacked weights run member by member: each member's block of
    the output equals the fold with its own weights, bit for bit."""
    rng = np.random.default_rng(3)
    mu, sigma = (torch.from_numpy(a) for a in _rand_pair(rng, (4, 10, 10, 6)))
    me, se = (torch.from_numpy(a) for a in _rand_pair(rng, (4, 21, 21, 6)))
    w = torch.from_numpy((0.1 * rng.normal(0, 1, (2, 3, 3, 12, 5))).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(-6, -4, (2, 5)).astype(np.float32))
    m, s = tm.vglue_conv_relu(mu, sigma, w, ws, (3, 3), 0.02, me, se)
    for k in range(2):
        b = slice(2 * k, 2 * k + 2)
        mk, sk = tm.vglue_conv_relu(mu[b], sigma[b], w[k], ws[k], (3, 3), 0.02, me[b], se[b])
        np.testing.assert_array_equal(m[b].numpy(), mk.numpy())
        np.testing.assert_array_equal(s[b].numpy(), sk.numpy())


# -------------------------------------------------------------- the models


def _cfgs(name):
    if name == "hippocampus":
        t = dataclasses.replace(configs.HIPPOCAMPUS.model, base_kernels=4)
        j = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, base_kernels=4)
        return t, j, 2
    # depth-5 BraTS geometry (with the (1, 0) bottleneck pre-pad) at a test
    # width, one image
    t = dataclasses.replace(configs.BRATS.model, base_kernels=2)
    j = dataclasses.replace(jconfigs.BRATS.model, base_kernels=2)
    return t, j, 1


def _tloss(params, x, cfg):
    probs, sigma = forward(params, x, cfg)
    return torch.log(sigma + 1e-3).mean() + (probs * probs).mean()


def _jloss(params, x, cfg):
    probs, sigma = jforward(params, x, cfg)
    return jnp.mean(jnp.log(sigma + 1e-3)) + jnp.mean(jnp.square(probs))


def _run(jparams, x, cfg, fold, loss=_tloss, fwd=forward):
    """(probs, sigma, loss, {layer/leaf: gradient}) of the port."""
    params = params_from_jax(jparams, "cpu")
    leaves = {f"{n}/{k}": t.requires_grad_(True) for n, p in params.items()
              for k, t in p.items()}
    with tm.lowering(glue_fold=fold):
        probs, sigma = fwd(params, torch.from_numpy(x), cfg)
        lv = loss(params, torch.from_numpy(x), cfg)
        grads = torch.autograd.grad(lv, list(leaves.values()))
    return (probs.detach().numpy(), sigma.detach().numpy(), float(lv.detach()),
            dict(zip(leaves, (g.numpy() for g in grads))))


def _jrun(jparams, x, jcfg, fold, loss=_jloss, fwd=jforward):
    jm.set_glue_fold(fold)
    try:
        p, s = jax.jit(lambda pp, xx: fwd(pp, xx, jcfg))(jparams, jnp.asarray(x))
        lv, g = jax.jit(jax.value_and_grad(lambda pp, xx: loss(pp, xx, jcfg)))(
            jparams, jnp.asarray(x))
    finally:
        jm.set_glue_fold("none")
    return np.asarray(p), np.asarray(s), float(lv), {
        f"{n}/{k}": np.asarray(v) for n, ws in g.items() for k, v in ws.items()}


def _fold_vs_explicit(got, ref):
    """The JAX test's fold-against-none tolerances."""
    np.testing.assert_allclose(got[0], ref[0], rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=3e-5, atol=3e-6)
    for name, g in got[3].items():
        np.testing.assert_allclose(g, ref[3][name], rtol=2e-4, atol=2e-5, err_msg=name)


def _port_vs_jax(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL * max(1.0, np.abs(want[1]).max()))
    assert got[2] == pytest.approx(want[2], rel=1e-5)
    for name, g in got[3].items():
        w = want[3][name]
        assert np.abs(g - w).max() <= GRAD_RTOL * max(np.abs(w).max(), 1e-30), name


@pytest.mark.parametrize("name", ["hippocampus", "brats_small"])
def test_forward_and_grad_equality(name):
    """The whole model under the fold against the explicit choreography
    (forward and every parameter's gradient) and against JAX's fold."""
    cfg, jcfg, batch = _cfgs(name)
    jparams = jinit(jax.random.PRNGKey(1), jcfg)
    x = np.array(jax.random.normal(jax.random.PRNGKey(2),
                                   (batch, cfg.image_size, cfg.image_size, cfg.in_channels)))
    got = _run(jparams, x, cfg, "fold")
    _fold_vs_explicit(got, _run(jparams, x, cfg, "none"))
    _port_vs_jax(got, _jrun(jparams, x, jcfg, "fold"))


CFG3 = dataclasses.replace(configs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                           base_kernels=2)
JCFG3 = dataclasses.replace(jconfigs.HIPPOCAMPUS.model, image_size=32, out_size=22,
                            base_kernels=2)


def _tloss3(params, x, cfg):
    probs, sigma = forward3d(params, x, cfg)
    return torch.log(sigma + 1e-3).mean() + (probs * probs).mean()


def _jloss3(params, x, cfg):
    probs, sigma = jforward3d(params, x, cfg)
    return jnp.mean(jnp.log(sigma + 1e-3)) + jnp.mean(jnp.square(probs))


@pytest.fixture(scope="module")
def case3d():
    return (jinit3d(jax.random.PRNGKey(4), JCFG3),
            np.array(jax.random.normal(jax.random.PRNGKey(5), (1, 32, 32, 32, 1))))


def test_forward3d_fold_equality(case3d):
    """3-D fold against the explicit choreography (forward and gradients,
    the JAX test's tolerances) and against JAX's 3-D fold."""
    jparams, x = case3d
    got = _run(jparams, x, CFG3, "fold", _tloss3, forward3d)
    _fold_vs_explicit(got, _run(jparams, x, CFG3, "none", _tloss3, forward3d))
    _port_vs_jax(got, _jrun(jparams, x, JCFG3, "fold", _jloss3, jforward3d))


def test_forward3d_im2col_matches_jax(case3d):
    """The port's one 3-D lowering through the whole 3-D model against the
    JAX package's ``set_conv3d_impl("im2col")``, forward and gradients."""
    jparams, x = case3d
    got = _run(jparams, x, CFG3, "none", _tloss3, forward3d)
    jm3.set_conv3d_impl("im2col")
    try:
        want = _jrun(jparams, x, JCFG3, "none", _jloss3, jforward3d)
    finally:
        jm3.set_conv3d_impl("conv")
    _port_vs_jax(got, want)


# ------------------------------------------------- taps, flops, remat, members


@pytest.mark.parametrize("family", ["2d", "3d"])
def test_flops_shape_tap_under_fold(family):
    """Under the fold the forward taps every named conv layer with JAX's
    stage names and shapes (the explicit pads and concatenations are not
    stages), and the FLOP counts stay those of the explicit glue."""
    if family == "2d":
        cfg, jcfg = _cfgs("hippocampus")[:2]
        shape = (1, cfg.image_size, cfg.image_size, 1)
        jparams, tfwd, jfwd, fn = jinit(jax.random.PRNGKey(0), jcfg), forward, jforward, \
            flops.train_step_flops
    else:
        cfg, jcfg = CFG3, JCFG3
        shape = (1, 32, 32, 32, 1)
        jparams, tfwd, jfwd, fn = jinit3d(jax.random.PRNGKey(0), jcfg), forward3d, \
            jforward3d, flops.train_step_flops3d
    x = np.zeros(shape, np.float32)
    ttaps, jtaps = [], []
    jm.set_glue_fold("fold")
    try:
        jax.eval_shape(lambda p, xx: jfwd(p, xx, jcfg, tap=lambda n, s: jtaps.append((n, tuple(s)))),
                       jparams, jnp.asarray(x))
    finally:
        jm.set_glue_fold("none")
    none = fn(cfg, 4)
    with tm.lowering(glue_fold="fold"), torch.no_grad():
        tfwd(params_from_jax(jparams, "cpu"), torch.from_numpy(x), cfg,
             tap=lambda n, s: ttaps.append((n, s)))
        assert fn(cfg, 4) == none
    assert ttaps == jtaps
    assert not any("pad" in n or "concat" in n for n, _ in ttaps)


def test_fold_under_remat():
    """``cfg.remat`` with the fold: the same loss and gradients, bit for
    bit, and the taps fire once."""
    cfg, jcfg, _ = _cfgs("hippocampus")
    cfg = dataclasses.replace(cfg, image_size=32, out_size=22)
    jparams = jinit(jax.random.PRNGKey(6), dataclasses.replace(jcfg, image_size=32,
                                                               out_size=22))
    x = np.random.default_rng(7).normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
    plain = _run(jparams, x, cfg, "fold")
    remat = _run(jparams, x, dataclasses.replace(cfg, remat=True), "fold")
    assert plain[2] == remat[2]
    for name, g in plain[3].items():
        np.testing.assert_array_equal(g, remat[3][name], err_msg=name)
    taps = []
    params = params_from_jax(jparams, "cpu")
    for t in params.values():
        for v in t.values():
            v.requires_grad_(True)
    with tm.lowering(glue_fold="fold"):
        p, s = forward(params, torch.from_numpy(x), dataclasses.replace(cfg, remat=True),
                       tap=lambda n, sh: taps.append(n))
        (p.sum() + s.sum()).backward()
    assert len(taps) == len(set(taps))


def test_constrain_under_fold_sees_the_jax_call_sequence():
    cfg, jcfg, _ = _cfgs("hippocampus")
    jparams = jinit(jax.random.PRNGKey(8), jcfg)
    x = np.zeros((1, 64, 64, 1), np.float32)
    jseen, tseen = [], []
    jm.set_glue_fold("fold")
    try:
        jax.eval_shape(lambda p, xx: jforward(
            p, xx, jcfg, constrain=lambda m, s: jseen.append(tuple(m.shape)) or (m, s)),
            jparams, jnp.asarray(x))
    finally:
        jm.set_glue_fold("none")
    with tm.lowering(glue_fold="fold"), torch.no_grad():
        forward(params_from_jax(jparams, "cpu"), torch.from_numpy(x), cfg,
                constrain=lambda m, s: tseen.append(tuple(m.shape)) or (m, s))
    assert tseen == jseen


@pytest.mark.parametrize("family", ["2d", "3d"])
def test_fold_member_stacked_forward(family):
    """A member-stacked forward under the fold equals each member's own
    forward, bit for bit."""
    if family == "2d":
        cfg = dataclasses.replace(_cfgs("hippocampus")[0], image_size=32, out_size=22)
        jcfg = dataclasses.replace(_cfgs("hippocampus")[1], image_size=32, out_size=22)
        init, fwd, shape = jinit, forward, (2, 32, 32, 1)
    else:
        cfg, jcfg, init, fwd, shape = CFG3, JCFG3, jinit3d, forward3d, (1, 32, 32, 32, 1)
    members = [params_from_jax(init(jax.random.PRNGKey(k), jcfg), "cpu") for k in range(2)]
    stacked = {n: {k: torch.stack([m[n][k] for m in members]) for k in members[0][n]}
               for n in members[0]}
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 1, (2,) + shape)
                         .astype(np.float32))
    with tm.lowering(glue_fold="fold"), torch.no_grad():
        probs, sigma = fwd(stacked, x, cfg)
        for k in range(2):
            pk, sk = fwd(members[k], x[k], cfg)
            np.testing.assert_array_equal(probs[k].numpy(), pk.numpy())
            np.testing.assert_array_equal(sigma[k].numpy(), sk.numpy())
