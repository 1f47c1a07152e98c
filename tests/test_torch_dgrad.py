"""The input gradient of the fused VDP conv as kernel 1 runs it on the card:
each transposed convolution of ``VDPConv.backward`` is a VALID convolution
of the cotangent padded by k - 1 with the weights flipped in both spatial
axes and Cin, Cout swapped (``ops/kernels/vdp_conv.py:conv_t_pair``), one
launch of the kernel without its window sum for both moments.

On the CPU: the padded, flipped plain form against PyTorch's
``conv_transpose2d`` (``_conv_t``) and against ``jax.vjp`` of the JAX
package's convolution; the planner's path for every layer's input-gradient
shape; the calls per backward that the card's ``dgrad_launches`` count.
The kernel itself is held against the plain form on the card by
``chip_smoke.py`` (phase 5)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops import moments as jmoments  # noqa: E402
from supernet_tpu_torch import configs, profiling, train  # noqa: E402
from supernet_tpu_torch.models import init_params, layer_names  # noqa: E402
from supernet_tpu_torch.ops.kernels import vdp_conv as V  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# b, h', w' (the cotangent's spatial size), cin, cout, k
SHAPES = [
    (2, 6, 7, 3, 4, 3),
    (1, 9, 5, 8, 16, 3),
    (2, 4, 4, 16, 8, 3),
    (3, 5, 6, 4, 1, 3),   # conv_input's 1-channel input gradient
    (2, 7, 6, 24, 40, 2),
    (1, 5, 5, 6, 5, 1),
]
# float32 against float64 or another float32 summation order: relative to
# the output's max magnitude, with K = k^2 Cout <= 360 terms
F32_TOL = 1e-5


def _inputs(shape, seed=0, dtype=np.float32):
    b, hp, wp, cin, cout, k = shape
    rng = np.random.default_rng(seed)
    g1 = rng.normal(0, 1, (b, hp, wp, cout)).astype(dtype)
    g2 = rng.normal(0, 1, (b, hp, wp, cout)).astype(dtype)
    w = (0.3 * rng.normal(0, 1, (k, k, cin, cout))).astype(dtype)
    return g1, g2, w


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_flipped_form_equals_conv_transpose(shape):
    """Exact in float64 (the same products, summed in another order), and
    within F32_TOL in float32."""
    for dtype, tol in ((np.float64, 1e-12), (np.float32, F32_TOL)):
        g1, g2, w = (torch.from_numpy(a) for a in _inputs(shape, dtype=dtype))
        d1, d2 = V.conv_t_pair_plain(g1, g2, w)
        b, hp, wp, cin, cout, k = shape
        assert d1.shape == d2.shape == (b, hp + k - 1, wp + k - 1, cin)
        assert d1.is_contiguous() and d2.is_contiguous()
        assert _rel(d1, V._conv_t(g1, w)) <= tol
        assert _rel(d2, V._conv_t(g2, w * w)) <= tol
        d1_only, none = V.conv_t_pair_plain(g1, None, w)
        assert none is None and torch.equal(d1_only, d1)


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_flipped_form_equals_jax_vjp(shape):
    """``(convT(g1, w), convT(g2, w^2))`` against ``jax.vjp`` of the JAX
    package's VALID convolution with respect to its input, float32 on both
    sides (two summation orders: F32_TOL of the max)."""
    g1, g2, w = _inputs(shape, seed=1)
    b, hp, wp, cin, cout, k = shape
    x = jnp.zeros((b, hp + k - 1, wp + k - 1, cin), jnp.float32)
    _, vjp_w = jax.vjp(lambda a: jmoments._conv_valid(a, jnp.asarray(w)), x)
    _, vjp_w2 = jax.vjp(lambda a: jmoments._conv_valid(a, jnp.square(jnp.asarray(w))), x)
    (want1,), (want2,) = vjp_w(jnp.asarray(g1)), vjp_w2(jnp.asarray(g2))
    d1, d2 = V.conv_t_pair_plain(*(torch.from_numpy(a) for a in (g1, g2, w)))
    assert _rel(d1, want1) <= F32_TOL
    assert _rel(d2, want2) <= F32_TOL


def test_cpu_tensors_take_conv_transpose():
    """On the CPU ``conv_t_pair`` is PyTorch's op itself, bit for bit, and
    launches nothing; other devices raise."""
    g1, g2, w = (torch.from_numpy(a) for a in _inputs(SHAPES[1]))
    before = (V.launches, V.dgrad_launches, V.dgrad_reduce_launches)
    d1, d2 = V.conv_t_pair(g1, g2, w)
    assert torch.equal(d1, V._conv_t(g1, w)) and torch.equal(d2, V._conv_t(g2, w * w))
    d1b, none = V.conv_t_pair(g1, None, w)
    assert none is None and torch.equal(d1b, d1)
    assert (V.launches, V.dgrad_launches, V.dgrad_reduce_launches) == before
    meta = torch.empty((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError):
        V.conv_t_pair(meta, None, torch.empty((3, 3, 3, 2), device="meta"))


@pytest.mark.parametrize("config,batch", [("hippocampus", 20), ("brats", 2)])
def test_dgrad_plan_of_every_layer(config, batch):
    """The input gradient of a k=3 conv with input [b,h,w,Cin] and Cout
    outputs is a conv of [b,h+2,w+2,Cout] into Cin channels: the tensor
    cores for every layer (Cout and Cin multiples of 8), the CUDA cores for
    conv_input (1 or 4 channels), within the split-K caps."""
    convs, _ = profiling.layer_shapes(configs.get_config(config).model)
    for name, (_, h, w, cin), cout in convs:
        p = V.plan(batch, h + 2, w + 2, cout, cin, 3)
        if name == "conv_input":
            assert p.path == "simt" and p.splits == 1, (name, p)
            continue
        assert p.path == "wgmma", (name, p)
        assert p.tile_n == (32 if cin <= 32 else 64)
        assert p.splits <= V.MAX_SPLITS and p.scratch_bytes <= V.MAX_SCRATCH_BYTES
        assert (cout // V.TC_CHUNK) % p.splits == 0
        # 2-D tiles of the input gradient's h x w pixels, and the planes of
        # the forward's weights read in place (flipped as they are split)
        assert (p.tile_h, p.tile_w) == V.tc_tile(h, w)
        n_tiles = -(-cin // p.tile_n)
        assert p.blocks == batch * -(-h // p.tile_h) * -(-w // p.tile_w) * n_tiles * p.splits
        assert p.planes_bytes == 16 * 9 * cout * n_tiles * p.tile_n
    # the forward plans are unchanged by the Cout % 8 rule
    for name, (_, h, w, cin), cout in convs:
        assert V.plan(batch, h, w, cin, cout, 3).path == (
            "simt" if name == "conv_input" else "wgmma")


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[-1] == 3 and s[4] % 8 == 0])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_transposed_weight_planes_read_the_forward_weights(shape, precision):
    """The transposed pair's call on the card hands the prologue the
    forward's ``w_mu`` with its flag FLIP: the planes it splits are those of
    the flipped, transposed weights of :func:`dgrad_operands`, so that copy
    is made only for the CUDA-core path."""
    _, _, w = (torch.from_numpy(a) for a in _inputs(shape))
    _, _, wd = V.dgrad_operands(torch.zeros(1, 2, 2, shape[4]), None, w)
    for tile_n in (32, 64):
        if precision == "default" and shape[4] % 16:
            continue
        assert torch.equal(V.split_weight_planes_plain(w, tile_n, precision, flip=True),
                           V.split_weight_planes_plain(wd, tile_n, precision))


def _tiny(name):
    size = {"hippocampus": dict(image_size=32, out_size=22),
            "brats": dict(image_size=140, out_size=122)}[name]
    return dataclasses.replace(configs.get_config(name).model, base_kernels=4, **size)


@pytest.mark.parametrize("name", ["hippocampus", "brats"])
def test_calls_per_gradient(name, monkeypatch):
    """``conv_t_pair`` runs once per k=3 conv whose input needs a gradient:
    a training gradient skips conv_input (the image needs none), a gradient
    with respect to the image does not. On the card each call is one
    ``dgrad_launches``: 9 / 17 per train step, 10 / 18 per attack gradient
    at hippocampus / BraTS depth."""
    cfg = _tiny(name)
    tc = configs.get_config(name).train
    n3 = sum(1 for _, k, _, _ in layer_names(cfg) if k == 3)
    assert n3 == {"hippocampus": 10, "brats": 18}[name]
    calls = []
    real = V.conv_t_pair
    monkeypatch.setattr(V, "conv_t_pair", lambda g1, g2, w, *a: calls.append(g2 is None)
                        or real(g1, g2, w, *a))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, cfg.image_size, cfg.image_size,
                                           cfg.in_channels)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, (2, cfg.out_size, cfg.out_size)))
    state, _ = train.create_train_state(
        init_params(torch.Generator().manual_seed(0), cfg, "cpu"), tc, "cpu")
    loss, _ = train.loss_fn(state.params, x, y, cfg, tc)
    torch.autograd.grad(loss, train.leaves(state.params))
    assert calls == [False] * (n3 - 1)
    calls.clear()
    xg = x.clone().requires_grad_()
    params = {k: {n: t.detach() for n, t in ws.items()} for k, ws in state.params.items()}
    loss, _ = train.loss_fn(params, xg, y, cfg, tc)
    (g,) = torch.autograd.grad(loss, [xg])
    # conv_input's backward comes last and has no sigma: convT(g1, w_mu) alone
    assert calls == [False] * (n3 - 1) + [True]
    assert g.shape == x.shape and bool(torch.isfinite(g).all())
