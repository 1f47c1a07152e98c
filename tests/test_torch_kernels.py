"""The port's kernel modules (supernet_tpu_torch/ops/kernels) on the CPU:
their plain versions against the JAX package's Pallas kernels run in
interpret mode, and the launch counters untouched by CPU tensors. The CUDA
kernels themselves are held against the same plain versions on the card by
chip_smoke.py."""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops.pallas import pool as jpool  # noqa: E402
from supernet_tpu.ops.pallas import vdp_conv as jvdp_conv  # noqa: E402
from supernet_tpu_torch.ops.kernels import pool, vdp_conv  # noqa: E402

# the module, not the function the package re-exports under the same name
jvdp_module = importlib.import_module("supernet_tpu.ops.pallas.vdp_conv")

CASES = [
    # k, cin, cout, H, fuse_relu, has_sigma  (tests/test_pallas.py:12-19)
    (3, 8, 16, 12, False, True),
    (3, 8, 16, 12, True, True),
    (2, 8, 8, 10, False, True),
    (1, 16, 4, 9, False, True),
    (3, 1, 8, 12, False, False),
]
VDP_ATOL = 1e-4  # the tolerance of tests/test_pallas.py for the same cases


def _conv_inputs(k, cin, cout, h, has_sigma, seed=0):
    rng = np.random.default_rng(seed)

    def t(*s):
        return rng.normal(0, 1, s).astype(np.float32)

    mu = t(2, h, h, cin)
    sigma = np.abs(t(2, h, h, cin)) if has_sigma else None
    return mu, sigma, 0.3 * t(k, k, cin, cout), t(cout) - 5.0


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CASES)
def test_vdp_conv_plain_matches_pallas_interpret(k, cin, cout, h, fuse, has_sigma):
    mu, sigma, w_mu, w_sigma = _conv_inputs(k, cin, cout, h, has_sigma)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (mu, sigma, w_mu, w_sigma)]
    want_mu, want_sig = jvdp_conv(*jargs, fuse_relu=fuse, interpret=True)
    _, _, want_win = jvdp_module._pallas_forward(
        *jargs, fuse_relu=fuse, precision="highest", interpret=True
    )
    targs = [torch.from_numpy(a) if a is not None else None
             for a in (mu, sigma, w_mu, w_sigma)]
    got = vdp_conv.vdp_conv(*targs, fuse_relu=fuse)
    assert vdp_conv.launches == 0  # CPU tensors never reach the kernel
    for g, w in zip(got, (want_mu, want_sig, want_win)):
        assert g.shape == w.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VDP_ATOL)


def _pool_inputs(shape, ties, seed=0):
    rng = np.random.default_rng(seed)
    if ties:
        mu = rng.integers(-3, 3, shape).astype(np.float32)
    else:
        mu = rng.normal(0, 1, shape).astype(np.float32)
    return mu, np.abs(rng.normal(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("shape,ties", [
    ((2, 8, 8, 32), True),
    ((1, 12, 16, 8), False),
    ((3, 4, 4, 130), True),  # >1 lane tile (tests/test_pallas.py:119-123)
])
def test_vmaxpool_plain_bit_exact_vs_pallas_interpret(shape, ties):
    mu, sigma = _pool_inputs(shape, ties)
    jpool.set_interpret(True)
    try:
        (want_mx, want_so), want_idx = jpool._vmp_fwd(
            jnp.asarray(mu), jnp.asarray(sigma)
        )
    finally:
        jpool.set_interpret(False)
    got = pool.vmaxpool(torch.from_numpy(mu), torch.from_numpy(sigma),
                        return_idx=True)
    assert pool.launches == 0
    for g, w in zip(got, (want_mx, want_so, want_idx)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_vmaxpool_odd_shape_bit_exact_vs_composition():
    from supernet_tpu.ops.moments import _vmaxpool_fwd_impl

    mu, sigma = _pool_inputs((2, 7, 9, 4), ties=True)
    want_mx, want_so, (want_idx, _) = _vmaxpool_fwd_impl(
        jnp.asarray(mu), jnp.asarray(sigma)
    )
    mx, so, idx = pool.vmaxpool(torch.from_numpy(mu), torch.from_numpy(sigma),
                                return_idx=True)
    assert mx.shape == (2, 4, 5, 4)
    for g, w in zip((mx, so, idx), (want_mx, want_so, want_idx)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_vmaxpool_propagates_nan_like_jnp_maximum():
    mu = np.zeros((1, 2, 2, 1), np.float32)
    mu[0, 0, 1, 0] = np.nan
    sigma = np.arange(4, dtype=np.float32).reshape(1, 2, 2, 1)
    from supernet_tpu.ops.moments import _vmaxpool_fwd_impl

    want_mx, want_so, (want_idx, _) = _vmaxpool_fwd_impl(
        jnp.asarray(mu), jnp.asarray(sigma)
    )
    mx, so, idx = pool.vmaxpool(torch.from_numpy(mu), torch.from_numpy(sigma),
                                return_idx=True)
    assert np.isnan(mx.numpy()).all() and np.isnan(np.asarray(want_mx)).all()
    np.testing.assert_array_equal(so.numpy(), np.asarray(want_so))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_wrappers_reject_other_devices():
    meta = torch.empty((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError):
        pool.vmaxpool(meta, meta)
    with pytest.raises(ValueError):
        vdp_conv.vdp_conv(meta, None, torch.empty((3, 3, 2, 4), device="meta"),
                          torch.empty((4,), device="meta"))


def test_library_path_is_named_by_source_hash():
    from supernet_tpu_torch.ops.kernels import _lib

    path = _lib._library_path()
    assert path.parent == _lib.BUILD_DIR
    assert path.name.startswith("libsupernet_kernels_") and path.suffix == ".so"
    assert path == _lib._library_path()  # stable for unchanged sources
    assert {p.name for p in _lib._CSRC.glob("*.cu")} >= {"vdp_conv.cu", "pool.cu"}
