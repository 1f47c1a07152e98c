"""The normalisation moments' Function (``ops/kernels/vdp_norm.py``) on the
CPU: its plain forward bit for bit the closed form ``vnorm`` took before it
became a Function, its closed-form backward against autograd of that closed
form and against ``gradcheck`` in float64, the gradients a caller does not
ask for, the kernels' plans and layouts from the shape alone, and the
refusal of a device that is neither the CPU nor CUDA. The kernels
themselves run on the card: ``tests/test_torch_vdp_norm_card.py``."""

import math
import types

import pytest
import torch

from supernet_tpu_torch import tracing
from supernet_tpu_torch.ops import moments_swin as MS
from supernet_tpu_torch.ops.kernels import vdp_norm as N

LAYER = (-1,)
INSTANCE = (1, 2, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _closed_form(mu, sigma, dims, gamma=None, beta=None, eps=MS.NORM_EPS):
    """``vnorm`` as the plan wrote it before the Function: the closed form
    in PyTorch operations, differentiated by autograd."""
    n = math.prod(mu.shape[d] for d in dims)
    m = mu.mean(dims, keepdim=True)
    c = mu - m
    s = torch.sqrt((c * c).mean(dims, keepdim=True) + eps)
    x = c / s
    xs = x * sigma
    a = sigma.sum(dims, keepdim=True)
    b = xs.sum(dims, keepdim=True)
    d = (x * xs).sum(dims, keepdim=True)
    x2 = x * x
    inner = sigma * (1.0 - 2.0 * (1.0 + x2) / n) + (a + 2.0 * x * b + x2 * d) / (n * n)
    scale = 1.0 / (s * s)
    if gamma is not None:
        scale = scale * (gamma * gamma)
        x = x * gamma
    if beta is not None:
        x = x + beta
    return x, scale * inner


# (name, shape, dims, gamma, beta): LayerNorm over channels with and without
# its affine (each alone too), InstanceNorm over odd sides, one volume and two,
# without and with a gamma and beta per channel (MedNeXt's GroupNorm(C, C))
CASES = [
    ("layer_affine", (2, 2, 3, 2, 8), LAYER, True, True),
    ("layer_plain", (2, 3, 1, 2, 5), LAYER, False, False),
    ("layer_gamma", (3, 7), LAYER, True, False),
    ("layer_beta", (3, 7), LAYER, False, True),
    ("instance_odd", (2, 3, 5, 3, 4), INSTANCE, False, False),
    ("instance_one", (1, 5, 3, 1, 6), INSTANCE, False, False),
    ("instance_affine", (2, 3, 5, 3, 4), INSTANCE, True, True),
    ("instance_affine_one", (1, 5, 3, 1, 6), INSTANCE, True, True),
]


def _inputs(shape, gamma, beta, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    mu = torch.randn(shape, generator=g, dtype=dtype) * 1.7 + 0.4
    sigma = torch.rand(shape, generator=g, dtype=dtype) + 0.05
    c = shape[-1]
    gam = torch.randn(c, generator=g, dtype=dtype) if gamma else None
    bet = torch.randn(c, generator=g, dtype=dtype) if beta else None
    return mu, sigma, gam, bet


@pytest.mark.parametrize("name,shape,dims,gamma,beta", CASES, ids=[c[0] for c in CASES])
def test_forward_is_the_closed_form_bit_for_bit(name, shape, dims, gamma, beta):
    mu, sigma, gam, bet = _inputs(shape, gamma, beta, 1)
    got = MS.vnorm(mu, sigma, dims, gam, bet)
    want = _closed_form(mu, sigma, dims, gam, bet)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,shape,dims,gamma,beta", CASES, ids=[c[0] for c in CASES])
def test_backward_is_autograd_of_the_closed_form(name, shape, dims, gamma, beta):
    mu, sigma, gam, bet = _inputs(shape, gamma, beta, 2)
    leaves = [t.requires_grad_() for t in (mu, sigma, gam, bet) if t is not None]
    g = torch.Generator().manual_seed(3)
    cot = [torch.randn(shape, generator=g, dtype=torch.float64) for _ in range(2)]
    got = torch.autograd.grad(MS.vnorm(mu, sigma, dims, gam, bet), leaves, cot)
    want = torch.autograd.grad(_closed_form(mu, sigma, dims, gam, bet), leaves, cot)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-12 * float(b.abs().max())), \
            float((a - b).abs().max())


@pytest.mark.parametrize("name,shape,dims,gamma,beta", CASES, ids=[c[0] for c in CASES])
def test_gradcheck(name, shape, dims, gamma, beta):
    mu, sigma, gam, bet = _inputs(shape, gamma, beta, 4)
    inputs = tuple(t.requires_grad_() for t in (mu, sigma, gam, bet) if t is not None)

    def fn(*args):
        it = iter(args)
        m, s = next(it), next(it)
        return N.VNorm.apply(m, s, next(it) if gamma else None, next(it) if beta else None,
                             dims, MS.NORM_EPS)

    assert torch.autograd.gradcheck(fn, inputs)


@pytest.mark.parametrize("frozen", ["sigma", "mu", "gamma", "beta"])
def test_gradients_not_asked_for(frozen):
    """A caller that needs no gradient of one input gets None there and the
    same gradients of the others (σ without a gradient: the first layer's
    case)."""
    mu, sigma, gam, bet = _inputs((2, 3, 2, 2, 6), True, True, 5)
    g = torch.Generator().manual_seed(6)
    cot = [torch.randn(mu.shape, generator=g, dtype=torch.float64) for _ in range(2)]
    grads = []
    for skip in (None, frozen):
        leaves = {k: t.clone().requires_grad_(k != skip)
                  for k, t in dict(mu=mu, sigma=sigma, gamma=gam, beta=bet).items()}
        torch.autograd.backward(MS.vlayer_norm(*leaves.values()), cot)
        grads.append({k: t.grad for k, t in leaves.items()})
    assert grads[1][frozen] is None
    for k, want in grads[0].items():
        if k != frozen:
            assert torch.equal(grads[1][k], want), k


def test_counts_norms_and_no_kernel_on_the_cpu():
    tracing.reset()
    mu, sigma, _, _ = _inputs((1, 3, 3, 3, 4), False, False, 7, torch.float32)
    MS.vinstance_norm3d(mu, sigma)
    MS.vlayer_norm(mu, sigma)
    counts = tracing.counters()
    assert counts["moments.norms"] == 2
    assert counts.get("moments.norms_fused", 0) == 0
    assert counts["vdp_norm.launches"] == counts["vdp_norm.bwd_launches"] == 0
    tracing.reset()


@pytest.mark.parametrize("device", ["mps", "xpu", "hip"])
def test_other_devices_are_refused(device):
    """Neither the CPU nor CUDA: raise, whatever the tensor is (a stand-in
    carries the device: this build has no such backend)."""
    mu = types.SimpleNamespace(device=torch.device(device), is_cuda=False)
    with pytest.raises(ValueError, match="unsupported device"):
        N.norm_fwd(mu, mu, INSTANCE, None, None, MS.NORM_EPS)
    with pytest.raises(ValueError, match="unsupported device"):
        N.norm_bwd(mu, mu, mu, mu, None, None, (mu,), INSTANCE, False)


def test_meta_tensors_take_the_plain_shapes():
    """``stage_shapes3d`` runs the plan on meta tensors: the plain version's
    shapes, no kernel."""
    mu = torch.empty((1, 3, 4, 5, 8), device="meta")
    for dims, gamma in ((INSTANCE, None), (LAYER, torch.empty(8, device="meta"))):
        out_mu, out_sigma = MS.vnorm(mu, mu, dims, gamma, gamma)
        assert out_mu.shape == out_sigma.shape == mu.shape
        assert out_mu.device.type == "meta"


@pytest.mark.parametrize("shape,dims,kind", [
    ((2, 4, 4, 4, 48), (-1,), "rows"),
    ((2, 4, 4, 4, 48), (4,), "rows"),
    ((7, 3072), (-1,), "rows"),
    ((1, 8, 8, 8, 384), (1, 2, 3), "slices"),
    ((1, 8, 8, 8, 384), (-4, -3, -2), "slices"),
    ((1, 8, 8, 8, 384), (3, 2, 1), "slices"),
    ((8, 8, 8, 384), (1, 2), None),
    ((1, 8, 8, 8, 384), (1, 2), None),
    ((1, 8, 8, 8, 384), (0, 4), None),
])
def test_layout_from_the_dims(shape, dims, kind):
    assert N.layout(shape, dims) == kind


@pytest.mark.parametrize("c", [1, 5, 48, 96, 192, 256, 257, 384, 768, 1536, 3072, 4096])
@pytest.mark.parametrize("rows", [1, 64, 4096, 262144])
def test_row_plan_holds_the_row(rows, c):
    p = N.plan_rows(rows, c)
    assert p.tpr * N.ROW_ELEMS >= c
    assert p.tpr == N.MIN_TPR == 32 or p.tpr // 2 * N.ROW_ELEMS < c
    assert p.tpr & (p.tpr - 1) == 0 and p.tpr % 32 == 0
    assert p.tpr <= N.MAX_TPR
    assert 1 <= p.blocks <= rows
    assert p.blocks * p.tpr <= N.SMS * N.ROW_THREADS_PER_SM


def test_row_plan_at_the_step_widths():
    """The Swin UNETR step's LayerNorm widths: up to 192 channels a warp a
    row, wider rows a block."""
    got = {c: N.plan_rows(4096, c).tpr for c in (48, 96, 192, 384, 768, 1536, 3072)}
    assert got == {48: 32, 96: 32, 192: 32, 384: 64, 768: 128, 1536: 256, 3072: 512}


def test_row_plan_refuses_wider_rows():
    with pytest.raises(ValueError, match="C <= 4096"):
        N.plan_rows(8, 4097)


# the InstanceNorm shapes of one Swin UNETR step at 128^3, odd ones, and a
# batch
@pytest.mark.parametrize("b,p,c", [
    (1, 128 ** 3, 48), (1, 64 ** 3, 48), (1, 32 ** 3, 96), (1, 16 ** 3, 192),
    (1, 8 ** 3, 384), (1, 4 ** 3, 768), (2, 5 * 3 * 7, 8), (3, 1, 4), (1, 999, 1032),
    (4, 17 ** 3, 64),
])
def test_slice_plan_covers_every_position_once(b, p, c):
    pl = N.plan_slices(b, p, c)
    units = c // N.VEC
    assert pl.qx * pl.py <= N.SLICE_THREADS and pl.qx == min(units, N.SLICE_THREADS)
    assert pl.ctiles * pl.qx >= units > (pl.ctiles - 1) * pl.qx
    assert pl.chunk % pl.py == 0
    assert (pl.chunks - 1) * pl.chunk < p <= pl.chunks * pl.chunk
    blocks = b * pl.ctiles * pl.chunks
    assert blocks <= max(b * pl.ctiles, N.SMS * N.SLICE_BLOCKS_PER_SM + b * pl.ctiles)


def test_slice_plan_fills_the_card_at_the_largest_norm():
    pl = N.plan_slices(1, 128 ** 3, 48)
    assert (pl.qx, pl.py) == (12, 21)
    assert pl.chunks >= N.SMS * N.SLICE_BLOCKS_PER_SM - 8


@pytest.mark.parametrize("c", [1, 6, 1030])
def test_slice_plan_refuses_channels_not_a_multiple_of_four(c):
    with pytest.raises(ValueError, match="C % 4 == 0"):
        N.plan_slices(1, 64, c)
