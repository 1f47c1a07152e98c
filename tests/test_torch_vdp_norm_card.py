"""On the card, the normalisation moments' kernel pair
(``ops/kernels/vdp_norm.py``, ``csrc/vdp_norm.cu``) against its plain
version run in float64 on the same float32 inputs, at the shapes of the
Swin UNETR step: InstanceNorm at 1x128^3x48 (``encoder1``, ``decoder1``) and
1x8^3x384 (``decoder5``), LayerNorm at 1x64^3x48 (stage 0), 1x32^3x384 (the
first patch merge) and 1x4^3x3072 (the last), and at 105 tokens of 48 and of
96 channels (an odd count of rows narrower than a warp's 256 elements); and
of the MedNeXt step, InstanceNorm with a gamma and beta per channel
(GroupNorm(C, C)) at 1x128^3x32 (level 0) and 1x8^3x512 (the bottleneck),
and at 2x16^3x256 (two volumes, folded over). Both directions, gamma and
beta gradients included; two runs bit for bit; one launch counted a call.
``card`` marks each test: it needs a CUDA card and skips without one. This
file imports no JAX:
``python -m pytest tests/test_torch_vdp_norm_card.py -q -p no:randomly``.

Tolerance: every output and input gradient within ``TOL`` = 1e-5 of the
float64 result's largest magnitude; a gamma or beta gradient within ``TOL``
of the largest sum of its terms' magnitudes over the tokens (a sum of terms
of both signs is small beside them, and float32 rounding scales with them).
The kernels sum in float32 within a block (a few hundred terms, about 1e-7
relative each) and in float64 across blocks, and each element's closed form
is a handful of float32 operations (a few ulps, 6e-8 each); 1e-5 leaves two
orders of magnitude for that, and a dropped term of the closed form (each
is of the outputs' order) fails it."""

import math

import pytest
import torch

from supernet_tpu_torch import tracing
from supernet_tpu_torch.ops import moments_swin as MS
from supernet_tpu_torch.ops.kernels import vdp_norm as N

TOL = 1e-5
INSTANCE = (1, 2, 3)
LAYER = (-1,)

# (name, shape, dims, affine)
SHAPES = [
    ("instance_128c48", (1, 128, 128, 128, 48), INSTANCE, False),
    ("instance_8c384", (1, 8, 8, 8, 384), INSTANCE, False),
    ("layer_64c48", (1, 64, 64, 64, 48), LAYER, True),
    ("layer_64c48_plain", (1, 64, 64, 64, 48), LAYER, False),
    ("layer_4c3072", (1, 4, 4, 4, 3072), LAYER, True),
    ("layer_32c384", (1, 32, 32, 32, 384), LAYER, True),
    ("layer_ragged_c48", (1, 3, 5, 7, 48), LAYER, True),
    ("layer_ragged_c96", (1, 3, 5, 7, 96), LAYER, True),
    ("instance_affine_128c32", (1, 128, 128, 128, 32), INSTANCE, True),
    ("instance_affine_8c512", (1, 8, 8, 8, 512), INSTANCE, True),
    ("instance_affine_b2_16c256", (2, 16, 16, 16, 256), INSTANCE, True),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield
    tracing.reset()
    torch.cuda.empty_cache()


def _inputs(shape, affine, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mu = torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5
    sigma = torch.rand(shape, device="cuda", generator=g) * 0.1 + 1e-3
    c = shape[-1]
    gamma = torch.randn(c, device="cuda", generator=g) if affine else None
    beta = torch.randn(c, device="cuda", generator=g) if affine else None
    cot = [torch.randn(shape, device="cuda", generator=g) for _ in range(2)]
    return mu, sigma, gamma, beta, cot


def _gap(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _wide(t):
    return None if t is None else t.double()


@pytest.mark.card
@pytest.mark.parametrize("name,shape,dims,affine", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_pair_against_float64(cuda, name, shape, dims, affine):
    mu, sigma, gamma, beta, (g_mu, g_sigma) = _inputs(shape, affine, 26)
    out_mu, out_sigma, stats = N.norm_fwd(mu, sigma, dims, gamma, beta, MS.NORM_EPS)
    d_mu, d_sigma, d_gamma, d_beta = N.norm_bwd(
        mu, sigma, g_mu, g_sigma, gamma, None if beta is None else beta.shape, stats, dims,
        affine)
    torch.cuda.synchronize()
    wide = [t.double() for t in (mu, sigma, g_mu, g_sigma)]
    r_mu, r_sigma, r_stats = N.norm_fwd_plain(wide[0], wide[1], dims, _wide(gamma),
                                              _wide(beta), MS.NORM_EPS)
    gaps = {"mu": _gap(out_mu, r_mu), "sigma": _gap(out_sigma, r_sigma)}
    del r_mu, r_sigma
    r = N.norm_bwd_plain(*wide, _wide(gamma), None if beta is None else beta.shape, r_stats,
                         dims)
    gaps.update(d_mu=_gap(d_mu, r[0]), d_sigma=_gap(d_sigma, r[1]))
    if affine:
        m, s, a, b, d = r_stats
        n = math.prod(shape[i] for i in dims)
        x = (wide[0] - m) / s
        inner = wide[1] * (1.0 - 2.0 * (1.0 + x * x) / n) + (a + 2.0 * x * b + x * x * d) / n ** 2
        g64 = gamma.double()
        scale_g = ((wide[2] * x).abs() + (2.0 * g64 * wide[3] * inner / (s * s)).abs())
        scale_g = float(scale_g.sum_to_size(g64.shape).max())
        scale_b = float(wide[2].abs().sum_to_size(g64.shape).max())
        gaps["d_gamma"] = float((d_gamma.double() - r[2]).abs().max()) / scale_g
        gaps["d_beta"] = float((d_beta.double() - r[3]).abs().max()) / scale_b
    print(f"{name}: {gaps}")
    for k, v in gaps.items():
        assert math.isfinite(v) and v < TOL, (k, v)


@pytest.mark.card
@pytest.mark.parametrize("name,shape,dims,affine", SHAPES, ids=[s[0] for s in SHAPES])
def test_two_runs_give_the_same_bits_and_count_one_launch_each(cuda, name, shape, dims,
                                                               affine):
    mu, sigma, gamma, beta, cot = _inputs(shape, affine, 27)
    runs = []
    tracing.reset()
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (mu, sigma, gamma, beta) if t is not None]
        it = iter(leaves)
        m, s = next(it), next(it)
        g, b = (next(it), next(it)) if affine else (None, None)
        out = MS.vnorm(m, s, dims, g, b)
        torch.autograd.backward(out, cot)
        runs.append([t.detach().clone() for t in out] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    counts = tracing.counters()
    assert counts["vdp_norm.launches"] == 2 and counts["vdp_norm.bwd_launches"] == 2
    assert counts["moments.norms_fused"] == counts["moments.norms"] == 2
