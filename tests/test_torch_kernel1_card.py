"""Kernel 1 on the card at the shapes the serving cells run (a BraTS chunk
of 20 slices): every k=3 layer's forward and transposed pair against the
plain version in float64 (within 1e-5 of the max: float32 accuracy), a
split-K layer, the member axis, bf16 activations and one bf16 pass; the
tensor-core path's weight planes bit for bit against
``split_weight_planes_plain``; one prologue per tensor-core call
(``weight_plane_launches`` and ``kernel1.weight_planes`` equal to
``kernel1.path.wgmma``). ``card`` marks each test: it needs a CUDA card
and skips without one. This file imports no JAX: ``python -m pytest
tests/test_torch_kernel1_card.py -q -p no:randomly``."""

import functools

import pytest
import torch

from supernet_tpu_torch import tracing
from supernet_tpu_torch.configs import BRATS
from supernet_tpu_torch.models import layer_names
from supernet_tpu_torch.ops.kernels import vdp_conv as V
from supernet_tpu_torch.profiling import layer_shapes

CHUNK = 20  # the serving cells' batch
F64_TOL = 1e-5  # chip_smoke.py's VDP_F64_TOL
LAYERS = [name for name, k, _, _ in layer_names(BRATS.model) if k == 3]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _shapes():
    """{layer: (h, w, cin, cout)} of one BraTS forward."""
    convs, _ = layer_shapes(BRATS.model)
    return {name: (h, w, cin, cout) for name, (_, h, w, cin), cout in convs}


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _forward_inputs(b, h, w, cin, cout, seed, sigma=True, members=None):
    g = _gen(seed)
    lead = () if members is None else (members,)
    mu = torch.randn(lead + (b, h, w, cin), device="cuda", generator=g)
    sg = (0.05 * torch.randn(lead + (b, h, w, cin), device="cuda", generator=g).abs()
          if sigma else None)
    w_mu = 0.1 * torch.randn(lead + (3, 3, cin, cout), device="cuda", generator=g)
    w_sigma = -4.0 + torch.randn(lead + (cout,), device="cuda", generator=g)
    return mu, sg, w_mu, w_sigma


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _wide(t):
    return None if t is None else t.double()


def _check_forward(mu, sg, w_mu, w_sigma, precision="highest"):
    """The forward without its ReLU against the plain version in float64
    (one bf16 pass: on the rounded operands), and the ReLU form equal to it
    masked."""
    with torch.inference_mode():
        got = V.vdp_conv(mu, sg, w_mu, w_sigma, precision=precision)
        want = V.vdp_conv_plain(_wide(mu), _wide(sg), _wide(w_mu), _wide(w_sigma),
                                precision=precision)
        for name, g, r in zip(("mu_out", "sig_out", "win"), got, want):
            assert _rel(g, r) <= F64_TOL, (name, _rel(g, r))
        relu = V.vdp_conv(mu, sg, w_mu, w_sigma, fuse_relu=True, precision=precision)
        on = got[0] > 0
        assert torch.equal(relu[0], torch.where(on, got[0], 0.0))
        assert torch.equal(relu[1], torch.where(on, got[1], 0.0))
        assert torch.equal(relu[2], got[2])


def _check_transposed(g1, g2, w_mu, precision="highest"):
    with torch.inference_mode():
        got = V.conv_t_pair(g1, g2, w_mu, precision)
        want = V.conv_t_pair_plain(_wide(g1), _wide(g2), _wide(w_mu), precision)
        for name, g, r in zip(("d1", "d2"), got, want):
            assert g.dtype == torch.float32
            assert _rel(g, r) <= F64_TOL, (name, _rel(g, r))


@pytest.mark.card
@pytest.mark.parametrize("layer", LAYERS)
def test_forward_at_chunk_20(card, layer):
    h, w, cin, cout = _shapes()[layer]
    p = V.plan(CHUNK, h, w, cin, cout, 3, 1, torch.cuda.get_device_properties(0)
               .multi_processor_count)
    assert p.path == ("simt" if layer == "conv_input" else "wgmma")
    _check_forward(*_forward_inputs(CHUNK, h, w, cin, cout, seed=1,
                                    sigma=layer != "conv_input"))


@pytest.mark.card
@pytest.mark.parametrize("layer", LAYERS[1:])
def test_transposed_pair_at_chunk_20(card, layer):
    h, w, cin, cout = _shapes()[layer]
    g = _gen(2)
    g1 = torch.randn(CHUNK, h - 2, w - 2, cout, device="cuda", generator=g)
    g2 = torch.randn(CHUNK, h - 2, w - 2, cout, device="cuda", generator=g)
    w_mu = 0.1 * torch.randn(3, 3, cin, cout, device="cuda", generator=g)
    _check_transposed(g1, g2, w_mu)
    # g2 None: the transposed conv of g1 alone
    with torch.inference_mode():
        d1, none = V.conv_t_pair(g1, None, w_mu)
        assert none is None and torch.equal(d1, V.conv_t_pair(g1, g2, w_mu)[0])


@pytest.mark.card
@pytest.mark.parametrize("layer", ["conv9", "up1_conv1"])
def test_split_k_layers(card, layer):
    """At batch 2 the deep layers' tiles do not fill the card: K slices and
    the reduce, forward and transposed."""
    h, w, cin, cout = _shapes()[layer]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert V.plan(2, h, w, cin, cout, 3, 1, sms).splits > 1
    before = V.reduce_launches
    _check_forward(*_forward_inputs(2, h, w, cin, cout, seed=3))
    assert V.reduce_launches == before + 2
    g = _gen(4)
    g1 = torch.randn(2, h - 2, w - 2, cout, device="cuda", generator=g)
    g2 = torch.randn(2, h - 2, w - 2, cout, device="cuda", generator=g)
    _check_transposed(g1, g2, 0.1 * torch.randn(3, 3, cin, cout, device="cuda", generator=g))


@pytest.mark.card
@pytest.mark.parametrize("layer,members,batch", [("up4_conv1", 2, 4), ("conv8", 2, 2)])
def test_member_axis(card, layer, members, batch):
    """K members in one launch, each against its own plain version in
    float64; a stride-0 input (one batch for every member) too."""
    h, w, cin, cout = _shapes()[layer]
    mu, sg, w_mu, w_sigma = _forward_inputs(batch, h, w, cin, cout, seed=5, members=members)
    _check_forward(mu, sg, w_mu, w_sigma)
    shared = mu[0].expand(members, *mu.shape[1:])
    shared_s = sg[0].expand(members, *sg.shape[1:])
    with torch.inference_mode():
        got = V.vdp_conv(shared, shared_s, w_mu, w_sigma)
        copied = V.vdp_conv(shared.contiguous(), shared_s.contiguous(), w_mu, w_sigma)
        for g, c in zip(got, copied):
            assert torch.equal(g, c)
    g = _gen(6)
    g1 = torch.randn(members * batch, h - 2, w - 2, cout, device="cuda", generator=g)
    g2 = torch.randn(members * batch, h - 2, w - 2, cout, device="cuda", generator=g)
    _check_transposed(g1, g2, w_mu)


@pytest.mark.card
@pytest.mark.parametrize("layer", ["conv1", "conv5", "up4_conv2"])
def test_bf16_activations_are_the_float32_call_rounded(card, layer):
    """bf16 moments: bit for bit the float32 call on the upcast inputs,
    rounded once (the transposed pair's float32 outputs equal)."""
    h, w, cin, cout = _shapes()[layer]
    mu, sg, w_mu, w_sigma = _forward_inputs(CHUNK, h, w, cin, cout, seed=7)
    mu, sg = mu.to(torch.bfloat16), sg.to(torch.bfloat16)
    with torch.inference_mode():
        got = V.vdp_conv(mu, sg, w_mu, w_sigma, fuse_relu=True)
        ref = V.vdp_conv(mu.float(), sg.float(), w_mu, w_sigma, fuse_relu=True)
        assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.float32
        for g, r in zip(got, ref):
            assert torch.equal(g, r.to(g.dtype))
        g1 = torch.randn(CHUNK, h - 2, w - 2, cout, device="cuda",
                         generator=_gen(8)).to(torch.bfloat16)
        d = V.conv_t_pair(g1, g1, w_mu)
        r = V.conv_t_pair(g1.float(), g1.float(), w_mu)
        assert torch.equal(d[0], r[0]) and torch.equal(d[1], r[1])


@pytest.mark.card
@pytest.mark.parametrize("layer", ["conv1", "conv7", "up3_conv1"])
def test_one_bf16_pass(card, layer):
    """Under "default" the tensor-core calls run one bf16 pass: within 1e-5
    of the max of the plain one pass in float64, forward and transposed."""
    h, w, cin, cout = _shapes()[layer]
    before = V.bf16_launches
    _check_forward(*_forward_inputs(CHUNK, h, w, cin, cout, seed=9), precision="default")
    g = _gen(10)
    g1 = torch.randn(CHUNK, h - 2, w - 2, cout, device="cuda", generator=g)
    g2 = torch.randn(CHUNK, h - 2, w - 2, cout, device="cuda", generator=g)
    _check_transposed(g1, g2, 0.1 * torch.randn(3, 3, cin, cout, device="cuda", generator=g),
                      "default")
    assert V.bf16_launches == before + 3


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("layer,members", [("conv1", None), ("conv9", None), ("up2_conv1", 2)])
def test_weight_planes_are_their_plain_version(card, layer, precision, members):
    """The prologue's planes, forward and flipped for the transposed pair,
    bit for bit ``split_weight_planes_plain``'s."""
    h, w, cin, cout = _shapes()[layer]
    mu, sg, w_mu, w_sigma = _forward_inputs(2, h, w, cin, cout, seed=11, members=members)
    k_n = 1 if members is None else members
    for flip in (False, True):
        if flip:  # the transposed pair's operands: cout channels in, cin out
            b = mu.shape[-4]
            x = torch.randn(mu.shape[:-3] + (h, w, cout), device="cuda", generator=_gen(12))
            sig, n_out = x.abs(), cin
            p = V.plan(b, h, w, cout, cin, 3, k_n, precision=precision)
        else:
            x, sig, n_out = mu, sg, cout
            p = V.plan(mu.shape[-4], h, w, cin, cout, 3, k_n, precision=precision)
        assert p.path == "wgmma"
        planes = torch.full((p.planes_bytes // 4,), -1, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            V._launch(x, sig, w_mu, None if flip else w_sigma, False, precision=precision,
                      flip=flip, planes=planes)
        want = V.split_weight_planes_plain(w_mu.cpu(), p.tile_n, precision, flip=flip)
        assert want.numel() == planes.numel()
        assert torch.equal(planes.cpu(), want.reshape(-1)), (flip, n_out)


@pytest.mark.card
def test_one_prologue_per_tensor_core_call(card):
    """A BraTS forward and backward at batch 2: ``weight_plane_launches``
    and ``kernel1.weight_planes`` count one prologue per tensor-core call,
    forward and transposed, and equal ``kernel1.path.wgmma``."""
    import math

    from supernet_tpu_torch import train
    from supernet_tpu_torch.configs import BRATS as EXP
    from supernet_tpu_torch.models import init_params

    cfg = EXP.model
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for p in params.values():
        k, _, cin, _ = p["w_mu"].shape
        p["w_mu"] *= math.sqrt(2.0 / (k * k * cin)) / p["w_mu"].std()
    params = {n: {k: t.to("cuda").requires_grad_() for k, t in ws.items()}
              for n, ws in params.items()}
    g = _gen(13)
    x = torch.randn(2, cfg.image_size, cfg.image_size, cfg.in_channels, device="cuda",
                    generator=g)
    y = torch.randint(0, cfg.n_classes, (2, cfg.out_size, cfg.out_size), device="cuda",
                      generator=g)
    tracing.reset()
    before = (V.weight_plane_launches, V.launches, V.dgrad_launches)
    loss, _ = train.loss_fn(params, x, y, cfg, EXP.train)
    torch.autograd.grad(loss, train.leaves(params))
    torch.cuda.synchronize()
    c = tracing.counters()
    calls = V.launches - before[1] + V.dgrad_launches - before[2]
    # every k=3 conv but conv_input on the tensor cores, forward and
    # transposed (conv_input's input needs no gradient)
    assert c["kernel1.path.wgmma"] + c["kernel1.path.simt"] == calls
    assert c["kernel1.path.wgmma"] >= 2 * (sum(1 for _, k, _, _ in layer_names(cfg)
                                               if k == 3) - 1)
    assert c["kernel1.weight_planes"] == c["kernel1.path.wgmma"]
    assert V.weight_plane_launches - before[0] == c["kernel1.path.wgmma"]
    assert c["vdp_conv.weight_plane_launches"] == V.weight_plane_launches
