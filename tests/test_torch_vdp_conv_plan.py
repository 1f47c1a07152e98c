"""The fused VDP conv's tensor-core path on the CPU: the planner that picks
the path, tile and K slices for every layer shape of both configs (at
float32 accuracy and in one bf16 pass), the 2-D tiles of output pixels and
their halos as the kernel indexes them, a numpy emulation of TF32 rounding
that shows why the path computes in 3xTF32, and the path's arithmetic
(3xTF32 split products, per-chunk promotion of the mu sum, the window sum
from the patch fragments; under "default" exact bf16 products folded per
chunk of 16 channels) emulated in numpy against the JAX package's Pallas
kernel in interpret mode. The CUDA kernels themselves are held against the
plain version, and against float64, on the card by chip_smoke.py."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supernet_tpu.ops.pallas import vdp_conv as jvdp_conv  # noqa: E402
from supernet_tpu_torch import profiling  # noqa: E402
from supernet_tpu_torch.configs import get_config  # noqa: E402
from supernet_tpu_torch.models import layer_names  # noqa: E402
from supernet_tpu_torch.ops.kernels import vdp_conv  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores, and torch's own thread pool in each of them only contends
    (a tiny float64 gradcheck ran 100x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCH = {"hippocampus": 20, "brats": 2}  # the batches chip_smoke.py drives
LAYERS = [(c, name) for c in BATCH
          for name, k, _, _ in layer_names(get_config(c).model) if k == 3]
F64_TOL = 1e-5  # chip_smoke.py's VDP_F64_TOL: float32 accuracy


@functools.lru_cache(maxsize=None)
def _conv_inputs(config):
    """{layer: (h, w, cin, cout)} from the stage taps of one CPU forward,
    as chip_smoke.py reads them."""
    convs, _ = profiling.layer_shapes(get_config(config).model)
    return {name: (h, w, cin, cout) for name, (_, h, w, cin), cout in convs}


def _m_tiles(b, ho, wo, p):
    """The M tiles of one member: ``p``'s 2-D tiles of each image."""
    return b * -(-ho // p.tile_h) * -(-wo // p.tile_w)


def _tile_ok(p, ho, wo):
    """A tensor-core plan's tile: :func:`vdp_conv.tc_tile`'s, at most 64
    pixels of at most ``ho`` rows, its halo within the kernel's shared
    memory."""
    assert (p.tile_h, p.tile_w) == vdp_conv.tc_tile(ho, wo)
    assert 1 <= p.tile_h <= ho and p.tile_h * p.tile_w <= vdp_conv.TC_TILE_M
    assert (p.tile_h + 2) * (p.tile_w + 2) <= vdp_conv.TC_MAX_HALO


def _planes_bytes(members, cin, cout, tile_n, bf16):
    """Four TF32 planes of the weights (16 bytes a weight), or two planes of
    bf16 pairs (4 bytes a weight), the columns padded to whole N tiles."""
    n_pad = -(-cout // tile_n) * tile_n
    return members * 9 * cin * n_pad * (4 if bf16 else 16)


def _split_cap(cin, m, cout):
    """The most K slices the planner may take for this shape."""
    chunks = cin // vdp_conv.TC_CHUNK
    ok = [s for s in range(1, min(chunks, vdp_conv.MAX_SPLITS) + 1)
          if chunks % s == 0
          and 4 * s * m * (2 * cout + 1) <= vdp_conv.MAX_SCRATCH_BYTES]
    return max(ok)


@pytest.mark.parametrize("config,layer", LAYERS)
def test_plan_every_layer(config, layer):
    h, w, cin, cout = _conv_inputs(config)[layer]
    b = BATCH[config]
    p = vdp_conv.plan(b, h, w, cin, cout, 3)
    if layer == "conv_input":
        assert p.path == "simt" and p.splits == 1 and p.scratch_bytes == 0
        return
    assert p.path == "wgmma"
    assert p.tile_n == (32 if cout <= 32 else 64)
    assert p.tile_m == vdp_conv.TC_TILE_M
    _tile_ok(p, h - 2, w - 2)
    assert p.planes_bytes == _planes_bytes(1, cin, cout, p.tile_n, False)
    m = b * (h - 2) * (w - 2)
    tiles = _m_tiles(b, h - 2, w - 2, p) * -(-cout // p.tile_n)
    assert p.blocks == tiles * p.splits
    chunks = cin // vdp_conv.TC_CHUNK
    assert chunks % p.splits == 0
    # TC_BLOCKS_PER_SM blocks per SM of the card, or as many slices as the
    # shape allows
    wave = vdp_conv.TC_BLOCKS_PER_SM * vdp_conv.SMS
    assert p.blocks >= wave or p.splits == _split_cap(cin, m, cout)
    # the fewest slices that reach it
    if p.splits > 1:
        assert tiles * max(s for s in range(1, p.splits)
                           if chunks % s == 0) < wave
        assert p.scratch_bytes == 4 * p.splits * m * (2 * cout + 1)
        assert p.scratch_bytes <= vdp_conv.MAX_SCRATCH_BYTES
    else:
        assert p.scratch_bytes == 0


@pytest.mark.parametrize("config,layer", LAYERS)
def test_plan_default_every_layer(config, layer):
    """Under "default" every k=3 layer but conv_input (Cin 1 or 4) and every
    transposed shape but conv_input's input gradient (Cout 1 or 4) takes the
    one-bf16-pass tensor-core path: every Cin and Cout of both models past
    the first layer is a multiple of 16. Its K slices divide the Cin/16
    chunks and fill the card as the 3xTF32 plan's do; "high" plans as
    "highest"."""
    h, w, cin, cout = _conv_inputs(config)[layer]
    b = BATCH[config]
    for shape in ((b, h, w, cin, cout), (b, h + 2, w + 2, cout, cin)):  # forward, transposed
        p = vdp_conv.plan(*shape, 3, precision="default")
        hi = vdp_conv.plan(*shape, 3)
        assert vdp_conv.plan(*shape, 3, precision="high") == hi
        if layer == "conv_input":  # Cin (forward) or Cout (transposed) 1 or 4
            assert p.path == "simt" and p.bf16 and p == hi._replace(bf16=True)
            continue
        pb, ph, pw, pc, po = shape
        assert pc % vdp_conv.TC_CHUNK_BF16 == 0
        assert (p.path, p.tile_m, p.tile_n, p.bf16) == ("wgmma", hi.tile_m, hi.tile_n, True)
        assert (p.tile_h, p.tile_w) == (hi.tile_h, hi.tile_w)
        assert not hi.bf16
        assert p.planes_bytes == _planes_bytes(1, pc, po, p.tile_n, True)
        m = pb * (ph - 2) * (pw - 2)
        tiles = _m_tiles(pb, ph - 2, pw - 2, p) * -(-po // p.tile_n)
        chunks = pc // vdp_conv.TC_CHUNK_BF16
        assert chunks % p.splits == 0 and p.blocks == tiles * p.splits
        cap = max(s for s in range(1, min(chunks, vdp_conv.MAX_SPLITS) + 1)
                  if chunks % s == 0
                  and 4 * s * m * (2 * po + 1) <= vdp_conv.MAX_SCRATCH_BYTES)
        wave = vdp_conv.TC_BLOCKS_PER_SM * vdp_conv.SMS
        assert p.blocks >= wave or p.splits == cap
        if p.splits > 1:
            assert tiles * max(s for s in range(1, p.splits) if chunks % s == 0) < wave
            assert p.scratch_bytes == 4 * p.splits * m * (2 * po + 1)


def _route(p):
    """A plan's path and whether it runs one bf16 pass."""
    return p.path, p.bf16


def test_plan_default_cin_not_a_multiple_of_16_takes_the_cuda_cores():
    """Cin = 24 is a multiple of 8 (3xTF32 on the tensor cores) but not of 16:
    under "default" the CUDA-core kernel rounds its operands instead."""
    assert _route(vdp_conv.plan(2, 12, 12, 24, 32, 3)) == ("wgmma", False)
    assert _route(vdp_conv.plan(2, 12, 12, 24, 32, 3, precision="default")) == ("simt", True)
    assert _route(vdp_conv.plan(2, 12, 12, 32, 32, 3, precision="default")) == ("wgmma", True)


MEMBERS = {"hippocampus": 4, "brats": 2}  # the ensembles chip_smoke.py drives


def _split_cap_members(cin, m, cout, members):
    """The most K slices the planner may take for ``members`` members."""
    chunks = cin // vdp_conv.TC_CHUNK
    return max(s for s in range(1, min(chunks, vdp_conv.MAX_SPLITS) + 1)
               if chunks % s == 0 and members * s <= vdp_conv.MAX_GRID_Z
               and 4 * members * s * m * (2 * cout + 1) <= vdp_conv.MAX_SCRATCH_BYTES)


@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
@pytest.mark.parametrize("config,layer", LAYERS)
def test_plan_members_every_layer(config, layer, sms):
    """The member axis: ``members=1`` on 132 SMs is the plan of the shape
    alone; with K members the M tiles are counted per member, so that the
    kernel's blocks (member = blockIdx.z // splits, a tile_h x tile_w tile
    of one image of that member) write every output pixel of every member
    exactly once; the scratch of K x S partials stays within
    MAX_SCRATCH_BYTES; the slices give TC_BLOCKS_PER_SM blocks per SM of
    ``sms`` SMs with as few
    slices as that takes."""
    h, w, cin, cout = _conv_inputs(config)[layer]
    b, members = BATCH[config], MEMBERS[config]
    one = vdp_conv.plan(b, h, w, cin, cout, 3, 1, sms)
    if sms == vdp_conv.SMS:
        assert one == vdp_conv.plan(b, h, w, cin, cout, 3)
    p = vdp_conv.plan(b, h, w, cin, cout, 3, members, sms)
    assert (p.path, p.tile_m, p.tile_n) == (one.path, one.tile_m, one.tile_n)
    assert (p.tile_h, p.tile_w) == (one.tile_h, one.tile_w)
    if p.path == "simt":  # one block per tile of one image of one member
        assert p.blocks == members * one.blocks and p.scratch_bytes == 0
        return
    assert p.planes_bytes == members * one.planes_bytes
    ho, wo = h - 2, w - 2
    m = b * ho * wo
    m_tiles, n_tiles = _m_tiles(b, ho, wo, p), -(-cout // p.tile_n)
    assert p.blocks == members * m_tiles * n_tiles * p.splits
    written = np.concatenate([
        member * m + _tile_pixels(bx, b, ho, wo, p.tile_h, p.tile_w)
        for member in range(members) for _ in range(p.splits) for bx in range(m_tiles)])
    counts = np.bincount(written, minlength=members * m)
    assert (counts == p.splits).all()  # each slice once per pixel
    chunks = cin // vdp_conv.TC_CHUNK
    assert chunks % p.splits == 0 and members * p.splits <= vdp_conv.MAX_GRID_Z
    tiles = members * m_tiles * n_tiles
    wave = vdp_conv.TC_BLOCKS_PER_SM * sms
    assert p.blocks >= wave or p.splits == _split_cap_members(cin, m, cout, members)
    if p.splits > 1:
        assert tiles * max(s for s in range(1, p.splits) if chunks % s == 0) < wave
        assert p.scratch_bytes == 4 * members * p.splits * m * (2 * cout + 1)
        assert p.scratch_bytes <= vdp_conv.MAX_SCRATCH_BYTES
    else:
        assert p.scratch_bytes == 0
    assert p.splits <= one.splits  # more members fill the card with fewer slices


def _tile_pixels(bx, b, ho, wo, th, tw):
    """The member's flat output pixels block ``bx`` stores, as the kernel
    indexes them: blockIdx.x = (image, tile row, tile column), rows m = tw
    ty + tx < th tw, those past the image masked."""
    tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
    img, rest = divmod(bx, tiles_h * tiles_w)
    ty_t, tx_t = divmod(rest, tiles_w)
    assert img < b
    r = np.arange(vdp_conv.TC_TILE_M)
    r = r[r < th * tw]
    oy, ox = ty_t * th + r // tw, tx_t * tw + r % tw
    keep = (oy < ho) & (ox < wo)
    return (img * ho + oy[keep]) * wo + ox[keep]


def _halo_patches(x, th, tw):
    """Every output pixel's 3 x 3 x C patch as the tensor-core kernel reads
    it: per block the (th + 2) x (tw + 2) halo of its tile from the source
    offsets it forms once ((hy W + hx) C from the tile's first pixel, -1
    past the image: zero-filled), then at each tap the pixel (ty + dy)
    (tw + 2) + tx + dx of the halo. Returns [B, H', W', 9, C], taps in the
    order 3 dy + dx; every pixel written once."""
    b, h, w, c = x.shape
    ho, wo = h - 2, w - 2
    hw, halo = tw + 2, (th + 2) * (tw + 2)
    flat = x.reshape(-1)
    out = np.full((b, ho, wo, 9, c), np.nan, x.dtype)
    tiles = b * -(-ho // th) * -(-wo // tw)
    for bx in range(tiles):
        tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
        img, rest = divmod(bx, tiles_h * tiles_w)
        oy0, ox0 = (rest // tiles_w) * th, (rest % tiles_w) * tw
        origin = ((img * h + oy0) * w + ox0) * c
        p = np.arange(halo)
        hy, hx = p // hw, p % hw
        off = np.where((oy0 + hy < h) & (ox0 + hx < w), (hy * w + hx) * c, -1)
        tile = np.where(off[:, None] >= 0,
                        flat[origin + np.maximum(off, 0)[:, None] + np.arange(c)], 0)
        for r in range(th * tw):
            ty, tx = divmod(r, tw)
            oy, ox = oy0 + ty, ox0 + tx
            if oy >= ho or ox >= wo:
                continue
            assert np.isnan(out[img, oy, ox]).all()
            for dy in range(3):
                for dx in range(3):
                    out[img, oy, ox, 3 * dy + dx] = tile[(ty + dy) * hw + tx + dx]
    return out


@pytest.mark.parametrize("hw", [(5, 5), (8, 13), (11, 10), (22, 22), (20, 35), (12, 70)])
def test_halo_tiles_gather_every_patch_once(hw):
    """The kernel's index arithmetic (tiles, halo offsets, tap shifts)
    reproduces im2col at the tile :func:`vdp_conv.tc_tile` picks and at the
    other candidate widths: every output pixel's patch, once."""
    h, w = hw
    rng = np.random.default_rng(h * w)
    x = rng.normal(0, 1, (2, h, w, 3)).astype(np.float32)
    ho, wo = h - 2, w - 2
    want = np.stack([x[:, dy:dy + ho, dx:dx + wo] for dy in range(3) for dx in range(3)],
                    axis=3)
    shapes = {vdp_conv.tc_tile(ho, wo), (8, 8), (4, 16), (2, 32), (min(ho, 64 // wo), wo)}
    for th, tw in shapes:
        if th < 1 or (th + 2) * (tw + 2) > vdp_conv.TC_MAX_HALO:
            continue
        np.testing.assert_array_equal(_halo_patches(x, th, tw), want)


@pytest.mark.parametrize("ho", [1, 2, 3, 6, 7, 18, 20, 44, 46, 90, 98, 186, 200])
def test_tc_tile_covers_the_output_with_the_fewest_tiles(ho):
    """The tile fits the kernel (at most 64 pixels, a halo within
    TC_MAX_HALO) and takes no more tiles than any candidate width with its
    most rows; at widths that are multiples of 8 it is 8 x 8."""
    for wo in sorted({ho, 8, 16, 40, 200, max(1, ho // 2)}):
        th, tw = vdp_conv.tc_tile(ho, wo)
        assert 1 <= th <= ho and th * tw <= vdp_conv.TC_TILE_M
        assert (th + 2) * (tw + 2) <= vdp_conv.TC_MAX_HALO
        n = -(-ho // th) * -(-wo // tw)
        for cw in (8, 16, 32) + ((wo,) if wo < 32 else ()):
            ch = min(64 // cw, ho, vdp_conv.TC_MAX_HALO // (cw + 2) - 2)
            assert n <= -(-ho // ch) * -(-wo // cw)
        if ho >= 8 and wo % 8 == 0 and ho % 8 == 0:
            assert (th, tw) == (8, 8)


@pytest.mark.parametrize("layer", ["conv8", "conv9", "up1_conv1"])
def test_plan_splits_the_starved_brats_layers(layer):
    h, w, cin, cout = _conv_inputs("brats")[layer]
    p = vdp_conv.plan(2, h, w, cin, cout, 3)
    assert p.path == "wgmma" and p.splits > 1 and p.blocks >= vdp_conv.SMS


@pytest.mark.parametrize("shape", [
    (4, 33, 29, 24, 40, 2),   # k = 2
    (4, 33, 29, 24, 40, 1),   # k = 1
    (3, 17, 19, 3, 96, 3),    # odd Cin
    (2, 12, 12, 12, 32, 3),   # Cin not a multiple of 8
    (2, 12, 12, 16, 30, 3),   # Cout not a multiple of 4
    (1, 4, 4, 16384, 16384, 3),  # step offsets past an int
    (20, 64, 64, 1, 32, 3),   # the first layer
])
def test_plan_cuda_core_shapes(shape):
    b, h, w, cin, cout, k = shape
    p = vdp_conv.plan(b, h, w, cin, cout, k)
    ct = 64 if cout >= 64 else 32
    assert p.path == "simt" and p.splits == 1 and p.scratch_bytes == 0
    assert p.tile_n == ct
    ho, wo = h - k + 1, w - k + 1
    tw = 8 if ct == 64 else 16
    assert p.blocks == -(-ho // 8) * -(-wo // tw) * -(-cout // ct) * b


def test_aligned_copies_only_a_misaligned_view():
    base = torch.zeros(17)
    assert vdp_conv._aligned(base) is base
    view = base[1:]  # 4 bytes past an aligned start
    out = vdp_conv._aligned(view)
    assert out is not view and out.data_ptr() % 16 == 0
    assert torch.equal(out, view)
    assert vdp_conv._aligned(None) is None


# ------------------------------------------------------------ TF32 emulation


def _tf32(x):
    """Round float32 to the nearest TF32 (10 mantissa bits), ties away from
    zero, as the kernel does (csrc/vdp_conv.cu:round_tf32)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(np.float32(x) - big)


def test_tf32_rounding_and_split():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                  -(1.0 + 2.0 ** -11), 3.0e-3, -7.5e5, 0.0], np.float32)
    # ties round away from zero; exact TF32 values stay
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                     -(1.0 + 2.0 ** -10)], np.float32)
    np.testing.assert_array_equal(_tf32(x[:4]), want)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 10000).astype(np.float32) * np.float32(1e3)
    big, small = _split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.all(np.abs(big - x) <= np.abs(x) * 2.0 ** -11)
    resid = np.abs((big.astype(np.float64) + small) - x)
    assert np.all(resid <= np.abs(x) * 2.0 ** -21)


def _product(a, b, mode):
    """a @ b with float32 accumulation, the operands as the tensor cores
    take them: one TF32 pass, or the three passes of 3xTF32."""
    if mode == "tf32":
        return _tf32(a) @ _tf32(b)
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize("k_dim", [288, 4608])  # hippocampus conv1, BraTS conv9
@pytest.mark.parametrize("mode", ["3xtf32", "tf32"])
def test_3xtf32_reaches_float32_accuracy_and_tf32_does_not(k_dim, mode):
    rng = np.random.default_rng(k_dim)
    a = rng.normal(0, 1, (64, k_dim)).astype(np.float32)
    b = (0.1 * rng.normal(0, 1, (k_dim, 64))).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    err = np.abs(_product(a, b, mode) - want).max() / np.abs(want).max()
    if mode == "3xtf32":
        assert err <= F64_TOL
    else:
        assert err > F64_TOL


# ------------------------------------- the tensor-core path's arithmetic


def _emulate_wgmma_path(mu, sigma, w_mu, w_sigma, fuse_relu):
    """The tensor-core kernel's arithmetic in numpy float32: im2col patches
    with K ordered (chunk of 8 channels, tap, channel), the mu product in
    3xTF32 restarted every chunk and folded into a float32 total, the sigma
    product in 3xTF32 throughout, the window sum over the patches."""
    b, h, w, cin = mu.shape
    cout = w_mu.shape[3]
    ho, wo = h - 2, w - 2

    def patches(x):
        cols = [x[:, dy:dy + ho, dx:dx + wo, c0:c0 + 8]
                for c0 in range(0, cin, 8) for dy in range(3) for dx in range(3)]
        return np.concatenate(cols, axis=-1).reshape(b * ho * wo, 9 * cin)

    wk = np.concatenate([w_mu[dy, dx, c0:c0 + 8]
                         for c0 in range(0, cin, 8)
                         for dy in range(3) for dx in range(3)])
    pm, ps = patches(mu), patches(sigma)
    mu_out = np.zeros((b * ho * wo, cout), np.float32)
    for c in range(0, 9 * cin, 72):
        mu_out += _product(pm[:, c:c + 72], wk[c:c + 72], "3xtf32")
    s2 = _product(ps, wk * wk, "3xtf32")
    win = (pm * pm + ps).sum(-1, keepdims=True, dtype=np.float32)
    sw = np.log1p(np.exp(w_sigma)).astype(np.float32)
    sig_out = win * sw + s2
    if fuse_relu:
        mask = mu_out > 0
        mu_out, sig_out = np.where(mask, mu_out, 0), np.where(mask, sig_out, 0)
    shape = (b, ho, wo)
    return (mu_out.reshape(*shape, cout), sig_out.reshape(*shape, cout),
            win.reshape(*shape, 1))


@pytest.mark.parametrize("cin,cout,fuse_relu", [(16, 32, True), (24, 64, False)])
def test_emulated_wgmma_path_matches_pallas_interpret(cin, cout, fuse_relu):
    rng = np.random.default_rng(cin)
    mu = rng.normal(0, 1, (2, 11, 10, cin)).astype(np.float32)
    sigma = np.abs(rng.normal(0, 1, (2, 11, 10, cin))).astype(np.float32)
    w_mu = (0.3 * rng.normal(0, 1, (3, 3, cin, cout))).astype(np.float32)
    w_sigma = (rng.normal(0, 1, cout) - 5.0).astype(np.float32)
    assert vdp_conv.plan(2, 11, 10, cin, cout, 3).path == "wgmma"
    got = _emulate_wgmma_path(mu, sigma, w_mu, w_sigma, fuse_relu)
    jargs = [jnp.asarray(a) for a in (mu, sigma, w_mu, w_sigma)]
    want = jvdp_conv(*jargs, fuse_relu=fuse_relu, interpret=True)
    for g, r in zip(got[:2], want):
        r = np.asarray(r)
        assert np.abs(g - r).max() <= F64_TOL * np.abs(r).max()
    plain = vdp_conv.vdp_conv_plain(*(torch.from_numpy(a) for a in
                                      (mu, sigma, w_mu, w_sigma)), fuse_relu)
    assert np.abs(got[2] - plain[2].numpy()).max() <= F64_TOL * float(plain[2].abs().max())


# ------------------------------------------------ the one-bf16-pass path


def _bf16(x):
    """float32 rounded to the nearest bf16, ties to even, as the kernel's
    cvt.rn.bf16x2.f32 rounds (finite values)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_bf16_rounding_is_torchs():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 1, 10000).astype(np.float32) * np.float32(1e3),
                        np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0, 0.0],
                                 np.float32)])
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(_bf16(x), want)
    assert _bf16(np.float32(1.0 + 2.0 ** -8)) == 1.0  # a tie goes to even


def _emulate_wgmma_bf16_path(mu, sigma, w_mu, w_sigma, fuse_relu):
    """The one-bf16-pass kernel's arithmetic in numpy: im2col patches with K
    ordered (chunk of 16 channels, tap, channel), the products of bf16
    operands (w^2 squared in float32, then rounded) exact in float64 and
    summed in float32 per chunk (the mu product restarted every chunk and
    folded into a float32 total, the sigma product throughout), the window
    sum over the unrounded patches."""
    b, h, w, cin = mu.shape
    cout = w_mu.shape[3]
    ho, wo = h - 2, w - 2
    c = vdp_conv.TC_CHUNK_BF16

    def patches(x):
        cols = [x[:, dy:dy + ho, dx:dx + wo, c0:c0 + c]
                for c0 in range(0, cin, c) for dy in range(3) for dx in range(3)]
        return np.concatenate(cols, axis=-1).reshape(b * ho * wo, 9 * cin)

    wk = np.concatenate([w_mu[dy, dx, c0:c0 + c]
                         for c0 in range(0, cin, c)
                         for dy in range(3) for dx in range(3)])
    pm, ps = patches(mu), patches(sigma)
    am, asg = _bf16(pm).astype(np.float64), _bf16(ps).astype(np.float64)
    bw, bq = _bf16(wk).astype(np.float64), _bf16(wk * wk).astype(np.float64)
    mu_out = np.zeros((b * ho * wo, cout), np.float32)
    s2 = np.zeros((b * ho * wo, cout), np.float32)
    for k0 in range(0, 9 * cin, 9 * c):
        sl = slice(k0, k0 + 9 * c)
        mu_out += (am[:, sl] @ bw[sl]).astype(np.float32)
        s2 += (asg[:, sl] @ bq[sl]).astype(np.float32)
    win = (pm * pm + ps).sum(-1, keepdims=True, dtype=np.float32)
    sw = np.log1p(np.exp(w_sigma)).astype(np.float32)
    sig_out = win * sw + s2
    if fuse_relu:
        mask = mu_out > 0
        mu_out, sig_out = np.where(mask, mu_out, 0), np.where(mask, sig_out, 0)
    shape = (b, ho, wo)
    return (mu_out.reshape(*shape, cout), sig_out.reshape(*shape, cout),
            win.reshape(*shape, 1))


@pytest.mark.parametrize("cin,cout,fuse_relu", [(16, 32, True), (32, 64, False)])
def test_emulated_wgmma_bf16_path_matches_pallas_on_rounded_operands(cin, cout, fuse_relu):
    """The one-pass emulation against the JAX package's conv on
    bf16-rounded operands with the Pallas kernel's unrounded window sum (as
    tests/test_torch_precision.py holds the plain version), and against the
    plain version under "default", within F64_TOL of the max."""
    from supernet_tpu.ops.pallas.vdp_conv import _conv, _pallas_forward

    rng = np.random.default_rng(cin + 1)
    mu = rng.normal(0, 1, (2, 11, 10, cin)).astype(np.float32)
    sigma = np.abs(rng.normal(0, 1, (2, 11, 10, cin))).astype(np.float32)
    w_mu = (0.3 * rng.normal(0, 1, (3, 3, cin, cout))).astype(np.float32)
    w_sigma = (rng.normal(0, 1, cout) - 5.0).astype(np.float32)
    assert _route(vdp_conv.plan(2, 11, 10, cin, cout, 3, precision="default")) == ("wgmma", True)
    got = _emulate_wgmma_bf16_path(mu, sigma, w_mu, w_sigma, fuse_relu)
    jm, js, jw, jws = (jnp.asarray(a) for a in (mu, sigma, w_mu, w_sigma))
    _, _, win = _pallas_forward(jm, js, jw, jws, fuse_relu=False, precision="highest",
                                interpret=True)
    want_mu = np.asarray(_conv(jnp.asarray(_bf16(mu)), jnp.asarray(_bf16(w_mu)),
                               "VALID", "highest"))
    want_sig = np.asarray(win * jnp.log1p(jnp.exp(jws)) + _conv(
        jnp.asarray(_bf16(sigma)), jnp.asarray(_bf16(w_mu * w_mu)), "VALID", "highest"))
    if fuse_relu:
        mask = want_mu > 0
        want_mu, want_sig = np.where(mask, want_mu, 0), np.where(mask, want_sig, 0)
    for g, r in zip(got, (want_mu, want_sig, np.asarray(win))):
        assert np.abs(g - r).max() <= F64_TOL * np.abs(r).max()
    plain = vdp_conv.vdp_conv_plain(*(torch.from_numpy(a) for a in
                                      (mu, sigma, w_mu, w_sigma)), fuse_relu,
                                    precision="default")
    for g, p in zip(got, plain):
        assert np.abs(g - p.numpy()).max() <= F64_TOL * float(p.abs().max())


def test_cpu_tensors_never_count_a_launch():
    vdp_conv.launches = vdp_conv.reduce_launches = 0
    x = torch.ones(1, 6, 6, 8)
    vdp_conv.vdp_conv(x, x, torch.ones(3, 3, 8, 8), torch.zeros(8), True)
    assert vdp_conv.launches == 0 and vdp_conv.reduce_launches == 0


@pytest.mark.parametrize("config,n", [("hippocampus", 10), ("brats", 18)])
def test_layer_shapes_and_bounds(config, n):
    convs, pools = profiling.layer_shapes(get_config(config).model)
    assert len(convs) == n and len(pools) == get_config(config).model.depth - 1
    for name, (_, h, w, cin), cout in convs:
        bd = profiling.vdp_conv_bounds(BATCH[config], h, w, cin, cout, 3,
                                       name != "conv_input")
        assert bd["bound_3xtf32_ms"] <= bd["bound_ms"]
        assert bd["bound_ms"] == max(bd["bytes_ms"], bd["f32_ms"])
