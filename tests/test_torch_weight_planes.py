"""Kernel 1's weight planes on the CPU: ``split_weight_planes_plain``, the
plain version of the tensor-core path's prologue
(``csrc/vdp_conv.cuh:vdp_conv_kernel_weight_planes``), which converts a
call's weights once into the K-major core matrices the wgmma B descriptor
reads. Its layout (member, chunk, tap, N tile, plane, word), the 3xTF32
halves (each exact in TF32, big + small within 2^-22 of w and of w^2), the
one bf16 pass's pairs, the zero columns past Cout, and the flipped form the
transposed pair reads in place. The prologue itself is held bit for bit
against this version on the card (``chip_smoke.py`` phase 2,
``tests/test_torch_kernel1_card.py``)."""

import numpy as np
import pytest
import torch

from supernet_tpu_torch.ops.kernels import vdp_conv as V


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the test workers share the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(cin, cout, members=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (3, 3, cin, cout) if members is None else (members, 3, 3, cin, cout)
    return torch.from_numpy((0.3 * rng.normal(0, 1, shape)).astype(np.float32))


def _floats(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.float32).astype(np.float64)


def _word_rows_cols(tile_n: int, bf16: bool):
    """(k, n) of each word of one operand, by the descriptor's layout."""
    e = np.arange(8 * tile_n)
    n = 8 * (e >> 6) + ((e >> 2) & 7)
    k = 8 * ((e >> 5) & 1) + 2 * (e & 3) if bf16 else 4 * ((e >> 5) & 1) + (e & 3)
    return k, n


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("cin,cout,tile_n", [(16, 32, 32), (32, 64, 64), (32, 40, 32)])
def test_layout_step_tap_tile_to_offset(precision, cin, cout, tile_n):
    """Word e of plane 0 in set (chunk, tap, N tile) holds w[dy, dx,
    chunk kK + k(e), tile tile_n + n(e)] (its TF32 big half, or the bf16
    pair of rows k(e), k(e) + 1), 0 past Cout; the flat offset of a step's
    block is ((chunk 9 + tap) n_tiles + tile) planes 8 tile_n words."""
    bf16 = precision == "default"
    w = _w(cin, cout)
    got = V.split_weight_planes_plain(w, tile_n, precision)
    kk = V.TC_CHUNK_BF16 if bf16 else V.TC_CHUNK
    chunks, n_tiles, planes = cin // kk, -(-cout // tile_n), 2 if bf16 else 4
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.shape == (1, chunks, 9, n_tiles, planes, 8 * tile_n)
    p = V.plan(2, 12, 12, cin, cout, 3, precision=precision)
    assert p.path == "wgmma" and p.planes_bytes == 4 * got.numel()
    flat = got.reshape(-1)
    k, n = _word_rows_cols(tile_n, bf16)
    for chunk in range(chunks):
        for tap in range(9):
            for t in range(n_tiles):
                off = ((chunk * 9 + tap) * n_tiles + t) * planes * 8 * tile_n
                block = flat[off:off + 8 * tile_n]
                assert torch.equal(block, got[0, chunk, tap, t, 0])
                col = t * tile_n + n
                ok = col < cout
                dy, dx = divmod(tap, 3)
                src = np.zeros(8 * tile_n, np.float32)
                src[ok] = w[dy, dx, chunk * kk + k[ok], col[ok]].numpy()
                if bf16:
                    lo = block.numpy().view(np.uint32) & 0xFFFF
                    want = torch.from_numpy(src).to(torch.bfloat16).view(torch.int16)
                    assert np.array_equal(lo, want.numpy().view(np.uint16).astype(np.uint32))
                else:
                    big = _floats(block)
                    assert np.all(np.abs(big - src) <= np.abs(src) * 2.0 ** -11)
                    assert np.all(big[~ok] == 0)


@pytest.mark.parametrize("cin,cout", [(8, 32), (64, 64), (24, 40)])
def test_tf32_halves_are_exact_and_reconstruct_w_and_its_square(cin, cout):
    """3xTF32: the four planes are w's big and small halves and w^2's
    (squared in float32 first), each exact in TF32 (the low 13 bits 0), big
    + small within 2^-22 of the value."""
    w = _w(cin, cout, seed=cin)
    got = V.split_weight_planes_plain(w, 32 if cout <= 32 else 64)
    bits = got.numpy().view(np.uint32)
    assert not (bits & 0x1FFF).any()
    tile_n = got.shape[-1] // 8
    k, n = _word_rows_cols(tile_n, False)
    kk = V.TC_CHUNK
    x = np.zeros(got.shape[:4] + (8 * tile_n,), np.float32)
    wn = w.numpy()
    for chunk in range(got.shape[1]):
        for tap in range(9):
            for t in range(got.shape[3]):
                col = t * tile_n + n
                ok = col < cout
                x[0, chunk, tap, t, ok] = wn[tap // 3, tap % 3, chunk * kk + k[ok], col[ok]]
    f = _floats(got)
    x64 = x.astype(np.float64)
    for big, small, value in ((f[..., 0, :], f[..., 1, :], x64), (f[..., 2, :], f[..., 3, :],
                                                                 x64 * x64)):
        assert np.all(np.abs(big + small - value) <= np.abs(value) * 2.0 ** -22)
        assert np.all(np.abs(small) <= np.abs(value) * 2.0 ** -10)
    # the halves the kernel's split gives: big the nearest TF32 (ties away)
    t = torch.from_numpy(x.reshape(-1))
    big, small = V._tf32_split(t)
    assert torch.equal(big, got[..., 0, :].reshape(-1))
    assert torch.equal(small, got[..., 1, :].reshape(-1))
    # w^2: the split of the float32 square, its residual taken in float32
    big, small = V._tf32_split(t * t)
    assert torch.equal(big, got[..., 2, :].reshape(-1))
    assert torch.equal(small, got[..., 3, :].reshape(-1))


def test_tf32_rounding_ties_away_from_zero():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 0.0, -0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 0.0, -0.0])
    big, small = V._tf32_split(x)
    assert torch.equal(big.view(torch.float32), want)
    assert torch.equal(small.view(torch.float32) + big.view(torch.float32), x)


def test_bf16_planes_pack_both_rows_in_one_pass():
    """One bf16 pass: each word holds rows k and k + 1 of one column, the
    lower row in the low half, rounded to nearest even; the second plane is
    w^2 squared in float32 and then rounded."""
    w = _w(32, 64, seed=3)
    got = V.split_weight_planes_plain(w, 64, "default")
    assert got.shape == (1, 2, 9, 1, 2, 512)
    k, n = _word_rows_cols(64, True)
    wn = w.numpy()
    for chunk in range(2):
        for tap in range(9):
            rows = wn[tap // 3, tap % 3, chunk * 16:(chunk + 1) * 16]
            for plane, src in ((0, rows), (1, rows * rows)):
                words = got[0, chunk, tap, 0, plane].numpy().view(np.uint32)
                lo = torch.from_numpy(src[k, n]).to(torch.bfloat16).view(torch.int16)
                hi = torch.from_numpy(src[k + 1, n]).to(torch.bfloat16).view(torch.int16)
                assert np.array_equal(words & 0xFFFF, lo.numpy().view(np.uint16))
                assert np.array_equal(words >> 16, hi.numpy().view(np.uint16))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("members", [None, 2])
def test_flipped_form_reads_the_forward_weights_in_place(precision, members):
    """The transposed pair's call reads the forward's w_mu [3,3,Cin,Cout]
    in place: its planes equal those of the flipped, transposed weights
    ``dgrad_operands`` forms ([3,3,Cout,Cin]); stacked members alike."""
    w = _w(48, 32, members, seed=7)
    flipped = V._flipped(w)
    assert flipped.shape[-2:] == (32, 48)
    got = V.split_weight_planes_plain(w, 64, precision, flip=True)
    want = V.split_weight_planes_plain(flipped, 64, precision)
    assert torch.equal(got, want)
    _, _, wd = V.dgrad_operands(torch.zeros(1, 4, 4, 32), None, w)
    assert torch.equal(wd, flipped)


def test_members_stack_their_planes():
    w = _w(16, 32, 3, seed=9)
    got = V.split_weight_planes_plain(w, 32)
    assert got.shape[0] == 3
    for m in range(3):
        assert torch.equal(got[m:m + 1], V.split_weight_planes_plain(w[m], 32))
    p = V.plan(2, 10, 10, 16, 32, 3, members=3)
    assert p.planes_bytes == 4 * got.numel()


def test_refuses_what_the_tensor_cores_do_not_take():
    with pytest.raises(ValueError):
        V.split_weight_planes_plain(torch.zeros(2, 2, 16, 32), 32)
    with pytest.raises(ValueError):
        V.split_weight_planes_plain(torch.zeros(3, 3, 24, 32), 32, "default")
