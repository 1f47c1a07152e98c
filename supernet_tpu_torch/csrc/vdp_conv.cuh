// Fused VDP convolution forward for Hopper, sm_90a: the kernels, compiled
// twice. vdp_conv.cu instantiates them at float32 accuracy and holds the C
// entry point; vdp_conv_bf16.cu instantiates them in one bf16 pass. Two
// sources, so that nvcc builds the two halves at once.
//
// Replaces supernet_tpu/ops/pallas/vdp_conv.py:_kernel (launched by
// _pallas_forward). In one pass over (mu, sigma) it computes, per output
// pixel and channel, with VALID padding and stride 1:
//   mu_out  = conv(mu, w_mu)
//   win     = k x k window sum of sum_c(mu^2 + sigma)   (sum_c mu^2 without sigma)
//   sig_out = win * sw + conv(sigma, w_mu^2)            (sw = softplus(w_sigma))
//   optional ReLU: where mu_out > 0 is false, both outputs are 0
// and writes win [B, H', W', 1] as well, the backward residual of the
// training slice.
//
// Without the window sum (win = 0 in the C entry) a call computes
//   mu_out  = conv(mu, w_mu)        sig_out = conv(sigma, w_mu^2)
// and neither forms nor writes win. VDPConv's backward runs its two
// transposed convolutions so (ops/kernels/vdp_conv.py:conv_t_pair): a VALID
// stride-1 transposed conv of g is the VALID conv of g padded by k - 1 with
// the weights flipped in both spatial axes and Cin, Cout swapped, so
// mu = pad(g1), sigma = pad(g2) and w = flip(w_mu)^T give convT(g1, w_mu) and
// convT(g2, w_mu^2) in one launch, at the precision of the forward.
//
// Precision (the template flag BF; SUPERNET_PRECISION through
// ops/kernels/vdp_conv.py). The Pallas kernel passes the global precision
// into its two MXU dots (vdp_conv.py:108-121): "default" rounds both
// operands of each product to bf16 and sums in float32, "high" and
// "highest" compute in float32 (Mosaic rounds "high" up). So here:
// - BF false ("high", "highest"): float32 accuracy, the exact float32 of
//   the CUDA cores or 3xTF32 on the tensor cores (below).
// - BF true ("default"): one bf16 pass. The products' operands mu, sigma,
//   w_mu and w_mu^2 are rounded to bf16 (to nearest even; w_mu^2 is squared
//   in float32 first, as the reference squares before its dot), so every
//   product is exact in float32, and the sums run in float32. The window
//   sum is no dot in the reference (a sum on the vector unit): it is taken
//   from the unrounded values, and win * sw and the ReLU on the float32
//   mu_out stay as they are.
//
// What bounds it: arithmetic. Each output costs 2 k^2 Cin multiply-adds (one
// for each product) against a few bytes of input that every neighbouring
// output shares. The CUDA cores' float32 rate is 67 TFLOP/s; the tensor
// cores' TF32 rate is 495, their bf16 rate 989. Two paths, chosen by shape
// and precision in ops/kernels/vdp_conv.py:plan:
//
// Tensor-core path (k = 3, Cin % 8 == 0 at float32 accuracy, Cin % 16 == 0
// in one bf16 pass, Cout % 4 == 0): an implicit GEMM, M = output pixels
// (the batch folded in), N = Cout, K = 9 Cin, both products in one block on
// the same M x K patches. Each operand is converted once, not once per tap:
// only fragment loads, wgmmas and the chunk fold run at every K step.
// - 3xTF32: every operand x is split into big = tf32(x) and small =
//   tf32(x - big), both rounded to nearest (the tensor core itself would
//   drop the low 13 bits), and each product accumulates
//   a_small b_big + a_big b_small + a_big b_big in float32. That keeps
//   float32 accuracy at a third of the TF32 rate, 165 TFLOP/s; single-pass
//   TF32 errs by about 1e-4 of the output's max at K = 4608.
//   wgmma.m64nNk8.f32.tf32.tf32, one K step = one tap x 8 input channels,
//   six wgmmas per step (three per product).
// - One bf16 pass: wgmma.m64nNk16.f32.bf16.bf16, one K step = one tap x 16
//   input channels, two wgmmas per step (one per product). The A fragments
//   are the inputs packed to bf16x2 (cvt.rn.bf16x2.f32; a bf16 input is
//   packed already), the window sum taken from the unrounded values. B is
//   w_mu and w_mu^2 rounded to bf16: half the bytes of one TF32 half and no
//   split.
// - The tensor cores add into their float32 accumulator with truncation, so
//   the mu product, whose terms cancel, restarts its accumulator every
//   chunk of 9 taps (72 K values in 3xTF32, 144 in one bf16 pass) and folds
//   it into a float32 total.
// - The weights are converted once per call. A prologue kernel,
//   vdp_conv_kernel_weight_planes, launched from the same entry on the same
//   stream, writes them into device scratch in the layout the wgmma B
//   descriptor reads: K-major core matrices of one step (kK channels of one
//   tap) x one N tile, 3xTF32 in four planes (w big, w small, w^2 big, w^2
//   small; w^2 squared in float32 first), one bf16 pass in two (w, w^2),
//   each step's planes one contiguous block, ordered (member, chunk, tap, N
//   tile). For the transposed pair it reads the forward's w_mu in place,
//   its taps mirrored and Cin, Cout swapped. The main loop converts
//   nothing: one thread copies each step's block into a ring of kStages
//   slots with one bulk copy (cp.async.bulk), whose bytes complete the
//   slot's mbarrier.
// - The activations are converted once per chunk. One warpgroup per block
//   of a 2-D tile of TH x TW output pixels of one image (TH TW <= 64, wgmma's
//   M; plan picks the shape from the output's width) x N channels (N = 32
//   or 64). Each chunk of kK input channels is copied once (cp.async) as the
//   tile's (TH + 2) x (TW + 2) halo of mu and sigma, pixels past the image
//   zero-filled, and split there once into the fragments' form (3xTF32: big
//   and small halves; one bf16 pass: bf16x2), in the same pass that adds the
//   chunk's mu^2 + sigma into a per-pixel channel sum. At each tap a thread
//   loads its A fragments from that tile at the tap's (dy, dx) offset, two
//   16-byte loads per row pair. Rows past the tile or the image are masked
//   at the store.
// - The window sum is taken once per output pixel, after the last chunk, as
//   the 3 x 3 window of the per-pixel channel sums.
// - No barrier within a chunk: step s waits for its slot's mbarrier, starts
//   on the tensor cores, and once step s - 1's wgmmas are done its slot
//   takes the copy of step s + kStages - 1 and the other register buffer
//   step s + 1's fragments. At a chunk's last tap the next chunk's halo,
//   copied during the chunk, is split while the tensor cores run (two
//   barriers a chunk), and the halo after it starts on its way.
// - Split-K: where the M x N tiles alone give fewer than two blocks per SM
//   of the card (the deep layers; plan's TC_BLOCKS_PER_SM), the Cin chunks are cut
//   into S slices, one block each. Each slice writes float32 partials of
//   both products and of its window sum to a scratch buffer [S, M, Cout] x 2
//   + [S, M], and vdp_conv_kernel_splitk_reduce sums the slices in fixed
//   order (no atomics: deterministic), adds win * sw, applies the ReLU and
//   writes the three outputs.
// An output's products depend on its splits, the K order and the fold
// points alone, not on the tile that holds it, so mu_out and the transposed
// pair's outputs are the same bits for any tile shape of one K slicing.
// What bounds it now is the wgmma chain itself and the chunk boundary: a
// step's six small wgmmas (m64n32k8 or m64n64k8 into two accumulators) run
// at about half the TF32 rate even with every load, split and barrier taken
// out, and at each chunk's end the block drains them to fold mu and split
// the next halo; other resident blocks fill that gap (PERF.md, section 6).
//
// CUDA-core path (everything else: the first layer's Cin of 1 or 4, k != 3,
// Cin not a multiple of the tensor cores' step), float32 products and sums;
// in one bf16 pass each product's operand is rounded to bf16 as it is read:
// - one block per (tile of output pixels, tile of CT output channels, image);
// - Cin is walked in chunks of kChunk channels. Each chunk stages its halo
//   tile of mu and sigma, and its k x k x kChunk x CT slice of w_mu, in
//   shared memory; w_mu^2 is formed in registers as each weight is read;
// - each of the 256 threads keeps a 4-pixel x 4-channel register tile of
//   both products in float32. Neighbouring threads take neighbouring output
//   channels, so with HWIO weights they read neighbouring words;
// - the window sum is shared by every output channel, so it is not computed
//   per channel: each chunk adds its channels' mu^2 (+ sigma) into one
//   per-pixel sum in shared memory, and the k x k window of that sum is taken
//   once per output pixel before the epilogue. In one bf16 pass the staged
//   tile is rounded after that sum has read it.
// Every offset into the activations and weights is 64-bit.
//
// Member axis (a deep ensemble's K parameter sets in one launch, the
// counterpart of jax.vmap over the Pallas call): w_mu [K, k, k, Cin, Cout],
// sw [K, Cout], and mu, sigma [K, B, H, W, Cin] with a member stride of their
// own, B H W Cin for per-member inputs or 0 for one batch that every member
// reads (no copy is made); the outputs are [K B, H', W', ...], member-major.
// The grid gains the member as its outermost coordinate: the CUDA-core path
// takes it with the image (blockIdx.z = member B + image), the tensor-core
// path with the K slice (blockIdx.z = member S + slice). An output tile is
// counted per member (its M is B H' W'), so a tile never holds pixels of two
// members, and the split-K scratch holds one [S, M, Cout] x 2 + [S, M] block
// per member.
//
// Dtypes (csrc/dtype.cuh). mu and sigma are float32 or bf16, one dtype for
// both; w_mu and sw are float32. Every sum runs in float32 on the loaded
// values, which a bf16 value converts to exactly. With the window sum,
// mu_out and sig_out come out in the input's dtype, each rounded once as it
// is stored (to nearest even, as torch's .to(bfloat16) rounds), and win in
// float32, the backward's residual. Without it (the transposed pair) the
// outputs are float32: they feed sums that VDPConv keeps in float32. With
// the ReLU a caller may ask for its mask, mu_out > 0 in float32 before the
// rounding, as bytes: a positive mu_out below bf16's least subnormal rounds
// to 0, so the mask cannot be read back from a bf16 mu_out. The TPU kernel
// computes in float32 behind a cast at its wrapper (vdp_conv.py:460-477);
// here the conversions happen in the loads and the stores. At float32
// accuracy a bf16 patch staged in shared memory converts at the fragment
// split; its value fits TF32, so the small half of its 3xTF32 split is 0 and
// the products and sums are those of the float32 kernel on the same values,
// in the same order: the plan is the float32 plan (the shape alone picks
// it), and only the staging (16 bytes carry the 8 channels of a K step) and
// the stores differ. In one bf16 pass a bf16 input is already the operand.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "dtype.cuh"

namespace supernet {
namespace vdp {

// The pointers of one call, the member strides and count (in elements).
// Tensor-core path: planes, the weight planes' scratch; th x tw, the tile of
// output pixels; flip, w_mu is the forward weights of the conv whose
// transposed pair this call computes.
struct Args {
  const void *mu, *sigma;
  const float *w_mu, *sw;
  void *mu_out, *sig_out;
  float *win, *part;
  uint32_t* planes;
  uint8_t* mask;
  int B, H, W, Cin, Cout, k, splits, members, th, tw;
  bool flip;
  long long x_ms, w_ms, sw_ms;
  cudaStream_t stream;
};

// Launch the planned kernel of one call on moments of `dtype` (0 float32,
// 1 bf16; see supernet_vdp_conv_fwd): at float32 accuracy (vdp_conv.cu) or
// in one bf16 pass (vdp_conv_bf16.cu).
cudaError_t run_f32(const Args& a, bool relu, bool with_win, int path,
                    int tile_n, int dtype);
cudaError_t run_bf16_pass(const Args& a, bool relu, bool with_win, int path,
                          int tile_n, int dtype);

// The input channels of one tensor-core K step: 8 (k8) at float32
// accuracy, 16 (k16) in one bf16 pass.
constexpr int tc_step_channels(bool bf) { return bf ? 16 : 8; }

// The most input pixels of a tensor-core tile's halo, (TH + 2) (TW + 2): its
// shared memory is sized for it (ops/kernels/vdp_conv.py:TC_MAX_HALO).
constexpr int kTcMaxHalo = 136;

namespace {

using supernet::bf16;
using supernet::from_f32;
using supernet::pack_bf16x2;
using supernet::round_bf16;
using supernet::to_f32;

// The output type of a call: the input's with the window sum, float32
// without it (the transposed pair).
template <bool WIN, typename TI>
using OutT = std::conditional_t<WIN, TI, float>;

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // input channels staged per step
constexpr int kRegP = 4;   // output pixels per thread
constexpr int kRegC = 4;   // output channels per thread

template <int CT>
struct Tile {
  static constexpr int CL = CT / kRegC;       // thread lanes along channels
  static constexpr int PL = kThreads / CL;    // thread lanes along pixels
  static constexpr int TP = PL * kRegP;       // output pixels per block
  static constexpr int TW = CT == 64 ? 8 : 16;
  static constexpr int TH = TP / TW;
};

// Floats of dynamic shared memory one block of this configuration needs.
template <int CT>
long long smem_floats(int k, bool has_sigma) {
  using T = Tile<CT>;
  const long long halo =
      static_cast<long long>(T::TH + k - 1) * (T::TW + k - 1);
  return kChunk * halo * (has_sigma ? 2 : 1) +
         static_cast<long long>(k) * k * kChunk * CT + halo + T::TP;
}

// BF: one bf16 pass, each product's operand rounded to bf16 as it is read.
template <int CT, bool HAS_SIGMA, bool RELU, bool WIN, typename TI, bool BF>
__global__ void __launch_bounds__(kThreads) vdp_conv_kernel(
    const TI* __restrict__ mu, const TI* __restrict__ sigma,
    const float* __restrict__ w_mu, const float* __restrict__ sw,
    OutT<WIN, TI>* __restrict__ mu_out, OutT<WIN, TI>* __restrict__ sig_out,
    float* __restrict__ win_out, uint8_t* __restrict__ mask_out, int B, int H,
    int W, int Cin, int Cout, int k, int Ho, int Wo, int tiles_w,
    long long x_ms, long long w_ms, long long sw_ms) {
  using T = Tile<CT>;
  using TO = OutT<WIN, TI>;
  const int hw = T::TW + k - 1;  // halo tile width
  const int halo = (T::TH + k - 1) * hw;

  extern __shared__ float smem[];
  float* s_mu = smem;                                   // [kChunk][halo]
  float* s_sg = s_mu + kChunk * halo;                   // [kChunk][halo]
  float* s_w = s_sg + (HAS_SIGMA ? kChunk * halo : 0);  // [k*k][kChunk][CT]
  float* s_t = s_w + k * k * kChunk * CT;               // [halo]
  float* s_win = s_t + halo;                            // [TP]

  const int tid = threadIdx.x;
  const int tc = tid % T::CL;
  const int tp = tid / T::CL;
  const int oy0 = (blockIdx.x / tiles_w) * T::TH;
  const int ox0 = (blockIdx.x % tiles_w) * T::TW;
  const int co0 = blockIdx.y * CT;
  // blockIdx.z = member B + image: the inputs and weights of the member at
  // its strides, the outputs at the global image bz
  const long long bz = blockIdx.z;
  const long long member = bz / B, b = bz - member * B;
  mu += member * x_ms;
  if (HAS_SIGMA) sigma += member * x_ms;
  w_mu += member * w_ms;
  if (WIN) sw += member * sw_ms;

  if (WIN) {
    for (int p = tid; p < halo; p += kThreads) s_t[p] = 0.f;
  }

  // this thread's pixels, as offsets into the halo tile
  int pofs[kRegP];
#pragma unroll
  for (int i = 0; i < kRegP; ++i) {
    const int p = tp + T::PL * i;
    pofs[i] = (p / T::TW) * hw + p % T::TW;
  }

  float acc_mu[kRegP][kRegC];
  float acc_s2[kRegP][kRegC];
#pragma unroll
  for (int i = 0; i < kRegP; ++i) {
#pragma unroll
    for (int j = 0; j < kRegC; ++j) {
      acc_mu[i][j] = 0.f;
      acc_s2[i][j] = 0.f;
    }
  }

  for (int c0 = 0; c0 < Cin; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed before it is overwritten
    // activations, channel fastest: a warp reads whole runs of channels
    for (int e = tid; e < halo * kChunk; e += kThreads) {
      const int c = e % kChunk, p = e / kChunk;
      const int y = oy0 + p / hw, x = ox0 + p % hw;
      float m = 0.f, s = 0.f;
      if (y < H && x < W && c0 + c < Cin) {
        const long long off = ((b * H + y) * W + x) * Cin + c0 + c;
        m = to_f32(mu[off]);
        if (HAS_SIGMA) s = to_f32(sigma[off]);
      }
      if (BF && !WIN) {  // only the products read the tile
        m = round_bf16(m);
        s = round_bf16(s);
      }
      s_mu[c * halo + p] = m;
      if (HAS_SIGMA) s_sg[c * halo + p] = s;
    }
    // weights, Cout fastest (HWIO keeps it contiguous)
    for (int e = tid; e < k * k * kChunk * CT; e += kThreads) {
      const int co = e % CT, r = e / CT;
      const int c = r % kChunk, tap = r / kChunk;
      float w = 0.f;
      if (c0 + c < Cin && co0 + co < Cout) {
        w = w_mu[(static_cast<long long>(tap) * Cin + c0 + c) * Cout + co0 + co];
      }
      s_w[e] = w;
    }
    __syncthreads();

    // the chunk's share of the per-pixel channel sum behind the window sum,
    // from the unrounded values; in one bf16 pass the thread that read an
    // element then rounds it for the products
    if (WIN) {
      for (int p = tid; p < halo; p += kThreads) {
        float t = 0.f;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float m = s_mu[c * halo + p];
          const float s = HAS_SIGMA ? s_sg[c * halo + p] : 0.f;
          t += HAS_SIGMA ? m * m + s : m * m;
          if (BF) {
            s_mu[c * halo + p] = round_bf16(m);
            if (HAS_SIGMA) s_sg[c * halo + p] = round_bf16(s);
          }
        }
        s_t[p] += t;
      }
      if (BF) __syncthreads();  // the rounded tile is whole before the products
    }

    for (int c = 0; c < kChunk; ++c) {
      for (int di = 0; di < k; ++di) {
        for (int dj = 0; dj < k; ++dj) {
          const float* wrow = s_w + ((di * k + dj) * kChunk + c) * CT + tc;
          float wv[kRegC], w2[kRegC];
#pragma unroll
          for (int j = 0; j < kRegC; ++j) {
            const float wt = wrow[T::CL * j];
            // w^2 squared in float32 before the rounding
            wv[j] = BF ? round_bf16(wt) : wt;
            w2[j] = BF ? round_bf16(wt * wt) : wt * wt;
          }
          const int shift = c * halo + di * hw + dj;
#pragma unroll
          for (int i = 0; i < kRegP; ++i) {
            const float m = s_mu[shift + pofs[i]];
#pragma unroll
            for (int j = 0; j < kRegC; ++j) {
              acc_mu[i][j] = fmaf(m, wv[j], acc_mu[i][j]);
            }
            if (HAS_SIGMA) {
              const float s = s_sg[shift + pofs[i]];
#pragma unroll
              for (int j = 0; j < kRegC; ++j) {
                acc_s2[i][j] = fmaf(s, w2[j], acc_s2[i][j]);
              }
            }
          }
        }
      }
    }
  }
  if (WIN) {
    __syncthreads();  // every chunk's channel sums are in s_t

    // the window sum, once per output pixel of the tile
    for (int p = tid; p < T::TP; p += kThreads) {
      const int base = (p / T::TW) * hw + p % T::TW;
      float acc = 0.f;
      for (int di = 0; di < k; ++di) {
        for (int dj = 0; dj < k; ++dj) acc += s_t[base + di * hw + dj];
      }
      s_win[p] = acc;
    }
    __syncthreads();
  }

  float swv[kRegC];
#pragma unroll
  for (int j = 0; j < kRegC; ++j) {
    const int co = co0 + tc + T::CL * j;
    swv[j] = WIN && co < Cout ? sw[co] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRegP; ++i) {
    const int p = tp + T::PL * i;
    const int oy = oy0 + p / T::TW, ox = ox0 + p % T::TW;
    if (oy >= Ho || ox >= Wo) continue;
    const long long pix = (bz * Ho + oy) * Wo + ox;
    const float wn = WIN ? s_win[p] : 0.f;
#pragma unroll
    for (int j = 0; j < kRegC; ++j) {
      const int co = co0 + tc + T::CL * j;
      if (co >= Cout) continue;
      float m = acc_mu[i][j];
      float s = WIN ? wn * swv[j] : 0.f;
      if (HAS_SIGMA) s += acc_s2[i][j];
      if (RELU) {
        const bool on = m > 0.f;
        if (!on) {
          m = 0.f;
          s = 0.f;
        }
        if (mask_out != nullptr) mask_out[pix * Cout + co] = on;
      }
      mu_out[pix * Cout + co] = from_f32<TO>(m);
      if (HAS_SIGMA || WIN) sig_out[pix * Cout + co] = from_f32<TO>(s);
    }
    if (WIN && blockIdx.y == 0 && tc == 0) win_out[pix] = wn;
  }
}

template <int CT, bool HAS_SIGMA, bool RELU, bool WIN, typename TI, bool BF>
cudaError_t launch(const Args& a) {
  using T = Tile<CT>;
  using TO = OutT<WIN, TI>;
  const int Ho = a.H - a.k + 1, Wo = a.W - a.k + 1;
  const int tiles_h = (Ho + T::TH - 1) / T::TH;
  const int tiles_w = (Wo + T::TW - 1) / T::TW;
  const dim3 grid(tiles_h * tiles_w, (a.Cout + CT - 1) / CT, a.members * a.B);
  const size_t bytes = smem_floats<CT>(a.k, HAS_SIGMA) * sizeof(float);
  auto kernel = vdp_conv_kernel<CT, HAS_SIGMA, RELU, WIN, TI, BF>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const TI*>(a.mu), static_cast<const TI*>(a.sigma), a.w_mu,
      a.sw, static_cast<TO*>(a.mu_out), static_cast<TO*>(a.sig_out), a.win,
      a.mask, a.B, a.H, a.W, a.Cin, a.Cout, a.k, Ho, Wo, tiles_w, a.x_ms,
      a.w_ms, a.sw_ms);
  return cudaGetLastError();
}

// The instance for (sigma or not, ReLU or not, window sum or not); the form
// without the window sum has no ReLU (the entry refuses the pair).
template <int CT, typename TI, bool BF>
cudaError_t dispatch(const Args& a, bool relu, bool with_win) {
  const bool has_sigma = a.sigma != nullptr;
  if (!with_win) {
    return has_sigma ? launch<CT, true, false, false, TI, BF>(a)
                     : launch<CT, false, false, false, TI, BF>(a);
  }
  if (has_sigma) {
    return relu ? launch<CT, true, true, true, TI, BF>(a)
                : launch<CT, true, false, true, TI, BF>(a);
  }
  return relu ? launch<CT, false, true, true, TI, BF>(a)
              : launch<CT, false, false, true, TI, BF>(a);
}

// ---------------------------------------------------------------------------
// Tensor-core path: an implicit GEMM on wgmma, 3xTF32 or one bf16 pass,
// optional split-K.
namespace tc {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTileM = 64;     // output pixels per block: wgmma's M
constexpr int kTaps = 9;       // k = 3
constexpr int kStages = 4;     // B ring depth, in K steps

// The shared memory of one block, in 32-bit words.
// - ring: kStages slots, each one step's B planes ([planes][8 NT] words,
//   the layout vdp_conv_kernel_weight_planes writes).
// - split: the chunk's halo, split once. 16 words per pixel, so that a
//   16-byte load gives a row's fragment words: 3xTF32, per tensor (mu, then
//   sigma) [big(c), big(c + 4), small(c), small(c + 4)] for c < 4 (channel
//   c of the chunk's 8); one bf16 pass [mu(c), mu(c + 4), sigma(c),
//   sigma(c + 4)] for c < 4, where word j holds the bf16 pair of channels
//   2 (j % 4) + 8 (j / 4) and the next one.
// - raw: the chunk's halo as copied, per tensor [pixel][raw_pix floats]:
//   kK channels in 16-byte pieces and padding, so that the split pass's
//   reads of eight pixels fall in distinct banks.
// - t: the per-pixel channel sums behind the window sum; off: the source
//   offset of each 16-byte piece of the halo (-1: past the image).
// - full: one mbarrier per ring slot, completed by the bytes of its copy.
template <int NT, typename TI, bool BF>
struct Smem {
  static constexpr int kK = tc_step_channels(BF);  // channels of one K step
  static constexpr int planes = BF ? 2 : 4;
  static constexpr int b = 8 * NT;         // words of one B operand (kK x NT)
  static constexpr int bset = planes * b;  // one step's B operands
  static constexpr int pieces = kK * static_cast<int>(sizeof(TI)) / 16;  // per pixel
  static constexpr int piece_e = 16 / static_cast<int>(sizeof(TI));    // elements per piece
  static constexpr int raw_pix = BF ? (sizeof(TI) == 4 ? 24 : 12)
                                    : (sizeof(TI) == 4 ? 12 : 4);
  static constexpr int raw = kTcMaxHalo * raw_pix;     // one tensor's raw halo
  static constexpr int split_t = kTcMaxHalo * 16;      // one split array
  static constexpr int split = (BF ? 1 : 2) * split_t;
  static constexpr int bars = (kStages * bset + split + 2 * raw + kTcMaxHalo +
                               kTcMaxHalo * pieces + 1) / 2 * 2;  // 8-byte aligned
  static constexpr int words = bars + 2 * kStages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (shared memory, 8 bytes each): init, the fence that makes an
// init visible to the asynchronous proxy, a wait for a phase's completion.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the copy engine, their arrival completing the phase of `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes global -> shared, bypassing L1, zero-filled where !valid (src is
// then not read).
__device__ __forceinline__ void cp_async_cg(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Round to the nearest TF32 (10 mantissa bits), ties away from zero: what
// cvt.rna.tf32.f32 gives for finite x, in two integer operations. A value
// with at most 10 mantissa bits (every bf16 value) is left as it is.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 2^-22 of |x|, both halves exact in TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A fragment of wgmma k8 with TF32 (per warp, 16 rows x 8 K): element i of
// a thread is row r + 8 (i & 1), K index c + 4 (i >> 1), where r = 16 warp
// + lane / 4 and c = lane % 4. A fragment of k16 with bf16 (16 rows x 16 K)
// has the same rows: register i holds K indices 2 c + 8 (i >> 1) and the
// next one, the lower in the low half.

// Descriptor of a K-major B operand in shared memory, no swizzle: core
// matrices of 8 rows (N) x 16 bytes (4 TF32 or 8 bf16 K values), 128
// contiguous bytes each; the two core matrices of one k8 (TF32) or k16
// (bf16) step lie 128 bytes apart along K (leading byte offset),
// consecutive groups of 8 rows 256 bytes apart (stride byte offset).
// Fields in units of 16 bytes. Word e of an operand is so (n, k) =
// (8 (e >> 6) + ((e >> 2) & 7), 4 ((e >> 5) & 1) + (e & 3)) in TF32, and
// (n, k), (n, k + 1) with k = 8 ((e >> 5) & 1) + 2 (e & 3) in bf16.
__device__ __forceinline__ uint64_t b_desc(const uint32_t* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// D[64 x N] = A[64 x 8] B[8 x N] (+ D unless scale_d is 0), A from
// registers, TF32 in, float32 sum.
template <int N>
struct Mma;

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// D[64 x N] = A[64 x 16] B[16 x N] (+ D unless scale_d is 0), A from
// registers (bf16x2), B K-major (imm-trans-b 0), bf16 in, float32 sum.
template <int N>
struct MmaBf16;

template <>
struct MmaBf16<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaBf16<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The weight planes of one call: one thread per word position e of one
// step's operand, [member][chunk][tap][N tile] sets of [planes][8 NT] words
// (Smem's layout). w: this conv's weights [3][3][Cin][Cout] per member at
// w_ms, or with FLIP (the transposed pair's call) the forward weights
// [3][3][Cout][Cin] of the conv whose transposed pair this is (tap 8 - t,
// Cin and Cout swapped). Columns past Cout are 0. 3xTF32: w's and w^2's big
// and small halves, w^2 squared in float32 first; one bf16 pass: w and w^2
// as bf16 pairs along K.
template <int NT, bool BF, bool FLIP>
__global__ void __launch_bounds__(256) vdp_conv_kernel_weight_planes(
    const float* __restrict__ w, uint32_t* __restrict__ planes, int Cin,
    int Cout, int n_tiles, int chunks, long long words, long long w_ms) {
  constexpr int kK = Smem<NT, float, BF>::kK;
  constexpr int kB = Smem<NT, float, BF>::b;
  constexpr int kPlanes = Smem<NT, float, BF>::planes;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= words) return;
  const int e = static_cast<int>(i % kB);
  const long long set = i / kB;
  const int nt = static_cast<int>(set % n_tiles);
  long long r = set / n_tiles;
  const int tap = static_cast<int>(r % kTaps);
  r /= kTaps;
  const int chunk = static_cast<int>(r % chunks);
  const long long member = r / chunks;
  const int n = nt * NT + 8 * (e >> 6) + ((e >> 2) & 7);
  const int k = chunk * kK + (BF ? 8 * ((e >> 5) & 1) + 2 * (e & 3)
                                 : 4 * ((e >> 5) & 1) + (e & 3));
  w += member * w_ms;
  auto at = [&](int c) -> float {
    if (n >= Cout) return 0.f;
    return FLIP ? w[(static_cast<long long>(kTaps - 1 - tap) * Cout + n) * Cin + c]
                : w[(static_cast<long long>(tap) * Cin + c) * Cout + n];
  };
  uint32_t* out = planes + set * (kPlanes * kB) + e;
  if constexpr (BF) {
    const float w0 = at(k), w1 = at(k + 1);
    out[0] = pack_bf16x2(w0, w1);
    out[kB] = pack_bf16x2(w0 * w0, w1 * w1);  // squared in float32, then rounded
  } else {
    const float x = at(k);
    uint32_t big, small;
    split(x, big, small);
    out[0] = big;
    out[kB] = small;
    // w^2 squared in float32 first (__fmul_rn: never fused into the split)
    split(__fmul_rn(x, x), big, small);
    out[2 * kB] = big;
    out[3 * kB] = small;
  }
}

// One block: the th x tw output pixels from (oy0, ox0) of one image (rows
// m = tw ty + tx of the wgmma tile, m < th tw) x channels n0..n0+NT-1,
// input channels of one K slice (chunks_per_split chunks of kK);
// blockIdx.x = (image, tile row, tile column), blockIdx.z = member S +
// slice. planes: the weight planes (vdp_conv_kernel_weight_planes), p_ms
// words a member. SPLIT: writes partials to the member's block of `part`
// ([S][M][Cout] mu, [S][M][Cout] sigma product, [S][M] window sum) instead
// of the outputs. !WIN: no window sum (sw, win_out and the window partials
// are not touched), and without sigma no sig_out either. TI: the
// activations' type, float or bf16. BF: one bf16 pass (k16), else 3xTF32
// (k8).
template <int NT, bool HAS_SIGMA, bool RELU, bool SPLIT, bool WIN, typename TI, bool BF>
__global__ void __launch_bounds__(kThreads) vdp_conv_kernel_wgmma(
    const TI* __restrict__ mu, const TI* __restrict__ sigma,
    const uint32_t* __restrict__ planes, const float* __restrict__ sw,
    OutT<WIN, TI>* __restrict__ mu_out, OutT<WIN, TI>* __restrict__ sig_out,
    float* __restrict__ win_out, float* __restrict__ part,
    uint8_t* __restrict__ mask_out, int H, int W, int Cin, int Cout, int Ho,
    int Wo, long long M, int th, int tw, int tiles_h, int tiles_w,
    int chunks_per_split, int splits, long long x_ms, long long p_ms,
    long long sw_ms) {
  using L = Smem<NT, TI, BF>;
  constexpr int kK = L::kK;
  constexpr bool kHalf = sizeof(TI) == 2;  // bf16 activations
  constexpr int R = NT / 2;  // accumulator registers per thread and product
  extern __shared__ __align__(128) float smem[];
  uint32_t* s_ring = reinterpret_cast<uint32_t*>(smem);  // [kStages][bset]
  uint32_t* s_split = s_ring + kStages * L::bset;        // [tensor][halo][16]
  float* s_raw = reinterpret_cast<float*>(s_split + L::split);  // [tensor][halo][raw_pix]
  float* s_t = s_raw + 2 * L::raw;                       // [halo]
  int* s_off = reinterpret_cast<int*>(s_t + kTcMaxHalo);  // [halo][pieces]
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L::bars);  // [kStages]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long member = blockIdx.z / splits;
  const int slice = static_cast<int>(blockIdx.z - member * splits);
  const int c_begin = slice * chunks_per_split * kK;
  const int steps = chunks_per_split * kTaps;
  const int tx_t = static_cast<int>(blockIdx.x % tiles_w);
  const int rest = static_cast<int>(blockIdx.x / tiles_w);
  const int ty_t = rest % tiles_h;
  const long long b = rest / tiles_h;
  const int oy0 = ty_t * th, ox0 = tx_t * tw;
  const int hw = tw + 2;             // halo row
  const int halo = (th + 2) * hw;    // halo pixels, at most kTcMaxHalo
  // this member's operands at their strides, its outputs and scratch block
  mu += member * x_ms;
  if (HAS_SIGMA) sigma += member * x_ms;
  planes += member * p_ms;
  if (WIN) {
    sw += member * sw_ms;
    win_out += member * M;
  }
  mu_out += member * M * Cout;
  if (HAS_SIGMA || WIN) sig_out += member * M * Cout;
  if (RELU && mask_out != nullptr) mask_out += member * M * Cout;
  if (SPLIT) part += member * splits * (2 * M * Cout + M);

  // the halo's first input element: pixel (b, oy0, ox0), channel c_begin
  const long long in0 = ((b * H + oy0) * W + ox0) * Cin + c_begin;
  const TI* t_mu = mu + in0;
  const TI* t_sg = HAS_SIGMA ? sigma + in0 : nullptr;
  for (int e = tid; e < halo * L::pieces; e += kThreads) {
    const int p = e / L::pieces, q = e - p * L::pieces;
    const int hy = p / hw, hx = p - hy * hw;
    s_off[e] = oy0 + hy < H && ox0 + hx < W ? (hy * W + hx) * Cin + q * L::piece_e : -1;
  }
  if (WIN) {
    for (int p = tid; p < halo; p += kThreads) s_t[p] = 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(s_full + i, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // The halo of chunk c of the slice into the raw tile: each 16-byte piece,
  // zero-filled past the image (its source is then the halo's first pixel,
  // inside the tensor, and not read).
  auto load_raw = [&](int c) {
    const int ch = c * kK;
    for (int e = tid; e < halo * L::pieces; e += kThreads) {
      const int off = s_off[e];
      const int src = (off >= 0 ? off : 0) + ch;
      const int p = e / L::pieces;
      float* dst = s_raw + p * L::raw_pix + 4 * (e - p * L::pieces);
      cp_async_cg(dst, t_mu + src, off >= 0);
      if (HAS_SIGMA) cp_async_cg(dst + L::raw, t_sg + src, off >= 0);
    }
  };

  // Each step's B planes: one contiguous block of bset words, steps
  // n_tiles blocks apart (set (chunk, tap, N tile)), copied by thread 0 as
  // one bulk copy into the next ring slot.
  const uint32_t* b_src =
      planes + (static_cast<long long>(slice) * chunks_per_split * kTaps * gridDim.y +
                blockIdx.y) * L::bset;
  const int b_step = static_cast<int>(gridDim.y) * L::bset;
  int ld_step = 0, ld_slot = 0;  // thread 0's
  auto load_b = [&]() {
    if (ld_step < steps) {
      bulk_copy(s_ring + ld_slot * L::bset, b_src + static_cast<long long>(ld_step) * b_step,
                L::bset * 4, s_full + ld_slot);
    }
    ++ld_step;
    ld_slot = ld_slot + 1 == kStages ? 0 : ld_slot + 1;
  };

  // The raw halo split once into the fragments' form, and (with the window
  // sum) the chunk's mu^2 + sigma added into each pixel's channel sum, from
  // the unrounded values. Item (pixel p, c): channels c and c + 4 of the
  // chunk's 8 (3xTF32), or the pairs 2c, 2c + 1 and 2c + 8, 2c + 9 of its 16
  // (one bf16 pass); the four items of a pixel are neighbouring lanes.
  auto split_chunk = [&]() {
    const int n = 4 * halo;
    for (int e0 = 0; e0 < n; e0 += kThreads) {
      const int e = e0 + tid;
      const bool on = e < n;
      const int p = e >> 2, c = e & 3;
      float t = 0.f;
      if (on) {
        const float* rm = s_raw + p * L::raw_pix;
        uint4 u, v = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (BF) {
          float x[4], y[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (kHalf) {
            const uint32_t* rw = reinterpret_cast<const uint32_t*>(rm);
            u.x = rw[c];
            u.y = rw[c + 4];
            if (HAS_SIGMA) {
              u.z = rw[L::raw + c];
              u.w = rw[L::raw + c + 4];
            } else {
              u.z = u.w = 0u;
            }
            x[0] = __uint_as_float(u.x << 16);
            x[1] = __uint_as_float(u.x & 0xffff0000u);
            x[2] = __uint_as_float(u.y << 16);
            x[3] = __uint_as_float(u.y & 0xffff0000u);
            y[0] = __uint_as_float(u.z << 16);
            y[1] = __uint_as_float(u.z & 0xffff0000u);
            y[2] = __uint_as_float(u.w << 16);
            y[3] = __uint_as_float(u.w & 0xffff0000u);
          } else {
            const float2 a0 = *reinterpret_cast<const float2*>(rm + 2 * c);
            const float2 a1 = *reinterpret_cast<const float2*>(rm + 2 * c + 8);
            x[0] = a0.x;
            x[1] = a0.y;
            x[2] = a1.x;
            x[3] = a1.y;
            u.x = pack_bf16x2(x[0], x[1]);
            u.y = pack_bf16x2(x[2], x[3]);
            u.z = u.w = 0u;
            if (HAS_SIGMA) {
              const float2 b0 = *reinterpret_cast<const float2*>(rm + L::raw + 2 * c);
              const float2 b1 = *reinterpret_cast<const float2*>(rm + L::raw + 2 * c + 8);
              y[0] = b0.x;
              y[1] = b0.y;
              y[2] = b1.x;
              y[3] = b1.y;
              u.z = pack_bf16x2(y[0], y[1]);
              u.w = pack_bf16x2(y[2], y[3]);
            }
          }
          *reinterpret_cast<uint4*>(s_split + p * 16 + 4 * c) = u;
          if (WIN) {
#pragma unroll
            for (int j = 0; j < 4; ++j) t += HAS_SIGMA ? x[j] * x[j] + y[j] : x[j] * x[j];
          }
        } else {
          float x0, x1, y0 = 0.f, y1 = 0.f;
          if constexpr (kHalf) {
            const TI* rb = reinterpret_cast<const TI*>(rm);
            x0 = to_f32(rb[c]);
            x1 = to_f32(rb[c + 4]);
            if (HAS_SIGMA) {
              const TI* sb = reinterpret_cast<const TI*>(rm + L::raw);
              y0 = to_f32(sb[c]);
              y1 = to_f32(sb[c + 4]);
            }
          } else {
            x0 = rm[c];
            x1 = rm[c + 4];
            if (HAS_SIGMA) {
              y0 = rm[L::raw + c];
              y1 = rm[L::raw + c + 4];
            }
          }
          split(x0, u.x, u.z);
          split(x1, u.y, u.w);
          *reinterpret_cast<uint4*>(s_split + p * 16 + 4 * c) = u;
          if (HAS_SIGMA) {
            split(y0, v.x, v.z);
            split(y1, v.y, v.w);
            *reinterpret_cast<uint4*>(s_split + L::split_t + p * 16 + 4 * c) = v;
          }
          if (WIN) t = HAS_SIGMA ? (x0 * x0 + y0) + (x1 * x1 + y1) : x0 * x0 + x1 * x1;
        }
      }
      if (WIN) {
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        if (on && c == 0) s_t[p] += t;
      }
    }
  };

  // The tensor cores add into their float32 accumulator with truncation, so
  // a long chain of k8 products loses accuracy where mu's terms cancel
  // (4.9e-6 of the output's max at K = 576 on an H100). So the mu product
  // restarts its accumulator every chunk (9 taps x kK channels) and adds it
  // into tot_mu with a float32 add. The forward's sigma product, whose terms
  // are all non-negative, accumulates throughout; without the window sum the
  // "sigma" operand is a cotangent of either sign (9.8e-6 of the max on an
  // H100 when it accumulated throughout), so it folds like mu.
  constexpr bool kFoldS2 = HAS_SIGMA && !WIN;
  float acc_mu[R], tot_mu[R], acc_s2[R], tot_s2[R];  // tot_s2: kFoldS2 only
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc_mu[i] = 0.f;
    tot_mu[i] = 0.f;
    acc_s2[i] = 0.f;
    if (kFoldS2) tot_s2[i] = 0.f;
  }
  // A fragments, double-buffered: [buffer][4] big and small halves of mu
  // and sigma, register i holding row r + 8 (i & 1), K group i >> 1; in one
  // bf16 pass mu_hi and sg_hi hold the bf16x2 fragments and the small halves
  // are unused.
  uint32_t mu_hi[2][4], mu_lo[2][4], sg_hi[2][4], sg_lo[2][4];
  // this thread's rows r0 and r0 + 8 as halo pixels (a row past the tile
  // reads pixel 0 and is not stored)
  const int r0 = 16 * warp + lane / 4;
  int hp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int ty = r < th * tw ? r / tw : 0;
    const int tx = r < th * tw ? r - ty * tw : 0;
    hp[h] = (ty * hw + tx) * 16 + 4 * (lane % 4);  // in words of a split array
  }
  // step s + 1's fragments from the split tile at its tap's offset, into
  // buffer P
  auto frags = [&](auto parity, int shift) {
    constexpr int P = decltype(parity)::value;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = *reinterpret_cast<const uint4*>(s_split + hp[h] + shift);
      mu_hi[P][h] = u.x;
      mu_hi[P][2 + h] = u.y;
      if constexpr (BF) {
        sg_hi[P][h] = u.z;
        sg_hi[P][2 + h] = u.w;
      } else {
        mu_lo[P][h] = u.z;
        mu_lo[P][2 + h] = u.w;
        if (HAS_SIGMA) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(s_split + L::split_t + hp[h] + shift);
          sg_hi[P][h] = v.x;
          sg_hi[P][2 + h] = v.y;
          sg_lo[P][h] = v.z;
          sg_lo[P][2 + h] = v.w;
        }
      }
    }
  };

  // the first kStages - 1 steps' B, chunk 0's halo split, chunk 1's halo
  // on its way
  if (tid == 0) {
    for (int i = 0; i + 1 < kStages; ++i) load_b();
  }
  load_raw(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_chunk();
  __syncthreads();
  if (chunks_per_split > 1) {
    load_raw(1);
    cp_async_commit();
  }
  frags(std::integral_constant<int, 0>(), 0);

  // No barrier within a chunk: each step waits for its B slot's copy, and
  // the tensor cores run step s while the block loads step s + 1's
  // fragments into the other buffer.
  int mm_tap = 0, mm_dy = 0, mm_dx = 0, mm_chunk = 0, rd_slot = 0;
  uint32_t rd_phase = 0;
  auto step = [&](auto parity, int s) {
    constexpr int P = decltype(parity)::value;
    mbar_wait(s_full + rd_slot, rd_phase);  // step s's B has landed
    const uint32_t* bo = s_ring + rd_slot * L::bset;
    if (++rd_slot == kStages) {
      rd_slot = 0;
      rd_phase ^= 1u;
    }
    wgmma_fence();
    fence_acc(acc_mu);
    if constexpr (BF) {
      MmaBf16<NT>::run(acc_mu, mu_hi[P], b_desc(bo), mm_tap != 0);
      if (HAS_SIGMA) {
        fence_acc(acc_s2);
        MmaBf16<NT>::run(acc_s2, sg_hi[P], b_desc(bo + L::b),
                         kFoldS2 ? mm_tap != 0 : 1);
        fence_acc(acc_s2);
      }
    } else {
      const uint64_t d_wb = b_desc(bo), d_ws = b_desc(bo + L::b);
      Mma<NT>::run(acc_mu, mu_lo[P], d_wb, mm_tap != 0);
      Mma<NT>::run(acc_mu, mu_hi[P], d_ws, 1);
      Mma<NT>::run(acc_mu, mu_hi[P], d_wb, 1);
      if (HAS_SIGMA) {
        fence_acc(acc_s2);
        const uint64_t d_qb = b_desc(bo + 2 * L::b), d_qs = b_desc(bo + 3 * L::b);
        Mma<NT>::run(acc_s2, sg_lo[P], d_qb, kFoldS2 ? mm_tap != 0 : 1);
        Mma<NT>::run(acc_s2, sg_hi[P], d_qs, 1);
        Mma<NT>::run(acc_s2, sg_hi[P], d_qb, 1);
        fence_acc(acc_s2);
      }
    }
    wgmma_commit();
    fence_acc(acc_mu);
    if (mm_tap == kTaps - 1) {
      // the chunk is complete: split the next chunk's halo (copied during
      // this chunk) while the tensor cores run, copy the one after it, then
      // fold the chunk's mu sum into the total
      if (s + 1 < steps) {
        cp_async_wait<0>();
        __syncthreads();  // the halo has landed; every fragment of the tile is loaded
        split_chunk();
        __syncthreads();
        if (mm_chunk + 2 < chunks_per_split) {
          load_raw(mm_chunk + 2);
          cp_async_commit();
        }
      }
      wgmma_wait<0>();
      fence_acc(acc_mu);
      fence_acc(acc_s2);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        tot_mu[i] += acc_mu[i];
        if (kFoldS2) tot_s2[i] += acc_s2[i];
      }
      mm_tap = mm_dy = mm_dx = 0;
      ++mm_chunk;
    } else {
      // step s - 1 is done: its fragment buffer may be refilled
      wgmma_wait<1>();
      ++mm_tap;
      if (++mm_dx == 3) {
        mm_dx = 0;
        ++mm_dy;
      }
    }
    // step s - 1's wgmmas are done, so its slot takes step s + kStages - 1
    if (tid == 0) load_b();
    if (s + 1 < steps) {
      frags(std::integral_constant<int, 1 - P>(), (mm_dy * hw + mm_dx) * 16);
    }
  };

  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(std::integral_constant<int, 0>(), s);
    step(std::integral_constant<int, 1>(), s + 1);
  }
  if (s < steps) step(std::integral_constant<int, 0>(), s);
  // the last step ends a chunk, so every wgmma has completed, and every
  // copy has been waited for

  // accumulator layout (wgmma m64nN, f32): register 4 j + 2 h + i holds row
  // r0 + 8 h, column 8 j + 2 (lane % 4) + i
  const long long S = splits;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= th * tw) continue;
    const int ty = r / tw, tx = r - ty * tw;
    const int oy = oy0 + ty, ox = ox0 + tx;
    if (oy >= Ho || ox >= Wo) continue;
    const long long m = (b * Ho + oy) * Wo + ox;
    // the 3 x 3 window of the per-pixel channel sums
    float wn = 0.f;
    if (WIN) {
      const int p = ty * hw + tx;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) wn += s_t[p + dy * hw + dx];
      }
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int co = blockIdx.y * NT + 8 * j + 2 * (lane % 4);
      if (co >= Cout) continue;  // Cout % 4 == 0: co + 1 < Cout as well
      float2 vm = make_float2(tot_mu[4 * j + 2 * h], tot_mu[4 * j + 2 * h + 1]);
      float2 vs =
          kFoldS2 ? make_float2(tot_s2[4 * j + 2 * h], tot_s2[4 * j + 2 * h + 1])
                  : make_float2(acc_s2[4 * j + 2 * h], acc_s2[4 * j + 2 * h + 1]);
      if (SPLIT) {
        const long long o = (slice * M + m) * Cout + co;
        *reinterpret_cast<float2*>(part + o) = vm;
        if (HAS_SIGMA || WIN) {
          *reinterpret_cast<float2*>(part + S * M * Cout + o) = vs;
        }
      } else {
        if (WIN) {
          vs.x += wn * sw[co];
          vs.y += wn * sw[co + 1];
        }
        if (RELU) {
          const bool on_x = vm.x > 0.f, on_y = vm.y > 0.f;
          if (!on_x) vm.x = vs.x = 0.f;
          if (!on_y) vm.y = vs.y = 0.f;
          if (mask_out != nullptr) {
            *reinterpret_cast<uchar2*>(mask_out + m * Cout + co) =
                make_uchar2(on_x, on_y);
          }
        }
        supernet::store2(mu_out + m * Cout + co, vm.x, vm.y);
        if (HAS_SIGMA || WIN) supernet::store2(sig_out + m * Cout + co, vs.x, vs.y);
      }
    }
    if (WIN && blockIdx.y == 0 && lane % 4 == 0) {
      if (SPLIT) {
        part[2 * S * M * Cout + slice * M + m] = wn;
      } else {
        win_out[m] = wn;
      }
    }
  }
}

// Sums the S slices of the split path in slice order and writes the outputs
// in TO; one thread per 4 output channels of one pixel, blockIdx.y the
// member. !WIN: no window sum; !S2: no sigma product either (mu_out alone).
template <bool RELU, bool WIN, bool S2, typename TO>
__global__ void __launch_bounds__(256) vdp_conv_kernel_splitk_reduce(
    const float* __restrict__ part, const float* __restrict__ sw,
    TO* __restrict__ mu_out, TO* __restrict__ sig_out,
    float* __restrict__ win_out, uint8_t* __restrict__ mask_out, long long M,
    int Cout, int S, long long sw_ms) {
  const int nq = Cout / 4;
  const long long plane = M * Cout;
  const long long member = blockIdx.y;
  part += member * S * (2 * plane + M);
  mu_out += member * plane;
  if (S2) sig_out += member * plane;
  if (WIN) {
    sw += member * sw_ms;
    win_out += member * M;
  }
  if (RELU && mask_out != nullptr) mask_out += member * plane;
  const float* part_s2 = part + S * plane;
  const float* part_win = part + 2 * S * plane;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < M * nq; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long m = i / nq;
    const int co = 4 * static_cast<int>(i - m * nq);
    const long long o = m * Cout + co;
    float4 vm = make_float4(0.f, 0.f, 0.f, 0.f), vs = vm;
    float wn = 0.f;
    for (int s = 0; s < S; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(part + s * plane + o);
      vm.x += a.x; vm.y += a.y; vm.z += a.z; vm.w += a.w;
      if (S2) {
        const float4 b =
            *reinterpret_cast<const float4*>(part_s2 + s * plane + o);
        vs.x += b.x; vs.y += b.y; vs.z += b.z; vs.w += b.w;
      }
      if (WIN) wn += part_win[s * M + m];
    }
    if (WIN) {
      const float4 v = *reinterpret_cast<const float4*>(sw + co);
      vs.x += wn * v.x; vs.y += wn * v.y; vs.z += wn * v.z; vs.w += wn * v.w;
    }
    if (RELU) {
      const bool on_x = vm.x > 0.f, on_y = vm.y > 0.f;
      const bool on_z = vm.z > 0.f, on_w = vm.w > 0.f;
      if (!on_x) vm.x = vs.x = 0.f;
      if (!on_y) vm.y = vs.y = 0.f;
      if (!on_z) vm.z = vs.z = 0.f;
      if (!on_w) vm.w = vs.w = 0.f;
      if (mask_out != nullptr) {
        *reinterpret_cast<uchar4*>(mask_out + o) = make_uchar4(on_x, on_y, on_z, on_w);
      }
    }
    supernet::store4(mu_out + o, vm);
    if (S2) supernet::store4(sig_out + o, vs);
    if (WIN && co == 0) win_out[m] = wn;
  }
}

template <int NT, bool HAS_SIGMA, bool RELU, bool SPLIT, bool WIN, typename TI, bool BF>
cudaError_t launch_wgmma(const Args& a) {
  using L = Smem<NT, TI, BF>;
  using TO = OutT<WIN, TI>;
  const int Ho = a.H - 2, Wo = a.W - 2;
  const long long M = static_cast<long long>(a.B) * Ho * Wo;
  const int tiles_h = (Ho + a.th - 1) / a.th, tiles_w = (Wo + a.tw - 1) / a.tw;
  const long long m_tiles = static_cast<long long>(a.B) * tiles_h * tiles_w;
  if (m_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n_tiles = (a.Cout + NT - 1) / NT;
  const int chunks = a.Cin / L::kK;
  const long long p_ms = static_cast<long long>(chunks) * kTaps * n_tiles * L::bset;
  // the weight planes of every member, on the same stream before the loop
  const long long words = a.members * static_cast<long long>(chunks) * kTaps * n_tiles * L::b;
  const long long pblocks = (words + 255) / 256;
  if (pblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto prologue = a.flip ? vdp_conv_kernel_weight_planes<NT, BF, true>
                         : vdp_conv_kernel_weight_planes<NT, BF, false>;
  prologue<<<static_cast<unsigned>(pblocks), 256, 0, a.stream>>>(
      a.w_mu, a.planes, a.Cin, a.Cout, n_tiles, chunks, words, a.w_ms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(m_tiles), n_tiles, a.members * a.splits);
  const size_t bytes = L::words * sizeof(uint32_t);
  auto kernel = vdp_conv_kernel_wgmma<NT, HAS_SIGMA, RELU, SPLIT, WIN, TI, BF>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const TI*>(a.mu), static_cast<const TI*>(a.sigma), a.planes,
      a.sw, static_cast<TO*>(a.mu_out), static_cast<TO*>(a.sig_out), a.win,
      a.part, a.mask, a.H, a.W, a.Cin, a.Cout, Ho, Wo, M, a.th, a.tw, tiles_h,
      tiles_w, chunks / a.splits, a.splits, a.x_ms, p_ms, a.sw_ms);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return err;
  const long long quads = M * (a.Cout / 4);
  const long long blocks = (quads + 255) / 256;
  vdp_conv_kernel_splitk_reduce<RELU, WIN, HAS_SIGMA || WIN, TO>
      <<<dim3(static_cast<unsigned>(blocks < 65535 ? blocks : 65535),
              a.members),
         256, 0, a.stream>>>(a.part, a.sw, static_cast<TO*>(a.mu_out),
                             static_cast<TO*>(a.sig_out), a.win, a.mask, M,
                             a.Cout, a.splits, a.sw_ms);
  return cudaGetLastError();
}

// The instance for (sigma or not, ReLU or not, split or not, window sum or
// not); the form without the window sum has no ReLU.
template <int NT, typename TI, bool BF>
cudaError_t dispatch_wgmma(const Args& a, bool relu, bool with_win) {
  const bool split = a.splits > 1;
  if (!with_win) {
    if (a.sigma != nullptr) {
      return split ? launch_wgmma<NT, true, false, true, false, TI, BF>(a)
                   : launch_wgmma<NT, true, false, false, false, TI, BF>(a);
    }
    return split ? launch_wgmma<NT, false, false, true, false, TI, BF>(a)
                 : launch_wgmma<NT, false, false, false, false, TI, BF>(a);
  }
  if (a.sigma != nullptr) {
    if (relu) {
      return split ? launch_wgmma<NT, true, true, true, true, TI, BF>(a)
                   : launch_wgmma<NT, true, true, false, true, TI, BF>(a);
    }
    return split ? launch_wgmma<NT, true, false, true, true, TI, BF>(a)
                 : launch_wgmma<NT, true, false, false, true, TI, BF>(a);
  }
  if (relu) {
    return split ? launch_wgmma<NT, false, true, true, true, TI, BF>(a)
                 : launch_wgmma<NT, false, true, false, true, TI, BF>(a);
  }
  return split ? launch_wgmma<NT, false, false, true, true, TI, BF>(a)
               : launch_wgmma<NT, false, false, false, true, TI, BF>(a);
}

}  // namespace tc

template <typename TI, bool BF>
cudaError_t run_as(const Args& a, bool relu, bool with_win, int path, int tile_n) {
  if (path == 0) {
    return tile_n == 64 ? dispatch<64, TI, BF>(a, relu, with_win)
                        : dispatch<32, TI, BF>(a, relu, with_win);
  }
  return tile_n == 64 ? tc::dispatch_wgmma<64, TI, BF>(a, relu, with_win)
                      : tc::dispatch_wgmma<32, TI, BF>(a, relu, with_win);
}

// Every instance of one precision (BF: one bf16 pass), by element type.
template <bool BF>
cudaError_t run(const Args& a, bool relu, bool with_win, int path, int tile_n,
                int dtype) {
  return dtype == kBFloat16 ? run_as<bf16, BF>(a, relu, with_win, path, tile_n)
                            : run_as<float, BF>(a, relu, with_win, path, tile_n);
}

}  // namespace
}  // namespace vdp
}  // namespace supernet
