// Fused VDP convolution forward for Hopper, sm_90a.
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
// What bounds it: arithmetic. Each output costs 2 k^2 Cin multiply-adds (one
// for each product) against a few bytes of input that every neighbouring
// output shares. The CUDA cores' float32 rate is 67 TFLOP/s; the tensor
// cores' TF32 rate is 495. Two paths, chosen by shape in
// ops/kernels/vdp_conv.py:plan:
//
// Tensor-core path (k = 3, Cin % 8 == 0, Cout % 4 == 0): an implicit GEMM,
// M = output pixels (the batch folded in), N = Cout, K = 9 Cin, both
// products in one block on the same M x K patches.
// - 3xTF32: every operand x is split into big = tf32(x) and small =
//   tf32(x - big), both rounded to nearest (the tensor core itself would
//   drop the low 13 bits), and each product accumulates
//   a_small b_big + a_big b_small + a_big b_big in float32. That keeps
//   float32 accuracy at a third of the TF32 rate, 165 TFLOP/s; single-pass
//   TF32 errs by about 1e-4 of the output's max at K = 4608.
// - The tensor cores add into their float32 accumulator with truncation, so
//   the mu product, whose terms cancel, restarts its accumulator every
//   chunk of 72 K values and folds it into a float32 total.
// - wgmma.m64nNk8.f32.tf32.tf32 (N = 32 or 64), one warpgroup per block of 64
//   output pixels x N channels. A (the patches) comes from registers: each
//   thread loads its fragment from the staged patch tile, splits it there and
//   adds its share of the window sum. B (the weights, HWIO, so N-major) is
//   transposed to K-major core matrices while it is split in shared memory,
//   with w^2 and its halves formed there: four operands per K step, and no
//   weight copy in device memory.
// - One K step is one tap x 8 input channels. A ring of kStages steps is
//   filled by 16-byte cp.async (4 channels of one pixel, im2col on the fly,
//   rows past M zero-filled), so the copies of the next steps overlap the
//   tensor cores' work on this one. The split B operands and the A
//   fragments are double-buffered: one barrier per step, after which the
//   block starts step s on the tensor cores and prepares step s + 1 while
//   they run.
// - Split-K: where the M x N tiles alone give fewer blocks than the card has
//   SMs (the deep BraTS layers: M = 72 to 512 against K = 4608), the Cin
//   chunks are cut into S slices, one block each. Each slice writes float32
//   partials of both products and of its window sum to a scratch buffer
//   [S, M, Cout] x 2 + [S, M], and vdp_conv_kernel_splitk_reduce sums the
//   slices in fixed order (no atomics: deterministic), adds win * sw, applies
//   the ReLU and writes the three outputs.
// - The window sum is formed once per output pixel from the same A
//   fragments: over the nine taps each fragment holds the tap-shifted inputs
//   of its rows, so summing mu^2 + sigma over the fragment and the quad of
//   lanes that shares a row gives that row's k x k x Cin window sum.
// What bounds it now is the work around the tensor cores: at N = 32 a K step
// is 6 small wgmmas against its staging, splitting and barrier (PERF.md).
//
// CUDA-core path (everything else: the first layer's Cin of 1 or 4, k != 3,
// Cin not a multiple of 8), the exact float32 baseline:
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
//   once per output pixel before the epilogue.
// Every offset into the activations and weights is 64-bit.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

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

template <int CT, bool HAS_SIGMA, bool RELU>
__global__ void __launch_bounds__(kThreads) vdp_conv_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ w_mu, const float* __restrict__ sw,
    float* __restrict__ mu_out, float* __restrict__ sig_out,
    float* __restrict__ win_out, int H, int W, int Cin, int Cout, int k,
    int Ho, int Wo, int tiles_w) {
  using T = Tile<CT>;
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
  const long long b = blockIdx.z;

  for (int p = tid; p < halo; p += kThreads) s_t[p] = 0.f;

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
        m = mu[off];
        if (HAS_SIGMA) s = sigma[off];
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

    // the chunk's share of the per-pixel channel sum behind the window sum
    for (int p = tid; p < halo; p += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float m = s_mu[c * halo + p];
        t += HAS_SIGMA ? m * m + s_sg[c * halo + p] : m * m;
      }
      s_t[p] += t;
    }

    for (int c = 0; c < kChunk; ++c) {
      for (int di = 0; di < k; ++di) {
        for (int dj = 0; dj < k; ++dj) {
          const float* wrow = s_w + ((di * k + dj) * kChunk + c) * CT + tc;
          float wv[kRegC], w2[kRegC];
#pragma unroll
          for (int j = 0; j < kRegC; ++j) {
            wv[j] = wrow[T::CL * j];
            w2[j] = wv[j] * wv[j];
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

  float swv[kRegC];
#pragma unroll
  for (int j = 0; j < kRegC; ++j) {
    const int co = co0 + tc + T::CL * j;
    swv[j] = co < Cout ? sw[co] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRegP; ++i) {
    const int p = tp + T::PL * i;
    const int oy = oy0 + p / T::TW, ox = ox0 + p % T::TW;
    if (oy >= Ho || ox >= Wo) continue;
    const long long pix = (b * Ho + oy) * Wo + ox;
    const float wn = s_win[p];
#pragma unroll
    for (int j = 0; j < kRegC; ++j) {
      const int co = co0 + tc + T::CL * j;
      if (co >= Cout) continue;
      float m = acc_mu[i][j];
      float s = wn * swv[j];
      if (HAS_SIGMA) s += acc_s2[i][j];
      if (RELU && !(m > 0.f)) {
        m = 0.f;
        s = 0.f;
      }
      mu_out[pix * Cout + co] = m;
      sig_out[pix * Cout + co] = s;
    }
    if (blockIdx.y == 0 && tc == 0) win_out[pix] = wn;
  }
}

template <int CT, bool HAS_SIGMA, bool RELU>
cudaError_t launch(const float* mu, const float* sigma, const float* w_mu,
                   const float* sw, float* mu_out, float* sig_out, float* win,
                   int B, int H, int W, int Cin, int Cout, int k,
                   cudaStream_t stream) {
  using T = Tile<CT>;
  const int Ho = H - k + 1, Wo = W - k + 1;
  const int tiles_h = (Ho + T::TH - 1) / T::TH;
  const int tiles_w = (Wo + T::TW - 1) / T::TW;
  const dim3 grid(tiles_h * tiles_w, (Cout + CT - 1) / CT, B);
  const size_t bytes = smem_floats<CT>(k, HAS_SIGMA) * sizeof(float);
  auto kernel = vdp_conv_kernel<CT, HAS_SIGMA, RELU>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(mu, sigma, w_mu, sw, mu_out,
                                            sig_out, win, H, W, Cin, Cout, k,
                                            Ho, Wo, tiles_w);
  return cudaGetLastError();
}

template <int CT>
cudaError_t dispatch(const float* mu, const float* sigma, const float* w_mu,
                     const float* sw, float* mu_out, float* sig_out,
                     float* win, int B, int H, int W, int Cin, int Cout, int k,
                     bool relu, cudaStream_t stream) {
  if (sigma != nullptr) {
    return relu ? launch<CT, true, true>(mu, sigma, w_mu, sw, mu_out, sig_out,
                                         win, B, H, W, Cin, Cout, k, stream)
                : launch<CT, true, false>(mu, sigma, w_mu, sw, mu_out, sig_out,
                                          win, B, H, W, Cin, Cout, k, stream);
  }
  return relu ? launch<CT, false, true>(mu, sigma, w_mu, sw, mu_out, sig_out,
                                        win, B, H, W, Cin, Cout, k, stream)
              : launch<CT, false, false>(mu, sigma, w_mu, sw, mu_out, sig_out,
                                         win, B, H, W, Cin, Cout, k, stream);
}

// ---------------------------------------------------------------------------
// Tensor-core path: 3xTF32 implicit GEMM on wgmma, optional split-K.
namespace tc {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTileM = 64;     // output pixels per block: wgmma's M
constexpr int kK = 8;          // one K step: 8 channels of one tap (k8)
constexpr int kTaps = 9;       // k = 3
constexpr int kStages = 4;     // cp.async ring depth, in K steps
constexpr int kARow = 12;      // floats per staged patch row: 8 channels and
                               // 4 of padding, so that the 8 rows one
                               // fragment load touches fall in distinct banks

template <int NT>
struct Smem {
  static constexpr int a = kTileM * kARow;  // one patch tile (mu or sigma)
  static constexpr int wrow = NT + 8;       // padded raw weight row
  static constexpr int stage = 2 * a + kK * wrow;
  static constexpr int b = kK * NT;         // one split B operand
  static constexpr int bset = 4 * b;        // w big, w small, w^2 big, w^2 small
  static constexpr int floats = 2 * bset + kStages * stage;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid (src is then not read).
// The activations go through L1 (.ca): the nine taps of a chunk read
// overlapping pixels. The weights bypass it (.cg).
__device__ __forceinline__ void cp_async_ca(float* dst, const float* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_cg(float* dst, const float* src,
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
// cvt.rna.tf32.f32 gives for finite x, in two integer operations.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 2^-22 of |x|, both halves exact in TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// a thread is row r + 8 frag_row(i), K index c + 4 frag_ch(i), where
// r = 16 warp + lane / 4 and c = lane % 4.
__device__ __forceinline__ constexpr int frag_row(int i) { return i & 1; }
__device__ __forceinline__ constexpr int frag_ch(int i) { return i >> 1; }

// Descriptor of a K-major B operand in shared memory, no swizzle: core
// matrices of 8 rows (N) x 16 bytes (4 K values), 128 contiguous bytes each;
// the two core matrices of one k8 step lie 128 bytes apart along K (leading
// byte offset), consecutive groups of 8 rows 256 bytes apart (stride byte
// offset). Fields in units of 16 bytes.
__device__ __forceinline__ uint64_t b_desc(const float* p) {
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

// One block: output pixels m0..m0+63 (flat over B x Ho x Wo) x channels
// n0..n0+NT-1, input channels of slice blockIdx.z (chunks_per_split chunks
// of 8). SPLIT: writes partials to `part` ([S][M][Cout] mu, [S][M][Cout]
// sigma product, [S][M] window sum) instead of the outputs.
template <int NT, bool HAS_SIGMA, bool RELU, bool SPLIT>
__global__ void __launch_bounds__(kThreads) vdp_conv_kernel_wgmma(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ w_mu, const float* __restrict__ sw,
    float* __restrict__ mu_out, float* __restrict__ sig_out,
    float* __restrict__ win_out, float* __restrict__ part, int H, int W,
    int Cin, int Cout, int Ho, int Wo, long long M, int chunks_per_split) {
  using L = Smem<NT>;
  constexpr int R = NT / 2;  // accumulator registers per thread and product
  extern __shared__ __align__(128) float smem[];
  float* s_b = smem;                   // [2][4][kK * NT] split B operands
  float* s_ring = smem + 2 * L::bset;  // [kStages][stage]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int n0 = blockIdx.y * NT;
  const int c_begin = blockIdx.z * chunks_per_split * kK;
  const int steps = chunks_per_split * kTaps;

  // Every address below that does not change from step to step is formed
  // once here; the steps only advance counters.
  // This thread's copies of each patch tile: row tid / 2, channels
  // 4 (tid % 2) .. +3 of the step's chunk.
  // A row past M is zero-filled; its source address stays that of pixel 0
  // plus the step's offset, which lies inside the tensor (the offset is
  // below 3 W Cin <= H W Cin).
  const int a_row = tid / 2;
  const long long am = m0 + a_row;
  const bool a_valid = am < M;
  long long a_base = c_begin + 4 * (tid % 2);
  if (a_valid) {
    const long long hw = static_cast<long long>(Ho) * Wo;
    const long long b = am / hw, rem = am - b * hw;
    const long long oy = rem / Wo, ox = rem - oy * Wo;
    a_base += ((b * H + oy) * W + ox) * Cin;
  }
  const float* a_mu = mu + a_base;
  const float* a_sg = HAS_SIGMA ? sigma + a_base : nullptr;
  const int a_dst = a_row * kARow + 4 * (tid % 2);
  // This thread's 16-byte pieces of each step's 8 x NT weights: piece e is
  // row e / (NT / 4), columns 4 (e % (NT / 4)) .. +3; columns past Cout
  // are zero-filled.
  constexpr int kWPieces = kK * NT / 4;
  constexpr int kWIter = (kWPieces + kThreads - 1) / kThreads;
  const float* w_src[kWIter];  // (a zero-filled piece reads nothing)
  int w_dst[kWIter];
  bool w_ok[kWIter];
#pragma unroll
  for (int i = 0; i < kWIter; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / (NT / 4), q = e % (NT / 4);
    w_ok[i] = n0 + 4 * q < Cout;
    w_src[i] = w_mu + (w_ok[i] ? static_cast<long long>(c_begin + r) * Cout +
                                     n0 + 4 * q
                               : 0);
    w_dst[i] = 2 * L::a + r * L::wrow + 4 * q;
  }
  // The B transform: element e = tid + i kThreads of each split operand,
  // which is (n, k) = (8 (e >> 6) + ((e >> 2) & 7), 4 ((e >> 5) & 1) +
  // (e & 3)), reads the raw weights at b_src + 16 i.
  constexpr int kBIter = kK * NT / kThreads;
  const int b_src = (4 * ((tid >> 5) & 1) + (tid & 3)) * L::wrow +
                    8 * (tid >> 6) + ((tid >> 2) & 7);

  // the load cursor: the next step to copy (tap = 3 dy + dx, channel
  // offset within the slice, ring slot); the offsets are below 9 Cin Cout
  // and fit an int
  int ld_tap = 0, ld_dy = 0, ld_dx = 0, ld_c = 0, ld_slot = 0;
  auto load_next = [&]() {
    float* st = s_ring + ld_slot * L::stage;
    const int shift = (ld_dy * W + ld_dx) * Cin + ld_c;
    cp_async_ca(st + a_dst, a_mu + shift, a_valid);
    if (HAS_SIGMA) cp_async_ca(st + L::a + a_dst, a_sg + shift, a_valid);
    const int w_row = (ld_tap * Cin + ld_c) * Cout;
#pragma unroll
    for (int i = 0; i < kWIter; ++i) {
      if (kWPieces % kThreads == 0 || tid + i * kThreads < kWPieces) {
        cp_async_cg(st + w_dst[i], w_src[i] + w_row, w_ok[i]);
      }
    }
    ld_slot = ld_slot + 1 == kStages ? 0 : ld_slot + 1;
    ld_tap = ld_tap + 1 == kTaps ? 0 : ld_tap + 1;
    if (++ld_dx == 3) {
      ld_dx = 0;
      if (++ld_dy == 3) {
        ld_dy = 0;
        ld_c += kK;
      }
    }
  };

  // The tensor cores add into their float32 accumulator with truncation, so
  // a long chain of k8 products loses accuracy where mu's terms cancel
  // (4.9e-6 of the output's max at K = 576 on an H100). So the mu product
  // restarts its accumulator every chunk (9 taps x 8 channels) and adds it
  // into tot_mu with a float32 add; the sigma product, whose terms are all
  // non-negative, accumulates throughout.
  float acc_mu[R], tot_mu[R], acc_s2[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc_mu[i] = 0.f;
    tot_mu[i] = 0.f;
    acc_s2[i] = 0.f;
  }
  // A fragments, double-buffered: [buffer][4] big and small halves of mu
  // and sigma, in the layout of frag_row and frag_ch.
  uint32_t mu_hi[2][4], mu_lo[2][4], sg_hi[2][4], sg_lo[2][4];
  float win0 = 0.f, win1 = 0.f;  // window-sum shares of rows r and r + 8
  const int frag = (16 * warp + lane / 4) * kARow + lane % 4;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load_next();
    cp_async_commit();
  }

  // The operands of the next step to prepare, into buffer P (its step's
  // parity): its weights [8][NT] become the four split K-major B operands,
  // and this thread's patch fragments the A registers, with their share of
  // the window sum. Buffer P was last read by the wgmmas two steps back,
  // which the previous step waited for.
  int pr_slot = 0;
  auto prepare = [&](auto parity) {
    constexpr int P = decltype(parity)::value;
    const float* st = s_ring + pr_slot * L::stage;
    float* bo = s_b + P * L::bset;
    const float* wr = st + 2 * L::a + b_src;
#pragma unroll
    for (int i = 0; i < kBIter; ++i) {
      const int e = tid + i * kThreads;
      const float w = wr[16 * i];
      uint32_t hi, lo;
      split(w, hi, lo);
      bo[e] = __uint_as_float(hi);
      bo[L::b + e] = __uint_as_float(lo);
      if (HAS_SIGMA) {
        split(w * w, hi, lo);
        bo[2 * L::b + e] = __uint_as_float(hi);
        bo[3 * L::b + e] = __uint_as_float(lo);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ofs = frag + frag_row(i) * 8 * kARow + frag_ch(i) * 4;
      const float x = st[ofs];
      split(x, mu_hi[P][i], mu_lo[P][i]);
      float t = x * x;
      if (HAS_SIGMA) {
        const float y = st[L::a + ofs];
        split(y, sg_hi[P][i], sg_lo[P][i]);
        t += y;
      }
      if (frag_row(i)) {
        win1 += t;
      } else {
        win0 += t;
      }
    }
    fence_proxy_async();  // the split operands are visible to wgmma
    pr_slot = pr_slot + 1 == kStages ? 0 : pr_slot + 1;
  };

  // One barrier per step: the tensor cores run step s while the block
  // prepares step s + 1 into the other buffers.
  int mm_tap = 0;
  auto step = [&](auto parity, int s) {
    constexpr int P = decltype(parity)::value;
    cp_async_wait<kStages - 3>();  // step s + 1 has landed (own copies)
    __syncthreads();  // step s's operands and step s + 1's copies complete;
                      // step s - 1's ring slot is consumed
    if (s + kStages - 1 < steps) load_next();
    cp_async_commit();

    const float* bo = s_b + P * L::bset;
    wgmma_fence();
    fence_acc(acc_mu);
    const uint64_t d_wb = b_desc(bo), d_ws = b_desc(bo + L::b);
    Mma<NT>::run(acc_mu, mu_lo[P], d_wb, mm_tap != 0);
    Mma<NT>::run(acc_mu, mu_hi[P], d_ws, 1);
    Mma<NT>::run(acc_mu, mu_hi[P], d_wb, 1);
    if (HAS_SIGMA) {
      fence_acc(acc_s2);
      const uint64_t d_qb = b_desc(bo + 2 * L::b), d_qs = b_desc(bo + 3 * L::b);
      Mma<NT>::run(acc_s2, sg_lo[P], d_qb, 1);
      Mma<NT>::run(acc_s2, sg_hi[P], d_qs, 1);
      Mma<NT>::run(acc_s2, sg_hi[P], d_qb, 1);
      fence_acc(acc_s2);
    }
    wgmma_commit();
    fence_acc(acc_mu);
    if (mm_tap == kTaps - 1) {
      // the chunk is complete: fold its mu sum into the total
      wgmma_wait<0>();
      fence_acc(acc_mu);
      fence_acc(acc_s2);
#pragma unroll
      for (int i = 0; i < R; ++i) tot_mu[i] += acc_mu[i];
    } else {
      // step s - 1 is done: its buffers may be refilled
      wgmma_wait<1>();
    }
    mm_tap = mm_tap + 1 == kTaps ? 0 : mm_tap + 1;
    if (s + 1 < steps) prepare(std::integral_constant<int, 1 - P>());
  };

  cp_async_wait<kStages - 2>();  // step 0 has landed
  __syncthreads();
  prepare(std::integral_constant<int, 0>());
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(std::integral_constant<int, 0>(), s);
    step(std::integral_constant<int, 1>(), s + 1);
  }
  if (s < steps) step(std::integral_constant<int, 0>(), s);
  // the last step ends a chunk, so every wgmma has completed
  cp_async_wait<0>();

  // the quad of lanes that shares a row holds its 8 channels
  win0 += __shfl_xor_sync(0xffffffffu, win0, 1);
  win0 += __shfl_xor_sync(0xffffffffu, win0, 2);
  win1 += __shfl_xor_sync(0xffffffffu, win1, 1);
  win1 += __shfl_xor_sync(0xffffffffu, win1, 2);

  // accumulator layout (wgmma m64nN, f32): register 4 j + 2 h + i holds row
  // r + 8 h, column 8 j + 2 (lane % 4) + i
  const long long r0 = m0 + 16 * warp + lane / 4;
  const long long S = gridDim.z;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = r0 + 8 * h;
    if (m >= M) continue;
    const float wn = h ? win1 : win0;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int co = n0 + 8 * j + 2 * (lane % 4);
      if (co >= Cout) continue;  // Cout % 4 == 0: co + 1 < Cout as well
      float2 vm = make_float2(tot_mu[4 * j + 2 * h], tot_mu[4 * j + 2 * h + 1]);
      float2 vs = make_float2(acc_s2[4 * j + 2 * h], acc_s2[4 * j + 2 * h + 1]);
      if (SPLIT) {
        const long long o = (blockIdx.z * M + m) * Cout + co;
        *reinterpret_cast<float2*>(part + o) = vm;
        *reinterpret_cast<float2*>(part + S * M * Cout + o) = vs;
      } else {
        vs.x += wn * sw[co];
        vs.y += wn * sw[co + 1];
        if (RELU) {
          if (!(vm.x > 0.f)) vm.x = vs.x = 0.f;
          if (!(vm.y > 0.f)) vm.y = vs.y = 0.f;
        }
        *reinterpret_cast<float2*>(mu_out + m * Cout + co) = vm;
        *reinterpret_cast<float2*>(sig_out + m * Cout + co) = vs;
      }
    }
    if (blockIdx.y == 0 && lane % 4 == 0) {
      if (SPLIT) {
        part[2 * S * M * Cout + blockIdx.z * M + m] = wn;
      } else {
        win_out[m] = wn;
      }
    }
  }
}

// Sums the S slices of the split path in slice order and writes the outputs;
// one thread per 4 output channels of one pixel.
template <bool RELU>
__global__ void __launch_bounds__(256) vdp_conv_kernel_splitk_reduce(
    const float* __restrict__ part, const float* __restrict__ sw,
    float* __restrict__ mu_out, float* __restrict__ sig_out,
    float* __restrict__ win_out, long long M, int Cout, int S) {
  const int nq = Cout / 4;
  const long long plane = M * Cout;
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
      const float4 b = *reinterpret_cast<const float4*>(part_s2 + s * plane + o);
      vm.x += a.x; vm.y += a.y; vm.z += a.z; vm.w += a.w;
      vs.x += b.x; vs.y += b.y; vs.z += b.z; vs.w += b.w;
      wn += part_win[s * M + m];
    }
    const float4 v = *reinterpret_cast<const float4*>(sw + co);
    vs.x += wn * v.x; vs.y += wn * v.y; vs.z += wn * v.z; vs.w += wn * v.w;
    if (RELU) {
      if (!(vm.x > 0.f)) vm.x = vs.x = 0.f;
      if (!(vm.y > 0.f)) vm.y = vs.y = 0.f;
      if (!(vm.z > 0.f)) vm.z = vs.z = 0.f;
      if (!(vm.w > 0.f)) vm.w = vs.w = 0.f;
    }
    *reinterpret_cast<float4*>(mu_out + o) = vm;
    *reinterpret_cast<float4*>(sig_out + o) = vs;
    if (co == 0) win_out[m] = wn;
  }
}

struct Args {
  const float *mu, *sigma, *w_mu, *sw;
  float *mu_out, *sig_out, *win, *part;
  int B, H, W, Cin, Cout, splits;
  cudaStream_t stream;
};

template <int NT, bool HAS_SIGMA, bool RELU, bool SPLIT>
cudaError_t launch_wgmma(const Args& a) {
  const int Ho = a.H - 2, Wo = a.W - 2;
  const long long M = static_cast<long long>(a.B) * Ho * Wo;
  const long long m_tiles = (M + kTileM - 1) / kTileM;
  if (m_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(m_tiles), (a.Cout + NT - 1) / NT,
                  a.splits);
  const size_t bytes = Smem<NT>::floats * sizeof(float);
  auto kernel = vdp_conv_kernel_wgmma<NT, HAS_SIGMA, RELU, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      a.mu, a.sigma, a.w_mu, a.sw, a.mu_out, a.sig_out, a.win, a.part, a.H,
      a.W, a.Cin, a.Cout, Ho, Wo, M, a.Cin / kK / a.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return err;
  const long long quads = M * (a.Cout / 4);
  const long long blocks = (quads + 255) / 256;
  vdp_conv_kernel_splitk_reduce<RELU>
      <<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), 256, 0,
         a.stream>>>(a.part, a.sw, a.mu_out, a.sig_out, a.win, M, a.Cout,
                     a.splits);
  return cudaGetLastError();
}

// The instance for (sigma or not, ReLU or not, split or not).
template <int NT>
cudaError_t dispatch_wgmma(const Args& a, bool relu) {
  const bool split = a.splits > 1;
  if (a.sigma != nullptr) {
    if (relu) {
      return split ? launch_wgmma<NT, true, true, true>(a)
                   : launch_wgmma<NT, true, true, false>(a);
    }
    return split ? launch_wgmma<NT, true, false, true>(a)
                 : launch_wgmma<NT, true, false, false>(a);
  }
  if (relu) {
    return split ? launch_wgmma<NT, false, true, true>(a)
                 : launch_wgmma<NT, false, true, false>(a);
  }
  return split ? launch_wgmma<NT, false, false, true>(a)
               : launch_wgmma<NT, false, false, false>(a);
}

}  // namespace tc

}  // namespace

// mu (and sigma, or null for the input layer): [B, H, W, Cin] float32;
// w_mu: [k, k, Cin, Cout] (HWIO); sw: softplus(w_sigma), [Cout].
// mu_out, sig_out: [B, H-k+1, W-k+1, Cout]; win: [B, H-k+1, W-k+1, 1].
// All contiguous, and 16-byte aligned on the tensor-core path.
// path 0: the CUDA-core kernel, tile_n (CT) 32 or 64, splits 1.
// path 1: the tensor-core kernel: k 3, Cin % 8 == 0, Cout % 4 == 0,
//   9 Cin Cout and 3 W Cin below 2^31 (its step offsets are ints),
//   tile_n 32 or 64, splits dividing Cin / 8; with splits > 1, `scratch`
//   holds 2 splits M Cout + splits M floats (M = B (H-2) (W-2)).
// The plan comes from ops/kernels/vdp_conv.py:plan. Launches on `stream`
// and returns cudaGetLastError(); a plan the kernels do not take is
// cudaErrorInvalidValue, and a k whose CUDA-core tiles need more shared
// memory than a block may have comes back as the error of
// cudaFuncSetAttribute.
extern "C" int supernet_vdp_conv_fwd(const void* mu, const void* sigma,
                                     const void* w_mu, const void* sw,
                                     void* mu_out, void* sig_out, void* win,
                                     void* scratch, int B, int H, int W,
                                     int Cin, int Cout, int k, int fuse_relu,
                                     int path, int tile_n, int splits,
                                     void* stream) {
  const auto* m = static_cast<const float*>(mu);
  const auto* s = static_cast<const float*>(sigma);
  const auto* w = static_cast<const float*>(w_mu);
  const auto* v = static_cast<const float*>(sw);
  auto* mo = static_cast<float*>(mu_out);
  auto* so = static_cast<float*>(sig_out);
  auto* wo = static_cast<float*>(win);
  auto* part = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  const bool relu = fuse_relu != 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (path == 0 && splits == 1 && (tile_n == 32 || tile_n == 64)) {
    err = tile_n == 64 ? dispatch<64>(m, s, w, v, mo, so, wo, B, H, W, Cin,
                                      Cout, k, relu, st)
                       : dispatch<32>(m, s, w, v, mo, so, wo, B, H, W, Cin,
                                      Cout, k, relu, st);
  } else if (path == 1 && k == 3 && Cin % tc::kK == 0 && Cout % 4 == 0 &&
             9LL * Cin * Cout < (1LL << 31) && 3LL * W * Cin < (1LL << 31) &&
             splits >= 1 && (Cin / tc::kK) % splits == 0 &&
             (splits == 1 || part != nullptr)) {
    const tc::Args a{m, s, w, v, mo, so, wo, part, B, H, W, Cin, Cout, splits,
                     st};
    if (tile_n == 32) err = tc::dispatch_wgmma<32>(a, relu);
    if (tile_n == 64) err = tc::dispatch_wgmma<64>(a, relu);
  }
  return static_cast<int>(err);
}
