// Normalisation moments of the Swin UNETR plan for Hopper, sm_90a: LayerNorm
// over the channels of each token ("rows") and InstanceNorm over D*H*W of each
// channel of each NDHWC volume ("slices"), forward and backward.
//
// Replaces no TPU kernel: the JAX package has no norm. It replaces the chain
// of PyTorch operations that ops/moments_swin.py:vnorm took on the card, and
// autograd's backward of it (about 100 operations a norm). The closed form is
// that module's docstring: with m and s = sqrt(v + eps) the statistics of mu
// over the N elements of a slice, c = mu - m, x = c / s, and A, B, D the sums
// of sigma, x sigma and x^2 sigma over the slice,
//   mu'    = gamma x + beta
//   sigma' = (gamma / s)^2 [sigma (1 - 2 (1 + x^2) / N) + (A + 2 x B + x^2 D) / N^2].
// The backward is its gradient in closed form (derived beside the plain
// version, ops/kernels/vdp_norm.py:norm_bwd_plain). With G = g_sigma' gamma^2
// / s^2 and gx = g_mu' gamma, eight sums over the slice
//   S0, S1, S2 = sum G, G x, G x^2;   P0, P1 = sum gx, gx x;
//   Q0, Q1, Q2 = sum G sigma, G sigma x, G sigma x^2
// give every element's gradients:
//   g_sigma = G (1 - 2 (1 + x^2) / N) + (S0 + 2 x S1 + x^2 S2) / N^2
//   gX      = gx + G (-4 x sigma / N + 2 (B + x D) / N^2) + 2 sigma (S1 + x S2) / N^2
//   g_mu    = gX / s + x c1 + c0,  c0 = -sum gX / (N s),
//             c1 = -(2 T / s + sum gX x / s) / N,  T = sum G inner
// (sum gX, sum gX x and T follow from the eight sums and A, B, D), and for
// LayerNorm the sums over the tokens of g_mu' and of g_mu' x + 2 gamma
// g_sigma' inner / s^2 give g_beta and g_gamma.
//
// What bounds it: bytes. A few flops per element, far below the card's
// ridge, so the design moves each tensor as few times as it can. The
// statistics are centred: the mean first, then the sums of c^2, sigma,
// c sigma and c^2 sigma (no raw-moment algebra). Per-thread and per-block
// sums are float32; sums across blocks are float64, in a fixed order. No
// float atomics: two runs give the same bits. No tensor cores, no TF32.
//
// Rows (LayerNorm, C <= 4096): a row lies in the registers of one block of
// TPR threads (a warp for C <= 256, up to 512 threads above), each holding up
// to 8 elements strided by TPR, so that the block's loads are contiguous. The
// forward reads mu and sigma once and writes both outputs once (4 transfers
// of the tensor's size); the backward reads mu, sigma and both cotangents
// once and writes both gradients once (6). A thread keeps the gamma and beta
// sums of its channels in registers over the rows its block takes, the block
// writes them as one partial row, and vdp_norm_fold_kernel sums the blocks'
// partial rows in float64.
//
// Slices (InstanceNorm, C % 4 == 0): a block is qx threads across channel
// units (four channels, one 16-byte load) by py threads across positions; it
// owns one chunk of positions of one volume and one tile of channels. The
// grid is about one wave of such blocks, every thread walking its chunk with
// the stride py, so a thread keeps its channels' sums in registers. Forward:
// the mean pass, the pass for the four sums, each folded per channel in
// float64 by vdp_norm_fold_kernel, then the output pass (7 transfers).
// Backward: one pass for the eight sums, a fold that turns them into ten
// per-slice coefficients, then the elementwise pass (10 transfers).

#include <cuda_runtime.h>

namespace {

constexpr int kRowElems = 8;      // elements of a row one thread holds
constexpr int kVec = 4;           // channels of a slice thread's 16-byte load
constexpr int kSliceThreads = 256;
constexpr int kFoldCh = 8;        // channels of a fold block
constexpr int kFoldSlices = 32;   // partial rows a fold block takes at once
constexpr int kCoef = 10;         // the backward's per-slice coefficients

// The sums of v[0..NV) over the TPR threads of a row's block, in every
// thread. A butterfly over the lanes of each warp adds the same pairs in
// every lane (float addition commutes), so its lanes hold the same bits.
// TPR > 32: the warps' sums meet in `red` ([TPR / 32][NV]) and every thread
// adds them in warp order.
template <int TPR, int NV>
__device__ __forceinline__ void row_sum(float (&v)[NV], float* red) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if constexpr (TPR > 32) {
    constexpr int kWarps = TPR / 32;
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) red[warp * NV + i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float t = red[i];
      for (int w = 1; w < kWarps; ++w) t += red[w * NV + i];
      v[i] = t;
    }
    __syncthreads();  // red is written again by the next reduction
  }
}

// stats: [5][rows] (m, s, A, B, D); gamma, beta: [C] or null.
template <int TPR>
__global__ void __launch_bounds__(TPR) vdp_norm_row_fwd_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out_mu, float* __restrict__ out_sigma,
    float* __restrict__ stats, long long rows, int C, float eps) {
  __shared__ float red[TPR > 32 ? TPR / 32 * 4 : 1];
  const int t = threadIdx.x;
  const float n = static_cast<float>(C);
  const float nn = n * n;
  float g[kRowElems], b[kRowElems];
#pragma unroll
  for (int k = 0; k < kRowElems; ++k) {
    const int j = t + k * TPR;
    g[k] = (gamma != nullptr && j < C) ? gamma[j] : 1.f;
    b[k] = (beta != nullptr && j < C) ? beta[j] : 0.f;
  }
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* mr = mu + row * C;
    const float* sr = sigma + row * C;
    float vm[kRowElems], vs[kRowElems];
    float sum[1] = {0.f};
#pragma unroll
    for (int k = 0; k < kRowElems; ++k) {
      const int j = t + k * TPR;
      vm[k] = j < C ? mr[j] : 0.f;
      vs[k] = j < C ? sr[j] : 0.f;
      sum[0] += vm[k];
    }
    row_sum<TPR, 1>(sum, red);
    const float m = sum[0] / n;
    float q[4] = {0.f, 0.f, 0.f, 0.f};  // c^2, sigma, c sigma, c^2 sigma
#pragma unroll
    for (int k = 0; k < kRowElems; ++k) {
      const float c = t + k * TPR < C ? vm[k] - m : 0.f;
      const float cs = c * vs[k];
      q[0] = fmaf(c, c, q[0]);
      q[1] += vs[k];
      q[2] += cs;
      q[3] = fmaf(c, cs, q[3]);
      vm[k] = c;
    }
    row_sum<TPR, 4>(q, red);
    const float s = sqrtf(q[0] / n + eps);
    const float A = q[1], B = q[2] / s, D = q[3] / (s * s);
    if (t == 0) {
      stats[row] = m;
      stats[rows + row] = s;
      stats[2 * rows + row] = A;
      stats[3 * rows + row] = B;
      stats[4 * rows + row] = D;
    }
    const float inv_s2 = 1.f / (s * s);
    float* om = out_mu + row * C;
    float* os = out_sigma + row * C;
#pragma unroll
    for (int k = 0; k < kRowElems; ++k) {
      const int j = t + k * TPR;
      if (j < C) {
        const float x = vm[k] / s;
        const float x2 = x * x;
        const float inner = vs[k] * (1.f - 2.f * (1.f + x2) / n) + (A + 2.f * x * B + x2 * D) / nn;
        om[j] = x * g[k] + b[k];
        os[j] = (inv_s2 * (g[k] * g[k])) * inner;
      }
    }
  }
}

// stats: the forward's; part: [gridDim.x][2][C] (the block's g_gamma and
// g_beta sums) or null when neither is wanted.
template <int TPR>
__global__ void __launch_bounds__(TPR) vdp_norm_row_bwd_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ g_mu, const float* __restrict__ g_sigma,
    const float* __restrict__ gamma, const float* __restrict__ stats,
    float* __restrict__ d_mu, float* __restrict__ d_sigma,
    float* __restrict__ part, long long rows, int C) {
  __shared__ float red[TPR > 32 ? TPR / 32 * 8 : 1];
  const int t = threadIdx.x;
  const float n = static_cast<float>(C);
  const float nn = n * n;
  float g[kRowElems], acc_g[kRowElems], acc_b[kRowElems];
#pragma unroll
  for (int k = 0; k < kRowElems; ++k) {
    const int j = t + k * TPR;
    g[k] = (gamma != nullptr && j < C) ? gamma[j] : 1.f;
    acc_g[k] = 0.f;
    acc_b[k] = 0.f;
  }
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float m = stats[row], s = stats[rows + row];
    const float A = stats[2 * rows + row], B = stats[3 * rows + row];
    const float D = stats[4 * rows + row];
    const float inv_s2 = 1.f / (s * s);
    const long long off = row * C;
    float x[kRowElems], vs[kRowElems], gm[kRowElems], gs[kRowElems], G[kRowElems];
    float q[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kRowElems; ++k) {
      const int j = t + k * TPR;
      const bool on = j < C;
      x[k] = on ? (mu[off + j] - m) / s : 0.f;
      vs[k] = on ? sigma[off + j] : 0.f;
      gm[k] = on ? g_mu[off + j] : 0.f;
      gs[k] = on ? g_sigma[off + j] : 0.f;
      G[k] = gs[k] * (inv_s2 * (g[k] * g[k]));
      const float gx = gm[k] * g[k];
      const float Gs = G[k] * vs[k];
      q[0] += G[k];
      q[1] = fmaf(G[k], x[k], q[1]);
      q[2] = fmaf(G[k] * x[k], x[k], q[2]);
      q[3] += gx;
      q[4] = fmaf(gx, x[k], q[4]);
      q[5] += Gs;
      q[6] = fmaf(Gs, x[k], q[6]);
      q[7] = fmaf(Gs * x[k], x[k], q[7]);
    }
    row_sum<TPR, 8>(q, red);
    const float S0 = q[0], S1 = q[1], S2 = q[2], P0 = q[3], P1 = q[4];
    const float Q0 = q[5], Q1 = q[6], Q2 = q[7];
    const float sum_gX = P0 - 4.f * Q1 / n + 2.f * (B * S0 + (D + A) * S1 + B * S2) / nn;
    const float sum_gXx = P1 - 4.f * Q2 / n + 4.f * (B * S1 + D * S2) / nn;
    const float T = Q0 * (1.f - 2.f / n) - 2.f * Q2 / n + (A * S0 + 2.f * B * S1 + D * S2) / nn;
    const float c0 = -sum_gX / (n * s);
    const float c1 = -(2.f * T + sum_gXx) / (n * s);
    float* dm = d_mu + off;
    float* ds = d_sigma + off;
#pragma unroll
    for (int k = 0; k < kRowElems; ++k) {
      const int j = t + k * TPR;
      if (j < C) {
        const float xk = x[k], x2 = xk * xk;
        const float keep = 1.f - 2.f * (1.f + x2) / n;
        ds[j] = G[k] * keep + (S0 + 2.f * xk * S1 + x2 * S2) / nn;
        const float gX = gm[k] * g[k] +
                         G[k] * (-4.f * xk * vs[k] / n + 2.f * (B + xk * D) / nn) +
                         2.f * vs[k] * (S1 + xk * S2) / nn;
        dm[j] = gX / s + xk * c1 + c0;
        if (part != nullptr) {
          const float inner = vs[k] * keep + (A + 2.f * xk * B + x2 * D) / nn;
          acc_b[k] += gm[k];
          acc_g[k] += gm[k] * xk + 2.f * g[k] * gs[k] * inner * inv_s2;
        }
      }
    }
  }
  if (part == nullptr) return;
  float* out = part + static_cast<long long>(blockIdx.x) * 2 * C;
#pragma unroll
  for (int k = 0; k < kRowElems; ++k) {
    const int j = t + k * TPR;
    if (j < C) {
      out[j] = acc_g[k];
      out[C + j] = acc_b[k];
    }
  }
}

// Sums NSUM partial values per (volume, channel) over `count` partial rows
// in float64, in a fixed order. part: [gridDim.y volumes][count][NSUM][C].
// A block takes 8 channels (blockIdx.x) of one volume (blockIdx.y); its
// thread (channel, slice) adds rows slice, slice + 32, ... in order, the
// slices then meet in a fixed tree, and slice 0 hands the totals to
// `finish(volume, channel, totals)`.
template <int NSUM, typename Finish>
__global__ void __launch_bounds__(kFoldCh * kFoldSlices) vdp_norm_fold_kernel(
    const float* __restrict__ part, int count, int C, Finish finish) {
  __shared__ double s_fold[kFoldSlices][NSUM][kFoldCh];
  const int ch = threadIdx.x % kFoldCh, slice = threadIdx.x / kFoldCh;
  const int c = static_cast<int>(blockIdx.x) * kFoldCh + ch;
  const int b = static_cast<int>(blockIdx.y);
  double acc[NSUM];
#pragma unroll
  for (int i = 0; i < NSUM; ++i) acc[i] = 0.0;
  if (c < C) {
    const float* p = part + static_cast<long long>(b) * count * NSUM * C + c;
    for (int r = slice; r < count; r += kFoldSlices) {
#pragma unroll
      for (int i = 0; i < NSUM; ++i) {
        acc[i] += static_cast<double>(p[(static_cast<long long>(r) * NSUM + i) * C]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NSUM; ++i) s_fold[slice][i][ch] = acc[i];
  __syncthreads();
  for (int o = kFoldSlices / 2; o > 0; o >>= 1) {
    if (slice < o) {
#pragma unroll
      for (int i = 0; i < NSUM; ++i) s_fold[slice][i][ch] += s_fold[slice + o][i][ch];
    }
    __syncthreads();
  }
  if (slice == 0 && c < C) {
    double tot[NSUM];
#pragma unroll
    for (int i = 0; i < NSUM; ++i) tot[i] = s_fold[0][i][ch];
    finish(b, c, tot);
  }
}

// The finishing steps of the folds. stats and coef are [k][S], S = B C, a
// slice's index b C + c.
struct FinishMean {
  float* stats;
  double n;
  int C;
  __device__ void operator()(int b, int c, const double* t) const {
    stats[static_cast<long long>(b) * C + c] = static_cast<float>(t[0] / n);
  }
};

struct FinishMoments {
  float* stats;
  long long S;
  double n, eps;
  int C;
  __device__ void operator()(int b, int c, const double* t) const {
    const long long i = static_cast<long long>(b) * C + c;
    const double s = sqrt(t[0] / n + eps);
    stats[S + i] = static_cast<float>(s);
    stats[2 * S + i] = static_cast<float>(t[1]);
    stats[3 * S + i] = static_cast<float>(t[2] / s);
    stats[4 * S + i] = static_cast<float>(t[3] / (s * s));
  }
};

// t: S0, S1, S2, P0, P1, Q0, Q1, Q2 (the file's comment). coef: m, s,
// 1 / s^2, S0 / N^2, 2 S1 / N^2, S2 / N^2, 2 B / N^2, 2 D / N^2, c0, c1.
struct FinishBwd {
  const float* stats;
  float* coef;
  long long S;
  double n;
  int C;
  __device__ void operator()(int b, int c, const double* t) const {
    const long long i = static_cast<long long>(b) * C + c;
    const float m = stats[i], s32 = stats[S + i];
    const double s = s32, A = stats[2 * S + i], B = stats[3 * S + i], D = stats[4 * S + i];
    const double S0 = t[0], S1 = t[1], S2 = t[2], P0 = t[3], P1 = t[4];
    const double Q0 = t[5], Q1 = t[6], Q2 = t[7];
    const double nn = n * n;
    const double sum_gX = P0 - 4.0 * Q1 / n + 2.0 * (B * S0 + (D + A) * S1 + B * S2) / nn;
    const double sum_gXx = P1 - 4.0 * Q2 / n + 4.0 * (B * S1 + D * S2) / nn;
    const double T = Q0 * (1.0 - 2.0 / n) - 2.0 * Q2 / n + (A * S0 + 2.0 * B * S1 + D * S2) / nn;
    const double v[kCoef] = {m, s, 1.0 / (s * s), S0 / nn, 2.0 * S1 / nn, S2 / nn,
                             2.0 * B / nn, 2.0 * D / nn, -sum_gX / (n * s),
                             -(2.0 * T + sum_gXx) / (n * s)};
#pragma unroll
    for (int k = 0; k < kCoef; ++k) coef[k * S + i] = static_cast<float>(v[k]);
  }
};

struct FinishAffine {
  float* d_gamma;
  float* d_beta;
  __device__ void operator()(int, int c, const double* t) const {
    d_gamma[c] = static_cast<float>(t[0]);
    d_beta[c] = static_cast<float>(t[1]);
  }
};

__device__ __forceinline__ void load4(const float* __restrict__ p, float (&v)[kVec]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

__device__ __forceinline__ void store4(float* __restrict__ p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Where a slice thread works: its volume, its first channel (c0, or -1 past
// C), and its positions p0 + threadIdx.y, + blockDim.y, ... below p1.
struct SliceSpot {
  long long p0, p1, base;  // base: the offset of (volume, position 0, c0)
  int b, c0;
};

__device__ __forceinline__ SliceSpot slice_spot(long long P, int C, long long chunk) {
  SliceSpot w;
  w.b = static_cast<int>(blockIdx.z);
  const int u = static_cast<int>(blockIdx.y * blockDim.x + threadIdx.x);
  w.c0 = u < C / kVec ? u * kVec : -1;
  w.p0 = static_cast<long long>(blockIdx.x) * chunk + threadIdx.y;
  w.p1 = min(static_cast<long long>(blockIdx.x + 1) * chunk, P);
  w.base = static_cast<long long>(w.b) * P * C + w.c0;
  return w;
}

// A slice block's sums: each thread's NV values over its positions, then the
// block's py threads of a channel unit added in order, written to part
// [B][gridDim.x][NSUM][C]. acc is ordered (sum k, channel j) -> k kVec + j.
template <int NSUM>
__device__ __forceinline__ void slice_block_sums(const float (&acc)[NSUM * kVec],
                                                 float* __restrict__ part, int C) {
  constexpr int NV = NSUM * kVec;
  extern __shared__ float red[];  // [py][qx][NV]
  const int qx = static_cast<int>(blockDim.x), py = static_cast<int>(blockDim.y);
  const int tid = static_cast<int>(threadIdx.y) * qx + static_cast<int>(threadIdx.x);
  float* mine = red + tid * NV;
#pragma unroll
  for (int i = 0; i < NV; ++i) mine[i] = acc[i];
  __syncthreads();
  float* out = part + (static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x) * NSUM * C;
  for (int e = tid; e < qx * NV; e += qx * py) {
    float tot = red[e];
    for (int r = 1; r < py; ++r) tot += red[r * qx * NV + e];
    const int ux = e / NV, i = e - ux * NV;
    const int k = i / kVec, j = i - k * kVec;
    const int c = (static_cast<int>(blockIdx.y) * qx + ux) * kVec + j;
    if (c < C) out[k * C + c] = tot;
  }
}

constexpr int kUnroll = 4;  // positions a slice thread loads before it adds

__global__ void __launch_bounds__(kSliceThreads) vdp_norm_slice_mean_kernel(
    const float* __restrict__ mu, float* __restrict__ part, long long P, int C,
    long long chunk) {
  const SliceSpot w = slice_spot(P, C, chunk);
  float acc[kVec] = {};
  if (w.c0 >= 0) {
    const long long step = blockDim.y;
    for (long long p = w.p0; p < w.p1; p += kUnroll * step) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const long long pp = p + i * step;
        if (pp < w.p1) {
          load4(mu + w.base + pp * C, v[i]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[i][j] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] += v[i][j];
      }
    }
  }
  slice_block_sums<1>(acc, part, C);
}

// stats[0] holds the mean.
__global__ void __launch_bounds__(kSliceThreads) vdp_norm_slice_moments_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ stats, float* __restrict__ part, long long P, int C,
    long long chunk) {
  const SliceSpot w = slice_spot(P, C, chunk);
  float acc[4 * kVec] = {};  // c^2, sigma, c sigma, c^2 sigma
  if (w.c0 >= 0) {
    float m[kVec];
    load4(stats + static_cast<long long>(w.b) * C + w.c0, m);
    const long long step = blockDim.y;
    for (long long p = w.p0; p < w.p1; p += kUnroll * step) {
      float vm[kUnroll][kVec], vs[kUnroll][kVec];
      bool ok[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const long long pp = p + i * step;
        ok[i] = pp < w.p1;
        if (ok[i]) {
          load4(mu + w.base + pp * C, vm[i]);
          load4(sigma + w.base + pp * C, vs[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        if (!ok[i]) continue;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float c = vm[i][j] - m[j];
          const float cs = c * vs[i][j];
          acc[j] = fmaf(c, c, acc[j]);
          acc[kVec + j] += vs[i][j];
          acc[2 * kVec + j] += cs;
          acc[3 * kVec + j] = fmaf(c, cs, acc[3 * kVec + j]);
        }
      }
    }
  }
  slice_block_sums<4>(acc, part, C);
}

__global__ void __launch_bounds__(kSliceThreads) vdp_norm_slice_out_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ stats, float* __restrict__ out_mu,
    float* __restrict__ out_sigma, long long P, int C, long long S, long long chunk) {
  const SliceSpot w = slice_spot(P, C, chunk);
  if (w.c0 < 0) return;
  const float n = static_cast<float>(P);
  const float nn = n * n;
  float m[kVec], s[kVec], A[kVec], B[kVec], D[kVec], inv_s2[kVec];
  const float* st = stats + static_cast<long long>(w.b) * C + w.c0;
  load4(st, m);
  load4(st + S, s);
  load4(st + 2 * S, A);
  load4(st + 3 * S, B);
  load4(st + 4 * S, D);
#pragma unroll
  for (int j = 0; j < kVec; ++j) inv_s2[j] = 1.f / (s[j] * s[j]);
  const long long step = blockDim.y;
  constexpr int kU = 2;
  for (long long p = w.p0; p < w.p1; p += kU * step) {
    float vm[kU][kVec], vs[kU][kVec];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const long long pp = p + i * step;
      if (pp < w.p1) {
        load4(mu + w.base + pp * C, vm[i]);
        load4(sigma + w.base + pp * C, vs[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const long long pp = p + i * step;
      if (pp >= w.p1) continue;
      float om[kVec], os[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float x = (vm[i][j] - m[j]) / s[j];
        const float x2 = x * x;
        const float inner =
            vs[i][j] * (1.f - 2.f * (1.f + x2) / n) + (A[j] + 2.f * x * B[j] + x2 * D[j]) / nn;
        om[j] = x;
        os[j] = inv_s2[j] * inner;
      }
      store4(out_mu + w.base + pp * C, om);
      store4(out_sigma + w.base + pp * C, os);
    }
  }
}

// stats: m, s of the forward.
__global__ void __launch_bounds__(kSliceThreads) vdp_norm_slice_bwd_sums_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ g_mu, const float* __restrict__ g_sigma,
    const float* __restrict__ stats, float* __restrict__ part, long long P, int C,
    long long S, long long chunk) {
  const SliceSpot w = slice_spot(P, C, chunk);
  float acc[8 * kVec] = {};  // S0, S1, S2, P0, P1, Q0, Q1, Q2
  if (w.c0 >= 0) {
    float m[kVec], s[kVec], k[kVec];
    const float* st = stats + static_cast<long long>(w.b) * C + w.c0;
    load4(st, m);
    load4(st + S, s);
#pragma unroll
    for (int j = 0; j < kVec; ++j) k[j] = 1.f / (s[j] * s[j]);
    const long long step = blockDim.y;
    constexpr int kU = 2;
    for (long long p = w.p0; p < w.p1; p += kU * step) {
      float vm[kU][kVec], vs[kU][kVec], gm[kU][kVec], gs[kU][kVec];
      bool ok[kU];
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        const long long pp = p + i * step;
        ok[i] = pp < w.p1;
        if (ok[i]) {
          const long long o = w.base + pp * C;
          load4(mu + o, vm[i]);
          load4(sigma + o, vs[i]);
          load4(g_mu + o, gm[i]);
          load4(g_sigma + o, gs[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        if (!ok[i]) continue;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float x = (vm[i][j] - m[j]) / s[j];
          const float G = gs[i][j] * k[j];
          const float Gs = G * vs[i][j];
          acc[j] += G;
          acc[kVec + j] = fmaf(G, x, acc[kVec + j]);
          acc[2 * kVec + j] = fmaf(G * x, x, acc[2 * kVec + j]);
          acc[3 * kVec + j] += gm[i][j];
          acc[4 * kVec + j] = fmaf(gm[i][j], x, acc[4 * kVec + j]);
          acc[5 * kVec + j] += Gs;
          acc[6 * kVec + j] = fmaf(Gs, x, acc[6 * kVec + j]);
          acc[7 * kVec + j] = fmaf(Gs * x, x, acc[7 * kVec + j]);
        }
      }
    }
  }
  slice_block_sums<8>(acc, part, C);
}

// coef: FinishBwd's.
__global__ void __launch_bounds__(kSliceThreads) vdp_norm_slice_grad_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ g_mu, const float* __restrict__ g_sigma,
    const float* __restrict__ coef, float* __restrict__ d_mu,
    float* __restrict__ d_sigma, long long P, int C, long long S, long long chunk) {
  const SliceSpot w = slice_spot(P, C, chunk);
  if (w.c0 < 0) return;
  const float n = static_cast<float>(P);
  float cf[kCoef][kVec];
  const float* co = coef + static_cast<long long>(w.b) * C + w.c0;
#pragma unroll
  for (int i = 0; i < kCoef; ++i) load4(co + i * S, cf[i]);
  const long long step = blockDim.y;
  constexpr int kU = 2;
  for (long long p = w.p0; p < w.p1; p += kU * step) {
    float vm[kU][kVec], vs[kU][kVec], gm[kU][kVec], gs[kU][kVec];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const long long pp = p + i * step;
      if (pp < w.p1) {
        const long long o = w.base + pp * C;
        load4(mu + o, vm[i]);
        load4(sigma + o, vs[i]);
        load4(g_mu + o, gm[i]);
        load4(g_sigma + o, gs[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const long long pp = p + i * step;
      if (pp >= w.p1) continue;
      float dm[kVec], ds[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float s = cf[1][j];
        const float x = (vm[i][j] - cf[0][j]) / s;
        const float x2 = x * x;
        const float G = gs[i][j] * cf[2][j];
        ds[j] = G * (1.f - 2.f * (1.f + x2) / n) + cf[3][j] + cf[4][j] * x + cf[5][j] * x2;
        const float gX = gm[i][j] + G * (-4.f * x * vs[i][j] / n + cf[6][j] + cf[7][j] * x) +
                         vs[i][j] * (cf[4][j] + 2.f * cf[5][j] * x);
        dm[j] = gX / s + x * cf[9][j] + cf[8][j];
      }
      const long long o = w.base + pp * C;
      store4(d_mu + o, dm);
      store4(d_sigma + o, ds);
    }
  }
}

template <int NSUM, typename Finish>
cudaError_t fold(const float* part, int count, int C, int volumes, Finish finish,
                 cudaStream_t st) {
  const dim3 grid((C + kFoldCh - 1) / kFoldCh, volumes);
  vdp_norm_fold_kernel<NSUM, Finish><<<grid, kFoldCh * kFoldSlices, 0, st>>>(part, count, C,
                                                                             finish);
  return cudaGetLastError();
}

template <int TPR>
cudaError_t rows_fwd(const float* mu, const float* sigma, const float* gamma,
                     const float* beta, float* out_mu, float* out_sigma, float* stats,
                     long long rows, int C, float eps, int blocks, cudaStream_t st) {
  vdp_norm_row_fwd_kernel<TPR><<<blocks, TPR, 0, st>>>(
      mu, sigma, gamma, beta, out_mu, out_sigma, stats, rows, C, eps);
  return cudaGetLastError();
}

template <int TPR>
cudaError_t rows_bwd(const float* mu, const float* sigma, const float* g_mu,
                     const float* g_sigma, const float* gamma, const float* stats,
                     float* d_mu, float* d_sigma, float* part, float* d_gamma,
                     float* d_beta, long long rows, int C, int blocks, cudaStream_t st) {
  vdp_norm_row_bwd_kernel<TPR><<<blocks, TPR, 0, st>>>(
      mu, sigma, g_mu, g_sigma, gamma, stats, d_mu, d_sigma, part, rows, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  return fold<2>(part, blocks, C, 1, FinishAffine{d_gamma, d_beta}, st);
}

struct SliceGrid {
  dim3 grid, block;
  long long chunk;
  size_t smem_per_sum;  // bytes of slice_block_sums' buffer per sum
};

cudaError_t slices_fwd(const float* mu, const float* sigma, float* out_mu, float* out_sigma,
                       float* stats, float* part, int B, long long P, int C, float eps,
                       const SliceGrid& g, cudaStream_t st) {
  const long long S = static_cast<long long>(B) * C;
  const int chunks = static_cast<int>(g.grid.x);
  vdp_norm_slice_mean_kernel<<<g.grid, g.block, g.smem_per_sum, st>>>(mu, part, P, C, g.chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fold<1>(part, chunks, C, B, FinishMean{stats, static_cast<double>(P), C}, st);
  if (err != cudaSuccess) return err;
  vdp_norm_slice_moments_kernel<<<g.grid, g.block, 4 * g.smem_per_sum, st>>>(
      mu, sigma, stats, part, P, C, g.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fold<4>(part, chunks, C, B,
                FinishMoments{stats, S, static_cast<double>(P), static_cast<double>(eps), C},
                st);
  if (err != cudaSuccess) return err;
  vdp_norm_slice_out_kernel<<<g.grid, g.block, 0, st>>>(mu, sigma, stats, out_mu, out_sigma,
                                                        P, C, S, g.chunk);
  return cudaGetLastError();
}

cudaError_t slices_bwd(const float* mu, const float* sigma, const float* g_mu,
                       const float* g_sigma, const float* stats, float* coef, float* part,
                       float* d_mu, float* d_sigma, int B, long long P, int C,
                       const SliceGrid& g, cudaStream_t st) {
  const long long S = static_cast<long long>(B) * C;
  vdp_norm_slice_bwd_sums_kernel<<<g.grid, g.block, 8 * g.smem_per_sum, st>>>(
      mu, sigma, g_mu, g_sigma, stats, part, P, C, S, g.chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fold<8>(part, static_cast<int>(g.grid.x), C, B,
                FinishBwd{stats, coef, S, static_cast<double>(P), C}, st);
  if (err != cudaSuccess) return err;
  vdp_norm_slice_grad_kernel<<<g.grid, g.block, 0, st>>>(mu, sigma, g_mu, g_sigma, coef, d_mu,
                                                         d_sigma, P, C, S, g.chunk);
  return cudaGetLastError();
}

SliceGrid slice_grid(int B, int qx, int py, int ctiles, int chunks, long long chunk) {
  return SliceGrid{dim3(chunks, ctiles, B), dim3(qx, py), chunk,
                   static_cast<size_t>(qx) * py * kVec * sizeof(float)};
}

}  // namespace

// LayerNorm forward: mu, sigma, out_mu, out_sigma [rows][C]; gamma, beta [C]
// or null; stats [5][rows]. tpr: threads per row (32 ... 512), blocks: the
// grid (ops/kernels/vdp_norm.py:plan_rows).
extern "C" int supernet_vdp_norm_rows_fwd(const void* mu, const void* sigma,
                                          const void* gamma, const void* beta,
                                          void* out_mu, void* out_sigma, void* stats,
                                          long long rows, int C, float eps, int tpr,
                                          int blocks, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mu);
  const auto* s = static_cast<const float*>(sigma);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* om = static_cast<float*>(out_mu);
  auto* os = static_cast<float*>(out_sigma);
  auto* sp = static_cast<float*>(stats);
  cudaError_t err;
  switch (tpr) {
    case 32: err = rows_fwd<32>(m, s, g, b, om, os, sp, rows, C, eps, blocks, st); break;
    case 64: err = rows_fwd<64>(m, s, g, b, om, os, sp, rows, C, eps, blocks, st); break;
    case 128: err = rows_fwd<128>(m, s, g, b, om, os, sp, rows, C, eps, blocks, st); break;
    case 256: err = rows_fwd<256>(m, s, g, b, om, os, sp, rows, C, eps, blocks, st); break;
    case 512: err = rows_fwd<512>(m, s, g, b, om, os, sp, rows, C, eps, blocks, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// LayerNorm backward: d_mu, d_sigma [rows][C]; part [blocks][2][C] and
// d_gamma, d_beta [C], or all three null when no gamma or beta gradient is
// wanted.
extern "C" int supernet_vdp_norm_rows_bwd(const void* mu, const void* sigma, const void* g_mu,
                                          const void* g_sigma, const void* gamma,
                                          const void* stats, void* d_mu, void* d_sigma,
                                          void* part, void* d_gamma, void* d_beta,
                                          long long rows, int C, int tpr, int blocks,
                                          void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mu);
  const auto* s = static_cast<const float*>(sigma);
  const auto* gm = static_cast<const float*>(g_mu);
  const auto* gs = static_cast<const float*>(g_sigma);
  const auto* g = static_cast<const float*>(gamma);
  const auto* sp = static_cast<const float*>(stats);
  auto* dm = static_cast<float*>(d_mu);
  auto* ds = static_cast<float*>(d_sigma);
  auto* pp = static_cast<float*>(part);
  auto* dg = static_cast<float*>(d_gamma);
  auto* db = static_cast<float*>(d_beta);
  cudaError_t err;
  switch (tpr) {
    case 32: err = rows_bwd<32>(m, s, gm, gs, g, sp, dm, ds, pp, dg, db, rows, C, blocks, st); break;
    case 64: err = rows_bwd<64>(m, s, gm, gs, g, sp, dm, ds, pp, dg, db, rows, C, blocks, st); break;
    case 128: err = rows_bwd<128>(m, s, gm, gs, g, sp, dm, ds, pp, dg, db, rows, C, blocks, st); break;
    case 256: err = rows_bwd<256>(m, s, gm, gs, g, sp, dm, ds, pp, dg, db, rows, C, blocks, st); break;
    case 512: err = rows_bwd<512>(m, s, gm, gs, g, sp, dm, ds, pp, dg, db, rows, C, blocks, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// InstanceNorm forward: mu, sigma, out_mu, out_sigma [B][P][C]; stats [5][B C];
// part [B][chunks][4][C]. The grid is ops/kernels/vdp_norm.py:plan_slices'.
extern "C" int supernet_vdp_norm_slices_fwd(const void* mu, const void* sigma, void* out_mu,
                                            void* out_sigma, void* stats, void* part, int B,
                                            long long P, int C, float eps, int qx,
                                            int py, int ctiles, int chunks, long long chunk,
                                            void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const SliceGrid g = slice_grid(B, qx, py, ctiles, chunks, chunk);
  const auto* m = static_cast<const float*>(mu);
  const auto* s = static_cast<const float*>(sigma);
  auto* om = static_cast<float*>(out_mu);
  auto* os = static_cast<float*>(out_sigma);
  auto* sp = static_cast<float*>(stats);
  auto* pp = static_cast<float*>(part);
  if (C % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(slices_fwd(m, s, om, os, sp, pp, B, P, C, eps, g, st));
}

// InstanceNorm backward: d_mu, d_sigma [B][P][C]; stats the forward's; coef
// [10][B C]; part [B][chunks][8][C].
extern "C" int supernet_vdp_norm_slices_bwd(const void* mu, const void* sigma,
                                            const void* g_mu, const void* g_sigma,
                                            const void* stats, void* coef, void* part,
                                            void* d_mu, void* d_sigma, int B, long long P,
                                            int C, int qx, int py, int ctiles,
                                            int chunks, long long chunk, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const SliceGrid g = slice_grid(B, qx, py, ctiles, chunks, chunk);
  const auto* m = static_cast<const float*>(mu);
  const auto* s = static_cast<const float*>(sigma);
  const auto* gm = static_cast<const float*>(g_mu);
  const auto* gs = static_cast<const float*>(g_sigma);
  const auto* sp = static_cast<const float*>(stats);
  auto* cp = static_cast<float*>(coef);
  auto* pp = static_cast<float*>(part);
  auto* dm = static_cast<float*>(d_mu);
  auto* ds = static_cast<float*>(d_sigma);
  if (C % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(slices_bwd(m, s, gm, gs, sp, cp, pp, dm, ds, B, P, C, g, st));
}
