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
// output shares, so the input has to be reused out of on-chip memory. Design:
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
//   once per output pixel before the epilogue;
// - every offset into the activations and weights is 64-bit.
// The tensor cores (wgmma), TMA and a pipelined load ring are for a later
// change; this kernel is the plain, exact baseline.

#include <cuda_runtime.h>

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

}  // namespace

// mu (and sigma, or null for the input layer): [B, H, W, Cin] float32;
// w_mu: [k, k, Cin, Cout] (HWIO); sw: softplus(w_sigma), [Cout].
// mu_out, sig_out: [B, H-k+1, W-k+1, Cout]; win: [B, H-k+1, W-k+1, 1].
// All contiguous. Launches on `stream` and returns cudaGetLastError(); a k
// whose tiles need more shared memory than a block may have comes back as
// the error of cudaFuncSetAttribute.
extern "C" int supernet_vdp_conv_fwd(const void* mu, const void* sigma,
                                     const void* w_mu, const void* sw,
                                     void* mu_out, void* sig_out, void* win,
                                     int B, int H, int W, int Cin, int Cout,
                                     int k, int fuse_relu, void* stream) {
  const auto* m = static_cast<const float*>(mu);
  const auto* s = static_cast<const float*>(sigma);
  const auto* w = static_cast<const float*>(w_mu);
  const auto* v = static_cast<const float*>(sw);
  auto* mo = static_cast<float*>(mu_out);
  auto* so = static_cast<float*>(sig_out);
  auto* wo = static_cast<float*>(win);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      Cout >= 64 ? dispatch<64>(m, s, w, v, mo, so, wo, B, H, W, Cin, Cout, k,
                                fuse_relu != 0, st)
                 : dispatch<32>(m, s, w, v, mo, so, wo, B, H, W, Cin, Cout, k,
                                fuse_relu != 0, st);
  return static_cast<int>(err);
}
