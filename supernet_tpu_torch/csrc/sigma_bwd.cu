// Sigma-chain backward of the fused VDP conv for Hopper, sm_90a.
//
// Replaces supernet_tpu/ops/pallas/sigma_bwd.py:_bwd_kernel (launched by
// _bwd_call). The variance output of a VDP conv holds the term
// win * s_w, where win [B,H',W'] is the k x k VALID window sum of the
// channel-summed source and s_w = softplus(w_sigma) [C]. Given its cotangent
// g [B,H',W',C], one pass over g gives
//   dt  = sum_c g * s_w                          [B,H',W']
//   u   = the transposed k x k ones-spread of dt [B,H'+k-1,W'+k-1]
//   dsw = sum_{b,h',w'} g * win                  [C]
//
// Dtypes, as the TPU kernel's (sigma_bwd.py:82-84, 106, 172-173): g and t
// are each float32 or bf16, s_w is float32; every product and sum runs in
// float32 on the loaded values (a bf16 value converts exactly), u comes out
// in t's dtype, rounded once as it is stored, and dsw in float32. Both paths
// keep the float32 plan and its order of sums, so a bf16 call computes the
// float32 call on the same values.
//
// What bounds it: bytes. Each element of g is read once for two
// multiply-adds, so the work is a streaming pass over g at device-memory
// bandwidth; dt and u are 1/C of g. The small layers are bound by the cost
// of a launch instead.
//
// Design. The TPU kernel walks the rows of one image in order and carries
// the last k-1 dt rows from one tile to the next. Blocks on the card run in
// no order and nothing carries over, so the work is cut where it needs no
// carry: two kernels, the first over g flat by pixel, the second over u.
//
// Pass 1 (sigma_bwd_dt_kernel, C % 4 == 0, C <= 512). A pixel's channels are
// C/4 quads of 4 channels (16 bytes of float32, 8 of bf16); a group of LANES
// lanes (8, 16 or 32) covers them in STEPS quad loads per lane, so at C = 32
// one load instruction of a warp reads four pixels. The groups of the whole grid walk the pixels with the stride
// of their number, UNROLL pixels per trip, which keeps four independent
// 16-byte loads of every lane in flight. A lane owns the same channels for
// its whole walk: s_w and its dsw sums stay in registers. dt of a pixel is
// reduced over the group's lanes by shuffles and written to a scratch
// [B,H',W']. At the end a block folds its groups' dsw sums (shuffles across
// the groups of a warp, then the warps in order through shared memory) and
// writes one partial row [C]. The grid is a function of the shape alone, so
// the partials and their order are too.
//
// Pass 2 (sigma_bwd_spread_kernel). One thread per element of u sums the
// k x k dt values that reach it (dt is small and sits in L2). Its first
// ceil(C/8) blocks sum the dsw partials instead: 8 channels per block, the
// rows dealt to the threads, each thread's rows in order, then a tree over
// the threads of a channel. Pass 2 is launched with programmatic stream
// serialization: pass 1 lets its dependents be scheduled as it starts
// (griddepcontrol.launch_dependents), pass 2 waits for pass 1's end and its
// writes before it reads anything (griddepcontrol.wait), so the second
// launch's latency hides behind the first kernel instead of following it.
//
// No atomics anywhere: u and dsw are the same bits in every run.
//
// Member axis (a deep ensemble's K parameter sets in one launch, the
// counterpart of jax.vmap over the Pallas call): g [K B, H', W', C] and t
// [K B, H', W'] member-major, s_w [K, C]; u [K B, H, W] and dsw [K, C]. In
// pass 1 blockIdx.y is the member: its blocks walk that member's pixels
// alone and write that member's partial rows, so no partial ever mixes two
// members; pass 2 writes u over all K B images (dt has the same layout) and
// its fold blocks take one member's channels each. The general path counts
// the member in its image index and reads that member's s_w.
//
// The general path (sigma_bwd_rows_kernel, any C) keeps the TPU kernel's row
// tiles: a block owns `rows` rows of u of one image, recomputes dt for the
// k-1 rows above them as a halo in shared memory (the carry's replacement),
// one pixel per warp with the lanes over channels, and writes a dsw partial
// per block that the caller sums.

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using supernet::bf16;
using supernet::from_f32;
using supernet::load4;
using supernet::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDswChannels = 8;  // channels per dsw-fold block of pass 2
constexpr int kDswSlices = kThreads / kDswChannels;

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, const float4 v, float s) {
  acc.x = fmaf(v.x, s, acc.x);
  acc.y = fmaf(v.y, s, acc.y);
  acc.z = fmaf(v.z, s, acc.z);
  acc.w = fmaf(v.w, s, acc.w);
}

// Per member (blockIdx.y): g: [P][C4][4]; t, dt: [P]; sw as float4:
// [C4]; part as float4: [gridDim.x][C4]. LANES * STEPS >= C4.
template <int LANES, int STEPS, int UNROLL, typename TG, typename TT>
__global__ void __launch_bounds__(kThreads) sigma_bwd_dt_kernel(
    const TG* __restrict__ g, const TT* __restrict__ t,
    const float4* __restrict__ sw, float* __restrict__ dt,
    float4* __restrict__ part, long long P, int C4) {
  constexpr int kGroups = kThreads / LANES;  // pixel groups per block
  __shared__ float4 s_part[kWarps][LANES * STEPS];
  const long long member = blockIdx.y;
  g += member * P * C4 * 4;
  t += member * P;
  dt += member * P;
  sw += member * C4;
  part += member * gridDim.x * C4;

  // pass 2 may be scheduled from now on; it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LANES;   // this lane's place in its group
  const int grp = lane / LANES;   // its group's place in the warp
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  // the first group of this warp: the trip count is the same for the whole
  // warp, so the shuffles below always find all 32 lanes
  const long long first =
      static_cast<long long>(blockIdx.x) * kGroups + warp * (32 / LANES);

  float4 w[STEPS], acc[STEPS];
  bool on[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int q = sub + s * LANES;
    on[s] = q < C4;
    w[s] = on[s] ? sw[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (long long base = first; base < P; base += stride * UNROLL) {
    float4 v[UNROLL][STEPS];
    float tv[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long p = base + grp + j * stride;
      const bool ok = p < P;
      tv[j] = ok ? to_f32(t[p]) : 0.f;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        v[j][s] = (ok && on[s]) ? load4(g + 4 * (p * C4 + sub + s * LANES))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      float d = 0.f;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        d = dot4(v[j][s], w[s], d);
        axpy4(acc[s], v[j][s], tv[j]);
      }
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1) {
        d += __shfl_xor_sync(0xffffffffu, d, o);
      }
      const long long p = base + grp + j * stride;
      if (sub == 0 && p < P) dt[p] = d;
    }
  }

  // dsw: the groups of a warp own the same channels, fold them by shuffles,
  // then the warps in order
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
#pragma unroll
    for (int o = LANES; o < 32; o <<= 1) {
      acc[s].x += __shfl_xor_sync(0xffffffffu, acc[s].x, o);
      acc[s].y += __shfl_xor_sync(0xffffffffu, acc[s].y, o);
      acc[s].z += __shfl_xor_sync(0xffffffffu, acc[s].z, o);
      acc[s].w += __shfl_xor_sync(0xffffffffu, acc[s].w, o);
    }
    if (lane < LANES) s_part[warp][sub + s * LANES] = acc[s];
  }
  __syncthreads();
  for (int q = tid; q < C4; q += kThreads) {
    float4 a = s_part[0][q];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) {
      const float4 b = s_part[i][q];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    part[static_cast<long long>(blockIdx.x) * C4 + q] = a;
  }
}

// dt: [K B][Hp][Wp]; part: [K][n_part][C]; u: [K B][H][W]; dsw: [K][C].
// Blocks 0 .. K dsw_blocks-1 fold the partials (member = block / dsw_blocks),
// the others write u. dt and part are written by pass 1 while this kernel
// may already be resident, so they are not declared read-only (no
// non-coherent loads).
template <typename TT>
__global__ void __launch_bounds__(kThreads) sigma_bwd_spread_kernel(
    const float* dt, const float* part, TT* __restrict__ u,
    float* __restrict__ dsw, int Hp, int Wp, int C, int k, int n_part,
    int dsw_blocks, unsigned total) {
  const int tid = threadIdx.x;
  // launched while pass 1 still runs: nothing of dt or part is read before
  // that grid has ended and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (static_cast<int>(blockIdx.x) < dsw_blocks) {
    __shared__ float s_fold[kDswSlices][kDswChannels];
    const int per_member = (C + kDswChannels - 1) / kDswChannels;
    const int member = blockIdx.x / per_member;
    const int ch = tid % kDswChannels, slice = tid / kDswChannels;
    const int c = (blockIdx.x - member * per_member) * kDswChannels + ch;
    part += static_cast<long long>(member) * n_part * C;
    dsw += static_cast<long long>(member) * C;
    float a = 0.f;
    if (c < C) {
#pragma unroll 4
      for (int r = slice; r < n_part; r += kDswSlices) {
        a += part[static_cast<long long>(r) * C + c];
      }
    }
    s_fold[slice][ch] = a;
    __syncthreads();
    for (int o = kDswSlices / 2; o > 0; o >>= 1) {
      if (slice < o) s_fold[slice][ch] += s_fold[slice + o][ch];
      __syncthreads();
    }
    if (slice == 0 && c < C) dsw[c] = s_fold[0][ch];
    return;
  }
  const unsigned e = (blockIdx.x - dsw_blocks) * kThreads + tid;
  if (e >= total) return;
  const unsigned H = Hp + k - 1, W = Wp + k - 1;
  const unsigned row = e / W;
  const int x = static_cast<int>(e - row * W);
  const unsigned b = row / H;
  const int y = static_cast<int>(row - b * H);
  const float* img = dt + static_cast<long long>(b) * Hp * Wp;
  float acc = 0.f;
  for (int di = 0; di < k; ++di) {
    const int yy = y - di;
    if (yy < 0 || yy >= Hp) continue;
    for (int dj = 0; dj < k; ++dj) {
      const int xx = x - dj;
      if (xx >= 0 && xx < Wp) acc += img[yy * Wp + xx];
    }
  }
  u[e] = from_f32<TT>(acc);
}

template <typename TG, typename TT>
__global__ void __launch_bounds__(kThreads) sigma_bwd_rows_kernel(
    const TG* __restrict__ g, const TT* __restrict__ t,
    const float* __restrict__ sw, TT* __restrict__ u,
    float* __restrict__ dsw_part, int Hp, int Wp, int C, int k, int rows,
    int tiles, int B) {
  const int H = Hp + k - 1, W = Wp + k - 1;
  const int pw = Wp + 2 * (k - 1);  // dt tile width, k-1 zeros each side
  const int ph = rows + k - 1;      // dt tile height, k-1 halo rows on top
  extern __shared__ float smem[];
  float* s_dt = smem;                  // [ph][pw]
  float* s_sw = s_dt + ph * pw;        // [C]
  float* s_dsw = s_sw + C;             // [kWarps][C]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y0 = (blockIdx.x % tiles) * rows;  // first u row of the block
  const long long b = blockIdx.x / tiles;      // image, member-major
  sw += (b / B) * C;                           // its member's s_w

  for (int i = tid; i < ph * pw; i += kThreads) s_dt[i] = 0.f;
  for (int i = tid; i < C; i += kThreads) s_sw[i] = sw[i];
  for (int i = tid; i < kWarps * C; i += kThreads) s_dsw[i] = 0.f;
  __syncthreads();

  // dt of g rows y0-k+1 .. y0+rows-1 (those inside the image); the block's
  // own rows (>= y0) also add to dsw
  float* my_dsw = s_dsw + warp * C;
  for (int p = warp; p < ph * Wp; p += kWarps) {
    const int m = p / Wp, x = p % Wp;
    const int row = y0 - (k - 1) + m;
    if (row < 0 || row >= Hp) continue;  // uniform across the warp
    const long long pix = (b * Hp + row) * Wp + x;
    const TG* gp = g + pix * C;
    const bool own = row >= y0;
    const float tv = own ? to_f32(t[pix]) : 0.f;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gv = to_f32(gp[c]);
      acc = fmaf(gv, s_sw[c], acc);
      if (own) my_dsw[c] = fmaf(gv, tv, my_dsw[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) s_dt[m * pw + x + (k - 1)] = acc;
  }
  __syncthreads();

  // u[y][x] = sum_{di,dj} dt[y-di][x-dj]; in tile coordinates the dt row of
  // u row y0+r is r+k-1-di and the dt column of x is x+k-1-dj
  const int n_rows = min(rows, H - y0);
  for (int e = tid; e < n_rows * W; e += kThreads) {
    const int r = e / W, x = e % W;
    float acc = 0.f;
    for (int di = 0; di < k; ++di) {
      const float* dr = s_dt + (r + k - 1 - di) * pw + x + k - 1;
      for (int dj = 0; dj < k; ++dj) acc += dr[-dj];
    }
    u[(b * H + y0 + r) * W + x] = from_f32<TT>(acc);
  }

  for (int c = tid; c < C; c += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += s_dsw[w * C + c];
    dsw_part[static_cast<long long>(blockIdx.x) * C + c] = acc;
  }
}

// Floats of dynamic shared memory one block of the general path needs for
// `rows` u rows.
long long smem_floats(int Wp, int C, int k, int rows) {
  return static_cast<long long>(rows + k - 1) * (Wp + 2 * (k - 1)) +
         static_cast<long long>(1 + kWarps) * C;
}

template <int LANES, int STEPS, int UNROLL, typename TG, typename TT>
void launch_dt(const TG* g, const TT* t, const float* sw, float* dt,
               float* part, long long P, int C4, int blocks, int members,
               cudaStream_t stream) {
  sigma_bwd_dt_kernel<LANES, STEPS, UNROLL, TG, TT>
      <<<dim3(static_cast<unsigned>(blocks), members), kThreads, 0, stream>>>(
          g, t, reinterpret_cast<const float4*>(sw), dt,
          reinterpret_cast<float4*>(part), P, C4);
}

template <typename TG, typename TT>
int sigma_bwd_vec(const void* g, const void* t, const void* sw, void* dt,
                  void* part, void* u, void* dsw, int B, int Hp, int Wp, int C,
                  int k, int lanes, int steps, int blocks, int members,
                  cudaStream_t st) {
  const int C4 = C / 4;
  const long long P = static_cast<long long>(B) * Hp * Wp;
  const long long total = static_cast<long long>(members) * B *
                          (Hp + k - 1) * (Wp + k - 1);
  const auto* gp = static_cast<const TG*>(g);
  const auto* tp = static_cast<const TT*>(t);
  const auto* sp = static_cast<const float*>(sw);
  auto* dp = static_cast<float*>(dt);
  auto* pp = static_cast<float*>(part);
  const int key = lanes * 8 + steps;
  switch (key) {
    case 8 * 8 + 1: launch_dt<8, 1, 4>(gp, tp, sp, dp, pp, P, C4, blocks, members, st); break;
    case 16 * 8 + 1: launch_dt<16, 1, 4>(gp, tp, sp, dp, pp, P, C4, blocks, members, st); break;
    case 32 * 8 + 1: launch_dt<32, 1, 4>(gp, tp, sp, dp, pp, P, C4, blocks, members, st); break;
    case 32 * 8 + 2: launch_dt<32, 2, 2>(gp, tp, sp, dp, pp, P, C4, blocks, members, st); break;
    case 32 * 8 + 3: launch_dt<32, 3, 1>(gp, tp, sp, dp, pp, P, C4, blocks, members, st); break;
    case 32 * 8 + 4: launch_dt<32, 4, 1>(gp, tp, sp, dp, pp, P, C4, blocks, members, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dsw_blocks = members * ((C + kDswChannels - 1) / kDswChannels);
  const long long u_blocks = (total + kThreads - 1) / kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(dsw_blocks + u_blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sigma_bwd_spread_kernel<TT>,
                           static_cast<const float*>(dp),
                           static_cast<const float*>(pp), static_cast<TT*>(u),
                           static_cast<float*>(dsw), Hp, Wp, C, k, blocks,
                           dsw_blocks, static_cast<unsigned>(total));
  return static_cast<int>(err);
}

template <typename TG, typename TT>
int sigma_bwd_rows(const void* g, const void* t, const void* sw, void* u,
                   void* dsw_part, int B, int Hp, int Wp, int C, int k,
                   int rows, int members, cudaStream_t st) {
  const int H = Hp + k - 1;
  const int tiles = (H + rows - 1) / rows;
  const size_t bytes = smem_floats(Wp, C, k, rows) * sizeof(float);
  auto kernel = sigma_bwd_rows_kernel<TG, TT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(members) * B * tiles;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, st>>>(
      static_cast<const TG*>(g), static_cast<const TT*>(t),
      static_cast<const float*>(sw), static_cast<TT*>(u),
      static_cast<float*>(dsw_part), Hp, Wp, C, k, rows, tiles, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The two-pass path. g: [members B, Hp, Wp, C] with C % 4 == 0, of dtype
// g_dtype; t: [members B, Hp, Wp] of dtype t_dtype (0 float32, 1 bf16);
// sw: [members, C] float32; all contiguous, g, sw and part on 16 bytes. dt:
// [members B, Hp, Wp] and part: [members, blocks, C] are float32 scratch;
// u: [members B, Hp+k-1, Wp+k-1] of t's dtype; dsw: [members, C] float32.
// `lanes` (8, 16 or 32) times `steps` (1..4, above 1 only with 32 lanes)
// covers C/4; `blocks` is pass 1's grid per member. Launches both kernels on
// `stream`, the second as a programmatic dependent of the first, and
// returns the first launch error.
extern "C" int supernet_sigma_bwd_vec(const void* g, const void* t,
                                      const void* sw, void* dt, void* part,
                                      void* u, void* dsw, int B, int Hp,
                                      int Wp, int C, int k, int lanes,
                                      int steps, int blocks, int members,
                                      int g_dtype, int t_dtype, void* stream) {
  const long long total = static_cast<long long>(members) * B *
                          (Hp + k - 1) * (Wp + k - 1);
  if (C % 4 != 0 || lanes * steps < C / 4 || blocks < 1 || members < 1 ||
      members > 65535 || total >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  constexpr int F = supernet::kFloat32, H = supernet::kBFloat16;
  if (g_dtype == F && t_dtype == F) {
    return sigma_bwd_vec<float, float>(g, t, sw, dt, part, u, dsw, B, Hp, Wp, C, k,
                                       lanes, steps, blocks, members, st);
  }
  if (g_dtype == H && t_dtype == F) {
    return sigma_bwd_vec<bf16, float>(g, t, sw, dt, part, u, dsw, B, Hp, Wp, C, k,
                                      lanes, steps, blocks, members, st);
  }
  if (g_dtype == F && t_dtype == H) {
    return sigma_bwd_vec<float, bf16>(g, t, sw, dt, part, u, dsw, B, Hp, Wp, C, k,
                                      lanes, steps, blocks, members, st);
  }
  if (g_dtype == H && t_dtype == H) {
    return sigma_bwd_vec<bf16, bf16>(g, t, sw, dt, part, u, dsw, B, Hp, Wp, C, k,
                                     lanes, steps, blocks, members, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The general path. g: [members B, Hp, Wp, C] of dtype g_dtype; t: [members
// B, Hp, Wp] of dtype t_dtype; sw: [members, C] float32; all contiguous. u:
// [members B, Hp+k-1, Wp+k-1] of t's dtype; dsw_part: [members B tiles, C]
// float32 with tiles = ceil((Hp+k-1) / rows), one partial per block
// (member-major). Launches on `stream` and returns cudaGetLastError(); a
// tile that needs more shared memory than a block may have comes back as
// the error of cudaFuncSetAttribute.
extern "C" int supernet_sigma_bwd(const void* g, const void* t, const void* sw,
                                  void* u, void* dsw_part, int B, int Hp,
                                  int Wp, int C, int k, int rows, int members,
                                  int g_dtype, int t_dtype, void* stream) {
  if (members < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  constexpr int F = supernet::kFloat32, H = supernet::kBFloat16;
  if (g_dtype == F && t_dtype == F) {
    return sigma_bwd_rows<float, float>(g, t, sw, u, dsw_part, B, Hp, Wp, C, k, rows, members, st);
  }
  if (g_dtype == H && t_dtype == F) {
    return sigma_bwd_rows<bf16, float>(g, t, sw, u, dsw_part, B, Hp, Wp, C, k, rows, members, st);
  }
  if (g_dtype == F && t_dtype == H) {
    return sigma_bwd_rows<float, bf16>(g, t, sw, u, dsw_part, B, Hp, Wp, C, k, rows, members, st);
  }
  if (g_dtype == H && t_dtype == H) {
    return sigma_bwd_rows<bf16, bf16>(g, t, sw, u, dsw_part, B, Hp, Wp, C, k, rows, members, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
