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
// What bounds it: bytes. Each element of g is read once for two
// multiply-adds, so the kernel is a streaming pass over g at device-memory
// bandwidth.
//
// Design. The TPU kernel walks the rows of one image in order and carries
// the last k-1 dt rows from one tile to the next. Blocks on the card run in
// no order, so the carry becomes a halo: a block owns kRows rows of u of one
// image, recomputes dt for the k-1 rows above them as well, keeps that
// (kRows+k-1) x W' tile of dt zero-padded in shared memory and spreads it
// along rows and columns there. dt is formed one pixel per warp, the lanes
// over channels (a warp reads a pixel's channels as one run of addresses)
// and reduced with shuffles. dsw counts only the block's own g rows (those
// of its u rows, so every g row counts once): each lane adds g * win for its
// channels into its warp's row of shared memory, the warps' rows are summed
// in a fixed order, and each block writes a partial [C]; the caller sums the
// partials, as the TPU path sums its per-image partials outside the kernel.
// Deterministic, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) sigma_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ t,
    const float* __restrict__ sw, float* __restrict__ u,
    float* __restrict__ dsw_part, int Hp, int Wp, int C, int k, int rows,
    int tiles) {
  const int H = Hp + k - 1, W = Wp + k - 1;
  const int pw = Wp + 2 * (k - 1);  // dt tile width, k-1 zeros each side
  const int ph = rows + k - 1;      // dt tile height, k-1 halo rows on top
  extern __shared__ float smem[];
  float* s_dt = smem;                  // [ph][pw]
  float* s_sw = s_dt + ph * pw;        // [C]
  float* s_dsw = s_sw + C;             // [kWarps][C]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y0 = (blockIdx.x % tiles) * rows;  // first u row of the block
  const long long b = blockIdx.x / tiles;

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
    const float* gp = g + pix * C;
    const bool own = row >= y0;
    const float tv = own ? t[pix] : 0.f;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gv = gp[c];
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
    u[(b * H + y0 + r) * W + x] = acc;
  }

  for (int c = tid; c < C; c += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += s_dsw[w * C + c];
    dsw_part[static_cast<long long>(blockIdx.x) * C + c] = acc;
  }
}

// Floats of dynamic shared memory one block needs for `rows` u rows.
long long smem_floats(int Wp, int C, int k, int rows) {
  return static_cast<long long>(rows + k - 1) * (Wp + 2 * (k - 1)) +
         static_cast<long long>(1 + kWarps) * C;
}

}  // namespace

// g: [B, Hp, Wp, C]; t: [B, Hp, Wp]; sw: [C]; all float32, contiguous.
// u: [B, Hp+k-1, Wp+k-1]; dsw_part: [B * tiles, C] with
// tiles = ceil((Hp+k-1) / rows), one partial per block. Launches on `stream`
// and returns cudaGetLastError(); a tile that needs more shared memory than
// a block may have comes back as the error of cudaFuncSetAttribute.
extern "C" int supernet_sigma_bwd(const void* g, const void* t, const void* sw,
                                  void* u, void* dsw_part, int B, int Hp,
                                  int Wp, int C, int k, int rows,
                                  void* stream) {
  const int H = Hp + k - 1;
  const int tiles = (H + rows - 1) / rows;
  const size_t bytes = smem_floats(Wp, C, k, rows) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sigma_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(B) * tiles;
  sigma_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(t),
      static_cast<const float*>(sw), static_cast<float*>(u),
      static_cast<float*>(dsw_part), Hp, Wp, C, k, rows, tiles);
  return static_cast<int>(cudaGetLastError());
}
