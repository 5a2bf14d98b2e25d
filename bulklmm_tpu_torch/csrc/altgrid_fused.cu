// Fused alt-grid kernel for Hopper (sm_90a): the grid-approximated
// Exact-LMM scan.
//
// Replaces bulklmm_tpu/pallas/altgrid_fused.py::fused_alt_grid (the Pallas
// body `_kernel`). For every (marker i, trait j) and every h2 grid step k it
// contracts over the n samples
//
//     r_k   = sum_s Xn[k,s,i] * Yn[k,s,j]
//     u_k   = max(max(1 - r_k^2, FLT_MIN) * cmat[k,j], FLT_MIN)
//
// keeps the running minimum of u_k over k and its first index (strict `<`:
// the first minimum wins), and at the end writes
//
//     L[i,j] = -(n/2) log10(min_k u_k)        kidx[i,j] = argmin_k u_k
//
// which is (max_k logL1_k - max_k ell0_k) / ln 10 of the reference's
// alt-grid scan: minimizing u_k = (1 - r_k^2) exp(-(2/n)(ell0_k - max ell0))
// is maximizing the alternative log-likelihood, with no log in the loop.
//
// Design. The per-step weighting and residualization are done outside, in
// thin torch products (kernels/altgrid_fused.py::prepare_inputs): Xn[k] and
// Yn[k] are the sqrt-weighted markers and traits of grid step k with the
// weighted-covariate orthobasis projected out, the keep masks applied and
// each column normalized, so r_k is a plain dot product. The TPU kernel
// recomputed them in VMEM on every step to keep its input traffic
// independent of g; on this card they are small (g n (p + m) 4 bytes,
// ~135 MB at 79 x 7,321 x 35,554 with g = 10) and stay mostly in L2, so the
// kernel body is a pure contraction plus the epilogue. Only L (and the
// index, when asked for) reaches device memory: the (p, m) running minimum
// and argmin stay in registers across the g steps.
//
// A block of 256 threads owns a 64 x 64 (markers x traits) output tile; each
// thread owns a 4 x 4 micro-tile of contiguous markers and traits, read from
// shared memory as float4 (two 128-bit loads per 16 FMAs). For each grid
// step the block walks n in chunks of 16 samples staged through shared
// memory, so n has no limit. Plain float32 FMA: no TF32, no tensor cores.
// Ragged p, m and n edges are masked: out-of-range samples stage as zeros,
// out-of-range outputs are not stored. Bound: compute on the CUDA cores,
// 2 n p m g flops against one 4 p m byte write of L (and one of the index).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, and never --use_fast_math.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kTileP = 64;    // markers per block
constexpr int kTileM = 64;    // traits per block
constexpr int kChunkN = 16;   // samples staged per step
constexpr int kThreads = 256;
constexpr int kLanes = 16;    // threads along each tile edge
constexpr int kR = 4;         // markers and traits per thread

template <bool kPanel>
__global__ void __launch_bounds__(kThreads)
altgrid_kernel(const float* __restrict__ Xn,    // (g, n, p) per-step markers
               const float* __restrict__ Yn,    // (g, n, m) per-step traits
               const float* __restrict__ cmat,  // (g, m) per-step trait factors
               float* __restrict__ out,         // (p, m) LOD
               int* __restrict__ kidx,          // (p, m) argmin grid index
               int g, int n, int p, int m) {
  __shared__ __align__(16) float xs[kChunkN][kTileP];
  __shared__ __align__(16) float ys[kChunkN][kTileM];

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;  // trait lane
  const int ty = tid / kLanes;  // marker lane
  const int p0 = blockIdx.y * kTileP;
  const int m0 = blockIdx.x * kTileM;

  // set at k = 0, the first step of every block
  float umin[kR][kR] = {};
  int kmin[kR][kR] = {};

  for (int k = 0; k < g; ++k) {
    const float* X = Xn + (size_t)k * n * p;
    const float* Y = Yn + (size_t)k * n * m;
    float acc[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = 0.0f;

    for (int n0 = 0; n0 < n; n0 += kChunkN) {
#pragma unroll
      for (int r = 0; r < (kChunkN * kTileP) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int row = e / kTileP, col = e % kTileP;
        const int gn = n0 + row;
        const int gp = p0 + col, gm = m0 + col;
        const bool in_n = gn < n;
        xs[row][col] = (in_n && gp < p) ? X[(size_t)gn * p + gp] : 0.0f;
        ys[row][col] = (in_n && gm < m) ? Y[(size_t)gn * m + gm] : 0.0f;
      }
      __syncthreads();

#pragma unroll
      for (int s = 0; s < kChunkN; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[s][kR * ty]);
        const float4 yv = *reinterpret_cast<const float4*>(&ys[s][kR * tx]);
        const float x[kR] = {xv.x, xv.y, xv.z, xv.w};
        const float y[kR] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int gm = m0 + kR * tx + j;
      // traits past m get factor 1; they are never stored
      const float c = gm < m ? cmat[(size_t)k * m + gm] : 1.0f;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float r = acc[i][j];
        // __fmul_rn: r^2 rounded on its own, as torch forms it (no FMA)
        const float u = fmaxf(fmaxf(1.0f - __fmul_rn(r, r), FLT_MIN) * c, FLT_MIN);
        if (k == 0 || u < umin[i][j]) {  // strict: the first minimum wins
          umin[i][j] = u;
          if (kPanel) kmin[i][j] = k;
        }
      }
    }
  }

  const float neg_half_n = -0.5f * (float)n;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int gp = p0 + kR * ty + i;
    if (gp >= p) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int gm = m0 + kR * tx + j;
      if (gm >= m) continue;
      const size_t o = (size_t)gp * m + gm;
      out[o] = neg_half_n * log10f(umin[i][j]);
      if (kPanel) kidx[o] = kmin[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous arrays: Xn, Yn, cmat
// and out float32, kidx int32 or null (null: no index is carried or
// written).
int bulklmm_altgrid(const float* Xn, const float* Yn, const float* cmat, float* out,
                    int* kidx, int g, int n, int p, int m, void* stream) {
  if (g <= 0 || n <= 0 || p <= 0 || m <= 0 || (p + kTileP - 1) / kTileP > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kTileM - 1) / kTileM, (p + kTileP - 1) / kTileP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kidx != nullptr)
    altgrid_kernel<true><<<grid, kThreads, 0, s>>>(Xn, Yn, cmat, out, kidx, g, n, p, m);
  else
    altgrid_kernel<false><<<grid, kThreads, 0, s>>>(Xn, Yn, cmat, out, kidx, g, n, p, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
