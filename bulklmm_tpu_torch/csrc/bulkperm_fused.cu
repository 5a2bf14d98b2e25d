// Fused bulk-permutation kernel for Hopper (sm_90a): genome-wide maxima of
// the squared permutation correlations, for a block of traits.
//
// Replaces bulklmm_tpu/pallas/bulkperm_fused.py::fused_perm_maxlods (the
// Pallas body `_kernel`). For every trait t of the block and every
// permutation k it contracts over the n samples and reduces over the p
// markers:
//
//     num[i]    = sum_s X[s,i] * S2[t,s,k]
//     out[t,k]  = max_i  num[i]^2 * inv_xn[t,i]
//
// X (n, p) is the rotated marker panel, shared by all traits; S2[t] (n, K)
// holds trait t's shuffled unit residuals, already residualized against its
// weighted covariates and folded with its sqrt-weights
// (kernels/bulkperm_fused.py::prepare_chunk_inputs); inv_xn[t,i] is the
// reciprocal squared norm of trait t's weighted, residualized marker i, and
// 0 where the marker is masked. The LOD transform of the maxima runs
// outside. The (traits x markers x permutations) tensor of num never
// reaches device memory: only the (mb, K) maxima are written.
//
// Design. A block of 256 threads owns one trait and a tile of kTileK
// permutations (64 or 128, a template parameter) and walks all markers, 64
// at a time; for each marker tile it walks n in chunks of 16 samples staged
// through shared memory, so n has no limit. The threads form a 16 x 16
// grid: each owns 4 contiguous markers and kTileK/16 permutations (in
// groups of 4 contiguous ones, 64 apart), read from shared memory as
// float4. After each marker tile a thread folds num^2 * inv_xn of its 4
// markers into its running maxima in registers; at the end one reduction
// through shared memory across the 16 marker lanes, and one write of the
// tile's maxima. No atomics and no zero-initialized output: the result is
// deterministic. Plain float32 FMA over the samples in order: no TF32, no
// tensor cores. Ragged p, K and n edges are masked: out-of-range samples,
// markers and permutations stage as zeros and a marker past p gets
// inv_xn = 0, so padding contributes r^2 = 0, the identity of the max
// (every real r^2 is >= 0); permutations past K are not stored.
//
// Every block re-reads all of X (n p 4 bytes, 2.3 MB at 79 x 7,321) from L2,
// so the L2 traffic is mb ceil(K / kTileK) n p 4 bytes; the wider
// permutation tile halves it and raises the FMAs per shared-memory load
// from 16 per 2 float4 to 32 per 3. The operands must be finite: fmaxf
// drops a NaN where a max that carries it is wanted.
//
// Bound: compute on the CUDA cores, 2 n p mb K flops against 4 mb n K bytes
// of S2 read once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, and never --use_fast_math.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileP = 64;    // markers per step
constexpr int kChunkN = 16;   // samples staged per step
constexpr int kThreads = 256;
constexpr int kLanes = 16;    // threads along each tile edge
constexpr int kRP = 4;        // markers per thread

// kRK: permutations per thread, 4 or 8; the block's tile is 16 * kRK wide.
template <int kRK>
__global__ void __launch_bounds__(kThreads)
bulkperm_kernel(const float* __restrict__ X,       // (n, p) rotated markers
                const float* __restrict__ S2,      // (mb, n, K) trait operands
                const float* __restrict__ inv_xn,  // (mb, p) 1 / marker norm^2, 0 = masked
                float* __restrict__ out,           // (mb, K) max r^2
                int n, int p, int K, int ktiles) {
  constexpr int kTileK = kLanes * kRK;
  constexpr int kGroups = kRK / 4;  // float4 groups of permutations per thread
  __shared__ __align__(16) float xs[kChunkN][kTileP];
  __shared__ __align__(16) float ss[kChunkN][kTileK];

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;  // permutation lane
  const int ty = tid / kLanes;  // marker lane
  const int t = blockIdx.x / ktiles;
  const int k0 = (blockIdx.x % ktiles) * kTileK;
  const float* St = S2 + (size_t)t * n * K;
  const float* wt = inv_xn + (size_t)t * p;

  float best[kRK];
#pragma unroll
  for (int j = 0; j < kRK; ++j) best[j] = 0.0f;

  for (int p0 = 0; p0 < p; p0 += kTileP) {
    float acc[kRP][kRK];
#pragma unroll
    for (int i = 0; i < kRP; ++i)
#pragma unroll
      for (int j = 0; j < kRK; ++j) acc[i][j] = 0.0f;

    for (int n0 = 0; n0 < n; n0 += kChunkN) {
#pragma unroll
      for (int r = 0; r < (kChunkN * kTileP) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int row = e / kTileP, col = e % kTileP;
        const int gn = n0 + row, gp = p0 + col;
        xs[row][col] = (gn < n && gp < p) ? X[(size_t)gn * p + gp] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < (kChunkN * kTileK) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        const int row = e / kTileK, col = e % kTileK;
        const int gn = n0 + row, gk = k0 + col;
        ss[row][col] = (gn < n && gk < K) ? St[(size_t)gn * K + gk] : 0.0f;
      }
      __syncthreads();

#pragma unroll
      for (int s = 0; s < kChunkN; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[s][kRP * ty]);
        const float x[kRP] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 yv = *reinterpret_cast<const float4*>(&ss[s][64 * g + 4 * tx]);
          const float y[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
          for (int i = 0; i < kRP; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][4 * g + j] = fmaf(x[i], y[j], acc[i][4 * g + j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const int gp = p0 + kRP * ty + i;
      const float w = gp < p ? wt[gp] : 0.0f;
#pragma unroll
      for (int j = 0; j < kRK; ++j) {
        // each product rounded on its own, as torch forms (num * num) * inv_xn
        const float r2 = __fmul_rn(__fmul_rn(acc[i][j], acc[i][j]), w);
        best[j] = fmaxf(best[j], r2);
      }
    }
  }

  // max across the 16 marker lanes; ss is free after the last barrier
  float (*red)[kTileK] = ss;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][64 * g + 4 * tx + j] = best[4 * g + j];
  __syncthreads();
  if (tid < kTileK && k0 + tid < K) {
    float m = red[0][tid];
#pragma unroll
    for (int r = 1; r < kLanes; ++r) m = fmaxf(m, red[r][tid]);
    out[(size_t)t * K + k0 + tid] = m;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous float32 arrays.
// tile_k is the permutation tile of a block, 64 or 128.
int bulklmm_bulkperm_maxr2(const float* X, const float* S2, const float* inv_xn, float* out,
                           int n, int p, int mb, int K, int tile_k, void* stream) {
  if (n <= 0 || p <= 0 || mb <= 0 || K <= 0 || (tile_k != 64 && tile_k != 128))
    return (int)cudaErrorInvalidValue;
  const int ktiles = (K + tile_k - 1) / tile_k;
  if ((long long)mb * ktiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(mb * ktiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_k == 64)
    bulkperm_kernel<4><<<grid, kThreads, 0, s>>>(X, S2, inv_xn, out, n, p, K, ktiles);
  else
    bulkperm_kernel<8><<<grid, kThreads, 0, s>>>(X, S2, inv_xn, out, n, p, K, ktiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
