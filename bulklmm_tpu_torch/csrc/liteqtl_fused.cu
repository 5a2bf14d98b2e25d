// Fused per-trait-weight correlation -> LOD kernel for Hopper (sm_90a).
//
// Replaces bulklmm_tpu/pallas/liteqtl_fused.py::fused_lods_per_trait (the
// Pallas body `_kernel`). For every (marker i, trait j) it contracts over
// the n samples
//
//     B    = sum_s X[s,i] * WY[s,j]
//     D1   = sum_s (X[s,i] * X[s,i]) * W[s,j]
//     U_k  = sum_s (X[s,i] * C[s,k]) * W[s,j]          k < c
//
// and then, with the trait's packed Cholesky factor L of C^T diag(w_j) C,
// its zeta = L^{-1} C^T W y_j and its masked 1/nrm2 (the scalar block,
// prepared outside), finishes in registers:
//
//     Z = L^{-1} U,  N = B - sum_k Z_k zeta_k,  D = D1 - sum_k Z_k^2
//     keep = D > 1024 eps D1;  D = max(D, 4 eps D1)
//     r2 = keep ? N^2 inv_nrm2 / D : 0
//     LOD = -(n/2) log10(max(1 - r2, FLT_MIN))
//
// Only the (p, m) LOD matrix is written: the (c+2) (p, m) products never
// reach device memory.
//
// Design: a plain tiled SIMT kernel. A block of 256 threads owns a 64 x 64
// (markers x traits) output tile; each thread owns a 4 x 4 micro-tile,
// strided by 16 in both directions, so shared-memory reads are conflict
// free and each warp's stores hit contiguous trait columns. The block
// walks n in chunks of 16 samples staged through shared memory, so n has
// no limit. Each thread keeps (c+2) x 16 float32 accumulators and forms
// X*C_k and X*X from the staged tiles as it goes (plain FMA, no TF32, no
// tensor cores). Ragged p, m and n edges are masked: out-of-range samples
// stage as zeros and contribute nothing, out-of-range outputs are not
// stored. Bound: compute on the CUDA cores, about 2 (c+2) n p m flops
// against one 4 p m byte write.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, and never --use_fast_math (it would replace
//        log10f and the IEEE division and flush subnormals).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kTileP = 64;    // markers per block
constexpr int kTileM = 64;    // traits per block
constexpr int kChunkN = 16;   // samples staged per step
constexpr int kThreads = 256;
constexpr int kLanes = 16;    // threads along each tile edge
constexpr int kRP = kTileP / kLanes;  // markers per thread
constexpr int kRM = kTileM / kLanes;  // traits per thread

// Row of L[(i, k)], i >= k, in the column-major packed lower triangle.
__host__ __device__ constexpr int tri_row(int c, int i, int k) {
  return k * c - (k * (k - 1)) / 2 + (i - k);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
liteqtl_lod_kernel(const float* __restrict__ X,     // (n, p) rotated markers
                   const float* __restrict__ Cov,   // (n, C) rotated covariates
                   const float* __restrict__ W,     // (n, m) per-trait weights
                   const float* __restrict__ WY,    // (n, m) weighted traits
                   const float* __restrict__ scal,  // (S, m) per-trait scalars
                   float* __restrict__ out,         // (p, m) LOD
                   int n, int p, int m) {
  constexpr int kTri = C * (C + 1) / 2;
  constexpr int kS = kTri + C + 1;  // rows: L entries | zeta | inv_nrm2
  constexpr int kAcc = C + 2;       // B, D1, U_0 .. U_{C-1}

  __shared__ float xs[kChunkN][kTileP];
  __shared__ float ws[kChunkN][kTileM];
  __shared__ float wys[kChunkN][kTileM];
  __shared__ float cs[kChunkN][C];
  __shared__ float ss[kS][kTileM];

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;  // trait lane
  const int ty = tid / kLanes;  // marker lane
  const int p0 = blockIdx.y * kTileP;
  const int m0 = blockIdx.x * kTileM;

  for (int e = tid; e < kS * kTileM; e += kThreads) {
    const int row = e / kTileM, col = e % kTileM;
    const int gm = m0 + col;
    // columns past m get ones: no division by zero in lanes never stored
    ss[row][col] = gm < m ? scal[(size_t)row * m + gm] : 1.0f;
  }

  float acc[kAcc][kRP][kRM];
#pragma unroll
  for (int a = 0; a < kAcc; ++a)
#pragma unroll
    for (int i = 0; i < kRP; ++i)
#pragma unroll
      for (int j = 0; j < kRM; ++j) acc[a][i][j] = 0.0f;

  for (int n0 = 0; n0 < n; n0 += kChunkN) {
#pragma unroll
    for (int r = 0; r < (kChunkN * kTileP) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kTileP, col = e % kTileP;
      const int gn = n0 + row;
      const int gp = p0 + col, gm = m0 + col;
      const bool in_n = gn < n;
      xs[row][col] = (in_n && gp < p) ? X[(size_t)gn * p + gp] : 0.0f;
      ws[row][col] = (in_n && gm < m) ? W[(size_t)gn * m + gm] : 0.0f;
      wys[row][col] = (in_n && gm < m) ? WY[(size_t)gn * m + gm] : 0.0f;
    }
    if (tid < kChunkN * C) {
      const int row = tid / C, k = tid % C;
      const int gn = n0 + row;
      cs[row][k] = gn < n ? Cov[(size_t)gn * C + k] : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int s = 0; s < kChunkN; ++s) {
      float x[kRP], w[kRM], wy[kRM];
#pragma unroll
      for (int i = 0; i < kRP; ++i) x[i] = xs[s][ty + kLanes * i];
#pragma unroll
      for (int j = 0; j < kRM; ++j) {
        w[j] = ws[s][tx + kLanes * j];
        wy[j] = wys[s][tx + kLanes * j];
      }
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        const float xx = x[i] * x[i];
#pragma unroll
        for (int j = 0; j < kRM; ++j) {
          acc[0][i][j] = fmaf(x[i], wy[j], acc[0][i][j]);
          acc[1][i][j] = fmaf(xx, w[j], acc[1][i][j]);
        }
      }
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float ck = cs[s][k];
#pragma unroll
        for (int i = 0; i < kRP; ++i) {
          const float xc = x[i] * ck;
#pragma unroll
          for (int j = 0; j < kRM; ++j) acc[2 + k][i][j] = fmaf(xc, w[j], acc[2 + k][i][j]);
        }
      }
    }
    __syncthreads();
  }

  const float eps = FLT_EPSILON;
  const float neg_half_n = -0.5f * (float)n;
#pragma unroll
  for (int j = 0; j < kRM; ++j) {
    const int lm = tx + kLanes * j;
    const int gm = m0 + lm;
    const float inv_nrm2 = ss[kTri + C][lm];
#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const int gp = p0 + ty + kLanes * i;
      float z[C];
      float num = acc[0][i][j];
      const float d1 = acc[1][i][j];
      float d = d1;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        float t = acc[2 + k][i][j];
#pragma unroll
        for (int q = 0; q < k; ++q) t -= ss[tri_row(C, k, q)][lm] * z[q];
        z[k] = t / ss[tri_row(C, k, k)][lm];
        num -= z[k] * ss[kTri + k][lm];
        d -= z[k] * z[k];
      }
      const bool keep = d > 1024.0f * eps * d1;
      d = fmaxf(d, 4.0f * eps * d1);
      const float r2 = keep ? num * num * inv_nrm2 / d : 0.0f;
      const float one_minus = fmaxf(1.0f - r2, FLT_MIN);
      if (gp < p && gm < m) out[(size_t)gp * m + gm] = neg_half_n * log10f(one_minus);
    }
  }
}

template <int C>
cudaError_t launch(const float* X, const float* Cov, const float* W, const float* WY,
                   const float* scal, float* out, int n, int p, int m,
                   cudaStream_t stream) {
  const dim3 grid((m + kTileM - 1) / kTileM, (p + kTileP - 1) / kTileP);
  liteqtl_lod_kernel<C><<<grid, kThreads, 0, stream>>>(X, Cov, W, WY, scal, out, n, p, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous float32 arrays;
// c must be 1..8 (the instantiations below).
int bulklmm_liteqtl_lod(const float* X, const float* Cov, const float* W,
                        const float* WY, const float* scal, float* out, int n,
                        int p, int m, int c, void* stream) {
  if (n <= 0 || p <= 0 || m <= 0 || (p + kTileP - 1) / kTileP > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return (int)launch<1>(X, Cov, W, WY, scal, out, n, p, m, s);
    case 2: return (int)launch<2>(X, Cov, W, WY, scal, out, n, p, m, s);
    case 3: return (int)launch<3>(X, Cov, W, WY, scal, out, n, p, m, s);
    case 4: return (int)launch<4>(X, Cov, W, WY, scal, out, n, p, m, s);
    case 5: return (int)launch<5>(X, Cov, W, WY, scal, out, n, p, m, s);
    case 6: return (int)launch<6>(X, Cov, W, WY, scal, out, n, p, m, s);
    case 7: return (int)launch<7>(X, Cov, W, WY, scal, out, n, p, m, s);
    case 8: return (int)launch<8>(X, Cov, W, WY, scal, out, n, p, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
