// The wide LOD kernel (liteqtl_wide_kernel: any count c > 8 of covariate
// columns), for the function that liteqtl_fused.cu states.
//
// The general kernel keeps (c + 2) accumulator sets a thread, one for each
// U_k, and finishes with the forward substitution Z = L^{-1} U; its
// registers grow with c, which is why it stops at c = 8. This kernel uses
// that the substitution is linear:
//
//     Z_k = sum_s X[s,i] * V[k,s,j],   V[k,:,j] = W[:,j] * (C L_j^{-T})[:,k],
//
// with L_j the trait's Cholesky factor of C^T diag(w_j) C. V, the weighted
// covariates whitened per trait, is formed outside the kernel in the solve
// dtype and rounded to float32 (kernels/liteqtl_fused.py::prepare_inputs),
// so that no packed factor and no substitution remain in the kernel. It
// walks the covariate columns one at a time with one Z accumulator set and
// subtracts each column's terms as it finishes it:
//
//     N = B - sum_k Z_k zeta_k,   D = D1 - sum_k Z_k^2
//
// then the same keep mask (D > 1024 eps D1), floor (4 eps D1), r2 and LOD as
// the general kernel, with IEEE divisions and log10f. Four accumulator sets
// a thread (N, D, D1, Z) for any c, and the same 2 (c + 2) n p m flops: the
// first walk over the samples takes B, D1 and Z_0 together, every later walk
// one Z_k. The scalar block is zeta (c rows), inv_nrm2, and nrm2 for the
// effects variant (kEffects), whose effect and standard error are the
// general kernel's effect_from_products() on the same N and D.
//
// Tiles as the general kernel's: a block of 256 threads owns a 64 x 64
// output tile, each thread a 4 x 4 micro-tile strided by 16 both ways, n
// walked in chunks of 16 samples through shared memory (16 KB static: X, V_k,
// and W and WY on the first walk). A block reads its X tile c times, from
// L2 after the first walk; V_k and the tile's W and WY once.
//
// What bounds it on an H100: the operations, 2 (c + 2) n p m float32 flops
// on the CUDA cores, against the (p, m) LOD write and the (c, n, m) operand
// (at 79 x 7,321 x 35,554 with c = 12: 5.8e11 flops, 8.6 ms at 67 TFLOP/s,
// against 1.04 GB + 135 MB, 0.35 ms). A SIMT kernel, correct first; taking
// the products on the tensor cores is later work.

#include "liteqtl_resident.cuh"

namespace liteqtl {

namespace {

constexpr int kWideChunkN = 16;                // samples staged per step
constexpr int kWideLanes = 16;                 // threads along each tile edge
constexpr int kWideRP = kTileP / kWideLanes;   // markers per thread
constexpr int kWideRM = kTileM / kWideLanes;   // traits per thread
constexpr int kWideLoads = (kWideChunkN * kTileP) / kThreads;

using Tile = float[kWideChunkN][kTileP];
using Acc = float[kWideRP][kWideRM];

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < kWideRP; ++i)
#pragma unroll
    for (int j = 0; j < kWideRM; ++j) a[i][j] = 0.0f;
}

// One walk over the n samples: z += X^T V_k on the thread's micro-tile; the
// first walk (kFirst) also b += X^T WY and d1 += (X * X)^T W.
template <bool kFirst>
__device__ __forceinline__ void walk_samples(const float* __restrict__ X,
                                             const float* __restrict__ Vk,
                                             const float* __restrict__ W,
                                             const float* __restrict__ WY, int n, int p, int ldx,
                                             int m, int p0, int m0, Tile& xs, Tile& vs, Tile& ws,
                                             Tile& wys, Acc& z, Acc& b, Acc& d1) {
  const int tid = threadIdx.x;
  const int tx = tid % kWideLanes;  // trait lane
  const int ty = tid / kWideLanes;  // marker lane
  for (int n0 = 0; n0 < n; n0 += kWideChunkN) {
#pragma unroll
    for (int r = 0; r < kWideLoads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kTileP, col = e % kTileP;
      const int gn = n0 + row;
      const int gp = p0 + col, gm = m0 + col;
      const bool in_n = gn < n;
      xs[row][col] = (in_n && gp < p) ? X[(size_t)gn * ldx + gp] : 0.0f;
      vs[row][col] = (in_n && gm < m) ? Vk[(size_t)gn * m + gm] : 0.0f;
      if constexpr (kFirst) {
        ws[row][col] = (in_n && gm < m) ? W[(size_t)gn * m + gm] : 0.0f;
        wys[row][col] = (in_n && gm < m) ? WY[(size_t)gn * m + gm] : 0.0f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int s = 0; s < kWideChunkN; ++s) {
      float x[kWideRP], v[kWideRM];
#pragma unroll
      for (int i = 0; i < kWideRP; ++i) x[i] = xs[s][ty + kWideLanes * i];
#pragma unroll
      for (int j = 0; j < kWideRM; ++j) v[j] = vs[s][tx + kWideLanes * j];
      if constexpr (kFirst) {
        float w[kWideRM], wy[kWideRM];
#pragma unroll
        for (int j = 0; j < kWideRM; ++j) {
          w[j] = ws[s][tx + kWideLanes * j];
          wy[j] = wys[s][tx + kWideLanes * j];
        }
#pragma unroll
        for (int i = 0; i < kWideRP; ++i) {
          const float xx = x[i] * x[i];
#pragma unroll
          for (int j = 0; j < kWideRM; ++j) {
            b[i][j] = fmaf(x[i], wy[j], b[i][j]);
            d1[i][j] = fmaf(xx, w[j], d1[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kWideRP; ++i)
#pragma unroll
        for (int j = 0; j < kWideRM; ++j) z[i][j] = fmaf(x[i], v[j], z[i][j]);
    }
    __syncthreads();
  }
}

// num -= Z_k zeta_k and d -= Z_k^2 on the thread's micro-tile, in the order
// of the general kernel's residualize().
__device__ __forceinline__ void subtract_column(const Acc& z, const float* __restrict__ zeta_k,
                                                int m, int m0, Acc& num, Acc& d) {
  const int tx = threadIdx.x % kWideLanes;
#pragma unroll
  for (int j = 0; j < kWideRM; ++j) {
    const int gm = m0 + tx + kWideLanes * j;
    const float zeta = gm < m ? zeta_k[gm] : 0.0f;
#pragma unroll
    for (int i = 0; i < kWideRP; ++i) {
      num[i][j] -= z[i][j] * zeta;
      d[i][j] -= z[i][j] * z[i][j];
    }
  }
}

template <bool kEffects>
__global__ void __launch_bounds__(kThreads)
liteqtl_wide_kernel(const float* __restrict__ X,     // (n, ldx) rotated markers
                    const float* __restrict__ V,     // (c, n, m) whitened weighted covariates
                    const float* __restrict__ W,     // (n, m) per-trait weights
                    const float* __restrict__ WY,    // (n, m) weighted traits
                    const float* __restrict__ scal,  // (c + 1 [+ 1], m) zeta, inv_nrm2 [, nrm2]
                    float* __restrict__ out,         // (p, m) LOD
                    float* __restrict__ beta_out,    // (p, m) effect (kEffects)
                    float* __restrict__ se_out,      // (p, m) its standard error (kEffects)
                    int n, int p, int ldx, int m, int c) {
  __shared__ Tile xs, vs, ws, wys;

  const int tid = threadIdx.x;
  const int tx = tid % kWideLanes;
  const int ty = tid / kWideLanes;
  const int p0 = blockIdx.y * kTileP;
  const int m0 = blockIdx.x * kTileM;

  Acc num, d, d1, z;
  zero(num);
  zero(d1);
  zero(z);
  walk_samples<true>(X, V, W, WY, n, p, ldx, m, p0, m0, xs, vs, ws, wys, z, num, d1);
#pragma unroll
  for (int i = 0; i < kWideRP; ++i)
#pragma unroll
    for (int j = 0; j < kWideRM; ++j) d[i][j] = d1[i][j];
  subtract_column(z, scal, m, m0, num, d);
  for (int k = 1; k < c; ++k) {
    zero(z);
    walk_samples<false>(X, V + (size_t)k * n * m, W, WY, n, p, ldx, m, p0, m0, xs, vs, ws, wys,
                        z, num, d1);
    subtract_column(z, scal + (size_t)k * m, m, m0, num, d);
  }

  const float neg_half_n = -0.5f * (float)n;
  const float dof = (float)max(n - c - 1, 1);
  const float eps = FLT_EPSILON;
#pragma unroll
  for (int j = 0; j < kWideRM; ++j) {
    const int gm = m0 + tx + kWideLanes * j;
    // columns past m get ones: no division by zero in lanes never stored
    const float inv_nrm2 = gm < m ? scal[(size_t)c * m + gm] : 1.0f;
    const float nrm2 = (kEffects && gm < m) ? scal[(size_t)(c + 1) * m + gm] : 1.0f;
#pragma unroll
    for (int i = 0; i < kWideRP; ++i) {
      const int gp = p0 + ty + kWideLanes * i;
      const float nn = num[i][j];
      const bool keep = d[i][j] > 1024.0f * eps * d1[i][j];
      const float dd = fmaxf(d[i][j], 4.0f * eps * d1[i][j]);
      const float r2 = keep ? nn * nn * inv_nrm2 / dd : 0.0f;
      const float lod = neg_half_n * log10f(fmaxf(1.0f - r2, FLT_MIN));
      if (gp < p && gm < m) out[(size_t)gp * m + gm] = lod;
      if constexpr (kEffects) {
        const float nk = (keep && inv_nrm2 > 0.0f) ? nn : 0.0f;
        const float dt = fmaxf(dd, FLT_MIN);
        const float rss = fmaxf(nrm2 - __fmul_rn(nk, nk) / dt, 0.0f);
        if (gp < p && gm < m) {
          beta_out[(size_t)gp * m + gm] = nk / dt;
          se_out[(size_t)gp * m + gm] = sqrtf(rss / dof / dt);
        }
      }
    }
  }
}

}  // namespace

// The wide kernel on the operands o (o.Cov is V, (c, n, m); o.scal the wide
// scalar block), c >= 1 covariate columns.
cudaError_t launch_wide(const Operands& o, int c, cudaStream_t stream) {
  if (c < 1 || (o.p + kTileP - 1) / kTileP > 65535) return cudaErrorInvalidValue;
  const dim3 grid((o.m + kTileM - 1) / kTileM, (o.p + kTileP - 1) / kTileP);
  if (o.beta != nullptr) {
    liteqtl_wide_kernel<true><<<grid, kThreads, 0, stream>>>(
        o.X, o.Cov, o.W, o.WY, o.scal, o.out, o.beta, o.se, o.n, o.p, o.ldx, o.m, c);
  } else {
    liteqtl_wide_kernel<false><<<grid, kThreads, 0, stream>>>(
        o.X, o.Cov, o.W, o.WY, o.scal, o.out, nullptr, nullptr, o.n, o.p, o.ldx, o.m, c);
  }
  return cudaGetLastError();
}

}  // namespace liteqtl
