// Fused per-trait-weight correlation -> LOD kernels for Hopper (sm_90a).
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
// reach device memory. The effects variant of both kernels (the template
// parameter kEffects; bulkscan(output_effects=True)) writes two more (p, m)
// matrices from the same products and residualization, the marker's effect
// and its standard error as ops/liteqtl.py::_effects_from_nd defines them
// (effect_from_products() in liteqtl_resident.cuh); its scalar block has one
// more row, the trait's nrm2. Its LODs are the LOD-only kernel's.
//
// What bounds it on an H100: 2 (c+2) n p m flops (1.23e11 at 79 x 7,321 x
// 35,554, c = 1) against one 4 p m byte write (1.04 GB) and 25 MB of
// operands: operations. Float32-grade products cost 1.84 ms on the CUDA
// cores (67 TFLOP/s) and 0.75 ms as three TF32 passes on the tensor cores
// (mma_tf32x3.cuh). Behind the products stand what every block re-reads
// from L2 (the (c+2) products share one tile of X, so a block has few
// operations for each byte of X that it reads) and an epilogue of two
// divisions and a logarithm for every output, which in their exact forms are
// more dispatch time than the products are tensor-core time.
//
// Three kernels; the launcher picks one from n and c (bulklmm_liteqtl_path),
// and kernels/liteqtl_fused.py::kernel_path states the same rule.
//
// The resident kernel (liteqtl_resident.cuh: n <= 88, c <= 3) takes the
// products on the tensor cores as three TF32 passes, with the traits'
// operands kept in shared memory for the whole launch and the marker tiles
// copied asynchronously; one source file a covariate count, so that they
// compile side by side.
//
// The general kernel (liteqtl_general_kernel: any n, c <= 8). A plain tiled
// SIMT kernel: a block of 256 threads owns a 64 x 64 output tile, each
// thread a 4 x 4 micro-tile strided by 16 both ways, n walked in chunks of
// 16 samples through shared memory, (c+2) x 16 float32 fmaf accumulators a
// thread, X * C_k and X * X formed from the staged tiles. It runs where the
// accumulator sets or the operands do not fit the resident kernel.
//
// The wide kernel (liteqtl_wide.cu: any c > 8) takes the covariates already
// whitened per trait and walks them one column at a time, with four
// accumulator sets a thread for any c; its operands are V (c, n, m) in the
// place of C and a scalar block without the packed factor.
//
// Ragged edges, every kernel: trait columns past m get scalars of 1 (no
// division by zero in lanes never stored), out-of-range outputs are not
// stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, and never --use_fast_math (it would replace
//        log10f and the IEEE division and flush subnormals).

#include "liteqtl_resident.cuh"

namespace liteqtl {

// --- the general kernel: float32 fmaf on staged chunks of n ----------------------

constexpr int kChunkN = 16;   // samples staged per step
constexpr int kLanes = 16;    // threads along each tile edge
constexpr int kRP = kTileP / kLanes;  // markers per thread
constexpr int kRM = kTileM / kLanes;  // traits per thread

template <int C, bool kEffects>
__global__ void __launch_bounds__(kThreads)
liteqtl_general_kernel(const float* __restrict__ X,     // (n, ldx) rotated markers
                       const float* __restrict__ Cov,   // (n, C) rotated covariates
                       const float* __restrict__ W,     // (n, m) per-trait weights
                       const float* __restrict__ WY,    // (n, m) weighted traits
                       const float* __restrict__ scal,  // (S, m) per-trait scalars
                       float* __restrict__ out,         // (p, m) LOD
                       float* __restrict__ beta_out,    // (p, m) effect (kEffects)
                       float* __restrict__ se_out,      // (p, m) its standard error (kEffects)
                       int n, int p, int ldx, int m) {
  constexpr int kS = scalar_rows(C, kEffects);
  constexpr int kAcc = C + 2;  // B, D1, U_0 .. U_{C-1}

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
      xs[row][col] = (in_n && gp < p) ? X[(size_t)gn * ldx + gp] : 0.0f;
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

  const float neg_half_n = -0.5f * (float)n;
  const float dof = (float)max(n - C - 1, 1);
#pragma unroll
  for (int j = 0; j < kRM; ++j) {
    const int lm = tx + kLanes * j;
    const int gm = m0 + lm;
#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const int gp = p0 + ty + kLanes * i;
      float u[C];
#pragma unroll
      for (int k = 0; k < C; ++k) u[k] = acc[2 + k][i][j];
      auto scal_of = [&](int row) { return ss[row][lm]; };
      const float lod =
          lod_from_products<C, false>(acc[0][i][j], acc[1][i][j], u, scal_of, neg_half_n);
      if (gp < p && gm < m) out[(size_t)gp * m + gm] = lod;
      if constexpr (kEffects) {
        const Effect f =
            effect_from_products<C, false>(acc[0][i][j], acc[1][i][j], u, scal_of, dof, 0.0f);
        if (gp < p && gm < m) {
          beta_out[(size_t)gp * m + gm] = f.beta;
          se_out[(size_t)gp * m + gm] = f.se;
        }
      }
    }
  }
}

// the most covariate columns the general kernel is instantiated for; the
// wide kernel takes more
constexpr int kGeneralCovariates = 8;

// liteqtl_wide.cu
cudaError_t launch_wide(const Operands& o, int c, cudaStream_t stream);

template <int C>
cudaError_t launch_general(const Operands& o, cudaStream_t stream) {
  if ((o.p + kTileP - 1) / kTileP > 65535) return cudaErrorInvalidValue;
  const dim3 grid((o.m + kTileM - 1) / kTileM, (o.p + kTileP - 1) / kTileP);
  if (o.beta != nullptr) {
    liteqtl_general_kernel<C, true><<<grid, kThreads, 0, stream>>>(
        o.X, o.Cov, o.W, o.WY, o.scal, o.out, o.beta, o.se, o.n, o.p, o.ldx, o.m);
  } else {
    liteqtl_general_kernel<C, false><<<grid, kThreads, 0, stream>>>(
        o.X, o.Cov, o.W, o.WY, o.scal, o.out, nullptr, nullptr, o.n, o.p, o.ldx, o.m);
  }
  return cudaGetLastError();
}

}  // namespace liteqtl

using namespace liteqtl;

extern "C" {

// The kernel that a launch with n samples and c covariate columns takes: 1
// the resident kernel, 0 the general one, 2 the wide one; effects != 0 for
// the effects variant.
int bulklmm_liteqtl_path(int n, int c, int effects) {
  if (c > kGeneralCovariates) return 2;
  return is_resident(n, c, effects != 0) ? 1 : 0;
}

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 on success). Pointers are device pointers to contiguous float32 arrays,
// but X: its n rows are ldx >= p floats apart. c >= 1; above 8 the wide
// kernel's operands (Cov is V, (c, n, m), and scal its scalar block). beta
// and se both null: the LOD alone; both given: the effects variant, whose
// scalar block has the nrm2 row. general != 0 takes the general kernel
// whatever the shape (c <= 8). The resident kernel needs ldx a multiple of 4
// and X 16-byte aligned, so that every row takes 16-byte copies; the columns
// between p and ldx may hold anything finite or not (their outputs are not
// stored).
int bulklmm_liteqtl_lod(const float* X, int ldx, const float* Cov, const float* W,
                        const float* WY, const float* scal, float* out, float* beta, float* se,
                        int n, int p, int m, int c, int general, void* stream) {
  if (n <= 0 || p <= 0 || m <= 0 || ldx < p) return (int)cudaErrorInvalidValue;
  if ((beta == nullptr) != (se == nullptr)) return (int)cudaErrorInvalidValue;
  const bool effects = beta != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operands o{X, Cov, W, WY, scal, out, beta, se, n, p, ldx, m};
  if (c > kGeneralCovariates) return general ? (int)cudaErrorInvalidValue : (int)launch_wide(o, c, s);
  if (!general && is_resident(n, c, effects)) {
    switch (c + (effects ? 3 : 0)) {
      case 1: return (int)launch_resident_c1(o, s);
      case 2: return (int)launch_resident_c2(o, s);
      case 3: return (int)launch_resident_c3(o, s);
      case 4: return (int)launch_resident_effects_c1(o, s);
      case 5: return (int)launch_resident_effects_c2(o, s);
      case 6: return (int)launch_resident_effects_c3(o, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (c) {
    case 1: return (int)launch_general<1>(o, s);
    case 2: return (int)launch_general<2>(o, s);
    case 3: return (int)launch_general<3>(o, s);
    case 4: return (int)launch_general<4>(o, s);
    case 5: return (int)launch_general<5>(o, s);
    case 6: return (int)launch_general<6>(o, s);
    case 7: return (int)launch_general<7>(o, s);
    case 8: return (int)launch_general<8>(o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
