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
// The per-step weighting and residualization are done outside, in thin torch
// products (kernels/altgrid_fused.py::prepare_inputs): Xn[k] and Yn[k] are
// the sqrt-weighted markers and traits of grid step k with the
// weighted-covariate orthobasis projected out, the keep masks applied and
// each column normalized, so r_k is a plain dot product and the kernel's
// body is a depth-n contraction plus the epilogue. Only L (and the index,
// when asked for) reaches device memory.
//
// What bounds it on an H100: operations. 2 n p m g flops (4.1e11 at 79 x
// 7,321 x 35,554 and g = 10) against 2.2 GB moved once. Float32-grade
// products cost 6.1 ms on the CUDA cores and 2.5 ms as three TF32 passes on
// the tensor cores (mma_tf32x3.cuh), so the product runs there. Behind the
// arithmetic stand the operand reads: g n (p + m) 4 bytes (135 MB) do not
// fit the 50 MB L2, and every block reads its two tiles of every grid step.
//
// Design. A block of 8 warps owns a 128 x 64 (markers x traits) output tile,
// each warp a 32 x 32 part of it: 2 x 4 m16n8k8 accumulator tiles, and beside
// them the running minimum and its int32 index, in registers across all g
// steps. Both operand tiles of a grid step (and its row of cmat) arrive by
// cp.async into a ring of two stages while the previous step multiplies;
// one barrier a step. Their rows are handed over 16-byte aligned (the
// wrapper pads an odd p or m), so the copies are 16 bytes wide. Both are raw
// float32 in shared memory and are split into their TF32 halves in registers
// at the fragment load, one step ahead of the tensor cores. Each depth
// step's three passes go into a step sum that starts from zero and is added
// into the accumulator with __fadd_rn (mma_tf32x3.cuh's mma_fragments()):
// the tensor cores cut a sum toward zero, and carried across the depth the
// cuts fell at the result's full magnitude. n above 80 is
// walked in chunks of 80 samples, one stage each, so n has no limit. Per
// block and grid step 192 columns are read for 8,192 outputs, against 128
// for 4,096 with 64 x 64 tiles: three quarters of the reads. At the end the
// block's tile goes through shared memory so that L and the index are
// written in whole rows. Ragged p, m and n edges: out-of-range samples,
// markers and traits stage as zeros, out-of-range outputs are not stored.
//
// The products' policy is the kernel's first template parameter: three TF32
// passes (tf32x3::Policy, depth steps of 8) for every preset but THROUGHPUT,
// three bf16 passes (bf16x3::Policy, mma.sync m16n8k16, depth steps of 16)
// for THROUGHPUT's "high" products, as the TPU kernel's HIGH branch splits
// them. The two differ in the fragment loads and the depth step alone; a
// stage keeps its 80 samples (a multiple of both steps).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, and never --use_fast_math.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstddef>

#include "mma_bf16x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kTileP = 128;   // markers per block
constexpr int kTileM = 64;    // traits per block
constexpr int kWarpsP = 4;    // warps along the markers, 32 each
constexpr int kThreads = 256;
constexpr int kMT = 2, kNT = 4;  // a warp's 32 x 32 part, in m16n8k8 tiles
constexpr int kStages = 2;
constexpr int kMaxDepth = 80;  // samples per stage, a multiple of both depth steps
constexpr int kLdX = padded_stride(kTileP);
constexpr int kLdY = padded_stride(kTileM);
constexpr int kLdOut = kTileM + 1;  // the output tile's row stride in shared memory

// Floats of one stage: `depth` rows of each operand and one row of cmat.
__host__ __device__ constexpr int stage_floats(int depth) {
  return depth * (kLdX + kLdY) + kLdY;
}

template <class P, bool kPanel>
__global__ void __launch_bounds__(kThreads, 1)
altgrid_kernel(const float* __restrict__ Xn,    // (g, n, ldx) per-step markers
               const float* __restrict__ Yn,    // (g, n, ldy) per-step traits
               const float* __restrict__ cmat,  // (g, m) per-step trait factors
               float* __restrict__ out,         // (p, m) LOD
               int* __restrict__ kidx,          // (p, m) argmin grid index
               int g, int n, int p, int ldx, int m, int ldy,
               int depth,    // samples per stage, a multiple of P::kStep
               int nchunks,  // steps per grid step
               int cvec) {
  extern __shared__ float4 shared_raw[];
  float* shared = reinterpret_cast<float*>(shared_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, q = lane % 4;
  const int wp = (warp % kWarpsP) * 32;  // the warp's first marker in the tile
  const int wm = (warp / kWarpsP) * 32;  // the warp's first trait in the tile
  const int p0 = blockIdx.y * kTileP;
  const int m0 = blockIdx.x * kTileM;
  const int stage_len = stage_floats(depth);

  // one step's tiles: both operands and, on a grid step's last chunk, cmat's row
  auto start_copies = [&](int step) {
    float* xs = shared + (step % kStages) * stage_len;
    float* ys = xs + depth * kLdX;
    const int k = step / nchunks, chunk = step - k * nchunks;
    const int r0 = k * n + chunk * depth;
    stage_tile_vec<kTileP, 4>(xs, kLdX, Xn, (k + 1) * n, ldx, r0, p0, depth, tid, kThreads);
    stage_tile_vec<kTileM, 4>(ys, kLdY, Yn, (k + 1) * n, ldy, r0, m0, depth, tid, kThreads);
    if (chunk == nchunks - 1)
      stage_tile<kTileM>(ys + depth * kLdY, kLdY, cmat, k + 1, m, k, m0, 1, cvec, tid, kThreads);
    cp_async_commit();
  };

  const int nsteps = g * nchunks;
  start_copies(0);

  // set at k = 0, the first grid step of every block
  float umin[kMT][kNT][4] = {};
  int kmin[kMT][kNT][4] = {};
  float acc[kMT][kNT][4];

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // this step's tiles have landed; the other stage is free
    if (step + 1 < nsteps) start_copies(step + 1);

    const int k = step / nchunks, chunk = step - k * nchunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
    }

    const float* xs = shared + (step % kStages) * stage_len;
    const float* ys = xs + depth * kLdX;
    warp_mma<P>(acc, xs + wp, kLdX, ys + wm, kLdY, depth, gq, q);

    if (chunk == nchunks - 1) {
      const float* cs = ys + depth * kLdY + wm;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // the factors of the thread's traits b_column(j, 2 q + e), j = 0..3;
        // a trait past m staged as 0 and is never stored
        float c[kNT];
        load_vec<kNT>(cs + b_column<kNT>(0, 2 * q + e), c);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float r = acc[i][j][2 * h + e];
              // __fmul_rn: r^2 rounded on its own, as torch forms it (no FMA)
              const float u = fmaxf(fmaxf(1.0f - __fmul_rn(r, r), FLT_MIN) * c[j], FLT_MIN);
              if (k == 0 || u < umin[i][j][2 * h + e]) {  // strict: the first minimum wins
                umin[i][j][2 * h + e] = u;
                if (kPanel) kmin[i][j][2 * h + e] = k;
              }
            }
      }
    }
  }

  // the block's tile through shared memory, so that whole rows are written
  const float neg_half_n = -0.5f * (float)n;
  float* tile = shared;
  for (int pass = 0; pass < (kPanel ? 2 : 1); ++pass) {
    __syncthreads();  // the stages, or the first pass's tile, are read no more
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wp + a_column(i, gq + 8 * (r / 2));
          const int col = wm + b_column<kNT>(j, 2 * q + r % 2);
          tile[row * kLdOut + col] = pass == 0 ? neg_half_n * log10f(umin[i][j][r])
                                               : __int_as_float(kmin[i][j][r]);
        }
    __syncthreads();
    for (int e = tid; e < kTileP * kTileM; e += kThreads) {
      const int row = e / kTileM, col = e % kTileM;
      if (p0 + row >= p || m0 + col >= m) continue;
      const size_t o = (size_t)(p0 + row) * m + m0 + col;
      if (pass == 0)
        out[o] = tile[row * kLdOut + col];
      else
        kidx[o] = __float_as_int(tile[row * kLdOut + col]);
    }
  }
}

template <class P, bool kPanel>
cudaError_t launch(const float* Xn, int ldx, const float* Yn, int ldy, const float* cmat,
                   float* out, int* kidx, int g, int n, int p, int m, cudaStream_t stream) {
  const int padded = (n + P::kStep - 1) / P::kStep * P::kStep;
  const int depth = padded < kMaxDepth ? padded : kMaxDepth;
  const int nchunks = (n + depth - 1) / depth;
  size_t floats = (size_t)kStages * stage_floats(depth);
  if (floats < (size_t)kTileP * kLdOut) floats = (size_t)kTileP * kLdOut;
  auto kernel = altgrid_kernel<P, kPanel>;
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(4 * floats));
  if (rc != cudaSuccess) return rc;
  const dim3 grid((m + kTileM - 1) / kTileM, (p + kTileP - 1) / kTileP);
  kernel<<<grid, kThreads, 4 * floats, stream>>>(Xn, Yn, cmat, out, kidx, g, n, p, ldx, m, ldy,
                                                 depth, nchunks, copy_width(cmat, m));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 on success). Pointers are device pointers to contiguous arrays: cmat and
// out float32, kidx int32 or null (null: no index is carried or written).
// Xn and Yn are float32 with their g n rows ldx >= p and ldy >= m floats
// apart, both strides multiples of 4 and both pointers 16-byte aligned, so
// that every row takes 16-byte copies, with zeros in the columns past p and m.
// bf16 != 0 takes the products as three bf16 passes, else as three TF32.
int bulklmm_altgrid(const float* Xn, int ldx, const float* Yn, int ldy, const float* cmat,
                    float* out, int* kidx, int g, int n, int p, int m, int bf16,
                    void* stream) {
  if (g <= 0 || n <= 0 || p <= 0 || m <= 0 || (p + kTileP - 1) / kTileP > 65535 ||
      (long long)g * n > INT_MAX || ldx < p || ldy < m || ldx % 4 != 0 || ldy % 4 != 0 ||
      reinterpret_cast<uintptr_t>(Xn) % 16 != 0 || reinterpret_cast<uintptr_t>(Yn) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto policy) {
    using P = decltype(policy);
    return kidx != nullptr ? launch<P, true>(Xn, ldx, Yn, ldy, cmat, out, kidx, g, n, p, m, s)
                           : launch<P, false>(Xn, ldx, Yn, ldy, cmat, out, kidx, g, n, p, m, s);
  };
  return (int)(bf16 ? run(bf16x3::Policy{}) : run(tf32x3::Policy{}));
}

}  // extern "C"
