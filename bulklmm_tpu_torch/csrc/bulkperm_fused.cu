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
// What bounds it on an H100: operations. 2 n p mb K flops (1.19e12 for 79 x
// 7,321 markers, 1,024 traits and 1,001 columns) against 0.36 GB of
// operands read once. Float32-grade products cost 17.7 ms a launch on the
// CUDA cores (67 TFLOP/s) and 7.2 ms as three TF32 passes on the tensor
// cores (mma_tf32x3.cuh), so the product runs there. Behind the arithmetic
// stand what each block re-reads from L2 and what a warp must run beside
// its products, so the design keeps the trait's operand in shared memory,
// gives every read of X 256 permutations to work on, and leaves the
// products to wgmma, which runs while the warps load and split.
//
// Design. A block of 8 warps (two warpgroups) owns one trait and a tile of
// 256 permutations and walks all markers, 64 at a time.
//
// - The markers. Tiles of X arrive by cp.async into a ring of two stages, a
//   row of inv_xn with them: the next tile loads while this one multiplies,
//   and one barrier a step orders both. The rows of X are handed over
//   16-byte aligned (the wrapper pads an odd p), so a tile is five 16-byte
//   copies a thread, where 4-byte copies of an odd-p tile are twenty and
//   showed as a fifth of a launch.
// - The trait's operand, resident (bulkperm_wide_kernel, n <= 88). The
//   block's S2 tile is read once, split into its two TF32 halves and kept in
//   shared memory for all marker tiles, K-major, as wgmma's B operand (80 KB
//   each half at n = 79). Each warpgroup takes 128 permutations and the same
//   64 markers of a step: X is the A operand, loaded from the staged tile
//   and split in registers while the asynchronous products of earlier depth
//   steps run, 64 accumulator registers a thread. The small terms of all
//   depth steps are added first and the leading terms after them: the
//   tensor cores' float32 accumulation cuts where it should round, and this
//   order takes a third as many sums at the result's full magnitude. The
//   markers arrive off the covariates' span (models/bulkperm.py), so no
//   sample's product dominates a sum. Taking the leading terms in runs
//   added with round to nearest, as the LOD kernel does, was measured and
//   left out: two m64n64 halves with a run set cost 1.40x (runs of 5
//   steps) to 1.67x (runs of 1) of this launch and spilled at 10 and 11
//   steps, for 9.6e-6 and 7.8e-6 from EXACT64 at BXD scale against 1.12e-5
//   here, where the plain engine is 1.30e-5 (PERF.md).
// - Above that size (bulkperm_chunked_kernel) n is walked in chunks of 64
//   samples: the chunk of S2 is staged raw beside the chunk of X, both are
//   split in registers, and the products are mma.sync m16n8k8, each warp 64
//   markers x 32 permutations, each depth step's sum added into the
//   accumulator rounded to nearest (mma_tf32x3.cuh's mma_fragments(): the
//   tensor cores cut a sum toward zero, accumulate_probe.cu). On this card mma.sync holds its warp's dispatch
//   slot, so every load, split and epilogue instruction of a warp comes on
//   top of its products' time; with the operand resident that layout took
//   over twice what wgmma takes (PERF.md).
// - The epilogue works on the accumulator layout: num^2 * inv_xn, each
//   product rounded on its own as torch rounds it, folded into running
//   maxima in registers. At the end the eight row groups of a warp are
//   folded by shuffles (and a warpgroup's four warps through shared memory).
//   No atomics, no zero-initialized output: the result is deterministic.
// - Edges. Samples past n, markers past p and permutations past K stage as
//   zeros, a marker past p gets inv_xn = 0, so padding contributes r^2 = 0,
//   the identity of the max (every real r^2 is >= 0); permutations past K
//   are not stored. The operands must be finite: fmaxf drops a NaN where a
//   max that carries it is wanted.
//
// L2 reads a launch at the main path's shape: every block reads X once
// (2.3 MB), 4,096 blocks: 9.5 GB, and S2 once.
//
// The products' policy is both kernels' first template parameter: three
// TF32 passes (tf32x3::Policy, depth steps of 8) for every preset but
// THROUGHPUT, three bf16 passes (bf16x3::Policy, depth steps of 16) for
// THROUGHPUT's "high" products, as the TPU kernel's HIGH branch splits them.
// Under bf16x3 the resident operand is two bf16 tiles (40 KB each at n = 79,
// stored in the slot order of mma_bf16x3.cuh) and the products are
// wgmma m64n128k16; the chunked kernel takes mma.sync m16n8k16 on the same
// staged chunks. Which path a launch takes (n <= 88 resident) is the same
// for both policies.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, and never --use_fast_math.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "mma_bf16x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kTileP = 64;    // markers per step
constexpr int kTileK = 256;   // permutations per block
constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kLdX = padded_stride(kTileP);
constexpr int kSharedLimit = 232448;  // bytes of shared memory a block can use

// n rounded up to a depth step of the policy
template <class P = tf32x3::Policy>
int padded_depth(int n) {
  return (n + P::kStep - 1) / P::kStep * P::kStep;
}

// --- the resident operand: asynchronous warpgroup products --------------------
//
// The block's two warpgroups take 128 permutations each and the same 64
// markers of a step. S2 lies in shared memory K-major, both TF32 halves
// (kmajor_offset()), and is wgmma's B operand by descriptor; X is the A
// operand, from registers. One accumulator: a second one, to fold one
// tile's maxima while the next multiplies, does not fit the registers
// (ptxas then serializes the products and the launch is slower).

constexpr int kGroupK = 128;       // permutations per warpgroup
constexpr int kResidentSteps = 11; // most depth steps of 8: the kernel is built for each count

// Depth steps of the policy that the kernel is built for, up to 88 samples.
template <class P>
constexpr int resident_steps() {
  return (8 * kResidentSteps + P::kStep - 1) / P::kStep;
}

// Shared memory of a block that keeps its trait's operand resident: both
// halves of the (padded n, 256) tile, 4 bytes a value under tf32x3 and 2
// under bf16x3, and two stages of 64 markers and a row of inv_xn.
template <class P = tf32x3::Policy>
size_t resident_shared_bytes(int n) {
  const size_t depth = padded_depth<P>(n), tile = depth * kTileK / (P::kStep / 8);
  return 4 * (2 * tile + (size_t)kStages * (depth + 1) * kLdX);
}

bool is_resident(int n) {
  return padded_depth(n) <= 8 * kResidentSteps && resident_shared_bytes(n) <= kSharedLimit;
}

// kSteps: depth steps of the policy, n padded; a template parameter so that the depth
// loops carry no branches (a run-time count cost 7 % of the launch).
template <class P, int kSteps>
__global__ void __launch_bounds__(kThreads, 1)
bulkperm_wide_kernel(const float* __restrict__ X,       // (n, ldx) rotated markers, zeros past p
                     const float* __restrict__ S2,      // (mb, n, K) trait operands
                     const float* __restrict__ inv_xn,  // (mb, p) 1 / marker norm^2, 0 = masked
                     float* __restrict__ out,           // (mb, K) max r^2
                     int n, int p, int ldx, int K, int ktiles, int wvec) {
  constexpr bool kBf16 = P::kStep == 16;
  constexpr int depth = P::kStep * kSteps;
  constexpr int kTileWords = depth * kTileK / (kBf16 ? 2 : 1);  // one half of S2's tile
  extern __shared__ __align__(128) float4 wide_shared_raw[];
  float* shared = reinterpret_cast<float*>(wide_shared_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int group = warp / 4;          // the warpgroup: permutations 128 group ..
  const int wrow = 16 * (warp % 4);    // the warp's first marker of the step
  const int t = blockIdx.x / ktiles;
  const int k0 = (blockIdx.x % ktiles) * kTileK;

  float* s_big = shared;  // K-major, kTileK columns, `depth` deep
  float* s_small = s_big + kTileWords;
  float* stages = s_small + kTileWords;
  const int stage_len = (depth + 1) * kLdX;

  auto start_copies = [&](int tile) {
    float* xs = stages + (tile % kStages) * stage_len;
    const int p0 = tile * kTileP;
    stage_tile_vec<kTileP, 4>(xs, kLdX, X, n, ldx, 0, p0, depth, tid, kThreads);
    stage_tile<kTileP>(xs + depth * kLdX, kLdX, inv_xn, t + 1, p, t, p0, 1, wvec, tid, kThreads);
    cp_async_commit();
  };

  const int ntiles = (p + kTileP - 1) / kTileP;
  start_copies(0);

  {
    // the block's S2 tile, read once, split, and laid out K-major
    const float* St = S2 + (size_t)t * n * K;
    if constexpr (kBf16) {
      // word depth w of column c holds samples sample_of_word(w) and that + 4
      for (int e = tid; e < kTileWords; e += kThreads) {
        const int w = e / kTileK, c = e % kTileK, s = bf16x3::sample_of_word(w);
        const bool inside = k0 + c < K;
        const float v0 = (s < n && inside) ? St[(size_t)s * K + k0 + c] : 0.0f;
        const float v1 = (s + 4 < n && inside) ? St[(size_t)(s + 4) * K + k0 + c] : 0.0f;
        uint32_t hi, lo;
        bf16x3::split_pair(v0, v1, hi, lo);
        s_big[kmajor_offset(w, c, kTileK)] = __uint_as_float(hi);
        s_small[kmajor_offset(w, c, kTileK)] = __uint_as_float(lo);
      }
    } else {
      for (int e = tid; e < depth * kTileK; e += kThreads) {
        const int s = e / kTileK, c = e % kTileK;
        const float v = (s < n && k0 + c < K) ? St[(size_t)s * K + k0 + c] : 0.0f;
        uint32_t big, small;
        split(v, big, small);
        s_big[kmajor_offset(s, c, kTileK)] = __uint_as_float(big);
        s_small[kmajor_offset(s, c, kTileK)] = __uint_as_float(small);
      }
    }
    fence_proxy_async();
  }

  float best[32];  // of columns 8 j + 2 q + e, at best[2 j + e]
#pragma unroll
  for (int i = 0; i < 32; ++i) best[i] = 0.0f;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other stage is free
    if (tile + 1 < ntiles) start_copies(tile + 1);

    const float* xs = stages + (tile % kStages) * stage_len;
    // The warp's A fragments: fragment row r is marker wrow + 2 (r % 8) + r / 8,
    // so rows g and g + 8 load as one 64-bit word. Every depth step has its
    // own registers, so nothing waits inside a tile: while the tensor cores
    // work on one step's products the next steps are loaded and split.
    // Two passes over the depth: the small terms of every step first, then
    // the leading terms, so that only depth / 8 sums, not 3 depth / 8, are
    // taken at the result's full magnitude (the tensor cores' float32
    // accumulation cuts, it does not round).
    // Under bf16x3 a step's four samples q, q + 4, q + 8, q + 12 pack into
    // the m16n8k16 registers (mma_bf16x3.cuh's slot order).
    uint32_t a_big[kSteps][4], a_small[kSteps][4];
    const float* acol = xs + wrow + 2 * g;
    pin_registers(acc);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if constexpr (kBf16) {
        float v[8];  // v[2 h + r]: sample 16 ks + q + 4 h, fragment row g + 8 r
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float pair[2];
          load_vec<2>(acol + (16 * ks + q + 4 * h) * kLdX, pair);
          v[2 * h] = pair[0], v[2 * h + 1] = pair[1];
        }
        bf16x3::split_fragment(v, a_big[ks], a_small[ks]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
          load_vec<2>(acol + (8 * ks + q + 4 * h) * kLdX, v);
          split(v[0], a_big[ks][2 * h], a_small[ks][2 * h]);
          split(v[1], a_big[ks][2 * h + 1], a_small[ks][2 * h + 1]);
        }
      }
      // a step of either policy is 32 bytes a column: 8 words of depth
      const int at = kmajor_offset(8 * ks, kGroupK * group, kTileK);
      wgmma_fence();
      // the tile's first product overwrites acc
      P::wgmma_m64n128(acc, a_small[ks], kmajor_descriptor(s_big + at, kTileK), ks > 0);
      P::wgmma_m64n128(acc, a_big[ks], kmajor_descriptor(s_small + at, kTileK), 1);
      wgmma_commit();
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int at = kmajor_offset(8 * ks, kGroupK * group, kTileK);
      P::wgmma_m64n128(acc, a_big[ks], kmajor_descriptor(s_big + at, kTileK), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin_registers(acc);

    float w[2];  // inv_xn of the thread's markers, fragment rows g and g + 8
    load_vec<2>(xs + depth * kLdX + wrow + 2 * g, w);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float num = acc[4 * j + 2 * h + e];
          // each product rounded on its own, as torch forms (num * num) * inv_xn
          best[2 * j + e] = fmaxf(best[2 * j + e], __fmul_rn(__fmul_rn(num, num), w[h]));
        }
  }

  // max over a warp's eight row groups by shuffles, over a warpgroup's four
  // warps through shared memory (the stages are read no more)
  __syncthreads();
  float* red = stages;  // [8 warps][kGroupK]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float m = best[i];
#pragma unroll
    for (int d = 4; d < 32; d *= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (g == 0) red[warp * kGroupK + 8 * (i / 2) + 2 * q + i % 2] = m;
  }
  __syncthreads();
  {
    const int grp = tid / kGroupK, c = tid % kGroupK;
    const float* r = red + 4 * grp * kGroupK + c;
    const float m = fmaxf(fmaxf(r[0], r[kGroupK]), fmaxf(r[2 * kGroupK], r[3 * kGroupK]));
    const int k = k0 + tid;
    if (k < K) out[(size_t)t * K + k] = m;
  }
}


// --- the staged operand: mma.sync over chunks of n ------------------------------

constexpr int kChunkN = 64;  // samples per step
constexpr int kMT = kTileP / 16, kNT = 4;  // a warp's 64 markers x 32 permutations
constexpr int kLdS = padded_stride(kTileK);
// one stage: kChunkN rows of X, one row of inv_xn, kChunkN rows of S2
constexpr int kChunkStage = (kChunkN + 1) * kLdX + kChunkN * kLdS;

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
bulkperm_chunked_kernel(const float* __restrict__ X,       // (n, ldx) rotated markers
                        const float* __restrict__ S2,      // (mb, n, K) trait operands
                        const float* __restrict__ inv_xn,  // (mb, p) 1 / marker norm^2
                        float* __restrict__ out,           // (mb, K) max r^2
                        int n, int p, int ldx, int K, int ktiles,
                        int nchunks,  // steps per marker tile
                        int svec, int wvec) {
  extern __shared__ float4 chunked_shared_raw[];
  float* stages = reinterpret_cast<float*>(chunked_shared_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int t = blockIdx.x / ktiles;
  const int k0 = (blockIdx.x % ktiles) * kTileK;
  const int wk = warp * 8 * kNT;  // the warp's first permutation in the tile

  // one step's tiles: X, S2 and, on a marker tile's last chunk, the row of inv_xn
  auto start_copies = [&](int step) {
    float* xs = stages + (step % kStages) * kChunkStage;
    const int tile = step / nchunks, chunk = step - tile * nchunks;
    const int p0 = tile * kTileP, n0 = chunk * kChunkN;
    stage_tile_vec<kTileP, 4>(xs, kLdX, X, n, ldx, n0, p0, kChunkN, tid, kThreads);
    if (chunk == nchunks - 1)
      stage_tile<kTileP>(xs + kChunkN * kLdX, kLdX, inv_xn, t + 1, p, t, p0, 1, wvec, tid,
                         kThreads);
    stage_tile<kTileK>(xs + (kChunkN + 1) * kLdX, kLdS, S2, (t + 1) * n, K, t * n + n0, k0,
                       kChunkN, svec, tid, kThreads);
    cp_async_commit();
  };

  const int nsteps = ((p + kTileP - 1) / kTileP) * nchunks;
  start_copies(0);

  float best[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) best[j][0] = best[j][1] = 0.0f;
  float acc[kMT][kNT][4];

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // this step's tiles have landed; the other stage is free
    if (step + 1 < nsteps) start_copies(step + 1);

    const int chunk = step % nchunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
    }

    const float* xs = stages + (step % kStages) * kChunkStage;
    warp_mma<P>(acc, xs, kLdX, xs + (kChunkN + 1) * kLdX + wk, kLdS, kChunkN, g, q);

    if (chunk == nchunks - 1) {
      const float* ws = xs + kChunkN * kLdX;
#pragma unroll
      for (int i2 = 0; i2 < kMT / 2; ++i2) {
        // inv_xn of the thread's four markers of tiles 2 i2 and 2 i2 + 1
        float w[4];
        load_vec<4>(ws + a_column(2 * i2, g), w);
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float num = acc[2 * i2 + b][j][2 * h + e];
                // each product rounded on its own, as torch forms (num * num) * inv_xn
                const float r2 = __fmul_rn(__fmul_rn(num, num), w[2 * b + h]);
                best[j][e] = fmaxf(best[j][e], r2);
              }
      }
    }
  }

  // max over the warp's eight row groups, then lanes 0..3 write 8 maxima each
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = best[j][e];
#pragma unroll
      for (int d = 4; d < 32; d *= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
      const int k = k0 + wk + b_column<kNT>(j, 2 * q + e);
      if (g == 0 && k < K) out[(size_t)t * K + k] = m;
    }
}

// Launches the resident kernel built for n's count of depth steps.
template <class P, int kSteps>
cudaError_t launch_wide(dim3 grid, cudaStream_t stream, const float* X, const float* S2,
                        const float* inv_xn, float* out, int n, int p, int ldx, int K, int ktiles,
                        int wvec) {
  if constexpr (kSteps == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (padded_depth<P>(n) != P::kStep * kSteps)
      return launch_wide<P, kSteps - 1>(grid, stream, X, S2, inv_xn, out, n, p, ldx, K, ktiles,
                                        wvec);
    const size_t bytes = resident_shared_bytes<P>(n);
    auto kernel = bulkperm_wide_kernel<P, kSteps>;
    cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return rc;
    kernel<<<grid, kThreads, bytes, stream>>>(X, S2, inv_xn, out, n, p, ldx, K, ktiles, wvec);
    return cudaGetLastError();
  }
}

template <class P>
cudaError_t launch(const float* X, int ldx, const float* S2, const float* inv_xn, float* out,
                   int n, int p, int mb, int K, cudaStream_t s) {
  const int ktiles = (K + kTileK - 1) / kTileK;
  const dim3 grid((unsigned)(mb * ktiles));
  const int wvec = copy_width(inv_xn, p);
  if (is_resident(n))
    return launch_wide<P, resident_steps<P>()>(grid, s, X, S2, inv_xn, out, n, p, ldx, K, ktiles,
                                               wvec);
  const size_t bytes = 4 * (size_t)kStages * kChunkStage;
  auto kernel = bulkperm_chunked_kernel<P>;
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, kThreads, bytes, s>>>(X, S2, inv_xn, out, n, p, ldx, K, ktiles,
                                       (n + kChunkN - 1) / kChunkN, copy_width(S2, K), wvec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 where a launch with n samples keeps the trait's operand in shared
// memory, 0 where it walks n in chunks.
int bulklmm_bulkperm_is_resident(int n) { return is_resident(n) ? 1 : 0; }

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 on success). Pointers are device pointers to contiguous float32 arrays,
// but X: its n rows are ldx >= p floats apart, ldx a multiple of 4 and X
// 16-byte aligned, so that every row takes 16-byte copies, with zeros in
// the columns past p. bf16 != 0 takes the products as three bf16 passes,
// else as three TF32.
int bulklmm_bulkperm_maxr2(const float* X, int ldx, const float* S2, const float* inv_xn,
                           float* out, int n, int p, int mb, int K, int bf16, void* stream) {
  const int ktiles = (K + kTileK - 1) / kTileK;
  if (n <= 0 || p <= 0 || mb <= 0 || K <= 0 || (long long)mb * n > INT_MAX ||
      (long long)mb * ktiles > INT_MAX || ldx < p || ldx % 4 != 0 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<bf16x3::Policy>(X, ldx, S2, inv_xn, out, n, p, mb, K, s)
                    : launch<tf32x3::Policy>(X, ldx, S2, inv_xn, out, n, p, mb, K, s));
}

}  // extern "C"
