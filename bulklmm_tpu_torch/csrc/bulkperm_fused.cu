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
// Design of the resident path (n <= 88). A block of 8 warps (two
// warpgroups) owns one trait and a tile of 256 permutations and walks all
// markers, 64 at a time.
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
// Above that size (bulkperm_chunked_kernel, n > 88) the trait's operand does
// not fit: n is walked in chunks of 32 samples, and S2 is read again for
// every tile of markers. At biobank scale (5,000 x 100,000, 32 traits x
// 1,001 columns: 3.2e13 flops, 0.19 s as three TF32 passes at the card's
// peak) the design is:
//
// - A block owns 128 markers x 128 permutations of one trait: two
//   warpgroups of 64 markers, each one m64n128 product set (wgmma m64n128k8
//   under tf32x3, k16 under bf16x3) with the same S2 chunk as B. X is the A
//   operand from registers, each warpgroup loading and splitting only its
//   own rows (split_by_bits(), the integer form of the TF32 split).
// - Each chunk of S2 is split once for the block into its two halves,
//   K-major in shared memory, a column's 4 depths one 16-byte store of each
//   half, into one of two buffers: the split of the next chunk runs while
//   the products of this one do.
// - The copies run two chunks ahead through a ring of 4 stages (X | S2) by
//   cp.async, 16 bytes a copy whatever K is: a row of S2 is copied from the
//   16-byte boundary at or before column k0, and the split reads each row
//   from its offset (row_shift()), where 4-byte copies would be four times
//   as many. Two barriers a chunk; the products of a chunk are
//   waited for at the top of the next, so that one warpgroup's products run
//   while the other loads and folds. ptxas keeps every wgmma asynchronous
//   only while no ordinary instruction writes a product set: the set is
//   zeroed by a product of zeros (ordinary zeroing made it serialize them
//   all, C7515).
// - The tensor cores cut a float32 sum toward zero (accumulate_probe.cu), so
//   a set carried over many chunks drifts. The set is added into float32
//   running totals in registers, rounded to nearest, after every run of
//   kFoldChunks = 2 chunks (64 samples), and the next run's first product
//   overwrites it. Measured at 5,000 samples (PERF.md): runs of 1, 2, 4 and
//   8 chunks strayed 5.7e-6, 6.0e-6, 9.7e-6 and 1.9e-5 in LOD from float64
//   (an mma.sync mainloop that rounds every depth step: 1.2e-5); runs of 2
//   took 0.510 s a launch at biobank scale, runs of 1 0.527 s. The order
//   (each chunk's three passes, A small x B big, A big x B small, A big x
//   B big, over its depth steps; a run's sum into the totals) is the split
//   reference's (kernels/bulkperm_fused.py).
// - The marker walk is split across blocks where the (trait, permutation
//   tile) pairs alone give fewer than kWaves = 8 blocks an SM (32 traits x 8
//   tiles = 256 pairs on 132 SMs: 5 groups of 157 tiles): geometry(), the
//   rule of bulklmm_bulkperm_marker_groups and of marker_groups() in Python.
//   A pair's groups sit side by side in the grid. Each block folds its
//   maxima by shuffles and through shared memory, then takes them into the
//   output by atomicMax on the bits of r^2 >= 0, whose integer order is the
//   float order, into zeros (the wrapper's fill): a max is exact and
//   order-free, so the output is bit-for-bit the same for every split.
//
// The products' policy is both kernels' first template parameter: three
// TF32 passes (tf32x3::Policy, depth steps of 8) for every preset but
// THROUGHPUT, three bf16 passes (bf16x3::Policy, depth steps of 16) for
// THROUGHPUT's "high" products, as the TPU kernel's HIGH branch splits them.
// Under bf16x3 the resident operand is two bf16 tiles (40 KB each at n = 79,
// stored in the slot order of mma_bf16x3.cuh) and the products are
// wgmma m64n128k16, as are the chunked kernel's, on bf16 halves of its
// chunks (a word packs samples s and s + 4), folded alike. Which path a
// launch takes (n <= 88 resident) is the same for both policies.
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


// --- the staged operand: warpgroup products over chunks of n ----------------------

namespace chunked {

constexpr int kMarkers = 128;  // markers of a block: 64 a warpgroup
constexpr int kColumns = 128;  // permutations of a block: one m64n128 product set a warpgroup
constexpr int kChunk = 32;     // samples a chunk: 4 depth steps of 8 (tf32x3), 2 of 16 (bf16x3)
constexpr int kRing = 4;       // raw chunks in the ring: copies run two chunks ahead of the split
constexpr int kFoldChunks = 2;  // chunks a product set carries into its running totals
constexpr int kWaves = 8;      // blocks an SM that the marker groups aim at
constexpr int kLd = padded_stride(kMarkers);  // row stride of a raw chunk (both are 128 wide)
constexpr int kRawFloats = kChunk * kLd;      // one raw operand chunk
constexpr int kStageFloats = 2 * kRawFloats;  // a stage: X | S2
// 16-byte blocks of a row of S2's raw chunk: the 128 columns and up to 3
// floats before them, where a row of S2 starts off a 16-byte boundary
constexpr int kRowBlocks = kColumns / 4 + 1;
constexpr int kZeroFloats = 8 * kColumns;  // a K-major depth step of zeros
constexpr int kWarps = kThreads / 32;
// one depth step of a split S2 chunk (8 TF32 or 16 bf16 samples, 32 bytes a
// column), in the 16-byte units of a descriptor's address
constexpr uint64_t kStepUnits = 8 * kColumns * 4 / 16;

// 32-bit words of one half of a split S2 chunk: a float each under tf32x3,
// two bf16 values each under bf16x3.
template <class P>
__host__ __device__ constexpr int half_words() {
  return kChunk * kColumns / (P::kStep / 8);
}

// Shared memory of a block: the ring of raw chunks, two split S2 chunks
// (both halves each), every warp's running maxima and the zero step.
template <class P>
constexpr size_t shared_bytes() {
  return 4 * ((size_t)kRing * kStageFloats + 2 * 2 * half_words<P>() + kWarps * kColumns +
              kZeroFloats);
}

// Starts the copies of samples [n0, n0 + kChunk) x markers [p0, p0 + 128)
// of X (n rows, ldx floats apart, 16-byte aligned) into dst (kLd a row):
// thread tid copies the 16 bytes 4 (tid % 32) of rows tid / 32 + 8 i.
// Samples past n and markers past ldx arrive as zeros.
__device__ __forceinline__ void stage_x(float* dst, const float* X, int n, int ldx, int n0, int p0,
                                        int tid) {
  const int c = 4 * (tid % 32), rr = tid / 32;
  const bool inside = p0 + c < ldx;
#pragma unroll
  for (int i = 0; i < kChunk / 8; ++i) {
    const int r = rr + 8 * i;
    const bool ok = inside && n0 + r < n;
    cp_async<16>(dst + r * kLd + c, ok ? X + (size_t)(n0 + r) * ldx + p0 + c : X, ok ? 16 : 0);
  }
}

// Starts the copies of rows [r0, r0 + kChunk) x columns [k0, k0 + 128) of
// S2 (K floats a row, 16-byte aligned) into dst (kLd a row), 16 bytes a
// copy whatever K is: row r's kRowBlocks 16-byte blocks from the one that
// holds column k0 on, so that its columns land at dst[r kLd + shift(r) + c],
// shift(r) = (r0 + r) K + k0 modulo 4 (row_shift()). Thread tid copies
// block tid % 32 of rows tid / 32 + 8 i, the first warp the last block of
// row tid. Columns past K and rows from `valid` on arrive as zeros; the
// floats before the shift are not read.
__device__ __forceinline__ void stage_s2(float* dst, const float* S2, int K, int r0, int valid,
                                         int k0, int tid) {
  auto copy = [&](int r, int b) {
    const size_t at = (size_t)(r0 + r) * K + k0;  // column k0 of the row
    const int shift = (int)(at % 4);
    const int left = r < valid ? K - k0 - (4 * b - shift) : 0;  // columns of the block inside K
    const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
    cp_async<16>(dst + r * kLd + 4 * b, bytes ? S2 + (at - shift + 4 * b) : S2, bytes);
  };
#pragma unroll
  for (int i = 0; i < kChunk / 8; ++i) copy(tid / 32 + 8 * i, tid % 32);
  if (tid < kChunk) copy(tid, kRowBlocks - 1);
}

// Where column k0 of row r of S2 lies in its staged row (stage_s2()):
// floats after the row's first, r K + k0 modulo 4.
__device__ __forceinline__ int row_shift(unsigned r, unsigned K, unsigned k0) {
  return (int)((r * K + k0) % 4u);
}

// d = 0 for a 64 x 128 tile by a product of zeros of the policy's type (A
// zero, B the zero step at desc_zero): d is written by wgmma and not read,
// where zeroing it by ordinary instructions makes ptxas serialize every
// product of the kernel (C7515). Issued after a wgmma_fence().
template <class P>
__device__ __forceinline__ void wgmma_zero(float (&d)[64], uint64_t desc_zero) {
  const uint32_t zero = 0u;
#define BULKPERM_ZERO_OUTPUTS                                                                   \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),           \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),   \
      "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),             \
      "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),             \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),             \
      "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]),             \
      "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),             \
      "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),             \
      "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),             \
      "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),             \
      "=f"(d[62]), "=f"(d[63])
#define BULKPERM_ZERO_D                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "            \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "            \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
  if constexpr (P::kStep == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %64, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" BULKPERM_ZERO_D
        "}, {%64, %64, %64, %64}, %65, p, 1, 1;\n}\n"
        : BULKPERM_ZERO_OUTPUTS
        : "r"(zero), "l"(desc_zero));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %64, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" BULKPERM_ZERO_D
        "}, {%64, %64, %64, %64}, %65, p, 1, 1, 0;\n}\n"
        : BULKPERM_ZERO_OUTPUTS
        : "r"(zero), "l"(desc_zero));
  }
#undef BULKPERM_ZERO_OUTPUTS
#undef BULKPERM_ZERO_D
}

// The raw (kChunk, kLd) S2 chunk `raw` of rows r0 .. (stage_s2(): row s's
// columns from row_shift(r0 + s) on) split into its halves at `big` and
// big + half_words<P>(), K-major over kColumns columns, so that a column's
// 4 consecutive words (4 depths) are 16 contiguous bytes of each half. A
// thread takes column c = e % 128 at word depths w0 = 4 (e / 128) .. w0 + 3
// and stores each half as one 16-byte word; the 32 threads of a warp read
// and write 32 neighbouring columns. Under tf32x3 a word depth is a sample;
// under bf16x3 word w0 + i packs samples 2 w0 + i and 2 w0 + i + 4
// (sample_of_word(), mma_bf16x3.cuh's slot order).
template <class P>
__device__ __forceinline__ void split_chunk(float* big, const float* raw, int r0, int K, int k0,
                                            int tid) {
  constexpr int kHalf = half_words<P>();
  constexpr int kRows = P::kStep / 2;  // samples of 4 word depths
#pragma unroll
  for (int j = 0; j < kHalf / 4 / kThreads; ++j) {
    const int e = tid + j * kThreads;
    const int c = e % kColumns, w0 = 4 * (e / kColumns), s0 = kRows * (e / kColumns);
    float v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = raw[(s0 + i) * kLd + row_shift(r0 + s0 + i, K, k0) + c];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (P::kStep == 8) split_by_bits(v[i], hi[i], lo[i]);
      else bf16x3::split_pair(v[i], v[i + 4], hi[i], lo[i]);
    }
    // kmajor_offset(w0, c, kColumns) at w0 % 4 == 0, written out: a call of
    // it here changed how the compiler inlined it into the resident kernel
    const int at = (w0 / 4) * (4 * kColumns) + 4 * c;
    *reinterpret_cast<uint4*>(big + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(big + kHalf + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The halves of a warp's A fragments of a chunk from the staged chunk of X:
// fragment row r of the warp's 16 is marker 2 (r % 8) + r / 8 (acol points
// at the thread's markers 2 g and 2 g + 1 of the warp's rows, which load as
// one 64-bit word), depth step ks in a_big[ks] and a_small[ks].
template <class P>
__device__ __forceinline__ void load_chunk_a(uint32_t (&a_big)[kChunk / P::kStep][4],
                                             uint32_t (&a_small)[kChunk / P::kStep][4],
                                             const float* acol, int q) {
#pragma unroll
  for (int ks = 0; ks < kChunk / P::kStep; ++ks) {
    if constexpr (P::kStep == 16) {
      float v[8];  // v[2 h + r]: sample 16 ks + q + 4 h, fragment row g + 8 r
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float pair[2];
        load_vec<2>(acol + (16 * ks + q + 4 * h) * kLd, pair);
        v[2 * h] = pair[0], v[2 * h + 1] = pair[1];
      }
      bf16x3::split_fragment(v, a_big[ks], a_small[ks]);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
        load_vec<2>(acol + (8 * ks + q + 4 * h) * kLd, v);
        split_by_bits(v[0], a_big[ks][2 * h], a_small[ks][2 * h]);
        split_by_bits(v[1], a_big[ks][2 * h + 1], a_small[ks][2 * h + 1]);
      }
    }
  }
}

// The launch geometry of the chunked kernel: marker groups, as many as give
// about kWaves blocks an SM where the (trait, column tile) pairs alone do
// not, each an equal run of 128-marker tiles (`group_tiles`), none empty.
struct Geometry {
  long long blocks;
  int groups, group_tiles, ktiles;
};

inline Geometry geometry(int p, int mb, int K, int sms) {
  Geometry geo;
  geo.ktiles = (K + kColumns - 1) / kColumns;
  const long long pairs = (long long)mb * geo.ktiles;
  const int ptiles = (p + kMarkers - 1) / kMarkers;
  long long groups = ((long long)kWaves * sms + pairs - 1) / pairs;
  groups = groups < 1 ? 1 : (groups > ptiles ? ptiles : groups);
  geo.group_tiles = (int)((ptiles + groups - 1) / groups);
  geo.groups = (ptiles + geo.group_tiles - 1) / geo.group_tiles;
  geo.blocks = pairs * geo.groups;
  return geo;
}

}  // namespace chunked

// The block of the chunked kernel: blockIdx.x = (pair, group), pair = (trait
// t, column tile), so that the marker groups of one pair sit side by side in
// the grid and read each chunk of its S2 through L2 at about the same time.
template <class P>
__global__ void __launch_bounds__(kThreads, 1)
bulkperm_chunked_kernel(const float* __restrict__ X,       // (n, ldx) rotated markers
                        const float* __restrict__ S2,      // (mb, n, K) trait operands
                        const float* __restrict__ inv_xn,  // (mb, p) 1 / marker norm^2
                        float* __restrict__ out,           // (mb, K) max r^2, zeros on entry
                        int n, int p, int ldx, int K, int ktiles, int groups, int group_tiles) {
  using namespace chunked;
  constexpr int kSteps = kChunk / P::kStep;
  constexpr int kHalf = half_words<P>();
  extern __shared__ __align__(128) float4 chunked_shared_raw[];
  float* stages = reinterpret_cast<float*>(chunked_shared_raw);  // [kRing][X | S2]
  float* split_s = stages + kRing * kStageFloats;              // [2][big | small]
  float* best_s = split_s + 2 * 2 * kHalf;                        // [kWarps][kColumns]
  float* zero_s = best_s + kWarps * kColumns;                     // [kZeroFloats]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int group = warp / 4;        // the warpgroup: markers 64 group ..
  const int wrow = 16 * (warp % 4);  // the warp's first marker in its warpgroup's 64
  const int pair = blockIdx.x / groups;
  const int t = pair / ktiles, k0 = (pair % ktiles) * kColumns;
  const int ptiles = (p + kMarkers - 1) / kMarkers;
  const int first = (blockIdx.x % groups) * group_tiles;
  const int last = min(first + group_tiles, ptiles);
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int nsteps = (last - first) * nchunks;  // chunks of the block's walk

  // one step's copies: the chunk of both warpgroups' markers and of S2
  auto start_copies = [&](int step) {
    if (step < nsteps) {
      float* st = stages + (step % kRing) * kStageFloats;
      const int tile = first + step / nchunks, n0 = (step % nchunks) * kChunk;
      stage_x(st, X, n, ldx, n0, tile * kMarkers, tid);
      stage_s2(st + kRawFloats, S2, K, t * n + n0, n - n0, k0, tid);
    }
    cp_async_commit();  // an empty group past the walk keeps the count of groups
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) start_copies(s);

  for (int e = tid; e < kWarps * kColumns + kZeroFloats; e += kThreads) best_s[e] = 0.0f;
  fence_proxy_async();
  // the first chunk of a walk's tile starts in row t n of S2 (row_shift())
  const int r_first = t * n;

  cp_async_wait<kRing - 2>();
  __syncthreads();  // chunk 0 has landed; the zero step is in place
  split_chunk<P>(split_s, stages + kRawFloats, r_first, K, k0, tid);
  fence_proxy_async();

  float acc[64], tot[64];  // element 4 j + 2 h + e: marker row g + 8 h, column 8 j + 2 q + e
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.0f;
  wgmma_fence();
  wgmma_zero<P>(acc, kmajor_descriptor(zero_s, kColumns));
  wgmma_commit();
  wgmma_wait<0>();

  // After the products of the walk's chunk `done`: the set joins its running
  // totals at the end of a run of kFoldChunks chunks and at the end of a
  // marker tile, and a marker tile's totals go into the warp's maxima.
  auto finish_chunk = [&](int done) {
    const int chunk = done % nchunks;
    const bool tile_end = chunk == nchunks - 1;
    if (tile_end || (chunk + 1) % kFoldChunks == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
    }
    if (tile_end) {
      const int m0 = (first + done / nchunks) * kMarkers + 64 * group + wrow + 2 * g;
      float w[2];  // inv_xn of the thread's markers (fragment rows g and g + 8), 0 past p
#pragma unroll
      for (int h = 0; h < 2; ++h) w[h] = m0 + h < p ? __ldg(inv_xn + (size_t)t * p + m0 + h) : 0.0f;
      float* mine = best_s + warp * kColumns;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // each product rounded on its own, as torch forms (num * num) * inv_xn
          const float n0 = tot[4 * j + e], n1 = tot[4 * j + 2 + e];
          float m = fmaxf(__fmul_rn(__fmul_rn(n0, n0), w[0]), __fmul_rn(__fmul_rn(n1, n1), w[1]));
#pragma unroll
          for (int d = 4; d < 32; d *= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
          if (g == 0) mine[8 * j + 2 * q + e] = fmaxf(mine[8 * j + 2 * q + e], m);
        }
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = 0.0f;
    }
  };

  const float* acol = stages + 64 * group + wrow + 2 * g;  // the thread's markers in stage 0
  const uint64_t desc0 = kmajor_descriptor(split_s, kColumns);
  constexpr uint64_t kSmallUnits = kHalf * 4 / 16, kBufferUnits = 2 * kSmallUnits;
  for (int step = 0; step < nsteps; ++step) {
    __syncthreads();  // this chunk's split S2 is complete; every thread is past the last step
    wgmma_wait<0>();  // this warpgroup's products of the last chunk are done
    pin_registers(acc);
    if (step > 0) finish_chunk(step - 1);

    // the products: both halves of X from registers, S2's from shared
    // memory; a run's first product overwrites the set (scale-d 0)
    uint32_t a_big[kSteps][4], a_small[kSteps][4];
    load_chunk_a<P>(a_big, a_small, acol + (step % kRing) * kStageFloats, q);
    const int keep = (step % nchunks) % kFoldChunks != 0;
    const uint64_t d_big = desc0 + (step & 1) * kBufferUnits, d_small = d_big + kSmallUnits;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      P::wgmma_m64n128(acc, a_small[ks], d_big + ks * kStepUnits, ks > 0 || keep);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      P::wgmma_m64n128(acc, a_big[ks], d_small + ks * kStepUnits, 1);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      P::wgmma_m64n128(acc, a_big[ks], d_big + ks * kStepUnits, 1);
    wgmma_commit();

    // while they run: the copies of the chunk kRing - 1 ahead (into the
    // stage of the last chunk, whose X every thread has loaded and whose S2
    // was split a step before), then the next chunk's S2 split into the
    // buffer that the last chunk's products read
    start_copies(step + kRing - 1);
    cp_async_wait<kRing - 2>();
    __syncthreads();  // the next chunk has landed; both warpgroups' last products are done
    if (step + 1 < nsteps) {
      split_chunk<P>(split_s + ((step + 1) & 1) * 2 * kHalf,
                     stages + ((step + 1) % kRing) * kStageFloats + kRawFloats,
                     r_first + ((step + 1) % nchunks) * kChunk, K, k0, tid);
      fence_proxy_async();
    }
  }
  wgmma_wait<0>();
  pin_registers(acc);
  finish_chunk(nsteps - 1);

  // the block's maxima over its eight warps into the output: r^2 >= 0, so
  // its bits order as integers do and the zeros on entry are the max's identity
  __syncthreads();
  if (tid < kColumns && k0 + tid < K) {
    float m = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, best_s[w * kColumns + tid]);
    atomicMax(reinterpret_cast<int*>(out + (size_t)t * K + k0 + tid), __float_as_int(m));
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

// The SM count of the current device.
inline cudaError_t device_sms(int& sms) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return rc;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
}

template <class P>
cudaError_t launch_chunked(const float* X, int ldx, const float* S2, const float* inv_xn,
                           float* out, int n, int p, int mb, int K, cudaStream_t s) {
  int sms = 0;
  cudaError_t rc = device_sms(sms);
  if (rc != cudaSuccess) return rc;
  const chunked::Geometry geo = chunked::geometry(p, mb, K, sms);
  if (geo.blocks > INT_MAX || reinterpret_cast<uintptr_t>(S2) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t bytes = chunked::shared_bytes<P>();
  auto kernel = bulkperm_chunked_kernel<P>;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<(unsigned)geo.blocks, kThreads, bytes, s>>>(X, S2, inv_xn, out, n, p, ldx, K,
                                                       geo.ktiles, geo.groups, geo.group_tiles);
  return cudaGetLastError();
}

template <class P>
cudaError_t launch(const float* X, int ldx, const float* S2, const float* inv_xn, float* out,
                   int n, int p, int mb, int K, cudaStream_t s) {
  if (!is_resident(n)) return launch_chunked<P>(X, ldx, S2, inv_xn, out, n, p, mb, K, s);
  const int ktiles = (K + kTileK - 1) / kTileK;
  const dim3 grid((unsigned)(mb * ktiles));
  const int wvec = copy_width(inv_xn, p);
  return launch_wide<P, resident_steps<P>()>(grid, s, X, S2, inv_xn, out, n, p, ldx, K, ktiles,
                                             wvec);
}

}  // namespace

extern "C" {

// 1 where a launch with n samples keeps the trait's operand in shared
// memory, 0 where it walks n in chunks.
int bulklmm_bulkperm_is_resident(int n) { return is_resident(n) ? 1 : 0; }

// The marker groups that a launch of n samples, p markers, mb traits and K
// permutations splits its marker walk into on the current device: 1 on the
// resident path, a negative CUDA error code where the device cannot be read.
int bulklmm_bulkperm_marker_groups(int n, int p, int mb, int K) {
  if (n <= 0 || p <= 0 || mb <= 0 || K <= 0) return -(int)cudaErrorInvalidValue;
  if (is_resident(n)) return 1;
  int sms = 0;
  const cudaError_t rc = device_sms(sms);
  return rc != cudaSuccess ? -(int)rc : chunked::geometry(p, mb, K, sms).groups;
}

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 on success). Pointers are device pointers to contiguous float32 arrays,
// but X: its n rows are ldx >= p floats apart, ldx a multiple of 4 and X
// 16-byte aligned, so that every row takes 16-byte copies, with zeros in
// the columns past p. On the chunked path (n > 88) `out` holds zeros on
// entry: the marker groups take their maxima into it. bf16 != 0 takes the
// products as three bf16 passes, else as three TF32.
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
