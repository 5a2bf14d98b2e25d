// The chunked mainloop of the LOD kernels that do not keep the traits'
// operands resident: the general kernel (n > 88 samples, c <= 3 covariate
// columns; liteqtl_fused.cu) and the wide kernel (c > 3 at any n, on the
// whitened operands; liteqtl_wide.cu), for the function that
// liteqtl_fused.cu states.
//
// What bounds both on an H100: the operations, 2 (c + 2) n p m flops as
// three TF32 passes on the tensor cores (at 2,000 x 100,000 x 2,048, c = 1:
// 2.46e12 flops, 14.9 ms), or as three bf16 passes under THROUGHPUT (7.45
// ms), against one (p, m) write and operands read once. The products'
// policy is the first template parameter of everything below that touches
// the products, as in the resident kernel: tf32x3::Policy (depth steps of 8)
// for every preset but THROUGHPUT, bf16x3::Policy (steps of 16,
// mma_bf16x3.cuh) for its "high" products; Chunking<P> holds what differs
// (see its note). The design:
//
// - A block of two warpgroups owns 64 traits and walks a group of marker
//   tiles two at a time, one 64-marker tile a warpgroup. Both warpgroups
//   walk the samples in chunks of kChunk in lockstep, so that each chunk of
//   the traits' operands is staged and split once for 128 markers.
// - The samples arrive through a ring of two stages by cp.async: the marker
//   tiles (16-byte copies: the wrapper hands X over with 16-byte aligned
//   rows), the chunk of every trait operand the walk needs and, for the
//   general kernel, the covariates. The next chunk's copies are in flight
//   while this one multiplies. Samples past n, markers past p and traits
//   past m arrive as zeros.
// - Each chunk's trait operands (W and WY for the general kernel; V_k, with
//   W and WY on the first walk, for the wide one) are split into their TF32
//   (bf16) halves once, by all 256 threads, and laid out K-major in shared
//   memory as wgmma's B operand. The copies and the split do not overlap the
//   products (two barriers a chunk), and each costs a large share of a
//   launch; a third warpgroup that copies and splits one step ahead of the
//   other two (named barriers, setmaxnreg 56 / 224) was slower and spilled.
// - X is the A operand, from registers, as in the resident kernel: one
//   fragment load gives X, X * X and X * C_k, each rounded to float32 as the
//   plain version rounds it and then split. Every product set is an m64n64
//   accumulator of 32 registers a thread. A bf16x3 step of 16 samples takes
//   two loads of a TF32 step's 8, each made into two of the four packed A
//   registers (fill_a()), so that a load holds no more registers than
//   under 3 x TF32.
// - Within a chunk the small terms of every depth step come first and the
//   leading terms after them, as in the resident kernel, in three passes
//   over the chunk (A small x B big, A big x B small, A big x B big; see
//   Pass).
// - The tensor cores' float32 accumulation cuts where it should round, so
//   under 3 x TF32 (Chunking<P> says why bf16x3 does not fold) one
//   accumulator carried across the 50 chunks of 2,000 samples drifts
//   by 750 cuts (1.05e-4 in LOD from the plain version at 2,000 x 8,192 x
//   2,048). A walk therefore adds its sets into float32 running totals,
//   rounded to nearest, every kFoldChunks chunks past 200 samples and after
//   every chunk below (fold_chunks()), and starts them again from zero: the
//   cuts then fall on partial sums of at most kFoldChunks chunks, or one.
//   Five chunks (200 samples) bring the 2,000-sample block back to the fmaf
//   kernel's distance; ten leave it at twice that, and every fold adds to
//   a launch's time. At BXD's 79 samples (two chunks) a fold after the
//   first took the wide kernel at c = 4 and 12 from 1.06e-5 to 3.7e-6 and
//   4.6e-6 from EXACT64, at a third more time (PERF.md). The totals cannot live in registers (a second (c + 2) x 32 set,
//   320 at c = 3, past the 255 a thread may hold) nor in shared memory
//   (160 KB a block at c = 3): they lie in device memory, one slot a
//   resident block (claim_slot()), read and written through L2. A walk of
//   one chunk (40 samples or fewer) takes no slot: each kernel has an
//   instantiation that folds (kFold) and one that does not.
//   The chunk after a fold starts its products with scale-d 0
//   (keeps_sets()), which overwrites the sets: zeroing them there by a
//   product of zeros in a branch made ptxas serialize the products
//   (C7514), and walking each run in a loop of its own made the wide kernel
//   spill 444 bytes. A walk that folds adds its last chunks into the totals
//   too and reads its sums back from them, so that its sets die there:
//   taking the sums as total + set where they are used spilled as well.
//   The CPU twin (kernels/split.py::matmul_tf32x3_emulated, with
//   chunk=CHUNK_SAMPLES and run=fold_chunks(n)) folds the same way.
// - A chunk is 40 samples, five depth steps of 8 fixed at compile time
//   (bf16x3: 32 samples, two steps of 16; Chunking): BXD's 79 samples take
//   two chunks (80, as the resident kernel's 10 steps; bf16x3 three, 96)
//   and 2,000 take 50 (63, 2,016), with no step spent on padding. A run-time
//   step count (the last chunk cut to the steps that hold samples) put the
//   products in branches, and ptxas then moved accumulator registers
//   between them (warpgroup.arrive injected, C7519) and spilled.
// - After each chunk's products the warpgroups wait for them (wgmma_wait<0>):
//   the next chunk's split overwrites the tiles they read.
// - A walk starts its product sets with a product of zeros (zero_sets()),
//   which writes them without reading them: the compiler then knows that a
//   set is dead between its last read in the epilogue and the next walk,
//   and the epilogue's exact divisions have its registers to spare. Zeroing
//   them by ordinary instructions instead makes ptxas serialize the
//   products (C7515), and accumulating into them with a run-time first-
//   product flag kept every set live through the epilogue, which spilled.
// - The epilogues round every product, difference and quotient on its own
//   (__fmul_rn, __fsub_rn, __fdiv_rn), as the plain version does: left to
//   the compiler, the LOD-only kernel and its effects variant fused other
//   pairs into fma and their LODs differed.
// - The grid is (trait tiles x marker groups), the markers cut into groups
//   of an even count of tiles only as far as is needed for about kWaves
//   blocks an SM, as for the resident kernel.
//
// The epilogues work on the accumulator layout: a thread holds two
// neighbouring traits of two neighbouring markers in each of 8 column tiles.
// The LOD leaves through shared memory a whole row an instruction; the
// effects variant's effect and standard error straight from the accumulator
// layout, a pair of traits a store.

#pragma once

#include <algorithm>

#include "liteqtl_resident.cuh"

namespace liteqtl {
namespace chunked {

constexpr int kRawLd = padded_stride(kTileM);  // row stride of a staged trait operand
constexpr uint64_t kStepUnits = 8 * kTileM * 4 / 16;  // one depth step of a split operand, 16-byte units
constexpr int kZeroFloats = 8 * kTileM;  // a K-major depth step of zeros: zero_sets()' B operand
constexpr int kWgThreads = kThreads / kGroups;    // threads of a warpgroup
constexpr int kSetFloats = 32 * kWgThreads;       // one warpgroup's product set

// The chunk and the running totals of the policy P. Under tf32x3 a chunk is
// 40 samples, five steps of 8, and a set joins its running total every 5
// chunks past 200 samples and after every chunk below (fold_chunks()).
// Under bf16x3 a chunk is 32 samples, two steps of 16: a half of a split
// operand then takes 2 bytes a value, but the raw float32 stages grow with
// the chunk's samples, and at 48 the wide kernel's stages, split operands,
// D1 and finished tiles (which no longer fit its split W and WY) take
// 244,736 bytes, past the 232,448 a block may have. The bf16x3 sets never
// join running totals (kFoldChunks 0): folding as 3 x TF32 does (after
// every chunk up to 192 samples, every 6 chunks past) took 1.44-1.72x the
// time at BXD's 79 samples, where bf16x3's own rounding left the distances
// as they were, and 1.16-1.21x at 2,000, where it halved the distance from
// the float32 plain version (1.05e-4 to 5.3e-5 in LOD; THROUGHPUT's bar
// there is 0.1; PERF.md).
template <class P>
struct Chunking {
  static constexpr int kChunk = P::kStep == 8 ? 40 : 32;  // samples a chunk
  static constexpr int kSteps = kChunk / P::kStep;        // depth steps a chunk
  // 32-bit words of one half of one split operand
  static constexpr int kHalfFloats = kChunk * kTileM * 8 / P::kStep;
  static constexpr int kXFloats = kChunk * kLdX;  // one warpgroup's chunk of its marker tile
  // chunks a set carries before it joins its running total, past
  // kFoldChunks chunks of samples; 0: the sets never join one
  static constexpr int kFoldChunks = P::kStep == 8 ? 5 : 0;
};

// Floats of one stage: both warpgroups' marker chunks, `ops` raw trait
// operands and c covariate columns.
template <class P>
__host__ __device__ constexpr int stage_floats(int ops, int c) {
  using K = Chunking<P>;
  return kGroups * K::kXFloats + ops * K::kChunk * kRawLd + c * K::kChunk;
}

// Floats of the finished tiles, one a warpgroup.
constexpr int kFinishedFloats = kGroups * kTileP * kLdOut;

// Floats of shared memory: the split operands (both halves), two stages,
// the finished tiles (unless `finished_apart` is false: they then take the
// place of split operands that the kernel's last walk does not read), the
// zero step and `srows` rows of per-trait scalars.
template <class P>
__host__ __device__ constexpr size_t shared_floats(int ops, int c, int srows,
                                                   bool finished_apart = true) {
  return 2 * (size_t)ops * Chunking<P>::kHalfFloats + 2 * (size_t)stage_floats<P>(ops, c) +
         (finished_apart ? kFinishedFloats : 0) + kZeroFloats + (size_t)srows * kTileM;
}

// d = 0 for a 64 x 64 tile by a product of zeros (A zero, B the zero step at
// desc_zero, the sum not read): d is written, not read, so its old value is
// dead before it. Issued after a wgmma_fence().
__device__ __forceinline__ void wgmma_zero_m64n64k8(float (&d)[32], uint64_t desc_zero) {
  const uint32_t zero = 0u;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %32, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %32, %32, %32}, %33, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(zero), "l"(desc_zero));
}

// The bf16 form of wgmma_zero_m64n64k8(): the zero step's 2,048 bytes are
// a K-major depth step of 16 bf16 zeros as well.
__device__ __forceinline__ void wgmma_zero_m64n64k16(float (&d)[32], uint64_t desc_zero) {
  const uint32_t zero = 0u;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %32, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %32, %32, %32}, %33, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(zero), "l"(desc_zero));
}

// d = 0 by a product of zeros of the policy's own type, so that a kernel
// issues one kind of wgmma.
template <class P>
__device__ __forceinline__ void wgmma_zero(float (&d)[32], uint64_t desc_zero) {
  if constexpr (P::kStep == 8) wgmma_zero_m64n64k8(d, desc_zero);
  else wgmma_zero_m64n64k16(d, desc_zero);
}

// Every set of acc zeroed (wgmma_zero()), as one group, waited for: an
// instruction that touches a set while its product is in flight (even the
// empty asm of pin_registers()) makes ptxas serialize every product of the
// kernel (C7514).
template <class P, int kSets>
__device__ __forceinline__ void zero_sets(float (&acc)[kSets][32], uint64_t desc_zero) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kSets; ++s) wgmma_zero<P>(acc[s], desc_zero);
  wgmma_commit();
  wgmma_wait<0>();
}

// The sets b, d1, ... zeroed as one group, waited for (zero_sets()).
template <class P, class... Sets>
__device__ __forceinline__ void zero_each(uint64_t desc_zero, Sets&... sets) {
  wgmma_fence();
  (wgmma_zero<P>(sets, desc_zero), ...);
  wgmma_commit();
  wgmma_wait<0>();
}

// The block's zero step, K-major (kZeroFloats floats), before its first
// barrier.
__device__ __forceinline__ void clear_zero_step(float* zeros, int tid) {
  for (int e = tid; e < kZeroFloats; e += kThreads) zeros[e] = 0.0f;
}

// --- the running totals ------------------------------------------------------------

// Floats of the running totals' device memory for `slots` resident blocks
// and `sets` product sets: one claim flag a slot (an int, zero when free;
// padded to 128 bytes), then each slot's [kGroups][sets][32][kWgThreads]
// floats, a thread's element i of a set kWgThreads floats after its i - 1.
__host__ __device__ constexpr long long total_floats(int slots, int sets) {
  return (slots + 31) / 32 * 32 + (long long)slots * kGroups * sets * kSetFloats;
}

// Whether a walk over n samples folds its sets into running totals: every
// walk of more than one chunk, under a policy whose sets join totals.
template <class P>
__host__ __device__ constexpr bool folds(int n) {
  return Chunking<P>::kFoldChunks > 0 && n > Chunking<P>::kChunk;
}

// Chunks that a walk over n samples carries in its sets before it adds them
// into their totals: one up to kFoldChunks chunks (BXD's 79 samples take
// two), so that no sum is cut at the result's full magnitude, and
// kFoldChunks past that, where a fold every chunk would cost a fold five
// times as often (1 where the policy never folds).
template <class P>
__host__ __device__ constexpr int fold_chunks(int n) {
  using K = Chunking<P>;
  return n > K::kFoldChunks * K::kChunk && K::kFoldChunks > 0 ? K::kFoldChunks : 1;
}

// The block's slot, claimed by its thread 0 from `slots` claim flags. At
// most `slots` blocks are resident and a block frees its slot as it ends
// (release_slot()), so a resident block always finds a free one.
__device__ __forceinline__ int claim_slot(int* flags, int slots) {
  int s = (int)((blockIdx.x + (size_t)gridDim.x * blockIdx.y) % slots);
  while (atomicCAS(flags + s, 0, 1) != 0) s = s + 1 == slots ? 0 : s + 1;
  __threadfence();
  return s;
}

// Frees the block's slot; every thread's totals are written (after a
// __syncthreads()).
__device__ __forceinline__ void release_slot(int* flags, int slot) {
  __threadfence();
  atomicExch(flags + slot, 0);
}

// The thread's element 0 of set 0 in its warpgroup's part of `slot`.
__device__ __forceinline__ float* slot_totals(float* totals, int slots, int slot, int sets,
                                              int group, int tid) {
  return totals + (slots + 31) / 32 * 32 + ((size_t)slot * kGroups + group) * sets * kSetFloats +
         tid % kWgThreads;
}

// The set acc into its running total at tot (the thread's element 0):
// tot = acc on a walk's first fold, else tot = tot + acc, every load issued
// before the first add.
__device__ __forceinline__ void fold_set(float* tot, const float (&acc)[32], bool first) {
  if (first) {
#pragma unroll
    for (int i = 0; i < 32; ++i) __stcg(tot + i * kWgThreads, acc[i]);
    return;
  }
  float t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = __ldcg(tot + i * kWgThreads);
#pragma unroll
  for (int i = 0; i < 32; ++i) __stcg(tot + i * kWgThreads, __fadd_rn(t[i], acc[i]));
}

// Whether a walk over nchunks chunks adds its sets into their totals after
// `chunk`: the last chunk of a run of `every` (fold_chunks()), unless it
// ends the walk.
__device__ __forceinline__ bool fold_after(int chunk, int nchunks, int every) {
  return (chunk + 1) % every == 0 && chunk + 1 < nchunks;
}

// The scale-d of a chunk's first products: 0 for a chunk that starts a run
// past the walk's first, so that they overwrite the sets that the fold
// before it took; the walk's first chunk adds to the zeroed sets.
__device__ __forceinline__ int keeps_sets(int chunk, int every) {
  return chunk % every != 0 || chunk == 0;
}

// --- the exact epilogue, every operation rounded on its own ---------------------

// keep = D > 1024 eps D1, then the floor D >= 4 eps D1.
__device__ __forceinline__ bool keep_and_floor(float& d, float d1) {
  const float eps = FLT_EPSILON;
  const bool keep = d > 1024.0f * eps * d1;
  d = fmaxf(d, 4.0f * eps * d1);
  return keep;
}

// The forward substitution of residualize() (liteqtl_resident.cuh) with
// IEEE divisions: num = B and d = D1 residualized on the trait's covariate
// basis (u = U_0 .. U_{C-1}; scal(row) its entry of the scalar block), the
// keep test returned and d floored.
template <int C, class Scal>
__device__ __forceinline__ bool residualize_rn(float& num, float& d, float d1,
                                               const float (&u)[C], Scal scal) {
  constexpr int kTri = C * (C + 1) / 2;
  float z[C];
  d = d1;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    float t = u[k];
#pragma unroll
    for (int q = 0; q < k; ++q) t = __fsub_rn(t, __fmul_rn(scal(tri_row(C, k, q)), z[q]));
    z[k] = __fdiv_rn(t, scal(tri_row(C, k, k)));
    num = __fsub_rn(num, __fmul_rn(z[k], scal(kTri + k)));
    d = __fsub_rn(d, __fmul_rn(z[k], z[k]));
  }
  return keep_and_floor(d, d1);
}

// LOD = -(n/2) log10(max(1 - r2, FLT_MIN)), r2 = keep ? num^2 inv_nrm2 / d : 0.
__device__ __forceinline__ float lod_rn(float num, float d, bool keep, float inv_nrm2,
                                        float neg_half_n) {
  const float r2 = keep ? __fdiv_rn(__fmul_rn(__fmul_rn(num, num), inv_nrm2), d) : 0.0f;
  return __fmul_rn(neg_half_n, log10f(fmaxf(__fsub_rn(1.0f, r2), FLT_MIN)));
}

// The effect and its standard error as effect_from_products() takes them:
// num masked by both keep tests, d at least FLT_MIN,
// beta = num / d, SE = sqrt(max(nrm2 - num^2 / d, 0) / dof / d), by one
// reciprocal of d in place of three IEEE divisions (inv_dof = 1 / dof): the
// epilogue runs while the tensor cores wait, and the effects are held to a
// relative 1e-4, not to the LOD's exact forms.
__device__ __forceinline__ Effect effect_rn(float num, float d, bool keep, float inv_nrm2,
                                            float nrm2, float inv_dof) {
  const float nk = (keep && inv_nrm2 > 0.0f) ? num : 0.0f;
  const float inv_d = __frcp_rn(fmaxf(d, FLT_MIN));
  const float beta = __fmul_rn(nk, inv_d);
  const float rss = fmaxf(__fsub_rn(nrm2, __fmul_rn(nk, beta)), 0.0f);
  return {beta, __fsqrt_rn(__fmul_rn(__fmul_rn(rss, inv_dof), inv_d))};
}

// Word e of both bf16 halves of a raw trait operand (split_operand()): word
// depth s = 4 (e / 256) + e % 4 and column c = e / 4 % 64 pack the samples
// sample_of_word(s) and that + 4, hi at big[e], lo at big[half + e].
__device__ __forceinline__ void split_word(float* big, const float* raw, int e, int half) {
  const int s = 4 * (e / (4 * kTileM)) + e % 4, c = (e / 4) % kTileM;
  const int s0 = bf16x3::sample_of_word(s);
  uint32_t hi, lo;
  bf16x3::split_pair(raw[s0 * kRawLd + c], raw[(s0 + 4) * kRawLd + c], hi, lo);
  big[e] = __uint_as_float(hi);
  big[half + e] = __uint_as_float(lo);
}

// The raw (kChunk, kRawLd) trait operand `raw` split into its halves at
// `big` and `big + kHalfFloats`, K-major. kmajor_offset(s, c, 64) is
// 256 (s / 4) + 4 c + s % 4, so thread (c = e / 4 % 64, s % 4 = e % 4)
// writes consecutive words and reads 32 different banks (row stride 8
// modulo 32). Under tf32x3 s is a sample, split in integer arithmetic
// (split_by_bits(): the conversion instruction runs at a fraction of the
// integer units' rate); under bf16x3 s is a word depth, whose word packs
// the samples sample_of_word(s) and that + 4 (mma_bf16x3.cuh's slot order),
// split by cvt.rn.bf16x2 (split_word()). kRolled (bf16x3): one word at a
// time, where the unrolled loop's temporaries beside the general kernel's
// five live sets at c = 3 spilled 8 bytes.
template <class P, bool kRolled = false>
__device__ __forceinline__ void split_operand(float* big, const float* raw, int tid) {
  constexpr int kHalf = Chunking<P>::kHalfFloats;
  if constexpr (kRolled) {
    static_assert(P::kStep == 16, "only the bf16x3 split is rolled");
#pragma unroll 1
    for (int r = 0; r < kHalf / kThreads; ++r) split_word(big, raw, tid + r * kThreads, kHalf);
  } else {
#pragma unroll
    for (int r = 0; r < kHalf / kThreads; ++r) {
      const int e = tid + r * kThreads;
      if constexpr (P::kStep == 8) {
        const int s = 4 * (e / (4 * kTileM)) + e % 4, c = (e / 4) % kTileM;
        uint32_t b, sm;
        split_by_bits(raw[s * kRawLd + c], b, sm);
        big[e] = __uint_as_float(b);
        big[kHalf + e] = __uint_as_float(sm);
      } else {
        split_word(big, raw, e, kHalf);
      }
    }
  }
}

// Starts the copies of rows [n0, n0 + kChunk) x traits [m0, m0 + 64) of the
// (n, m) array src into dst (kRawLd a row), tvec floats a copy.
template <class P>
__device__ __forceinline__ void stage_operand(float* dst, const float* src, int n, int m, int n0,
                                              int m0, int tvec, int tid) {
  stage_tile<kTileM>(dst, kRawLd, src, n, m, n0, m0, Chunking<P>::kChunk, tvec, tid, kThreads);
}

// Starts the copies of both warpgroups' marker chunks: tiles `tile` and
// `tile + 1`, samples [n0, n0 + kChunk); tiles past p arrive as zeros.
template <class P>
__device__ __forceinline__ void stage_markers(float* dst, const float* X, int n, int ldx, int n0,
                                              int tile, int tid) {
  using K = Chunking<P>;
#pragma unroll
  for (int w = 0; w < kGroups; ++w)
    stage_tile_vec<kTileP, 4>(dst + w * K::kXFloats, kLdX, X, n, ldx, n0, (tile + w) * kTileP,
                              K::kChunk, tid, kThreads);
}

// The raw float32 values of one depth step of a thread's A fragment: its two
// markers at depths s0 and s0 + 4, x[2 h + r] at depth s0 + 4 h, fragment
// row g + 8 r (load_step() without covariates).
__device__ __forceinline__ void load_x(float (&x)[4], const float* acol, int s0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[2];
    load_vec<2>(acol + (s0 + 4 * h) * kLdX, v);
    x[2 * h] = v[0], x[2 * h + 1] = v[1];
  }
}

// The three passes of a product, one after another over a chunk's depth
// steps: the small terms (A small x B big, then A big x B small) before the
// leading one (A big x B big); under bf16x3 lo x hi, hi x lo, hi x hi. A
// pass holds one half of each A fragment, 4 registers a product set and
// step, where taking both small terms of a step together held 8 and spilled
// at c = 2 and c = 3; the X forms are made again for each pass.
enum Pass { kSmallA = 0, kSmallB = 1, kLeading = 2 };

// The TF32 half of the float32 value x that pass kPass takes for A.
template <int kPass>
__device__ __forceinline__ uint32_t a_half(float x) {
  if constexpr (kPass == kSmallA) {
    uint32_t big, small;
    split_by_bits(x, big, small);
    return small;
  } else {
    return round_tf32(x);
  }
}

// The bf16 halves of x0 and x1 that pass kPass takes for A, packed as
// bf16x3::round_pair() packs them (x0 in the low half).
template <int kPass>
__device__ __forceinline__ uint32_t a_pair(float x0, float x1) {
  if constexpr (kPass == kSmallA) {
    uint32_t hi, lo;
    bf16x3::split_pair(x0, x1, hi, lo);
    return lo;
  } else {
    return bf16x3::round_pair(x0, x1);
  }
}

// Loads of 8 samples (two depths of a thread, load_x() or load_step()) that
// one depth step of P takes: 1 under tf32x3, 2 under bf16x3.
template <class P>
constexpr int kLoads = P::kStep / 8;

// The A registers that load kh of a depth step gives pass kPass, from the
// float32 values f[2 h + r] at depth s0 + 4 h, fragment row g + 8 r: under
// tf32x3 all four (kh = 0), under bf16x3 registers 2 kh and 2 kh + 1, each
// packing the samples 8 kh + q and 8 kh + q + 4 of its row (mma_bf16x3.cuh).
template <class P, int kPass>
__device__ __forceinline__ void fill_a(uint32_t (&a)[4], const float (&f)[4], int kh) {
  if constexpr (P::kStep == 8) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = a_half<kPass>(f[r]);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) a[2 * kh + r] = a_pair<kPass>(f[r], f[2 + r]);
  }
}

// Offset, in 16-byte units, of the half of a split B operand that pass
// kPass takes: the small half lies kHalfFloats after the big one.
template <class P, int kPass>
__host__ __device__ constexpr uint64_t b_half() {
  return kPass == kSmallB ? Chunking<P>::kHalfFloats * 4 / 16 : 0;
}

// One pass of the general kernel's (C + 2) products over a chunk: acc[0] +=
// X^T WY, acc[1] += (X * X)^T W, acc[2 + k] += (X * C_k)^T W. acol: the
// thread's markers in the warpgroup's staged chunk; cs: the chunk's
// covariates [k][kChunk]. d_w and d_wy: descriptors of the big halves'
// depth step 0. kInFlight: depth steps whose products may still run while
// the next step's fragments are made. kPrefetch: each load's operands are
// loaded while the one before is made into fragments or multiplies (10
// registers at c = 3, where the kernel has none to spare: it loads them when
// it needs them). A bf16x3 step takes two loads of 8 samples.
template <class P, int C, int kInFlight, int kPass, bool kPrefetch>
__device__ __forceinline__ void general_pass(float (&acc)[C + 2][32], const float* acol,
                                             const float* cs, uint64_t d_w, uint64_t d_wy, int q,
                                             int keep) {
  using K = Chunking<P>;
  constexpr int kAcc = C + 2;
  constexpr int kL = kLoads<P>;
  StepOperands<C> now, next;
  if constexpr (kPrefetch) load_step<C>(now, acol, cs, K::kChunk, q);
#pragma unroll
  for (int ks = 0; ks < K::kSteps; ++ks) {
    uint32_t a[kAcc][4];
#pragma unroll
    for (int kh = 0; kh < kL; ++kh) {
      const int at = kL * ks + kh;  // the load's first depth, in steps of 8
      if constexpr (!kPrefetch) load_step<C>(now, acol, cs, K::kChunk, 8 * at + q);
      float f[kAcc][4];
      make_forms<C>(f, now);
#pragma unroll
      for (int s = 0; s < kAcc; ++s) fill_a<P, kPass>(a[s], f[s], kh);
      if (kPrefetch && at + 1 < kL * K::kSteps)
        load_step<C>(next, acol, cs, K::kChunk, 8 * (at + 1) + q);
      if constexpr (kPrefetch && kL > 1) {
        if (kh + 1 < kL) now = next;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kAcc; ++s)
      P::wgmma_m64n64(acc[s], a[s], (s == 0 ? d_wy : d_w) + ks * kStepUnits + b_half<P, kPass>(),
                      kPass == kSmallA && ks == 0 ? keep : 1);
    wgmma_commit();
    wgmma_wait<kInFlight>();
    if constexpr (kPrefetch) now = next;
  }
}

// acc += the general kernel's products over one chunk, three passes (acc =
// them with keep 0: keeps_sets()).
template <class P, int C, int kInFlight>
__device__ __forceinline__ void general_chunk(float (&acc)[C + 2][32], const float* acol,
                                              const float* cs, uint64_t d_w, uint64_t d_wy, int q,
                                              int keep) {
  constexpr bool kPrefetch = C < 3;
  general_pass<P, C, kInFlight, kSmallA, kPrefetch>(acc, acol, cs, d_w, d_wy, q, keep);
  general_pass<P, C, kInFlight, kSmallB, kPrefetch>(acc, acol, cs, d_w, d_wy, q, 1);
  general_pass<P, C, kInFlight, kLeading, kPrefetch>(acc, acol, cs, d_w, d_wy, q, 1);
  wgmma_wait<0>();
}

// One pass of the wide kernel's products over a chunk: z += X^T V_k and, on
// the first walk (kFirst), b += X^T WY and d1 += (X * X)^T W. Descriptors
// as for general_pass().
template <class P, bool kFirst, int kInFlight, int kPass>
__device__ __forceinline__ void wide_pass(float (&b)[32], float (&d1)[32], float (&z)[32],
                                          const float* acol, uint64_t d_w, uint64_t d_wy,
                                          uint64_t d_v, int q, int keep) {
  using K = Chunking<P>;
  constexpr int kL = kLoads<P>;
  // with no step in flight (the effects variant) the operands are loaded
  // when they are needed, for registers
  constexpr bool kPrefetch = kInFlight > 0;
  float now[4], next[4];
  if constexpr (kPrefetch) load_x(now, acol, q);
#pragma unroll
  for (int ks = 0; ks < K::kSteps; ++ks) {
    uint32_t x[4], xx[4];
#pragma unroll
    for (int kh = 0; kh < kL; ++kh) {
      const int at = kL * ks + kh;  // the load's first depth, in steps of 8
      if constexpr (!kPrefetch) load_x(now, acol, 8 * at + q);
      if constexpr (P::kStep == 8) {
        // x and X * X a value at a time, as before the policy came: the
        // 3 x TF32 machine code stays as it was (kernel_times.py --sass)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          x[r] = a_half<kPass>(now[r]);
          if constexpr (kFirst) xx[r] = a_half<kPass>(__fmul_rn(now[r], now[r]));
        }
      } else {
        fill_a<P, kPass>(x, now, kh);
        if constexpr (kFirst) {
          float sq[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sq[r] = __fmul_rn(now[r], now[r]);
          fill_a<P, kPass>(xx, sq, kh);
        }
      }
      if (kPrefetch && at + 1 < kL * K::kSteps) load_x(next, acol, 8 * (at + 1) + q);
      if constexpr (kPrefetch && kL > 1) {
        if (kh + 1 < kL) {
#pragma unroll
          for (int r = 0; r < 4; ++r) now[r] = next[r];
        }
      }
    }
    wgmma_fence();
    const uint64_t step = ks * kStepUnits + b_half<P, kPass>();
    const int sd = kPass == kSmallA && ks == 0 ? keep : 1;
    if constexpr (kFirst) {
      P::wgmma_m64n64(b, x, d_wy + step, sd);
      P::wgmma_m64n64(d1, xx, d_w + step, sd);
    }
    P::wgmma_m64n64(z, x, d_v + step, sd);
    wgmma_commit();
    wgmma_wait<kInFlight>();
    if constexpr (kPrefetch) {
#pragma unroll
      for (int r = 0; r < 4; ++r) now[r] = next[r];
    }
  }
}

// The wide kernel's products over one chunk, three passes, added to the
// sets (keep 1) or in their place (keep 0).
template <class P, bool kFirst, int kInFlight>
__device__ __forceinline__ void wide_chunk(float (&b)[32], float (&d1)[32], float (&z)[32],
                                           const float* acol, uint64_t d_w, uint64_t d_wy,
                                           uint64_t d_v, int q, int keep) {
  wide_pass<P, kFirst, kInFlight, kSmallA>(b, d1, z, acol, d_w, d_wy, d_v, q, keep);
  wide_pass<P, kFirst, kInFlight, kSmallB>(b, d1, z, acol, d_w, d_wy, d_v, q, 1);
  wide_pass<P, kFirst, kInFlight, kLeading>(b, d1, z, acol, d_w, d_wy, d_v, q, 1);
  wgmma_wait<0>();
}

// A warp's 16 rows of its warpgroup's finished tile (`mine`: the row of the
// warp's first marker, lane's two traits) into `out`, a whole row (256
// contiguous bytes) an instruction, as the resident kernel writes them.
__device__ __forceinline__ void write_rows(float* out, const float* mine, int row0, int m0, int p,
                                           int m, int pairs, int lane) {
  const int gm = m0 + 2 * lane;
  if (pairs && m % 2 == 0 && row0 + 16 <= p && m0 + kTileM <= m) {
    float* to = out + (size_t)row0 * m + gm;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      __stcs(reinterpret_cast<float2*>(to + (size_t)r * m),
             *reinterpret_cast<const float2*>(mine + r * kLdOut));
  } else {
    for (int r = 0; r < 16 && row0 + r < p; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(mine + r * kLdOut);
      const size_t at = (size_t)(row0 + r) * m + gm;
      if (pairs && gm + 1 < m && at % 2 == 0) {
        __stcs(reinterpret_cast<float2*>(out + at), v);
      } else {
        if (gm < m) __stcs(out + at, v.x);
        if (gm + 1 < m) __stcs(out + at + 1, v.y);
      }
    }
  }
}

// What the epilogue takes for one output: num and d residualized (d
// floored), the keep test, the trait's inv_nrm2 and (the effects variant's)
// nrm2.
struct Residual {
  float num, d;
  bool keep;
  float inv_nrm2, nrm2;
};

// A warpgroup's finished tile, both kernels: element(j, h, e) gives the
// Residual of the thread's output at marker wrow + 2 g + h, trait
// 8 j + 2 q + e of the tile (accumulator element 4 j + 2 h + e). The LOD
// leaves through the warp's rows of the finished tile (my_finished), the
// effects variant's effect and standard error straight from the
// accumulator layout. `mine`: the tile holds markers.
template <bool kEffects, class Element>
__device__ __forceinline__ void finish_tile(Element element, float* out, float* beta_out,
                                            float* se_out, float* my_finished, int tile, int wrow,
                                            int m0, int p, int m, int pairs, bool mine,
                                            float neg_half_n, float inv_dof, int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < kTileM / 8; ++j) {
    // a compiler barrier keeps each column tile's work together
    asm volatile("" ::: "memory");
    const int lm = 8 * j + 2 * q;
    float lod[2][2], beta[2][2], se[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const Residual r = element(j, h, e);
        lod[h][e] = lod_rn(r.num, r.d, r.keep, r.inv_nrm2, neg_half_n);
        if constexpr (kEffects) {
          const Effect f = effect_rn(r.num, r.d, r.keep, r.inv_nrm2, r.nrm2, inv_dof);
          beta[h][e] = f.beta;
          se[h][e] = f.se;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(my_finished + (2 * g + h) * kLdOut + lm) =
          make_float2(lod[h][0], lod[h][1]);
    if constexpr (kEffects) {
      if (mine) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gp = tile * kTileP + wrow + 2 * g + h;
          store_pair(beta_out, gp, m0 + lm, beta[h], p, m, pairs);
          store_pair(se_out, gp, m0 + lm, se[h], p, m, pairs);
        }
      }
    }
  }
  __syncwarp();  // the warp's 16 rows are complete
  if (mine) write_rows(out, my_finished + 2 * lane, tile * kTileP + wrow, m0, p, m, pairs, lane);
}

// The launch geometry: the grid (trait tiles x marker groups) and the tiles
// of a group, an even count, as many groups as give about kWaves blocks an
// SM.
struct Geometry {
  dim3 grid;
  int group_tiles;
};

inline cudaError_t geometry(const Operands& o, Geometry& geo) {
  int device = 0, sms = 0;
  cudaError_t rc;
  if ((rc = cudaGetDevice(&device)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return rc;
  const int mtiles = (o.m + kTileM - 1) / kTileM;
  const int ntiles = (o.p + kTileP - 1) / kTileP;
  long long groups = ((long long)kWaves * sms + mtiles - 1) / mtiles;
  if (groups > (ntiles + 1) / 2) groups = (ntiles + 1) / 2;
  if (groups > 65535) groups = 65535;
  int group_tiles = (int)((ntiles + groups - 1) / groups);
  group_tiles += group_tiles % 2;
  geo.grid = dim3((unsigned)mtiles, (unsigned)((ntiles + group_tiles - 1) / group_tiles));
  geo.group_tiles = group_tiles;
  return cudaSuccess;
}

// The running totals' device memory that a launch is handed: `at` (null for
// none), `floats` long. With `need` set the launcher launches nothing and
// writes there the floats the launch would need (0 when its walks do not
// fold).
struct Totals {
  float* at;
  long long floats;
  long long* need;
};

// The slots of the running totals of a launch of `kernel` (its dynamic
// shared memory limit set to `bytes`) with `sets` product sets a
// warpgroup: one for each block the device holds at once, 0 when its walks
// do not fold (`fold`: folds()). Checks the memory in t, or writes its size
// to t.need.
template <class Kernel>
cudaError_t total_slots(Kernel kernel, size_t bytes, bool fold, int sets, const Totals& t,
                        int& slots) {
  slots = 0;
  if (!fold) {
    if (t.need) *t.need = 0;
    return cudaSuccess;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc;
  if ((rc = cudaGetDevice(&device)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return rc;
  if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes)) !=
      cudaSuccess)
    return rc;
  slots = std::max(per_sm, 1) * sms;
  const long long floats = total_floats(slots, sets);
  if (t.need) *t.need = floats;
  else if (t.at == nullptr || t.floats < floats) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The widest copy that every row of every trait operand allows.
inline int trait_copy_width(const float* W, const float* WY, int m) {
  return std::min(copy_width(W, m), copy_width(WY, m));
}

}  // namespace chunked
}  // namespace liteqtl
