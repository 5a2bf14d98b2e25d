// The resident LOD kernel (liteqtl_resident_kernel: n <= 88, c <= 3), for
// the function that liteqtl_fused.cu states. A block owns 64 traits and
// walks a group of marker tiles, 64 markers each.
//
// - The traits' operands, resident. The block reads its 64 columns of W and
//   WY once, splits them into their TF32 halves and keeps the four tiles in
//   shared memory for the whole launch, K-major, as wgmma's B operand (80 KB
//   at n = 79); the scalar block and the covariates lie beside them. W and
//   WY leave device memory once a marker group.
// - Two warpgroups, each on its own. Warpgroup w takes the block's marker
//   tiles w, w + 2, ... with its own ring of two stages, and shares only the
//   read-only operands with the other. Inside a warpgroup a warp copies the
//   16 markers that it multiplies and writes out the 16 rows that it
//   computed, so after the block's one barrier the warps meet at their
//   products alone. The second warpgroup starts one tile's products behind
//   the first, so that one's epilogue (CUDA cores) runs while the other's
//   products hold the tensor cores.
// - The markers. A tile of X arrives by 16-byte cp.async (the wrapper hands
//   X over with 16-byte aligned rows), the next tile in flight while this
//   one multiplies; samples past n and markers past p arrive as zeros.
// - X is the A operand, from registers, and its three forms are made there:
//   one fragment load gives X, X * X and X * C_k, each rounded to float32 as
//   the plain version rounds it and then split. No X^2 or X C array exists
//   anywhere. Every form has its own m64n64 accumulator set, 32 registers a
//   thread, (c + 2) sets at once: that is what limits c.
// - Two passes over the depth: the small terms of every depth step first,
//   then the leading terms (X is loaded and rounded again for them). The
//   tensor cores finish every product's float32 sum by cutting it toward
//   zero, each addend cut 2 bits below the last place of the largest term
//   (csrc/accumulate_probe.cu), so a leading term added into the set at the
//   result's full magnitude loses up to a unit there, always toward zero.
//   Under tf32x3 the leading terms therefore go form by form and a depth
//   step at a time into one scratch set of 32 registers that the step's
//   product overwrites (scale-d 0); the scratch set is then added into the
//   form's set with __fadd_rn. A second set per form does not fit beside
//   (c + 2) sets; the cost is a wait a step and form (1.24x the launch at
//   BXD scale; runs of two steps spilled at c = 3, PERF.md). The small
//   terms are 2^-11 of the result and stay in the sets.
// - The epilogue works on the accumulator layout: a thread holds two
//   neighbouring traits of two neighbouring markers in each of 8 column
//   tiles and reads the traits' scalars from shared memory. It takes
//   reciprocals and the special-function unit's log2 where the general
//   kernel divides and calls log10f (lod_from_products()). The finished tile
//   leaves through shared memory, a whole 256-byte row an instruction; pairs
//   of floats where the rows of `out` are 8-byte aligned, scalars where they
//   are not (odd m).
// - The grid is (trait tiles x marker groups): the markers are cut into
//   groups only as far as is needed for about 16 waves of blocks, so that
//   the last, partly empty wave costs little.
//
// - The effects variant (kEffects) writes the marker's effect and its
//   standard error beside the LOD, from the same products and in the same
//   pass: the LOD leaves through the finished tile as above, the effect and
//   its standard error straight from the accumulator layout, a pair of
//   traits a store, one column tile at a time, and with c = 2 no depth step
//   in flight (as c = 3). Three passes through the one finished tile kept
//   every accumulator live until the last pass, which cost 61 registers at
//   c = 1 and spilled at c = 3; a finished tile each would not fit the
//   shared memory at n = 88. The variant needs one more row of the scalar
//   block (nrm2) and no more shared memory otherwise.
//
// - The products' policy is the kernel's first template parameter: three
//   TF32 passes (tf32x3::Policy, wgmma m64n64k8, depth steps of 8) for every
//   preset but THROUGHPUT, three bf16 passes (bf16x3::Policy, m64n64k16,
//   depth steps of 16) for THROUGHPUT's "high" products, the JAX package's
//   HIGH. Under bf16x3 the four operand tiles hold bf16 halves in the slot
//   order of mma_bf16x3.cuh (half the shared memory: 40 KB at n = 79, and
//   n = 88 pads to 96), a thread's A fragment of a step packs its samples q,
//   q + 4, q + 8 and q + 12 (two steps of the TF32 loads), and the rest,
//   the two passes over the depth and the epilogue, is the same, but for
//   the runs: under bf16x3 the leading terms go into the sets.
//
// The kernel is built for every (policy, covariate columns, depth steps)
// triple it takes; each count of covariate columns is its own source file
// for each policy (liteqtl_resident_c<c>.cu and, for the effects variant,
// liteqtl_resident_e<c>.cu; liteqtl_resident_bf16_c<c>.cu and _e<c>.cu),
// so that the files compile side by side. This header also holds
// what the general kernel shares with it: tile sizes, the scalar block's
// layout and the epilogue.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include "mma_bf16x3.cuh"

namespace liteqtl {

using namespace tf32x3;

constexpr int kTileP = 64;    // markers per tile
constexpr int kTileM = 64;    // traits per block
constexpr int kThreads = 256;

// Row of L[(i, k)], i >= k, in the column-major packed lower triangle.
__host__ __device__ constexpr int tri_row(int c, int i, int k) {
  return k * c - (k * (k - 1)) / 2 + (i - k);
}

// Rows of the scalar block: L entries | zeta | inv_nrm2, and nrm2 for the
// effects variant.
__host__ __device__ constexpr int scalar_rows(int c, bool effects = false) {
  return c * (c + 1) / 2 + c + 1 + (effects ? 1 : 0);
}

// 1 / x within one unit of the last place, for a normal x; a subnormal x
// counts as zero, and +-0 gives +-inf. The form that takes subnormals costs
// six more instructions an output for a case in which D1, the weighted sum
// of a marker's squares, is below 1e-34. volatile: the compiler must not
// sink it into a branch on the caller's mask (it did, and a branch an output
// kept it from interleaving the outputs' chains: the epilogue took three
// times as long).
__device__ __forceinline__ float reciprocal(float x) {
  float r;
  asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// log2(x) for a normal x > 0 by the special-function unit: absolute error
// 2^-22 for x in (0.5, 2), relative error 2^-22 elsewhere.
__device__ __forceinline__ float log2_normal(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// sqrt(x) by the special-function unit, for the effects variant's standard
// error: a few units of the last place; a subnormal x counts as zero.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The forward substitution of one (marker, trait) pair: num = B and d = D1
// residualized on the trait's covariate basis (u = U_0 .. U_{C-1}; scal(row)
// is the trait's entry of the scalar block), then the keep test (returned)
// and the floor of d. kReciprocals: the diagonal rows of the scalar block
// hold 1 / L[(k, k)].
template <int C, bool kReciprocals, class Scal>
__device__ __forceinline__ bool residualize(float& num, float& d, float d1, const float (&u)[C],
                                            Scal scal) {
  constexpr int kTri = C * (C + 1) / 2;
  float z[C];
  d = d1;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    float t = u[k];
#pragma unroll
    for (int q = 0; q < k; ++q) t -= scal(tri_row(C, k, q)) * z[q];
    z[k] = kReciprocals ? t * scal(tri_row(C, k, k)) : t / scal(tri_row(C, k, k));
    num -= z[k] * scal(kTri + k);
    d -= z[k] * z[k];
  }
  const float eps = FLT_EPSILON;
  const bool keep = d > 1024.0f * eps * d1;
  d = fmaxf(d, 4.0f * eps * d1);
  return keep;
}

// The LOD of one (marker, trait) pair from its products: num = B, d1 = D1,
// u = U_0 .. U_{C-1}; scal(row) is the trait's entry of the scalar block.
// kReciprocals = false: IEEE divisions and log10f, as the plain version
// takes them. kReciprocals = true: the diagonal rows of the scalar block
// hold 1 / L[(k, k)], D is inverted by reciprocal() and the logarithm is
// log2_normal() of an argument clamped to [FLT_MIN, 1] (its absolute error
// of 2^-22 is 3e-6 in the LOD at n = 88); none has a slow path, and together
// they take about a quarter of the exact form's dispatch time (the divisions'
// slow-path calls keep the compiler from interleaving the outputs' chains).
template <int C, bool kReciprocals, class Scal>
__device__ __forceinline__ float lod_from_products(float num, float d1, const float (&u)[C],
                                                   Scal scal, float neg_half_n) {
  constexpr int kTri = C * (C + 1) / 2;
  float d;
  const bool keep = residualize<C, kReciprocals>(num, d, d1, u, scal);
  if constexpr (kReciprocals) {
    const float inv_d = reciprocal(d);
    const float r2 = keep ? num * num * scal(kTri + C) * inv_d : 0.0f;
    // 0.301029996 = log10(2)
    return (neg_half_n * 0.301029996f) * log2_normal(fmaxf(1.0f - r2, FLT_MIN));
  } else {
    const float r2 = keep ? num * num * scal(kTri + C) / d : 0.0f;
    return neg_half_n * log10f(fmaxf(1.0f - r2, FLT_MIN));
  }
}

struct Effect {
  float beta, se;
};

// The marker's effect and its standard error, from the same products and the
// same residualization as the LOD, the way ops/liteqtl.py::_effects_from_nd
// takes them: N masked by both keep tests (the trait's is inv_nrm2 > 0), D at
// least FLT_MIN,
//     beta = N / D,   SE = sqrt(max(nrm2 - N^2 / D, 0) / dof / D),
// dof = max(n - c - 1, 1). kReciprocals = false: IEEE divisions and sqrtf
// (the plain version's order). kReciprocals = true: D and dof inverted by
// reciprocal() (inv_dof is 1 / dof) and sqrt_approx().
template <int C, bool kReciprocals, class Scal>
__device__ __forceinline__ Effect effect_from_products(float num, float d1, const float (&u)[C],
                                                       Scal scal, float dof, float inv_dof) {
  constexpr int kTri = C * (C + 1) / 2;
  float d;
  const bool keep = residualize<C, kReciprocals>(num, d, d1, u, scal) && scal(kTri + C) > 0.0f;
  const float nk = keep ? num : 0.0f;
  d = fmaxf(d, FLT_MIN);
  const float nrm2 = scal(kTri + C + 1);
  if constexpr (kReciprocals) {
    const float inv_d = reciprocal(d);
    const float rss = fmaxf(nrm2 - __fmul_rn(nk, nk) * inv_d, 0.0f);
    return {nk * inv_d, sqrt_approx(rss * inv_dof * inv_d)};
  } else {
    const float rss = fmaxf(nrm2 - __fmul_rn(nk, nk) / d, 0.0f);
    return {nk / d, sqrtf(rss / dof / d)};
  }
}

// --- the resident kernel: warpgroup products on operands kept in shared memory ---

constexpr int kGroups = 2;          // warpgroups a block, each on its own marker tiles
constexpr int kStages = 2;
constexpr int kLdX = padded_stride(kTileP);
constexpr int kLdOut = kTileM + 4;  // row stride of a finished tile in shared memory
constexpr int kResidentC = 3;       // most covariate columns: (c + 2) accumulator sets of 32 registers
constexpr int kResidentSteps = 11;  // most depth steps of 8
constexpr int kSharedLimit = 232448;  // bytes of shared memory a block can use
constexpr int kWaves = 16;          // blocks an SM that the marker groups aim at

// Depth steps of the policy the kernel is built for: under tf32x3 steps of
// 8, even counts up to 10, then 11; under bf16x3 steps of 16, every count
// from 2 to 6 (one step at c = 3 with effects spilled 40 bytes, and a
// launch of 16 samples or fewer loses nothing by a second step of zeros).
// The samples between n and the steps are zeros in shared memory.
template <class P = tf32x3::Policy>
__host__ __device__ constexpr int built_steps(int n) {
  const int steps = (n + P::kStep - 1) / P::kStep;
  if (P::kStep == 16) return steps < 2 ? 2 : steps;
  return steps > 10 ? steps : steps + steps % 2;
}

// Floats of shared memory: four K-major operand tiles (a float a value under
// tf32x3, half of one under bf16x3), two stages of X and one finished tile a
// warpgroup, the covariates, the scalar block.
template <class P = tf32x3::Policy>
__host__ __device__ constexpr size_t resident_shared_floats(int steps, int c, bool effects) {
  const size_t depth = P::kStep * (size_t)steps;
  return 4 * depth * kTileM / (P::kStep / 8) +
         (size_t)kGroups * (kStages * depth * kLdX + kTileP * kLdOut) + c * depth +
         (size_t)scalar_rows(c, effects) * kTileM;
}

inline bool is_resident(int n, int c, bool effects) {
  return c >= 1 && c <= kResidentC && built_steps(n) <= kResidentSteps &&
         4 * resident_shared_floats(built_steps(n), c, effects) <= (size_t)kSharedLimit;
}

// One depth step's raw operands of a thread: its two markers (fragment rows
// g and g + 8 are neighbours in the staged tile and load as one word) at its
// kDepths depths s0, s0 + 4, .. (two a TF32 step, four a bf16 step), and the
// covariates at those depths. acol points at the thread's markers of the
// staged tile, cs at the covariates [k][depth].
template <int C, int kDepths = 2>
struct StepOperands {
  float x[2 * kDepths];  // x[2 h + r]: depth s0 + 4 h, fragment row g + 8 r
  float c[C][kDepths];   // c[k][h]
};

template <int C, int kDepths>
__device__ __forceinline__ void load_step(StepOperands<C, kDepths>& o, const float* acol,
                                          const float* cs, int depth, int s0) {
#pragma unroll
  for (int h = 0; h < kDepths; ++h) {
    const int s = s0 + 4 * h;
    float v[2];
    load_vec<2>(acol + s * kLdX, v);
    o.x[2 * h] = v[0], o.x[2 * h + 1] = v[1];
#pragma unroll
    for (int k = 0; k < C; ++k) o.c[k][h] = cs[k * depth + s];
  }
}

// The forms of one depth step's A fragment, float32: f[0] = X, f[1] = X * X,
// f[2 + k] = X * C_k, each product rounded on its own.
template <int C, int kDepths>
__device__ __forceinline__ void make_forms(float (&f)[C + 2][2 * kDepths],
                                           const StepOperands<C, kDepths>& o) {
#pragma unroll
  for (int i = 0; i < 2 * kDepths; ++i) {
    f[0][i] = o.x[i];
    f[1][i] = __fmul_rn(o.x[i], o.x[i]);
#pragma unroll
    for (int k = 0; k < C; ++k) f[2 + k][i] = __fmul_rn(o.x[i], o.c[k][i / 2]);
  }
}

// v[0], v[1] into dst[row, col], dst[row, col + 1] of a (p, m) output, as one
// 8-byte store where both lie inside and the address allows; pairs = 1 where
// the output's base is 8-byte aligned.
__device__ __forceinline__ void store_pair(float* dst, int row, int col, const float (&v)[2],
                                           int p, int m, int pairs) {
  if (row >= p) return;
  const size_t at = (size_t)row * m + col;
  if (pairs && col + 1 < m && at % 2 == 0) {
    __stcs(reinterpret_cast<float2*>(dst + at), make_float2(v[0], v[1]));
  } else {
    if (col < m) __stcs(dst + at, v[0]);
    if (col + 1 < m) __stcs(dst + at + 1, v[1]);
  }
}

// Whether the resident kernel built for a policy's depth step (`step`: 8
// tf32x3, 16 bf16x3), c covariate columns, `steps` depth steps and the
// effects variant takes its leading terms a depth step at a time into a
// scratch set, each step added into its set rounded to nearest (tf32x3),
// rather than straight into its sets (bf16x3); at c = 3 with the effects
// variant and 2 depth steps (n <= 16) the scratch set spilled 36 bytes, and
// that instantiation adds the leading terms into its sets too. The CPU twin
// (kernels/liteqtl_fused.py::lead_runs) is held against it through
// bulklmm_liteqtl_lead_runs().
__host__ __device__ constexpr bool lead_runs(int step, int c, int steps, bool effects) {
  return step == 8 && !(effects && c == 3 && steps <= 2);
}

// kSteps: depth steps of the policy P, n padded; a template parameter so
// that the depth loops carry no branches. kInFlight: the depth steps whose
// products may still run while the next step's fragments are made (each step
// in flight holds its fragments' registers).
template <class P, int C, int kSteps, int kInFlight, bool kEffects>
__global__ void __launch_bounds__(kThreads, 1)
liteqtl_resident_kernel(const float* __restrict__ X,     // (n, ldx) rotated markers
                        const float* __restrict__ Cov,   // (n, C) rotated covariates
                        const float* __restrict__ W,     // (n, m) per-trait weights
                        const float* __restrict__ WY,    // (n, m) weighted traits
                        const float* __restrict__ scal,  // (S, m) per-trait scalars
                        float* __restrict__ out,         // (p, m) LOD
                        float* __restrict__ beta_out,    // (p, m) effect (kEffects)
                        float* __restrict__ se_out,      // (p, m) its standard error (kEffects)
                        int n, int p, int ldx, int m,
                        int group_tiles,  // marker tiles of one block
                        int pairs) {      // 1: every output is 8-byte aligned
  constexpr bool kBf16 = P::kStep == 16;
  constexpr int kDepths = P::kStep / 4;  // a thread's depths of a step
  constexpr int depth = P::kStep * kSteps;
  constexpr int kS = scalar_rows(C, kEffects);
  constexpr bool kLeadRuns = lead_runs(P::kStep, C, kSteps, kEffects);
  constexpr int kAcc = C + 2;  // B, D1, U_0 .. U_{C-1}
  constexpr int kTileFloats = depth * kTileM / (kBf16 ? 2 : 1);  // 32-bit words
  constexpr int kStageFloats = depth * kLdX;
  extern __shared__ __align__(128) float4 resident_shared_raw[];
  float* shared = reinterpret_cast<float*>(resident_shared_raw);
  float* w_big = shared;  // K-major, kTileM columns, `depth` deep
  float* w_small = w_big + kTileFloats;
  float* wy_big = w_small + kTileFloats;
  float* wy_small = wy_big + kTileFloats;
  float* stages = wy_small + kTileFloats;
  float* finished = stages + kGroups * kStages * kStageFloats;  // [kGroups][kTileP][kLdOut]
  float* cs = finished + kGroups * kTileP * kLdOut;       // [C][depth]
  float* ss = cs + C * depth;                             // [kS][kTileM]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int group = warp / 4;        // the warpgroup
  const int wrow = 16 * (warp % 4);  // the warp's first marker of a tile
  const int m0 = blockIdx.x * kTileM;
  const int ntiles = (p + kTileP - 1) / kTileP;
  const int first = blockIdx.y * group_tiles;
  const int last = min(first + group_tiles, ntiles);

  // A warp copies the 16 markers of a tile that it multiplies itself and
  // writes the 16 rows of the finished tile that it computed itself, so
  // inside the tile loop a warp waits for no other: the warpgroup meets at
  // its products alone.
  float* my_stages = stages + group * kStages * kStageFloats + wrow;
  float* my_finished = finished + (group * kTileP + wrow) * kLdOut;
  auto start_copies = [&](int tile, int slot) {
    stage_tile_vec<16, 4>(my_stages + slot * kStageFloats, kLdX, X, n, ldx, 0,
                          tile * kTileP + wrow, depth, lane, 32);
    cp_async_commit();
  };

  int tile = first + group;
  if (tile < last) start_copies(tile, 0);

  // the block's operands, read once: scalars, covariates, and the W and WY
  // columns split and laid out K-major. With 64 columns kmajor_offset(s, c)
  // is 256 (s / 4) + 4 c + s % 4, so thread (c = tid / 4, s % 4 = tid % 4)
  // writes consecutive words; under bf16x3 s is a word depth, whose word
  // holds samples sample_of_word(s) and that + 4.
  for (int e = tid; e < kS * kTileM; e += kThreads) {
    const int row = e / kTileM, gm = m0 + e % kTileM;
    // columns past m get ones: no division by zero in lanes never stored
    float v = gm < m ? scal[(size_t)row * m + gm] : 1.0f;
    // the factor's diagonal as reciprocals (IEEE, once a trait and block)
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (row == tri_row(C, k, k)) v = 1.0f / v;
    ss[e] = v;
  }
  for (int e = tid; e < C * depth; e += kThreads) {
    const int k = e / depth, s = e % depth;
    cs[e] = s < n ? Cov[(size_t)s * C + k] : 0.0f;
  }
  for (int e = tid; e < kTileFloats; e += kThreads) {
    const int s = 4 * (e / (4 * kTileM)) + e % 4, c = (e / 4) % kTileM;
    uint32_t big, small;
    if constexpr (kBf16) {
      const int s0 = bf16x3::sample_of_word(s);
      const bool col = m0 + c < m;
      const size_t at = (size_t)s0 * m + m0 + c, next = at + 4 * (size_t)m;
      const bool in0 = col && s0 < n, in1 = col && s0 + 4 < n;
      bf16x3::split_pair(in0 ? W[at] : 0.0f, in1 ? W[next] : 0.0f, big, small);
      w_big[e] = __uint_as_float(big);
      w_small[e] = __uint_as_float(small);
      bf16x3::split_pair(in0 ? WY[at] : 0.0f, in1 ? WY[next] : 0.0f, big, small);
      wy_big[e] = __uint_as_float(big);
      wy_small[e] = __uint_as_float(small);
    } else {
      const bool inside = s < n && m0 + c < m;
      const float w = inside ? W[(size_t)s * m + m0 + c] : 0.0f;
      const float wy = inside ? WY[(size_t)s * m + m0 + c] : 0.0f;
      split(w, big, small);
      w_big[e] = __uint_as_float(big);
      w_small[e] = __uint_as_float(small);
      split(wy, big, small);
      wy_big[e] = __uint_as_float(big);
      wy_small[e] = __uint_as_float(small);
    }
  }
  fence_proxy_async();
  __syncthreads();  // the last barrier of the whole block

  // descriptors of depth step 0; step ks lies 32 bytes a column, 8 kTileM
  // words = 128 units of 16 bytes, on (either policy)
  const uint64_t d_w_big = kmajor_descriptor(w_big, kTileM);
  const uint64_t d_w_small = kmajor_descriptor(w_small, kTileM);
  const uint64_t d_wy_big = kmajor_descriptor(wy_big, kTileM);
  const uint64_t d_wy_small = kmajor_descriptor(wy_small, kTileM);
  constexpr uint64_t kStepUnits = 8 * kTileM * 4 / 16;

  float acc[kAcc][32];
#pragma unroll
  for (int a = 0; a < kAcc; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;

  // The second warpgroup starts when the first has finished its first
  // tile's products. Both take the same time a tile, so the distance stays:
  // one multiplies while the other is in its epilogue. Started together they
  // would stay together, share the tensor cores and then the dispatch slots,
  // and overlap nothing.
  const bool staggered = last - first >= kGroups;
  if (staggered && group == 1) asm volatile("bar.sync 3, %0;" :: "n"(kThreads) : "memory");

  const float neg_half_n = -0.5f * (float)n;
  const float dof = (float)max(n - C - 1, 1);  // the effects variant's
  const float inv_dof = 1.0f / dof;
  for (int slot = 0; tile < last; tile += kGroups, slot ^= 1) {
    cp_async_wait<0>();
    __syncwarp();  // the warp's part of this tile has landed; its other stage is free
    if (tile + kGroups < last) start_copies(tile + kGroups, slot ^ 1);

    // The warp's A fragments: fragment row r is marker wrow + 2 (r % 8) + r / 8.
    const float* acol = my_stages + slot * kStageFloats + 2 * g;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) pin_registers(acc[a]);

    // Each step's operands are loaded one step ahead, before the products of
    // the step before are started: the asynchronous products are ordered
    // against memory, so the compiler moves no load across them itself.
    StepOperands<C, kDepths> now, next;
    load_step<C>(now, acol, cs, depth, q);

    // the small terms of every depth step
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      float f[kAcc][2 * kDepths];
      make_forms<C>(f, now);
      uint32_t big[kAcc][4], small[kAcc][4];
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        if constexpr (kBf16) {
          bf16x3::split_fragment(f[a], big[a], small[a]);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) split_by_bits(f[a][r], big[a][r], small[a][r]);
        }
      }
      // the second pass starts again at step 0
      load_step<C>(next, acol, cs, depth, P::kStep * ((ks + 1) % kSteps) + q);
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        // the tile's first product overwrites acc
        P::wgmma_m64n64(acc[a], small[a], (a == 0 ? d_wy_big : d_w_big) + ks * kStepUnits, ks > 0);
        P::wgmma_m64n64(acc[a], big[a], (a == 0 ? d_wy_small : d_w_small) + ks * kStepUnits, 1);
      }
      wgmma_commit();
      wgmma_wait<kInFlight>();
      now = next;
    }
    if constexpr (!kLeadRuns) {
      // the leading terms
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        float f[kAcc][2 * kDepths];
        make_forms<C>(f, now);
        uint32_t big[kAcc][4];
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          if constexpr (kBf16) {
            bf16x3::round_fragment(f[a], big[a]);
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) big[a][r] = round_tf32(f[a][r]);
          }
        }
        if (ks + 1 < kSteps) load_step<C>(next, acol, cs, depth, P::kStep * (ks + 1) + q);
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
          P::wgmma_m64n64(acc[a], big[a], (a == 0 ? d_wy_big : d_w_big) + ks * kStepUnits, 1);
        wgmma_commit();
        wgmma_wait<kInFlight>();
        now = next;
      }
    } else {
      // the leading terms, form by form and a depth step at a time: a
      // step's product goes into one scratch set that it overwrites
      // (scale-d 0), and the step is added into the form's set rounded to
      // nearest once it is done
      wgmma_wait<0>();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          StepOperands<C, kDepths> o;
          load_step<C>(o, acol, cs, depth, P::kStep * ks + q);
          float f[kAcc][2 * kDepths];
          make_forms<C>(f, o);
          uint32_t big[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) big[i] = round_tf32(f[a][i]);
          float run[32];
          wgmma_fence();
          P::wgmma_m64n64(run, big, (a == 0 ? d_wy_big : d_w_big) + ks * kStepUnits, 0);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[a][i] = __fadd_rn(acc[a][i], run[i]);
        }
      }
    }
    wgmma_wait<0>();
    if (staggered && group == 0 && tile == first)
      asm volatile("bar.arrive 3, %0;" :: "n"(kThreads) : "memory");
#pragma unroll
    for (int a = 0; a < kAcc; ++a) pin_registers(acc[a]);

    // the thread's outputs: markers wrow + 2 g + h, traits 8 j + 2 q + e of the tile
#pragma unroll
    for (int j = 0; j < kTileM / 8; ++j) {
      // the effects variant holds three outputs a pair: a compiler barrier
      // keeps each column tile's work together (interleaved across tiles it
      // spilled at c = 2)
      if constexpr (kEffects) asm volatile("" ::: "memory");
      const int lm = 8 * j + 2 * q;
      float sv[kS][2];
#pragma unroll
      for (int row = 0; row < kS; ++row) load_vec<2>(ss + row * kTileM + lm, sv[row]);
      float lod[2][2], beta[2][2], se[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float u[C];
#pragma unroll
          for (int k = 0; k < C; ++k) u[k] = acc[2 + k][i];
          auto scal_of = [&](int row) { return sv[row][e]; };
          lod[h][e] = lod_from_products<C, true>(acc[0][i], acc[1][i], u, scal_of, neg_half_n);
          if constexpr (kEffects) {
            const Effect f =
                effect_from_products<C, true>(acc[0][i], acc[1][i], u, scal_of, dof, inv_dof);
            beta[h][e] = f.beta;
            se[h][e] = f.se;
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(my_finished + (2 * g + h) * kLdOut + lm) =
            make_float2(lod[h][0], lod[h][1]);
      if constexpr (kEffects) {
        // straight from the accumulator layout, a pair of traits a store
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gp = tile * kTileP + wrow + 2 * g + h;
          store_pair(beta_out, gp, m0 + lm, beta[h], p, m, pairs);
          store_pair(se_out, gp, m0 + lm, se[h], p, m, pairs);
        }
      }
    }

    // The tile leaves through shared memory, a warp its 16 rows and a whole row
    // (256 contiguous bytes) an instruction: a row of `out` starts at any
    // multiple of 4 or 8 bytes, and stores of 32 bytes a quad straight from
    // the accumulator layout then touch two sectors each, which took over
    // twice the time of the whole write.
    __syncwarp();  // the warp's 16 rows are complete
    const int gm = m0 + 2 * lane;
    const int row0 = tile * kTileP + wrow;
    const float* mine = my_finished + 2 * lane;
    if (pairs && m % 2 == 0 && row0 + 16 <= p && m0 + kTileM <= m) {
      // an inner tile: no edge, every row 8-byte aligned
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
}

struct Operands {
  const float *X, *Cov, *W, *WY, *scal;
  float* out;
  float *beta, *se;  // the effects variant's outputs; null for the LOD alone
  int n, p, ldx, m;
};

inline bool aligned8(const float* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 8 == 0; }

template <class P, int C, int kSteps, bool kEffects>
cudaError_t launch_resident_built(const Operands& o, cudaStream_t stream) {
  // one depth step in flight beside the one being made, while its fragments' registers fit
  auto kernel = liteqtl_resident_kernel<P, C, kSteps, (C <= (kEffects ? 1 : 2) ? 1 : 0), kEffects>;
  const size_t bytes = 4 * resident_shared_floats<P>(kSteps, C, kEffects);
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  int device = 0, sms = 0;
  if ((rc = cudaGetDevice(&device)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return rc;
  // marker groups: as many as give about kWaves blocks an SM, an even count
  // of tiles each (one warpgroup takes the even tiles, the other the odd)
  const int mtiles = (o.m + kTileM - 1) / kTileM;
  const int ntiles = (o.p + kTileP - 1) / kTileP;
  long long groups = ((long long)kWaves * sms + mtiles - 1) / mtiles;
  if (groups > (ntiles + 1) / 2) groups = (ntiles + 1) / 2;
  if (groups > 65535) groups = 65535;
  int group_tiles = (int)((ntiles + groups - 1) / groups);
  group_tiles += group_tiles % 2;
  const dim3 grid((unsigned)mtiles, (unsigned)((ntiles + group_tiles - 1) / group_tiles));
  const int pairs = aligned8(o.out) && (!kEffects || (aligned8(o.beta) && aligned8(o.se)));
  kernel<<<grid, kThreads, bytes, stream>>>(o.X, o.Cov, o.W, o.WY, o.scal, o.out, o.beta, o.se,
                                            o.n, o.p, o.ldx, o.m, group_tiles, pairs);
  return cudaGetLastError();
}

template <class P, int C, bool kEffects>
cudaError_t launch_resident(const Operands& o, cudaStream_t stream) {
  if (o.ldx % 4 != 0 || reinterpret_cast<uintptr_t>(o.X) % 16 != 0) return cudaErrorInvalidValue;
  if constexpr (P::kStep == 16) {
    switch (built_steps<P>(o.n)) {
      case 2: return launch_resident_built<P, C, 2, kEffects>(o, stream);
      case 3: return launch_resident_built<P, C, 3, kEffects>(o, stream);
      case 4: return launch_resident_built<P, C, 4, kEffects>(o, stream);
      case 5: return launch_resident_built<P, C, 5, kEffects>(o, stream);
      case 6: return launch_resident_built<P, C, 6, kEffects>(o, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (built_steps<P>(o.n)) {
      case 2: return launch_resident_built<P, C, 2, kEffects>(o, stream);
      case 4: return launch_resident_built<P, C, 4, kEffects>(o, stream);
      case 6: return launch_resident_built<P, C, 6, kEffects>(o, stream);
      case 8: return launch_resident_built<P, C, 8, kEffects>(o, stream);
      case 10: return launch_resident_built<P, C, 10, kEffects>(o, stream);
      case 11: return launch_resident_built<P, C, 11, kEffects>(o, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

// launch_resident<P, c, false> and launch_resident<P, c, true>, each defined
// in its own source file: tf32x3::Policy, then bf16x3::Policy.
cudaError_t launch_resident_c1(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_c2(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_c3(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_effects_c1(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_effects_c2(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_effects_c3(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_bf16_c1(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_bf16_c2(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_bf16_c3(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_bf16_effects_c1(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_bf16_effects_c2(const Operands& o, cudaStream_t stream);
cudaError_t launch_resident_bf16_effects_c3(const Operands& o, cudaStream_t stream);

}  // namespace liteqtl
