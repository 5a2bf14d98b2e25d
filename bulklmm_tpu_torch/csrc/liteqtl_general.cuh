// The general LOD kernel (liteqtl_general_wgmma_kernel: c <= 3 covariate
// columns at any n, the launcher's choice for n > 88), for the function that
// liteqtl_fused.cu states, on the chunked mainloop of liteqtl_chunked.cuh,
// with the products' policy as its first template parameter. liteqtl_fused.cu
// instantiates it for tf32x3::Policy, liteqtl_general_bf16_c<c>.cu for
// bf16x3::Policy (THROUGHPUT), one source file a covariate count so that the
// files compile side by side.

#pragma once

#include "liteqtl_chunked.cuh"

namespace liteqtl {

// --- the general kernel: chunked warpgroup products, c <= 3 ------------------------

// kInFlight: depth steps whose products may still run while the next step's
// fragments are made (each step in flight holds its fragments' registers).
// kFold: the walks fold their sets into running totals (folds()); each
// walk then adds its last chunks into them too, and the epilogue reads its
// sums from them.
template <class P, int C, int kInFlight, bool kEffects, bool kFold>
__global__ void __launch_bounds__(kThreads, 1)
liteqtl_general_wgmma_kernel(const float* __restrict__ X,     // (n, ldx) rotated markers
                             const float* __restrict__ Cov,   // (n, C) rotated covariates
                             const float* __restrict__ W,     // (n, m) per-trait weights
                             const float* __restrict__ WY,    // (n, m) weighted traits
                             const float* __restrict__ scal,  // (S, m) per-trait scalars
                             float* __restrict__ out,         // (p, m) LOD
                             float* __restrict__ beta_out,    // (p, m) effect (kEffects)
                             float* __restrict__ se_out,      // (p, m) its standard error (kEffects)
                             float* __restrict__ totals,      // running totals (kFold)
                             int slots,                       // their slots
                             int n, int p, int ldx, int m,
                             int group_tiles,  // marker tiles of one block, an even count
                             int tvec,         // floats a copy of W and WY
                             int pairs) {      // 1: every output is 8-byte aligned
  using namespace chunked;
  using K = Chunking<P>;
  constexpr int kOps = 2;  // W, WY
  constexpr int kS = scalar_rows(C, kEffects);
  constexpr int kTri = C * (C + 1) / 2;
  constexpr int kAcc = C + 2;  // B, D1, U_0 .. U_{C-1}
  constexpr int kStage = stage_floats<P>(kOps, C);
  constexpr bool kRolledSplit = P::kStep == 16 && C == 3;  // split_operand(): registers
  extern __shared__ __align__(128) float4 general_shared_raw[];
  __shared__ int slot;
  float* shared = reinterpret_cast<float*>(general_shared_raw);
  float* split_w = shared;  // [big, small][kHalfFloats], K-major
  float* split_wy = split_w + 2 * K::kHalfFloats;
  float* stages = split_wy + 2 * K::kHalfFloats;  // [2][kStage]: X of both warpgroups | W | WY | C
  float* finished = stages + 2 * kStage;          // [kGroups][kTileP][kLdOut]
  float* zeros = finished + kGroups * kTileP * kLdOut;  // [kZeroFloats]
  float* ss = zeros + kZeroFloats;                      // [kS][kTileM]
  constexpr int kRawW = kGroups * K::kXFloats, kRawWY = kRawW + K::kChunk * kRawLd;
  constexpr int kCov = kRawWY + K::kChunk * kRawLd;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int group = warp / 4;        // the warpgroup
  const int wrow = 16 * (warp % 4);  // the warp's first marker of a tile
  const int m0 = blockIdx.x * kTileM;
  const int ntiles = (p + kTileP - 1) / kTileP;
  const int first = blockIdx.y * group_tiles;
  const int last = min(first + group_tiles, ntiles);
  const int nchunks = (n + K::kChunk - 1) / K::kChunk;
  const int every = fold_chunks<P>(n);  // chunks a run of the sets carries (kFold)
  const int nsteps = (last - first + 1) / 2 * nchunks;  // chunks of all pairs of marker tiles

  // one step's copies: the two marker chunks, W, WY and the covariates
  auto start_copies = [&](int step) {
    float* st = stages + (step & 1) * kStage;
    const int chunk = step % nchunks, tile = first + 2 * (step / nchunks);
    const int n0 = chunk * K::kChunk;
    stage_markers<P>(st, X, n, ldx, n0, tile, tid);
    stage_operand<P>(st + kRawW, W, n, m, n0, m0, tvec, tid);
    stage_operand<P>(st + kRawWY, WY, n, m, n0, m0, tvec, tid);
    for (int e = tid; e < C * K::kChunk; e += kThreads) {
      const int k = e / K::kChunk, s = n0 + e % K::kChunk;
      cp_async<4>(st + kCov + e, s < n ? Cov + (size_t)s * C + k : Cov, s < n ? 4 : 0);
    }
    cp_async_commit();
  };
  if (nsteps > 0) start_copies(0);

  if (kFold && tid == 0) slot = claim_slot(reinterpret_cast<int*>(totals), slots);
  clear_zero_step(zeros, tid);
  for (int e = tid; e < kS * kTileM; e += kThreads) {
    const int row = e / kTileM, gm = m0 + e % kTileM;
    // columns past m get ones: no division by zero in lanes never stored
    ss[e] = gm < m ? scal[(size_t)row * m + gm] : 1.0f;
  }

  fence_proxy_async();
  __syncthreads();  // the zero step is in place before the first product reads it
  const uint64_t d_w = kmajor_descriptor(split_w, kTileM);
  const uint64_t d_wy = kmajor_descriptor(split_wy, kTileM);
  const uint64_t d_zero = kmajor_descriptor(zeros, kTileM);
  float* const tot = kFold ? slot_totals(totals, slots, slot, kAcc, group, tid) : nullptr;

  const float neg_half_n = -0.5f * (float)n;
  const float inv_dof = 1.0f / (float)max(n - C - 1, 1);  // the effects variant's
  float* my_finished = finished + (group * kTileP + wrow) * kLdOut;
  const int npairs = (last - first + 1) / 2;
  int step = 0;
  for (int pair = 0; pair < npairs; ++pair) {
    float acc[kAcc][32];
    zero_sets<P>(acc, d_zero);
    for (int chunk = 0; chunk < nchunks; ++chunk, ++step) {
      cp_async_wait<0>();
      __syncthreads();  // this step's chunk has landed; the other stage is free
      if (step + 1 < nsteps) start_copies(step + 1);
      const float* st = stages + (step & 1) * kStage;
      split_operand<P, kRolledSplit>(split_w, st + kRawW, tid);
      split_operand<P, kRolledSplit>(split_wy, st + kRawWY, tid);
      fence_proxy_async();
      __syncthreads();  // the split operands are complete
#pragma unroll
      for (int a = 0; a < kAcc; ++a) pin_registers(acc[a]);
      general_chunk<P, C, kInFlight>(acc, st + group * K::kXFloats + wrow + 2 * g, st + kCov, d_w,
                                     d_wy, q, kFold ? keeps_sets(chunk, every) : 1);
#pragma unroll
      for (int a = 0; a < kAcc; ++a) pin_registers(acc[a]);
      if (kFold && fold_after(chunk, nchunks, every)) {
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
          fold_set(tot + a * kSetFloats, acc[a], chunk + 1 == every);
      }
    }
    if constexpr (kFold) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) fold_set(tot + a * kSetFloats, acc[a], false);
    }

    // set a's element i over the whole walk
    auto sum = [&](int a, int i) {
      if constexpr (kFold) return __ldcg(tot + a * kSetFloats + i * kWgThreads);
      else return acc[a][i];
    };
    auto element = [&](int j, int h, int e) {
      const int i = 4 * j + 2 * h + e, lm = 8 * j + 2 * q + e;
      auto scal_of = [&](int row) { return ss[row * kTileM + lm]; };
      float u[C];
#pragma unroll
      for (int k = 0; k < C; ++k) u[k] = sum(2 + k, i);
      Residual r;
      r.num = sum(0, i);
      r.keep = residualize_rn<C>(r.num, r.d, sum(1, i), u, scal_of);
      r.inv_nrm2 = scal_of(kTri + C);
      r.nrm2 = kEffects ? scal_of(kTri + C + 1) : 1.0f;
      return r;
    };
    const int tile = first + 2 * pair + group;
    finish_tile<kEffects>(element, out, beta_out, se_out, my_finished, tile, wrow, m0, p, m, pairs,
                          tile < last, neg_half_n, inv_dof, lane);
  }
  if (kFold) {
    __syncthreads();  // every thread's totals are written
    if (tid == 0) release_slot(reinterpret_cast<int*>(totals), slot);
  }
}

// the most covariate columns the general kernel is instantiated for; the
// wide kernel takes more
constexpr int kGeneralCovariates = 3;

// The general kernel of policy P for C covariate columns on the operands o,
// or with t.need set the size of its running totals.
template <class P, int C, bool kEffects>
cudaError_t launch_general(const Operands& o, const chunked::Totals& t, cudaStream_t stream) {
  using namespace chunked;
  if (o.ldx % 4 != 0 || reinterpret_cast<uintptr_t>(o.X) % 16 != 0) return cudaErrorInvalidValue;
  // depth steps in flight beside the one being made, as far as their fragments' registers fit
  constexpr int kInFlight = C == 1 || (C == 2 && !kEffects) ? 1 : 0;
  const bool fold = folds<P>(o.n);
  auto kernel = liteqtl_general_wgmma_kernel<P, C, kInFlight, kEffects, false>;
  if constexpr (Chunking<P>::kFoldChunks > 0) {
    if (fold) kernel = liteqtl_general_wgmma_kernel<P, C, kInFlight, kEffects, true>;
  }
  const size_t bytes = 4 * shared_floats<P>(2, C, scalar_rows(C, kEffects));
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  int slots;
  if ((rc = total_slots(kernel, bytes, fold, C + 2, t, slots)) != cudaSuccess || t.need) return rc;
  Geometry geo;
  if ((rc = geometry(o, geo)) != cudaSuccess) return rc;
  const int pairs = aligned8(o.out) && (!kEffects || (aligned8(o.beta) && aligned8(o.se)));
  kernel<<<geo.grid, kThreads, bytes, stream>>>(o.X, o.Cov, o.W, o.WY, o.scal, o.out, o.beta,
                                                o.se, t.at, slots, o.n, o.p, o.ldx, o.m,
                                                geo.group_tiles, trait_copy_width(o.W, o.WY, o.m),
                                                pairs);
  return cudaGetLastError();
}

// The general kernel with bf16x3 products (THROUGHPUT) for c covariate
// columns, the LOD alone or the effects variant (o.beta set), each defined
// in its own source file (liteqtl_general_bf16_c<c>.cu).
cudaError_t launch_general_bf16_c1(const Operands& o, const chunked::Totals& t, cudaStream_t s);
cudaError_t launch_general_bf16_c2(const Operands& o, const chunked::Totals& t, cudaStream_t s);
cudaError_t launch_general_bf16_c3(const Operands& o, const chunked::Totals& t, cudaStream_t s);

// The wide kernel (liteqtl_wide.cuh) on the operands o, c > 3 covariate
// columns: 3 x TF32 products (liteqtl_wide.cu) or bf16x3
// (liteqtl_wide_bf16.cu).
cudaError_t launch_wide(const Operands& o, int c, const chunked::Totals& t, cudaStream_t stream);
cudaError_t launch_wide_bf16(const Operands& o, int c, const chunked::Totals& t,
                             cudaStream_t stream);

}  // namespace liteqtl
