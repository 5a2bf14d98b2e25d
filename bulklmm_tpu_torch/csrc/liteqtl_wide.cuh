// The wide LOD kernel (liteqtl_wide_wgmma_kernel: any count c > 3 of
// covariate columns, at any n), for the function that liteqtl_fused.cu
// states, with the products' policy as its first template parameter:
// liteqtl_wide.cu instantiates it for tf32x3::Policy, liteqtl_wide_bf16.cu
// for bf16x3::Policy (THROUGHPUT). The kernel and its launcher lie in an
// anonymous namespace, one copy a source file.
//
// The general kernel keeps (c + 2) accumulator sets, one for each U_k, and
// finishes with the forward substitution Z = L^{-1} U; its registers grow
// with c, which is why it stops at c = 3. This kernel uses that the
// substitution is linear:
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
// the general kernel, with IEEE divisions and log10f. The same 2 (c + 2) n p m
// flops: the first walk over the samples takes B, D1 and Z_0 together, every
// later walk one Z_k. The scalar block is zeta (c rows), inv_nrm2, and nrm2
// for the effects variant (kEffects), whose effect and standard error are
// the general kernel's effect_from_products() on the same N and D.
//
// The products are the chunked warpgroup mainloop of liteqtl_chunked.cuh: a
// block of two warpgroups owns 64 traits and two 64-marker tiles at a time,
// walks the samples in chunks of 40 (bf16x3: 32) through a ring of cp.async
// stages, and splits each chunk of V_k (and of W and WY on the first walk)
// once for both tiles. Product sets B, D1 and Z_0 on the
// first walk, Z_k alone after it, and N, D on the CUDA cores: 128
// accumulator registers a thread at most, for any c; D1 waits for the
// epilogue in shared memory after the first walk. No instruction but
// wgmma writes a product set (N is not kept in B's registers), or ptxas
// serializes the products (C7515). Two columns a walk (one A fragment for
// both Z sets, the marker chunks staged half as often) took 160 and
// spilled, and gained nothing at 79 samples. Under 3 x TF32 the
// finished tiles take the place of the split W and WY, which the last walk
// does not read (c > 3 means four walks at least). Past kFoldChunks chunks
// a walk adds its sets into running totals in device memory (B, D1, Z).
//
// What bounds it on an H100: the operations, 2 (c + 2) n p m flops as three
// TF32 passes, against the (p, m) LOD write and the (c, n, m) operand (at
// 79 x 7,321 x 35,554 with c = 12: 5.8e11 flops, 3.5 ms at 165 TFLOP/s of
// float32-grade work, against 1.04 GB + 135 MB, 0.35 ms).

#pragma once

#include <type_traits>

#include "liteqtl_chunked.cuh"

namespace liteqtl {

namespace {

// kFold: the walks fold their sets into running totals (folds()); each
// walk then adds its last chunks into them too, and its sums are read back
// from them, so that the product sets die at that fold. The finished tiles
// take the place of the split W and WY where they fit there (tf32x3), else
// they lie after D1 (bf16x3: the halves of a chunk of 32 take 4,096 words).
template <class P, int kInFlight, bool kEffects, bool kFold>
__global__ void __launch_bounds__(kThreads, 1)
liteqtl_wide_wgmma_kernel(const float* __restrict__ X,     // (n, ldx) rotated markers
                          const float* __restrict__ V,     // (c, n, m) whitened weighted covariates
                          const float* __restrict__ W,     // (n, m) per-trait weights
                          const float* __restrict__ WY,    // (n, m) weighted traits
                          const float* __restrict__ scal,  // (c + 1 [+ 1], m) zeta, inv_nrm2 [, nrm2]
                          float* __restrict__ out,         // (p, m) LOD
                          float* __restrict__ beta_out,    // (p, m) effect (kEffects)
                          float* __restrict__ se_out,      // (p, m) its standard error (kEffects)
                          float* __restrict__ totals,      // running totals (kFold)
                          int slots,                       // their slots
                          int n, int p, int ldx, int m, int c,
                          int group_tiles,  // marker tiles of one block, an even count
                          int tvec,         // floats a copy of W, WY and V
                          int pairs) {      // 1: every output is 8-byte aligned
  using namespace chunked;
  using K = Chunking<P>;
  constexpr int kOps = 3;  // W, WY, V_k
  constexpr int kStage = stage_floats<P>(kOps, 0);
  constexpr bool kFinishedInSplit = kFinishedFloats <= 4 * K::kHalfFloats;
  extern __shared__ __align__(128) float4 wide_shared_raw[];
  __shared__ int slot;
  float* shared = reinterpret_cast<float*>(wide_shared_raw);
  float* split_w = shared;  // [big, small][kHalfFloats], K-major
  float* split_wy = split_w + 2 * K::kHalfFloats;
  float* split_v = split_wy + 2 * K::kHalfFloats;
  float* stages = split_v + 2 * K::kHalfFloats;  // [2][kStage]: X of both warpgroups | W | WY | V_k
  float* zeros = stages + 2 * kStage;            // [kZeroFloats]
  float* d1s = zeros + kZeroFloats;  // [kGroups][32][kWgThreads]: D1 after the first walk
  // [kGroups][kTileP][kLdOut], in the last walk's free split W and WY where they fit
  float* finished = kFinishedInSplit ? split_w : d1s + kGroups * kSetFloats;
  constexpr int kRawW = kGroups * K::kXFloats, kRawWY = kRawW + K::kChunk * kRawLd;
  constexpr int kRawV = kRawWY + K::kChunk * kRawLd;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int group = warp / 4;
  const int wrow = 16 * (warp % 4);
  const int m0 = blockIdx.x * kTileM;
  const int ntiles = (p + kTileP - 1) / kTileP;
  const int first = blockIdx.y * group_tiles;
  const int last = min(first + group_tiles, ntiles);
  const int nchunks = (n + K::kChunk - 1) / K::kChunk;
  const int every = fold_chunks<P>(n);  // chunks a run of the sets carries (kFold)
  const int walk_steps = c * nchunks;  // steps of one pair of marker tiles
  const int nsteps = (last - first + 1) / 2 * walk_steps;

  // one step's copies: the two marker chunks, V_k and, on the first walk, W and WY
  auto start_copies = [&](int step) {
    float* st = stages + (step & 1) * kStage;
    const int chunk = step % nchunks, k = step % walk_steps / nchunks;
    const int tile = first + 2 * (step / walk_steps);
    const int n0 = chunk * K::kChunk;
    stage_markers<P>(st, X, n, ldx, n0, tile, tid);
    stage_operand<P>(st + kRawV, V + (size_t)k * n * m, n, m, n0, m0, tvec, tid);
    if (k == 0) {
      stage_operand<P>(st + kRawW, W, n, m, n0, m0, tvec, tid);
      stage_operand<P>(st + kRawWY, WY, n, m, n0, m0, tvec, tid);
    }
    cp_async_commit();
  };
  if (nsteps > 0) start_copies(0);

  if (kFold && tid == 0) slot = claim_slot(reinterpret_cast<int*>(totals), slots);
  clear_zero_step(zeros, tid);
  fence_proxy_async();
  __syncthreads();  // the zero step is in place before the first product reads it
  const uint64_t d_w = kmajor_descriptor(split_w, kTileM);
  const uint64_t d_wy = kmajor_descriptor(split_wy, kTileM);
  const uint64_t d_v = kmajor_descriptor(split_v, kTileM);
  const uint64_t d_zero = kmajor_descriptor(zeros, kTileM);
  // the totals of B, D1 and Z, one set after another (kFold)
  float* const tot = kFold ? slot_totals(totals, slots, slot, 3, group, tid) : nullptr;
  auto total_of = [&](int set) { return tot + set * kSetFloats; };
  // element i of a set over the whole walk: a, or its total
  auto sum_of = [&](const float (&a)[32], int set, int i) {
    if constexpr (kFold) return __ldcg(total_of(set) + i * kWgThreads);
    else return a[i];
  };

  const float neg_half_n = -0.5f * (float)n;
  const float inv_dof = 1.0f / (float)max(n - c - 1, 1);
  float* my_finished = finished + (group * kTileP + wrow) * kLdOut;
  float* my_d1 = d1s + group * kSetFloats + tid % kWgThreads;  // the thread's element 0
  const int npairs = (last - first + 1) / 2;
  int step = 0;
  // one chunk of a walk: its copies, its split operands (W and WY on the
  // first walk) and its products
  auto walk_chunk = [&](auto first_walk, float (&b)[32], float (&d1)[32], float (&z)[32],
                        int chunk) {
    constexpr bool kFirstWalk = decltype(first_walk)::value;
    cp_async_wait<0>();
    __syncthreads();  // this step's chunk has landed; the other stage is free
    if (step + 1 < nsteps) start_copies(step + 1);
    const float* st = stages + (step & 1) * kStage;
    split_operand<P>(split_v, st + kRawV, tid);
    if constexpr (kFirstWalk) {
      split_operand<P>(split_w, st + kRawW, tid);
      split_operand<P>(split_wy, st + kRawWY, tid);
    }
    fence_proxy_async();
    __syncthreads();  // the split operands are complete
    pin_registers(z);
    if constexpr (kFirstWalk) pin_registers(b), pin_registers(d1);
    wide_chunk<P, kFirstWalk, kInFlight>(b, d1, z, st + group * K::kXFloats + wrow + 2 * g, d_w,
                                         d_wy, d_v, q, kFold ? keeps_sets(chunk, every) : 1);
    pin_registers(z);
    if constexpr (kFirstWalk) pin_registers(b), pin_registers(d1);
    ++step;
  };
  // num -= Z_k zeta_k and d -= Z_k^2, in the order of residualize(): the
  // thread's traits 8 j + 2 q + e, element i = 4 j + 2 h + e. After the
  // first walk (kFirst) num and d start from B and D1 element by element,
  // so that b and d1 die as num and d are made, and D1 waits for the
  // epilogue in shared memory.
  auto subtract_column = [&](auto first, int k, const float (&b)[32], const float (&d1)[32],
                             const float (&z)[32], float (&num)[32], float (&d)[32]) {
    constexpr bool kFirst = decltype(first)::value;
#pragma unroll
    for (int j = 0; j < kTileM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = m0 + 8 * j + 2 * q + e;
        const float zeta = gm < m ? scal[(size_t)k * m + gm] : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          if constexpr (kFirst) {
            num[i] = sum_of(b, 0, i);
            d[i] = sum_of(d1, 1, i);
            my_d1[i * kWgThreads] = d[i];
          }
          const float zk = sum_of(z, 2, i);
          num[i] = __fsub_rn(num[i], __fmul_rn(zk, zeta));
          d[i] = __fsub_rn(d[i], __fmul_rn(zk, zk));
        }
      }
    }
  };

  for (int pair = 0; pair < npairs; ++pair) {
    // the first walk: B, D1 and Z_0 (kFold: each run of kFoldChunks chunks
    // added into the totals)
    float num[32], d[32];
    {
      float b[32], d1[32], z[32];
      zero_each<P>(d_zero, b, d1, z);
      for (int chunk = 0; chunk < nchunks; ++chunk) {
        walk_chunk(std::true_type{}, b, d1, z, chunk);
        if (kFold && fold_after(chunk, nchunks, every)) {
          fold_set(total_of(0), b, chunk + 1 == every);
          fold_set(total_of(1), d1, chunk + 1 == every);
          fold_set(total_of(2), z, chunk + 1 == every);
        }
      }
      if constexpr (kFold) {
        fold_set(total_of(0), b, false);
        fold_set(total_of(1), d1, false);
        fold_set(total_of(2), z, false);
      }
      subtract_column(std::true_type{}, 0, b, d1, z, num, d);
    }
    // every later walk: Z_k
    for (int k = 1; k < c; ++k) {
      float z[32];
      zero_each<P>(d_zero, z);
      for (int chunk = 0; chunk < nchunks; ++chunk) {
        walk_chunk(std::false_type{}, z, z, z, chunk);
        if (kFold && fold_after(chunk, nchunks, every)) fold_set(total_of(2), z, chunk + 1 == every);
      }
      if constexpr (kFold) fold_set(total_of(2), z, false);
      subtract_column(std::false_type{}, k, z, z, z, num, d);
    }

    auto element = [&](int j, int h, int e) {
      const int i = 4 * j + 2 * h + e, gm = m0 + 8 * j + 2 * q + e;
      Residual r;
      r.num = num[i];
      r.d = d[i];
      r.keep = keep_and_floor(r.d, my_d1[i * kWgThreads]);
      // columns past m get ones: no division by zero in lanes never stored
      r.inv_nrm2 = gm < m ? scal[(size_t)c * m + gm] : 1.0f;
      r.nrm2 = (kEffects && gm < m) ? scal[(size_t)(c + 1) * m + gm] : 1.0f;
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

// The wide kernel of policy P on the operands o (o.Cov is V, (c, n, m); o.scal
// the wide scalar block), c > 3 covariate columns, or with t.need set the
// size of its running totals.
template <class P>
cudaError_t launch_wide_kernel(const Operands& o, int c, const chunked::Totals& t,
                               cudaStream_t stream) {
  using namespace chunked;
  if (c < 4 || o.ldx % 4 != 0 || reinterpret_cast<uintptr_t>(o.X) % 16 != 0)
    return cudaErrorInvalidValue;
  const bool effects = o.beta != nullptr;
  // each depth step's fragments are made while the step before multiplies
  const bool fold = folds<P>(o.n);
  auto kernel = effects ? liteqtl_wide_wgmma_kernel<P, 1, true, false>
                        : liteqtl_wide_wgmma_kernel<P, 1, false, false>;
  if constexpr (Chunking<P>::kFoldChunks > 0) {
    if (fold)
      kernel = effects ? liteqtl_wide_wgmma_kernel<P, 1, true, true>
                       : liteqtl_wide_wgmma_kernel<P, 1, false, true>;
  }
  constexpr bool kFinishedInSplit = kFinishedFloats <= 4 * Chunking<P>::kHalfFloats;
  const size_t bytes = 4 * (shared_floats<P>(3, 0, 0, !kFinishedInSplit) + kGroups * kSetFloats);
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  int slots;
  if ((rc = total_slots(kernel, bytes, fold, 3, t, slots)) != cudaSuccess || t.need) return rc;
  Geometry geo;
  if ((rc = geometry(o, geo)) != cudaSuccess) return rc;
  // every V_k starts n m floats after the one before it
  const long long nm = (long long)o.n * o.m;
  const int tvec = std::min({trait_copy_width(o.W, o.WY, o.m), copy_width(o.Cov, o.m),
                             nm % 4 == 0 ? 4 : nm % 2 == 0 ? 2 : 1});
  const int pairs = aligned8(o.out) && (!effects || (aligned8(o.beta) && aligned8(o.se)));
  kernel<<<geo.grid, kThreads, bytes, stream>>>(o.X, o.Cov, o.W, o.WY, o.scal, o.out, o.beta,
                                                o.se, t.at, slots, o.n, o.p, o.ldx, o.m, c,
                                                geo.group_tiles, tvec, pairs);
  return cudaGetLastError();
}

}  // namespace

}  // namespace liteqtl
