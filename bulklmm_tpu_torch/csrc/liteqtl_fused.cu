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
// reach device memory. The effects variant of every kernel (the template
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
// from L2 and an epilogue of two divisions and a logarithm for every
// output, which in their exact forms are more dispatch time than the
// products are tensor-core time at n = 79.
//
// Three kernels, all of them 3 x TF32 wgmma products; the launcher picks one
// from n and c (bulklmm_liteqtl_path), and kernels/liteqtl_fused.py::
// kernel_path states the same rule. Under THROUGHPUT's "high" products the
// resident kernel takes three bf16 passes instead (bf16x3, the JAX
// package's HIGH); the general and wide kernels keep their three TF32
// passes, which are stricter than that preset asks.
//
// The resident kernel (liteqtl_resident.cuh: n <= 88, c <= 3) keeps the
// traits' operands in shared memory for the whole launch and copies the
// marker tiles asynchronously; one source file a covariate count and
// policy, so that they compile side by side.
//
// The general kernel (liteqtl_general_wgmma_kernel below: c <= 3 at any n,
// the launcher's choice for n > 88) walks the samples in chunks through a
// ring of cp.async stages, splitting each chunk of W and WY once for two
// marker tiles (liteqtl_chunked.cuh), with (c + 2) accumulator sets, added
// into float32 running totals in device memory (every kFoldChunks chunks past
// 200 samples, every chunk below), and the exact epilogue (IEEE divisions and
// log10f).
//
// The wide kernel (liteqtl_wide.cu: any c > 3, at any n) takes the
// covariates already whitened per trait and walks them one column at a
// time on the same chunked mainloop, with three product sets and two
// CUDA-core sets for any c; its operands are V (c, n, m) in the place of C
// and a scalar block without the packed factor.
//
// Ragged edges, every kernel: trait columns past m get scalars of 1 (no
// division by zero in lanes never stored), out-of-range outputs are not
// stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC, and never --use_fast_math (it would replace
//        log10f and the IEEE division and flush subnormals).

#include "liteqtl_chunked.cuh"

namespace liteqtl {

// --- the general kernel: chunked 3 x TF32 warpgroup products, c <= 3 -----------------

// kInFlight: depth steps whose products may still run while the next step's
// fragments are made (each step in flight holds its fragments' registers).
// kFold: the walks fold their sets into running totals (folds(n)); each
// walk then adds its last chunks into them too, and the epilogue reads its
// sums from them.
template <int C, int kInFlight, bool kEffects, bool kFold>
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
  constexpr int kOps = 2;  // W, WY
  constexpr int kS = scalar_rows(C, kEffects);
  constexpr int kTri = C * (C + 1) / 2;
  constexpr int kAcc = C + 2;  // B, D1, U_0 .. U_{C-1}
  constexpr int kStage = stage_floats(kOps, C);
  extern __shared__ __align__(128) float4 general_shared_raw[];
  __shared__ int slot;
  float* shared = reinterpret_cast<float*>(general_shared_raw);
  float* split_w = shared;  // [big, small][kHalfFloats], K-major
  float* split_wy = split_w + 2 * kHalfFloats;
  float* stages = split_wy + 2 * kHalfFloats;  // [2][kStage]: X of both warpgroups | W | WY | C
  float* finished = stages + 2 * kStage;       // [kGroups][kTileP][kLdOut]
  float* zeros = finished + kGroups * kTileP * kLdOut;  // [kZeroFloats]
  float* ss = zeros + kZeroFloats;                      // [kS][kTileM]
  constexpr int kRawW = kGroups * kXFloats, kRawWY = kRawW + kChunk * kRawLd;
  constexpr int kCov = kRawWY + kChunk * kRawLd;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int group = warp / 4;        // the warpgroup
  const int wrow = 16 * (warp % 4);  // the warp's first marker of a tile
  const int m0 = blockIdx.x * kTileM;
  const int ntiles = (p + kTileP - 1) / kTileP;
  const int first = blockIdx.y * group_tiles;
  const int last = min(first + group_tiles, ntiles);
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int every = fold_chunks(n);  // chunks a run of the sets carries (kFold)
  const int nsteps = (last - first + 1) / 2 * nchunks;  // chunks of all pairs of marker tiles

  // one step's copies: the two marker chunks, W, WY and the covariates
  auto start_copies = [&](int step) {
    float* st = stages + (step & 1) * kStage;
    const int chunk = step % nchunks, tile = first + 2 * (step / nchunks);
    const int n0 = chunk * kChunk;
    stage_markers(st, X, n, ldx, n0, tile, tid);
    stage_operand(st + kRawW, W, n, m, n0, m0, tvec, tid);
    stage_operand(st + kRawWY, WY, n, m, n0, m0, tvec, tid);
    for (int e = tid; e < C * kChunk; e += kThreads) {
      const int k = e / kChunk, s = n0 + e % kChunk;
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
    zero_sets(acc, d_zero);
    for (int chunk = 0; chunk < nchunks; ++chunk, ++step) {
      cp_async_wait<0>();
      __syncthreads();  // this step's chunk has landed; the other stage is free
      if (step + 1 < nsteps) start_copies(step + 1);
      const float* st = stages + (step & 1) * kStage;
      split_operand(split_w, st + kRawW, tid);
      split_operand(split_wy, st + kRawWY, tid);
      fence_proxy_async();
      __syncthreads();  // the split operands are complete
#pragma unroll
      for (int a = 0; a < kAcc; ++a) pin_registers(acc[a]);
      general_chunk<C, kInFlight>(acc, st + group * kXFloats + wrow + 2 * g, st + kCov, d_w, d_wy,
                                  q, kFold ? keeps_sets(chunk, every) : 1);
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

// liteqtl_wide.cu
cudaError_t launch_wide(const Operands& o, int c, const chunked::Totals& t, cudaStream_t stream);

template <int C, bool kEffects>
cudaError_t launch_general(const Operands& o, const chunked::Totals& t, cudaStream_t stream) {
  using namespace chunked;
  if (o.ldx % 4 != 0 || reinterpret_cast<uintptr_t>(o.X) % 16 != 0) return cudaErrorInvalidValue;
  // depth steps in flight beside the one being made, as far as their fragments' registers fit
  constexpr int kInFlight = C == 1 || (C == 2 && !kEffects) ? 1 : 0;
  auto kernel = folds(o.n) ? liteqtl_general_wgmma_kernel<C, kInFlight, kEffects, true>
                           : liteqtl_general_wgmma_kernel<C, kInFlight, kEffects, false>;
  const size_t bytes = 4 * shared_floats(2, C, scalar_rows(C, kEffects));
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  int slots;
  if ((rc = total_slots(kernel, bytes, o.n, C + 2, t, slots)) != cudaSuccess || t.need) return rc;
  Geometry geo;
  if ((rc = geometry(o, geo)) != cudaSuccess) return rc;
  const int pairs = aligned8(o.out) && (!kEffects || (aligned8(o.beta) && aligned8(o.se)));
  kernel<<<geo.grid, kThreads, bytes, stream>>>(o.X, o.Cov, o.W, o.WY, o.scal, o.out, o.beta,
                                                o.se, t.at, slots, o.n, o.p, o.ldx, o.m,
                                                geo.group_tiles, trait_copy_width(o.W, o.WY, o.m),
                                                pairs);
  return cudaGetLastError();
}

// The launch of the kernel for o (c covariate columns; `general`: the
// general kernel whatever n is; `bf16`: the resident kernel's bf16x3
// products, where the shape takes it), or with t.need set its running
// totals' size.
cudaError_t dispatch(const Operands& o, int c, bool general, bool bf16, const chunked::Totals& t,
                     cudaStream_t s) {
  const bool effects = o.beta != nullptr;
  if (c > kGeneralCovariates) return general ? cudaErrorInvalidValue : launch_wide(o, c, t, s);
  if (!general && is_resident(o.n, c, effects)) {
    if (t.need) {
      *t.need = 0;
      return cudaSuccess;
    }
    switch (c + (effects ? 3 : 0) + (bf16 ? 6 : 0)) {
      case 1: return launch_resident_c1(o, s);
      case 2: return launch_resident_c2(o, s);
      case 3: return launch_resident_c3(o, s);
      case 4: return launch_resident_effects_c1(o, s);
      case 5: return launch_resident_effects_c2(o, s);
      case 6: return launch_resident_effects_c3(o, s);
      case 7: return launch_resident_bf16_c1(o, s);
      case 8: return launch_resident_bf16_c2(o, s);
      case 9: return launch_resident_bf16_c3(o, s);
      case 10: return launch_resident_bf16_effects_c1(o, s);
      case 11: return launch_resident_bf16_effects_c2(o, s);
      case 12: return launch_resident_bf16_effects_c3(o, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (c + (effects ? 3 : 0)) {
    case 1: return launch_general<1, false>(o, t, s);
    case 2: return launch_general<2, false>(o, t, s);
    case 3: return launch_general<3, false>(o, t, s);
    case 4: return launch_general<1, true>(o, t, s);
    case 5: return launch_general<2, true>(o, t, s);
    case 6: return launch_general<3, true>(o, t, s);
    default: return cudaErrorInvalidValue;
  }
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

// 1 where the resident 3 x TF32 kernel for c covariate columns and `steps`
// depth steps takes its leading terms a depth step at a time into a scratch
// set, 0 where it adds them straight into its sets (lead_runs()).
int bulklmm_liteqtl_lead_runs(int c, int steps, int effects) {
  return lead_runs(tf32x3::Policy::kStep, c, steps, effects != 0) ? 1 : 0;
}

// The floats of device memory that bulklmm_liteqtl_lod needs as `totals`
// for n samples and c covariate columns (0: none), or -1 with the CUDA error
// in *error.
long long bulklmm_liteqtl_totals(int n, int c, int effects, int general, int* error) {
  float dummy = 0.0f;
  const Operands o{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   effects ? &dummy : nullptr, effects ? &dummy : nullptr, n, 1, 4, 1};
  long long need = 0;
  const cudaError_t rc = dispatch(o, c, general != 0, false, {nullptr, 0, &need}, nullptr);
  *error = (int)rc;
  return rc == cudaSuccess ? need : -1;
}

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 on success). Pointers are device pointers to contiguous float32 arrays,
// but X: its n rows are ldx >= p floats apart, ldx a multiple of 4 and X
// 16-byte aligned, so that every row takes 16-byte copies; the columns
// between p and ldx may hold anything finite or not (their outputs are not
// stored). c >= 1; above 3 the wide kernel's operands (Cov is V, (c, n, m),
// and scal its scalar block). beta and se both null: the LOD alone; both
// given: the effects variant, whose scalar block has the nrm2 row.
// general != 0 takes the general kernel whatever n is (c <= 3). bf16 != 0
// takes the resident kernel's products as three bf16 passes where the shape
// takes the resident kernel (the general and wide kernels keep their three
// TF32 passes); bulklmm_liteqtl_path() names the kernel. totals:
// bulklmm_liteqtl_totals() floats of device memory, zeroed, which the
// launch leaves zeroed where it found them so (null where it needs none),
// `total_floats` long.
int bulklmm_liteqtl_lod(const float* X, int ldx, const float* Cov, const float* W,
                        const float* WY, const float* scal, float* out, float* beta, float* se,
                        int n, int p, int m, int c, int general, int bf16, float* totals,
                        long long total_floats, void* stream) {
  if (n <= 0 || p <= 0 || m <= 0 || ldx < p) return (int)cudaErrorInvalidValue;
  if ((beta == nullptr) != (se == nullptr)) return (int)cudaErrorInvalidValue;
  const Operands o{X, Cov, W, WY, scal, out, beta, se, n, p, ldx, m};
  return (int)dispatch(o, c, general != 0, bf16 != 0, {totals, total_floats, nullptr},
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
