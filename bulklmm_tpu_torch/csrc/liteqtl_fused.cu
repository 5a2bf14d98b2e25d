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
// kernel_path states the same rule. Under THROUGHPUT's "high" products each
// of the three takes three bf16 passes instead (bf16x3, the JAX package's
// HIGH), an instantiation of its own on bf16x3::Policy in a source file of
// its own.
//
// The resident kernel (liteqtl_resident.cuh: n <= 88, c <= 3) keeps the
// traits' operands in shared memory for the whole launch and copies the
// marker tiles asynchronously; one source file a covariate count and
// policy, so that they compile side by side.
//
// The general kernel (liteqtl_general.cuh: c <= 3 at any n, the launcher's
// choice for n > 88) walks the samples in chunks through a ring of cp.async
// stages, splitting each chunk of W and WY once for two marker tiles
// (liteqtl_chunked.cuh), with (c + 2) accumulator sets, under 3 x TF32
// added into float32 running totals in device memory (every kFoldChunks
// chunks past 200 samples, every chunk below), and the exact epilogue (IEEE
// divisions and log10f).
//
// The wide kernel (liteqtl_wide.cuh: any c > 3, at any n) takes the
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

#include "liteqtl_general.cuh"

namespace liteqtl {

// The launch of the kernel for o (c covariate columns; `general`: the
// general kernel whatever n is; `bf16`: the kernel's bf16x3 products), or
// with t.need set its running totals' size.
cudaError_t dispatch(const Operands& o, int c, bool general, bool bf16, const chunked::Totals& t,
                     cudaStream_t s) {
  const bool effects = o.beta != nullptr;
  if (c > kGeneralCovariates) {
    if (general) return cudaErrorInvalidValue;
    return bf16 ? launch_wide_bf16(o, c, t, s) : launch_wide(o, c, t, s);
  }
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
  if (bf16) {
    switch (c) {
      case 1: return launch_general_bf16_c1(o, t, s);
      case 2: return launch_general_bf16_c2(o, t, s);
      case 3: return launch_general_bf16_c3(o, t, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (c + (effects ? 3 : 0)) {
    case 1: return launch_general<tf32x3::Policy, 1, false>(o, t, s);
    case 2: return launch_general<tf32x3::Policy, 2, false>(o, t, s);
    case 3: return launch_general<tf32x3::Policy, 3, false>(o, t, s);
    case 4: return launch_general<tf32x3::Policy, 1, true>(o, t, s);
    case 5: return launch_general<tf32x3::Policy, 2, true>(o, t, s);
    case 6: return launch_general<tf32x3::Policy, 3, true>(o, t, s);
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
// for n samples, c covariate columns and the products (bf16 != 0: bf16x3)
// (0: none), or -1 with the CUDA error in *error.
long long bulklmm_liteqtl_totals(int n, int c, int effects, int general, int bf16, int* error) {
  float dummy = 0.0f;
  const Operands o{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   effects ? &dummy : nullptr, effects ? &dummy : nullptr, n, 1, 4, 1};
  long long need = 0;
  const cudaError_t rc = dispatch(o, c, general != 0, bf16 != 0, {nullptr, 0, &need}, nullptr);
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
// takes the kernel's products as three bf16 passes, on every path;
// bulklmm_liteqtl_path() names the kernel. totals:
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
