// The general LOD kernel with bf16x3 products (THROUGHPUT) for 3 covariate
// columns, the LOD alone and the effects variant.

#include "liteqtl_general.cuh"

namespace liteqtl {

cudaError_t launch_general_bf16_c3(const Operands& o, const chunked::Totals& t, cudaStream_t s) {
  return o.beta != nullptr ? launch_general<bf16x3::Policy, 3, true>(o, t, s)
                           : launch_general<bf16x3::Policy, 3, false>(o, t, s);
}

}  // namespace liteqtl
