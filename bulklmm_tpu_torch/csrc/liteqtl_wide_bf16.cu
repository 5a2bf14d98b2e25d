// The wide LOD kernel with bf16x3 products (liteqtl_wide.cuh): THROUGHPUT's
// "high" products.

#include "liteqtl_wide.cuh"

namespace liteqtl {

cudaError_t launch_wide_bf16(const Operands& o, int c, const chunked::Totals& t,
                             cudaStream_t stream) {
  return launch_wide_kernel<bf16x3::Policy>(o, c, t, stream);
}

}  // namespace liteqtl
