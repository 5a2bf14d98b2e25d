// The resident LOD kernel with bf16x3 products (THROUGHPUT) for 1 covariate
// column, every depth it is built for.

#include "liteqtl_resident.cuh"

namespace liteqtl {

cudaError_t launch_resident_bf16_c1(const Operands& o, cudaStream_t stream) {
  return launch_resident<bf16x3::Policy, 1, false>(o, stream);
}

}  // namespace liteqtl
