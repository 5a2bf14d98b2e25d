// The resident LOD kernel's effects variant for 1 covariate column, every depth
// it is built for.

#include "liteqtl_resident.cuh"

namespace liteqtl {

cudaError_t launch_resident_effects_c1(const Operands& o, cudaStream_t stream) {
  return launch_resident<tf32x3::Policy, 1, true>(o, stream);
}

}  // namespace liteqtl
