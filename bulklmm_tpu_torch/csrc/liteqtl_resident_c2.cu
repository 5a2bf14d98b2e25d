// The resident LOD kernel for 2 covariate columns, every depth it is built for.

#include "liteqtl_resident.cuh"

namespace liteqtl {

cudaError_t launch_resident_c2(const Operands& o, cudaStream_t stream) {
  return launch_resident<tf32x3::Policy, 2, false>(o, stream);
}

}  // namespace liteqtl
