// The wide LOD kernel with 3 x TF32 products (liteqtl_wide.cuh): every
// preset but THROUGHPUT.

#include "liteqtl_wide.cuh"

namespace liteqtl {

// The wide kernel on the operands o (o.Cov is V, (c, n, m); o.scal the wide
// scalar block), c > 3 covariate columns: the last walk leaves the split W
// and WY to the finished tiles.
cudaError_t launch_wide(const Operands& o, int c, const chunked::Totals& t, cudaStream_t stream) {
  return launch_wide_kernel<tf32x3::Policy>(o, c, t, stream);
}

}  // namespace liteqtl
