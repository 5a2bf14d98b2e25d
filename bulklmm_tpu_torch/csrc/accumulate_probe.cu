// The accumulate probe: how Hopper's tensor cores finish a float32 sum.
//
// Not a port of a TPU kernel and on no scan's path. The three kernels of
// this directory take their float32-grade products as three TF32 passes
// into float32 accumulators (mma_tf32x3.cuh), and how the tensor cores add
// a step's products into an accumulator (aligned to what, cut or rounded,
// with how many bits beyond float32) decides how far a long sum drifts.
// This file runs one product of each form the kernels use on operands that
// the caller crafts, so that the answer is measured, not assumed:
//
// - bulklmm_probe_mma: mma.sync m16n8k8 (TF32 operands, float32
//   accumulators), one warp a 16 x 8 x 8 tile: D = C + A B.
// - bulklmm_probe_wgmma: wgmma m64n64k8 (A from registers, B K-major in
//   shared memory), one warpgroup a 64 x 64 x 8 tile: D = C + A B.
//
// accumulate_probe_bf16.cu holds the bf16 forms of THROUGHPUT's bf16x3
// products (mma.sync m16n8k16, wgmma m64n64k16).
//
// A, B and C are float32 with row-major tiles one after another: A (rows x
// 8), B (8 x columns), C and D (rows x columns). A's and B's values must be
// TF32 already (13 low mantissa bits zero); they are handed to the tensor
// cores as they are, with no conversion. kernels/accumulate_probe.py crafts
// the cases and holds the results against kernels/split.py's model of the
// sum (tensor_core_sum()).
//
// Build: with the rest of csrc/ (kernels/build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

// One warp a tile. Fragment layout of m16n8k8 (PTX ISA): thread (g = lane /
// 4, q = lane % 4) holds A[g][q], A[g + 8][q], A[g][q + 4], A[g + 8][q + 4],
// B[q][g], B[q + 4][g] and C[g][2 q + e], C[g + 8][2 q + e].
__global__ void probe_mma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                 const float* __restrict__ C, float* __restrict__ D, int tiles) {
  const int tile = blockIdx.x;
  if (tile >= tiles) return;
  const int lane = threadIdx.x, g = lane / 4, q = lane % 4;
  const float* a = A + (size_t)tile * 16 * 8;
  const float* b = B + (size_t)tile * 8 * 8;
  const float* c = C + (size_t)tile * 16 * 8;
  float* d = D + (size_t)tile * 16 * 8;
  const uint32_t af[4] = {__float_as_uint(a[g * 8 + q]), __float_as_uint(a[(g + 8) * 8 + q]),
                          __float_as_uint(a[g * 8 + q + 4]),
                          __float_as_uint(a[(g + 8) * 8 + q + 4])};
  const uint32_t bf[2] = {__float_as_uint(b[q * 8 + g]), __float_as_uint(b[(q + 4) * 8 + g])};
  float acc[4] = {c[g * 8 + 2 * q], c[g * 8 + 2 * q + 1], c[(g + 8) * 8 + 2 * q],
                  c[(g + 8) * 8 + 2 * q + 1]};
  mma_m16n8k8(acc, af, bf);
  d[g * 8 + 2 * q] = acc[0];
  d[g * 8 + 2 * q + 1] = acc[1];
  d[(g + 8) * 8 + 2 * q] = acc[2];
  d[(g + 8) * 8 + 2 * q + 1] = acc[3];
}

// One warpgroup (128 threads) a tile: warp w holds rows 16 w .. 16 w + 15 of
// A in the m16n8k8 layout and of D in the accumulator layout
// (wgmma_m64n64k8()); B is staged K-major (kmajor_offset()).
__global__ void probe_wgmma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                   const float* __restrict__ C, float* __restrict__ D, int tiles) {
  __shared__ __align__(128) float bs[8 * 64];
  const int tile = blockIdx.x;
  if (tile >= tiles) return;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, g = lane / 4, q = lane % 4;
  const float* a = A + (size_t)tile * 64 * 8 + 16 * w * 8;
  const float* b = B + (size_t)tile * 8 * 64;
  const float* c = C + (size_t)tile * 64 * 64 + 16 * w * 64;
  float* d = D + (size_t)tile * 64 * 64 + 16 * w * 64;
  for (int e = tid; e < 8 * 64; e += 128) {
    const int s = e / 64, col = e % 64;
    bs[kmajor_offset(s, col, 64)] = b[e];
  }
  fence_proxy_async();
  __syncthreads();
  const uint32_t af[4] = {__float_as_uint(a[g * 8 + q]), __float_as_uint(a[(g + 8) * 8 + q]),
                          __float_as_uint(a[g * 8 + q + 4]),
                          __float_as_uint(a[(g + 8) * 8 + q + 4])};
  float acc[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[4 * j + 2 * h + e] = c[(g + 8 * h) * 64 + 8 * j + 2 * q + e];
  wgmma_fence();
  wgmma_m64n64k8(acc, af, kmajor_descriptor(bs, 64), 1);
  wgmma_commit();
  wgmma_wait<0>();
  pin_registers(acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) d[(g + 8 * h) * 64 + 8 * j + 2 * q + e] = acc[4 * j + 2 * h + e];
}

}  // namespace

extern "C" {

// D = C + A B for `tiles` 16 x 8 x 8 tiles by mma.sync; device pointers,
// float32, tiles one after another. Returns the launch's CUDA error.
int bulklmm_probe_mma(const float* A, const float* B, const float* C, float* D, int tiles,
                      void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  probe_mma_kernel<<<tiles, 32, 0, static_cast<cudaStream_t>(stream)>>>(A, B, C, D, tiles);
  return (int)cudaGetLastError();
}

// D = C + A B for `tiles` 64 x 64 x 8 tiles by wgmma; as bulklmm_probe_mma.
int bulklmm_probe_wgmma(const float* A, const float* B, const float* C, float* D, int tiles,
                        void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  probe_wgmma_kernel<<<tiles, 128, 0, static_cast<cudaStream_t>(stream)>>>(A, B, C, D, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
