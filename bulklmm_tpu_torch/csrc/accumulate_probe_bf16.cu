// The accumulate probe's bf16 forms: how Hopper's tensor cores finish a
// float32 sum of bf16 products, for THROUGHPUT's bf16x3 kernels
// (mma_bf16x3.cuh). accumulate_probe.cu states what the probe is for and
// how kernels/accumulate_probe.py uses it; this file holds its bf16 forms:
//
// - bulklmm_probe_mma_bf16: mma.sync m16n8k16 (bf16 operands, float32
//   accumulators), one warp a 16 x 8 x 16 tile: D = C + A B.
// - bulklmm_probe_wgmma_bf16: wgmma m64n64k16 (A from registers, B K-major
//   in shared memory), one warpgroup a 64 x 64 x 16 tile: D = C + A B.
//
// A (rows x 16), B (16 x columns), C and D (rows x columns) are float32 with
// row-major tiles one after another; A's and B's values must be bf16
// already (16 low bits zero) and reach the tensor cores as they are, depth k
// in the instruction's slot k.
//
// Build: with the rest of csrc/ (kernels/build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16x3.cuh"

namespace {

using namespace tf32x3;

// Two bf16 values held as float32 (16 low bits zero) packed into one
// register, lo in the low half: slots k and k + 1.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
}

// One warp a 16 x 8 x 16 tile. Fragment layout of m16n8k16 (PTX ISA): thread
// (g, q) holds A[g][2 q + e], A[g + 8][2 q + e], A[g][2 q + 8 + e],
// A[g + 8][2 q + 8 + e] (four registers, e = 0 low), B[2 q + e][g],
// B[2 q + 8 + e][g] and C as m16n8k8.
__global__ void probe_mma_bf16_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                      const float* __restrict__ C, float* __restrict__ D,
                                      int tiles) {
  const int tile = blockIdx.x;
  if (tile >= tiles) return;
  const int lane = threadIdx.x, g = lane / 4, q = lane % 4;
  const float* a = A + (size_t)tile * 16 * 16;
  const float* b = B + (size_t)tile * 16 * 8;
  const float* c = C + (size_t)tile * 16 * 8;
  float* d = D + (size_t)tile * 16 * 8;
  const uint32_t af[4] = {pack_bf16(a[g * 16 + 2 * q], a[g * 16 + 2 * q + 1]),
                          pack_bf16(a[(g + 8) * 16 + 2 * q], a[(g + 8) * 16 + 2 * q + 1]),
                          pack_bf16(a[g * 16 + 2 * q + 8], a[g * 16 + 2 * q + 9]),
                          pack_bf16(a[(g + 8) * 16 + 2 * q + 8], a[(g + 8) * 16 + 2 * q + 9])};
  const uint32_t bf[2] = {pack_bf16(b[2 * q * 8 + g], b[(2 * q + 1) * 8 + g]),
                          pack_bf16(b[(2 * q + 8) * 8 + g], b[(2 * q + 9) * 8 + g])};
  float acc[4] = {c[g * 8 + 2 * q], c[g * 8 + 2 * q + 1], c[(g + 8) * 8 + 2 * q],
                  c[(g + 8) * 8 + 2 * q + 1]};
  bf16x3::mma_m16n8k16(acc, af, bf);
  d[g * 8 + 2 * q] = acc[0];
  d[g * 8 + 2 * q + 1] = acc[1];
  d[(g + 8) * 8 + 2 * q] = acc[2];
  d[(g + 8) * 8 + 2 * q + 1] = acc[3];
}

// One warpgroup a 64 x 64 x 16 tile: A from registers in the m16n8k16
// layout, B staged K-major, word w of a column packing depths 2 w and
// 2 w + 1 (a core matrix holds 8 consecutive depths of 16 bits).
__global__ void probe_wgmma_bf16_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                        const float* __restrict__ C, float* __restrict__ D,
                                        int tiles) {
  __shared__ __align__(128) uint32_t bs[8 * 64];
  const int tile = blockIdx.x;
  if (tile >= tiles) return;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, g = lane / 4, q = lane % 4;
  const float* a = A + (size_t)tile * 64 * 16 + 16 * w * 16;
  const float* b = B + (size_t)tile * 16 * 64;
  const float* c = C + (size_t)tile * 64 * 64 + 16 * w * 64;
  float* d = D + (size_t)tile * 64 * 64 + 16 * w * 64;
  for (int e = tid; e < 8 * 64; e += 128) {
    const int word = e / 64, col = e % 64;
    bs[kmajor_offset(word, col, 64)] = pack_bf16(b[2 * word * 64 + col], b[(2 * word + 1) * 64 + col]);
  }
  fence_proxy_async();
  __syncthreads();
  const uint32_t af[4] = {pack_bf16(a[g * 16 + 2 * q], a[g * 16 + 2 * q + 1]),
                          pack_bf16(a[(g + 8) * 16 + 2 * q], a[(g + 8) * 16 + 2 * q + 1]),
                          pack_bf16(a[g * 16 + 2 * q + 8], a[g * 16 + 2 * q + 9]),
                          pack_bf16(a[(g + 8) * 16 + 2 * q + 8], a[(g + 8) * 16 + 2 * q + 9])};
  float acc[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[4 * j + 2 * h + e] = c[(g + 8 * h) * 64 + 8 * j + 2 * q + e];
  wgmma_fence();
  bf16x3::wgmma_m64n64k16(acc, af, kmajor_descriptor(bs, 64), 1);
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

// D = C + A B for `tiles` 16 x 8 x 16 tiles by mma.sync with bf16 operands;
// as bulklmm_probe_mma.
int bulklmm_probe_mma_bf16(const float* A, const float* B, const float* C, float* D, int tiles,
                           void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  probe_mma_bf16_kernel<<<tiles, 32, 0, static_cast<cudaStream_t>(stream)>>>(A, B, C, D, tiles);
  return (int)cudaGetLastError();
}

// D = C + A B for `tiles` 64 x 64 x 16 tiles by wgmma with bf16 operands; as
// bulklmm_probe_mma.
int bulklmm_probe_wgmma_bf16(const float* A, const float* B, const float* C, float* D, int tiles,
                             void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  probe_wgmma_bf16_kernel<<<tiles, 128, 0, static_cast<cudaStream_t>(stream)>>>(A, B, C, D,
                                                                               tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
