// The bf16x3 products of the THROUGHPUT preset on Hopper's tensor cores: the
// split of a float32 into two bf16 halves, the warp-level m16n8k16 product
// (mma.sync) with its fragment loads from depth-major shared tiles, the
// warpgroup-level 64 x 128 x 16 and 64 x 64 x 16 products (wgmma) with their
// K-major tiles, and the product policy (Policy) that a kernel is
// instantiated for beside tf32x3::Policy. Device functions only.
//
// The split. A float32 a is written as hi + lo with hi = bf16(a) and
// lo = bf16(a - hi), both rounded to nearest, ties to even, as a conversion
// to bfloat16 rounds in numpy, torch and JAX (cvt.rn; the TF32 split rounds
// ties away from zero, and that must not leak in here); a - hi is exact in
// float32 and hi + lo restores a within 2^-16 |a|. A product a * b is taken
// as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, the small terms first, each an
// exact product of two 8-bit significands accumulated in float32; the dropped
// lo_a * lo_b is below 2^-16 |a b|. This is the JAX package's HIGH on a TPU
// (pallas/altgrid_fused.py and pallas/bulkperm_fused.py split by hand the
// same way). Three bf16 passes at 989 TFLOP/s take half the tensor-core time
// of three TF32 passes, and the halves take half the shared memory.
//
// The depth order. A depth step is 16 samples. Thread (g, q) of the m16n8k16
// fragments holds the depth slots 2q, 2q + 1, 2q + 8 and 2q + 9, two to a
// register, the lower slot in the low half. The sum over a step does not
// depend on which sample sits in which slot, as long as both operands agree,
// so the slots are filled in the order
//
//     slot 2q -> sample q,  2q + 1 -> q + 4,  2q + 8 -> q + 8,  2q + 9 -> q + 12
//
// and a thread loads the samples q, q + 4, q + 8 and q + 12 of a step: the
// rows the TF32 fragments load in two steps of 8, with the same bank pattern
// (a stride of 8 modulo 32 floats). A K-major bf16 tile stores its samples in
// that order too: the 32-bit word of "word depth" w (kmajor_offset(w, c))
// holds samples sample_of_word(w) and sample_of_word(w) + 4 of column c. A
// depth step of 16 bf16 values is 32 bytes a column, as a TF32 step of 8, so
// the core matrices, the descriptor and the step offsets keep their bytes.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32x3.cuh"

namespace bf16x3 {

using tf32x3::load_vec;

// x0 and x1 rounded to bf16 and packed in one register, x0 in the low half.
// cvt.rn.bf16x2.f32 d, a, b puts a in the upper half.
__device__ __forceinline__ uint32_t round_pair(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// Both halves of x0 and x1, each pair packed as round_pair() packs it.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = round_pair(x0, x1);
  lo = round_pair(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// The first of the two samples of a K-major word at word depth w: w and w + 4
// of the same column hold samples w + (w & ~3) and that + 4 (the slot order).
__host__ __device__ constexpr int sample_of_word(int w) { return w + (w & ~3); }

// A fragment of 16 rows from the values of a thread in depth order:
// v[2 h + r] is sample s0 + 4 h (h = 0..3) of fragment row g + 8 r, where s0
// = step + q. Register 2 kh + r packs samples 8 kh + q and 8 kh + q + 4.
__device__ __forceinline__ void split_fragment(const float (&v)[8], uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      split_pair(v[4 * kh + r], v[4 * kh + 2 + r], hi[2 * kh + r], lo[2 * kh + r]);
}

// The leading halves alone.
__device__ __forceinline__ void round_fragment(const float (&v)[8], uint32_t (&hi)[4]) {
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int r = 0; r < 2; ++r) hi[2 * kh + r] = round_pair(v[4 * kh + r], v[4 * kh + 2 + r]);
}

// c += a * b for one 16 x 8 x 16 tile; a row-major (16 x 16), b column-major
// (16 x 8), bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The fragments of one depth-16 step of a warp's (16 MT) x (8 NT) product:
// both bf16 halves of both operands, in the m16n8k16 register layout.
template <int MT, int NT>
struct Fragments {
  uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[NT][2], b_lo[NT][2];
};

// Loads one step's fragments from shared memory and splits them in
// registers, as tf32x3::load_fragments() does for a step of 8 (the same
// pointers, strides, column maps a_column() and b_column(), and loads): the
// samples q and q + 4 of each half step, packed into one register.
template <int MT, int NT>
__device__ __forceinline__ void load_fragments(Fragments<MT, NT>& f, const float* A, int lda,
                                               const float* B, int ldb, int g, int q) {
  static_assert(MT % 2 == 0, "A-side tiles come in pairs");
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {  // samples 8 kh + q and 8 kh + q + 4
    const float* arow = A + (8 * kh + q) * lda + 4 * g;
#pragma unroll
    for (int i2 = 0; i2 < MT / 2; ++i2) {
      float v[4], w[4];
      load_vec<4>(arow + 32 * i2, v);
      load_vec<4>(arow + 4 * lda + 32 * i2, w);
      // registers 2 kh (row g) and 2 kh + 1 (row g + 8) of tiles 2 i2, 2 i2 + 1
      split_pair(v[0], w[0], f.a_hi[2 * i2][2 * kh], f.a_lo[2 * i2][2 * kh]);
      split_pair(v[1], w[1], f.a_hi[2 * i2][2 * kh + 1], f.a_lo[2 * i2][2 * kh + 1]);
      split_pair(v[2], w[2], f.a_hi[2 * i2 + 1][2 * kh], f.a_lo[2 * i2 + 1][2 * kh]);
      split_pair(v[3], w[3], f.a_hi[2 * i2 + 1][2 * kh + 1], f.a_lo[2 * i2 + 1][2 * kh + 1]);
    }
    float vb[NT], wb[NT];
    load_vec<NT>(B + (8 * kh + q) * ldb + NT * g, vb);
    load_vec<NT>(B + (8 * kh + q + 4) * ldb + NT * g, wb);
#pragma unroll
    for (int j = 0; j < NT; ++j) split_pair(vb[j], wb[j], f.b_hi[j][kh], f.b_lo[j][kh]);
  }
}

// acc += A * B for one step's fragments, three bf16 passes: the small terms
// first, then the leading one.
template <int MT, int NT>
__device__ __forceinline__ void mma_fragments(float (&acc)[MT][NT][4], const Fragments<MT, NT>& f) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_m16n8k16(acc[i][j], f.a_lo[i], f.b_hi[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_m16n8k16(acc[i][j], f.a_hi[i], f.b_lo[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_m16n8k16(acc[i][j], f.a_hi[i], f.b_hi[j]);
}

// --- warpgroup products ------------------------------------------------------
//
// The bf16 forms of tf32x3::wgmma_m64n128k8() and wgmma_m64n64k8(): A from
// registers in the m16n8k16 layout (split_fragment()), B from a K-major bf16
// tile in shared memory by descriptor (kmajor_descriptor() of the step's
// first word; "tnspB" 0: B is K-major), the same accumulator layout.

// d = (scale_d ? d : 0) + a * b for a 64 x 128 x 16 tile.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d = (scale_d ? d : 0) + a * b for a 64 x 64 x 16 tile.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// --- the product policy ---------------------------------------------------------

// The product policy of this split: depth steps of 16 samples.
struct Policy {
  static constexpr int kStep = 16;
  template <int MT, int NT>
  using StepFragments = bf16x3::Fragments<MT, NT>;
  template <int MT, int NT>
  static __device__ __forceinline__ void load(StepFragments<MT, NT>& f, const float* A, int lda,
                                              const float* B, int ldb, int g, int q) {
    load_fragments<MT, NT>(f, A, lda, B, ldb, g, q);
  }
  template <int MT, int NT>
  static __device__ __forceinline__ void mma(float (&acc)[MT][NT][4],
                                             const StepFragments<MT, NT>& f) {
    mma_fragments<MT, NT>(acc, f);
  }
  static __device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
    wgmma_m64n128k16(d, a, desc_b, scale_d);
  }
  static __device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
    wgmma_m64n64k16(d, a, desc_b, scale_d);
  }
};

}  // namespace bf16x3
