// Float32-grade matrix products on Hopper's tensor cores: the 3 x TF32 split,
// the warp-level m16n8k8 product (mma.sync) with its fragment loads from
// depth-major shared tiles, the warpgroup-level 64 x 128 x 8 and 64 x 64 x 8
// products (wgmma) with their K-major tile and descriptor, and asynchronous
// tile copies. Device functions only, shared by the kernels of this directory.
// The split's product policy (Policy) and the warp-level product that takes
// a policy (warp_mma) live here too; mma_bf16x3.cuh holds the other policy,
// the bf16x3 split of the THROUGHPUT preset.
//
// The split. A float32 a is written as big + small with
// big = tf32(a) (cvt.rna: round to nearest on the 13 low mantissa bits, ties
// away from zero) and small = tf32(a - big); a - big is exact in float32.
// A product a * b is then taken as small_a * big_b + big_a * small_b +
// big_a * big_b, the small terms first, each an exact product of two 11-bit
// significands accumulated in float32 by the tensor core. The dropped
// small * small term is below 2^-22 |a b|, the size of float32's own
// rounding. Three tensor-core passes at 495 TFLOP/s give 165 TFLOP/s of
// float32-grade work, against 67 TFLOP/s on the CUDA cores.
//
// Tiles of the mma.sync product. Both operands lie in shared memory
// depth-major, tile[s][column], exactly as they lie in device memory (the
// contraction index s outermost), so nothing is transposed. With a row stride of 8
// modulo 32 floats the 4 depths x 8 column groups that one fragment load
// touches fall into 32 different banks. The columns of a warp's tile are
// dealt to the m16n8k8 fragments so that one thread's values are contiguous
// and load as one 128-bit word:
//
//   A side (16-row tiles i = 0..MT-1, MT even), fragment row r of tile i:
//       column 32 (i / 2) + 4 (r % 8) + 2 (i % 2) + r / 8
//   B side (8-column tiles j = 0..NT-1, NT 2 or 4), fragment column c:
//       column NT c + j
//
// a_column() and b_column() state the same maps for the epilogues, which
// work on the accumulator layout: thread (g = lane / 4, q = lane % 4) holds
// of tile (i, j) the elements acc[i][j][2 h + e] at fragment row g + 8 h and
// fragment column 2 q + e.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

// Row stride, in floats, of a shared tile that is `width` columns wide.
__host__ __device__ constexpr int padded_stride(int width) { return width + 8; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// split() in integer arithmetic: the same bits (round to nearest on the 13
// low mantissa bits, ties away from zero, is half a unit added to the
// magnitude and the low bits cut), for finite x. The conversion instruction
// runs at a fraction of the integer units' rate on this card, and the
// kernels that split every value they load take this form.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_by_bits(float x, uint32_t& big, uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

// c += a * b for one 16 x 8 x 8 tile; a row-major (16 x 8), b column-major
// (8 x 8), TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma_m16n8k8(float (&c)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Column, within a warp's A-side tile, of fragment row r (0..15) of 16-row tile i.
__device__ __forceinline__ int a_column(int i, int r) {
  return 32 * (i / 2) + 4 * (r % 8) + 2 * (i % 2) + r / 8;
}

// Column, within a warp's B-side tile, of fragment column c (0..7) of 8-column tile j.
template <int NT>
__device__ __forceinline__ int b_column(int j, int c) {
  return NT * c + j;
}

// NT contiguous floats from shared memory, as one load.
template <int NT>
__device__ __forceinline__ void load_vec(const float* ptr, float (&v)[NT]) {
  static_assert(NT == 2 || NT == 4, "two or four floats");
  if constexpr (NT == 4) {
    const float4 t = *reinterpret_cast<const float4*>(ptr);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(ptr);
    v[0] = t.x, v[1] = t.y;
  }
}

// The fragments of one depth-8 step of a warp's (16 MT) x (8 NT) product: both
// TF32 halves of both operands, in the m16n8k8 register layout.
template <int MT, int NT>
struct Fragments {
  uint32_t a_big[MT][4], a_small[MT][4], b_big[NT][2], b_small[NT][2];
};

// Loads one step's fragments from shared memory and splits them in registers
// (each element once per step and warp). A and B point at depth k0 of the
// two raw float32 tiles, at the warp's first column; lda and ldb are row
// strides in floats, 8 modulo 32, and both pointers are 16-byte aligned.
// g = lane / 4, q = lane % 4.
template <int MT, int NT>
__device__ __forceinline__ void load_fragments(Fragments<MT, NT>& f, const float* A, int lda,
                                               const float* B, int ldb, int g, int q) {
  static_assert(MT % 2 == 0, "A-side tiles come in pairs");
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // depths k0 + q and k0 + q + 4
    const float* arow = A + (q + 4 * h) * lda + 4 * g;
#pragma unroll
    for (int i2 = 0; i2 < MT / 2; ++i2) {
      float v[4];
      load_vec<4>(arow + 32 * i2, v);
      // fragment registers 2h (row g) and 2h + 1 (row g + 8) of tiles 2 i2, 2 i2 + 1
      split(v[0], f.a_big[2 * i2][2 * h], f.a_small[2 * i2][2 * h]);
      split(v[1], f.a_big[2 * i2][2 * h + 1], f.a_small[2 * i2][2 * h + 1]);
      split(v[2], f.a_big[2 * i2 + 1][2 * h], f.a_small[2 * i2 + 1][2 * h]);
      split(v[3], f.a_big[2 * i2 + 1][2 * h + 1], f.a_small[2 * i2 + 1][2 * h + 1]);
    }
    float vb[NT];
    load_vec<NT>(B + (q + 4 * h) * ldb + NT * g, vb);
#pragma unroll
    for (int j = 0; j < NT; ++j) split(vb[j], f.b_big[j][h], f.b_small[j][h]);
  }
}

// acc += A * B for one step's fragments, three TF32 passes: the small terms
// first, then the leading one, into a step sum that starts from zero, which
// is then added into acc rounded to nearest (__fadd_rn). The tensor cores
// finish each product's float32 sum by cutting it toward zero (the probe,
// accumulate_probe.cu), so a sum carried across the depth in the
// accumulator loses up to a unit in its last place at every step, always
// toward zero, at the result's full magnitude; here the cuts fall on one
// step's sum and the steps add up as float32 on the CUDA cores adds them.
// The A-side tiles go two at a time, so that the step sum takes 8 NT
// registers, not 4 MT NT.
template <int MT, int NT>
__device__ __forceinline__ void mma_fragments(float (&acc)[MT][NT][4], const Fragments<MT, NT>& f) {
  static_assert(MT % 2 == 0, "mma_fragments takes the A-side tiles two at a time");
#pragma unroll
  for (int i2 = 0; i2 < MT; i2 += 2) {
    float part[2][NT][4] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_m16n8k8(part[i][j], f.a_small[i2 + i], f.b_big[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_m16n8k8(part[i][j], f.a_big[i2 + i], f.b_small[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_m16n8k8(part[i][j], f.a_big[i2 + i], f.b_big[j]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i2 + i][j][r] = __fadd_rn(acc[i2 + i][j][r], part[i][j][r]);
  }
}

// --- warpgroup products ------------------------------------------------------
//
// wgmma runs asynchronously: four warps start one 64 x N x 8 product and go
// on while the tensor cores work, where mma.sync holds its warp's dispatch slot
// (on an H100 a kernel of mma.sync alone reached about half of the tensor
// cores' TF32 peak, and every other instruction of the warp came on top of
// that time). Its TF32
// form takes B from shared memory depth-contiguous ("K-major") only, so a
// tile that is to be the B operand is transposed when it is staged; A comes
// from registers in the m16n8k8 layout, warp w of the group holding rows
// 16 w .. 16 w + 15.

// Offset, in floats, of element (depth s, column c) of a K-major B tile
// without swizzle, `columns` wide: 8 x 4 core matrices (8 columns x 4
// depths, 128 bytes, a column's 4 depths contiguous), those of one depth
// group side by side.
__host__ __device__ constexpr int kmajor_offset(int s, int c, int columns) {
  return (s / 4) * (4 * columns) + (c / 8) * 32 + (c % 8) * 4 + s % 4;
}

// The shared-memory descriptor of such a tile's depth-8 step that starts at
// `ptr` (depth a multiple of 8, column a multiple of 8): start address, the
// byte offset between the step's two depth groups ("leading"), the byte
// offset between neighbouring groups of 8 columns ("stride"), no swizzle.
// A bf16 tile's depth-16 step has the same byte geometry (mma_bf16x3.cuh).
__device__ __forceinline__ uint64_t kmajor_descriptor(const void* ptr, int columns) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  const uint64_t leading = 16 * columns, stride = 128;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (leading >> 4) << 16 | (stride >> 4) << 32;
}

// Orders the warpgroup's earlier register and shared-memory writes before
// its next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most kPending of the warpgroup's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(kPending) : "memory");
}

// Makes shared-memory writes of ordinary stores visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Keeps the compiler from moving accumulators across an asynchronous product.
template <int kCount>
__device__ __forceinline__ void pin_registers(float (&d)[kCount]) {
#pragma unroll
  for (int i = 0; i < kCount; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = (scale_d ? d : 0) + a * b for a 64 x 128 x 8 tile. d: 64 registers a
// thread, element d[4 j + 2 h + e] at row 16 w + g + 8 h and column
// 8 j + 2 q + e (the m16n8k8 accumulator layout, 16 column tiles). a: this
// warp's m16n8k8 A fragment. desc_b: kmajor_descriptor() of the 8 x 128 step.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
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

// d = (scale_d ? d : 0) + a * b for a 64 x 64 x 8 tile: the narrow form of
// wgmma_m64n128k8(), 32 registers a thread in the same layout (8 column
// tiles), for kernels that keep several accumulator sets at once. desc_b:
// kmajor_descriptor() of the 8 x 64 step.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// --- the product policy ---------------------------------------------------------

// The product policy of this split, the template parameter that a kernel is
// instantiated for (bf16x3::Policy in mma_bf16x3.cuh is the other one):
// depth steps of 8 samples and their fragments, loaded and multiplied.
struct Policy {
  static constexpr int kStep = 8;
  template <int MT, int NT>
  using StepFragments = tf32x3::Fragments<MT, NT>;
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
    wgmma_m64n128k8(d, a, desc_b, scale_d);
  }
  static __device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
    wgmma_m64n64k8(d, a, desc_b, scale_d);
  }
};

// acc += A * B over `depth` samples (a multiple of P::kStep) of two shared
// tiles, with the products of policy P, software-pipelined: the fragments of
// step s + 1 are loaded and split while the tensor cores work on step s.
// Pointers and strides as load_fragments() takes them, at depth 0.
template <class P, int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const float* A, int lda,
                                         const float* B, int ldb, int depth, int g, int q) {
  typename P::template StepFragments<MT, NT> cur, next;
  P::template load<MT, NT>(cur, A, lda, B, ldb, g, q);
#pragma unroll 2
  for (int s = P::kStep; s < depth; s += P::kStep) {
    P::template load<MT, NT>(next, A + s * lda, lda, B + s * ldb, ldb, g, q);
    P::template mma<MT, NT>(acc, cur);
    cur = next;
  }
  P::template mma<MT, NT>(acc, cur);
}

// --- asynchronous copies -----------------------------------------------------

// Copies kBytes (4, 8 or 16) from device to shared memory without passing
// through registers; the bytes past src_bytes are written as zeros. Both
// addresses are aligned to kBytes.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* smem_dst, const float* src, int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"(dst), "l"(src), "n"(kBytes), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// The widest copy, in floats (4, 2 or 1), that every row of a row-major
// array with this base and row length allows; tiles start at multiples of 4.
inline int copy_width(const float* base, int row_length) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (a % 16 == 0 && row_length % 4 == 0) return 4;
  if (a % 8 == 0 && row_length % 2 == 0) return 2;
  return 1;
}

// Starts the copy of rows [r0, r0 + nrows) x columns [c0, c0 + kWidth) of the
// row-major (rows x cols) array src into dst[nrows][ldd], kVec floats a
// copy, spread over the block's threads. Elements past the array's edges
// arrive as zeros. c0, cols and the rows' addresses are multiples of kVec
// floats (copy_width()).
template <int kWidth, int kVec>
__device__ __forceinline__ void stage_tile_vec(float* dst, int ldd, const float* src, int rows,
                                               int cols, int r0, int c0, int nrows, int tid,
                                               int nthreads) {
  constexpr int kPerRow = kWidth / kVec;
  for (int e = tid; e < nrows * kPerRow; e += nthreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    const bool inside = r0 + r < rows && c0 + c < cols;
    const float* from = inside ? src + (size_t)(r0 + r) * cols + (c0 + c) : src;
    cp_async<4 * kVec>(dst + r * ldd + c, from, inside ? 4 * kVec : 0);
  }
}

template <int kWidth>
__device__ __forceinline__ void stage_tile(float* dst, int ldd, const float* src, int rows,
                                           int cols, int r0, int c0, int nrows, int vec, int tid,
                                           int nthreads) {
  if (vec == 4)
    stage_tile_vec<kWidth, 4>(dst, ldd, src, rows, cols, r0, c0, nrows, tid, nthreads);
  else if (vec == 2)
    stage_tile_vec<kWidth, 2>(dst, ldd, src, rows, cols, r0, c0, nrows, tid, nthreads);
  else
    stage_tile_vec<kWidth, 1>(dst, ldd, src, rows, cols, r0, c0, nrows, tid, nthreads);
}

}  // namespace tf32x3
