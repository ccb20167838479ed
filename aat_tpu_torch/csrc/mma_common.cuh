// Shared by the tensor-core kernels (flash_fwd_mma.cu, flash_bwd_mma.cu,
// flash_fwd_tf32x3.cu, flash_bwd_tf32x3.cu and vq.cu) and, for its cp.async
// copies, by mel.cu: cp.async copies, ldmatrix, mma.sync m16n8k16 bf16 ->
// f32 and m16n8k8 tf32 -> f32 with the 3xTF32 split, the XOR swizzle of
// shared tiles and the row loaders into them, and the dropout keep test as
// an integer compare.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t4 = lane % 4): the
// A fragment (16 x 16, row-major) holds rows g and g + 8, columns 2·t4, +1
// and 2·t4 + 8, +9 as a[0] (g, low columns), a[1] (g + 8, low), a[2] (g,
// high), a[3] (g + 8, high); the accumulator (16 x 8) holds rows g and g + 8,
// columns 2·t4 and 2·t4 + 1. So two accumulator tiles of 8 columns, rounded
// to bf16, are the A fragment of one 16-deep k-step: the C -> A reuse that
// keeps probabilities in registers.
#pragma once

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace aat_flash {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes == 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a·b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: an f32 product on the tf32 tensor cores at f32 accuracy. Each
// operand splits as a = hi + lo, hi = tf32(a) and lo = tf32(a - hi) (a - hi
// is exact in f32), and a·b is taken as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b,
// the two small terms first; only lo·lo (about 2^-22 of |a·b|) is left out.
// tf32 products are exact in f32, so the error is that of the f32 sums; the
// tensor cores' f32 accumulation truncates, so a kernel sums a few k-steps
// from zero at a time and joins them in f32 adds that round to nearest.
//
// Fragment layouts of mma.sync.m16n8k8 .tf32 (g = lane / 4, t4 = lane % 4):
// A (16 x 8, row-major) holds a[0] (g, t4), a[1] (g + 8, t4), a[2] (g,
// t4 + 4), a[3] (g + 8, t4 + 4); B (8 x 8, column-major) b0 (row t4, column
// g) and b1 (row t4 + 4, column g); the accumulator (16 x 8) c[0] (g, 2·t4),
// c[1] (g, 2·t4 + 1), c[2] (g + 8, 2·t4), c[3] (g + 8, 2·t4 + 1). On 32-bit
// data ldmatrix.x4 (b16, not transposed) gives each lane element (lane / 4,
// lane % 4) of four 8 x 4 matrices: exactly the A fragment of a row-major
// tile, and two B fragments of a tile stored n-major (k contiguous).

// round to tf32, to nearest with ties away from zero; the 13 low bits of
// the result are unspecified, and the tensor cores ignore them
__device__ __forceinline__ uint32_t cvt_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi is the tf32 value itself (low bits cleared), so x - hi is exact
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = cvt_tf32(x) & 0xffffe000u;
  lo = cvt_tf32(x - __uint_as_float(hi));
}

// c += a·b for one m16n8k8 tile of tf32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32, from the split fragments of a and b
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// round(x·scale) to bf16 for both halves of a bf16x2
__device__ __forceinline__ uint32_t scale_round(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// float offset of 16-byte chunk `chunk` of row `row` in a swizzled f32 tile
// of W floats a row (W / 4 >= 8 chunks)
template <int W>
__device__ __forceinline__ int swz_f32(int row, int chunk) {
  return row * W + ((chunk ^ (row & 7)) << 2);
}

// rows [row0, row0 + ROWS) of a [rows, D] bf16 matrix with row stride
// `stride` into a swizzled tile, by THREADS threads; rows at or past n_valid
// become zeros
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride,
                                          int row0, int n_valid, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < n_valid;
    const bf16* g = src + (ok ? (long long)(row0 + r) * stride : 0ll) + c * 8;
    cp_async16(smem_u32(dst + swz<D>(r, c)), g, ok ? 16 : 0);
  }
}

// rows [row0, row0 + ROWS) of an f32 [rows, D] matrix with row stride
// `stride` into a tile swizzled in 16-byte chunks, by THREADS threads; rows
// at or past n_valid become zeros
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_f32_swz(float* dst, const float* src, long long stride,
                                                  int row0, int n_valid, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < n_valid;
    const float* g = src + (ok ? (long long)(row0 + r) * stride : 0ll) + c * 4;
    cp_async16(smem_u32(dst + swz_f32<D>(r, c)), g, ok ? 16 : 0);
  }
}

// the same into a tile of PITCH floats a row, not swizzled
template <int D, int ROWS, int THREADS, int PITCH>
__device__ __forceinline__ void load_rows_f32_padded(float* dst, const float* src,
                                                     long long stride, int row0, int n_valid,
                                                     int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int n = 0; n < ROWS * kChunks / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < n_valid;
    const float* g = src + (ok ? (long long)(row0 + r) * stride : 0ll) + c * 4;
    cp_async16(smem_u32(dst + r * PITCH + c * 4), g, ok ? 16 : 0);
  }
}

// The keep decision for score (q_pos, k_pos) of one batch·head
// (`_keep_from_positions`, :115; seed_and_head = head_key(...),
// positions absolute, s_stride the unpadded key length) as an integer
// compare: u = (hash >> 8)·2^-24 >= rate  <=>  (hash >> 8) >=
// ceil(rate·2^24)  <=>  hash >= keep_min with keep_min = ceil(rate·2^24)·2^8
// (rate·2^24 is exact in f32, and rate < 1, which the wrappers check, keeps
// it below 2^32).
__device__ __forceinline__ bool keep_bits(uint32_t seed_and_head, int q_pos, int k_pos,
                                          int s_stride, uint32_t keep_min) {
  const uint32_t x = (uint32_t)q_pos * (uint32_t)s_stride + (uint32_t)k_pos;
  return mix32(x ^ seed_and_head) >= keep_min;
}

// keep_min of keep_bits on the host; 0 means no dropout
inline unsigned int keep_min(float rate) {
  return rate > 0.f ? (unsigned int)ceilf(rate * 16777216.0f) << 8 : 0u;
}

}  // namespace aat_flash
