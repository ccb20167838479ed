// Shared by every flash-attention kernel (flash_bwd.cu and, through
// mma_common.cuh, flash_fwd_mma.cu, flash_fwd_tf32x3.cu and flash_bwd_mma.cu):
// the masking constants and the attention-dropout position hash, so the
// backward regenerates exactly the forward's keep mask.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aat_flash {

constexpr float kMask = -2e30f;    // masked score
constexpr float kNegInf = -1e30f;  // running-max floor: exp(kMask - kNegInf) == 0
constexpr uint32_t kGolden = 0x9e3779b9u;

// murmur3 finalizer; uint32 arithmetic gives the bits of the TPU kernel's
// int32 wraparound with logical shifts (aat_tpu/ops/attention.py:106)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  return x ^ (x >> 16);
}

// Keep decision for score (q_pos, k_pos) of one batch·head
// (`_keep_from_positions`, :115): seed_and_head = seed + (b·H + h)·golden,
// positions absolute, s_stride the unpadded key length.
__device__ __forceinline__ bool keep(uint32_t seed_and_head, int q_pos,
                                     int k_pos, int s_stride, float rate) {
  const uint32_t x = (uint32_t)q_pos * (uint32_t)s_stride + (uint32_t)k_pos;
  const float u = (float)(mix32(x ^ seed_and_head) >> 8) * (1.0f / 16777216.0f);
  return u >= rate;
}

// Score mask of the causal path: the triangle and, with pack_len > 0, the
// block-diagonal same-utterance constraint (`_causal_mask`, :152).
__device__ __forceinline__ bool causal_allowed(int q_pos, int k_pos, int pack_len) {
  if (k_pos > q_pos) return false;
  return pack_len <= 0 || (q_pos / pack_len == k_pos / pack_len);
}

}  // namespace aat_flash
