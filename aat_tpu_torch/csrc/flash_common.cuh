// Shared by every flash-attention kernel (through mma_common.cuh:
// flash_fwd_mma.cu, flash_fwd_tf32x3.cu, flash_bwd_mma.cu and
// flash_bwd_tf32x3.cu):
// the masking constants and the attention-dropout position hash, so the
// backward regenerates exactly the forward's keep mask, and the backward
// kernels' arguments and head-width dispatch.
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

// The dropout hash's key of one head: seed + (b·heads_total + head_offset +
// h)·golden, with h the launch's q-head. heads_total is the number of heads
// of a batch row the masks are keyed on and head_offset the place of the
// launch's head 0 among them; (H, 0) keys the launch on its own heads, and a
// tensor-parallel head shard passes its global place, so it draws one
// device's masks. The C entries fold head_offset·golden into the seed
// (offset_seed) and the kernels add (b·heads_total + h)·golden (head_key):
// the same bits, and the kernels' code as fast as with the launch's own
// heads (an offset kept apart in the arguments slowed the causal bf16
// forward at D = 128 by 40% on an H100, chip_smoke.ab_flash_entries).
inline unsigned int offset_seed(int seed, int head_offset) {
  return (unsigned int)seed + (unsigned int)head_offset * kGolden;
}

__device__ __forceinline__ uint32_t head_key(uint32_t seed, long long b, int heads_total,
                                             int h) {
  return seed + (uint32_t)(b * heads_total + h) * kGolden;
}

// Score mask of the causal path: the triangle and, with pack_len > 0, the
// block-diagonal same-utterance constraint (`_causal_mask`, :152).
__device__ __forceinline__ bool causal_allowed(int q_pos, int k_pos, int pack_len) {
  if (k_pos > q_pos) return false;
  return pack_len <= 0 || (q_pos / pack_len == k_pos / pack_len);
}

// The backward kernels' arguments after their tensors (flash_bwd_mma.cu,
// flash_bwd_tf32x3.cu)
struct BwdArgs {
  const int* key_mask;
  const float* lse;
  int t_len, s_len, n_heads, n_kv_heads;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float sm_scale;
  int pack_len;
  unsigned int seed;
  unsigned int keep_min;  // 0: no dropout; else keep where hash >= keep_min
  float inv_keep;
  int heads_total;  // head_key's heads of a batch row
};

template <int D, bool CAUSAL>
struct Variant {
  static constexpr int width = D;
  static constexpr bool causal = CAUSAL;
};

// Calls f(Variant<D, CAUSAL>{}) for the run's head width and masking; 1
// (cudaErrorInvalidValue) for a head width the kernels were not built for.
// The 3xTF32 kernels take one width for q, k and v (DV == D).
template <typename F>
int dispatch(int D, int DV, int causal, F&& f) {
  if (DV != D) return (int)cudaErrorInvalidValue;
  if (D == 64) return causal ? f(Variant<64, true>{}) : f(Variant<64, false>{});
  if (D == 128) return causal ? f(Variant<128, true>{}) : f(Variant<128, false>{});
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernels' widths: DQK of q and k, DV of v (and of out, dout).
// Multi-head latent attention (DeepSeek-V2) scores 128 + 64 rotary columns
// and reads 128-wide values: (192, 128), causal only.
template <int DQK, int DV, bool CAUSAL>
struct MmaVariant {
  static constexpr int dqk = DQK;
  static constexpr int dv = DV;
  static constexpr bool causal = CAUSAL;
};

// Calls f(MmaVariant<DQK, DV, CAUSAL>{}) for the run's widths and masking;
// 1 (cudaErrorInvalidValue) for widths the kernels were not built for.
template <typename F>
int dispatch_mma(int DQK, int DV, int causal, F&& f) {
  if (DQK == 64 && DV == 64)
    return causal ? f(MmaVariant<64, 64, true>{}) : f(MmaVariant<64, 64, false>{});
  if (DQK == 128 && DV == 128)
    return causal ? f(MmaVariant<128, 128, true>{}) : f(MmaVariant<128, 128, false>{});
  if (DQK == 192 && DV == 128 && causal) return f(MmaVariant<192, 128, true>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace aat_flash
