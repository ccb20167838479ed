// Flash-attention forward in f32, dense or causal, with a key-padding mask,
// an optional row log-sum-exp and optional attention-probability dropout.
// This is the f32 route: bf16 operands take the tensor-core kernel of
// flash_fwd_mma.cu.
//
// Replaces, for f32, the TPU kernels aat_tpu/ops/attention.py:186
// `_fwd_kernel` (dense, launched by `_flash_forward` :471) and :245
// `_fwd_tri_kernel` (causal over the lower-triangle step tables `_tri_tables`
// :638, launched :418). q [B,T,H,D], k/v [B,S,KVH,D] read through their
// strides (no transpose around the call), key mask [B,S] int32 -> out
// [B,T,H,D] f32, lse [B,H,T] f32 when asked for (the backward's residual).
// Semantics kept exactly from the TPU kernels:
//   - sm_scale is folded into q (:346);
//   - masked keys score -2e30 and the running max starts at -1e30, so a
//     fully masked row gives exp() == 0 everywhere, an exact-zero output
//     and lse == -1e30;
//   - the normaliser sums the undropped probabilities, is floored at 1e-30
//     and applied as a reciprocal;
//   - dropout keeps a probability where the position hash of (q, k) under
//     seed + (b*H + h)*0x9e3779b9 is >= rate, scaling kept ones by
//     1/(1-rate) (flash_common.cuh);
//   - GQA: q-head h reads kv-head h / (H / KVH);
//   - causal: key k is allowed for query q when k <= q and, with
//     pack_len > 0, k / pack_len == q / pack_len.
// The TPU's causal step tables become a loop bound: the key loop of a
// query block stops at min(S, q0 + 32), and the triangle select runs only
// on tiles that straddle the diagonal (or on every tile with pack_len).
//
// What bounds it on the H100: scores and P @ V run on the FP32 FFMA pipes
// out of shared memory, so arithmetic (4*T*S*D flops per head, half that
// causal, at <= 67 TFLOP/s) and shared-memory bandwidth bound it. Its
// design: a block owns 32 query rows of one (batch, head); a loop over
// 64-key tiles inside the block replaces the TPU's sequential k grid axis,
// carrying the online-softmax state (row max, denominator, 64- or 128-wide
// accumulator) in registers. Four threads share a query row (scores: 16
// keys each; output: D/4 columns each) and combine row max and row sum with
// warp shuffles. Shared-memory rows are padded by one float so the strided
// reads hit distinct banks.
#include "flash_common.cuh"

namespace {

using namespace aat_flash;

constexpr int kBQ = 32;
constexpr int kBK = 64;
constexpr int kThreads = 128;  // 4 threads per query row

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1) + kBK);
}

struct FwdArgs {
  const int* key_mask;
  float* lse;  // nullptr: no residual
  int t_len, s_len, n_heads, n_kv_heads;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float sm_scale;
  int pack_len;
  unsigned int seed;
  float rate, inv_keep;  // rate 0: no dropout
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, FwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][D+1]
  float* ks = qs + kBQ * (D + 1);        // [kBK][D+1]
  float* vs = ks + kBK * (D + 1);        // [kBK][D]
  float* ps = vs + kBK * D;              // [kBQ][kBK+1]
  float* bias = ps + kBQ * (kBK + 1);    // [kBK]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* kb = k + b * a.k_sb + hk * a.k_sh;
  const float* vb = v + b * a.v_sb + hk * a.v_sh;
  const int* mb = a.key_mask + b * a.s_len;
  const uint32_t seed_and_head =
      a.seed + (uint32_t)(b * a.n_heads + h) * kGolden;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < a.t_len)
      x = qb[(q0 + r) * a.q_st + d] * a.sm_scale;
    qs[r * (D + 1) + d] = x;
  }

  const int row = tid / 4;   // query row within the tile
  const int lane = tid % 4;  // which quarter of keys / output columns
  const int q_pos = q0 + row;
  float m_i = kNegInf, l_i = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  const int k_end = CAUSAL ? min(a.s_len, q0 + kBQ) : a.s_len;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q loaded; previous tile's K/V no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int s = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (s < a.s_len) {
        kx = kb[s * a.k_ss + d];
        vx = vb[s * a.v_ss + d];
      }
      ks[c * (D + 1) + d] = kx;
      vs[c * D + d] = vx;
    }
    for (int i = tid; i < kBK; i += kThreads)
      bias[i] = (k0 + i < a.s_len && mb[k0 + i] > 0) ? 0.f : kMask;
    __syncthreads();

    // scores: one q value read from shared memory feeds 16 FMAs
    float sc[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j)
        sc[j] = fmaf(qv, ks[(lane + 4 * j) * (D + 1) + d], sc[j]);
    }
    const bool edge = CAUSAL && (a.pack_len > 0 || k0 + kBK - 1 > q0);
    float mx = kMask;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      sc[j] += bias[lane + 4 * j];
      if (edge && !causal_allowed(q_pos, k0 + lane + 4 * j, a.pack_len))
        sc[j] = kMask;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      float p = expf(sc[j] - m_new);
      rs += p;  // the denominator sums the undropped probabilities
      if (a.rate > 0.f)
        p = keep(seed_and_head, q_pos, k0 + lane + 4 * j, a.s_len, a.rate)
                ? p * a.inv_keep : 0.f;
      ps[row * (kBK + 1) + lane + 4 * j] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_i = alpha * l_i + rs;
    m_i = m_new;
    __syncwarp();  // a row's probabilities come from lanes of one warp

#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[row * (kBK + 1) + c];
#pragma unroll
      for (int i = 0; i < D / 4; ++i)
        acc[i] = fmaf(p, vs[c * D + lane + 4 * i], acc[i]);
    }
  }

  if (q_pos < a.t_len) {
    const float l = fmaxf(l_i, 1e-30f);
    const float inv = 1.0f / l;
    float* ob = out + ((b * a.t_len + q_pos) * a.n_heads + h) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) ob[lane + 4 * i] = acc[i] * inv;
    if (a.lse != nullptr && lane == 0)
      a.lse[(b * a.n_heads + h) * a.t_len + q_pos] = m_i + logf(l);
  }
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           const FwdArgs& a, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t_len + kBQ - 1) / kBQ, a.n_heads, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int causal, const FwdArgs& a, cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, out, B, a, stream)
                : launch<D, false>(q, k, v, out, B, a, stream);
}

}  // namespace

// f32 q, k, v and out. Returns cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for a head width the kernel was not built for.
// `lse` may be null.
extern "C" int aat_flash_fwd(const void* q, const void* k, const void* v,
                             const int* key_mask, void* out, float* lse, int B,
                             int T_len, int S, int H, int KVH, int D,
                             long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             float sm_scale, int causal, int pack_len, int seed,
                             float rate, float inv_keep, cudaStream_t stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const FwdArgs a{key_mask, lse, T_len, S, H, KVH,
                  q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  sm_scale, pack_len, (unsigned int)seed, rate, inv_keep};
  if (D == 64) return launch_d<64>(q, k, v, out, B, causal, a, stream);
  if (D == 128) return launch_d<128>(q, k, v, out, B, causal, a, stream);
  return (int)cudaErrorInvalidValue;
}
