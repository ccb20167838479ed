// Dense (non-causal) flash-attention forward with a key-padding mask.
//
// Replaces the TPU kernel aat_tpu/ops/attention.py:186 `_fwd_kernel`
// (non-causal, launched by `_flash_forward` :471). q [B,T,H,D], k/v
// [B,S,KVH,D] read through their strides (no transpose around the call),
// key mask [B,S] int32 -> out [B,T,H,D] in the input dtype. f32 or bf16
// inputs, f32 accumulation. (The row log-sum-exp the backward needs is
// added with the backward kernel.) Semantics kept exactly from the TPU kernel:
//   - sm_scale is folded into q and rounded to the input dtype (:346);
//   - masked keys score -2e30 and the running max starts at -1e30, so a
//     fully masked row gives exp() == 0 everywhere and an exact-zero output;
//   - the normaliser is floored at 1e-30 and applied as a reciprocal;
//   - probabilities are rounded to v's dtype before P @ V (bf16 path);
//   - GQA: q-head h reads kv-head h / (H / KVH).
// Train-mode dropout (the position hash) is not part of this kernel.
//
// What bounds it on the H100: this first version runs scores and P @ V on
// the FP32 FFMA pipes out of shared memory, so arithmetic (4*T*S*D flops
// per head at <= 67 TFLOP/s) and shared-memory bandwidth bound it, far
// below the tensor-core rate. Its design: a block owns 32 query rows of one
// (batch, head); a loop over 64-key tiles inside the block replaces the
// TPU's sequential k grid axis, carrying the online-softmax state (row max,
// denominator, 64- or 128-wide accumulator) in registers. Four threads
// share a query row (scores: 16 keys each; output: D/4 columns each) and
// combine row max and row sum with warp shuffles. Shared-memory rows are
// padded by one float so the strided reads hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;
constexpr int kBK = 64;
constexpr int kThreads = 128;  // 4 threads per query row
constexpr float kMask = -2e30f;
constexpr float kNegInf = -1e30f;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1) + kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ key_mask,
                 T* __restrict__ out, int t_len,
                 int s_len, int n_heads, int n_kv_heads, long long q_sb,
                 long long q_st, long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                 float sm_scale) {
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
  const int hk = h / (n_heads / n_kv_heads);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int* mb = key_mask + b * s_len;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < t_len)
      x = Cvt<T>::round(Cvt<T>::load(qb[(q0 + r) * q_st + d]) * sm_scale);
    qs[r * (D + 1) + d] = x;
  }

  const int row = tid / 4;   // query row within the tile
  const int lane = tid % 4;  // which quarter of keys / output columns
  float m_i = kNegInf, l_i = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < s_len; k0 += kBK) {
    __syncthreads();  // q loaded; previous tile's K/V no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int s = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (s < s_len) {
        kx = Cvt<T>::load(kb[s * k_ss + d]);
        vx = Cvt<T>::load(vb[s * v_ss + d]);
      }
      ks[c * (D + 1) + d] = kx;
      vs[c * D + d] = vx;
    }
    for (int i = tid; i < kBK; i += kThreads)
      bias[i] = (k0 + i < s_len && mb[k0 + i] > 0) ? 0.f : kMask;
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
    float mx = kMask;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      sc[j] += bias[lane + 4 * j];
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = expf(sc[j] - m_new);
      rs += p;  // the denominator sums the unrounded probabilities
      ps[row * (kBK + 1) + lane + 4 * j] = Cvt<T>::round(p);
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

  const int t = q0 + row;
  if (t < t_len) {
    const float inv = 1.0f / fmaxf(l_i, 1e-30f);
    T* ob = out + ((b * t_len + t) * n_heads + h) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) ob[lane + 4 * i] = Cvt<T>::store(acc[i] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* key_mask,
           void* out, int B, int T_len, int S, int H, int KVH,
           long long q_sb, long long q_st, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_mask, static_cast<T*>(out), T_len, S,
      H, KVH, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head width the kernel was not built for.
extern "C" int aat_flash_fwd(const void* q, const void* k, const void* v,
                             const int* key_mask, void* out, int is_bf16,
                             int B, int T_len, int S, int H, int KVH, int D, long long q_sb, long long q_st,
                             long long q_sh, long long k_sb, long long k_ss,
                             long long k_sh, long long v_sb, long long v_ss,
                             long long v_sh, float sm_scale,
                             cudaStream_t stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
#define AAT_FLASH_ARGS                                                       \
  q, k, v, key_mask, out, B, T_len, S, H, KVH, q_sb, q_st, q_sh, k_sb, \
      k_ss, k_sh, v_sb, v_ss, v_sh, sm_scale, stream
  if (D == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(AAT_FLASH_ARGS)
                   : launch<float, 64>(AAT_FLASH_ARGS);
  if (D == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(AAT_FLASH_ARGS)
                   : launch<float, 128>(AAT_FLASH_ARGS);
#undef AAT_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
