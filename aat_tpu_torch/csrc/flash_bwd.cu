// Flash-attention backward in f32, dense or causal: dq, dk and dv from the
// saved row log-sum-exp, with the forward's key mask, dropout mask and
// causal / pack_len mask regenerated. This is the f32 route: bf16 operands
// take the tensor-core kernels of flash_bwd_mma.cu. Two kernels, each behind
// its own C entry:
//   - `aat_flash_bwd_dq`: a block owns 64 query rows of one (b, h) and loops
//     over key tiles (up to the diagonal when causal);
//   - `aat_flash_bwd_dkv`: a block owns 64 keys of one (b, h) and loops over
//     query tiles (from the diagonal when causal).
// Each computes delta = rowsum(dout · out) of its query rows itself, so the
// two are independent launches with the same inputs.
//
// Replaces, for f32, the TPU kernels of aat_tpu/ops/attention.py:
//   - key length S <= 8192 (`_FUSED_BWD_MAX_S` :831): :764
//     `_bwd_fused_kernel` (dense, launched by `_flash_backward` :982) and
//     :709 `_bwd_fused_tri_kernel` (causal, launched :941), which the
//     wrappers `flash_backward_kernel` / `flash_backward_causal_kernel`
//     cover with one launch of each kernel here;
//   - S > 8192: :562 `_bwd_dq_kernel` (launched :1068) and :595
//     `_bwd_dkv_kernel` (launched :1110), dense and causal, which the
//     wrappers `flash_backward_dq_long` / `flash_backward_dkv_long` cover
//     with one kernel each.
// The TPU needed the second pair because the fused kernels keep a whole
// [S, D] f32 dk/dv accumulator per batch·head in VMEM. These kernels keep no
// S-sized state at all, so one design serves every S.
//
// Inputs: q [B,T,H,D], k/v [B,S,KVH,D] through their strides, the forward's
// out and the incoming dout (contiguous [B,T,H,D]), lse [B,H,T] f32.
// Outputs: dq [B,T,H,D], and dk/dv per q-head [B,S,H,D]; the wrapper sums
// those over the H/KVH heads that share a kv head (GQA). Semantics kept
// from the TPU kernels (`_ds_block` :525):
//   - q is scaled by sm_scale, s = q_s·k;
//     dk = ds^T·q_s needs no further factor, dq = (ds·k)·sm_scale;
//   - p = exp(s - lse) from the undropped scores; masked scores are -2e30,
//     so masked keys, fully masked rows (lse == -1e30) and padded rows give
//     p == 0 and exactly zero gradients;
//   - delta = rowsum(dout · out) (`_delta128` :513, in-kernel as there);
//   - with dropout the position hash regenerates the forward's keep mask:
//     dv uses p·keep/(1-rate), dp is masked and scaled the same way, ds
//     uses the undropped p: ds = p·(dp - delta);
// Tensor offsets are 64-bit; the hash keeps the TPU's 32-bit q·S + k
// arithmetic (wraparound, which S <= 46340 never reaches).
//
// No atomics: deterministic. s and dp are recomputed in both kernels, so
// the backward does 14 T·S·D multiply-adds per head where the fused TPU
// kernel did 10.
//
// What bounds it on the H100: like the forward, every product runs on the
// FP32 FFMA pipes out of shared memory (<= 67 TFLOP/s, far below the
// tensor-core rate). 256 threads as 16 x 16 compute 4 x 4 score tiles
// (8 shared loads per 16 FFMAs per product) and 4 x D/16 output tiles;
// shared rows are padded by one float so the strided reads hit distinct
// banks.
#include "flash_common.cuh"

namespace {

using namespace aat_flash;

constexpr int kB = 64;          // query rows and keys per tile
constexpr int kThreads = 256;   // 16 x 16

struct BwdArgs {
  const int* key_mask;
  const float* lse;
  int t_len, s_len, n_heads, n_kv_heads;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float sm_scale;
  int pack_len;
  unsigned int seed;
  float rate, inv_keep;
};

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * kB * (D + 1) + kB * (kB + 1) + 3 * kB;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * kB * (D + 1) + 2 * kB * (kB + 1) + 3 * kB;
}

// Rows [r0, r0+kB) of a [*, T, *, D] tensor (strides rs per row) into
// shared [kB][D+1]; rows >= n are zero. SCALE folds sm_scale in (the
// forward's q_s).
template <int D, bool SCALE>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long rs,
                                          int r0, int n, float scale) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < n) {
      x = src[(r0 + r) * rs + d];
      if (SCALE) x *= scale;
    }
    dst[r * (D + 1) + d] = x;
  }
}

// delta = rowsum(dout · out) of query rows [q0, q0 + kB) into delta_s, four
// threads per row, dout from shared memory (dos, loaded and synchronised
// before) and out from device memory; 0 for rows past t_len.
template <int D>
__device__ __forceinline__ void row_delta(const float* dos, const float* ob, long long o_st,
                                          int q0, int t_len, float* delta_s) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  float sum = 0.f;
  if (q0 + r < t_len)
    for (int d = part; d < D; d += 4)
      sum = fmaf(dos[r * (D + 1) + d], ob[(q0 + r) * o_st + d], sum);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0) delta_s[r] = sum;
}

// s = q_s·k^T and dp = dout·v^T for this thread's 4 x 4 entries
// (rows ty + 16i, keys tx + 16j), then p and ds. Writes ds to dss and,
// when pvs is given, p·keep/(1-rate) to pvs.
template <int D, bool CAUSAL>
__device__ __forceinline__ void score_block(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* bias, const float* lse_s, const float* delta_s, float* dss,
    float* pvs, int q0, int k0, uint32_t seed_and_head, const BwdArgs& a) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
      dov[i] = dos[(ty + 16 * i) * (D + 1) + d];
      kv[i] = ks[(tx + 16 * i) * (D + 1) + d];
      vv[i] = vs[(tx + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
  const bool edge = CAUSAL && (a.pack_len > 0 || k0 + kB - 1 > q0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, q_pos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, k_pos = k0 + c;
      float sv = s[i][j] + bias[c];
      if (edge && !causal_allowed(q_pos, k_pos, a.pack_len)) sv = kMask;
      const float p = q_pos < a.t_len ? expf(sv - lse_s[r]) : 0.f;
      float pv = p, dpv = dp[i][j];
      if (a.rate > 0.f) {
        const bool kept = keep(seed_and_head, q_pos, k_pos, a.s_len, a.rate);
        pv = kept ? p * a.inv_keep : 0.f;
        dpv = kept ? dpv * a.inv_keep : 0.f;
      }
      dss[r * (kB + 1) + c] = p * (dpv - delta_s[r]);
      if (pvs != nullptr) pvs[r * (kB + 1) + c] = pv;
    }
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout, float* __restrict__ dq, BwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kB][D+1]
  float* dos = qs + kB * (D + 1);    // [kB][D+1]
  float* ks = dos + kB * (D + 1);    // [kB][D+1]
  float* vs = ks + kB * (D + 1);     // [kB][D+1]
  float* dss = vs + kB * (D + 1);    // [kB][kB+1]
  float* lse_s = dss + kB * (kB + 1);
  float* delta_s = lse_s + kB;
  float* bias = delta_s + kB;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const long long bh = b * a.n_heads + h;
  const uint32_t seed_and_head = a.seed + (uint32_t)bh * kGolden;
  const long long o_st = (long long)a.n_heads * D;  // out/dout/dq row stride
  const float* ob = out + b * a.t_len * o_st + h * D;
  const float* dob = dout + b * a.t_len * o_st + h * D;
  const float* kb = k + b * a.k_sb + hk * a.k_sh;
  const float* vb = v + b * a.v_sb + hk * a.v_sh;
  const int* mb = a.key_mask + b * a.s_len;

  load_rows<D, true>(qs, q + b * a.q_sb + h * a.q_sh, a.q_st, q0, a.t_len, a.sm_scale);
  load_rows<D, false>(dos, dob, o_st, q0, a.t_len, 0.f);
  for (int i = tid; i < kB; i += kThreads)
    lse_s[i] = q0 + i < a.t_len ? a.lse[bh * a.t_len + q0 + i] : 0.f;
  __syncthreads();
  row_delta<D>(dos, ob, o_st, q0, a.t_len, delta_s);  // read after the loop's barrier

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int k_end = CAUSAL ? min(a.s_len, q0 + kB) : a.s_len;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // previous tile's ks/dss no longer read
    load_rows<D, false>(ks, kb, a.k_ss, k0, a.s_len, 0.f);
    load_rows<D, false>(vs, vb, a.v_ss, k0, a.s_len, 0.f);
    for (int i = tid; i < kB; i += kThreads)
      bias[i] = (k0 + i < a.s_len && mb[k0 + i] > 0) ? 0.f : kMask;
    __syncthreads();
    score_block<D, CAUSAL>(qs, dos, ks, vs, bias, lse_s, delta_s, dss,
                           nullptr, q0, k0, seed_and_head, a);
    __syncthreads();
    for (int c = 0; c < kB; ++c) {  // dq += ds · k
      float dsv[4], kv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * (kB + 1) + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) kv[j] = ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= a.t_len) continue;
    float* row = dq + (b * a.t_len + t) * o_st + h * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) row[tx + 16 * j] = acc[i][j] * a.sm_scale;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ out,
                     const float* __restrict__ dout, float* __restrict__ dk,
                     float* __restrict__ dv, BwdArgs a) {
  extern __shared__ float smem[];
  float* ks = smem;                  // [kB][D+1]
  float* vs = ks + kB * (D + 1);     // [kB][D+1]
  float* qs = vs + kB * (D + 1);     // [kB][D+1]
  float* dos = qs + kB * (D + 1);    // [kB][D+1]
  float* pvs = dos + kB * (D + 1);   // [kB][kB+1]
  float* dss = pvs + kB * (kB + 1);  // [kB][kB+1]
  float* lse_s = dss + kB * (kB + 1);
  float* delta_s = lse_s + kB;
  float* bias = delta_s + kB;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const long long bh = b * a.n_heads + h;
  const uint32_t seed_and_head = a.seed + (uint32_t)bh * kGolden;
  const long long o_st = (long long)a.n_heads * D;
  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* ob = out + b * a.t_len * o_st + h * D;
  const float* dob = dout + b * a.t_len * o_st + h * D;
  const int* mb = a.key_mask + b * a.s_len;

  load_rows<D, false>(ks, k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, a.s_len, 0.f);
  load_rows<D, false>(vs, v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, a.s_len, 0.f);
  for (int i = tid; i < kB; i += kThreads)
    bias[i] = (k0 + i < a.s_len && mb[k0 + i] > 0) ? 0.f : kMask;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int q_begin = CAUSAL ? k0 : 0;  // query tiles above the diagonal see none of these keys
  for (int q0 = q_begin; q0 < a.t_len; q0 += kB) {
    __syncthreads();  // previous tile's qs/dos/pvs/dss no longer read
    load_rows<D, true>(qs, qb, a.q_st, q0, a.t_len, a.sm_scale);
    load_rows<D, false>(dos, dob, o_st, q0, a.t_len, 0.f);
    for (int i = tid; i < kB; i += kThreads)
      lse_s[i] = q0 + i < a.t_len ? a.lse[bh * a.t_len + q0 + i] : 0.f;
    __syncthreads();
    row_delta<D>(dos, ob, o_st, q0, a.t_len, delta_s);
    __syncthreads();
    score_block<D, CAUSAL>(qs, dos, ks, vs, bias, lse_s, delta_s, dss,
                           pvs, q0, k0, seed_and_head, a);
    __syncthreads();
    for (int r = 0; r < kB; ++r) {  // dv += p_v^T · dout, dk += ds^T · q_s
      float pv[4], dsv[4], dov[D / 16], qv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pvs[r * (kB + 1) + ty + 16 * i];
        dsv[i] = dss[r * (kB + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        dov[j] = dos[r * (D + 1) + tx + 16 * j];
        qv[j] = qs[r * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= a.s_len) continue;
    const long long off = ((b * a.s_len + s) * a.n_heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j];
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int D, bool CAUSAL>
struct Variant {
  static constexpr int width = D;
  static constexpr bool causal = CAUSAL;
};

// Calls f(Variant<D, CAUSAL>{}) for the run's head width and masking; 1
// (cudaErrorInvalidValue) for a head width the kernels were not built for.
template <typename F>
int dispatch(int D, int causal, F&& f) {
  if (D == 64) return causal ? f(Variant<64, true>{}) : f(Variant<64, false>{});
  if (D == 128) return causal ? f(Variant<128, true>{}) : f(Variant<128, false>{});
  return (int)cudaErrorInvalidValue;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// dq [B,T,H,D] f32. Returns cudaGetLastError() after the launch.
extern "C" int aat_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const int* key_mask, const void* out,
                                const void* dout, const float* lse, void* dq,
                                int B, int T_len, int S, int H,
                                int KVH, int D, long long q_sb, long long q_st,
                                long long q_sh, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, float sm_scale, int causal,
                                int pack_len, int seed, float rate,
                                float inv_keep, cudaStream_t stream) {
  if (B == 0 || T_len == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a{key_mask, lse, T_len, S, H, KVH,
                  q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  sm_scale, pack_len, (unsigned int)seed, rate, inv_keep};
  return dispatch(D, causal, [&](auto variant) {
    using V = decltype(variant);
    auto kernel = flash_bwd_dq_kernel<V::width, V::causal>;
    constexpr size_t smem = sizeof(float) * dq_smem_floats<V::width>();
    const int err = prepare(kernel, smem);
    if (err != 0) return err;
    const dim3 grid((T_len + kB - 1) / kB, H, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out),
        static_cast<const float*>(dout), static_cast<float*>(dq), a);
    return (int)cudaGetLastError();
  });
}

// dk, dv per q-head, f32 [B,S,H,D]. Returns cudaGetLastError() after the
// launch.
extern "C" int aat_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const int* key_mask, const void* out,
                                 const void* dout, const float* lse, float* dk,
                                 float* dv, int B, int T_len, int S, int H,
                                 int KVH, int D, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_ss,
                                 long long k_sh, long long v_sb, long long v_ss,
                                 long long v_sh, float sm_scale, int causal,
                                 int pack_len, int seed, float rate,
                                 float inv_keep, cudaStream_t stream) {
  if (B == 0 || T_len == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a{key_mask, lse, T_len, S, H, KVH,
                  q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  sm_scale, pack_len, (unsigned int)seed, rate, inv_keep};
  return dispatch(D, causal, [&](auto variant) {
    using V = decltype(variant);
    auto kernel = flash_bwd_dkv_kernel<V::width, V::causal>;
    constexpr size_t smem = sizeof(float) * dkv_smem_floats<V::width>();
    const int err = prepare(kernel, smem);
    if (err != 0) return err;
    const dim3 grid((S + kB - 1) / kB, H, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out),
        static_cast<const float*>(dout), dk, dv, a);
    return (int)cudaGetLastError();
  });
}
