// Flash-attention forward on Hopper's tensor cores, bf16 operands: dense or
// causal, with a key-padding mask, an optional row log-sum-exp and optional
// attention-probability dropout.
//
// Replaces, for bf16, the TPU kernels aat_tpu/ops/attention.py:186
// `_fwd_kernel` (dense) and :245 `_fwd_tri_kernel` (causal); f32 operands
// take flash_fwd_tf32x3.cu. It computes exactly what that file's note lists:
// q·sm_scale rounded to bf16 and f32 accumulation; masked keys at -2e30 with
// the running max floored at -1e30, so a dead row gives exact zeros and
// lse == -1e30; a denominator over the undropped, unrounded probabilities;
// dropout by the position hash of flash_common.cuh, the kept probabilities
// scaled by 1/(1-rate) and rounded to bf16 before P·V; GQA as h / (H / KVH);
// causal with pack_len; q/k/v read through their strides; lse [B,H,T] f32
// when asked for.
//
// What bounds it on the H100 at the long-form shapes ([1,8499,16,64] dense
// with dropout 0.1, [1,8540,16,128] causal):
//   - tensor cores: 2.96e11 (dense) and 2.99e11 (causal) FLOP at 989 TFLOP/s
//     bf16, 0.30 ms each;
//   - exponentials: one MUFU ex2 per score, 1.16e9 dense, 0.28 ms at 16 a
//     clock per SM;
//   - the dropout hash: about 10 integer operations per score, about 0.7 ms
//     at 64 a clock per SM, the largest of the three with dropout on;
//   - memory: 17 MB read and written, 5 us.
// What the design does about each (the FlashAttention-2 pattern on
// mma.sync; wgmma and TMA are later work):
//   - A block of 4 warps owns 64 query rows of one (batch, head), 16 rows a
//     warp, so a warp never exchanges scores with another. Q is copied to
//     shared memory once, loaded into registers with ldmatrix, scaled and
//     rounded there.
//   - K and V stream in tiles of 64 keys through a 2-stage cp.async ring
//     (16-byte copies; the next tile's copy runs under this tile's
//     products). Rows are XOR-swizzled in 16-byte chunks (chunk ^ row % 8),
//     so the 8 rows an ldmatrix reads hit 8 distinct bank groups. At
//     D = 128 the ring and Q take 80 KB, two blocks an SM.
//   - q and k may be wider than v (DQK, DV): multi-head latent attention
//     scores 192 columns (128 + 64 rotary) and reads 128-wide values. Q·K^T
//     then runs 12 k-steps, P·V and the accumulators stay 128 wide, and Q and
//     the rings take 104.5 KB, still two blocks an SM.
//   - S = Q·K^T and O += P·V run on mma.sync.m16n8k16 bf16 -> f32. P never
//     leaves registers: the m16n8 accumulator fragment of S is the A
//     fragment of P·V once rounded to bf16, and V is read with
//     ldmatrix.trans.
//   - The online softmax runs on the accumulator fragments: the 4 lanes of a
//     row combine their max with two shuffles, the row sum stays per lane
//     until the end. Exponentials are ex2 with log2(e) folded into one FMA.
//   - The dropout test compares hash >= ceil(rate·2^24)·2^8 as integers,
//     which is (hash >> 8) >= ceil(rate·2^24) without the shift and
//     bit-identical to the float test ((hash >> 8)·2^-24 is exact in f32).
//     The threshold is computed once on the host, so no int-to-float
//     conversion runs per score.
//   - Causal: the key loop of a query block stops at min(S, q0 + 64), the
//     triangle and pack_len select runs only on the tile that straddles the
//     diagonal (on every tile with pack_len), and the grid puts heads on x
//     and query blocks on y in reverse, so the longest blocks start first.
#include "mma_common.cuh"

namespace {

using namespace aat_flash;

constexpr int kBQ = 64;               // query rows of a block, 16 a warp
constexpr int kBK = 64;               // keys of one K/V tile
constexpr int kThreads = 32 * kBQ / 16;
constexpr int kStages = 2;            // the K/V ring

// Q and the K ring are DQK wide, the V ring DV wide
template <int DQK, int DV>
constexpr int smem_bytes() {
  return (int)(sizeof(bf16) * (kBQ * DQK + kStages * kBK * (DQK + DV)) +
               sizeof(int) * kStages * kBK);
}

struct MmaArgs {
  const int* key_mask;
  float* lse;  // nullptr: no residual
  int t_len, s_len, n_heads, n_kv_heads;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float sm_scale;
  int pack_len;
  unsigned int seed;
  unsigned int keep_min;  // 0: no dropout; else keep where hash >= keep_min
  float inv_keep;
  int heads_total;  // head_key's heads of a batch row
};

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, MmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // [kBQ][DQK]
  bf16* ks = qs + kBQ * DQK;                               // [kStages][kBK][DQK]
  bf16* vs = ks + kStages * kBK * DQK;                     // [kStages][kBK][DV]
  int* ms = reinterpret_cast<int*>(vs + kStages * kBK * DV);  // [kStages][kBK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const bf16* qb = q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = k + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = v + b * a.v_sb + hk * a.v_sh;
  const int* mb = a.key_mask + b * a.s_len;
  const uint32_t seed_and_head = head_key(a.seed, b, a.heads_total, h);
  const int k_end = CAUSAL ? min(a.s_len, q0 + kBQ) : a.s_len;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    load_rows<DQK, kBK, kThreads>(ks + stage * kBK * DQK, kb, a.k_ss, k0, a.s_len, tid);
    load_rows<DV, kBK, kThreads>(vs + stage * kBK * DV, vb, a.v_ss, k0, a.s_len, tid);
    if (tid < kBK) {
      const bool ok = k0 + tid < a.s_len;
      cp_async4(smem_u32(ms + stage * kBK + tid), mb + (ok ? k0 + tid : 0), ok ? 4 : 0);
    }
  };

  load_rows<DQK, kBQ, kThreads>(qs, qb, a.q_st, q0, a.t_len, tid);
  cp_async_commit();  // group: Q
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();  // group: tile 0
  cp_async_wait<1>();
  __syncthreads();

  // A fragments of this warp's 16 rows of q·sm_scale, rounded to bf16
  uint32_t qf[DQK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    ldsm_x4(smem_u32(qs + swz<DQK>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4))), qf[kk]);
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[kk][i] = scale_round(qf[kk][i], a.sm_scale);
  }

  // lane owns rows g and g + 8 of the warp's 16, columns 2·t4 and 2·t4 + 1
  // of every 8-wide tile of the accumulators
  const int g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
    cp_async_commit();  // empty on the last tile, which keeps the count
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();
    const int k0 = it * kBK;
    const bf16* kt = ks + stage * kBK * DQK;
    const bf16* vt = vs + stage * kBK * DV;
    const int* mt = ms + stage * kBK;

    // S = Q·K^T: K rows are the columns of B, read without transpose
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(kt + swz<DQK>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     kk * 2 + ((lane >> 3) & 1))),
                kf);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // key padding, then the triangle / pack_len select where it can bite
    const bool edge = CAUSAL && (a.pack_len > 0 || k0 + kBK - 1 > q0);
    float mx_lo = kMask, mx_hi = kMask;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const bool valid = mt[c] > 0;
        float lo = valid ? s[j][e] : kMask;
        float hi = valid ? s[j][2 + e] : kMask;
        if (edge) {
          if (!causal_allowed(row_lo, k0 + c, a.pack_len)) lo = kMask;
          if (!causal_allowed(row_hi, k0 + c, a.pack_len)) hi = kMask;
        }
        s[j][e] = lo;
        s[j][2 + e] = hi;
        mx_lo = fmaxf(mx_lo, lo);
        mx_hi = fmaxf(mx_hi, hi);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float alpha_lo = ex2((m_lo - mn_lo) * kLog2e);
    const float alpha_hi = ex2((m_hi - mn_hi) * kLog2e);
    m_lo = mn_lo;
    m_hi = mn_hi;
    const float off_lo = -mn_lo * kLog2e, off_hi = -mn_hi * kLog2e;

    // P in bf16 as the A operand of P·V: the accumulator tile of keys
    // 8j..8j+7 is half of the A fragment of k-step j / 2
    uint32_t pf[kBK / 16][4];
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p0 = ex2(fmaf(s[j][0], kLog2e, off_lo));
      float p1 = ex2(fmaf(s[j][1], kLog2e, off_lo));
      float p2 = ex2(fmaf(s[j][2], kLog2e, off_hi));
      float p3 = ex2(fmaf(s[j][3], kLog2e, off_hi));
      rs_lo += p0 + p1;  // the denominator sums the undropped, unrounded p
      rs_hi += p2 + p3;
      if (a.keep_min != 0u) {
        const int c = k0 + 8 * j + 2 * t4;
        p0 = keep_bits(seed_and_head, row_lo, c, a.s_len, a.keep_min) ? p0 * a.inv_keep : 0.f;
        p1 = keep_bits(seed_and_head, row_lo, c + 1, a.s_len, a.keep_min) ? p1 * a.inv_keep : 0.f;
        p2 = keep_bits(seed_and_head, row_hi, c, a.s_len, a.keep_min) ? p2 * a.inv_keep : 0.f;
        p3 = keep_bits(seed_and_head, row_hi, c + 1, a.s_len, a.keep_min) ? p3 * a.inv_keep : 0.f;
      }
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);      // row g
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
    }
    l_lo = alpha_lo * l_lo + rs_lo;
    l_hi = alpha_hi * l_hi + rs_hi;

    // O = alpha·O + P·V: V rows are the rows of B, read with ldmatrix.trans
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      acc[i][0] *= alpha_lo;
      acc[i][1] *= alpha_lo;
      acc[i][2] *= alpha_hi;
      acc[i][3] *= alpha_hi;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(smem_u32(vt + swz<DV>(kk * 16 + (lane & 15), dp * 2 + (lane >> 4))), vf);
        mma_bf16(acc[2 * dp], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float lf_lo = fmaxf(l_lo, 1e-30f), lf_hi = fmaxf(l_hi, 1e-30f);
  const float inv_lo = 1.0f / lf_lo, inv_hi = 1.0f / lf_hi;
  if (row_lo < a.t_len) {
    bf16* o = out + ((b * a.t_len + row_lo) * a.n_heads + h) * DV + 2 * t4;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(o + 8 * i) = pack_bf16(acc[i][0] * inv_lo, acc[i][1] * inv_lo);
    if (a.lse != nullptr && t4 == 0)
      a.lse[(b * a.n_heads + h) * a.t_len + row_lo] = m_lo + logf(lf_lo);
  }
  if (row_hi < a.t_len) {
    bf16* o = out + ((b * a.t_len + row_hi) * a.n_heads + h) * DV + 2 * t4;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(o + 8 * i) = pack_bf16(acc[i][2] * inv_hi, acc[i][3] * inv_hi);
    if (a.lse != nullptr && t4 == 0)
      a.lse[(b * a.n_heads + h) * a.t_len + row_hi] = m_hi + logf(lf_hi);
  }
}

template <int DQK, int DV, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, int B, const MmaArgs& a,
           cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<DQK, DV, CAUSAL>;
  constexpr int smem = smem_bytes<DQK, DV>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_heads, (a.t_len + kBQ - 1) / kBQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(q),
                                           static_cast<const bf16*>(k),
                                           static_cast<const bf16*>(v), static_cast<bf16*>(out), a);
  return (int)cudaGetLastError();
}

}  // namespace

// aat_flash_fwd_tf32x3's arguments; q, k, v and out are bf16, with
// strides in multiples of 8 elements and 16-byte-aligned starts (the wrapper
// checks); D is the width of q and k, DV that of v and out. Returns
// cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue) for widths
// the kernel was not built for (flash_common.cuh dispatch_mma).
extern "C" int aat_flash_fwd_mma(const void* q, const void* k, const void* v,
                                 const int* key_mask, void* out, float* lse, int B, int T_len,
                                 int S, int H, int KVH, int D, int DV, long long q_sb,
                                 long long q_st,
                                 long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh, float sm_scale,
                                 int causal, int pack_len, int seed, float rate, float inv_keep,
                                 int heads_total, int head_offset, cudaStream_t stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const MmaArgs a{key_mask, lse, T_len, S, H, KVH, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                  v_sb, v_ss, v_sh, sm_scale, pack_len, aat_flash::offset_seed(seed, head_offset),
                  aat_flash::keep_min(rate), inv_keep, heads_total};
  return dispatch_mma(D, DV, causal, [&](auto variant) {
    using V = decltype(variant);
    return launch<V::dqk, V::dv, V::causal>(q, k, v, out, B, a, stream);
  });
}
