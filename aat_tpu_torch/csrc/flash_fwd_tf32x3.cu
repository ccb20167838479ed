// Flash-attention forward in f32 on Hopper's tensor cores as 3xTF32, dense
// or causal, with a key-padding mask, an optional row log-sum-exp and
// optional attention-probability dropout. This is the f32 route: bf16
// operands take flash_fwd_mma.cu.
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
//     seed + (b*heads_total + head_offset + h)*0x9e3779b9 (head_key; (H, 0)
//     keys the launch's own heads) is >= rate, scaling kept ones by
//     1/(1-rate) (flash_common.cuh's hash, tested as the integer compare
//     keep_bits of mma_common.cuh);
//   - GQA: q-head h reads kv-head h / (H / KVH);
//   - causal: key k is allowed for query q when k <= q and, with
//     pack_len > 0, k / pack_len == q / pack_len.
// The TPU's causal step tables become a loop bound: the key loop of a
// query block stops at min(S, q0 + 64), and the triangle select runs only
// on tiles that straddle the diagonal (or on every tile with pack_len).
//
// What bounds it on the H100: the two products, 4*T*S*D flops per head
// (half that causal). In full f32 they would run on the FFMA pipes at 67
// TFLOP/s; here each f32 product is three tf32 products on the tensor cores
// (mma_common.cuh: a = hi + lo, a·b = lo·hi + hi·lo + hi·hi), 495 / 3 = 165
// TFLOP/s of f32-accurate work, with the f32 sums' error and not TF32's
// (one-pass TF32 reads norm ratios of about 4e-4 against the 1e-4 f32
// bound in tests/test_torch_tf32x3.py). Memory (q, k, v, out once) is a
// tenth of that time at serving's [1,999,16,64].
// The design (the FlashAttention-2 pattern on mma.sync, as flash_fwd_mma.cu;
// wgmma and TMA are later work):
//   - A block of 4 warps owns 64 query rows of one (batch, head), 16 rows a
//     warp. Q stays in shared memory (swizzled in 16-byte chunks) and each
//     k-step's A fragment is loaded with ldmatrix, scaled and split in
//     registers: held split for the whole loop, Q alone would take 128
//     registers at D = 128, and kept split in shared memory it would take
//     64 KB there, leaving one block an SM.
//   - K and V stream through a 2-stage cp.async ring of 16-byte f32 chunks,
//     tiles of 64 keys at D = 64 and 32 at D = 128, so two blocks fit an SM
//     (83 and 97 KB of shared memory). K is swizzled like Q, and its B
//     fragments come from ldmatrix too: on 32-bit data a non-transposed
//     b16 ldmatrix gives exactly the tf32 fragments of a k-contiguous tile.
//   - S = Q·K^T and O += P·V run on mma.sync.m16n8k8 tf32 -> f32, three
//     products per fragment pair. P never leaves registers, but the tf32 A
//     layout is not the accumulator's: A column t4 is (g, t4) where the
//     accumulator holds keys 2·t4 and 2·t4 + 1 of row g. So A column t4
//     stands for key 2·t4 and column t4 + 4 for key 2·t4 + 1, and V's B
//     fragment is read in the same order (b0 = V[2·t4][n], b1 = V[2·t4 + 1]
//     [n]) with scalar shared loads, since ldmatrix transposes only b16. V
//     rows are padded to D + 4 floats, 4 banks mod 32, which makes those
//     loads conflict-free. The key mask, the causal select and the dropout
//     hash act on the accumulator fragment before the relabelling, with the
//     true key index.
//   - The tensor cores' f32 accumulation truncates: carried over all of S,
//     O would drift by about S/8 ulps. Each tile's P·V therefore sums from
//     zero, 8 columns of O at a time, and joins O in one f32 FMA per
//     element (alpha·O + tile), which rounds to nearest.
//   - The online softmax runs on the accumulator fragments in f32: the 4
//     lanes of a row combine their max with two shuffles, the row sum stays
//     per lane until the end; exponentials are ex2 with log2(e) folded in.
#include "mma_common.cuh"

namespace {

using namespace aat_flash;

constexpr int kBQ = 64;               // query rows of a block, 16 a warp
constexpr int kThreads = 32 * kBQ / 16;
constexpr int kStages = 2;            // the K/V ring

template <int D>
__host__ __device__ constexpr int tile_keys() {
  return D == 64 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr int v_pitch() {  // floats a V row: 4 banks past a multiple of 32
  return D + 4;
}

template <int D>
constexpr int smem_bytes() {
  return (int)(sizeof(float) * (kBQ * D + kStages * tile_keys<D>() * (D + v_pitch<D>())) +
               sizeof(int) * kStages * tile_keys<D>());
}

struct Tf32Args {
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

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, Tf32Args a) {
  constexpr int kBK = tile_keys<D>();
  constexpr int kVP = v_pitch<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);           // [kBQ][D]
  float* ks = qs + kBQ * D;                                 // [kStages][kBK][D]
  float* vs = ks + kStages * kBK * D;                       // [kStages][kBK][kVP]
  int* ms = reinterpret_cast<int*>(vs + kStages * kBK * kVP);  // [kStages][kBK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* kb = k + b * a.k_sb + hk * a.k_sh;
  const float* vb = v + b * a.v_sb + hk * a.v_sh;
  const int* mb = a.key_mask + b * a.s_len;
  const uint32_t seed_and_head = head_key(a.seed, b, a.heads_total, h);
  const int k_end = CAUSAL ? min(a.s_len, q0 + kBQ) : a.s_len;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    load_rows_f32_swz<D, kBK, kThreads>(ks + stage * kBK * D, kb, a.k_ss, k0, a.s_len, tid);
    load_rows_f32_padded<D, kBK, kThreads, kVP>(vs + stage * kBK * kVP, vb, a.v_ss, k0, a.s_len,
                                                tid);
    if (tid < kBK) {
      const bool ok = k0 + tid < a.s_len;
      cp_async4(smem_u32(ms + stage * kBK + tid), mb + (ok ? k0 + tid : 0), ok ? 4 : 0);
    }
  };

  load_rows_f32_swz<D, kBQ, kThreads>(qs, qb, a.q_st, q0, a.t_len, tid);
  cp_async_commit();  // group: Q
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();  // group: tile 0

  // lane owns rows g and g + 8 of the warp's 16, columns 2·t4 and 2·t4 + 1
  // of every 8-wide tile of the accumulators
  const int g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
    cp_async_commit();   // empty on the last tile, which keeps the count
    cp_async_wait<1>();  // Q and tile `it` have landed
    __syncthreads();
    const int k0 = it * kBK;
    const float* kt = ks + stage * kBK * D;
    const float* vt = vs + stage * kBK * kVP;
    const int* mt = ms + stage * kBK;

    // S = (Q·sm_scale)·K^T in 3xTF32: K rows are the columns of B
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t qf[4], q_hi[4], q_lo[4];
      ldsm_x4(smem_u32(qs + swz_f32<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4))), qf);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(qf[i]) * a.sm_scale, q_hi[i], q_lo[i]);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t kf[4], k_hi[2][2], k_lo[2][2];
        ldsm_x4(smem_u32(kt + swz_f32<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         kk * 2 + ((lane >> 3) & 1))),
                kf);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(kf[i]), k_hi[i >> 1][i & 1], k_lo[i >> 1][i & 1]);
        mma_3xtf32(s[2 * np], q_hi, q_lo, k_hi[0], k_lo[0]);
        mma_3xtf32(s[2 * np + 1], q_hi, q_lo, k_hi[1], k_lo[1]);
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

    // P in place, dropped by the hash of the true (row, key)
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p0 = ex2(fmaf(s[j][0], kLog2e, off_lo));
      float p1 = ex2(fmaf(s[j][1], kLog2e, off_lo));
      float p2 = ex2(fmaf(s[j][2], kLog2e, off_hi));
      float p3 = ex2(fmaf(s[j][3], kLog2e, off_hi));
      rs_lo += p0 + p1;  // the denominator sums the undropped p
      rs_hi += p2 + p3;
      if (a.keep_min != 0u) {
        const int c = k0 + 8 * j + 2 * t4;
        p0 = keep_bits(seed_and_head, row_lo, c, a.s_len, a.keep_min) ? p0 * a.inv_keep : 0.f;
        p1 = keep_bits(seed_and_head, row_lo, c + 1, a.s_len, a.keep_min) ? p1 * a.inv_keep : 0.f;
        p2 = keep_bits(seed_and_head, row_hi, c, a.s_len, a.keep_min) ? p2 * a.inv_keep : 0.f;
        p3 = keep_bits(seed_and_head, row_hi, c + 1, a.s_len, a.keep_min) ? p3 * a.inv_keep : 0.f;
      }
      s[j][0] = p0;
      s[j][1] = p1;
      s[j][2] = p2;
      s[j][3] = p3;
    }
    l_lo = alpha_lo * l_lo + rs_lo;
    l_hi = alpha_hi * l_hi + rs_hi;

    // O = alpha·O + P·V: k-step j covers keys 8j..8j+7 in the relabelled
    // order (A column t4 = key 2·t4, column t4 + 4 = key 2·t4 + 1). The
    // tensor cores' f32 accumulation truncates, so a sum carried across all
    // of S would drift by about S/8 ulps (5e-5 relative at 8,499 keys, half
    // the f32 bound): each tile's P·V accumulates from zero, 8 columns of O
    // at a time, and joins O in an f32 FMA that rounds to nearest.
#pragma unroll
    for (int d0 = 0; d0 < D / 8; d0 += 8) {
      float o[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t p_hi[4], p_lo[4];
        split_tf32(s[j][0], p_hi[0], p_lo[0]);  // (g, key 2·t4)
        split_tf32(s[j][2], p_hi[1], p_lo[1]);  // (g + 8, key 2·t4)
        split_tf32(s[j][1], p_hi[2], p_lo[2]);  // (g, key 2·t4 + 1)
        split_tf32(s[j][3], p_hi[3], p_lo[3]);  // (g + 8, key 2·t4 + 1)
        const float* vr = vt + (8 * j + 2 * t4) * kVP + 8 * d0 + g;
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          uint32_t v_hi[2], v_lo[2];
          split_tf32(vr[8 * dn], v_hi[0], v_lo[0]);        // V[2·t4][8·(d0 + dn) + g]
          split_tf32(vr[kVP + 8 * dn], v_hi[1], v_lo[1]);  // V[2·t4 + 1][8·(d0 + dn) + g]
          mma_3xtf32(o[dn], p_hi, p_lo, v_hi, v_lo);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[d0 + i][0] = fmaf(acc[d0 + i][0], alpha_lo, o[i][0]);
        acc[d0 + i][1] = fmaf(acc[d0 + i][1], alpha_lo, o[i][1]);
        acc[d0 + i][2] = fmaf(acc[d0 + i][2], alpha_hi, o[i][2]);
        acc[d0 + i][3] = fmaf(acc[d0 + i][3], alpha_hi, o[i][3]);
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
    float* o = out + ((b * a.t_len + row_lo) * a.n_heads + h) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(o + 8 * i) = make_float2(acc[i][0] * inv_lo, acc[i][1] * inv_lo);
    if (a.lse != nullptr && t4 == 0)
      a.lse[(b * a.n_heads + h) * a.t_len + row_lo] = m_lo + logf(lf_lo);
  }
  if (row_hi < a.t_len) {
    float* o = out + ((b * a.t_len + row_hi) * a.n_heads + h) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(o + 8 * i) = make_float2(acc[i][2] * inv_hi, acc[i][3] * inv_hi);
    if (a.lse != nullptr && t4 == 0)
      a.lse[(b * a.n_heads + h) * a.t_len + row_hi] = m_hi + logf(lf_hi);
  }
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, int B, const Tf32Args& a,
           cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3_kernel<D, CAUSAL>;
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_heads, (a.t_len + kBQ - 1) / kBQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q),
                                           static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<float*>(out),
                                           a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int causal,
             const Tf32Args& a, cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, out, B, a, stream)
                : launch<D, false>(q, k, v, out, B, a, stream);
}

}  // namespace

// q, k, v and out are f32, with strides in multiples of 4 elements and
// 16-byte-aligned starts (the wrapper checks). Returns cudaGetLastError()
// after the launch; 1 (cudaErrorInvalidValue) for a head width the kernel
// was not built for, or a value width DV other than D. `lse` may be null.
extern "C" int aat_flash_fwd_tf32x3(const void* q, const void* k, const void* v,
                                    const int* key_mask, void* out, float* lse, int B, int T_len,
                                    int S, int H, int KVH, int D, int DV, long long q_sb,
                                    long long q_st,
                                    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, float sm_scale,
                                    int causal, int pack_len, int seed, float rate, float inv_keep,
                                    int heads_total, int head_offset, cudaStream_t stream) {
  if (DV != D) return (int)cudaErrorInvalidValue;
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const Tf32Args a{key_mask, lse, T_len, S, H, KVH, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, sm_scale, pack_len, aat_flash::offset_seed(seed, head_offset),
                   aat_flash::keep_min(rate), inv_keep, heads_total};
  if (D == 64) return launch_d<64>(q, k, v, out, B, causal, a, stream);
  if (D == 128) return launch_d<128>(q, k, v, out, B, causal, a, stream);
  return (int)cudaErrorInvalidValue;
}
