// Flash-attention backward on Hopper's tensor cores, bf16 operands, dense or
// causal: dq, dk and dv from the saved row log-sum-exp, with the forward's
// key mask, dropout mask and causal / pack_len mask regenerated. Two kernels,
// each behind its own C entry:
//   - `aat_flash_bwd_dq_mma`: a block owns 64 query rows of one (b, h) and
//     streams key tiles (up to the diagonal when causal);
//   - `aat_flash_bwd_dkv_mma`: a short rowsum kernel writes delta =
//     rowsum(dout · out) [B,H,T] f32 into a scratch the wrapper allocates,
//     then a block owns 64 keys of one (b, h) and streams query tiles (from
//     the diagonal when causal).
// The two entries take the same inputs and are independent launches, as the
// split route needs.
//
// Replaces, for bf16, the TPU kernels of aat_tpu/ops/attention.py: :764
// `_bwd_fused_kernel` and :709 `_bwd_fused_tri_kernel` (S <= 8192, one
// launch of each entry), :562 `_bwd_dq_kernel` and :595 `_bwd_dkv_kernel`
// (S > 8192, one entry each); f32 operands take flash_bwd_tf32x3.cu. It computes
// exactly what that file's note lists (`_ds_block` :525):
//   - q_s = round_bf16(q·sm_scale), s = q_s·k, with f32 accumulation;
//   - p = exp(s - lse) from the undropped scores; masked scores are -2e30,
//     so masked keys and dead rows (lse == -1e30) give p == 0; a padded
//     query row (>= T) reads lse = +1e30, which forces p == 0 there whatever
//     its (zero-filled) q and dout hold;
//   - dropout by the position hash of the absolute (query, key) positions:
//     dv uses p·keep/(1-rate), dp is masked and scaled the same way, and
//     ds = p·(dp - delta) uses the undropped p;
//   - p_v and ds are rounded to bf16 before each product;
//   - dq = (ds·k)·sm_scale in bf16; dk = ds^T·q_s and dv = p_v^T·dout per
//     q-head in f32 [B,S,H,D] (the wrapper sums the GQA heads and casts);
//   - GQA as h / (H / KVH); causal with pack_len; q/k/v through their
//     strides; out and dout contiguous [B,T,H,D].
// No atomics: deterministic.
//
// What bounds it on the H100 at the long-form shapes ([1,8540,16,128]
// causal, [1,8499,16,64] dense with dropout 0.1), per allowed (q, k) pair:
//   - tensor cores: 2·D flops for each of 3 products in dq (q·k, dout·v,
//     ds·k) and 4 in dk/dv (q·k, dout·v, p_v·dout, ds·q) at 989 TFLOP/s:
//     0.449 / 0.598 ms causal at D = 128;
//   - exponentials: one per pair in each kernel (MUFU, 16 a clock per SM);
//   - the dropout hash: about 10 integer operations per pair, 0.622 ms per
//     kernel at the dense shape (64 a clock per SM), which bounds both
//     kernels there.
// What the design does about each (the FlashAttention-2 backward on
// mma.sync; wgmma and TMA are later work):
//   - Every product runs on mma.sync.m16n8k16 bf16 -> f32. A warp owns 16
//     rows (dq: queries; dk/dv: keys), so no score leaves its warp. The
//     accumulator fragments of s and dp become p and ds in registers, and
//     rounded to bf16 they are the A operand of the next product (dq: ds·k;
//     dk/dv: p_v^T·dout and ds^T·q_s), with the other operand read by
//     ldmatrix.trans. Nothing round-trips through shared memory.
//   - The dk/dv kernel computes the transposed tiles s^T = k·q_s^T and
//     dp^T = v·dout^T, so its rows are keys: the hash's row is then the
//     fragment's column (the query) and its column the fragment's row.
//   - The streamed operand (dq: K, V and the key mask; dk/dv: q, dout, lse
//     and delta) goes through a 2-stage cp.async ring of 64-row tiles,
//     XOR-swizzled in 16-byte chunks as in flash_fwd_mma.cu, so the next
//     tile's copy runs under this tile's products. The resident operand (dq:
//     q_s and dout; dk/dv: k and v) is copied once; its fragments are
//     re-read with ldmatrix each tile, which keeps the accumulators (dq:
//     D/8 x 4; dk/dv: 2 x D/8 x 4) and the score tiles in registers at
//     D = 128. The dq kernel rounds q_s in registers; the dk/dv kernel, where
//     q_s is a B operand twice, scales and rounds each landed q tile once in
//     shared memory, in the same pass that turns lse into -lse·log2e.
//   - delta = rowsum(dout·out) is computed once per query row: in the dq
//     kernel from its dout tile, in the dk/dv entry by the rowsum kernel, so
//     no key block reads out again.
//   - Exponentials are ex2 with log2(e) folded into one FMA; the dropout
//     test is the integer compare hash >= ceil(rate·2^24)·2^8.
//   - Causal: a dq block's key loop stops at min(S, q0 + 64) and query
//     blocks launch in reverse; a dk/dv block's query loop starts at its
//     first key and key blocks launch in order, so the blocks with the most
//     tiles start first. The triangle / pack_len select runs only on tiles
//     that straddle the diagonal (every tile with pack_len).
//   - At D = 128 each kernel takes about 97 KB of shared memory, two blocks
//     an SM (`__launch_bounds__(128, 2)`).
//   - q and k may be wider than v (DQK, DV): multi-head latent attention's
//     (192, 128), causal. Each pair of products runs its k-steps to the wider
//     width, a step past the narrower one feeding only its own product; dq
//     and dk are DQK wide, dv and delta's rows DV. The streamed tiles take 32
//     rows there (dq_bk, dkv_bq), so dq's 192-wide and dk/dv's 320-wide
//     accumulators stay in registers and each kernel takes about 80 KB.
#include "mma_common.cuh"

namespace {

using namespace aat_flash;

constexpr int kBQ = 64;  // query rows of a dq block, and of a dk/dv query tile
constexpr int kBK = 64;  // keys of a dq key tile, and of a dk/dv block
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kStages = 2;     // the ring
constexpr float kPadLse = 1e30f;  // lse of a padded query row: p == 0 there

// q and k are DQK wide, v, out and dout DV wide. Past DQK = 128 (latent
// attention's 192) the streamed tiles take 32 rows, so the wider
// accumulators (dq: DQK; dk/dv: DQK + DV) and the score tiles still fit the
// registers and two blocks fit an SM.
template <int DQK>
__host__ __device__ constexpr int dq_bk() {
  return DQK > 128 ? 32 : kBK;
}

template <int DQK>
__host__ __device__ constexpr int dkv_bq() {
  return DQK > 128 ? 32 : kBQ;
}

template <int DQK, int DV>
constexpr int dq_smem_bytes() {
  return (int)(sizeof(bf16) * (kBQ * (DQK + DV) + kStages * dq_bk<DQK>() * (DQK + DV)) +
               sizeof(int) * kStages * dq_bk<DQK>());
}

template <int DQK, int DV>
constexpr int dkv_smem_bytes() {
  return (int)(sizeof(bf16) * (kBK * (DQK + DV) + kStages * dkv_bq<DQK>() * (DQK + DV)) +
               sizeof(float) * 2 * kStages * dkv_bq<DQK>());
}

// acc + the dot product of 8 bf16 pairs held as two 16-byte words
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y, float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ out,
                        const bf16* __restrict__ dout, bf16* __restrict__ dq, BwdArgs a) {
  constexpr int BK = dq_bk<DQK>();
  constexpr int DM = DQK > DV ? DQK : DV;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);             // [kBQ][DQK]
  bf16* dos = qs + kBQ * DQK;                               // [kBQ][DV]
  bf16* ks = dos + kBQ * DV;                                // [kStages][BK][DQK]
  bf16* vs = ks + kStages * BK * DQK;                       // [kStages][BK][DV]
  int* ms = reinterpret_cast<int*>(vs + kStages * BK * DV);  // [kStages][BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBQ;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const long long bh = b * a.n_heads + h;
  const long long o_st = (long long)a.n_heads * DV;  // out/dout row stride
  const bf16* ob = out + b * a.t_len * o_st + h * DV;
  const bf16* kb = k + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = v + b * a.v_sb + hk * a.v_sh;
  const int* mb = a.key_mask + b * a.s_len;
  const uint32_t seed_and_head = head_key(a.seed, b, a.heads_total, h);
  const int k_end = CAUSAL ? min(a.s_len, q0 + kBQ) : a.s_len;
  const int n_tiles = (k_end + BK - 1) / BK;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BK;
    load_rows<DQK, BK, kThreads>(ks + stage * BK * DQK, kb, a.k_ss, k0, a.s_len, tid);
    load_rows<DV, BK, kThreads>(vs + stage * BK * DV, vb, a.v_ss, k0, a.s_len, tid);
    if (tid < BK) {
      const bool ok = k0 + tid < a.s_len;
      cp_async4(smem_u32(ms + stage * BK + tid), mb + (ok ? k0 + tid : 0), ok ? 4 : 0);
    }
  };

  load_rows<DQK, kBQ, kThreads>(qs, q + b * a.q_sb + h * a.q_sh, a.q_st, q0, a.t_len, tid);
  load_rows<DV, kBQ, kThreads>(dos, dout + b * a.t_len * o_st + h * DV, o_st, q0, a.t_len, tid);
  cp_async_commit();  // group: q and dout
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

  // delta = rowsum(dout · out): lanes 2r and 2r + 1 sum half of row r each
  float delta_lo, delta_hi;
  {
    const int r = lane >> 1, half = lane & 1;
    float sum = 0.f;
    if (q0 + warp * 16 + r < a.t_len) {
      const bf16* orow = ob + (q0 + warp * 16 + r) * o_st;
#pragma unroll
      for (int n = 0; n < DV / 16; ++n) {
        const int c = half * (DV / 16) + n;
        sum = dot8(*reinterpret_cast<const uint4*>(orow + c * 8),
                   *reinterpret_cast<const uint4*>(dos + swz<DV>(warp * 16 + r, c)), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    delta_lo = __shfl_sync(0xffffffffu, sum, 2 * g);
    delta_hi = __shfl_sync(0xffffffffu, sum, 2 * (g + 8));
  }
  // -lse·log2e of the two rows, so p = ex2(s·log2e - lse·log2e) is one FMA
  const float nl_lo = -(row_lo < a.t_len ? a.lse[bh * a.t_len + row_lo] : kPadLse) * kLog2e;
  const float nl_hi = -(row_hi < a.t_len ? a.lse[bh * a.t_len + row_hi] : kPadLse) * kLog2e;

  float acc[DQK / 8][4];
#pragma unroll
  for (int i = 0; i < DQK / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
    cp_async_commit();  // empty on the last tile, which keeps the count
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();
    const int k0 = it * BK;
    const bf16* kt = ks + stage * BK * DQK;
    const bf16* vt = vs + stage * BK * DV;
    const int* mt = ms + stage * BK;

    // S = q_s·K^T (DQK deep) and dP = dout·V^T (DV deep): K and V rows are
    // the columns of B; a k-step past one width feeds only the other product
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      const bool on_k = kk < DQK / 16, on_v = kk < DV / 16;
      uint32_t df[4];
      if (on_v)
        ldsm_x4(smem_u32(dos + swz<DV>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4))), df);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int chunk = kk * 2 + ((lane >> 3) & 1);
        uint32_t kf[4], vf[4];
        if (on_k) ldsm_x4(smem_u32(kt + swz<DQK>(row, chunk)), kf);
        if (on_v) ldsm_x4(smem_u32(vt + swz<DV>(row, chunk)), vf);
        if (on_k) {
          mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
        if (on_v) {
          mma_bf16(dp[2 * np], df, vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], df, vf[2], vf[3]);
        }
      }
    }

    // p, the dropout of dp, ds = p·(dp - delta), rounded to bf16 as the A
    // operand of dS·K: accumulator tile j is half of k-step j / 2
    const bool edge = CAUSAL && (a.pack_len > 0 || k0 + BK - 1 > q0);
    uint32_t dsf[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float ds[4];
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
        const float p_lo = ex2(fmaf(lo, kLog2e, nl_lo));
        const float p_hi = ex2(fmaf(hi, kLog2e, nl_hi));
        float dp_lo = dp[j][e], dp_hi = dp[j][2 + e];
        if (a.keep_min != 0u) {
          dp_lo = keep_bits(seed_and_head, row_lo, k0 + c, a.s_len, a.keep_min)
                      ? dp_lo * a.inv_keep : 0.f;
          dp_hi = keep_bits(seed_and_head, row_hi, k0 + c, a.s_len, a.keep_min)
                      ? dp_hi * a.inv_keep : 0.f;
        }
        ds[e] = p_lo * (dp_lo - delta_lo);
        ds[2 + e] = p_hi * (dp_hi - delta_hi);
      }
      dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);      // row g
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);  // row g + 8
    }

    // dQ += dS·K: K rows are the rows of B, read with ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DQK / 16; ++dn) {
        uint32_t kf[4];
        ldsm_x4_trans(smem_u32(kt + swz<DQK>(kk * 16 + (lane & 15), dn * 2 + (lane >> 4))),
                      kf);
        mma_bf16(acc[2 * dn], dsf[kk], kf[0], kf[1]);
        mma_bf16(acc[2 * dn + 1], dsf[kk], kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

  if (row_lo < a.t_len) {
    bf16* o = dq + ((b * a.t_len + row_lo) * a.n_heads + h) * DQK + 2 * t4;
#pragma unroll
    for (int i = 0; i < DQK / 8; ++i)
      *reinterpret_cast<uint32_t*>(o + 8 * i) =
          pack_bf16(acc[i][0] * a.sm_scale, acc[i][1] * a.sm_scale);
  }
  if (row_hi < a.t_len) {
    bf16* o = dq + ((b * a.t_len + row_hi) * a.n_heads + h) * DQK + 2 * t4;
#pragma unroll
    for (int i = 0; i < DQK / 8; ++i)
      *reinterpret_cast<uint32_t*>(o + 8 * i) =
          pack_bf16(acc[i][2] * a.sm_scale, acc[i][3] * a.sm_scale);
  }
}

// delta[b, h, t] = rowsum(dout · out)[b, t, h] for rows of D bf16, D / 8
// lanes a row (one 16-byte chunk each)
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int t_len, int n_heads) {
  constexpr int kLanes = D / 8;
  const long long r = (long long)blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  float sum = 0.f;
  if (r < rows)
    sum = dot8(*reinterpret_cast<const uint4*>(out + r * D + c * 8),
               *reinterpret_cast<const uint4*>(dout + r * D + c * 8), 0.f);
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (r < rows && c == 0) {
    const long long bt = r / n_heads;  // b·T + t
    const int hh = (int)(r % n_heads);
    delta[((bt / t_len) * n_heads + hh) * t_len + bt % t_len] = sum;
  }
}

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, BwdArgs a) {
  constexpr int BQ = dkv_bq<DQK>();
  constexpr int DM = DQK > DV ? DQK : DV;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);                 // [kBK][DQK]
  bf16* vs = ks + kBK * DQK;                                    // [kBK][DV]
  bf16* qs = vs + kBK * DV;                                     // [kStages][BQ][DQK]
  bf16* dos = qs + kStages * BQ * DQK;                          // [kStages][BQ][DV]
  float* ls = reinterpret_cast<float*>(dos + kStages * BQ * DV);  // [kStages][BQ]
  float* dls = ls + kStages * BQ;                               // [kStages][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const long long bh = b * a.n_heads + h;
  const long long o_st = (long long)a.n_heads * DV;  // dout row stride
  const bf16* qb = q + b * a.q_sb + h * a.q_sh;
  const bf16* dob = dout + b * a.t_len * o_st + h * DV;
  const float* lb = a.lse + bh * a.t_len;
  const float* db = delta + bh * a.t_len;
  const uint32_t seed_and_head = head_key(a.seed, b, a.heads_total, h);
  // query tiles above the diagonal see none of these keys (BQ divides kBK)
  const int q_begin = CAUSAL ? k0 : 0;
  const int n_tiles = q_begin < a.t_len ? (a.t_len - q_begin + BQ - 1) / BQ : 0;

  auto load_q = [&](int tile, int stage) {
    const int q0 = q_begin + tile * BQ;
    load_rows<DQK, BQ, kThreads>(qs + stage * BQ * DQK, qb, a.q_st, q0, a.t_len, tid);
    load_rows<DV, BQ, kThreads>(dos + stage * BQ * DV, dob, o_st, q0, a.t_len, tid);
    if (2 * BQ == kThreads || tid < 2 * BQ) {
      const int i = tid & (BQ - 1);  // threads [0, BQ) copy lse, [BQ, 2·BQ) delta
      const bool ok = q0 + i < a.t_len;
      const float* src = (tid < BQ ? lb : db) + (ok ? q0 + i : 0);
      cp_async4(smem_u32((tid < BQ ? ls : dls) + stage * BQ + i), src, ok ? 4 : 0);
    }
  };

  load_rows<DQK, kBK, kThreads>(ks, k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, a.s_len, tid);
  load_rows<DV, kBK, kThreads>(vs, v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, a.s_len, tid);
  cp_async_commit();  // group: k and v
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();  // group: tile 0

  // lane owns keys g and g + 8 of the warp's 16 (the accumulator rows) and
  // queries 2·t4, 2·t4 + 1 of every 8-wide tile (the columns)
  const int g = lane >> 2, t4 = lane & 3;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const int* mb = a.key_mask + b * a.s_len;
  const bool valid_lo = key_lo < a.s_len && mb[key_lo] > 0;
  const bool valid_hi = key_hi < a.s_len && mb[key_hi] > 0;

  float dk_acc[DQK / 8][4], dv_acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (i < DQK / 8) dk_acc[i][e] = 0.f;
      if (i < DV / 8) dv_acc[i][e] = 0.f;
    }

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_q(it + 1, stage ^ 1);
    cp_async_commit();  // empty on the last tile, which keeps the count
    cp_async_wait<1>();  // tile `it` (and k, v) have landed
    __syncthreads();
    const int q0 = q_begin + it * BQ;
    bf16* qt = qs + stage * BQ * DQK;
    const bf16* dt = dos + stage * BQ * DV;
    float* lt = ls + stage * BQ;
    const float* dlt = dls + stage * BQ;

    // one pass over the landed tile: q -> round(q·sm_scale) (a B operand
    // twice), lse -> -lse·log2e (kPadLse past T, so p == 0 there)
    for (int i = tid; i < BQ * DQK / 8; i += kThreads) {
      uint4 w = reinterpret_cast<uint4*>(qt)[i];
      w.x = scale_round(w.x, a.sm_scale);
      w.y = scale_round(w.y, a.sm_scale);
      w.z = scale_round(w.z, a.sm_scale);
      w.w = scale_round(w.w, a.sm_scale);
      reinterpret_cast<uint4*>(qt)[i] = w;
    }
    if (tid < BQ) lt[tid] = -(q0 + tid < a.t_len ? lt[tid] : kPadLse) * kLog2e;
    __syncthreads();

    // S^T = K·q_s^T (DQK deep) and dP^T = V·dout^T (DV deep): q and dout rows
    // are the columns of B; a k-step past one width feeds only the other
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      const bool on_k = kk < DQK / 16, on_v = kk < DV / 16;
      const int a_row = warp * 16 + (lane & 15), a_chunk = kk * 2 + (lane >> 4);
      uint32_t kf[4], vf[4];
      if (on_k) ldsm_x4(smem_u32(ks + swz<DQK>(a_row, a_chunk)), kf);
      if (on_v) ldsm_x4(smem_u32(vs + swz<DV>(a_row, a_chunk)), vf);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int chunk = kk * 2 + ((lane >> 3) & 1);
        uint32_t qf[4], df[4];
        if (on_k) ldsm_x4(smem_u32(qt + swz<DQK>(row, chunk)), qf);
        if (on_v) ldsm_x4(smem_u32(dt + swz<DV>(row, chunk)), df);
        if (on_k) {
          mma_bf16(s[2 * np], kf, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], kf, qf[2], qf[3]);
        }
        if (on_v) {
          mma_bf16(dp[2 * np], vf, df[0], df[1]);
          mma_bf16(dp[2 * np + 1], vf, df[2], df[3]);
        }
      }
    }

    // p^T, p_v^T and dS^T, rounded to bf16 as the A operands of the next
    // products. The hash's row is the query (this fragment's column), its
    // column the key (this fragment's row).
    const bool edge = CAUSAL && (a.pack_len > 0 || q0 < k0 + kBK - 1);
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 nl = *reinterpret_cast<const float2*>(lt + c);
      const float2 dl = *reinterpret_cast<const float2*>(dlt + c);
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int query = q0 + c + e;
        const float nle = e ? nl.y : nl.x, dle = e ? dl.y : dl.x;
        float lo = valid_lo ? s[j][e] : kMask;
        float hi = valid_hi ? s[j][2 + e] : kMask;
        if (edge) {
          if (!causal_allowed(query, key_lo, a.pack_len)) lo = kMask;
          if (!causal_allowed(query, key_hi, a.pack_len)) hi = kMask;
        }
        const float p_lo = ex2(fmaf(lo, kLog2e, nle));
        const float p_hi = ex2(fmaf(hi, kLog2e, nle));
        float pv_lo = p_lo, pv_hi = p_hi, dp_lo = dp[j][e], dp_hi = dp[j][2 + e];
        if (a.keep_min != 0u) {
          const bool keep_lo = keep_bits(seed_and_head, query, key_lo, a.s_len, a.keep_min);
          const bool keep_hi = keep_bits(seed_and_head, query, key_hi, a.s_len, a.keep_min);
          pv_lo = keep_lo ? p_lo * a.inv_keep : 0.f;
          dp_lo = keep_lo ? dp_lo * a.inv_keep : 0.f;
          pv_hi = keep_hi ? p_hi * a.inv_keep : 0.f;
          dp_hi = keep_hi ? dp_hi * a.inv_keep : 0.f;
        }
        pv[e] = pv_lo;
        pv[2 + e] = pv_hi;
        ds[e] = p_lo * (dp_lo - dle);
        ds[2 + e] = p_hi * (dp_hi - dle);
      }
      pf[j >> 1][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);       // key g
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);   // key g + 8
      dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P_v^T·dout (DV wide) and dK += dS^T·q_s (DQK wide): dout and
    // q_s rows are the rows of B, read with ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < DM / 16; ++dn) {
        const bool on_v = dn < DV / 16, on_k = dn < DQK / 16;
        const int row = kk * 16 + (lane & 15), chunk = dn * 2 + (lane >> 4);
        uint32_t df[4], qf[4];
        if (on_v) ldsm_x4_trans(smem_u32(dt + swz<DV>(row, chunk)), df);
        if (on_k) ldsm_x4_trans(smem_u32(qt + swz<DQK>(row, chunk)), qf);
        if (on_v) {
          mma_bf16(dv_acc[2 * dn], pf[kk], df[0], df[1]);
          mma_bf16(dv_acc[2 * dn + 1], pf[kk], df[2], df[3]);
        }
        if (on_k) {
          mma_bf16(dk_acc[2 * dn], dsf[kk], qf[0], qf[1]);
          mma_bf16(dk_acc[2 * dn + 1], dsf[kk], qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();

  if (key_lo < a.s_len) {
    const long long row = (b * a.s_len + key_lo) * a.n_heads + h;
    const long long off_k = row * DQK + 2 * t4, off_v = row * DV + 2 * t4;
#pragma unroll
    for (int i = 0; i < DM / 8; ++i) {
      if (i < DQK / 8)
        *reinterpret_cast<float2*>(dk + off_k + 8 * i) = make_float2(dk_acc[i][0], dk_acc[i][1]);
      if (i < DV / 8)
        *reinterpret_cast<float2*>(dv + off_v + 8 * i) = make_float2(dv_acc[i][0], dv_acc[i][1]);
    }
  }
  if (key_hi < a.s_len) {
    const long long row = (b * a.s_len + key_hi) * a.n_heads + h;
    const long long off_k = row * DQK + 2 * t4, off_v = row * DV + 2 * t4;
#pragma unroll
    for (int i = 0; i < DM / 8; ++i) {
      if (i < DQK / 8)
        *reinterpret_cast<float2*>(dk + off_k + 8 * i) = make_float2(dk_acc[i][2], dk_acc[i][3]);
      if (i < DV / 8)
        *reinterpret_cast<float2*>(dv + off_v + 8 * i) = make_float2(dv_acc[i][2], dv_acc[i][3]);
    }
  }
}

}  // namespace

// aat_flash_bwd_dq's arguments without is_bf16: dq [B,T,H,D] bf16. q, k, v,
// out and dout are bf16 with 16-byte-aligned starts, q/k/v strides in
// multiples of 8 elements (the wrapper checks). Returns cudaGetLastError()
// after the launch.
extern "C" int aat_flash_bwd_dq_mma(const void* q, const void* k, const void* v,
                                    const int* key_mask, const void* out, const void* dout,
                                    const float* lse, void* dq, int B, int T_len, int S, int H,
                                    int KVH, int D, int DV, long long q_sb, long long q_st,
                                    long long q_sh, long long k_sb, long long k_ss,
                                    long long k_sh, long long v_sb, long long v_ss,
                                    long long v_sh, float sm_scale, int causal, int pack_len,
                                    int seed, float rate, float inv_keep, int heads_total,
                                    int head_offset, cudaStream_t stream) {
  if (B == 0 || T_len == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a{key_mask, lse, T_len, S, H, KVH, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                  v_sb, v_ss, v_sh, sm_scale, pack_len, aat_flash::offset_seed(seed, head_offset),
                  aat_flash::keep_min(rate), inv_keep, heads_total};
  return dispatch_mma(D, DV, causal, [&](auto variant) {
    using V = decltype(variant);
    auto kernel = flash_bwd_dq_mma_kernel<V::dqk, V::dv, V::causal>;
    constexpr int smem = dq_smem_bytes<V::dqk, V::dv>();
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(H, (T_len + kBQ - 1) / kBQ, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
        a);
    return (int)cudaGetLastError();
  });
}

// aat_flash_bwd_dkv's arguments without is_bf16, and `delta`, a [B,H,T] f32
// scratch the rowsum kernel fills: dk, dv per q-head, f32 [B,S,H,D]. The
// same operand rules as aat_flash_bwd_dq_mma. Returns cudaGetLastError()
// after the launches.
extern "C" int aat_flash_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                     const int* key_mask, const void* out, const void* dout,
                                     const float* lse, float* dk, float* dv, float* delta,
                                     int B, int T_len, int S, int H, int KVH, int D, int DV,
                                     long long q_sb, long long q_st, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     float sm_scale, int causal, int pack_len, int seed,
                                     float rate, float inv_keep, int heads_total, int head_offset,
                                     cudaStream_t stream) {
  if (B == 0 || T_len == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a{key_mask, lse, T_len, S, H, KVH, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                  v_sb, v_ss, v_sh, sm_scale, pack_len, aat_flash::offset_seed(seed, head_offset),
                  aat_flash::keep_min(rate), inv_keep, heads_total};
  return dispatch_mma(D, DV, causal, [&](auto variant) {
    using V = decltype(variant);
    constexpr int rows_per_block = 256 / (V::dv / 8);
    const long long rows = (long long)B * T_len * H;
    flash_bwd_delta_kernel<V::dv>
        <<<(unsigned int)((rows + rows_per_block - 1) / rows_per_block), 256, 0, stream>>>(
            static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, rows, T_len,
            H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    auto kernel = flash_bwd_dkv_mma_kernel<V::dqk, V::dv, V::causal>;
    constexpr int smem = dkv_smem_bytes<V::dqk, V::dv>();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(H, (S + kBK - 1) / kBK, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), delta, dk, dv, a);
    return (int)cudaGetLastError();
  });
}
