// Flash-attention backward in f32 on Hopper's tensor cores as 3xTF32, dense
// or causal: dq, dk and dv from the saved row log-sum-exp, with the forward's
// key mask, dropout mask and causal / pack_len mask regenerated. This is the
// f32 route: bf16 operands take flash_bwd_mma.cu. Two kernels, each behind
// its own C entry:
//   - `aat_flash_bwd_dq_tf32x3`: a block owns 64 query rows of one (b, h)
//     and streams key tiles (up to the diagonal when causal);
//   - `aat_flash_bwd_dkv_tf32x3`: a short rowsum kernel writes delta =
//     rowsum(dout · out) [B,H,T] f32 into a scratch the wrapper allocates,
//     then a block owns 64 keys of one (b, h) and streams query tiles (from
//     the diagonal when causal).
// The two entries take the same inputs and are independent launches, as the
// split route needs.
//
// Replaces, for f32, the TPU kernels of aat_tpu/ops/attention.py: :764
// `_bwd_fused_kernel` and :709 `_bwd_fused_tri_kernel` (S <= 8192, one
// launch of each entry), :562 `_bwd_dq_kernel` and :595 `_bwd_dkv_kernel`
// (S > 8192, one entry each). It computes (`_ds_block` :525):
//   - q_s = q·sm_scale in f32, with no bf16 rounding anywhere; s = q_s·k;
//   - p = exp(s - lse) from the undropped scores; masked scores are -2e30,
//     so masked keys and dead rows (lse == -1e30) give p == 0; a padded
//     query row (>= T) reads lse = +1e30, which forces p == 0 there;
//   - dropout by the position hash of the absolute (query, key) positions:
//     dv = (p·keep/(1-rate))^T·dout, dp is masked and scaled the same way,
//     and ds = p·(dp - delta) uses the undropped p;
//   - dq = (ds·k)·sm_scale; dk = ds^T·q_s and dv per q-head in f32
//     [B,S,H,D] (the wrapper sums the GQA heads);
//   - GQA as h / (H / KVH); causal with pack_len, exact zeros on dead rows;
//     q/k/v through their strides; out and dout contiguous [B,T,H,D].
// No atomics: deterministic.
//
// What bounds it on the H100: the matrix products, 2·D flops per allowed
// (q, k) pair for each of 3 products in dq (q·k, dout·v, ds·k) and 4 in
// dk/dv (q·k, dout·v, p_v·dout, ds·q). In full f32 they would run on the
// FFMA pipes at 67 TFLOP/s; here each is three tf32 products on the tensor
// cores (mma_common.cuh: a = hi + lo, a·b = lo·hi + hi·lo + hi·hi), 495 / 3
// = 165 TFLOP/s of f32-accurate work: 2.42 ms dq and 3.23 ms dk/dv at
// [1,8499,16,64] with dropout 0.1, 0.112 ms for both at [2,999,16,64].
// What the design does about it (the FlashAttention-2 backward on mma.sync
// m16n8k8 tf32, with flash_bwd_mma.cu's structure; wgmma is later work):
//   - A warp owns 16 rows (dq: queries; dk/dv: keys), so no score leaves its
//     warp. The dk/dv kernel computes the transposed tiles s^T = k·q_s^T and
//     dp^T = v·dout^T, so its rows are keys: the hash's row is then the
//     fragment's column (the query) and its column the fragment's row.
//   - The accumulator fragments of s and dp become p and ds in registers,
//     and are the A operand of the next product (dq: ds·k; dk/dv:
//     p_v^T·dout and ds^T·q_s). The tf32 A layout is not the accumulator's,
//     so A column t4 stands for key (or query) 2·t4 and column t4 + 4 for
//     2·t4 + 1, and the B operand is read in that order. The key mask, the
//     causal select and the hash act on the accumulator fragment, with the
//     true indices, before the relabelling.
//   - The resident operand (dq: q and dout; dk/dv: k and v) is copied once
//     into a tile swizzled in 16-byte chunks; each k-step's A fragment is
//     loaded with ldmatrix and split in registers (held split for the whole
//     loop, it would take D registers an operand).
//   - The streamed operand (dq: K, V and the key mask; dk/dv: q, dout, lse
//     and delta) goes through a 2-stage cp.async ring of 32-row tiles with
//     rows padded to D + 4 floats. Each streamed tile is a B operand of two
//     products (K of s and of ds·k; q_s of s^T and of ds^T·q_s, dout of dp^T
//     and p_v^T·dout; V of dp), read by all 4 warps, so it is split once as
//     it lands, by the whole block: hi in place of the copy (q scaled first)
//     and lo into a tile beside it. The warps then read hi and lo words with
//     scalar shared loads, which the D + 4 pitch keeps free of bank
//     conflicts in both orientations (rows g, columns t4: banks 4g + t4;
//     rows 2·t4 (+1), columns g: banks 8·t4 (+4) + g); ldmatrix.trans exists
//     only for b16.
//   - The three products of each fragment pair run as three passes over the
//     tile's independent accumulators (all lo·hi, then all hi·lo, then all
//     hi·hi), so consecutive mma.sync never wait on one another.
//   - The tensor cores' f32 accumulation truncates: each tile's ds·k,
//     p_v^T·dout and ds^T·q_s sums from zero and joins dq, dv and dk in f32
//     adds that round to nearest; s and dp sum over D from zero anyway.
//   - delta = rowsum(dout·out) is computed once per query row: in the dq
//     kernel from its dout tile, in the dk/dv entry by the rowsum kernel.
//     out is read with 4-byte loads, so it may start anywhere.
//   - Exponentials are ex2 with log2(e) folded into one FMA; the dropout
//     test is the integer compare hash >= ceil(rate·2^24)·2^8.
//   - Causal: a dq block's key loop stops at min(S, q0 + 64) and query
//     blocks launch in reverse; a dk/dv block's query loop starts at its
//     first key, so the blocks with the most tiles start first. The
//     triangle / pack_len select runs only on tiles that straddle the
//     diagonal (every tile with pack_len).
//   - Shared memory: 85 KB a block at D = 64 (two blocks an SM), 163 KB at
//     D = 128 (one).
#include "mma_common.cuh"

namespace {

using namespace aat_flash;

constexpr int kRows = 64;     // resident rows of a block, 16 a warp
constexpr int kTile = 32;     // rows of a streamed tile
constexpr int kThreads = 128;
constexpr int kStages = 2;    // the ring
constexpr float kPadLse = 1e30f;  // lse of a padded query row: p == 0 there

template <int D>
__host__ __device__ constexpr int pitch() {  // floats a streamed row: 4 banks past a multiple of 32
  return D + 4;
}

// n-tiles of 8 output columns a product tile sums at once: at D = 128 half
// of them, which keeps the dk/dv accumulators and a tile's sums in registers
template <int D>
__host__ __device__ constexpr int chunk_tiles() {
  return D == 64 ? 8 : 4;
}

// the resident tiles (two [64][D]), the ring (two streamed [32][D+4] tiles a
// stage), the lo tiles beside the landed stage, and kTile words of each of
// two per-row vectors a stage (dq: the key mask; dk/dv: lse and delta)
template <int D>
constexpr int smem_bytes() {
  return (int)(sizeof(float) * (2 * kRows * D + (kStages + 1) * 2 * kTile * pitch<D>() +
                                2 * kStages * kTile));
}

template <int D>
__host__ __device__ constexpr int blocks_per_sm() {
  return D == 64 ? 2 : 1;
}

// a landed [kTile][D+4] tile split in place: x·scale -> hi (the tf32 value,
// low bits cleared) where x was, lo = tf32(x·scale - hi) into `lo`
template <int D>
__device__ __forceinline__ void split_tile(float* t, float* lo, float scale, int tid) {
  constexpr int kChunks = D / 4;
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int off = (i / kChunks) * pitch<D>() + (i % kChunks) * 4;
    float4 x = *reinterpret_cast<float4*>(t + off);
    uint4 h, l;
    split_tf32(x.x * scale, h.x, l.x);
    split_tf32(x.y * scale, h.y, l.y);
    split_tf32(x.z * scale, h.z, l.z);
    split_tf32(x.w * scale, h.w, l.w);
    *reinterpret_cast<uint4*>(t + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

__device__ __forceinline__ uint32_t word(const float* p) { return __float_as_uint(*p); }

// the A fragment of k-step kk of this warp's 16 rows of a swizzled resident
// tile, times `scale`, split
template <int D>
__device__ __forceinline__ void a_fragment(const float* tile, int warp, int lane, int kk,
                                           float scale, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  uint32_t f[4];
  ldsm_x4(smem_u32(tile + swz_f32<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4))), f);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(f[i]) * scale, hi[i], lo[i]);
}

// s (from a and b) and dp (from c and d) += their 3xTF32 products over D:
// A fragments from this warp's rows of the resident tiles `ra` (times
// `scale`) and `rc`, B fragments from the split streamed tiles (hi in
// `bh`/`dh`, lo in `bl`/`dl`), whose rows are the 8-wide n-tiles
template <int D>
__device__ __forceinline__ void scores(const float* ra, const float* rc, const float* bh,
                                       const float* bl, const float* dh, const float* dl,
                                       float scale, int warp, int lane, float (&s)[kTile / 8][4],
                                       float (&dp)[kTile / 8][4]) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a_hi[4], a_lo[4], c_hi[4], c_lo[4];
    a_fragment<D>(ra, warp, lane, kk, scale, a_hi, a_lo);
    a_fragment<D>(rc, warp, lane, kk, 1.f, c_hi, c_lo);
    uint32_t b_hi[kTile / 8][2], b_lo[kTile / 8][2], d_hi[kTile / 8][2], d_lo[kTile / 8][2];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int off = (8 * j + g) * pitch<D>() + 8 * kk + t4;  // (row n = 8j + g, column k = t4)
      b_hi[j][0] = word(bh + off), b_hi[j][1] = word(bh + off + 4);
      b_lo[j][0] = word(bl + off), b_lo[j][1] = word(bl + off + 4);
      d_hi[j][0] = word(dh + off), d_hi[j][1] = word(dh + off + 4);
      d_lo[j][0] = word(dl + off), d_lo[j][1] = word(dl + off + 4);
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      mma_tf32(s[j], a_lo, b_hi[j][0], b_hi[j][1]);
      mma_tf32(dp[j], c_lo, d_hi[j][0], d_hi[j][1]);
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      mma_tf32(s[j], a_hi, b_lo[j][0], b_lo[j][1]);
      mma_tf32(dp[j], c_hi, d_lo[j][0], d_lo[j][1]);
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      mma_tf32(s[j], a_hi, b_hi[j][0], b_hi[j][1]);
      mma_tf32(dp[j], c_hi, d_hi[j][0], d_hi[j][1]);
    }
  }
}

// acc[D/8][4] += x·B in 3xTF32, where x is a [16, kTile] tile held as
// accumulator fragments (k-step j is x[j]; A column t4 stands for index
// 2·t4 and column t4 + 4 for 2·t4 + 1) and B the split streamed tile
// [kTile][D] (rows k, columns n), read in that order. The tile's sum starts
// from zero and joins acc in f32 adds, chunk_tiles<D>() n-tiles at a time.
template <int D>
__device__ __forceinline__ void product(const float (&x)[kTile / 8][4], const float* bh,
                                        const float* bl, int lane, float (&acc)[D / 8][4]) {
  constexpr int kN = chunk_tiles<D>();
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int d0 = 0; d0 < D / 8; d0 += kN) {
    float t[kN][4];
#pragma unroll
    for (int i = 0; i < kN; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(x[j][0], a_hi[0], a_lo[0]);  // (g, 2·t4)
      split_tf32(x[j][2], a_hi[1], a_lo[1]);  // (g + 8, 2·t4)
      split_tf32(x[j][1], a_hi[2], a_lo[2]);  // (g, 2·t4 + 1)
      split_tf32(x[j][3], a_hi[3], a_lo[3]);  // (g + 8, 2·t4 + 1)
      uint32_t b_hi[kN][2], b_lo[kN][2];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int off = (8 * j + 2 * t4) * pitch<D>() + 8 * (d0 + i) + g;  // B[2·t4][g]
        b_hi[i][0] = word(bh + off), b_hi[i][1] = word(bh + off + pitch<D>());
        b_lo[i][0] = word(bl + off), b_lo[i][1] = word(bl + off + pitch<D>());
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) mma_tf32(t[i], a_lo, b_hi[i][0], b_hi[i][1]);
#pragma unroll
      for (int i = 0; i < kN; ++i) mma_tf32(t[i], a_hi, b_lo[i][0], b_lo[i][1]);
#pragma unroll
      for (int i = 0; i < kN; ++i) mma_tf32(t[i], a_hi, b_hi[i][0], b_hi[i][1]);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d0 + i][e] += t[i][e];
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<D>())
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ out,
                           const float* __restrict__ dout, float* __restrict__ dq, BwdArgs a) {
  constexpr int kP = pitch<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);           // [kRows][D] swizzled
  float* dos = qs + kRows * D;                              // [kRows][D] swizzled
  float* ring = dos + kRows * D;                            // [kStages][K, V][kTile][kP]
  float* lo = ring + kStages * 2 * kTile * kP;              // [K, V][kTile][kP]
  int* ms = reinterpret_cast<int*>(lo + 2 * kTile * kP);    // [kStages][kTile]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const long long bh = b * a.n_heads + h;
  const long long o_st = (long long)a.n_heads * D;  // out/dout/dq row stride
  const float* ob = out + b * a.t_len * o_st + h * D;
  const float* kb = k + b * a.k_sb + hk * a.k_sh;
  const float* vb = v + b * a.v_sb + hk * a.v_sh;
  const int* mb = a.key_mask + b * a.s_len;
  const uint32_t seed_and_head = head_key(a.seed, b, a.heads_total, h);
  const int k_end = CAUSAL ? min(a.s_len, q0 + kRows) : a.s_len;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kTile;
    float* kt = ring + stage * 2 * kTile * kP;
    load_rows_f32_padded<D, kTile, kThreads, kP>(kt, kb, a.k_ss, k0, a.s_len, tid);
    load_rows_f32_padded<D, kTile, kThreads, kP>(kt + kTile * kP, vb, a.v_ss, k0, a.s_len, tid);
    if (tid < kTile) {
      const bool ok = k0 + tid < a.s_len;
      cp_async4(smem_u32(ms + stage * kTile + tid), mb + (ok ? k0 + tid : 0), ok ? 4 : 0);
    }
  };

  load_rows_f32_swz<D, kRows, kThreads>(qs, q + b * a.q_sb + h * a.q_sh, a.q_st, q0, a.t_len,
                                        tid);
  load_rows_f32_swz<D, kRows, kThreads>(dos, dout + b * a.t_len * o_st + h * D, o_st, q0,
                                        a.t_len, tid);
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();  // group: q, dout and tile 0

  // lane owns rows g and g + 8 of the warp's 16, columns 2·t4 and 2·t4 + 1
  // of every 8-wide tile of the accumulators
  const int g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const float nl_lo = -(row_lo < a.t_len ? a.lse[bh * a.t_len + row_lo] : kPadLse) * kLog2e;
  const float nl_hi = -(row_hi < a.t_len ? a.lse[bh * a.t_len + row_hi] : kPadLse) * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float delta_lo = 0.f, delta_hi = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    cp_async_wait<0>();  // tile `it` (and q, dout) have landed
    __syncthreads();     // and every warp is done with tile it - 1
    if (it == 0) {
      // delta = rowsum(dout · out): lanes 2r and 2r + 1 sum half of row r
      const int r = lane >> 1, half = lane & 1, row = warp * 16 + r;
      float sum = 0.f;
      if (q0 + row < a.t_len) {
        const float* orow = ob + (q0 + row) * o_st;
        for (int c = half * (D / 8); c < (half + 1) * (D / 8); ++c) {
          const float4 d4 = *reinterpret_cast<const float4*>(dos + swz_f32<D>(row, c));
          sum = fmaf(d4.x, orow[4 * c], sum);
          sum = fmaf(d4.y, orow[4 * c + 1], sum);
          sum = fmaf(d4.z, orow[4 * c + 2], sum);
          sum = fmaf(d4.w, orow[4 * c + 3], sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      delta_lo = __shfl_sync(0xffffffffu, sum, 2 * g);
      delta_hi = __shfl_sync(0xffffffffu, sum, 2 * (g + 8));
    }
    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
    cp_async_commit();
    float* kt = ring + stage * 2 * kTile * kP;
    float* vt = kt + kTile * kP;
    split_tile<D>(kt, lo, 1.f, tid);
    split_tile<D>(vt, lo + kTile * kP, 1.f, tid);
    __syncthreads();
    const int k0 = it * kTile;
    const int* mt = ms + stage * kTile;

    // S = q_s·K^T and dP = dout·V^T: K and V rows are the columns of B
    float s[kTile / 8][4], dp[kTile / 8][4];
    scores<D>(qs, dos, kt, lo, vt, lo + kTile * kP, a.sm_scale, warp, lane, s, dp);

    // p, the dropout of dp, ds = p·(dp - delta) in place of s
    const bool edge = CAUSAL && (a.pack_len > 0 || k0 + kTile - 1 > q0);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const bool valid = mt[c] > 0;
        float x_lo = valid ? s[j][e] : kMask;
        float x_hi = valid ? s[j][2 + e] : kMask;
        if (edge) {
          if (!causal_allowed(row_lo, k0 + c, a.pack_len)) x_lo = kMask;
          if (!causal_allowed(row_hi, k0 + c, a.pack_len)) x_hi = kMask;
        }
        const float p_lo = ex2(fmaf(x_lo, kLog2e, nl_lo));
        const float p_hi = ex2(fmaf(x_hi, kLog2e, nl_hi));
        float dp_lo = dp[j][e], dp_hi = dp[j][2 + e];
        if (a.keep_min != 0u) {
          dp_lo = keep_bits(seed_and_head, row_lo, k0 + c, a.s_len, a.keep_min)
                      ? dp_lo * a.inv_keep : 0.f;
          dp_hi = keep_bits(seed_and_head, row_hi, k0 + c, a.s_len, a.keep_min)
                      ? dp_hi * a.inv_keep : 0.f;
        }
        s[j][e] = p_lo * (dp_lo - delta_lo);
        s[j][2 + e] = p_hi * (dp_hi - delta_hi);
      }
    }

    // dQ += dS·K: K rows are the rows of B
    product<D>(s, kt, lo, lane, acc);
  }
  cp_async_wait<0>();

  if (row_lo < a.t_len) {
    float* o = dq + ((b * a.t_len + row_lo) * a.n_heads + h) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(o + 8 * i) =
          make_float2(acc[i][0] * a.sm_scale, acc[i][1] * a.sm_scale);
  }
  if (row_hi < a.t_len) {
    float* o = dq + ((b * a.t_len + row_hi) * a.n_heads + h) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(o + 8 * i) =
          make_float2(acc[i][2] * a.sm_scale, acc[i][3] * a.sm_scale);
  }
}

// delta[b, h, t] = rowsum(dout · out)[b, t, h] for rows of D f32, 16 lanes
// a row, each summing every 16th element (4-byte loads: out may start
// anywhere)
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_f32_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int t_len, int n_heads) {
  constexpr int kLanes = 16;
  const long long r = (long long)blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  float sum = 0.f;
  if (r < rows)
    for (int i = c; i < D; i += kLanes) sum = fmaf(dout[r * D + i], out[r * D + i], sum);
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (r < rows && c == 0) {
    const long long bt = r / n_heads;  // b·T + t
    const int hh = (int)(r % n_heads);
    delta[((bt / t_len) * n_heads + hh) * t_len + bt % t_len] = sum;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<D>())
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ delta, float* __restrict__ dk,
                            float* __restrict__ dv, BwdArgs a) {
  constexpr int kP = pitch<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kRows][D] swizzled
  float* vs = ks + kRows * D;                      // [kRows][D] swizzled
  float* ring = vs + kRows * D;                    // [kStages][q, dout][kTile][kP]
  float* lo = ring + kStages * 2 * kTile * kP;     // [q, dout][kTile][kP]
  float* ls = lo + 2 * kTile * kP;                 // [kStages][kTile] lse
  float* dls = ls + kStages * kTile;               // [kStages][kTile] delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const long long b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const long long bh = b * a.n_heads + h;
  const long long o_st = (long long)a.n_heads * D;  // dout row stride
  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* dob = dout + b * a.t_len * o_st + h * D;
  const float* lb = a.lse + bh * a.t_len;
  const float* db = delta + bh * a.t_len;
  const uint32_t seed_and_head = head_key(a.seed, b, a.heads_total, h);
  // query tiles above the diagonal see none of these keys (kRows is a
  // multiple of kTile)
  const int q_begin = CAUSAL ? k0 : 0;
  const int n_tiles = q_begin < a.t_len ? (a.t_len - q_begin + kTile - 1) / kTile : 0;

  auto load_q = [&](int tile, int stage) {
    const int q0 = q_begin + tile * kTile;
    float* qt = ring + stage * 2 * kTile * kP;
    load_rows_f32_padded<D, kTile, kThreads, kP>(qt, qb, a.q_st, q0, a.t_len, tid);
    load_rows_f32_padded<D, kTile, kThreads, kP>(qt + kTile * kP, dob, o_st, q0, a.t_len, tid);
    if (tid < 2 * kTile) {  // threads 0-31 copy lse, 32-63 delta
      const int i = tid & (kTile - 1);
      const bool ok = q0 + i < a.t_len;
      const float* src = (tid < kTile ? lb : db) + (ok ? q0 + i : 0);
      cp_async4(smem_u32((tid < kTile ? ls : dls) + stage * kTile + i), src, ok ? 4 : 0);
    }
  };

  load_rows_f32_swz<D, kRows, kThreads>(ks, k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, a.s_len,
                                        tid);
  load_rows_f32_swz<D, kRows, kThreads>(vs, v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, a.s_len,
                                        tid);
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();  // group: k, v and tile 0

  // lane owns keys g and g + 8 of the warp's 16 (the accumulator rows) and
  // queries 2·t4, 2·t4 + 1 of every 8-wide tile (the columns)
  const int g = lane >> 2, t4 = lane & 3;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const int* mb = a.key_mask + b * a.s_len;
  const bool valid_lo = key_lo < a.s_len && mb[key_lo] > 0;
  const bool valid_hi = key_hi < a.s_len && mb[key_hi] > 0;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    cp_async_wait<0>();  // tile `it` (and k, v) have landed
    __syncthreads();     // and every warp is done with tile it - 1
    if (it + 1 < n_tiles) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    const int q0 = q_begin + it * kTile;
    float* qt = ring + stage * 2 * kTile * kP;
    float* dt = qt + kTile * kP;
    float* lt = ls + stage * kTile;
    const float* dlt = dls + stage * kTile;
    // one pass over the landed tile: q -> split(q·sm_scale), dout ->
    // split(dout), lse -> -lse·log2e (kPadLse past T, so p == 0 there)
    split_tile<D>(qt, lo, a.sm_scale, tid);
    split_tile<D>(dt, lo + kTile * kP, 1.f, tid);
    if (tid < kTile) lt[tid] = -(q0 + tid < a.t_len ? lt[tid] : kPadLse) * kLog2e;
    __syncthreads();

    // S^T = K·q_s^T and dP^T = V·dout^T: q and dout rows are the columns of B
    float s[kTile / 8][4], dp[kTile / 8][4];
    scores<D>(ks, vs, qt, lo, dt, lo + kTile * kP, 1.f, warp, lane, s, dp);

    // p_v^T in place of s and dS^T in place of dp. The hash's row is the
    // query (this fragment's column), its column the key (the row).
    const bool edge = CAUSAL && (a.pack_len > 0 || q0 < k0 + kRows - 1);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e, query = q0 + c;
        const float nle = lt[c], dle = dlt[c];
        float x_lo = valid_lo ? s[j][e] : kMask;
        float x_hi = valid_hi ? s[j][2 + e] : kMask;
        if (edge) {
          if (!causal_allowed(query, key_lo, a.pack_len)) x_lo = kMask;
          if (!causal_allowed(query, key_hi, a.pack_len)) x_hi = kMask;
        }
        const float p_lo = ex2(fmaf(x_lo, kLog2e, nle));
        const float p_hi = ex2(fmaf(x_hi, kLog2e, nle));
        float pv_lo = p_lo, pv_hi = p_hi, dp_lo = dp[j][e], dp_hi = dp[j][2 + e];
        if (a.keep_min != 0u) {
          const bool keep_lo = keep_bits(seed_and_head, query, key_lo, a.s_len, a.keep_min);
          const bool keep_hi = keep_bits(seed_and_head, query, key_hi, a.s_len, a.keep_min);
          pv_lo = keep_lo ? p_lo * a.inv_keep : 0.f;
          dp_lo = keep_lo ? dp_lo * a.inv_keep : 0.f;
          pv_hi = keep_hi ? p_hi * a.inv_keep : 0.f;
          dp_hi = keep_hi ? dp_hi * a.inv_keep : 0.f;
        }
        s[j][e] = pv_lo;
        s[j][2 + e] = pv_hi;
        dp[j][e] = p_lo * (dp_lo - dle);
        dp[j][2 + e] = p_hi * (dp_hi - dle);
      }
    }

    // dV += P_v^T·dout and dK += dS^T·q_s: dout and q_s rows are the rows
    // of B
    product<D>(s, dt, lo + kTile * kP, lane, dv_acc);
    product<D>(dp, qt, lo, lane, dk_acc);
  }
  cp_async_wait<0>();

  if (key_lo < a.s_len) {
    const long long off = ((b * a.s_len + key_lo) * a.n_heads + h) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(dk + off + 8 * i) = make_float2(dk_acc[i][0], dk_acc[i][1]);
      *reinterpret_cast<float2*>(dv + off + 8 * i) = make_float2(dv_acc[i][0], dv_acc[i][1]);
    }
  }
  if (key_hi < a.s_len) {
    const long long off = ((b * a.s_len + key_hi) * a.n_heads + h) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(dk + off + 8 * i) = make_float2(dk_acc[i][2], dk_acc[i][3]);
      *reinterpret_cast<float2*>(dv + off + 8 * i) = make_float2(dv_acc[i][2], dv_acc[i][3]);
    }
  }
}

}  // namespace

// dq [B,T,H,D] f32. q, k, v and dout are f32 with 16-byte-aligned starts,
// q/k/v strides in multiples of 4 elements (the wrapper checks); out may
// start anywhere. Returns cudaGetLastError() after the launch.
extern "C" int aat_flash_bwd_dq_tf32x3(const void* q, const void* k, const void* v,
                                       const int* key_mask, const void* out, const void* dout,
                                       const float* lse, void* dq, int B, int T_len, int S,
                                       int H, int KVH, int D, int DV, long long q_sb,
                                       long long q_st,
                                       long long q_sh, long long k_sb, long long k_ss,
                                       long long k_sh, long long v_sb, long long v_ss,
                                       long long v_sh, float sm_scale, int causal, int pack_len,
                                       int seed, float rate, float inv_keep, int heads_total,
                                       int head_offset, cudaStream_t stream) {
  if (B == 0 || T_len == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a{key_mask, lse, T_len, S, H, KVH, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                  v_sb, v_ss, v_sh, sm_scale, pack_len, aat_flash::offset_seed(seed, head_offset),
                  aat_flash::keep_min(rate), inv_keep, heads_total};
  return dispatch(D, DV, causal, [&](auto variant) {
    using V = decltype(variant);
    auto kernel = flash_bwd_dq_tf32x3_kernel<V::width, V::causal>;
    constexpr int smem = smem_bytes<V::width>();
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(H, (T_len + kRows - 1) / kRows, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(out), static_cast<const float*>(dout), static_cast<float*>(dq),
        a);
    return (int)cudaGetLastError();
  });
}

// aat_flash_bwd_dq_tf32x3's arguments with dk, dv (f32 per q-head
// [B,S,H,D]) in place of dq, and `delta`, a [B,H,T] f32 scratch the rowsum
// kernel fills. The same operand rules. Returns cudaGetLastError() after the
// launches.
extern "C" int aat_flash_bwd_dkv_tf32x3(const void* q, const void* k, const void* v,
                                        const int* key_mask, const void* out, const void* dout,
                                        const float* lse, float* dk, float* dv, float* delta,
                                        int B, int T_len, int S, int H, int KVH, int D,
                                        int DV, long long q_sb, long long q_st, long long q_sh,
                                        long long k_sb, long long k_ss, long long k_sh,
                                        long long v_sb, long long v_ss, long long v_sh,
                                        float sm_scale, int causal, int pack_len, int seed,
                                        float rate, float inv_keep, int heads_total,
                                        int head_offset, cudaStream_t stream) {
  if (B == 0 || T_len == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a{key_mask, lse, T_len, S, H, KVH, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                  v_sb, v_ss, v_sh, sm_scale, pack_len, aat_flash::offset_seed(seed, head_offset),
                  aat_flash::keep_min(rate), inv_keep, heads_total};
  return dispatch(D, DV, causal, [&](auto variant) {
    using V = decltype(variant);
    const long long rows = (long long)B * T_len * H;
    flash_bwd_delta_f32_kernel<V::width>
        <<<(unsigned int)((rows + 15) / 16), 256, 0, stream>>>(
            static_cast<const float*>(out), static_cast<const float*>(dout), delta, rows, T_len,
            H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    auto kernel = flash_bwd_dkv_tf32x3_kernel<V::width, V::causal>;
    constexpr int smem = smem_bytes<V::width>();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(H, (S + kRows - 1) / kRows, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), delta, dk, dv, a);
    return (int)cudaGetLastError();
  });
}
