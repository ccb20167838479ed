// Nearest codebook entry: x [N, D] f32, codebook [K, D] f32 and the code
// norms cbn [K] = ||c||^2 f32 -> idx [N] int32, the code with the least
// cbn[k] - 2 x.c_k; exact ties go to the lowest code id.
//
// Replaces the TPU kernel aat_tpu/ops/vq.py:50 `_make_vq_kernel` (wrapper
// `nearest_codebook_pallas` :91, launched :101). Semantics kept from it:
// dist = cbn - 2 * (x.c) with the x.c sum in f32, a running minimum over
// codebook tiles that moves only on a strictly smaller distance (so the
// lowest id wins a tie within and across tiles), overhanging codes never
// candidates. The norms and the gather codebook[idx] stay outside the
// kernel, as on the TPU, so the plain route reads the same cbn tensor.
//
// What bounds it on the H100: arithmetic, 2*N*K*D flops (550 GFLOP at
// N = 262144, K = D = 1024) against N*D*4 bytes of x. One-pass TF32 would
// move distances by more than half the near-tie margin of 1e-4·|best|
// (tests/test_torch_tf32x3.py) and flip near-ties, so x.c runs on the
// tensor cores as 3xTF32 (mma_common.cuh: three tf32 products per f32
// product, f32 accumulation), whose error is that of the f32 sums: 495 / 3
// = 165 TFLOP/s of f32-accurate products, against 67 on the FFMA pipes. The
// TPU kept a [256, D] x tile and a [512, D] code tile in VMEM; a Hopper
// block has 227 KB of shared memory, so the design is a tensor-core GEMM
// whose epilogue is the argmin:
//   - a block owns 128 rows of x and walks over tiles of 128 codes, 8 warps
//     as 2 x 4, each warp 64 rows x 32 codes (4 x 4 m16n8 accumulators);
//   - x and code chunks of 32 floats of depth (both K-major, as stored)
//     stream through a 2-stage cp.async ring that runs across code tiles,
//     swizzled in 16-byte chunks, so the 8 rows an ldmatrix reads hit 8
//     distinct bank groups; both operands' fragments come from ldmatrix
//     (on 32-bit data a non-transposed b16 ldmatrix gives the tf32 A and B
//     fragments of k-contiguous tiles) and split into hi and lo in
//     registers, then three mma.sync.m16n8k8 per fragment pair; the tensor
//     cores' f32 accumulation truncates, so each chunk's products sum from
//     zero and join the running dot products in f32 adds;
//   - after each code tile a thread folds its accumulators into a running
//     (min, id) for its 8 rows, its codes ascending; at the end the 4 lanes
//     of a quad combine theirs with shuffles, then the 4 warps that share
//     rows through shared memory, the lower id winning an exact tie;
//   - any N, K and D: rows past N and codes past K load as zeros (cp.async
//     with src_bytes 0) and those codes are never candidates; with D a
//     multiple of 4 and 16-byte-aligned x and codebook the ring copies
//     16 bytes at a time, else 4, which also zero-fills a ragged D tail.
// Offsets into x and the codebook are 64-bit: N*D passes 2^31 at about
// two million 1024-wide rows.
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace aat_flash;

constexpr int kBM = 128;            // rows of x per block
constexpr int kBN = 128;            // codes per tile
constexpr int kBK = 32;             // depth of one chunk: 8 chunks of 16 bytes a row
constexpr int kWarpsN = 4;          // warps along the codes
constexpr int kThreads = 256;       // 8 warps: 2 along the rows x 4 along the codes
constexpr int kStages = 2;
constexpr int kTile = kBM * kBK;    // floats of one x or code chunk (kBM == kBN)
constexpr int kSmemBytes =
    (int)(sizeof(float) * kStages * 2 * kTile + (sizeof(float) + sizeof(int)) * kWarpsN * kBM);

// rows [row0, row0 + 128) and columns [d0, d0 + 32) of a row-major [n_rows,
// d] f32 matrix into a swizzled chunk; rows past n_rows and columns past d
// become zeros
template <bool VEC>
__device__ __forceinline__ void load_chunk(float* dst, const float* src, int n_rows, long long row0,
                                           int d, int d0, int tid) {
  if (VEC) {  // d % 4 == 0: a 16-byte chunk is all in or all past the row
#pragma unroll
    for (int n = 0; n < kBM * (kBK / 4) / kThreads; ++n) {
      const int i = tid + n * kThreads;
      const int r = i >> 3, c = i & 7;  // 8 threads read one row's 128 bytes
      const long long row = row0 + r;
      const int col = d0 + 4 * c;
      const bool ok = row < n_rows && col < d;
      cp_async16(smem_u32(dst + swz_f32<kBK>(r, c)), ok ? src + row * d + col : src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int n = 0; n < kBM * kBK / kThreads; ++n) {
      const int i = tid + n * kThreads;
      const int r = i >> 5, e = i & 31;
      const long long row = row0 + r;
      const int col = d0 + e;
      const bool ok = row < n_rows && col < d;
      cp_async4(smem_u32(dst + swz_f32<kBK>(r, e >> 2) + (e & 3)),
                ok ? src + row * d + col : src, ok ? 4 : 0);
    }
  }
}

// (dist, id) := (o_dist, o_id) when that is nearer, or as near with a lower id
__device__ __forceinline__ void take_nearer(float& dist, int& id, float o_dist, int o_id) {
  if (o_dist < dist || (o_dist == dist && o_id < id)) {
    dist = o_dist;
    id = o_id;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ cbn, int* __restrict__ idx, int n, int k, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [kStages][kBM][kBK]
  float* cs = xs + kStages * kTile;                // [kStages][kBN][kBK]
  float* red_dist = cs + kStages * kTile;          // [kWarpsN][kBM]
  int* red_id = reinterpret_cast<int*>(red_dist + kWarpsN * kBM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t4 = lane & 3;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int n_chunks = (d + kBK - 1) / kBK;
  const int n_steps = n_chunks * ((k + kBN - 1) / kBN);

  auto load = [&](int step, int stage) {
    const int d0 = (step % n_chunks) * kBK;
    load_chunk<VEC>(xs + stage * kTile, x, n, row0, d, d0, tid);
    load_chunk<VEC>(cs + stage * kTile, cb, k, (long long)(step / n_chunks) * kBN, d, d0, tid);
  };

  // slot 2·mi + hf: row wm·64 + 16·mi + g + 8·hf of the block
  float best[8];
  int best_id[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    best_id[i] = 0;
  }
  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1;
    if (step + 1 < n_steps) load(step + 1, stage ^ 1);
    cp_async_commit();   // empty on the last step, which keeps the count
    cp_async_wait<1>();  // step `step` has landed
    __syncthreads();
    const float* xt = xs + stage * kTile;
    const float* ct = cs + stage * kTile;
    // the chunk's products accumulate from zero and join acc in f32 adds
    // that round to nearest: the tensor cores' accumulation truncates, and
    // carried over all of D it would drift by about D/8·3 ulps
    float part[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        part[mi][ni][0] = part[mi][ni][1] = part[mi][ni][2] = part[mi][ni][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(ct + swz_f32<kBK>(wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                           kk * 2 + ((lane >> 3) & 1))),
                bf);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(bf[i]), b_hi[2 * np + (i >> 1)][i & 1],
                     b_lo[2 * np + (i >> 1)][i & 1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4], a_hi[4], a_lo[4];
        ldsm_x4(smem_u32(xt + swz_f32<kBK>(wm * 64 + mi * 16 + (lane & 15), kk * 2 + (lane >> 4))),
                af);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(af[i]), a_hi[i], a_lo[i]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_3xtf32(part[mi][ni], a_hi, a_lo, b_hi[ni], b_lo[ni]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] += part[mi][ni][i];

    if ((step + 1) % n_chunks == 0) {
      // the code tile is complete: fold it into the running minimum, this
      // thread's codes ascending
      const int c0 = (step / n_chunks) * kBN + wn * 32 + 2 * t4;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int code = c0 + 8 * ni + e;
          if (code < k) {  // overhanging codes are never candidates
            const float norm = __ldg(cbn + code);
#pragma unroll
            for (int slot = 0; slot < 8; ++slot) {
              const float dist = norm - 2.f * acc[slot >> 1][ni][2 * (slot & 1) + e];
              if (dist < best[slot]) {
                best[slot] = dist;
                best_id[slot] = code;
              }
            }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
    }
  }
  cp_async_wait<0>();

  // the 4 lanes of a quad hold the same rows, then the 4 warps along the codes
#pragma unroll
  for (int slot = 0; slot < 8; ++slot) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      take_nearer(best[slot], best_id[slot], __shfl_xor_sync(0xffffffffu, best[slot], off),
                  __shfl_xor_sync(0xffffffffu, best_id[slot], off));
    if (t4 == 0) {
      const int r = wm * 64 + 16 * (slot >> 1) + g + 8 * (slot & 1);
      red_dist[wn * kBM + r] = best[slot];
      red_id[wn * kBM + r] = best_id[slot];
    }
  }
  __syncthreads();
  if (tid < kBM && row0 + tid < n) {
    float dist = red_dist[tid];
    int id = red_id[tid];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) take_nearer(dist, id, red_dist[w * kBM + tid], red_id[w * kBM + tid]);
    idx[row0 + tid] = id;
  }
}

template <bool VEC>
int launch(const float* x, const float* codebook, const float* cbn, int* idx, int n, int k, int d,
           cudaStream_t stream) {
  auto kernel = vq_nearest_kernel<VEC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kBM - 1) / kBM;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(x, codebook, cbn, idx, n, k, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int aat_vq_nearest(const float* x, const float* codebook,
                              const float* cbn, int* idx, int n, int k, int d,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codebook) % 16 == 0;
  return vec ? launch<true>(x, codebook, cbn, idx, n, k, d, stream)
             : launch<false>(x, codebook, cbn, idx, n, k, d, stream);
}
