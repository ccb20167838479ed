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
// N = 262144, K = D = 1024) against N*D*4 bytes of x. It stays in full
// FP32 FFMA: TF32 would move distances by ~1e-3 relative and flip
// near-ties. The TPU kept a [256, D] x tile and a [512, D] code tile in
// VMEM; a Hopper block has 227 KB of shared memory, so the design is a
// register-tiled SGEMM whose epilogue is the argmin:
//   - a block owns 128 rows of x and loops over tiles of 128 codes; for
//     each code tile it streams D through shared memory in chunks of 16
//     (x and codes stored transposed, rows padded by one float);
//   - 256 threads as 16 x 16, each accumulating 8 rows x 8 codes (rows
//     ty + 16i, codes tx + 16j): 16 shared loads feed 64 FFMAs;
//   - after each code tile a thread folds its 8 x 8 distances into a
//     running (min, id) per row in registers, codes ascending;
//   - at the end the 16 threads of a row (one half-warp) combine their
//     (min, id) pairs with warp shuffles, the lower id winning a tie.
// Offsets into x and the codebook are 64-bit: N*D passes 2^31 at about
// two million 1024-wide rows.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 128;            // rows of x per block
constexpr int kBN = 128;            // codes per tile
constexpr int kBK = 16;             // depth per shared-memory chunk
constexpr int kThreads = 256;       // 16 x 16
constexpr int kLd = kBM + 1;        // padded shared row (kBM == kBN)

__global__ void __launch_bounds__(kThreads)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ cbn, int* __restrict__ idx,
                  int n, int k, int d) {
  __shared__ float xs[kBK * kLd];   // [kBK][kBM + 1]: a chunk of x, transposed
  __shared__ float cs[kBK * kLd];   // [kBK][kBN + 1]: a chunk of codes, transposed

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long row0 = (long long)blockIdx.x * kBM;

  float best[8];
  int best_id[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    best_id[i] = 0;
  }

  for (int c0 = 0; c0 < k; c0 += kBN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kBK) {
      __syncthreads();  // the previous chunk is no longer read
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, kk = i % kBK;  // 16 neighbouring threads read one row
        const int col = d0 + kk;
        const long long row = row0 + r;
        const int code = c0 + r;
        xs[kk * kLd + r] = (row < n && col < d) ? x[row * d + col] : 0.f;
        cs[kk * kLd + r] = (code < k && col < d) ? cb[(long long)code * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float xv[8], cv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = xs[kk * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) cv[j] = cs[kk * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], cv[j], acc[i][j]);
      }
    }

    // fold the tile into the running minimum, this thread's codes ascending
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = c0 + tx + 16 * j;
      if (code >= k) continue;  // overhanging codes are never candidates
      const float norm = cbn[code];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dist = norm - 2.f * acc[i][j];
        if (dist < best[i]) {
          best[i] = dist;
          best_id[i] = code;
        }
      }
    }
  }

  // the 16 threads of a row are one half-warp: combine (min, id), lower id
  // on a tie
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float dist = best[i];
    int id = best_id[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float o_dist = __shfl_xor_sync(0xffffffffu, dist, off);
      const int o_id = __shfl_xor_sync(0xffffffffu, id, off);
      if (o_dist < dist || (o_dist == dist && o_id < id)) {
        dist = o_dist;
        id = o_id;
      }
    }
    const long long row = row0 + ty + 16 * i;
    if (tx == 0 && row < n) idx[row] = id;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int aat_vq_nearest(const float* x, const float* codebook,
                              const float* cbn, int* idx, int n, int k, int d,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kBM - 1) / kBM;
  vq_nearest_kernel<<<blocks, kThreads, 0, stream>>>(x, codebook, cbn, idx, n, k, d);
  return (int)cudaGetLastError();
}
