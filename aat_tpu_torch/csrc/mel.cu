// Fused log-mel kernel: frames [N, 400] f32 -> log10 mel [N, 64] f32.
//
// Replaces the TPU kernel aat_tpu/ops/mel_pallas.py:36 `_mel_kernel`
// (wrapper `fused_melspec_pallas` :63). Per frame it computes
//     spec  = frame @ [w*cos | -w*sin]      (400 x 2*201 windowed DFT basis)
//     power = re^2 + im^2                    (201 bins)
//     mel   = power @ slaney_filters         (201 x 64)
//     out   = log10(max(1e-10, mel))
// all in FP32 FFMA. Never TF32: the adaptive segmenter compares a smoothed
// mel curve under a 1e-5 epsilon, and a TF32 pass moves it by far more.
//
// What bounds it on the H100: arithmetic. 2*400*402 + 2*201*64 flops per
// 1.6 KB frame read is ~200 flop/byte, above the card's FP32 ridge, and
// FP32 FFMA runs at 67 TFLOP/s at most. The TPU kernel held the whole
// 400x512 basis in VMEM (800 KB); a Hopper block has 227 KB of shared
// memory, so the design is:
//   - a tile of 32 frames stays in shared memory for the whole block;
//   - the basis streams through shared memory in chunks of 32 bins
//     (cos and sin columns of those bins, 400 x 64 floats); each thread
//     computes the cos and sin sums of one bin for 4 frames, so a basis
//     value read from shared memory feeds 4 FMAs and a frame value 2;
//   - the slaney filters (201 x 64) stay in shared memory;
//   - each chunk's power spectrum goes to a small shared buffer and is
//     folded at once into 64 mel sums per frame held in registers, so the
//     power spectrum never reaches device memory.
// The sums run in another order than XLA's, which moves results by a few
// f32 ulps.
#include <cuda_runtime.h>

namespace {

constexpr int kNFft = 400;
constexpr int kBins = 201;
constexpr int kMels = 64;
constexpr int kTileF = 32;             // frames per block
constexpr int kChunkB = 32;            // bins per basis chunk
constexpr int kCols = 2 * kChunkB;     // cos + sin columns per chunk
constexpr int kThreads = 256;
constexpr int kSpecLd = kCols + 1;     // padded row: no bank conflicts
constexpr size_t kSmemBytes =
    sizeof(float) * (kTileF * kNFft + kNFft * kCols + kBins * kMels +
                     kTileF * kSpecLd);

__global__ void __launch_bounds__(kThreads)
mel_kernel(const float* __restrict__ frames, const float* __restrict__ basis,
           const float* __restrict__ filters, float* __restrict__ out,
           int n_frames) {
  extern __shared__ float smem[];
  float* fr = smem;                      // [kTileF][kNFft]
  float* bs = fr + kTileF * kNFft;       // [kNFft][kCols]
  float* fl = bs + kNFft * kCols;        // [kBins][kMels]
  float* sp = fl + kBins * kMels;        // [kTileF][kSpecLd]

  const int tid = threadIdx.x;
  const long long f0 = (long long)blockIdx.x * kTileF;

  for (int i = tid; i < kTileF * kNFft; i += kThreads) {
    const int f = i / kNFft;
    fr[i] = (f0 + f < n_frames) ? frames[f0 * kNFft + i] : 0.f;
  }
  for (int i = tid; i < kBins * kMels; i += kThreads) fl[i] = filters[i];

  // DFT phase: a warp shares one frame group; lane `bin` owns the cos and
  // sin columns of one bin of the chunk.
  const int bin = tid % 32;
  const int fgrp = tid / 32;             // frames fgrp + 8*i, i < 4
  // mel phase: 8 threads per frame, each owning 8 of the 64 mel sums.
  const int mf = tid / 8;
  const int mlane = tid % 8;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int b0 = 0; b0 < kBins; b0 += kChunkB) {
    __syncthreads();  // frames/filters loaded; previous chunk consumed
    for (int i = tid; i < kNFft * kCols; i += kThreads) {
      const int n = i / kCols;
      const int c = i % kCols;
      const int k = b0 + (c % kChunkB);
      const int half = c / kChunkB;      // 0: cos column, 1: sin column
      bs[i] = (k < kBins) ? basis[n * (2 * kBins) + half * kBins + k] : 0.f;
    }
    __syncthreads();

    float re[4] = {0.f, 0.f, 0.f, 0.f};
    float im[4] = {0.f, 0.f, 0.f, 0.f};
    for (int n = 0; n < kNFft; ++n) {
      const float cv = bs[n * kCols + bin];
      const float sv = bs[n * kCols + kChunkB + bin];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = fr[(fgrp + 8 * i) * kNFft + n];
        re[i] = fmaf(x, cv, re[i]);
        im[i] = fmaf(x, sv, im[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sp[(fgrp + 8 * i) * kSpecLd + bin] = re[i];
      sp[(fgrp + 8 * i) * kSpecLd + kChunkB + bin] = im[i];
    }
    __syncthreads();

    const int nb = min(kChunkB, kBins - b0);
    for (int b = 0; b < nb; ++b) {
      const float re = sp[mf * kSpecLd + b];
      const float im = sp[mf * kSpecLd + kChunkB + b];
      const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      const float* frow = fl + (b0 + b) * kMels;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, frow[mlane + 8 * j], acc[j]);
    }
  }

  if (f0 + mf < n_frames) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[(f0 + mf) * kMels + mlane + 8 * j] = log10f(fmaxf(1e-10f, acc[j]));
  }
}

}  // namespace

extern "C" int aat_mel_forward(const float* frames, const float* basis,
                               const float* filters, float* out, int n_frames,
                               cudaStream_t stream) {
  if (n_frames <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + kTileF - 1) / kTileF;
  mel_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(frames, basis, filters,
                                                       out, n_frames);
  return (int)cudaGetLastError();
}
