// Fused log-mel kernel: frames [N, 400] f32 -> log10 mel [N, 64] f32.
//
// Replaces the TPU kernel aat_tpu/ops/mel_pallas.py:36 `_mel_kernel`
// (wrapper `fused_melspec_pallas` :63). Per frame it computes
//     spec  = frame @ [w*cos | -w*sin]      (400 x 2*201 windowed DFT basis)
//     power = re^2 + im^2                    (201 bins)
//     mel   = power @ slaney_filters         (201 x 64)
//     out   = log10(max(1e-10, mel))
// all in FP32 FFMA. Never TF32, not 3xTF32 either: the adaptive segmenter
// compares a smoothed mel curve under a 1e-5 epsilon, and the boundary
// contract is written against f32 sums.
//
// What bounds it on the H100: arithmetic on the FFMA pipes (67 TFLOP/s).
// The work these inputs need per frame is the dense DFT (2*400*402 flops),
// the power (3*201) and the 388 nonzero Slaney products (2*388): 3.10
// GFLOP at 9,608 frames, 0.0463 ms, against 1.6 KB read per frame. The
// basis (643 KB) does not fit a block's shared memory, so every block
// streams it from L2; L2 traffic per frame shrinks as a block owns more
// frames.
//
// The design, an SGEMM as it is built for this card, with the log-mel as
// its epilogue:
//   - Register blocking. A thread holds 8 frames x 8 basis columns (64
//     sums). Per 2 ks it reads its 8 frames as float2s and its 8 columns as
//     two float4s a k, so each shared word feeds at least 4 FFMAs (the
//     first version fed 8 FFMAs from 6 words). A warp is a 2-D tile of 4
//     frame groups x 8 column groups (32 frames x 64 columns), so lanes
//     share each word they read: a k costs the warp 4 shared wavefronts
//     (2 for its 64 basis words, 2 for its frames) against 16 SM clocks of
//     its FFMAs. Lanes that all read other columns of the same frames would
//     need 16, as many as those clocks.
//   - The basis is laid out on the host in the kernel's order (ops/mel.py
//     `kernel_basis`): [400][416], cos and sin interleaved per bin, bins
//     padded to 208 = 52 threads x 4 bins. Thread c owns the float4s at
//     columns 4c (bins 2c, 2c+1) and 208 + 4c (bins 104+2c, 105+2c), so a
//     warp's float4 loads are contiguous.
//   - Streaming K. The 400-long dimension streams in slices of 16 through a
//     3-stage cp.async ring of 16-byte copies, for the basis slice (16 x 416)
//     and the frames slice (frames x 16), so two slices' copies run under
//     this slice's FFMAs, with one barrier a slice.
//   - One block owns all bins of its frames: power, mel fold and log10 stay
//     in the block, with no atomics; the results are deterministic.
//   - Filling the card. A block is 4 frame groups of 8 frames (52 threads a
//     group, 208 threads, 88 KB of shared memory, two blocks an SM) where
//     that gives every SM a block (9,608 frames: 301 blocks), else 2 or 1
//     group (serving's 1,201 frames: 151 blocks of 8 frames). More frames a
//     block stream the basis fewer times; fewer fill more SMs.
//   - Banded mel fold. Each bin has at most 2 nonzero Slaney weights (388
//     of 201 x 64), so each mel filter is a contiguous band of bins, found
//     once on the host (`band`: first bin and count per mel). A thread folds
//     one (frame, mel) over its band in bin order; skipping an exact zero
//     leaves the sum's rounding as the dense in-order fold gives it, since
//     fma(p, 0, acc) == acc.
//   - Frames are read through a batch stride and a frame stride, so the
//     wrapper passes the framing's strided view without a copy.
// Each DFT sum runs k = 0..399 in one FFMA chain, and the power (two
// products and an add, not fused) and the fold keep the first version's
// order: the same arithmetic in the same order as that version. On the
// card it reaches a third of its bound (PERF.md); its FFMA loop alone runs
// below half the FFMA rate, for a reason not yet measured.
#include "mma_common.cuh"  // the cp.async copies; mel runs no tensor-core instruction

namespace {

using aat_flash::cp_async16;
using aat_flash::cp_async_commit;
using aat_flash::cp_async_wait;
using aat_flash::smem_u32;

constexpr int kNFft = 400;
constexpr int kBins = 201;
constexpr int kMels = 64;
constexpr int kColThreads = 52;            // threads across the columns
constexpr int kPadBins = 4 * kColThreads;  // 208: 4 bins a thread
constexpr int kCols = 2 * kPadBins;        // 416: cos and sin of each bin
constexpr int kTm = 8;                     // frames a thread (a frame group)
constexpr int kKs = 16;                    // k of a ring slice
constexpr int kStages = 3;
constexpr int kSlices = kNFft / kKs;       // 25
constexpr int kFp = kKs + 4;               // frame row pitch
constexpr int kPp = kPadBins + 1;          // power row pitch
constexpr int kMaxBand = 18;               // bins of the longest mel band (ops/mel.py MAX_BAND)

// a frame row's offset in a ring stage: frame group f sits 4·f words
// further, so the 4 groups a warp reads at once hit 4 other bank pairs
__host__ __device__ constexpr int frame_row(int r) { return r * kFp + (r / kTm) * 4; }

template <int FG>
__host__ __device__ constexpr int stage_frames() {  // floats of a stage's frame slice
  return frame_row(FG * kTm);
}

template <int FG>
constexpr int smem_floats() {
  return kStages * (kKs * kCols + stage_frames<FG>());
}

struct MelArgs {
  const float* frames;
  const float* basis;    // [kNFft][kCols], the kernel's order
  const float* filters;  // [kBins][kMels]
  const int* band;       // [kMels][2]: first nonzero bin, count
  float* out;            // [n_batch * n_per][kMels]
  int n_per;             // frames per batch row
  long long total;       // frames in all
  long long batch_stride, frame_stride;  // in floats
};

// FG (1, 2 or 4) frame groups of 8 frames a block, 52 threads a group. A
// warp's lanes span all FG groups and 32 / FG column groups, so a warp
// reads 32 / FG distinct basis float4s a k and FG distinct frame rows
template <int FG>
__global__ void __launch_bounds__(FG * kColThreads, 2) mel_kernel(MelArgs a) {
  static_assert(32 % FG == 0 && FG <= 4, "a warp spans every frame group");
  constexpr int kThreads = FG * kColThreads;
  constexpr int kBm = FG * kTm;
  constexpr int kStageFrames = stage_frames<FG>();
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                          // [kStages][kKs][kCols]
  float* fs = bs + kStages * kKs * kCols;    // [kStages][kBm rows at frame_row]

  const int tid = threadIdx.x, lane = tid % 32;
  const int fg = lane % FG, cg = tid / 32 * (32 / FG) + lane / FG;
  const long long g0 = (long long)blockIdx.x * kBm;

  // this thread's 16-byte chunk of each frames slice, if it copies one: its
  // row's start in device memory (rows past the last frame copy zeros)
  static_assert(kKs * kCols / 4 % kThreads == 0 && kBm * kKs / 4 <= kThreads,
                "the copies divide among the threads");
  const int f_row = tid / (kKs / 4), f_chunk = tid % (kKs / 4);
  const bool f_copies = tid < kBm * kKs / 4;
  const bool f_valid = f_copies && g0 + f_row < a.total;
  const float* f_src = a.frames;
  if (f_valid) {
    const long long g = g0 + f_row;
    f_src += g / a.n_per * a.batch_stride + g % a.n_per * a.frame_stride + 4 * f_chunk;
  }

  // slice `slice` of the basis and of this block's frames into ring stage
  // `stage`
  auto load = [&](int slice, int stage) {
    const float* bsrc = a.basis + slice * kKs * kCols + 4 * tid;
    const uint32_t bdst = smem_u32(bs + stage * kKs * kCols + 4 * tid);
#pragma unroll
    for (int n = 0; n < kKs * kCols / 4 / kThreads; ++n)
      cp_async16(bdst + 16 * kThreads * n, bsrc + 4 * kThreads * n, 16);
    if (f_copies)
      cp_async16(smem_u32(fs + stage * kStageFrames + frame_row(f_row) + 4 * f_chunk),
                 f_valid ? f_src + slice * kKs : a.frames, f_valid ? 16 : 0);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load(s, s);
    cp_async_commit();
  }

  float acc[kTm][8];
#pragma unroll
  for (int i = 0; i < kTm; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < kSlices; ++it) {
    cp_async_wait<kStages - 2>();  // slice `it` has landed
    __syncthreads();               // and every thread is done with slice it - 1
    if (it + kStages - 1 < kSlices) load(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();             // empty at the end, which keeps the count
    const int stage = it % kStages;
    const float* bt = bs + stage * kKs * kCols + 4 * cg;
    const float* ft = fs + stage * kStageFrames + frame_row(fg * kTm);
#pragma unroll
    for (int k2 = 0; k2 < kKs; k2 += 2) {
      float2 x[kTm];  // this thread's 8 frames at k2, k2 + 1 (a broadcast in its group)
#pragma unroll
      for (int i = 0; i < kTm; ++i) x[i] = *reinterpret_cast<const float2*>(ft + i * kFp + k2);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bt + (k2 + kk) * kCols);
        const float4 b1 = *reinterpret_cast<const float4*>(bt + (k2 + kk) * kCols + kPadBins);
#pragma unroll
        for (int i = 0; i < kTm; ++i) {
          const float xv = kk ? x[i].y : x[i].x;
          acc[i][0] = fmaf(xv, b0.x, acc[i][0]);
          acc[i][1] = fmaf(xv, b0.y, acc[i][1]);
          acc[i][2] = fmaf(xv, b0.z, acc[i][2]);
          acc[i][3] = fmaf(xv, b0.w, acc[i][3]);
          acc[i][4] = fmaf(xv, b1.x, acc[i][4]);
          acc[i][5] = fmaf(xv, b1.y, acc[i][5]);
          acc[i][6] = fmaf(xv, b1.z, acc[i][6]);
          acc[i][7] = fmaf(xv, b1.w, acc[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the power spectrum now

  // power [kBm][kPp] of bins 2c, 2c+1 and 104+2c, 105+2c (re^2 + im^2, the
  // products rounded before the add)
  float* ps = smem;
#pragma unroll
  for (int i = 0; i < kTm; ++i) {
    float* row = ps + (fg * kTm + i) * kPp;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = (j >> 1) * (kPadBins / 2) + 2 * cg + (j & 1);
      row[bin] = __fadd_rn(__fmul_rn(acc[i][2 * j], acc[i][2 * j]),
                           __fmul_rn(acc[i][2 * j + 1], acc[i][2 * j + 1]));
    }
  }
  __syncthreads();

  // the banded fold and log10, one (frame, mel) a step, mels fastest so
  // the stores coalesce; the band loop is unrolled to its longest (a bin
  // past a mel's band is skipped), so its loads issue back to back
  for (int t = tid; t < kBm * kMels; t += kThreads) {
    const int r = t / kMels, m = t % kMels;
    const long long g = g0 + r;
    if (g >= a.total) break;
    const int first = __ldg(a.band + 2 * m), count = __ldg(a.band + 2 * m + 1);
    const float* prow = ps + r * kPp + first;
    const float* wcol = a.filters + first * kMels + m;
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < kMaxBand; ++b)
      if (b < count) sum = fmaf(prow[b], __ldg(wcol + b * kMels), sum);
    a.out[g * kMels + m] = log10f(fmaxf(1e-10f, sum));
  }
}

template <int FG>
int launch(const MelArgs& a, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(float) * smem_floats<FG>();
  static_assert(FG * kTm * kPp <= smem_floats<FG>(), "the power spectrum must fit the ring");
  cudaError_t err =
      cudaFuncSetAttribute(mel_kernel<FG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.total + FG * kTm - 1) / (FG * kTm);
  mel_kernel<FG><<<(unsigned int)blocks, FG * kColThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// frames: n_batch rows of n_per frames of 400 f32, frame (b, f) at
// frames + b·batch_stride + f·frame_stride (strides in floats, multiples of
// 4, 16-byte-aligned start: the wrapper checks); basis [400][416] in the
// kernel's order, filters [201][64], band [64][2] int32; out [n_batch·n_per,
// 64] f32; no band longer than kMaxBand (the wrapper's table). Returns
// cudaGetLastError() after the launch.
extern "C" int aat_mel_forward(const float* frames, const float* basis, const float* filters,
                               const int* band, float* out, int n_batch, int n_per,
                               long long batch_stride, long long frame_stride,
                               cudaStream_t stream) {
  const long long total = (long long)n_batch * n_per;
  if (total <= 0) return 0;
  const MelArgs a{frames, basis, filters, band, out, n_per, total, batch_stride, frame_stride};
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // the most frame groups a block that still give every SM a block
  if ((total + 4 * kTm - 1) / (4 * kTm) >= sms) return launch<4>(a, stream);
  if ((total + 2 * kTm - 1) / (2 * kTm) >= sms) return launch<2>(a, stream);
  return launch<1>(a, stream);
}
