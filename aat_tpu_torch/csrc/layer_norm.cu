// The layer norm of models/hubert._layer_norm, forward and backward, over
// the last axis of rows ([N, C], C contiguous) or over the channels of a
// channel-first [B, C, T] tensor (the conv stack's output, normalised over
// C at each of its B·T positions) read and written in place of a transpose:
//
//   mean = Σ x / C,  var = Σ (x − mean)² / C  (two passes, in f32)
//   rstd = rsqrt(var + eps),  y = (x − mean)·rstd·scale + bias
//
// scale and bias are read in their own type (f32 or bf16) and widened; y is
// rounded once to x's type (f32 or bf16). The forward writes the f32 mean
// and rstd of each normalised vector where the caller passes them (the
// backward's only saved state besides x). The backward of dy, with x̂
// recomputed from x and those statistics and g = dy·scale:
//
//   dx = rstd·(g − Σg/C − x̂·Σ(g·x̂)/C),  dscale = Σ dy·x̂,  dbias = Σ dy
//
// dx in one pass; dscale and dbias as f32 partials, one row of C a block, in
// a fixed order, then a second small pass that sums the partials in block
// order in f64 and rounds them to the parameter's type: no atomics, so the
// gradients are the same bits from run to run.
//
// Replaces no TPU kernel: the JAX package writes the layer norm in jnp,
// which XLA fuses into one pass. The port's plain version (the CPU route)
// is a 12-op f32 composite: about 7 full-size f32 passes forward and 14
// backward, about 200 bytes of traffic a value, three f32 copies a value
// saved for the backward, and on the conv stack two transposed copies.
//
// What bounds it on the H100: bytes. The forward reads x and writes y, the
// backward reads x and dy and writes dx: 4 and 6 bytes a value in bf16 (8
// and 12 in f32) over 3.35 TB/s; the arithmetic is a few flops a value.
// The design keeps each value in registers between its one read and one
// write:
//   rows     a row per warp up to 1,024 values (2-4 warps past that), its
//            16-byte vectors kept as loaded and widened where used, the
//            sums by warp shuffles (and shared memory across a row's
//            warps); each lane keeps the backward's dscale and dbias
//            partials of its columns over all the rows of its block.
//   channel- a block is C/32 warps over a tile of positions of one batch
//   first    row: warp w holds channels 32w..32w+31, lane l positions
//            t0 + l + 32j, so every load and store is 32 consecutive
//            positions of one channel row; the column sums go through
//            shared memory. A row of T positions may start anywhere (T is
//            odd for every conv layer of a 16 kHz utterance), so the
//            accesses are element-wide. A store that fills a 32-byte sector
//            in part costs far more than a whole one: the forward's y is
//            written into rows padded to whole 128-byte lines (the
//            wrapper's view), its 64-position tiles each a whole line (at
//            [40, 512, 40607] bf16 on an H100 the forward took 1.66 ms so,
//            3.05 ms into unpadded rows). dx is written where
//            it lies, for the conv's backward. The backward's dscale
//            and dbias partials of a tile reduce over the 32 lanes by a
//            transposing butterfly (31 shuffles for 32 channels), leaving
//            lane l with channel 32w + l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // rows kernels: warps a block
constexpr int kMaxGroup = kWarps;  // rows kernels: warps a row, at most
constexpr int kRowsMaxC = 4096;  // rows kernels: 32 lanes · 4 warps · 32 values
constexpr int kCfChannels = 32;  // channel-first kernels: channels a warp
constexpr int kCfMaxC = 512;     // channel-first kernels: 16 warps a block
constexpr int kCfFwdJ = 2;       // channel-first forward: 32·J positions a tile
constexpr int kCfTile = 32 * kCfFwdJ;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N values of type E loaded or stored as one aligned vector (two 16-byte
// accesses for 8 f32)
template <typename E, int N>
struct alignas(sizeof(E) * N >= 16 ? 16 : sizeof(E) * N) Vec {
  E e[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;  // the same bits in every lane (a + b == b + a)
}

// The sums over a row's `group` warps of each warp's totals (u, v) (every
// warp of the block calls it: it synchronises the block when group > 1).
__device__ __forceinline__ float2 row_sum(float u, float v, float2* red, int warp, int group) {
  u = warp_sum(u);
  v = warp_sum(v);
  if (group == 1) return make_float2(u, v);
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(u, v);
  __syncthreads();
  const int first = warp - warp % group;
  float2 s = make_float2(0.0f, 0.0f);
  for (int i = 0; i < group; ++i) {
    s.x += red[first + i].x;
    s.y += red[first + i].y;
  }
  __syncthreads();
  return s;
}

// Lane `lane` of warp `part` in a row's group: its k-th vector.
__device__ __forceinline__ int vec_index(int part, int lane, int k, int group) {
  return part * 32 + lane + k * 32 * group;
}

// The forward over rows: K vectors of V values a lane (kept as loaded,
// widened where used), `group` warps a row.
template <typename T, typename W, int K>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_rows_fwd(const T* __restrict__ x, T* __restrict__ y, const W* __restrict__ scale,
                        const W* __restrict__ bias, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, long long n_rows, int C, int group,
                        float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float2 red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_block = kWarps / group, slot = warp / group, part = warp % group;
  const int n_vec = C / V;
  const float inv_c = 1.0f / (float)C;
  for (long long first = (long long)blockIdx.x * per_block; first < n_rows;
       first += (long long)gridDim.x * per_block) {
    const long long row = first + slot;
    const bool live = row < n_rows;
    const Vec<T, V>* xr = reinterpret_cast<const Vec<T, V>*>(x + (live ? row : 0) * C);
    Vec<T, V> v[K];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (live && vec_index(part, lane, k, group) < n_vec) {
        v[k] = xr[vec_index(part, lane, k, group)];
#pragma unroll
        for (int e = 0; e < V; ++e) s += to_float(v[k].e[e]);
      }
    }
    const float mean = row_sum(s, 0.0f, red, warp, group).x * inv_c;
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (live && vec_index(part, lane, k, group) < n_vec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = to_float(v[k].e[e]) - mean;
          ss += d * d;
        }
      }
    }
    const float rstd = rsqrtf(row_sum(ss, 0.0f, red, warp, group).x * inv_c + eps);
    if (!live) continue;
    Vec<T, V>* yr = reinterpret_cast<Vec<T, V>*>(y + row * C);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = vec_index(part, lane, k, group);
      if (q < n_vec) {
        const Vec<W, V> sc = reinterpret_cast<const Vec<W, V>*>(scale)[q];
        const Vec<W, V> bi = reinterpret_cast<const Vec<W, V>*>(bias)[q];
        Vec<T, V> out;
#pragma unroll
        for (int e = 0; e < V; ++e)
          out.e[e] = from_float<T>((to_float(v[k].e[e]) - mean) * rstd * to_float(sc.e[e]) +
                                   to_float(bi.e[e]));
        yr[q] = out;
      }
    }
    if (mean_out != nullptr && part == 0 && lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// The backward over rows; with `partials`, this block's dscale and dbias
// over its rows go to partials[blockIdx.x][0 / 1][0, C).
template <typename T, typename W, int K>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_rows_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                        const W* __restrict__ scale, const float* __restrict__ mean,
                        const float* __restrict__ rstd, T* __restrict__ dx,
                        float* __restrict__ partials, long long n_rows, int C, int group) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float2 red[kWarps];
  __shared__ float acc[2][kRowsMaxC];  // [dscale, dbias][column]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_block = kWarps / group, slot = warp / group, part = warp % group;
  const int n_vec = C / V;
  const float inv_c = 1.0f / (float)C;
  float ds[K][V], db[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) ds[k][e] = db[k][e] = 0.0f;
  for (long long first = (long long)blockIdx.x * per_block; first < n_rows;
       first += (long long)gridDim.x * per_block) {
    const long long row = first + slot;
    const bool live = row < n_rows;
    const long long at = (live ? row : 0) * C;
    const float m = live ? mean[row] : 0.0f, r = live ? rstd[row] : 0.0f;
    Vec<T, V> xv[K], dv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = vec_index(part, lane, k, group);
      if (live && q < n_vec) {
        xv[k] = reinterpret_cast<const Vec<T, V>*>(x + at)[q];
        dv[k] = reinterpret_cast<const Vec<T, V>*>(dy + at)[q];
      }
    }
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = vec_index(part, lane, k, group);
      if (live && q < n_vec) {
        const Vec<W, V> sc = reinterpret_cast<const Vec<W, V>*>(scale)[q];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (to_float(xv[k].e[e]) - m) * r;
          const float d = to_float(dv[k].e[e]);
          const float g = d * to_float(sc.e[e]);
          sg += g;
          sgx += g * xh;
          ds[k][e] += d * xh;
          db[k][e] += d;
        }
      }
    }
    const float2 sums = row_sum(sg, sgx, red, warp, group);
    if (!live) continue;
    const float a = sums.x * inv_c, b = sums.y * inv_c;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = vec_index(part, lane, k, group);
      if (q < n_vec) {
        const Vec<W, V> sc = reinterpret_cast<const Vec<W, V>*>(scale)[q];
        Vec<T, V> out;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (to_float(xv[k].e[e]) - m) * r;
          out.e[e] = from_float<T>(r * (to_float(dv[k].e[e]) * to_float(sc.e[e]) - a - xh * b));
        }
        reinterpret_cast<Vec<T, V>*>(dx + at)[q] = out;
      }
    }
  }
  if (partials == nullptr) return;
  // the block's slots hold the same columns: summed in slot order
  for (int j = 0; j < per_block; ++j) {
    if (slot == j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int q = vec_index(part, lane, k, group);
        if (q < n_vec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[0][q * V + e] = (j == 0 ? 0.0f : acc[0][q * V + e]) + ds[k][e];
            acc[1][q * V + e] = (j == 0 ? 0.0f : acc[1][q * V + e]) + db[k][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = partials + (long long)blockIdx.x * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) out[i] = acc[i / C][i % C];
}

// Each lane's v[i] summed over the warp's 32 lanes, for i < 32; lane l ends
// with the sum of v[l] in v[0]. Stage O keeps, of the 2·O values a lane
// holds, the half its partner (lane ^ O) does not, and adds the partner's
// copy of it; every index is a constant, so v stays in registers.
template <int O>
__device__ __forceinline__ void transpose_sum(float (&v)[kCfChannels], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
  if constexpr (O > 1) transpose_sum<O / 2>(v, lane);
}

// The sum over a channel-first block's warps of column `col`'s partials,
// in warp order (every thread of the column reads the same values).
template <int N>
__device__ __forceinline__ float column_sum(const float (*red)[N], int n_warps, int col) {
  float s = 0.0f;
  for (int w = 0; w < n_warps; ++w) s += red[w][col];
  return s;
}

// The forward over channel-first [B, C, T]: C/32 warps a block, a tile of
// 32·J positions of one batch row a turn (lane l: positions t0 + l + 32j).
template <typename T, typename W>
__global__ void __launch_bounds__(kCfMaxC)
    layer_norm_cf_fwd(const T* __restrict__ x, T* __restrict__ y, const W* __restrict__ scale,
                      const W* __restrict__ bias, float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, long long n_batch, int C, long long len,
                      long long ldy, float eps) {
  constexpr int CH = kCfChannels, J = kCfFwdJ;
  __shared__ float red[2][kCfMaxC / 32][kCfTile];  // the sums, the squared deviations
  __shared__ float scale_s[kCfMaxC], bias_s[kCfMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    scale_s[c] = to_float(scale[c]);
    bias_s[c] = to_float(bias[c]);
  }
  __syncthreads();
  const float inv_c = 1.0f / (float)C;
  const long long tiles_t = (len + 32 * J - 1) / (32 * J), n_tiles = n_batch * tiles_t;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b = tile / tiles_t, t0 = (tile % tiles_t) * 32 * J + lane;
    const T* xw = x + (b * C + (long long)warp * CH) * len + t0;
    float v[CH][J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const bool live = t0 + 32 * j < len;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        v[i][j] = live ? to_float(xw[i * len + 32 * j]) : 0.0f;
        s += v[i][j];
      }
      red[0][warp][lane + 32 * j] = s;
    }
    __syncthreads();
    float mean[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      mean[j] = column_sum(red[0], n_warps, lane + 32 * j) * inv_c;
      float ss = 0.0f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float d = v[i][j] - mean[j];
        ss += d * d;
      }
      red[1][warp][lane + 32 * j] = ss;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const long long t = t0 + 32 * j;
      if (t >= len) continue;
      const float rstd = rsqrtf(column_sum(red[1], n_warps, lane + 32 * j) * inv_c + eps);
      T* yw = y + (b * C + (long long)warp * CH) * ldy + t;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = warp * CH + i;
        yw[i * ldy] = from_float<T>((v[i][j] - mean[j]) * rstd * scale_s[c] + bias_s[c]);
      }
      if (mean_out != nullptr && warp == 0) {
        mean_out[b * len + t] = mean[j];
        rstd_out[b * len + t] = rstd;
      }
    }
  }
}

// The backward over channel-first [B, C, T], a tile of 32 positions a
// turn; with `partials`, this block's dscale and dbias go to
// partials[blockIdx.x][0 / 1][0, C).
template <typename T, typename W>
__global__ void __launch_bounds__(kCfMaxC)
    layer_norm_cf_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                      const W* __restrict__ scale, const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      float* __restrict__ partials, long long n_batch, int C, long long len) {
  constexpr int CH = kCfChannels;
  // Σg and Σg·x̂ of each column, double-buffered by the tile's parity: one
  // barrier a tile
  __shared__ float red[2][2][kCfMaxC / 32][32];
  __shared__ float scale_s[kCfMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < C; c += blockDim.x) scale_s[c] = to_float(scale[c]);
  __syncthreads();
  const float inv_c = 1.0f / (float)C;
  // of channel warp·32 + lane, over the block's tiles: a long chain of
  // adds, whose terms cancel, kept in f64
  double ds = 0.0, db = 0.0;
  const long long tiles_t = (len + 31) / 32, n_tiles = n_batch * tiles_t;
  int parity = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
    const long long b = tile / tiles_t, t = (tile % tiles_t) * 32 + lane;
    const bool live = t < len;
    const long long at = (b * C + (long long)warp * CH) * len + t;
    const float m = live ? mean[b * len + t] : 0.0f, r = live ? rstd[b * len + t] : 0.0f;
    float xh[CH], d[CH];
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      xh[i] = live ? (to_float(x[at + i * len]) - m) * r : 0.0f;
      d[i] = live ? to_float(dy[at + i * len]) : 0.0f;
      const float g = d[i] * scale_s[warp * CH + i];
      sg += g;
      sgx += g * xh[i];
    }
    red[parity][0][warp][lane] = sg;
    red[parity][1][warp][lane] = sgx;
    __syncthreads();
    const float a = column_sum(red[parity][0], n_warps, lane) * inv_c;
    const float bb = column_sum(red[parity][1], n_warps, lane) * inv_c;
    if (live) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float g = d[i] * scale_s[warp * CH + i];
        dx[at + i * len] = from_float<T>(r * (g - a - xh[i] * bb));
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) xh[i] *= d[i];  // dy·x̂ (0 past T)
    transpose_sum<16>(xh, lane);
    transpose_sum<16>(d, lane);
    ds += (double)xh[0];
    db += (double)d[0];
  }
  if (partials == nullptr) return;
  float* out = partials + (long long)blockIdx.x * 2 * C;
  out[warp * CH + lane] = (float)ds;
  out[C + warp * CH + lane] = (float)db;
}

// dscale[c] and dbias[c] (i = c and C + c): the blocks' partials summed in
// a fixed order, in f64 (the partials of a parameter's gradient cancel). A
// block takes 32 of the 2C sums: warp w adds partials w, w + 8, ..., then
// warp 0 the 8 warps' sums in order.
template <typename W>
__global__ void __launch_bounds__(256)
    layer_norm_finish(const float* __restrict__ partials, int n_parts, int C,
                      W* __restrict__ dscale, W* __restrict__ dbias) {
  __shared__ double red[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (i < 2 * C)
    for (int p = warp; p < n_parts; p += 8) s += (double)partials[(long long)p * 2 * C + i];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || i >= 2 * C) return;
  double t = 0.0;
  for (int w = 0; w < 8; ++w) t += red[w][lane];
  (i < C ? dscale : dbias)[i % C] = from_float<W>((float)t);
}

// Blocks of `kernel` that fit on the card at once (one kind of GPU a
// process; each kernel instance asks once).
template <typename Kernel>
int fit_blocks(Kernel kernel, int threads, int& fit) {
  if (fit == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    fit = sms * (per_sm > 0 ? per_sm : 1);
  }
  return fit;
}

int clamp_blocks(long long want, int fit, int cap) {
  long long n = want < fit ? want : fit;
  if (cap > 0 && n > cap) n = cap;
  return n < 1 ? 1 : (int)n;
}

// The rows kernels' shape: `group` warps a row (a power of two up to 8) and
// K vectors a lane (a power of two up to kmax), the least that hold C.
bool rows_shape(int C, int V, int kmax, int* K, int* group) {
  int g = 1;
  while (32 * g * V * kmax < C) g *= 2;
  if (g > kMaxGroup) return false;
  int k = 1;
  while (32 * g * V * k < C) k *= 2;
  *K = k;
  *group = g;
  return true;
}

struct Args {
  const void* x;
  const void* dy;
  void* y;  // the forward's y, the backward's dx
  const void* scale;
  const void* bias;
  float* mean;
  float* rstd;
  void* dscale;
  void* dbias;
  float* partials;
  int n_partials;
  long long outer;
  int C;
  long long len;  // T
  long long ldy;  // the forward's y: elements between channel rows (channel-first)
  float eps;
  cudaStream_t stream;
};

template <typename T, typename W, int K>
int rows_fwd_go(const Args& a, int group) {
  static int fit = 0;
  const int per_block = kWarps / group;
  const int blocks = clamp_blocks((a.outer + per_block - 1) / per_block,
                                  fit_blocks(layer_norm_rows_fwd<T, W, K>, kWarps * 32, fit), 0);
  layer_norm_rows_fwd<T, W, K><<<blocks, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y), static_cast<const W*>(a.scale),
      static_cast<const W*>(a.bias), a.mean, a.rstd, a.outer, a.C, group, a.eps);
  return (int)cudaGetLastError();
}

template <typename W>
int finish_go(const Args& a, int blocks) {
  layer_norm_finish<W><<<(2 * a.C + 31) / 32, 256, 0, a.stream>>>(
      a.partials, blocks, a.C, static_cast<W*>(a.dscale), static_cast<W*>(a.dbias));
  return (int)cudaGetLastError();
}

template <typename T, typename W, int K>
int rows_bwd_go(const Args& a, int group) {
  static int fit = 0;
  const int per_block = kWarps / group;
  const int blocks =
      clamp_blocks((a.outer + per_block - 1) / per_block,
                   fit_blocks(layer_norm_rows_bwd<T, W, K>, kWarps * 32, fit), a.n_partials);
  float* partials = a.dscale != nullptr ? a.partials : nullptr;
  layer_norm_rows_bwd<T, W, K><<<blocks, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), static_cast<const W*>(a.scale),
      a.mean, a.rstd, static_cast<T*>(a.y), partials, a.outer, a.C, group);
  const int err = (int)cudaGetLastError();
  return err != 0 || partials == nullptr ? err : finish_go<W>(a, blocks);
}

template <typename T, typename W>
int rows_fwd_launch(const Args& a) {
  constexpr int V = 16 / sizeof(T);
  int K, group;
  if (!rows_shape(a.C, V, 32 / V, &K, &group)) return (int)cudaErrorInvalidValue;
  switch (K) {
    case 1: return rows_fwd_go<T, W, 1>(a, group);
    case 2: return rows_fwd_go<T, W, 2>(a, group);
    case 4: return rows_fwd_go<T, W, 4>(a, group);
    default:
      if constexpr (V == 4) return rows_fwd_go<T, W, 8>(a, group);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename W>
int rows_bwd_launch(const Args& a) {
  constexpr int V = 16 / sizeof(T);
  int K, group;
  if (!rows_shape(a.C, V, 32 / V, &K, &group)) return (int)cudaErrorInvalidValue;
  switch (K) {
    case 1: return rows_bwd_go<T, W, 1>(a, group);
    case 2: return rows_bwd_go<T, W, 2>(a, group);
    case 4: return rows_bwd_go<T, W, 4>(a, group);
    default:
      if constexpr (V == 4) return rows_bwd_go<T, W, 8>(a, group);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename W>
int cf_fwd_launch(const Args& a) {
  static int fit = 0;
  const int threads = a.C;  // C / 32 warps
  const int blocks = clamp_blocks(a.outer * ((a.len + kCfTile - 1) / kCfTile),
                                  fit_blocks(layer_norm_cf_fwd<T, W>, threads, fit), 0);
  layer_norm_cf_fwd<T, W><<<blocks, threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y), static_cast<const W*>(a.scale),
      static_cast<const W*>(a.bias), a.mean, a.rstd, a.outer, a.C, a.len, a.ldy, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int cf_bwd_launch(const Args& a) {
  static int fit = 0;
  const int threads = a.C;
  const int blocks = clamp_blocks(a.outer * ((a.len + 31) / 32),
                                  fit_blocks(layer_norm_cf_bwd<T, W>, threads, fit), a.n_partials);
  float* partials = a.dscale != nullptr ? a.partials : nullptr;
  layer_norm_cf_bwd<T, W><<<blocks, threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), static_cast<const W*>(a.scale),
      a.mean, a.rstd, static_cast<T*>(a.y), partials, a.outer, a.C, a.len);
  const int err = (int)cudaGetLastError();
  return err != 0 || partials == nullptr ? err : finish_go<W>(a, blocks);
}

// dtype, wdtype: 0 f32, 1 bf16 (ops/layer_norm._DTYPES); layout 0 rows
// [outer, C] (T = 1), 1 channel-first [outer, C, T]
bool valid(int dtype, int wdtype, int layout, long long outer, int C, long long T) {
  if (dtype < 0 || dtype > 1 || wdtype < 0 || wdtype > 1 || outer < 0 || T < 0) return false;
  if (layout == 0) return T == 1 && C >= 8 && C <= kRowsMaxC && C % 8 == 0;
  return layout == 1 && C >= kCfChannels && C <= kCfMaxC && C % kCfChannels == 0;
}

template <template <typename, typename> class Pass>
int by_type(int dtype, int wdtype, const Args& a, int layout) {
  if (dtype == 0)
    return wdtype == 0 ? Pass<float, float>::run(a, layout)
                       : Pass<float, __nv_bfloat16>::run(a, layout);
  return wdtype == 0 ? Pass<__nv_bfloat16, float>::run(a, layout)
                     : Pass<__nv_bfloat16, __nv_bfloat16>::run(a, layout);
}

template <typename T, typename W>
struct Forward {
  static int run(const Args& a, int layout) {
    if (a.outer == 0 || a.len == 0) return 0;
    return layout == 0 ? rows_fwd_launch<T, W>(a) : cf_fwd_launch<T, W>(a);
  }
};

template <typename T, typename W>
struct Backward {
  static int run(const Args& a, int layout) {
    if (a.outer == 0 || a.len == 0) return a.dscale != nullptr ? finish_go<W>(a, 0) : 0;
    return layout == 0 ? rows_bwd_launch<T, W>(a) : cf_bwd_launch<T, W>(a);
  }
};

}  // namespace

// x, y, scale, bias, mean and rstd (f32, one a normalised vector, or both
// null), dtype (x and y), wdtype (scale and bias), layout, outer, C, T,
// ldy, eps, stream. Layout 0: x and y [outer, C] rows (T = 1); 1: x
// [outer, C, T] normalised over C, y [outer, C, ldy] (its first T of each
// row). Every pointer 16-byte aligned (the wrapper's copies).
extern "C" int aat_layer_norm_fwd(const void* x, void* y, const void* scale, const void* bias,
                                  float* mean, float* rstd, int dtype, int wdtype, int layout,
                                  long long outer, int C, long long T, long long ldy, float eps,
                                  cudaStream_t stream) {
  if (!valid(dtype, wdtype, layout, outer, C, T) || (mean == nullptr) != (rstd == nullptr) ||
      (layout == 1 && ldy < T))
    return (int)cudaErrorInvalidValue;
  const Args a{x, nullptr, y, scale, bias, mean, rstd, nullptr, nullptr, nullptr, 0,
               outer, C, T, ldy, eps, stream};
  return by_type<Forward>(dtype, wdtype, a, layout);
}

// x, dy, scale, the forward's mean and rstd, dx, dscale and dbias (in
// wdtype, or both null: no parameter gradient), partials (f32 scratch of
// n_partials · 2 · C), n_partials, then the forward's dtype, wdtype,
// layout, outer, C, T, and stream. dy and dx lie as x does.
extern "C" int aat_layer_norm_bwd(const void* x, const void* dy, const void* scale,
                                  const float* mean, const float* rstd, void* dx, void* dscale,
                                  void* dbias, float* partials, int n_partials, int dtype,
                                  int wdtype, int layout, long long outer, int C, long long T,
                                  cudaStream_t stream) {
  if (!valid(dtype, wdtype, layout, outer, C, T) || (dscale == nullptr) != (dbias == nullptr) ||
      (dscale != nullptr && (partials == nullptr || n_partials < 1)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, dy, dx, scale, nullptr, const_cast<float*>(mean), const_cast<float*>(rstd),
               dscale, dbias, partials, n_partials, outer, C, T, T, 0.0f, stream};
  return by_type<Backward>(dtype, wdtype, a, layout);
}
