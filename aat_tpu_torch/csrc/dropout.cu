// Element dropout of ops/dropout.dropout: y = keep ? x·scale : +0, with the
// keep mask hashed from each element's flat index in the global tensor,
// mix32(idx ^ seed), kept where its top 24 bits are >= keep_min. The
// backward entry runs the same pass on dy (dx = keep ? dy·scale : 0): the
// mask is regenerated from the seed, so the forward saves nothing for it.
//
// Replaces no TPU kernel: the JAX package writes the dropout in plain jnp
// (aat_tpu/ops/dropout.py), which XLA fuses into one pass. The port's plain
// version computes the same 32-bit hash in int64 (torch's >> on int32 is
// arithmetic), in about 20 element-wise launches of 8-byte integers a call;
// this kernel is that plain version in one pass.
//
// Bits: the index is built in uint32 wrapping arithmetic, idx = idx·extent +
// (coord + offset) over the dims, which is the plain version's int64 index
// masked to its low 32 bits. keep_min = ceil(float32(rate)·2^24) (the
// wrapper's), so (h >> 8) >= keep_min is exactly the plain version's
// (h >> 8)·2^-24 >= float32(rate). A survivor is float(x)·scale rounded
// once to x's type, scale being 1/(1 - rate) already rounded to that type:
// the bits of torch's x * scale, and of autograd's backward of it.
//
// What bounds it on the H100: bytes. x is read once and y written once, 4
// bytes an element in bf16 (8 in f32), over 3.35 TB/s; the hash is about 10
// integer operations an element, under the INT32 throughput at that
// traffic. The design keeps everything in registers: 16-byte vector loads
// and stores (8 bf16 or f16, 4 f32), one hash per element, a grid of as
// many blocks as fit on the SMs walking the vectors in a grid-stride loop
// with a 64-bit index (two vectors in flight a thread), the index cut to
// 32 bits only for the hash. Elements a vector cannot take (a start off
// 16 bytes, a last dim that is not a multiple of the vector, the tail)
// go one at a time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kMaxDims = 4;
constexpr int kThreads = 256;

// The dims the wrapper walks (row-major, local sizes), each with the global
// offset of its local coordinate 0 and its global extent, both mod 2^32
// (dim 0's extent is never used).
struct Place {
  long long size[kMaxDims];
  uint32_t offset[kMaxDims];
  uint32_t extent[kMaxDims];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// The global flat index (mod 2^32) of local flat element i.
template <int NDIM>
__device__ __forceinline__ uint32_t global_index(const Place& p, unsigned long long i) {
  if constexpr (NDIM == 1) return (uint32_t)i + p.offset[0];
  uint32_t idx = 0, mult = 1;
#pragma unroll
  for (int d = NDIM - 1; d > 0; --d) {
    const unsigned long long size = (unsigned long long)p.size[d];
    idx += ((uint32_t)(i % size) + p.offset[d]) * mult;
    mult *= p.extent[d];
    i /= size;
  }
  return idx + ((uint32_t)i + p.offset[0]) * mult;
}

template <typename T>
__device__ __forceinline__ T drop(T v, uint32_t idx, uint32_t seed, uint32_t keep_min,
                                  float scale) {
  const bool keep = (aat_flash::mix32(idx ^ seed) >> 8) >= keep_min;
  return keep ? from_float<T>(__fmul_rn(to_float(v), scale)) : from_float<T>(0.0f);
}

template <typename T>
struct alignas(16) Pack {
  T e[16 / sizeof(T)];
};

// One vector of elements at flat element v·V: the wrapper takes vectors
// where their indices are consecutive (one dim, or V dividing the last).
template <typename T, int NDIM>
__device__ __forceinline__ Pack<T> drop_pack(const Pack<T>& in, const Place& p, long long v,
                                             uint32_t seed, uint32_t keep_min, float scale) {
  constexpr int V = 16 / sizeof(T);
  const uint32_t base = global_index<NDIM>(p, (unsigned long long)v * V);
  Pack<T> out;
#pragma unroll
  for (int k = 0; k < V; ++k) out.e[k] = drop(in.e[k], base + k, seed, keep_min, scale);
  return out;
}

template <typename T, int NDIM>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, long long n_vec,
                   Place p, uint32_t seed, uint32_t keep_min, float scale) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(x);
  Pack<T>* yp = reinterpret_cast<Pack<T>*>(y);
  for (long long v = first; v < n_vec; v += 2 * stride) {
    const long long w = v + stride;
    const Pack<T> a = xp[v];
    Pack<T> b;
    if (w < n_vec) b = xp[w];
    yp[v] = drop_pack<T, NDIM>(a, p, v, seed, keep_min, scale);
    if (w < n_vec) yp[w] = drop_pack<T, NDIM>(b, p, w, seed, keep_min, scale);
  }
  for (long long i = n_vec * V + first; i < n; i += stride)
    y[i] = drop(x[i], global_index<NDIM>(p, (unsigned long long)i), seed, keep_min, scale);
}

template <typename T, int NDIM>
int launch(const void* x, void* y, long long n, const Place& p, uint32_t seed,
           uint32_t keep_min, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0 &&
                   (NDIM == 1 || p.size[NDIM - 1] % V == 0);
  const long long n_vec = vec ? n / V : 0;
  // as many blocks as fit on the card at once (the counts are the same on
  // every card of a process: one kind of GPU)
  static int fit = 0;
  if (fit == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dropout_kernel<T, NDIM>, kThreads,
                                                  0);
    fit = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long work = n_vec > 0 ? (n_vec + 1) / 2 : n;  // threads that find work
  const long long blocks = (work + kThreads - 1) / kThreads;
  dropout_kernel<T, NDIM><<<(int)(blocks < fit ? blocks : fit), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, n_vec, p, seed, keep_min, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dims(const void* x, void* y, long long n, int ndim, const Place& p, uint32_t seed,
                uint32_t keep_min, float scale, cudaStream_t stream) {
  switch (ndim) {
    case 1: return launch<T, 1>(x, y, n, p, seed, keep_min, scale, stream);
    case 2: return launch<T, 2>(x, y, n, p, seed, keep_min, scale, stream);
    case 3: return launch<T, 3>(x, y, n, p, seed, keep_min, scale, stream);
    case 4: return launch<T, 4>(x, y, n, p, seed, keep_min, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 f32, 1 bf16, 2 f16 (ops/dropout._DTYPES)
int dropout_entry(const void* x, void* y, int dtype, int ndim, const long long* size,
                  const long long* offset, const long long* extent, int seed, int keep_min,
                  float scale, cudaStream_t stream) {
  if (ndim < 1 || ndim > kMaxDims || keep_min < 0) return (int)cudaErrorInvalidValue;
  Place p;
  long long n = 1;
  for (int d = 0; d < kMaxDims; ++d) {
    p.size[d] = d < ndim ? size[d] : 1;
    p.offset[d] = (uint32_t)offset[d];
    p.extent[d] = (uint32_t)extent[d];
    if (p.size[d] < 0) return (int)cudaErrorInvalidValue;
    n *= p.size[d];
  }
  if (n == 0) return 0;
  const uint32_t s = (uint32_t)seed, k = (uint32_t)keep_min;
  switch (dtype) {
    case 0: return launch_dims<float>(x, y, n, ndim, p, s, k, scale, stream);
    case 1: return launch_dims<__nv_bfloat16>(x, y, n, ndim, p, s, k, scale, stream);
    case 2: return launch_dims<__half>(x, y, n, ndim, p, s, k, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y, dtype, ndim, the dims' local sizes, global offsets and global
// extents (4 each; past ndim the sizes are ignored), seed, keep_min, scale,
// stream. Both entries compute the same pass; they are two so the launch
// counts tell the forward from the backward.
extern "C" int aat_dropout_fwd(const void* x, void* y, int dtype, int ndim, long long size0,
                               long long size1, long long size2, long long size3,
                               long long offset0, long long offset1, long long offset2,
                               long long offset3, long long extent0, long long extent1,
                               long long extent2, long long extent3, int seed, int keep_min,
                               float scale, cudaStream_t stream) {
  const long long size[] = {size0, size1, size2, size3};
  const long long offset[] = {offset0, offset1, offset2, offset3};
  const long long extent[] = {extent0, extent1, extent2, extent3};
  return dropout_entry(x, y, dtype, ndim, size, offset, extent, seed, keep_min, scale, stream);
}

// dy, dx and the forward's arguments: dx = keep ? dy·scale : 0
extern "C" int aat_dropout_bwd(const void* dy, void* dx, int dtype, int ndim, long long size0,
                               long long size1, long long size2, long long size3,
                               long long offset0, long long offset1, long long offset2,
                               long long offset3, long long extent0, long long extent1,
                               long long extent2, long long extent3, int seed, int keep_min,
                               float scale, cudaStream_t stream) {
  const long long size[] = {size0, size1, size2, size3};
  const long long offset[] = {offset0, offset1, offset2, offset3};
  const long long extent[] = {extent0, extent1, extent2, extent3};
  return dropout_entry(dy, dx, dtype, ndim, size, offset, extent, seed, keep_min, scale, stream);
}
