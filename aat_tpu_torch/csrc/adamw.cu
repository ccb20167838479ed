// The fused guarded AdamW step of training/optim.fused_guarded_adamw in two
// passes over every trainable leaf, in place:
//
//   aat_adamw_sumsq   the sum of squares of g·inv_n (g / n, the mean over
//                     the step's microbatches), one f32 partial a block;
//   aat_adamw_update  each block sums the partials to gn (or reads gn, the
//                     mesh's norm over shards), ok = isfinite(gn), the
//                     clip's scale; then per element
//                       gs = g·inv_n·scale
//                       m  = (1-b1)·gs + b1·m
//                       v  = (1-b2)·gs² + b2·v
//                       p += -lr·((m/bc1) / (sqrt(v/bc2) + eps) [+ wd·p])
//                     and, where ok is false, returns before touching p, m
//                     or v.
//
// Replaces no TPU kernel: the JAX package writes the optimizer in optax's
// jnp, which XLA fuses. It replaces the port's plain eager chain (the same
// functions of training/optim, still the CPU route): about 28 element-wise
// launches a leaf over some 425 leaves, each reading and writing every
// value again, all waiting on Python's dispatch.
//
// Value for value: every product, sum, quotient and square root is an
// explicitly rounded intrinsic in the plain route's order (nvcc contracts
// nothing into an FMA), the hyper-parameters are the f32 roundings torch
// gives its Python scalars, and lr, bc1 and bc2 are the plain route's own
// device scalars, read by pointer. inv_n is float32(1/n): torch's CUDA
// g / n for a Python n multiplies by that reciprocal (exact for n = 2).
// The clip's scale is torch's clip / gn, reciprocal(gn)·clip. Without a
// clip p, m and v are then the plain route's bits; with one, gn sums in
// another order than torch's sum over leaves, and only that differs. The
// partials are summed in a fixed order, with no atomics: gn is the same
// from run to run and in every block.
//
// What bounds it on the H100: bytes. One step reads g twice (once for the
// norm) and reads and writes p, m and v: 32 bytes a value, about 10.3 GB
// at HuBERT-large + the adapter, 3.1 ms at 3.35 TB/s. The design moves
// each of those bytes once: 16-byte vector loads and stores (leaves are
// separate allocations; a leaf whose pointers are not all 16-byte aligned
// goes one element at a time, as does a leaf's tail), and a persistent
// grid that walks (leaf, chunk) work items of kChunk values, so a 4096 x
// 1024 kernel splits into 512 items and a 1,024-value bias is one.
//
// The leaf table travels in the kernel's parameter space, one struct by
// value (__grid_constant__, read in place), and not as a device table:
// the launch snapshots it, so the host may rewrite its arrays for the next
// step without waiting for this one, and no upload precedes the kernel.
// kMaxLeaves leaves fit in 22.6 KB of the 32 KB that CUDA 12.1 allows; a
// longer list (a trained LM besides the encoder) launches once per
// kMaxLeaves leaves, the sum's later launches adding to the partials.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 512;
constexpr long long kChunk = 8192;  // values a work item (a multiple of 4)

struct Leaves {
  const float* g[kMaxLeaves];
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long numel[kMaxLeaves];
  int first_item[kMaxLeaves + 1];  // leaf l's work items: [first_item[l], first_item[l + 1])
  unsigned int decay[kMaxLeaves / 32];
  int n_leaves;
};

// the per-element constants, as f32
struct Step {
  float inv_n, scale, b1, c1, b2, c2, bc1, bc2, eps, wd, neg_lr;
};

struct Hyper {
  float inv_n, b1, c1, b2, c2, eps, wd, clip;
  int has_clip;
  const float* neg_lr;
  const float* bc1;
  const float* bc2;
};

// the leaf whose items hold ``item``: the last l with first_item[l] <= item
__device__ __forceinline__ int leaf_of(const Leaves& t, int item) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_item[mid] <= item) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The block's sum in a fixed order (a shuffle tree in each warp, then the
// warps' sums in warp 0), valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float square_of_mean(float g, float inv_n, float acc) {
  const float x = __fmul_rn(g, inv_n);
  return __fadd_rn(acc, __fmul_rn(x, x));
}

__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const __grid_constant__ Leaves t, float inv_n, float* __restrict__ partials,
                 int accumulate) {
  __shared__ float red[kThreads / 32];
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  const int items = t.first_item[t.n_leaves];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int l = leaf_of(t, item);
    const long long start = (long long)(item - t.first_item[l]) * kChunk;
    const long long len = min(kChunk, t.numel[l] - start);
    const float* g = t.g[l] + start;
    long long done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const long long n_vec = len >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (long long i = threadIdx.x; i < n_vec; i += kThreads) {
        const float4 x = __ldg(g4 + i);
        a0 = square_of_mean(x.x, inv_n, a0);
        a1 = square_of_mean(x.y, inv_n, a1);
        a2 = square_of_mean(x.z, inv_n, a2);
        a3 = square_of_mean(x.w, inv_n, a3);
      }
      done = n_vec << 2;
    }
    for (long long i = done + threadIdx.x; i < len; i += kThreads)
      a0 = square_of_mean(__ldg(g + i), inv_n, a0);
  }
  const float s = block_sum(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)), red);
  if (threadIdx.x == 0)
    partials[blockIdx.x] = accumulate ? __fadd_rn(partials[blockIdx.x], s) : s;
}

// The plain route's leaf update (training/optim.fused_guarded_adamw's
// ``leaf`` and apply_updates), op for op.
__device__ __forceinline__ void adamw(float g, float& p, float& m, float& v, const Step& s,
                                      bool decay) {
  const float gs = __fmul_rn(__fmul_rn(g, s.inv_n), s.scale);
  m = __fadd_rn(__fmul_rn(s.c1, gs), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.c2, __fmul_rn(gs, gs)), __fmul_rn(s.b2, v));
  float d = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (decay) d = __fadd_rn(d, __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, d));
}

__global__ void __launch_bounds__(kThreads)
    update_kernel(const __grid_constant__ Leaves t, const Hyper h,
                  const float* __restrict__ partials, int n_partials, float* gn_io) {
  __shared__ float red[kThreads / 32];
  __shared__ float gn_shared;
  if (n_partials > 0) {
    float s = 0.0f;
    for (int i = threadIdx.x; i < n_partials; i += kThreads) s = __fadd_rn(s, partials[i]);
    s = block_sum(s, red);
    if (threadIdx.x == 0) {
      gn_shared = __fsqrt_rn(s);
      if (blockIdx.x == 0) *gn_io = gn_shared;
    }
  } else if (threadIdx.x == 0) {
    gn_shared = *gn_io;
  }
  __syncthreads();
  const float gn = gn_shared;
  if (!isfinite(gn)) return;  // the guard: p, m and v stay as they were
  Step s;
  s.inv_n = h.inv_n;
  // torch's where(gn < clip, 1, clip / gn), clip / gn being reciprocal(gn)·clip
  s.scale = h.has_clip && !(gn < h.clip) ? __fmul_rn(__fdiv_rn(1.0f, gn), h.clip) : 1.0f;
  s.b1 = h.b1;
  s.c1 = h.c1;
  s.b2 = h.b2;
  s.c2 = h.c2;
  s.bc1 = *h.bc1;
  s.bc2 = *h.bc2;
  s.eps = h.eps;
  s.wd = h.wd;
  s.neg_lr = *h.neg_lr;
  const int items = t.first_item[t.n_leaves];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int l = leaf_of(t, item);
    const long long start = (long long)(item - t.first_item[l]) * kChunk;
    const long long len = min(kChunk, t.numel[l] - start);
    const bool decay = (t.decay[l >> 5] >> (l & 31)) & 1u;
    const float* g = t.g[l] + start;
    float* p = t.p[l] + start;
    float* m = t.m[l] + start;
    float* v = t.v[l] + start;
    long long done = 0;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(p) |
                           reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
    if ((bits & 15) == 0) {
      const long long n_vec = len >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (long long i = threadIdx.x; i < n_vec; i += kThreads) {
        const float4 gi = __ldg(g4 + i);
        float4 pi = p4[i], mi = m4[i], vi = v4[i];
        adamw(gi.x, pi.x, mi.x, vi.x, s, decay);
        adamw(gi.y, pi.y, mi.y, vi.y, s, decay);
        adamw(gi.z, pi.z, mi.z, vi.z, s, decay);
        adamw(gi.w, pi.w, mi.w, vi.w, s, decay);
        p4[i] = pi;
        m4[i] = mi;
        v4[i] = vi;
      }
      done = n_vec << 2;
    }
    for (long long i = done + threadIdx.x; i < len; i += kThreads) {
      float pi = p[i], mi = m[i], vi = v[i];
      adamw(__ldg(g + i), pi, mi, vi, s, decay);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }
}

// Leaves [first, first + count) of the host arrays into ``t``; false where
// a size is negative or the work items overflow an int.
bool fill(Leaves& t, const void* g, const void* p, const void* m, const void* v,
          const void* numel, const void* decay, int first, int count) {
  const float* const* gs = static_cast<const float* const*>(g) + first;
  const long long* ns = static_cast<const long long*>(numel) + first;
  t.n_leaves = count;
  long long items = 0;
  for (int i = 0; i < count; ++i) {
    if (ns[i] < 0) return false;
    t.g[i] = gs[i];
    t.numel[i] = ns[i];
    t.first_item[i] = (int)items;
    items += (ns[i] + kChunk - 1) / kChunk;
    if (items > INT_MAX) return false;
  }
  t.first_item[count] = (int)items;
  for (int w = 0; w < kMaxLeaves / 32; ++w) t.decay[w] = 0u;
  if (p != nullptr) {
    float* const* ps = static_cast<float* const*>(p) + first;
    float* const* ms = static_cast<float* const*>(m) + first;
    float* const* vs = static_cast<float* const*>(v) + first;
    const int* ds = static_cast<const int*>(decay) + first;
    for (int i = 0; i < count; ++i) {
      t.p[i] = ps[i];
      t.m[i] = ms[i];
      t.v[i] = vs[i];
      if (ds[i]) t.decay[i >> 5] |= 1u << (i & 31);
    }
  }
  return true;
}

}  // namespace

// g (the leaves' gradient pointers, a host array), numel (int64 a leaf),
// n_leaves, inv_n, partials (n_partials f32 on the device; one block
// each), n_partials, stream. Launches once per kMaxLeaves leaves (at least
// once: no leaves write zeros).
extern "C" int aat_adamw_sumsq(const void* g, const void* numel, int n_leaves, float inv_n,
                               float* partials, int n_partials, cudaStream_t stream) {
  if (n_leaves < 0 || n_partials < 1) return (int)cudaErrorInvalidValue;
  Leaves t;
  for (int first = 0; first == 0 || first < n_leaves; first += kMaxLeaves) {
    const int count = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    if (!fill(t, g, nullptr, nullptr, nullptr, numel, nullptr, first, count))
      return (int)cudaErrorInvalidValue;
    sumsq_kernel<<<n_partials, kThreads, 0, stream>>>(t, inv_n, partials, first > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// g, p, m, v (host arrays of device pointers), numel (int64), decay (int),
// n_leaves, inv_n, partials and n_partials (aat_adamw_sumsq's; with
// n_partials 0 gn is read from gn instead, else block 0 writes it there),
// gn (one f32), neg_lr, bc1, bc2 (f32 device scalars: -lr at the step's
// count and the bias corrections), b1, b2, c1 = f32(1 - b1), c2 = f32(1 -
// b2), eps, weight_decay, has_clip, clip, stream. Launches once per
// kMaxLeaves leaves (at least once, so gn is always written).
extern "C" int aat_adamw_update(const void* g, const void* p, const void* m, const void* v,
                                const void* numel, const void* decay, int n_leaves, float inv_n,
                                const float* partials, int n_partials, float* gn,
                                const float* neg_lr, const float* bc1, const float* bc2,
                                float b1, float b2, float c1, float c2, float eps,
                                float weight_decay, int has_clip, float clip,
                                cudaStream_t stream) {
  if (n_leaves < 0 || n_partials < 0) return (int)cudaErrorInvalidValue;
  // as many blocks as fit on the card at once (one kind of GPU a process)
  static int fit = 0;
  if (fit == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, update_kernel, kThreads, 0);
    fit = sms * (per_sm > 0 ? per_sm : 1);
  }
  const Hyper h{inv_n, b1, c1, b2, c2, eps, weight_decay, clip, has_clip, neg_lr, bc1, bc2};
  Leaves t;
  for (int first = 0; first == 0 || first < n_leaves; first += kMaxLeaves) {
    const int count = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    if (!fill(t, g, p, m, v, numel, decay, first, count)) return (int)cudaErrorInvalidValue;
    const int items = t.first_item[count];
    const int blocks = items < 1 ? 1 : (items < fit ? items : fit);
    update_kernel<<<blocks, kThreads, 0, stream>>>(t, h, partials, n_partials, gn);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
