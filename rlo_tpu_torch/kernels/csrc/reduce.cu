// K1: the fused per-step combine of the rootless collectives, out = op(a, b).
//
// Replaces rlo_tpu/pallas/reduce.py:_combine_kernel (the Pallas kernel
// behind fused_combine). It computes what that kernel computes over the
// flat n elements; the (rows, 128) padding and the block grid existed for
// the TPU's lanes and are not carried over:
//   - sum/min/max on f32 and bf16: load, widen to f32, combine, narrow back
//     with round-to-nearest-even (__float2bfloat16_rn);
//   - min/max propagate NaN as torch.minimum/maximum do (a NaN in a wins,
//     then a NaN in b; otherwise fminf/fmaxf). fminf/fmaxf alone drop NaN;
//   - int32 sum/min/max are exact (the TPU kernel rounds them through f32,
//     which is lossy above 2^24; the JAX package's default off the TPU is
//     exact, and the port holds to that). Sums wrap like torch.add;
//   - and/or are bitwise and so independent of the integer type: the
//     wrapper passes them as bytes (dtype code 0), any integer dtype.
// out may alias a (the ring's accumulate path): each element is read
// before it is written by the same thread, so that is safe.
//
// Bound: HBM bytes. The kernel reads a and b once and writes out once,
// 3 * n * itemsize bytes, and does one operation per element, far below
// the card's compute rate; the least time is those bytes over the peak
// HBM bandwidth (3.35 TB/s on an H100 SXM). The design aims at that bound
// and nothing else: 16-byte vector loads and stores (LDG.128/STG.128) when
// all three pointers are 16-byte aligned, kUnroll vectors of a and of b
// loaded by each thread before its first store (enough bytes in flight
// per SM to cover HBM's latency; with one pair a thread the kernel ran at
// about 80 % of the bound), a grid that covers the work with one loop
// step a block up to a cap from the SM count (read once, at the first
// launch), a grid-stride loop beyond it, no shared memory, and a
// scalar tail. Unaligned views (a ring chunk at an odd offset) take the
// scalar path. A route through shared memory with TMA bulk copies was not
// taken: the data needs no reuse or transposition, and plain 16-byte loads
// already keep the memory system busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_AND = 3, OP_OR = 4 };
enum Dtype { DT_BYTES = 0, DT_F32 = 1, DT_BF16 = 2, DT_I32 = 3 };

template <int OP>
__device__ __forceinline__ float combine_f32(float a, float b) {
  if (OP == OP_SUM) return a + b;
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return OP == OP_MIN ? fminf(a, b) : fmaxf(a, b);
}

template <int OP>
__device__ __forceinline__ int32_t combine_i32(int32_t a, int32_t b) {
  if (OP == OP_SUM)  // wrap on overflow like torch.add, without signed UB
    return (int32_t)((uint32_t)a + (uint32_t)b);
  if (OP == OP_MIN) return a < b ? a : b;
  return a > b ? a : b;
}

template <int OP>
__device__ __forceinline__ uint32_t combine_bits(uint32_t a, uint32_t b) {
  return OP == OP_AND ? (a & b) : (a | b);
}

template <int OP>
__device__ __forceinline__ uint8_t combine_byte(uint8_t a, uint8_t b) {
  return OP == OP_AND ? (uint8_t)(a & b) : (uint8_t)(a | b);
}

// One element of each type.
template <int OP, int DT>
struct Elem;

template <int OP>
struct Elem<OP, DT_F32> {
  using T = float;
  static __device__ __forceinline__ T f(T a, T b) { return combine_f32<OP>(a, b); }
};

template <int OP>
struct Elem<OP, DT_BF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T f(T a, T b) {
    return __float2bfloat16_rn(
        combine_f32<OP>(__bfloat162float(a), __bfloat162float(b)));
  }
};

template <int OP>
struct Elem<OP, DT_I32> {
  using T = int32_t;
  static __device__ __forceinline__ T f(T a, T b) { return combine_i32<OP>(a, b); }
};

template <int OP>
struct Elem<OP, DT_BYTES> {
  using T = uint8_t;
  static __device__ __forceinline__ T f(T a, T b) { return combine_byte<OP>(a, b); }
};

// 16 bytes of each type, combined lane by lane.
template <int OP, int DT>
__device__ __forceinline__ uint4 combine_vec(uint4 a, uint4 b) {
  using E = Elem<OP, DT>;
  using T = typename E::T;
  uint4 r;
  if (DT == DT_BYTES) {
    r.x = combine_bits<OP>(a.x, b.x);
    r.y = combine_bits<OP>(a.y, b.y);
    r.z = combine_bits<OP>(a.z, b.z);
    r.w = combine_bits<OP>(a.w, b.w);
    return r;
  }
  const T* pa = reinterpret_cast<const T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
  T* pr = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) pr[i] = E::f(pa[i], pb[i]);
  return r;
}

constexpr int kThreads = 256;
// 16-byte vectors of a (and of b) a thread loads before its stores
constexpr int kUnroll = 4;

template <int OP, int DT>
__global__ void __launch_bounds__(kThreads)
combine_vec_kernel(const uint4* a, const uint4* __restrict__ b, uint4* out,
                   int64_t nvec, const typename Elem<OP, DT>::T* a_tail,
                   const typename Elem<OP, DT>::T* b_tail,
                   typename Elem<OP, DT>::T* out_tail, int64_t ntail) {
  // a and out may alias, so neither is __restrict__ and a is not read
  // through the read-only path; all of a thread's loads of a step precede
  // its stores, and no element is touched by two threads
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t v0 = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       v0 < nvec; v0 += step) {
    uint4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * kThreads;
      if (v < nvec) {
        x[u] = a[v];
        y[u] = __ldg(b + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * kThreads;
      if (v < nvec) out[v] = combine_vec<OP, DT>(x[u], y[u]);
    }
  }
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t < ntail) out_tail[t] = Elem<OP, DT>::f(a_tail[t], b_tail[t]);
}

template <int OP, int DT>
__global__ void combine_scalar_kernel(const typename Elem<OP, DT>::T* a,
                                      const typename Elem<OP, DT>::T* b,
                                      typename Elem<OP, DT>::T* out,
                                      int64_t n) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = Elem<OP, DT>::f(a[i], b[i]);
}

int sm_count() {
  // read once, at the first launch (C++ makes the first call's
  // initialisation thread-safe); no attribute query on later launches
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

int grid_for(int64_t work, int per_thread) {
  // enough blocks to cover the work once, so that a block takes one step
  // of its loop and the block scheduler evens out the last wave (one step
  // a block up to 1 GB an operand on 132 SMs); the grid-stride loop covers
  // the rest. A cap of a wave or two left a partial last wave of
  // long-running blocks, slower than one step a block.
  const int64_t per_block = (int64_t)kThreads * per_thread;
  int64_t blocks = (work + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sm_count() * 256;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <int OP, int DT>
int launch(const void* a, const void* b, void* out, int64_t n,
           cudaStream_t stream) {
  using T = typename Elem<OP, DT>::T;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* to = static_cast<T*>(out);
  bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                   reinterpret_cast<uintptr_t>(b) |
                   reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (aligned) {
    const int64_t per = 16 / sizeof(T);
    int64_t nvec = n / per;
    int64_t done = nvec * per;
    int64_t ntail = n - done;
    // the tail (< 16 bytes) takes the first threads of the first block
    combine_vec_kernel<OP, DT><<<grid_for(nvec, kUnroll), kThreads, 0,
                                 stream>>>(
        reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
        reinterpret_cast<uint4*>(out), nvec, ta + done, tb + done,
        to + done, ntail);
  } else {
    combine_scalar_kernel<OP, DT><<<grid_for(n, 1), kThreads, 0, stream>>>(
        ta, tb, to, n);
  }
  return (int)cudaGetLastError();
}

template <int DT>
int dispatch_float_op(int op, const void* a, const void* b, void* out,
                      int64_t n, cudaStream_t s) {
  switch (op) {
    case OP_SUM: return launch<OP_SUM, DT>(a, b, out, n, s);
    case OP_MIN: return launch<OP_MIN, DT>(a, b, out, n, s);
    case OP_MAX: return launch<OP_MAX, DT>(a, b, out, n, s);
  }
  return -1;
}

}  // namespace

// Plain C interface, loaded with ctypes: one parameter block, packed on the
// host in one step (a ctypes call's cost grows with its argument count).
// Returns the cudaGetLastError() code after the launch (0 = cudaSuccess), or
// -1 for an op/dtype pair the kernel does not take. n is the element count
// of dtype; for DT_BYTES it is the byte count. Launches on `stream`, does
// not synchronise, and allocates nothing.
struct CombineParams {
  uint64_t a, b, out;
  int64_t n;
  uint64_t stream;
  int32_t op, dtype;
};
static_assert(sizeof(CombineParams) == 48, "packed as <5Q2i");

extern "C" int rlo_fused_combine(const void* params) {
  CombineParams p;
  memcpy(&p, params, sizeof p);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p.stream);
  const void* a = reinterpret_cast<const void*>(p.a);
  const void* b = reinterpret_cast<const void*>(p.b);
  void* out = reinterpret_cast<void*>(p.out);
  const int64_t n = p.n;
  if (n <= 0) return 0;
  if (p.dtype == DT_BYTES) {
    if (p.op == OP_AND) return launch<OP_AND, DT_BYTES>(a, b, out, n, s);
    if (p.op == OP_OR) return launch<OP_OR, DT_BYTES>(a, b, out, n, s);
    return -1;
  }
  switch (p.dtype) {
    case DT_F32: return dispatch_float_op<DT_F32>(p.op, a, b, out, n, s);
    case DT_BF16: return dispatch_float_op<DT_BF16>(p.op, a, b, out, n, s);
    case DT_I32: return dispatch_float_op<DT_I32>(p.op, a, b, out, n, s);
  }
  return -1;
}
