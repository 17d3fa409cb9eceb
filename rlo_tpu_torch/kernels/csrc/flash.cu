// K2: the flash-attention block update (forward), (m, l, o) -> (m', l', o').
//
// Replaces rlo_tpu/pallas/flash.py:_kernel (the Pallas kernel behind
// flash_block_update_hld and flash_attention). It computes what that kernel
// computes, row by row:
//   s    = (q . k^T) * scale           f32 (q, k, v upcast to f32)
//   s    = where(k_pos <= q_pos, s, -1e30)           (causal only)
//   m'   = max(m, rowmax(s))
//   p    = where(mask, exp(s - m'), 0)  kept in f32 for the P.V product
//   corr = exp(m - m')
//   l'   = l * corr + rowsum(p);   o' = o * corr + p . v
// The TPU kernel ran a sequential grid axis over K tiles with the state in
// VMEM scratch; here one block owns (query head h, a tile of BQ query rows)
// and loops over the K tiles itself, carrying m and l in shared memory and
// o in registers, starting from the carried (m, l, o) it is given. GQA: query
// head h reads K/V head h / (H / Hkv), the row mapping of the TPU wrapper's
// fold. Ragged Lq and Lk edges are masked (rows past Lq are not stored,
// columns past Lk count as masked), so any L is accepted. A K tile whose
// every position lies beyond the tile's last query position (causal) is
// skipped: such a tile changes neither m, l nor o.
//
// Bound: max(bytes / 3.35 TB/s, causal FLOPs / 989 TFLOP/s) on an H100 SXM;
// bytes = q, k, v read plus m, l, o written; FLOPs = 4 * H * D * (the
// unmasked (q, k) pairs). At the prefill shapes (folded heads 512, L 1024,
// D 64) the bytes bound it. This first kernel is simple rather than fast:
// every product is an f32 FMA on the CUDA cores (about 67 TFLOP/s at best,
// no tensor cores), tiles are staged in shared memory as f32, each thread
// keeps a 4 x (D/16) patch of the score tile and of o. The design keeps the
// (BQ, Lk) score matrix out of device memory, which is what the TPU kernel
// existed for; wgmma, TMA and bf16 tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;  // 16 x 16: each thread 4 rows x 4 (or D/16) cols
constexpr int SP = BK + 1;     // padded score-tile row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)BQ * SP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, const float* __restrict__ o_in,
                 const int* __restrict__ qpos, const int* __restrict__ kpos,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 float* __restrict__ o_out, int Lq, int Lk, int group,
                 int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // o columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // BQ x DP   query tile (f32)
  float* ks = qs + BQ * DP;     // BK x DP   key tile
  float* vs = ks + BK * DP;     // BK x D    value tile
  float* ss = vs + BK * D;      // BQ x SP   scores, then probabilities
  __shared__ float row_m[BQ], row_l[BQ], row_corr[BQ];
  __shared__ int qp_s[BQ], kp_s[BK];
  __shared__ int qmax_s;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int hk = h / group;
  const T* qh = q + (size_t)h * Lq * D;
  const T* kh = k + (size_t)hk * Lk * D;
  const T* vh = v + (size_t)hk * Lk * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    int r = i / D, c = i % D, qr = q0 + r;
    qs[r * DP + c] = qr < Lq ? to_f(qh[(size_t)qr * D + c]) : 0.f;
  }
  if (tid < BQ) {
    int qr = q0 + tid;
    bool ok = qr < Lq;
    qp_s[tid] = ok ? qpos[qr] : INT_MIN;
    row_m[tid] = ok ? m_in[(size_t)h * Lq + qr] : kNeg;
    row_l[tid] = ok ? l_in[(size_t)h * Lq + qr] : 0.f;
  }
  if (tid == 0) qmax_s = INT_MIN;
  __syncthreads();
  if (tid < BQ && q0 + tid < Lq) atomicMax(&qmax_s, qp_s[tid]);

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int qr = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      acc[i][j] = qr < Lq ? o_in[((size_t)h * Lq + qr) * D + tx + 16 * j] : 0.f;
  }
  __syncthreads();
  const int qmax = qmax_s;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    if (tid < BK) kp_s[tid] = k0 + tid < Lk ? kpos[k0 + tid] : INT_MAX;
    // a causal tile no query row of this block may see is skipped
    int live = __syncthreads_or(!causal ||
                                (tid < BK && k0 + tid < Lk && kp_s[tid] <= qmax));
    if (!live) continue;
    for (int i = tid; i < BK * D; i += kThreads) {
      int r = i / D, c = i % D, kr = k0 + r;
      bool ok = kr < Lk;
      ks[r * DP + c] = ok ? to_f(kh[(size_t)kr * D + c]) : 0.f;
      vs[r * D + c] = ok ? to_f(vh[(size_t)kr * D + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4+i, columns tx+16*j of the tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c = tx + 16 * j;
        bool mask = k0 + c < Lk && (!causal || kp_s[c] <= qp_s[r]);
        ss[r * SP + c] = mask ? s[i][j] * scale : kNeg;
      }
    }
    __syncthreads();

    // row statistics: four threads (one warp quarter) per row
    {
      const int r = tid >> 2, part = tid & 3;
      float mx = kNeg;
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) mx = fmaxf(mx, ss[r * SP + part * 16 + cc]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        int c = part * 16 + cc;
        bool mask = k0 + c < Lk && (!causal || kp_s[c] <= qp_s[r]);
        float p = mask ? expf(ss[r * SP + c] - m_new) : 0.f;
        ss[r * SP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        float corr = expf(m_old - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_corr[r] = corr;
      }
    }
    __syncthreads();

    // o = o * corr + p . v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float corr = row_corr[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty * 4 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int qr = q0 + ty * 4 + i;
    if (qr >= Lq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      o_out[((size_t)h * Lq + qr) * D + tx + 16 * j] = acc[i][j];
  }
  if (tid < BQ && q0 + tid < Lq) {
    m_out[(size_t)h * Lq + q0 + tid] = row_m[tid];
    l_out[(size_t)h * Lq + q0 + tid] = row_l[tid];
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* m,
           const float* l, const float* o, const int* qp, const int* kp,
           float* m2, float* l2, float* o2, int H, int Hkv, int Lq, int Lk,
           int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + BQ - 1) / BQ, H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m, l, o, qp, kp, m2, l2, o2, Lq, Lk,
      H / Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const float* m, const float* l, const float* o, const int* qp,
               const int* kp, float* m2, float* l2, float* o2, int H, int Hkv,
               int Lq, int Lk, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, m, l, o, qp, kp, m2, l2, o2, H, Hkv, Lq, Lk, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, m, l, o, qp, kp, m2, l2, o2, H, Hkv, Lq, Lk, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, m, l, o, qp, kp, m2, l2, o2, H, Hkv, Lq, Lk, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, m, l, o, qp, kp, m2, l2, o2, H, Hkv, Lq, Lk, causal, scale, s);
  }
  return -1;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype 1 = f32, 2 = bf16 (q, k, v).
// Layouts: q (H, Lq, D); k, v (Hkv, Lk, D); m, l (H, Lq); o (H, Lq, D);
// q_pos (Lq), k_pos (Lk) int32; outputs m2, l2, o2 like m, l, o. Returns the
// cudaGetLastError() code after the launch (0 = success) or -1 for a dtype or
// head_dim the kernel does not take. Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int rlo_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, const void* m, const void* l,
                             const void* o, const void* q_pos,
                             const void* k_pos, void* m2, void* l2, void* o2,
                             int H, int Hkv, int Lq, int Lk, int D, int causal,
                             float scale, void* stream) {
  if (H <= 0 || Lq <= 0) return 0;
  if (Hkv <= 0 || H % Hkv) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fm = static_cast<const float*>(m);
  auto fl = static_cast<const float*>(l);
  auto fo = static_cast<const float*>(o);
  auto qp = static_cast<const int*>(q_pos);
  auto kp = static_cast<const int*>(k_pos);
  auto m2f = static_cast<float*>(m2);
  auto l2f = static_cast<float*>(l2);
  auto o2f = static_cast<float*>(o2);
  if (dtype == 1)
    return dispatch_d<float>(D, q, k, v, fm, fl, fo, qp, kp, m2f, l2f, o2f, H,
                             Hkv, Lq, Lk, causal, scale, s);
  if (dtype == 2)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, fm, fl, fo, qp, kp, m2f, l2f,
                                     o2f, H, Hkv, Lq, Lk, causal, scale, s);
  return -1;
}
