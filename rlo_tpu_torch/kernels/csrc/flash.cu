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
// o in registers, starting from the carried (m, l, o) it is given. q, k and
// v share one head count: the wrapper folds a GQA group into the query axis,
// as the TPU wrapper does. Ragged Lq and Lk edges are masked (rows past Lq are not stored,
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

// The one score routine of K2-K5: s[i][j] = sum over d = 0..D-1 of
// a[ty*4+i][d] * b[tx+16*j][d], one fmaf chain in that order from 0, on
// f32 tiles of row stride D + 1. The backward's tie routing compares the
// recomputed score with the forward's running max m' for equality, so every
// kernel must form each score with these bits: the same chain, then a
// separate multiply by scale (__fmul_rn in K3-K5, which nothing contracts).
template <int D>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int ty, int tx, float s[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

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
                 float* __restrict__ o_out, int Lq, int Lk, int causal,
                 float scale) {
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
  const T* qh = q + (size_t)h * Lq * D;
  const T* kh = k + (size_t)h * Lk * D;
  const T* vh = v + (size_t)h * Lk * D;

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
    tile_dots<D>(qs, ks, ty, tx, s);
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
           float* m2, float* l2, float* o2, int H, int Lq, int Lk,
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
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const float* m, const float* l, const float* o, const int* qp,
               const int* kp, float* m2, float* l2, float* o2, int H,
               int Lq, int Lk, int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, m, l, o, qp, kp, m2, l2, o2, H, Lq, Lk, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, m, l, o, qp, kp, m2, l2, o2, H, Lq, Lk, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, m, l, o, qp, kp, m2, l2, o2, H, Lq, Lk, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, m, l, o, qp, kp, m2, l2, o2, H, Lq, Lk, causal, scale, s);
  }
  return -1;
}


// ---------------------------------------------------------------------------
// K3-K5: the backward of the block update.
//
// Replace rlo_tpu/pallas/flash.py:_rowstats_kernel (K3), _bwd_dq_kernel (K4)
// and _bwd_dkv_kernel (K5), the Pallas kernels behind _pallas_bwd. The host
// glue (kernels/flash.py) has already folded any GQA group into the query
// axis, so q, k and v share the head count here; it has also formed the
// per-row pieces m' (the forward's running max), dl' (the l' cotangent),
// do' (the o' cotangent, f32) and route (the m' cotangent's share per tied
// position, 0 in the fast mode). With the recomputed score tile
//   s~  = where(mask, (q . k^T) * scale, -1e30)     (tile_dots, K2's bits)
//   u   = exp(s~ - m')
//   ds~ = u * where(mask, dl' + do' . v^T, 0) + where(mask & s~ == m', route, 0)
// K3 counts, per row, the positions with s~ == m' (masked ones included);
// K4 sums dq = scale * ds~ . k over the K tiles; K5 sums dv = p^T . do' and
// dk = scale * ds~^T . q over the Q tiles, p = where(mask, u, 0).
//
// The TPU kernels ran a sequential grid axis with the sums in VMEM scratch;
// here K3 and K4 own (head, 64 query rows) and loop over the K tiles, K5
// owns (head, 64 key rows) and loops over every Q tile, each carrying its
// sums in registers, so no two blocks write one output and no atomics are
// needed: gradients are the same bits from run to run. A causal tile that
// no row of the block can see is skipped: its ds~ and p are 0. K3 counts
// such a tile in closed form instead: every position there is masked, so
// s~ = -1e30 and it ties exactly the rows whose m' is -1e30.
//
// Bound: K4 does 3 and K5 4 products of 2 * D FLOPs per unmasked (q, k)
// pair, K3 one; bytes are q, k, v, do' read once and the outputs written
// once. On an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the training
// shapes (64 folded heads, L 1024, D 64, bf16, causal) the bytes bound all
// three, the products close behind for K4 and K5 (the f32 do' and outputs
// are most of the bytes). Like K2
// these first kernels are simple rather than fast: f32 FMAs on the CUDA
// cores from f32 tiles in shared memory, each thread a 4 x 4 patch of the
// score tile and a 4 x (D/16) patch of the output; wgmma, TMA and bf16
// tensor-core products are later work, and they too must reproduce
// tile_dots' bits for the tie comparison or route it differently.

template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n_rows, int tid) {
  constexpr int DP = D + 1;
  for (int i = tid; i < 64 * D; i += kThreads) {
    int r = i / D, c = i % D, gr = r0 + r;
    dst[r * DP + c] = gr < n_rows ? to_f(src[(size_t)gr * D + c]) : 0.f;
  }
}

template <int D>
constexpr size_t bwd_smem_bytes(int n_row_tiles, int n_score_tiles) {
  return sizeof(float) * ((size_t)n_row_tiles * 64 * (D + 1) +
                          (size_t)n_score_tiles * 64 * SP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_rowstats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ m2,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos, float* __restrict__ cnt,
                      int Lq, int Lk, int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // BQ x DP
  float* ks = qs + BQ * (D + 1);    // BK x DP
  __shared__ float m2_s[BQ];
  __shared__ int qp_s[BQ], kp_s[BK];
  __shared__ int qmax_s;

  const int tid = threadIdx.x, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const T* kh = k + (size_t)h * Lk * D;
  load_rows<T, D>(qs, q + (size_t)h * Lq * D, q0, Lq, tid);
  if (tid < BQ) {
    int qr = q0 + tid;
    bool ok = qr < Lq;
    qp_s[tid] = ok ? qpos[qr] : INT_MIN;
    m2_s[tid] = ok ? m2[(size_t)h * Lq + qr] : 0.f;
  }
  if (tid == 0) qmax_s = INT_MIN;
  __syncthreads();
  if (tid < BQ && q0 + tid < Lq) atomicMax(&qmax_s, qp_s[tid]);
  __syncthreads();
  const int qmax = qmax_s;
  const int ty = tid / 16, tx = tid % 16;
  int n[4] = {0, 0, 0, 0};

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    if (tid < BK) kp_s[tid] = k0 + tid < Lk ? kpos[k0 + tid] : INT_MAX;
    int live = __syncthreads_or(!causal ||
                                (tid < BK && k0 + tid < Lk && kp_s[tid] <= qmax));
    if (!live) {  // all masked: s~ = -1e30 at each of its valid positions
      if (tx == 0) {
        int valid = min(BK, Lk - k0);
#pragma unroll
        for (int i = 0; i < 4; ++i) n[i] += m2_s[ty * 4 + i] == kNeg ? valid : 0;
      }
      continue;
    }
    load_rows<T, D>(ks, kh, k0, Lk, tid);
    __syncthreads();
    float s[4][4];
    tile_dots<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c = tx + 16 * j;
        if (k0 + c >= Lk) continue;
        bool mask = !causal || kp_s[c] <= qp_s[r];
        float st = mask ? __fmul_rn(s[i][j], scale) : kNeg;
        n[i] += st == m2_s[r];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      n[i] += __shfl_xor_sync(0xffffffffu, n[i], off);
    int qr = q0 + ty * 4 + i;
    if (tx == 0 && qr < Lq) cnt[(size_t)h * Lq + qr] = (float)n[i];
  }
}

// ds~ and p of one (64 x 64) tile from the score and do'.v^T patches of this
// thread (rows ty*4+i, columns tx+16*j), written to shared memory.
__device__ __forceinline__ void ds_tile(
    const float s[4][4], const float dp[4][4], int ty, int tx, int q0, int k0,
    int Lq, int Lk, int causal, float scale, const int* qp_s,
    const int* kp_s, const float* m2_s, const float* dl_s, const float* rt_s,
    float* dss, float* ps) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = ty * 4 + i;
    float mr = m2_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = tx + 16 * j;
      bool mask = q0 + r < Lq && k0 + c < Lk && (!causal || kp_s[c] <= qp_s[r]);
      float st = mask ? __fmul_rn(s[i][j], scale) : kNeg;
      float u = expf(st - mr);
      float ds = u * (mask ? dl_s[r] + dp[i][j] : 0.f);
      if (mask && st == mr) ds += rt_s[r];
      dss[r * SP + c] = ds;
      if (ps) ps[r * SP + c] = mask ? u : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ m2,
                    const float* __restrict__ dl2,
                    const float* __restrict__ do2,
                    const float* __restrict__ route,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kpos, float* __restrict__ dq,
                    int Lq, int Lk, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // BQ x DP
  float* dos = qs + BQ * DP;    // BQ x DP
  float* ks = dos + BQ * DP;    // BK x DP
  float* vs = ks + BK * DP;     // BK x DP
  float* dss = vs + BK * DP;    // BQ x SP
  __shared__ float m2_s[BQ], dl_s[BQ], rt_s[BQ];
  __shared__ int qp_s[BQ], kp_s[BK];
  __shared__ int qmax_s;

  const int tid = threadIdx.x, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t hq = (size_t)h * Lq;
  const T* kh = k + (size_t)h * Lk * D;
  const T* vh = v + (size_t)h * Lk * D;
  load_rows<T, D>(qs, q + hq * D, q0, Lq, tid);
  load_rows<float, D>(dos, do2 + hq * D, q0, Lq, tid);
  if (tid < BQ) {
    int qr = q0 + tid;
    bool ok = qr < Lq;
    qp_s[tid] = ok ? qpos[qr] : INT_MIN;
    m2_s[tid] = ok ? m2[hq + qr] : 0.f;
    dl_s[tid] = ok ? dl2[hq + qr] : 0.f;
    rt_s[tid] = ok ? route[hq + qr] : 0.f;
  }
  if (tid == 0) qmax_s = INT_MIN;
  __syncthreads();
  if (tid < BQ && q0 + tid < Lq) atomicMax(&qmax_s, qp_s[tid]);
  __syncthreads();
  const int qmax = qmax_s;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    if (tid < BK) kp_s[tid] = k0 + tid < Lk ? kpos[k0 + tid] : INT_MAX;
    int live = __syncthreads_or(!causal ||
                                (tid < BK && k0 + tid < Lk && kp_s[tid] <= qmax));
    if (!live) continue;
    load_rows<T, D>(ks, kh, k0, Lk, tid);
    load_rows<T, D>(vs, vh, k0, Lk, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<D>(qs, ks, ty, tx, s);
    tile_dots<D>(dos, vs, ty, tx, dp);
    ds_tile(s, dp, ty, tx, q0, k0, Lq, Lk, causal, scale, qp_s, kp_s, m2_s,
            dl_s, rt_s, dss, nullptr);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dv_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_[i] = dss[(ty * 4 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float kv = ks[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dv_[i], kv, acc[i][j]);
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
      dq[(hq + qr) * D + tx + 16 * j] = acc[i][j] * scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ m2,
                     const float* __restrict__ dl2,
                     const float* __restrict__ do2,
                     const float* __restrict__ route,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kpos, float* __restrict__ dk,
                     float* __restrict__ dv, int Lq, int Lk, int causal,
                     float scale) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // BQ x DP
  float* dos = qs + BQ * DP;    // BQ x DP
  float* ks = dos + BQ * DP;    // BK x DP
  float* vs = ks + BK * DP;     // BK x DP
  float* dss = vs + BK * DP;    // BQ x SP
  float* ps = dss + BQ * SP;    // BQ x SP
  __shared__ float m2_s[BQ], dl_s[BQ], rt_s[BQ];
  __shared__ int qp_s[BQ], kp_s[BK];
  __shared__ int kmin_s;

  const int tid = threadIdx.x, h = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t hq = (size_t)h * Lq;
  const size_t hk = (size_t)h * Lk;
  load_rows<T, D>(ks, k + hk * D, k0, Lk, tid);
  load_rows<T, D>(vs, v + hk * D, k0, Lk, tid);
  if (tid < BK) kp_s[tid] = k0 + tid < Lk ? kpos[k0 + tid] : INT_MAX;
  if (tid == 0) kmin_s = INT_MAX;
  __syncthreads();
  if (tid < BK && k0 + tid < Lk) atomicMin(&kmin_s, kp_s[tid]);
  __syncthreads();
  const int kmin = kmin_s;
  const int ty = tid / 16, tx = tid % 16;
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    int qp_mine = INT_MIN;
    if (tid < BQ) {
      int qr = q0 + tid;
      bool ok = qr < Lq;
      qp_mine = ok ? qpos[qr] : INT_MIN;
      qp_s[tid] = qp_mine;
      m2_s[tid] = ok ? m2[hq + qr] : 0.f;
      dl_s[tid] = ok ? dl2[hq + qr] : 0.f;
      rt_s[tid] = ok ? route[hq + qr] : 0.f;
    }
    // a causal Q tile whose every row lies before this K tile is skipped
    int live = __syncthreads_or(!causal || (tid < BQ && q0 + tid < Lq &&
                                            qp_mine >= kmin));
    if (!live) continue;
    load_rows<T, D>(qs, q + hq * D, q0, Lq, tid);
    load_rows<float, D>(dos, do2 + hq * D, q0, Lq, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<D>(qs, ks, ty, tx, s);
    tile_dots<D>(dos, vs, ty, tx, dp);
    ds_tile(s, dp, ty, tx, q0, k0, Lq, Lk, causal, scale, qp_s, kp_s, m2_s,
            dl_s, rt_s, dss, ps);
    __syncthreads();
    // this thread: key rows ty*4+i of the tile, head-dim columns tx+16*j
#pragma unroll 4
    for (int rr = 0; rr < BQ; ++rr) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[rr * SP + ty * 4 + i];
        dsv[i] = dss[rr * SP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float dov = dos[rr * DP + tx + 16 * j];
        float qv = qs[rr * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(pv[i], dov, acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv, acc_k[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int kr = k0 + ty * 4 + i;
    if (kr >= Lk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[(hk + kr) * D + tx + 16 * j] = acc_k[i][j] * scale;
      dv[(hk + kr) * D + tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The three backward launches for one (dtype, head_dim). `which` is 3 (K3),
// 4 (K4) or 5 (K5); unused pointers may be null.
template <typename T, int D>
int launch_bwd(int which, const void* q, const void* k, const void* v,
               const float* m2, const float* dl2, const float* do2,
               const float* route, const int* qp, const int* kp, float* out0,
               float* out1, int H, int Lq, int Lk, int causal, float scale,
               cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  dim3 qgrid((Lq + BQ - 1) / BQ, H), kgrid((Lk + BK - 1) / BK, H);
  int e;
  if (which == 3) {
    constexpr size_t smem = bwd_smem_bytes<D>(2, 0);
    if ((e = set_smem(flash_rowstats_kernel<T, D>, smem))) return e;
    flash_rowstats_kernel<T, D><<<qgrid, kThreads, smem, stream>>>(
        tq, tk, m2, qp, kp, out0, Lq, Lk, causal, scale);
  } else if (which == 4) {
    constexpr size_t smem = bwd_smem_bytes<D>(4, 1);
    if ((e = set_smem(flash_bwd_dq_kernel<T, D>, smem))) return e;
    flash_bwd_dq_kernel<T, D><<<qgrid, kThreads, smem, stream>>>(
        tq, tk, tv, m2, dl2, do2, route, qp, kp, out0, Lq, Lk, causal, scale);
  } else if (which == 5) {
    if (Lk <= 0) return 0;
    constexpr size_t smem = bwd_smem_bytes<D>(4, 2);
    if ((e = set_smem(flash_bwd_dkv_kernel<T, D>, smem))) return e;
    flash_bwd_dkv_kernel<T, D><<<kgrid, kThreads, smem, stream>>>(
        tq, tk, tv, m2, dl2, do2, route, qp, kp, out0, out1, Lq, Lk, causal,
        scale);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(int which, int D, const void* q, const void* k,
                 const void* v, const float* m2, const float* dl2,
                 const float* do2, const float* route, const int* qp,
                 const int* kp, float* o0, float* o1, int H, int Lq, int Lk,
                 int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(which, q, k, v, m2, dl2, do2, route, qp, kp, o0, o1, H, Lq, Lk, causal, scale, s);
    case 32: return launch_bwd<T, 32>(which, q, k, v, m2, dl2, do2, route, qp, kp, o0, o1, H, Lq, Lk, causal, scale, s);
    case 64: return launch_bwd<T, 64>(which, q, k, v, m2, dl2, do2, route, qp, kp, o0, o1, H, Lq, Lk, causal, scale, s);
    case 128: return launch_bwd<T, 128>(which, q, k, v, m2, dl2, do2, route, qp, kp, o0, o1, H, Lq, Lk, causal, scale, s);
  }
  return -1;
}

int bwd_entry(int which, int dtype, const void* q, const void* k,
              const void* v, const void* m2, const void* dl2, const void* do2,
              const void* route, const void* q_pos, const void* k_pos,
              void* out0, void* out1, int H, int Lq, int Lk, int D,
              int causal, float scale, void* stream) {
  if (H <= 0 || Lq <= 0) return 0;
  auto args = [&](auto tag) {
    using T = decltype(tag);
    return dispatch_bwd<T>(
        which, D, q, k, v, static_cast<const float*>(m2),
        static_cast<const float*>(dl2), static_cast<const float*>(do2),
        static_cast<const float*>(route), static_cast<const int*>(q_pos),
        static_cast<const int*>(k_pos), static_cast<float*>(out0),
        static_cast<float*>(out1), H, Lq, Lk, causal, scale,
        static_cast<cudaStream_t>(stream));
  };
  if (dtype == 1) return args(float{});
  if (dtype == 2) return args(__nv_bfloat16{});
  return -1;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype 1 = f32, 2 = bf16 (q, k, v).
// Layouts: q (H, Lq, D); k, v (H, Lk, D); m, l (H, Lq); o (H, Lq, D);
// q_pos (Lq), k_pos (Lk) int32; outputs m2, l2, o2 like m, l, o. Returns the
// cudaGetLastError() code after the launch (0 = success) or -1 for a dtype or
// head_dim the kernel does not take. Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int rlo_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, const void* m, const void* l,
                             const void* o, const void* q_pos,
                             const void* k_pos, void* m2, void* l2, void* o2,
                             int H, int Lq, int Lk, int D, int causal,
                             float scale, void* stream) {
  if (H <= 0 || Lq <= 0) return 0;
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
                             Lq, Lk, causal, scale, s);
  if (dtype == 2)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, fm, fl, fo, qp, kp, m2f, l2f,
                                     o2f, H, Lq, Lk, causal, scale, s);
  return -1;
}

// K3-K5. Layouts: q, k, v (H, L, D) of one head count (the GQA group is
// folded into Lq by the caller); m2, dl2, route (H, Lq) f32; do2 (H, Lq, D)
// f32; q_pos (Lq), k_pos (Lk) int32. Outputs: cnt (H, Lq) f32 (K3); dq
// (H, Lq, D) f32 (K4); dk, dv (H, Lk, D) f32 (K5). Every output element is
// written (0 where nothing contributes). Return codes as rlo_flash_fwd's.
extern "C" int rlo_flash_rowstats(int dtype, const void* q, const void* k,
                                  const void* m2, const void* q_pos,
                                  const void* k_pos, void* cnt, int H, int Lq,
                                  int Lk, int D, int causal, float scale,
                                  void* stream) {
  return bwd_entry(3, dtype, q, k, nullptr, m2, nullptr, nullptr, nullptr,
                   q_pos, k_pos, cnt, nullptr, H, Lq, Lk, D, causal, scale,
                   stream);
}

extern "C" int rlo_flash_bwd_dq(int dtype, const void* q, const void* k,
                                const void* v, const void* m2,
                                const void* dl2, const void* do2,
                                const void* route, const void* q_pos,
                                const void* k_pos, void* dq, int H, int Lq,
                                int Lk, int D, int causal, float scale,
                                void* stream) {
  return bwd_entry(4, dtype, q, k, v, m2, dl2, do2, route, q_pos, k_pos, dq,
                   nullptr, H, Lq, Lk, D, causal, scale, stream);
}

extern "C" int rlo_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                 const void* v, const void* m2,
                                 const void* dl2, const void* do2,
                                 const void* route, const void* q_pos,
                                 const void* k_pos, void* dk, void* dv, int H,
                                 int Lq, int Lk, int D, int causal,
                                 float scale, void* stream) {
  return bwd_entry(5, dtype, q, k, v, m2, dl2, do2, route, q_pos, k_pos, dk,
                   dv, H, Lq, Lk, D, causal, scale, stream);
}
