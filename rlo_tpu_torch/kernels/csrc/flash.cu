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
// VMEM scratch; here one block owns (query head h, a tile of query rows)
// and loops over the K tiles itself, starting from the carried (m, l, o)
// it is given. q, k and v share one head count: the wrapper folds a GQA
// group into the query axis, as the TPU wrapper does, so the positions of
// one query tile need not be monotone and nothing here takes a row index
// for a position. Ragged Lq and Lk edges are masked (rows past Lq are not
// stored, columns past Lk count as masked), so any L is accepted. A K tile
// that no query row may see (causal) changes neither m, l nor o, whether it
// is skipped or computed.
//
// Bound: max(bytes / 3.35 TB/s, causal FLOPs / 989 TFLOP/s) on an H100 SXM;
// bytes = q, k, v and the carried m, l, o read plus m', l', o' written (the
// f32 o read and written is most of it); FLOPs = 4 * H * D * (the unmasked
// (q, k) pairs). At the prefill shapes (folded heads 512, L 1024, D 64) the
// bytes bound it, the products close behind. On the CUDA cores (67 TFLOP/s
// f32) the products alone took 7x the bound; on the tensor cores what holds
// it back is the instructions issued around each product (the online
// softmax, the split of p) and the latency of the mma chains.
//
// Design, by dtype (a dispatch written here, not a fallback):
// - bf16 q, k, v (the main path: training, prefill, flash_attention) take
//   the tensor cores (flash_fwd_mma_kernel). Each warp owns 16 query rows,
//   a block of 4 warps 64. The Q tile is loaded once and its mma fragments
//   stay in registers; K and V tiles of 64 rows are double-buffered in
//   shared memory as bf16 by cp.async (16-byte copies, zero-filled past
//   Lk), so the next tile's copy runs under this tile's products. Scores
//   are mma.sync m16n8k16 bf16 products with f32 accumulation (mma_scores,
//   the score routine of K2-K5), then an uncontracted __fmul_rn by scale.
//   The online softmax stays in the mma fragments: a row's max and sum are
//   taken across the 4 lanes of a quad that share it (__shfl_xor_sync), p
//   by the SFU's 2^x (ex2.approx, relative error ~2^-22). P.V runs on the
//   tensor cores at the reference's precision: p is split exactly as
//   p_hi = bf16(p), p_lo = bf16(p - p_hi) and p_lo.v + p_hi.v accumulate
//   into the f32 o fragments (~16 bits of p, against bf16's 8, which would
//   move o by ~2^-9 relative). A tile no row of a warp sees is skipped by
//   that warp; a tile all its rows see whole is not masked.
// - f32 q, k, v keep the CUDA-core route (flash_fwd_f32_kernel): the tensor
//   cores cannot form f32 products exactly, and K3-K5 must recompute K2's
//   score bits, so all four f32 kernels form scores with tile_dots' fmaf
//   chain from f32 tiles in shared memory.

#include <cuda.h>  // CUtensorMap (K5's TMA)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;  // 16 x 16: each thread 4 rows x 4 (or D/16) cols
constexpr int SP = BK + 1;     // padded score-tile row
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
constexpr bool kTensor = std::is_same<T, bf16>::value;

// The f32 score routine of K2-K5: s[i][j] = sum over d = 0..D-1 of
// a[ty*4+i][d] * b[tx+16*j][d], one fmaf chain in that order from 0, on
// f32 tiles of row stride D + 1. The backward's tie routing compares the
// recomputed score with the forward's running max m' for equality, so every
// f32 kernel forms each score with these bits, then a separate multiply by
// scale (__fmul_rn in K3-K5, which nothing contracts).
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

// ---------------------------------------------------------------------------
// Tensor-core building blocks (sm_80+ instructions, run on sm_90a).
// bf16 tiles in shared memory have rows of D + 8 elements: the 16-byte pad
// puts the 8 rows an ldmatrix reads in 8 different bank groups.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b on one 16 x 8 tile, k = 16, bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (src must
// still be a valid address).
template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (relative error about 2^-22; 0 for x below -126)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// The exact split of two f32 values into bf16 pairs hi + lo (hi = bf16(x),
// lo = bf16(x - hi); x - hi is exact in f32), packed as mma A registers.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// The mma A fragments of 16 query rows (row stride D + 8) for every
// 16-wide step of d.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const bf16* rows, int lane) {
  const bf16* p = rows + (lane & 15) * (D + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) ldsm_x4(qf[kc], p + kc * 16);
}

// The bf16 score routine of K2-K5: the raw scores of 16 query rows (qf)
// against NT * 8 key rows of kb (row stride D + 8), s[j] the 16 x 8 mma
// tile of keys 8j..8j+7. Each score is mma.sync m16n8k16 accumulation over
// d in 16-wide steps, in order 0..D from a zero accumulator; the caller
// multiplies by scale with __fmul_rn. The backward's tie routing compares
// K3-K5's recomputed score with K2's running max m' for equality, so every
// bf16 kernel forms each score here, with its query rows at the same
// offsets mod 16 and its keys at the same offsets mod 8 (tiles start at
// multiples of 64).
template <int D, int NT>
__device__ __forceinline__ void mma_scores(const uint32_t (&qf)[D / 16][4],
                                           const bf16* kb, int lane,
                                           float (&s)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // lanes 0-7: keys 0-7, d 0-7; 8-15: keys 0-7, d 8-15; 16-23: keys
  // 8-15, d 0-7; 24-31: keys 8-15, d 8-15 of each 16-key pair of tiles
  const bf16* p = kb + ((lane & 7) + ((lane >> 4) << 3)) * (D + 8) + (lane & 8);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, p + jp * 16 * (D + 8) + kc * 16);
      mma_bf16(s[2 * jp], qf[kc], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qf[kc], b[2], b[3]);
    }
}

// ---------------------------------------------------------------------------
// K2, f32 route: CUDA cores, f32 tiles, each thread a 4 x 4 patch of the
// score tile and a 4 x (D/16) patch of o.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)BQ * SP);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ o_in,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kpos, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ o_out,
                     int Lq, int Lk, int causal, float scale) {
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
  const float* qh = q + (size_t)h * Lq * D;
  const float* kh = k + (size_t)h * Lk * D;
  const float* vh = v + (size_t)h * Lk * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    int r = i / D, c = i % D, qr = q0 + r;
    qs[r * DP + c] = qr < Lq ? qh[(size_t)qr * D + c] : 0.f;
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
      ks[r * DP + c] = ok ? kh[(size_t)kr * D + c] : 0.f;
      vs[r * D + c] = ok ? vh[(size_t)kr * D + c] : 0.f;
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
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
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
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
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

// ---------------------------------------------------------------------------
// K2, bf16 route: tensor cores (see the header).
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows = BQ

template <int D>
constexpr size_t mma_smem_bytes() {  // Q tile, 2 K and 2 V tiles, bf16
  return sizeof(bf16) * (size_t)(BQ + 4 * BK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 3 : 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ o_in,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kpos, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ o_out,
                     int Lq, int Lk, int causal, float scale) {
  constexpr int DS = D + 8;             // bf16 row stride in shared memory
  constexpr int CH = D / 8;             // 16-byte chunks per row
  constexpr int RPP = kMmaThreads / CH; // rows per pass of the block's copies
  constexpr int NO = D / 8;             // o fragments (8 columns each)
  constexpr int NS = BK / 8;            // score fragments (8 keys each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x DS
  bf16* ks = qs + BQ * DS;                        // 2 x BK x DS
  bf16* vs = ks + 2 * BK * DS;                    // 2 x BK x DS
  __shared__ int kp_s[2][BK];
  __shared__ int span_s[3];  // max query position; first, last live tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  // the longest causal rows first: they finish last
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t hq = (size_t)h * Lq;
  const bf16* kh = k + (size_t)h * Lk * D;
  const bf16* vh = v + (size_t)h * Lk * D;
  // this thread's 16-byte chunk of each copied row: rows cr + RPP * i
  const int cr = tid / CH, cc = (tid % CH) * 8;

#pragma unroll
  for (int i = 0; i < BQ / RPP; ++i) {
    const int r = cr + i * RPP;
    const bool ok = q0 + r < Lq;
    cp_async16(qs + r * DS + cc, q + (hq + (ok ? q0 + r : 0)) * D + cc, ok);
  }
  cp_async_commit();

  // this lane's rows: hf = 0, 1 is row g + 8 hf of the warp's 16
  bool rok[2];
  int qp[2];
  float mrow[2], lrow[2], o[NO][4];
  int wmax = INT_MIN, wmin = INT_MAX;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + warp * 16 + g + 8 * hf;
    const bool ok = r < Lq;
    rok[hf] = ok;
    qp[hf] = ok ? qpos[r] : INT_MIN;
    mrow[hf] = ok ? m_in[hq + r] : kNeg;
    lrow[hf] = ok ? l_in[hq + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const size_t c = (hq + r) * D + j * 8 + t4 * 2;
      o[j][2 * hf] = ok ? o_in[c] : 0.f;
      o[j][2 * hf + 1] = ok ? o_in[c + 1] : 0.f;
    }
    if (ok) {
      wmax = max(wmax, qp[hf]);
      wmin = min(wmin, qp[hf]);
    }
  }
  // the warp's span of query positions (rows past Lq left out)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(kFull, wmax, off));
    wmin = min(wmin, __shfl_xor_sync(kFull, wmin, off));
  }
  const bool warp_rows = __any_sync(kFull, rok[0]);

  // the K tiles some row of the block may see: all of them, or (causal) the
  // span from the first to the last tile holding a position <= the block's
  // largest query position (a dead tile inside the span is a no-op)
  const int ntiles = (Lk + BK - 1) / BK;
  int first = 0, last = ntiles - 1;
  if (causal) {
    if (tid == 0) {
      span_s[0] = INT_MIN;
      span_s[1] = INT_MAX;
      span_s[2] = -1;
    }
    __syncthreads();
    if (lane == 0) atomicMax(&span_s[0], wmax);
    __syncthreads();
    const int qmax = span_s[0];
    int f = INT_MAX, l = -1;
    for (int i = tid; i < Lk; i += kMmaThreads)
      if (kpos[i] <= qmax) {
        f = min(f, i / BK);
        l = i / BK;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      f = min(f, __shfl_xor_sync(kFull, f, off));
      l = max(l, __shfl_xor_sync(kFull, l, off));
    }
    if (lane == 0) {
      atomicMin(&span_s[1], f);
      atomicMax(&span_s[2], l);
    }
    __syncthreads();
    first = span_s[1];
    last = span_s[2];
  }

  auto load_tile = [&](int t, int buf) {
    const int k0 = t * BK;
    bf16* kd = ks + buf * BK * DS + cr * DS + cc;
    bf16* vd = vs + buf * BK * DS + cr * DS + cc;
#pragma unroll
    for (int i = 0; i < BK / RPP; ++i) {
      const int r = k0 + cr + i * RPP;
      const bool ok = r < Lk;
      const size_t src = (size_t)(ok ? r : 0) * D + cc;
      cp_async16(kd + i * RPP * DS, kh + src, ok);
      cp_async16(vd + i * RPP * DS, vh + src, ok);
    }
    if (tid < BK) {
      const bool ok = k0 + tid < Lk;
      cp_async4(&kp_s[buf][tid], kpos + (ok ? k0 + tid : 0), ok);
    }
    cp_async_commit();
  };

  // one commit group per tile (an empty one past the last), so waiting
  // for all groups but the newest waits for exactly the tile needed
  if (first <= last)
    load_tile(first, 0);
  else
    cp_async_commit();
  cp_async_wait<1>();  // the Q tile
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, qs + warp * 16 * DS, lane);

  for (int t = first, buf = 0; t <= last; ++t, buf ^= 1) {
    if (t < last)
      load_tile(t + 1, buf ^ 1);  // freed by the last iteration's barrier
    else
      cp_async_commit();
    cp_async_wait<1>();  // tile t
    __syncthreads();

    const int k0 = t * BK;
    const int* kp = kp_s[buf];
    // does a row of the warp see a column of this lane; do all see all
    bool sees = false, whole_lane = true;
#pragma unroll
    for (int c = lane; c < BK; c += 32) {
      const bool valid = k0 + c < Lk;
      sees |= valid && (!causal || kp[c] <= wmax);
      whole_lane &= valid && (!causal || kp[c] <= wmin);
    }
    // one tile's update; `masked` (a std::bool_constant) is false for a
    // tile every row of the warp sees whole, which needs no mask
    auto update = [&](auto masked) {
      float s[NS][4];
      mma_scores<D, NS>(qf, ks + buf * BK * DS, lane, s);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[j][e], scale);
          if constexpr (decltype(masked)::value) {
            const int c = j * 8 + t4 * 2 + (e & 1);
            if (!(k0 + c < Lk && (!causal || kp[c] <= qp[e >> 1]))) x = kNeg;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      // m' = max(m, the row's scaled scores) over the quad; p =
      // 2^(s log2e - m' log2e): a masked score (-1e30) gives 0 against a
      // finite m', and a row whose m' is still -1e30 (all masked) takes 0
      // for m' log2e, so its p is 0 too: exp(-1e30 - (-1e30)) = 1 must not
      // leak
      float ml[2], corr[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x = mx[hf];
        x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
        x = fmaxf(x, __shfl_xor_sync(kFull, x, 2));
        const float mn = fmaxf(mrow[hf], x);
        ml[hf] = mn == kNeg ? 0.f : mn * kLog2e;
        corr[hf] = mrow[hf] == mn ? 1.f
                                  : ex2_approx((mrow[hf] - mn) * kLog2e);
        mrow[hf] = mn;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2_approx(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
          s[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sum[hf] += __shfl_xor_sync(kFull, sum[hf], 1);
        sum[hf] += __shfl_xor_sync(kFull, sum[hf], 2);
        lrow[hf] = lrow[hf] * corr[hf] + sum[hf];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
      // o += p_lo . v + p_hi . v; the score fragments of keys
      // 16kc..16kc+15 are the A fragment of step kc. All lo products of a
      // step go before its hi products, so no two neighbouring mma feed
      // one accumulator
      const bf16* vrow =
          vs + (buf * BK + (lane & 15)) * DS + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
        split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
        split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
        uint32_t b[D / 16][4];
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp)
          ldsm_x4_t(b[dp], vrow + kc * 16 * DS + dp * 16);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          mma_bf16(o[2 * dp], lo, b[dp][0], b[dp][1]);
          mma_bf16(o[2 * dp + 1], lo, b[dp][2], b[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          mma_bf16(o[2 * dp], hi, b[dp][0], b[dp][1]);
          mma_bf16(o[2 * dp + 1], hi, b[dp][2], b[dp][3]);
        }
      }
    };
    // warp-uniform: skip a tile none of the warp's rows sees
    if (warp_rows && __any_sync(kFull, sees)) {
      if (__all_sync(kFull, whole_lane))
        update(std::false_type{});
      else
        update(std::true_type{});
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!rok[hf]) continue;
    const size_t r = hq + q0 + warp * 16 + g + 8 * hf;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(o_out + r * D + j * 8 + t4 * 2) =
          make_float2(o[j][2 * hf], o[j][2 * hf + 1]);
    if (t4 == 0) {
      m_out[r] = mrow[hf];
      l_out[r] = lrow[hf];
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A launch takes at most kMaxGridYZ heads on grid.y (CUDA's limit); a
// call with more runs one launch a chunk of heads, each with its per-head
// operands offset to the chunk's first head. The positions carry no head
// axis. A call within the limit is one launch, as before.
constexpr int kMaxGridYZ = 65535;

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* m,
           const float* l, const float* o, const int* qp, const int* kp,
           float* m2, float* l2, float* o2, int H, int Lq, int Lk,
           int causal, float scale, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  int e;
  for (int h0 = 0; h0 < H; h0 += kMaxGridYZ) {
    const int hn = H - h0 < kMaxGridYZ ? H - h0 : kMaxGridYZ;
    const dim3 grid((Lq + BQ - 1) / BQ, hn);
    const size_t oq = (size_t)h0 * Lq, ok = (size_t)h0 * Lk;
    if constexpr (kTensor<T>) {
      constexpr size_t smem = mma_smem_bytes<D>();
      if ((e = set_smem(flash_fwd_mma_kernel<D>, smem))) return e;
      flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
          tq + oq * D, tk + ok * D, tv + ok * D, m + oq, l + oq, o + oq * D,
          qp, kp, m2 + oq, l2 + oq, o2 + oq * D, Lq, Lk, causal, scale);
    } else {
      constexpr size_t smem = smem_bytes<D>();
      if ((e = set_smem(flash_fwd_f32_kernel<D>, smem))) return e;
      flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
          tq + oq * D, tk + ok * D, tv + ok * D, m + oq, l + oq, o + oq * D,
          qp, kp, m2 + oq, l2 + oq, o2 + oq * D, Lq, Lk, causal, scale);
    }
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
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
//   s~  = where(mask, (q . k^T) * scale, -1e30)     (K2's bits)
//   u   = exp(s~ - m')
//   ds~ = u * where(mask, dl' + do' . v^T, 0) + where(mask & s~ == m', route, 0)
// K3 counts, per row, the positions with s~ == m' (masked ones included);
// K4 sums dq = scale * ds~ . k over the K tiles; K5 sums dv = p^T . do' and
// dk = scale * ds~^T . q over the Q tiles, p = where(mask, u, 0).
//
// The TPU kernels ran a sequential grid axis with the sums in VMEM scratch;
// here K3 and K4 own (head, 64 query rows) and loop over the K tiles, K5
// owns (head, 64 key rows; bf16: 128) and loops over the Q tiles, each
// carrying its sums in registers, so no two blocks write one output and no
// atomics are needed: gradients are the same bits from run to run. A
// causal tile that no row of the block can see is skipped: its ds~ and p
// are 0. K3 counts such a tile in closed form instead: every position
// there is masked, so s~ = -1e30 and it ties exactly the rows whose m' is
// -1e30.
//
// The score tile fixes the tie bits. bf16 operands form it with K2's
// routine, mma_scores (tensor-core m16n8k16 steps over d from a zero
// accumulator, query rows at offsets that agree mod 16 and keys mod 8);
// f32 operands with tile_dots. Both are followed by __fmul_rn by scale, as
// in K2, so s~ == m' holds where K2's max came from a score.
//
// Bound: K4 runs 3 and K5 4 products of 2 * D FLOPs per unmasked (q, k)
// pair, K3 one; bytes are q, k, v, do' read once and the outputs written
// once. On an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the training
// shapes (64 folded heads, L 1024, D 64, bf16, causal) the bytes bound all
// three, the products close behind for K4 and K5 (the f32 do' and outputs
// are most of the bytes).
//
// Design, by dtype:
// - The f32 K3-K5 take the CUDA cores: 256 threads, each a 4 x 4 patch of
//   the 64 x 64 score tile and a 4 x (D/16) patch of the output, from f32
//   tiles in shared memory.
// - bf16 K3 (flash_rowstats_mma_kernel) is K4's shape with one product:
//   each warp owns 16 query rows (kK3Warps warps a block), its Q fragments
//   in registers, K tiles of 64 keys and their positions double-buffered by
//   cp.async; the scores land in mma C fragments, where the mask, the
//   multiply by scale and the compare with m' run, and each lane keeps its
//   share of a row's count in a register (no shared score tile, one barrier
//   a tile).
// - bf16 K4 and K5 run every product on the tensor cores (K4 on mma.sync
//   m16n8k16, K5 on wgmma; f32 accumulation). The f32 operands do', ds~ and p are split
//   exactly into bf16 hi + lo (split_bf16: ~16 bits, against bf16's 8,
//   whose one rounding would move the result ~2^-9 relative), so
//   dP = do'_hi.v^T + do'_lo.v^T, dq = ds~_hi.k + ds~_lo.k,
//   dk = ds~_hi^T.q + ds~_lo^T.q and dv = p_hi^T.do'_hi + p_hi^T.do'_lo +
//   p_lo^T.do'_hi (the dropped lo.lo term is ~2^-16 relative): 5 products a
//   pair in K4, 8 in K5, against the score's 1.
//   K4 (flash_bwd_dq_mma_kernel): K2's shape. Each warp owns 16 query rows
//   (a block of 4 warps 64); its Q fragments stay in registers, its do'
//   rows are split once into bf16 tiles; K and V tiles of 64 keys are
//   double-buffered by cp.async. Scores and dP land in mma C fragments,
//   ds~ is formed there, and the ds~ fragments become the A operand of
//   ds~ . k as K2's p does (K from the same tile by ldmatrix.trans).
//   K5 (flash_bwd_dkv_mma_kernel): the Hopper design of its own note
//   below (128 keys a block, the live query tiles only, a TMA ring,
//   dP, dk and dv on wgmma, the scores on mma_scores).
// ---------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n_rows, int tid) {
  constexpr int DP = D + 1;
  for (int i = tid; i < 64 * D; i += kThreads) {
    int r = i / D, c = i % D, gr = r0 + r;
    dst[r * DP + c] = gr < n_rows ? src[(size_t)gr * D + c] : 0.f;
  }
}

// Dynamic shared memory of the f32 CUDA-core kernels: f32 row tiles (row
// stride D + 1) and f32 score tiles (row stride SP).
template <int D>
constexpr size_t bwd_smem_bytes(int f32_row_tiles, int score_tiles) {
  return sizeof(float) * ((size_t)f32_row_tiles * 64 * (D + 1) +
                          (size_t)score_tiles * 64 * SP);
}

// K3, f32 route: 256 threads, each a 4 x 4 patch of the 64 x 64 score tile
// by tile_dots from f32 tiles in shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_rowstats_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ m2,
                          const int* __restrict__ qpos,
                          const int* __restrict__ kpos,
                          float* __restrict__ cnt, int Lq, int Lk, int causal,
                          float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // BQ x D + 1
  float* ks = qs + BQ * (D + 1); // BK x D + 1
  __shared__ float m2_s[BQ];
  __shared__ int qp_s[BQ], kp_s[BK];
  __shared__ int qmax_s;

  const int tid = threadIdx.x, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* kh = k + (size_t)h * Lk * D;
  load_rows<D>(qs, q + (size_t)h * Lq * D, q0, Lq, tid);
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
    load_rows<D>(ks, kh, k0, Lk, tid);
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
      n[i] += __shfl_xor_sync(kFull, n[i], off);
    int qr = q0 + ty * 4 + i;
    if (tx == 0 && qr < Lq) cnt[(size_t)h * Lq + qr] = (float)n[i];
  }
}

// Warps of a bf16 K3 block, each 16 query rows.
constexpr int kK3Warps = 4;
constexpr int K3Q = 16 * kK3Warps;         // query rows of a block
constexpr int kK3Threads = 32 * kK3Warps;

template <int D>
constexpr size_t rowstats_mma_smem_bytes() {  // the Q tile, 2 K tiles, bf16
  return sizeof(bf16) * (size_t)(K3Q + 2 * BK) * (D + 8);
}

// K3, bf16 route: K4's shape without V or do'. Each warp owns 16 query rows
// (a block of kK3Warps warps K3Q) with its Q fragments in registers; K tiles
// of 64 keys and their positions are double-buffered by cp.async; the
// scores come from mma_scores into C fragments, and the mask, the __fmul_rn
// by scale and the compare with m' run there, in registers. A row's count
// is split over the 4 lanes of its quad and summed by shuffles at the end.
// A causal tile that no row of the warp (outside [first, last]: of the
// block) can see is counted in closed form: a row ties its kvalid positions
// exactly when its m' is -1e30.
template <int D>
__global__ void __launch_bounds__(kK3Threads)
flash_rowstats_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const float* __restrict__ m2,
                          const int* __restrict__ qpos,
                          const int* __restrict__ kpos,
                          float* __restrict__ cnt, int Lq, int Lk, int causal,
                          float scale) {
  constexpr int DS = D + 8;             // bf16 row stride in shared memory
  constexpr int CH = D / 8;             // 16-byte chunks per row
  constexpr int RPP = kK3Threads / CH;  // rows per pass of the block's copies
  constexpr int NS = BK / 8;            // score fragments (8 keys each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // K3Q x DS
  bf16* ks = qs + K3Q * DS;                      // 2 x BK x DS
  __shared__ int kp_s[2][BK];
  __shared__ int span_s[3];  // max query position; first, last live tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  // the longest causal rows first: they finish last
  const int q0 = (gridDim.x - 1 - blockIdx.x) * K3Q;
  const size_t hq = (size_t)h * Lq;
  const bf16* kh = k + (size_t)h * Lk * D;
  const int cr = tid / CH, cc = (tid % CH) * 8;

  for (int r = cr; r < K3Q; r += RPP) {
    const bool ok = q0 + r < Lq;
    cp_async16(qs + r * DS + cc, q + (hq + (ok ? q0 + r : 0)) * D + cc, ok);
  }
  cp_async_commit();

  bool ok[2];
  int qp[2];
  float mr[2];
  int wmax = INT_MIN;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + warp * 16 + g + 8 * hf;
    ok[hf] = r < Lq;
    qp[hf] = ok[hf] ? qpos[r] : INT_MIN;
    mr[hf] = ok[hf] ? m2[hq + r] : 0.f;
    if (ok[hf]) wmax = max(wmax, qp[hf]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wmax = max(wmax, __shfl_xor_sync(kFull, wmax, off));
  const bool warp_rows = __any_sync(kFull, ok[0]);

  // the K tiles some row of the block may see, as in K2
  const int ntiles = (Lk + BK - 1) / BK;
  int first = 0, last = ntiles - 1;
  if (causal) {
    if (tid == 0) {
      span_s[0] = INT_MIN;
      span_s[1] = INT_MAX;
      span_s[2] = -1;
    }
    __syncthreads();
    if (lane == 0) atomicMax(&span_s[0], wmax);
    __syncthreads();
    const int qmax = span_s[0];
    int f = INT_MAX, l = -1;
    for (int i = tid; i < Lk; i += kK3Threads)
      if (kpos[i] <= qmax) {
        f = min(f, i / BK);
        l = i / BK;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      f = min(f, __shfl_xor_sync(kFull, f, off));
      l = max(l, __shfl_xor_sync(kFull, l, off));
    }
    if (lane == 0) {
      atomicMin(&span_s[1], f);
      atomicMax(&span_s[2], l);
    }
    __syncthreads();
    first = span_s[1];
    last = span_s[2];
  }

  auto load_tile = [&](int t, int buf) {
    const int k0 = t * BK;
    bf16* kd = ks + buf * BK * DS + cc;
    for (int r = cr; r < BK; r += RPP) {
      const bool in = k0 + r < Lk;
      cp_async16(kd + r * DS, kh + (size_t)(in ? k0 + r : 0) * D + cc, in);
    }
    if (tid < BK) {
      const bool in = k0 + tid < Lk;
      cp_async4(&kp_s[buf][tid], kpos + (in ? k0 + tid : 0), in);
    }
    cp_async_commit();
  };

  // the tiles outside [first, last] hold only masked positions
  const int live_cols =
      first <= last ? min(Lk, (last + 1) * BK) - first * BK : 0;
  int n[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    n[hf] = t4 == 0 && mr[hf] == kNeg ? Lk - live_cols : 0;

  if (first <= last)
    load_tile(first, 0);
  else
    cp_async_commit();
  cp_async_wait<1>();  // the Q tile
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, qs + warp * 16 * DS, lane);

  for (int t = first, buf = 0; t <= last; ++t, buf ^= 1) {
    if (t < last)
      load_tile(t + 1, buf ^ 1);  // freed by the last iteration's barrier
    else
      cp_async_commit();
    cp_async_wait<1>();  // tile t
    __syncthreads();

    const int k0 = t * BK, kvalid = min(BK, Lk - k0);
    const int* kp = kp_s[buf];
    bool sees = false;
#pragma unroll
    for (int c = lane; c < BK; c += 32)
      sees |= c < kvalid && (!causal || kp[c] <= wmax);
    // warp-uniform: a tile none of the warp's rows sees, in closed form
    if (!__any_sync(kFull, sees)) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        n[hf] += t4 == 0 && mr[hf] == kNeg ? kvalid : 0;
    } else if (warp_rows) {
      float s[NS][4];
      mma_scores<D, NS>(qf, ks + buf * BK * DS, lane, s);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + t4 * 2 + (e & 1), hf = e >> 1;
          const bool mask = !causal || kp[c] <= qp[hf];
          const float st = mask ? __fmul_rn(s[j][e], scale) : kNeg;
          n[hf] += c < kvalid && st == mr[hf];
        }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    n[hf] += __shfl_xor_sync(kFull, n[hf], 1);
    n[hf] += __shfl_xor_sync(kFull, n[hf], 2);
    if (t4 == 0 && ok[hf])
      cnt[hq + q0 + warp * 16 + g + 8 * hf] = (float)n[hf];
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ m2,
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
  const float* kh = k + (size_t)h * Lk * D;
  const float* vh = v + (size_t)h * Lk * D;
  load_rows<D>(qs, q + hq * D, q0, Lq, tid);
  load_rows<D>(dos, do2 + hq * D, q0, Lq, tid);
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
    load_rows<D>(ks, kh, k0, Lk, tid);
    load_rows<D>(vs, vh, k0, Lk, tid);
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ m2,
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
  load_rows<D>(ks, k + hk * D, k0, Lk, tid);
  load_rows<D>(vs, v + hk * D, k0, Lk, tid);
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
    load_rows<D>(qs, q + hq * D, q0, Lq, tid);
    load_rows<D>(dos, do2 + hq * D, q0, Lq, tid);
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

// ---------------------------------------------------------------------------
// K4 and K5, bf16 route: tensor cores (see the section header).
// ---------------------------------------------------------------------------

// The rows of one query row pair (hf = 0, 1: rows g and g + 8 of a warp's
// 16) that ds_frags reads.
struct RowVals {
  bool ok[2];
  int qp[2];
  float m2[2], dl[2], rt[2];
};

// c[j] += a . b^T for the 16 rows of a (row stride D + 8, split into bf16
// hi and lo tiles) against NT * 8 rows of b, as mma_scores lays them out:
// the lo products of a 16-wide step of d before its hi products.
template <int D, int NT>
__device__ __forceinline__ void mma_rows_split(const bf16* a_hi,
                                               const bf16* a_lo,
                                               const bf16* b, int lane,
                                               float (&c)[NT][4]) {
  const int ao = (lane & 15) * (D + 8) + (lane >> 4) * 8;
  const bf16* p = b + ((lane & 7) + ((lane >> 4) << 3)) * (D + 8) + (lane & 8);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t hi[4], lo[4], bb[NT / 2][4];
    ldsm_x4(hi, a_hi + ao + kc * 16);
    ldsm_x4(lo, a_lo + ao + kc * 16);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp)
      ldsm_x4(bb[jp], p + jp * 16 * (D + 8) + kc * 16);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      mma_bf16(c[2 * jp], lo, bb[jp][0], bb[jp][1]);
      mma_bf16(c[2 * jp + 1], lo, bb[jp][2], bb[jp][3]);
    }
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      mma_bf16(c[2 * jp], hi, bb[jp][0], bb[jp][1]);
      mma_bf16(c[2 * jp + 1], hi, bb[jp][2], bb[jp][3]);
    }
  }
}

// ds~ (into s, over the raw scores) and, with P, p, in the mma C fragments
// of 16 query rows against NT * 8 keys: element e of tile j is row
// g + 8 (e >> 1), key 8j + 2 t4 + (e & 1) of the keys at kp (kvalid of them
// lie before Lk). The elementwise rule of ds_tile.
template <int NT, bool P>
__device__ __forceinline__ void ds_frags(float (&s)[NT][4],
                                         const float (&dp)[NT][4],
                                         float (&p)[NT][4], const RowVals& rv,
                                         const int* kp, int kvalid,
                                         int causal, float scale, int t4) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + t4 * 2 + (e & 1), hf = e >> 1;
      const bool mask =
          rv.ok[hf] && c < kvalid && (!causal || kp[c] <= rv.qp[hf]);
      const float st = mask ? __fmul_rn(s[j][e], scale) : kNeg;
      const float u = expf(st - rv.m2[hf]);
      float ds = u * (mask ? rv.dl[hf] + dp[j][e] : 0.f);
      if (mask && st == rv.m2[hf]) ds += rv.rt[hf];
      s[j][e] = ds;
      if constexpr (P) p[j][e] = mask ? u : 0.f;
    }
}

// ROWS f32 do' rows (row stride D, n of them valid) split into bf16 hi and
// lo tiles (row stride D + 8), zero past n, by NT threads (t = 0..NT-1).
template <int D, int ROWS, int NT>
__device__ __forceinline__ void split_rows(bf16* hi, bf16* lo,
                                           const float* src, int n, int t) {
  constexpr int C4 = D / 4;
  for (int i = t; i < ROWS * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) x = *reinterpret_cast<const float4*>(src + (size_t)r * D + c);
    uint32_t h0, l0, h1, l1;
    split_bf16(x.x, x.y, h0, l0);
    split_bf16(x.z, x.w, h1, l1);
    *reinterpret_cast<uint2*>(hi + r * (D + 8) + c) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + r * (D + 8) + c) = make_uint2(l0, l1);
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {  // do'_hi (the Q tile first),
  return sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * (D + 8);  // do'_lo, 2 K, 2 V
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 3 : 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ m2,
                        const float* __restrict__ dl2,
                        const float* __restrict__ do2,
                        const float* __restrict__ route,
                        const int* __restrict__ qpos,
                        const int* __restrict__ kpos, float* __restrict__ dq,
                        int Lq, int Lk, int causal, float scale) {
  constexpr int DS = D + 8;             // bf16 row stride in shared memory
  constexpr int CH = D / 8;             // 16-byte chunks per row
  constexpr int RPP = kMmaThreads / CH; // rows per pass of the block's copies
  constexpr int NO = D / 8;             // dq fragments (8 columns each)
  constexpr int NS = BK / 8;            // score fragments (8 keys each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dhi = reinterpret_cast<bf16*>(smem_raw);  // BQ x DS: Q, then do'_hi
  bf16* dlo = dhi + BQ * DS;                      // BQ x DS
  bf16* ks = dlo + BQ * DS;                       // 2 x BK x DS
  bf16* vs = ks + 2 * BK * DS;                    // 2 x BK x DS
  __shared__ int kp_s[2][BK];
  __shared__ int span_s[3];  // max query position; first, last live tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  // the longest causal rows first: they finish last
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t hq = (size_t)h * Lq;
  const bf16* kh = k + (size_t)h * Lk * D;
  const bf16* vh = v + (size_t)h * Lk * D;
  const int cr = tid / CH, cc = (tid % CH) * 8;

#pragma unroll
  for (int i = 0; i < BQ / RPP; ++i) {
    const int r = cr + i * RPP;
    const bool ok = q0 + r < Lq;
    cp_async16(dhi + r * DS + cc, q + (hq + (ok ? q0 + r : 0)) * D + cc, ok);
  }
  cp_async_commit();

  RowVals rv;
  int wmax = INT_MIN;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + warp * 16 + g + 8 * hf;
    const bool ok = r < Lq;
    rv.ok[hf] = ok;
    rv.qp[hf] = ok ? qpos[r] : INT_MIN;
    rv.m2[hf] = ok ? m2[hq + r] : 0.f;
    rv.dl[hf] = ok ? dl2[hq + r] : 0.f;
    rv.rt[hf] = ok ? route[hq + r] : 0.f;
    if (ok) wmax = max(wmax, rv.qp[hf]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wmax = max(wmax, __shfl_xor_sync(kFull, wmax, off));
  const bool warp_rows = __any_sync(kFull, rv.ok[0]);

  // the K tiles some row of the block may see, as in K2
  const int ntiles = (Lk + BK - 1) / BK;
  int first = 0, last = ntiles - 1;
  if (causal) {
    if (tid == 0) {
      span_s[0] = INT_MIN;
      span_s[1] = INT_MAX;
      span_s[2] = -1;
    }
    __syncthreads();
    if (lane == 0) atomicMax(&span_s[0], wmax);
    __syncthreads();
    const int qmax = span_s[0];
    int f = INT_MAX, l = -1;
    for (int i = tid; i < Lk; i += kMmaThreads)
      if (kpos[i] <= qmax) {
        f = min(f, i / BK);
        l = i / BK;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      f = min(f, __shfl_xor_sync(kFull, f, off));
      l = max(l, __shfl_xor_sync(kFull, l, off));
    }
    if (lane == 0) {
      atomicMin(&span_s[1], f);
      atomicMax(&span_s[2], l);
    }
    __syncthreads();
    first = span_s[1];
    last = span_s[2];
  }

  auto load_tile = [&](int t, int buf) {
    const int k0 = t * BK;
    bf16* kd = ks + buf * BK * DS + cr * DS + cc;
    bf16* vd = vs + buf * BK * DS + cr * DS + cc;
#pragma unroll
    for (int i = 0; i < BK / RPP; ++i) {
      const int r = k0 + cr + i * RPP;
      const bool ok = r < Lk;
      const size_t src = (size_t)(ok ? r : 0) * D + cc;
      cp_async16(kd + i * RPP * DS, kh + src, ok);
      cp_async16(vd + i * RPP * DS, vh + src, ok);
    }
    if (tid < BK) {
      const bool ok = k0 + tid < Lk;
      cp_async4(&kp_s[buf][tid], kpos + (ok ? k0 + tid : 0), ok);
    }
    cp_async_commit();
  };

  if (first <= last)
    load_tile(first, 0);
  else
    cp_async_commit();
  cp_async_wait<1>();  // the Q tile
  __syncthreads();
  // the warp's Q fragments, then its do' rows split in place of its Q rows
  bf16* whi = dhi + warp * 16 * DS;
  bf16* wlo = dlo + warp * 16 * DS;
  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, whi, lane);
  __syncwarp();
  split_rows<D, 16, 32>(whi, wlo, do2 + (hq + q0 + warp * 16) * D,
                        Lq - q0 - warp * 16, lane);
  __syncwarp();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = first, buf = 0; t <= last; ++t, buf ^= 1) {
    if (t < last)
      load_tile(t + 1, buf ^ 1);  // freed by the last iteration's barrier
    else
      cp_async_commit();
    cp_async_wait<1>();  // tile t
    __syncthreads();

    const int k0 = t * BK;
    const int* kp = kp_s[buf];
    bool sees = false;
#pragma unroll
    for (int c = lane; c < BK; c += 32)
      sees |= k0 + c < Lk && (!causal || kp[c] <= wmax);
    // warp-uniform: skip a tile none of the warp's rows sees
    if (warp_rows && __any_sync(kFull, sees)) {
      const bf16* kt = ks + buf * BK * DS;
      float s[NS][4], dp[NS][4];
      mma_scores<D, NS>(qf, kt, lane, s);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
      mma_rows_split<D, NS>(whi, wlo, vs + buf * BK * DS, lane, dp);
      ds_frags<NS, false>(s, dp, dp, rv, kp, Lk - k0, causal, scale, t4);
      // dq += ds~_lo . k + ds~_hi . k: the ds~ fragments of keys
      // 16kc..16kc+15 are the A fragment of step kc; k by ldmatrix.trans
      const bf16* krow = kt + (lane & 15) * DS + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
        split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
        split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
        uint32_t b[D / 16][4];
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2)
          ldsm_x4_t(b[dp2], krow + kc * 16 * DS + dp2 * 16);
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          mma_bf16(acc[2 * dp2], lo, b[dp2][0], b[dp2][1]);
          mma_bf16(acc[2 * dp2 + 1], lo, b[dp2][2], b[dp2][3]);
        }
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          mma_bf16(acc[2 * dp2], hi, b[dp2][0], b[dp2][1]);
          mma_bf16(acc[2 * dp2 + 1], hi, b[dp2][2], b[dp2][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!rv.ok[hf]) continue;
    const size_t r = hq + q0 + warp * 16 + g + 8 * hf;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(dq + r * D + j * 8 + t4 * 2) =
          make_float2(acc[j][2 * hf] * scale, acc[j][2 * hf + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// K5, bf16 route: the Hopper design (flash_bwd_dkv_mma_kernel).
//
// Replaces rlo_tpu/pallas/flash.py:320 (_bwd_dkv_kernel) for bf16 q, k, v.
// Bound at the training cell's shape (StarCoder2-3B, 8 x 4096 packed rows:
// 16 folded KV heads, Lq 12 x 4096 = 49,152 query rows whose positions
// repeat 0..4095 once a GQA group, Lk 4,096, D 128, causal): the four
// products the roofline counts (s, dP, dv, dk) are 4 x 4.12e11 FLOPs a
// layer, 1.67 ms at 989 TFLOP/s; the bytes (q, f32 do', k, v and the row
// values read once, f32 dk, dv written) 0.21 ms at 3.35 TB/s. The products
// bound it; this design takes 9.1-9.2 ms there (18 % of the bound, 360
// TFLOP/s of executed products). The split
// precision runs 8 bf16 products where the roofline counts 4: s once, dP
// = do'_hi.v^T + do'_lo.v^T, dv = p_hi^T.do'_hi + p_hi^T.do'_lo +
// p_lo^T.do'_hi, dk = ds~_hi^T.q + ds~_lo^T.q (the dropped lo.lo terms are
// ~2^-16 relative).
//
// Design:
// - A block owns K5K = 128 keys of one head: a producer warpgroup and two
//   consumer warpgroups of 64 keys each (384 threads, one block an SM), so
//   every query tile that crosses memory feeds two warpgroups' products.
//   Blocks run the smallest key positions first (the longest walks): the
//   linear block index takes the head fastest.
// - Live tiles only. A prepass (flash_bwd_dkv_prep_kernel, once a call)
//   writes the largest position of each 64-row query tile; the producer
//   walks those maxima 32 at a time by ballot and hands on only the tiles
//   whose largest position reaches the block's smallest key position
//   (causal; all tiles otherwise). Under the GQA fold the positions repeat,
//   so a block's causal span holds dead tiles: they cost neither a load
//   nor a barrier. The walk reads positions, never the fold's group count
//   (ring, Ulysses and pipeline callers pass any positions).
// - do' is split once a call by the same prepass (hi = bf16(x), lo =
//   bf16(x - hi), split_bf16's rule) and streams as two bf16 tiles.
// - TMA ring. The producer warp keeps kK5Stages stages of (q, do'_hi,
//   do'_lo) tiles in flight by TMA (128-byte-swizzled boxes for D >= 64,
//   the row's own width below; rows past Lq read as zeros) through full and
//   empty mbarriers, and writes each tile's row values (m', dl', route,
//   positions) beside them. v arrives once by TMA; k by cp.async into the
//   padded layout of the score routine.
// - Scores stay on mma.sync: each consumer warp forms its 16 query rows'
//   scores against its warpgroup's 64 keys with mma_scores (m16n8k16 over
//   d from a zero accumulator, then __fmul_rn by scale), by the tie rule:
//   K3-K5 must recompute K2's score bits for the m' tie test, and a wgmma
//   score route would have to move K2-K5 together.
// - The products on wgmma (sm_90a), f32 accumulation in registers. dP =
//   do'.v^T is m64n64k16 with both operands K-major in shared memory; warp
//   w of a warpgroup holds query rows 16w.. in its dP accumulator exactly
//   as in its mma_scores fragments, so ds_frags combines the two in
//   registers. p and ds~ are split into bf16 hi/lo and staged as
//   [query row][key] tiles, read by wgmma as transposed (MN-major) A
//   operands of dk += ds~^T.q and dv += p^T.do' (m64nDk16), with q and do'
//   as MN-major B operands straight from the ring. ds~ and then p share
//   one staging pair a warpgroup (the dk products finish before p lands).
//   setmaxnreg gives the consumers 232 registers (a warpgroup's dk and dv
//   accumulators, 64 keys x D in f32, and a tile's scores and dP) and the
//   producer warpgroup 40. That is all they hold: one 64-bit value more
//   kept live across the tile loop made ptxas spill and serialise every
//   wgmma (check nvcc -Xptxas -v after a change).
// - No atomics: each block owns its key rows, so gradients repeat bit for
//   bit.
// ---------------------------------------------------------------------------

constexpr int K5K = 128;          // keys of a block: two warpgroups of 64
constexpr int K5Q = 64;           // query rows of a tile
constexpr int kK5Stages = 2;      // depth of the (q, do'_hi, do'_lo) ring
constexpr int kK5Threads = 384;   // a producer + two consumer warpgroups

// The shared-memory layout of K5 for head_dim D (byte offsets from a
// 1024-byte-aligned base). Every D-wide bf16 tile is CB column blocks of
// rows x SW bytes, each block swizzled as TMA writes it (16-byte chunk
// index ^= address bits 7.., SW / 16 chunks a period).
template <int D>
struct K5Tiles {
  static constexpr int SW = 2 * D < 128 ? 2 * D : 128;  // swizzle span
  static constexpr int BOX = SW / 2;                     // bf16 a box row
  static constexpr int CB = 2 * D / SW;
  static constexpr uint64_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int QT = K5Q * 2 * D;                 // a query tile
  static constexpr int PT = K5Q * 64 * 2;                // a staged tile
  static constexpr int RING = 0;  // stages x (q, do'_hi, do'_lo)
  static constexpr int VT = RING + kK5Stages * 3 * QT;   // v, K5K rows
  static constexpr int STG = VT + 2 * QT;   // 2 warpgroups x (hi, lo)
  static constexpr int KS = STG + 4 * PT;   // k, K5K rows of D + 8
  static constexpr int ROWF = KS + K5K * (D + 8) * 2;  // m', dl', route
  static constexpr int ROWP = ROWF + kK5Stages * 3 * K5Q * 4;  // q_pos
  static constexpr int KP = ROWP + kK5Stages * K5Q * 4;  // key positions
  static constexpr int TILE = KP + K5K * 4;  // each stage's tile index
  static constexpr int BAR = TILE + 16;  // full[stages], empty[stages], v
  static constexpr int BYTES = BAR + (2 * kK5Stages + 1) * 8;
};

// K5's dynamic shared memory: its layout and 1024 bytes to align the base.
template <int D>
constexpr size_t dkv_tma_smem_bytes() {
  return (size_t)K5Tiles<D>::BYTES + 1024;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive, and expect `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a barrier of `n` threads on hardware barrier `id` (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the generic proxy's shared-memory writes, seen by wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's accumulators
// across the asynchronous products (issue ... wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, layout type (1 = 128-byte, 2 = 64-byte, 3 = 32-byte
// swizzle).
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// K-major operand (rows x D, d contiguous) of a tile with R rows a column
// block, at the 16-wide step kc of d.
template <int D, int R>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kc) {
  using L = K5Tiles<D>;
  const int b = 32 * kc;
  return gdesc(tile + (b / L::SW) * (R * L::SW) + b % L::SW, 16, 8 * L::SW,
               L::MODE);
}

// MN-major B operand (query rows x D, d contiguous; K = query rows) of a
// query tile, at the 16-row step kq: d repeats every column block.
template <int D>
__device__ __forceinline__ uint64_t ndesc(uint32_t tile, int kq) {
  using L = K5Tiles<D>;
  return gdesc(tile + kq * 16 * L::SW, K5Q * L::SW, 8 * L::SW, L::MODE);
}

// MN-major A operand (keys x query rows, keys contiguous) of a staged
// [query row][64 keys] tile, at the 16-row step kq.
__device__ __forceinline__ uint64_t pdesc(uint32_t tile, int kq) {
  return gdesc(tile + kq * 16 * 128, 1024, 1024, 1);
}

// wgmma.mma_async m64nNk16, f32 += bf16 . bf16, both operands from shared
// memory; TA / TB = 1: that operand is MN-major. d holds the accumulator
// as mma.sync's C fragments, 8 columns after 8: d[4j + e] is row
// 16 (warp % 4) + g + 8 (e >> 1), column 8j + 2 t4 + (e & 1).
template <int N>
struct Wgmma;

// Eight accumulator operands of Wgmma<N>::run, d[i] .. d[i + 7].
#define RLO_WG_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// Wgmma<N>: REGS names its N / 2 accumulators in the PTX, A .. TB_ are
// the numbers of the operands after them (a, b, acc, TA, TB), and the
// rest are the accumulators' constraints.
#define RLO_WGMMA(N, REGS, A, B, ACC, TA_, TB_, ...)                    \
  template <>                                                           \
  struct Wgmma<N> {                                                     \
    template <int TA, int TB>                                           \
    __device__ __forceinline__ static void run(float (&d)[N / 2],       \
                                               uint64_t a, uint64_t b,  \
                                               int acc) {               \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ACC ", 0;\n"  \
                   "wgmma.mma_async.sync.aligned.m64n" #N               \
                   "k16.f32.bf16.bf16 {" REGS "}, %" #A ", %" #B        \
                   ", p, 1, 1, %" #TA_ ", %" #TB_ ";\n}\n"              \
                   : __VA_ARGS__                                        \
                   : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));       \
    }                                                                   \
  };

RLO_WGMMA(16,
          "%0, %1, %2, %3, %4, %5, %6, %7",
          8, 9, 10, 11, 12,
          RLO_WG_D8(0))
RLO_WGMMA(32,
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15",
          16, 17, 18, 19, 20,
          RLO_WG_D8(0), RLO_WG_D8(8))
RLO_WGMMA(64,
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31",
          32, 33, 34, 35, 36,
          RLO_WG_D8(0), RLO_WG_D8(8), RLO_WG_D8(16), RLO_WG_D8(24))
RLO_WGMMA(128,
          "%0, %1, %2, %3, %4, %5, %6, %7, "
          "%8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, "
          "%24, %25, %26, %27, %28, %29, %30, %31, "
          "%32, %33, %34, %35, %36, %37, %38, %39, "
          "%40, %41, %42, %43, %44, %45, %46, %47, "
          "%48, %49, %50, %51, %52, %53, %54, %55, "
          "%56, %57, %58, %59, %60, %61, %62, %63",
          64, 65, 66, 67, 68,
          RLO_WG_D8(0), RLO_WG_D8(8), RLO_WG_D8(16), RLO_WG_D8(24),
          RLO_WG_D8(32), RLO_WG_D8(40), RLO_WG_D8(48), RLO_WG_D8(56))

#undef RLO_WGMMA
#undef RLO_WG_D8

// Byte offset of (row, byte column) in a swizzled tile of K5Tiles<D> with
// R rows a column block.
template <int D, int R>
__device__ __forceinline__ uint32_t sw_off(int row, int col_bytes) {
  constexpr int SW = K5Tiles<D>::SW;
  const uint32_t o = (col_bytes / SW) * (R * SW) + row * SW + col_bytes % SW;
  return o ^ (((o >> 7) & (SW / 16 - 1)) << 4);
}

// load_q_frags over a swizzled query tile: the mma A fragments of rows
// r0.. (16) for every 16-wide step of d.
template <int D>
__device__ __forceinline__ void load_q_frags_sw(uint32_t (&qf)[D / 16][4],
                                                const unsigned char* tile,
                                                int r0, int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm_x4(qf[kc], reinterpret_cast<const bf16*>(
                        tile + sw_off<D, K5Q>(r0 + (lane & 15),
                                              32 * kc + 16 * (lane >> 4))));
}

// x (mma C fragments: query rows 16w + g (+8), keys 8j + 2 t4 (+1)) split
// into bf16 hi and lo [query row][64 keys] tiles of 128-byte rows, their
// 16-byte chunks swizzled by the row as wgmma's 128-byte pattern reads
// them (row & 7 == g).
__device__ __forceinline__ void stage_split(unsigned char* hi,
                                            const float (&x)[8][4], int w,
                                            int g, int t4) {
  unsigned char* lo = hi + K5Q * 64 * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int o = (16 * w + g + 8 * hf) * 128 + ((j ^ g) << 4) + 4 * t4;
      uint32_t h, l;
      split_bf16(x[j][2 * hf], x[j][2 * hf + 1], h, l);
      *reinterpret_cast<uint32_t*>(hi + o) = h;
      *reinterpret_cast<uint32_t*>(lo + o) = l;
    }
}

// K5's prepass: do' split into bf16 hi + lo (split_bf16's rule; n4 groups
// of 4 values), and the largest position of every K5Q-row query tile
// (warp i of the grid takes tile i), the live-tile walk's input.
__global__ void __launch_bounds__(256)
flash_bwd_dkv_prep_kernel(const float* __restrict__ do2,
                          const int* __restrict__ qpos, bf16* __restrict__ hi,
                          bf16* __restrict__ lo, int* __restrict__ tmax,
                          size_t n4, int Lq) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    const float4 x = reinterpret_cast<const float4*>(do2)[i];
    uint32_t h0, l0, h1, l1;
    split_bf16(x.x, x.y, h0, l0);
    split_bf16(x.z, x.w, h1, l1);
    reinterpret_cast<uint2*>(hi)[i] = make_uint2(h0, h1);
    reinterpret_cast<uint2*>(lo)[i] = make_uint2(l0, l1);
  }
  const size_t t = i >> 5;
  const int lane = threadIdx.x & 31;
  if (t < (size_t)(Lq + K5Q - 1) / K5Q) {  // one warp a tile
    int m = INT_MIN;
    for (int r = (int)t * K5Q + lane; r < Lq && r < ((int)t + 1) * K5Q;
         r += 32)
      m = max(m, qpos[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) tmax[t] = m;
  }
}

template <int D>
__global__ void __launch_bounds__(kK5Threads, 1)
flash_bwd_dkv_mma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap thi,
                         const __grid_constant__ CUtensorMap tlo,
                         const __grid_constant__ CUtensorMap tv,
                         const bf16* __restrict__ k,
                         const float* __restrict__ m2,
                         const float* __restrict__ dl2,
                         const float* __restrict__ route,
                         const int* __restrict__ qpos,
                         const int* __restrict__ tmax,
                         const int* __restrict__ kpos, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Lq, int Lk,
                         int causal, float scale) {
  using L = K5Tiles<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  float* rowf = reinterpret_cast<float*>(base + L::ROWF);
  int* rowp = reinterpret_cast<int*>(base + L::ROWP);
  int* tile_s = reinterpret_cast<int*>(base + L::TILE);
  const uint32_t ring = smem_addr(base + L::RING);
  const uint32_t full = smem_addr(base + L::BAR);
  const uint32_t empty = full + 8 * kK5Stages, vbar = empty + 8 * kK5Stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the head fastest: every head's smallest key positions (the longest
  // walks) first
  const int h = blockIdx.x % H, k0 = (blockIdx.x / H) * K5K;
  const size_t hq = (size_t)h * Lq, hk = (size_t)h * Lk;

  if (tid == 0) {
    for (int s = 0; s < kK5Stages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, 2);  // one thread a consumer warpgroup
    }
    mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {  // the producer warpgroup: one warp works, three leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 0) return;
    int kmin = INT_MAX;  // the block's smallest key position
    for (int i = lane; i < K5K; i += 32)
      if (k0 + i < Lk) kmin = min(kmin, kpos[k0 + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      kmin = min(kmin, __shfl_xor_sync(kFull, kmin, off));
    if (lane == 0) {
      mbar_arrive_tx(vbar, K5K * 2 * D);
      for (int c = 0; c < L::CB; ++c)
        tma_load_3d(smem_addr(base + L::VT) + c * K5K * L::SW, &tv, vbar,
                    c * L::BOX, k0, h);
    }
    int s = 0, ph = 0;
    // tile t (or, t < 0, the end) into stage s once the consumers free it
    auto issue = [&](int t) {
      mbar_wait(empty + 8 * s, ph ^ 1);
      const int q0 = t * K5Q;
      if (t >= 0)
        for (int i = lane; i < K5Q; i += 32) {
          const int r = q0 + i;
          const bool ok = r < Lq;
          const size_t o = hq + (ok ? r : 0);
          rowf[(s * 3 + 0) * K5Q + i] = ok ? m2[o] : 0.f;
          rowf[(s * 3 + 1) * K5Q + i] = ok ? dl2[o] : 0.f;
          rowf[(s * 3 + 2) * K5Q + i] = ok ? route[o] : 0.f;
          rowp[s * K5Q + i] = ok ? qpos[r] : 0;
        }
      if (lane == 0) {
        tile_s[s] = t;
        if (t >= 0) {
          mbar_arrive_tx(full + 8 * s, 3 * L::QT);
          const uint32_t dst = ring + s * 3 * L::QT;
          for (int c = 0; c < L::CB; ++c) {
            const uint32_t o = c * K5Q * L::SW;
            tma_load_3d(dst + o, &tq, full + 8 * s, c * L::BOX, q0, h);
            tma_load_3d(dst + L::QT + o, &thi, full + 8 * s, c * L::BOX, q0,
                        h);
            tma_load_3d(dst + 2 * L::QT + o, &tlo, full + 8 * s, c * L::BOX,
                        q0, h);
          }
        } else {
          mbar_arrive(full + 8 * s);
        }
      } else {
        mbar_arrive(full + 8 * s);
      }
      if (++s == kK5Stages) {
        s = 0;
        ph ^= 1;
      }
    };
    const int ntiles = (Lq + K5Q - 1) / K5Q;
    for (int b = 0; b < ntiles; b += 32) {
      const int t = b + lane;
      unsigned live =
          __ballot_sync(kFull, t < ntiles && (!causal || tmax[t] >= kmin));
      while (live) {
        issue(b + __ffs(live) - 1);
        live &= live - 1;
      }
    }
    issue(-1);
    return;
  }

  // the consumer warpgroups: keys k0 + 64 wg.., warp w query rows 16 w..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = (warp >> 2) - 1, w = warp & 3, ctid = tid & 127;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + 64 * wg;
  bf16* ks = reinterpret_cast<bf16*>(base + L::KS) + 64 * wg * (D + 8);
  int* kp = reinterpret_cast<int*>(base + L::KP) + 64 * wg;
  for (int i = ctid; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = kw0 + r < Lk;
    cp_async16(ks + r * (D + 8) + c, k + (hk + (ok ? kw0 + r : 0)) * D + c,
               ok);
  }
  cp_async_commit();
  if (ctid < 64) kp[ctid] = kw0 + ctid < Lk ? kpos[kw0 + ctid] : INT_MAX;
  cp_async_wait<0>();
  bar_sync(2 + wg, 128);
  const uint32_t vt = smem_addr(base + L::VT) + 64 * wg * L::SW;
  unsigned char* stg = base + L::STG + 2 * wg * L::PT;  // hi, then lo
  const uint32_t sa = smem_addr(stg);

  float acck[D / 2], accv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acck[i] = accv[i] = 0.f;
  mbar_wait(vbar, 0);

  for (int s = 0, ph = 0, prev = -1;;) {
    mbar_wait(full + 8 * s, ph);
    const int t = tile_s[s];
    if (t < 0) break;
    const unsigned char* qt = base + L::RING + s * 3 * L::QT;
    const uint32_t qa = ring + s * 3 * L::QT, ha = qa + L::QT,
                   la = qa + 2 * L::QT;
    float sc[8][4], dp[8][4];
    {
      uint32_t qf[D / 16][4];
      load_q_frags_sw<D>(qf, qt, 16 * w, lane);
      mma_scores<D, 8>(qf, ks, lane, sc);
    }
    // dP = do'_lo . v^T + do'_hi . v^T
    float(&dpv)[32] = *reinterpret_cast<float(*)[32]>(&dp[0][0]);
#pragma unroll
    for (int i = 0; i < 32; ++i) dpv[i] = 0.f;
    fence_regs(dpv);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      Wgmma<64>::run<0, 0>(dpv, kdesc<D, K5Q>(la, kc), kdesc<D, K5K>(vt, kc),
                           1);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      Wgmma<64>::run<0, 0>(dpv, kdesc<D, K5Q>(ha, kc), kdesc<D, K5K>(vt, kc),
                           1);
    wg_commit();
    wg_wait0();  // dP, and the last tile's dv products: its stage is free
    fence_regs(dpv);
    RowVals rv;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * w + g + 8 * hf;
      rv.ok[hf] = t * K5Q + r < Lq;
      rv.qp[hf] = rowp[s * K5Q + r];
      rv.m2[hf] = rowf[(s * 3 + 0) * K5Q + r];
      rv.dl[hf] = rowf[(s * 3 + 1) * K5Q + r];
      rv.rt[hf] = rowf[(s * 3 + 2) * K5Q + r];
    }
    if (prev >= 0 && ctid == 0) mbar_arrive(empty + 8 * prev);
    ds_frags<8, true>(sc, dp, dp, rv, kp, Lk - kw0, causal, scale, t4);
    // dk += ds~_hi^T . q + ds~_lo^T . q
    stage_split(stg, sc, w, g, t4);
    fence_async_smem();
    bar_sync(2 + wg, 128);
    fence_regs(acck);
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < K5Q / 16; ++kq) {
      Wgmma<D>::template run<1, 1>(acck, pdesc(sa, kq), ndesc<D>(qa, kq), 1);
      Wgmma<D>::template run<1, 1>(acck, pdesc(sa + L::PT, kq),
                                   ndesc<D>(qa, kq), 1);
    }
    wg_commit();
    wg_wait0();  // the staged tiles are free for p
    fence_regs(acck);
    // dv += p_hi^T . do'_hi + p_hi^T . do'_lo + p_lo^T . do'_hi, left in
    // flight under the next tile's scores
    stage_split(stg, dp, w, g, t4);
    fence_async_smem();
    bar_sync(2 + wg, 128);
    fence_regs(accv);
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < K5Q / 16; ++kq) {
      Wgmma<D>::template run<1, 1>(accv, pdesc(sa, kq), ndesc<D>(ha, kq), 1);
      Wgmma<D>::template run<1, 1>(accv, pdesc(sa, kq), ndesc<D>(la, kq), 1);
      Wgmma<D>::template run<1, 1>(accv, pdesc(sa + L::PT, kq),
                                   ndesc<D>(ha, kq), 1);
    }
    wg_commit();
    prev = s;
    if (++s == kK5Stages) {
      s = 0;
      ph ^= 1;
    }
  }
  wg_wait0();
  fence_regs(acck);
  fence_regs(accv);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kr = kw0 + 16 * w + g + 8 * hf;
    if (kr >= Lk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t o = (hk + kr) * D + j * 8 + t4 * 2;
      *reinterpret_cast<float2*>(dk + o) = make_float2(
          acck[4 * j + 2 * hf] * scale, acck[4 * j + 2 * hf + 1] * scale);
      *reinterpret_cast<float2*>(dv + o) =
          make_float2(accv[4 * j + 2 * hf], accv[4 * j + 2 * hf + 1]);
    }
  }
}

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (the library links no driver library).
using TensorMapEncode = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

TensorMapEncode tensor_map_encode() {
  static const TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncode>(p)
               : nullptr;
  }();
  return fn;
}

// A (heads, rows, D) bf16 tensor as TMA boxes of box_rows rows x SW bytes,
// swizzled as K5's descriptors read them; rows past `rows` read as zeros.
// Returns 0, or 1000 + the driver's error.
template <int D>
int bf16_tile_map(CUtensorMap* map, const void* base, int rows, int heads,
                  int box_rows) {
  using L = K5Tiles<D>;
  const TensorMapEncode enc = tensor_map_encode();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// K5's prepass for H heads of Lq rows: do' (H, Lq, D) f32 into hi and lo
// (H, Lq, D) bf16, and the ceil(Lq / K5Q) tile maxima of q_pos.
int launch_dkv_prep(const float* do2, const int* qp, bf16* hi, bf16* lo,
                    int* tmax, int H, int Lq, int D, cudaStream_t stream) {
  const size_t n4 = (size_t)H * Lq * D / 4;
  const size_t nt = (size_t)((Lq + K5Q - 1) / K5Q) * 32;
  const size_t n = n4 > nt ? n4 : nt;
  flash_bwd_dkv_prep_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      do2, qp, hi, lo, tmax, n4, Lq);
  return (int)cudaGetLastError();
}

// The three backward launches for one (dtype, head_dim). `which` is 3 (K3),
// 4 (K4) or 5 (K5); unused pointers may be null. bf16 K5 takes do' as the
// prepass made it (dhi, dlo) and the tile maxima of q_pos (tmax), not
// do2. As K2's, a call with more than kMaxGridYZ heads runs one launch a
// chunk of heads, every per-head operand (q, k, v, m2, dl2, do2, dhi, dlo,
// route and the outputs) offset to the chunk's first head.
template <typename T, int D>
int launch_bwd(int which, const void* q, const void* k, const void* v,
               const float* m2, const float* dl2, const float* do2,
               const float* route, const int* qp, const int* kp,
               const void* dhi, const void* dlo, const int* tmax, float* out0,
               float* out1, int H, int Lq, int Lk, int causal, float scale,
               cudaStream_t stream) {
  if (which < 3 || which > 5) return -1;
  if (which == 5 && Lk <= 0) return 0;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  int e;
  for (int h0 = 0; h0 < H; h0 += kMaxGridYZ) {
    const int hn = H - h0 < kMaxGridYZ ? H - h0 : kMaxGridYZ;
    const dim3 qgrid((Lq + BQ - 1) / BQ, hn), kgrid((Lk + BK - 1) / BK, hn);
    const size_t oq = (size_t)h0 * Lq, ok = (size_t)h0 * Lk;
    const T* cq = tq + oq * D;
    const T* ck = tk + ok * D;
    const T* cv = tv ? tv + ok * D : tv;
    const float* cm2 = m2 + oq;
    const float* cdl2 = dl2 ? dl2 + oq : dl2;
    const float* cdo2 = do2 ? do2 + oq * D : do2;
    const float* croute = route ? route + oq : route;
    if (which == 3) {
      if constexpr (kTensor<T>) {
        constexpr size_t smem = rowstats_mma_smem_bytes<D>();
        if ((e = set_smem(flash_rowstats_mma_kernel<D>, smem))) return e;
        flash_rowstats_mma_kernel<D>
            <<<dim3((Lq + K3Q - 1) / K3Q, hn), kK3Threads, smem, stream>>>(
                cq, ck, cm2, qp, kp, out0 + oq, Lq, Lk, causal, scale);
      } else {
        constexpr size_t smem = bwd_smem_bytes<D>(2, 0);
        if ((e = set_smem(flash_rowstats_f32_kernel<D>, smem))) return e;
        flash_rowstats_f32_kernel<D><<<qgrid, kThreads, smem, stream>>>(
            cq, ck, cm2, qp, kp, out0 + oq, Lq, Lk, causal, scale);
      }
    } else if (which == 4) {
      if constexpr (kTensor<T>) {
        constexpr size_t smem = dq_mma_smem_bytes<D>();
        if ((e = set_smem(flash_bwd_dq_mma_kernel<D>, smem))) return e;
        flash_bwd_dq_mma_kernel<D><<<qgrid, kMmaThreads, smem, stream>>>(
            cq, ck, cv, cm2, cdl2, cdo2, croute, qp, kp, out0 + oq * D, Lq,
            Lk, causal, scale);
      } else {
        constexpr size_t smem = bwd_smem_bytes<D>(4, 1);
        if ((e = set_smem(flash_bwd_dq_f32_kernel<D>, smem))) return e;
        flash_bwd_dq_f32_kernel<D><<<qgrid, kThreads, smem, stream>>>(
            cq, ck, cv, cm2, cdl2, cdo2, croute, qp, kp, out0 + oq * D, Lq,
            Lk, causal, scale);
      }
    } else {
      if constexpr (kTensor<T>) {
        CUtensorMap mq, mhi, mlo, mv;
        if ((e = bf16_tile_map<D>(&mq, cq, Lq, hn, K5Q)) ||
            (e = bf16_tile_map<D>(&mhi, static_cast<const T*>(dhi) + oq * D,
                                  Lq, hn, K5Q)) ||
            (e = bf16_tile_map<D>(&mlo, static_cast<const T*>(dlo) + oq * D,
                                  Lq, hn, K5Q)) ||
            (e = bf16_tile_map<D>(&mv, cv, Lk, hn, K5K)))
          return e;
        constexpr size_t smem = dkv_tma_smem_bytes<D>();
        if ((e = set_smem(flash_bwd_dkv_mma_kernel<D>, smem))) return e;
        flash_bwd_dkv_mma_kernel<D>
            <<<hn * ((Lk + K5K - 1) / K5K), kK5Threads, smem, stream>>>(
                mq, mhi, mlo, mv, ck, cm2, cdl2, croute, qp, tmax, kp,
                out0 + ok * D, out1 + ok * D, hn, Lq, Lk, causal, scale);
      } else {
        constexpr size_t smem = bwd_smem_bytes<D>(4, 2);
        if ((e = set_smem(flash_bwd_dkv_f32_kernel<D>, smem))) return e;
        flash_bwd_dkv_f32_kernel<D><<<kgrid, kThreads, smem, stream>>>(
            cq, ck, cv, cm2, cdl2, cdo2, croute, qp, kp, out0 + ok * D,
            out1 + ok * D, Lq, Lk, causal, scale);
      }
    }
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
}

template <typename T>
int dispatch_bwd(int which, int D, const void* q, const void* k,
                 const void* v, const float* m2, const float* dl2,
                 const float* do2, const float* route, const int* qp,
                 const int* kp, const void* dhi, const void* dlo,
                 const int* tmax, float* o0, float* o1, int H, int Lq, int Lk,
                 int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(which, q, k, v, m2, dl2, do2, route, qp, kp, dhi, dlo, tmax, o0, o1, H, Lq, Lk, causal, scale, s);
    case 32: return launch_bwd<T, 32>(which, q, k, v, m2, dl2, do2, route, qp, kp, dhi, dlo, tmax, o0, o1, H, Lq, Lk, causal, scale, s);
    case 64: return launch_bwd<T, 64>(which, q, k, v, m2, dl2, do2, route, qp, kp, dhi, dlo, tmax, o0, o1, H, Lq, Lk, causal, scale, s);
    case 128: return launch_bwd<T, 128>(which, q, k, v, m2, dl2, do2, route, qp, kp, dhi, dlo, tmax, o0, o1, H, Lq, Lk, causal, scale, s);
  }
  return -1;
}

int bwd_entry(int which, int dtype, const void* q, const void* k,
              const void* v, const void* m2, const void* dl2, const void* do2,
              const void* route, const void* q_pos, const void* k_pos,
              const void* dhi, const void* dlo, const void* tmax, void* out0,
              void* out1, int H, int Lq, int Lk, int D, int causal,
              float scale, void* stream) {
  if (H <= 0 || Lq <= 0) return 0;
  auto args = [&](auto tag) {
    using T = decltype(tag);
    return dispatch_bwd<T>(
        which, D, q, k, v, static_cast<const float*>(m2),
        static_cast<const float*>(dl2), static_cast<const float*>(do2),
        static_cast<const float*>(route), static_cast<const int*>(q_pos),
        static_cast<const int*>(k_pos), dhi, dlo,
        static_cast<const int*>(tmax), static_cast<float*>(out0),
        static_cast<float*>(out1), H, Lq, Lk, causal, scale,
        static_cast<cudaStream_t>(stream));
  };
  if (dtype == 1) return args(float{});
  if (dtype == 2) return args(bf16{});
  return -1;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype 1 = f32, 2 = bf16 (q, k, v;
// bf16 pointers 16-byte aligned). Layouts: q (H, Lq, D); k, v (H, Lk, D);
// m, l (H, Lq); o (H, Lq, D); q_pos (Lq), k_pos (Lk) int32; outputs m2, l2,
// o2 like m, l, o (o2 8-byte aligned). Returns the cudaGetLastError() code
// after the launch (0 = success) or -1 for a dtype or head_dim the kernel
// does not take. Launches on `stream`, does not synchronise, allocates
// nothing.
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
    return dispatch_d<bf16>(D, q, k, v, fm, fl, fo, qp, kp, m2f, l2f, o2f, H,
                            Lq, Lk, causal, scale, s);
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
                   q_pos, k_pos, nullptr, nullptr, nullptr, cnt, nullptr, H,
                   Lq, Lk, D, causal, scale, stream);
}

extern "C" int rlo_flash_bwd_dq(int dtype, const void* q, const void* k,
                                const void* v, const void* m2,
                                const void* dl2, const void* do2,
                                const void* route, const void* q_pos,
                                const void* k_pos, void* dq, int H, int Lq,
                                int Lk, int D, int causal, float scale,
                                void* stream) {
  return bwd_entry(4, dtype, q, k, v, m2, dl2, do2, route, q_pos, k_pos,
                   nullptr, nullptr, nullptr, dq, nullptr, H, Lq, Lk, D,
                   causal, scale, stream);
}

// K5. f32 operands read do2; bf16 operands read do' as K5's prepass
// (rlo_flash_dkv_prep) made it instead, do_hi and do_lo (H, Lq, D) bf16,
// 16-byte aligned, and its tile maxima of q_pos (tile_max), and ignore
// do2. Unused pointers may be null.
extern "C" int rlo_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                 const void* v, const void* m2,
                                 const void* dl2, const void* do2,
                                 const void* route, const void* q_pos,
                                 const void* k_pos, const void* do_hi,
                                 const void* do_lo, const void* tile_max,
                                 void* dk, void* dv, int H, int Lq, int Lk,
                                 int D, int causal, float scale,
                                 void* stream) {
  return bwd_entry(5, dtype, q, k, v, m2, dl2, do2, route, q_pos, k_pos,
                   do_hi, do_lo, tile_max, dk, dv, H, Lq, Lk, D, causal,
                   scale, stream);
}

// K5's prepass (bf16 route): do2 (H, Lq, D) f32, 16-byte aligned, split
// into do_hi = bf16(do2) and do_lo = bf16(do2 - do_hi), (H, Lq, D) bf16;
// tile_max (ceil(Lq / 64)) int32 the largest q_pos of each 64-row tile.
extern "C" int rlo_flash_dkv_prep(const void* do2, const void* q_pos,
                                  void* do_hi, void* do_lo, void* tile_max,
                                  int H, int Lq, int D, void* stream) {
  if (H <= 0 || Lq <= 0) return 0;
  return launch_dkv_prep(static_cast<const float*>(do2),
                         static_cast<const int*>(q_pos),
                         static_cast<bf16*>(do_hi), static_cast<bf16*>(do_lo),
                         static_cast<int*>(tile_max), H, Lq, D,
                         static_cast<cudaStream_t>(stream));
}
