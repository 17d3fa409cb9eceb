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
// owns (head, 64 key rows) and loops over the Q tiles, each carrying its
// sums in registers, so no two blocks write one output and no atomics are
// needed: gradients are the same bits from run to run. A causal tile that
// no row of the block can see is skipped: its ds~ and p are 0. K3 counts
// such a tile in closed form instead: every position there is masked, so
// s~ = -1e30 and it ties exactly the rows whose m' is -1e30.
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
// - bf16 K4 and K5 run every product on the tensor cores (mma.sync
//   m16n8k16, f32 accumulation). The f32 operands do', ds~ and p are split
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
//   K5 (flash_bwd_dkv_mma_kernel): 8 warps own 64 keys (K and V tiles
//   loaded once) and loop over Q tiles, whose Q, f32 do' and row values
//   the next tile's cp.async copies while this one computes. Per tile,
//   warp w first forms the scores, dP, p and ds~ of query rows 16 (w % 4)
//   against keys 32 (w / 4) and stages p and ds~ as bf16 hi/lo tiles in
//   shared memory; then it accumulates dk and dv for keys 16 (w % 4) and
//   head-dim columns (w / 4) D/2 on, reading p^T and ds~^T back by
//   ldmatrix.trans as A fragments (the contraction is over query rows).
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

constexpr int kDkvThreads = 256;  // K5: 8 warps
constexpr int PS = BK + 8;        // bf16 row stride of K5's p and ds~ tiles

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

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, 2 Q, do'_hi, do'_lo (bf16, 64 x (D + 8) each); p_hi, p_lo,
  // ds~_hi, ds~_lo (bf16, BQ x PS each); the f32 do' tile (BQ x D)
  return sizeof(bf16) * ((size_t)6 * 64 * (D + 8) + (size_t)4 * BQ * PS) +
         sizeof(float) * (size_t)BQ * D;
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, D <= 64 ? 2 : 1)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ m2,
                         const float* __restrict__ dl2,
                         const float* __restrict__ do2,
                         const float* __restrict__ route,
                         const int* __restrict__ qpos,
                         const int* __restrict__ kpos, float* __restrict__ dk,
                         float* __restrict__ dv, int Lq, int Lk, int causal,
                         float scale) {
  constexpr int DS = D + 8;   // bf16 row stride of the D-wide tiles
  constexpr int CH = D / 8;   // 16-byte bf16 chunks per row
  constexpr int C4 = D / 4;   // 16-byte f32 chunks per row
  constexpr int NA = D / 16;  // accumulator fragments: D/2 columns a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // BK x DS
  bf16* vs = ks + BK * DS;                        // BK x DS
  bf16* qs = vs + BK * DS;                        // 2 x BQ x DS
  bf16* dhi = qs + 2 * BQ * DS;                   // BQ x DS
  bf16* dlo = dhi + BQ * DS;                      // BQ x DS
  bf16* phi = dlo + BQ * DS;                      // BQ x PS
  bf16* plo = phi + BQ * PS;                      // BQ x PS
  bf16* shi = plo + BQ * PS;                      // BQ x PS
  bf16* slo = shi + BQ * PS;                      // BQ x PS
  float* dof = reinterpret_cast<float*>(slo + BQ * PS);  // BQ x D
  __shared__ float rows_f[2][3][BQ];  // m', dl', route of a Q tile's rows
  __shared__ int rows_p[2][BQ];       // their positions
  __shared__ int kp_s[BK];
  __shared__ int span_s[3];  // min key position; first, last live Q tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t hq = (size_t)h * Lq, hk = (size_t)h * Lk;

  for (int i = tid; i < BK * CH; i += kDkvThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = k0 + r < Lk;
    const size_t src = (hk + (ok ? k0 + r : 0)) * D + c;
    cp_async16(ks + r * DS + c, k + src, ok);
    cp_async16(vs + r * DS + c, v + src, ok);
  }
  cp_async_commit();
  if (tid < BK) kp_s[tid] = k0 + tid < Lk ? kpos[k0 + tid] : INT_MAX;
  if (tid == 0) {
    span_s[0] = INT_MAX;
    span_s[1] = INT_MAX;
    span_s[2] = -1;
  }
  __syncthreads();
  if (tid < BK && k0 + tid < Lk) atomicMin(&span_s[0], kp_s[tid]);
  __syncthreads();
  const int kmin = span_s[0];
  // the Q tiles whose rows may see a key of this block: all of them, or
  // (causal) the span from the first to the last tile holding a position
  // >= the block's smallest key position (a dead tile inside is skipped)
  const int ntiles = (Lq + BQ - 1) / BQ;
  int first = 0, last = ntiles - 1;
  if (causal) {
    int f = INT_MAX, l = -1;
    for (int i = tid; i < Lq; i += kDkvThreads)
      if (qpos[i] >= kmin) {
        f = min(f, i / BQ);
        l = i / BQ;
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

  // Q tile t's bf16 rows, f32 do' rows and row values into buffer buf
  auto load_q = [&](int t, int buf) {
    const int q0 = t * BQ;
    bf16* qd = qs + buf * BQ * DS;
    for (int i = tid; i < BQ * CH; i += kDkvThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = q0 + r < Lq;
      cp_async16(qd + r * DS + c, q + (hq + (ok ? q0 + r : 0)) * D + c, ok);
    }
    for (int i = tid; i < BQ * C4; i += kDkvThreads) {
      const int r = i / C4, c = (i % C4) * 4;
      const bool ok = q0 + r < Lq;
      cp_async16(dof + r * D + c, do2 + (hq + (ok ? q0 + r : 0)) * D + c, ok);
    }
    {  // 256 threads: one value each of the 4 x 64. Thread r < BQ copies
      // row r's position: it reads it before the tile's first barrier,
      // which only its own cp_async_wait makes safe
      const int a = tid / BQ, r = tid % BQ;
      const bool ok = q0 + r < Lq;
      const size_t src = ok ? q0 + r : 0;
      if (a == 0)
        cp_async4(&rows_p[buf][r], qpos + src, ok);
      else
        cp_async4(&rows_f[buf][a - 1][r],
                  (a == 1 ? m2 : a == 2 ? dl2 : route) + hq + src, ok);
    }
    cp_async_commit();
  };

  if (first <= last)
    load_q(first, 0);
  else
    cp_async_commit();

  // score phase: query rows sr.. (16), keys sc.. (32); accumulate phase:
  // keys ar.. (16), head-dim columns ac.. (D/2)
  const int sr = (warp & 3) * 16, sc = (warp >> 2) * 32;
  const int ar = (warp & 3) * 16, ac = (warp >> 2) * (D / 2);
  float acck[NA][4], accv[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[j][e] = accv[j][e] = 0.f;

  for (int t = first, buf = 0; t <= last; ++t, buf ^= 1) {
    cp_async_wait<0>();  // tile t (and, the first time, K and V)
    const int q0 = t * BQ;
    const int live = __syncthreads_or(
        !causal || (tid < BQ && q0 + tid < Lq && rows_p[buf][tid] >= kmin));
    if (live)  // do' split once per tile (rows past Lq are zero-filled)
      split_rows<D, BQ, kDkvThreads>(dhi, dlo, dof, BQ, tid);
    __syncthreads();  // dof is free, do'_hi/lo are ready
    if (t < last)
      load_q(t + 1, buf ^ 1);  // buf ^ 1 freed by the last iteration
    else
      cp_async_commit();
    if (live) {
      const bf16* qt = qs + buf * BQ * DS;
      RowVals rv;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = sr + g + 8 * hf;
        rv.ok[hf] = q0 + r < Lq;
        rv.qp[hf] = rows_p[buf][r];
        rv.m2[hf] = rows_f[buf][0][r];
        rv.dl[hf] = rows_f[buf][1][r];
        rv.rt[hf] = rows_f[buf][2][r];
      }
      {
        uint32_t qf[D / 16][4];
        load_q_frags<D>(qf, qt + sr * DS, lane);
        float s[4][4], dp[4][4], p[4][4];
        mma_scores<D, 4>(qf, ks + sc * DS, lane, s);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
        mma_rows_split<D, 4>(dhi + sr * DS, dlo + sr * DS, vs + sc * DS, lane,
                             dp);
        ds_frags<4, true>(s, dp, p, rv, kp_s + sc, Lk - k0 - sc, causal,
                          scale, t4);
        // stage p and ds~ as bf16 hi/lo [query row][key] tiles
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int o = (sr + g + 8 * hf) * PS + sc + j * 8 + t4 * 2;
            uint32_t hi, lo;
            split_bf16(p[j][2 * hf], p[j][2 * hf + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(phi + o) = hi;
            *reinterpret_cast<uint32_t*>(plo + o) = lo;
            split_bf16(s[j][2 * hf], s[j][2 * hf + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(shi + o) = hi;
            *reinterpret_cast<uint32_t*>(slo + o) = lo;
          }
      }
      __syncthreads();
      // dv += p^T . do' and dk += ds~^T . q over the tile's 64 query rows:
      // p^T and ds~^T (keys x query rows) by ldmatrix.trans of the staged
      // tiles, do' and q (query rows x d) by ldmatrix.trans as B
      const int ao = ((lane & 7) + ((lane >> 4) << 3)) * PS + ar + (lane & 8);
      const int bo = (lane & 15) * DS + (D == 16 ? 0 : ac) + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t aph[4], apl[4], ash[4], asl[4];
        ldsm_x4_t(aph, phi + ao + kc * 16 * PS);
        ldsm_x4_t(apl, plo + ao + kc * 16 * PS);
        ldsm_x4_t(ash, shi + ao + kc * 16 * PS);
        ldsm_x4_t(asl, slo + ao + kc * 16 * PS);
        // 16 head-dim columns a step (D = 16: the warp's 8 of them)
#pragma unroll
        for (int jp = 0; jp < (D == 16 ? 1 : NA / 2); ++jp) {
          uint32_t bh[4], bl[4], bq[4];
          const int off = bo + kc * 16 * DS + jp * 16;
          ldsm_x4_t(bh, dhi + off);
          ldsm_x4_t(bl, dlo + off);
          ldsm_x4_t(bq, qt + off);
          if constexpr (D == 16) {
            const bool up = warp >= 4;
            const uint32_t h0 = up ? bh[2] : bh[0], h1 = up ? bh[3] : bh[1];
            const uint32_t l0 = up ? bl[2] : bl[0], l1 = up ? bl[3] : bl[1];
            const uint32_t q0b = up ? bq[2] : bq[0], q1b = up ? bq[3] : bq[1];
            mma_bf16(accv[0], aph, h0, h1);
            mma_bf16(acck[0], ash, q0b, q1b);
            mma_bf16(accv[0], aph, l0, l1);
            mma_bf16(acck[0], asl, q0b, q1b);
            mma_bf16(accv[0], apl, h0, h1);
          } else {
            mma_bf16(accv[2 * jp], aph, bh[0], bh[1]);
            mma_bf16(accv[2 * jp + 1], aph, bh[2], bh[3]);
            mma_bf16(acck[2 * jp], ash, bq[0], bq[1]);
            mma_bf16(acck[2 * jp + 1], ash, bq[2], bq[3]);
            mma_bf16(accv[2 * jp], aph, bl[0], bl[1]);
            mma_bf16(accv[2 * jp + 1], aph, bl[2], bl[3]);
            mma_bf16(acck[2 * jp], asl, bq[0], bq[1]);
            mma_bf16(acck[2 * jp + 1], asl, bq[2], bq[3]);
            mma_bf16(accv[2 * jp], apl, bh[0], bh[1]);
            mma_bf16(accv[2 * jp + 1], apl, bh[2], bh[3]);
          }
        }
      }
    }
    __syncthreads();  // the staged tiles and buf are free for the next tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kr = k0 + ar + g + 8 * hf;
    if (kr >= Lk) continue;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const size_t o = (hk + kr) * D + ac + j * 8 + t4 * 2;
      *reinterpret_cast<float2*>(dk + o) =
          make_float2(acck[j][2 * hf] * scale, acck[j][2 * hf + 1] * scale);
      *reinterpret_cast<float2*>(dv + o) =
          make_float2(accv[j][2 * hf], accv[j][2 * hf + 1]);
    }
  }
}

// The three backward launches for one (dtype, head_dim). `which` is 3 (K3),
// 4 (K4) or 5 (K5); unused pointers may be null. As K2's, a call with more
// than kMaxGridYZ heads runs one launch a chunk of heads, every per-head
// operand (q, k, v, m2, dl2, do2, route and the outputs) offset to the
// chunk's first head.
template <typename T, int D>
int launch_bwd(int which, const void* q, const void* k, const void* v,
               const float* m2, const float* dl2, const float* do2,
               const float* route, const int* qp, const int* kp, float* out0,
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
        constexpr size_t smem = dkv_mma_smem_bytes<D>();
        if ((e = set_smem(flash_bwd_dkv_mma_kernel<D>, smem))) return e;
        flash_bwd_dkv_mma_kernel<D><<<kgrid, kDkvThreads, smem, stream>>>(
            cq, ck, cv, cm2, cdl2, cdo2, croute, qp, kp, out0 + ok * D,
            out1 + ok * D, Lq, Lk, causal, scale);
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
