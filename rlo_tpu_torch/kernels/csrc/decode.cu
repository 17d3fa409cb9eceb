// K6, K7 and K8: decode attention against the dense KV cache, and the two
// in-place cache writes. K9, K10 and K11: the same against a page pool.
//
// K6 replaces rlo_tpu/pallas/decode.py:_decode_kernel (behind
// flash_block_decode and flash_decode). Cache (b, kvh, hd, L) seq-minor in
// f32, bf16 or int8 (with f32 scales (b, kvh, L)); q (b, kvh, R, hd) with
// R = T * r rows t-major (row t*r + rr is token t, group member rr, at
// position pos_b + t), already rounded to the dot dtype by the wrapper; out
// (b, kvh, R, hd) f32. Per cache tile of BK = 128 positions, as the TPU
// kernel does per grid step:
//   s    = (q . k) * scale, f32 accumulation of exact bf16 (or f32) products
//   s   *= k_scale                                            (int8 only)
//   s    = where(j <= pos + t && j < L, s, -1e30); v = 0 where j > pos + T - 1
//   m'   = max(m, rowmax s);  p = where(mask, exp(s - m'), 0)
//   l'   = l * exp(m - m') + rowsum p
//   pv   = where(mask, p * v_scale, 0) (int8) else p, rounded to the dot dtype
//   o'   = o * exp(m - m') + pv . v;      out = o / l
// The tile partition is the same for every T (BK is fixed), so T = 1 and
// T > 1 share one accumulation order; tiles wholly beyond pos + T - 1 are
// skipped (they change neither m, l nor o). One block owns one (batch row,
// kv head) and RT query rows and walks the live tiles: threads run along the
// cache axis (coalesced reads of the seq-minor k rows), the V tile is staged
// in shared memory for P.V. The TPU kernel's grid-per-tile and VMEM sizing
// (_pick_bk, _block_fits_vmem) are not carried over.
// Bound: bytes. Decode reads the live cache (k, v and the scales up to
// pos + T) once and does ~4 flops per byte of bf16 cache, far below the
// card's 295 flops/byte ridge: the least time is those bytes over 3.35 TB/s
// (H100 SXM). The design reads each live byte once per RT-row tile; with
// b * kvh blocks and no split of the cache axis across blocks, a small batch
// leaves SMs idle (a split-K pass is later work).
//
// K9 replaces rlo_tpu/pallas/decode.py:_paged_decode_kernel (behind
// paged_flash_decode): K6 through a page table. Pools (P, kvh, hd, ps), scale
// pools (P, kvh, ps), table (b, mp) int32; logical position j of row b lives
// at lane j % ps of physical page table[b, j / ps] (clamped into [0, P-1]),
// over a logical length L = mp * ps. It is the same kernel body as K6 with
// the column address swapped (the PAGED template flag): the tiles stay BK =
// 128 LOGICAL positions whatever ps is, so pages that hold a dense cache's
// columns give K6's result bit for bit, and ps = 128 is the TPU kernel's
// partition (one grid step per page). Unmapped entries point at the null
// page, whose positions the masks hide. Bound: the live bytes read (k, v and
// the scales up to pos + T, plus the table) over 3.35 TB/s; the page
// indirection costs one table read per tile column and breaks coalescing
// only at page edges (ps >= 32 keeps each warp's reads within one page).
//
// K7 replaces rlo_tpu/pallas/decode.py:_write_row_kernel (write_kv_row):
// cache[b, :, :, pos_b] = row[b]; a position outside [0, L) matches no
// column and its write is dropped, as on the TPU. pos is read on the device:
// stride 0 (one shared position) or 1 (one per row). Bound: the bytes
// written (plus the rows read); one thread per element, element size 1, 2
// or 4 bytes.
//
// K10 replaces _write_page_row_kernel (write_kv_page_row): row b lands at
// pool[page_b, :, :, off_b], page clamped into [0, P-1]; an off outside
// [0, ps) (the server's off = ps sentinel for inactive slots) drops the
// write. Two rows on one page both land (the TPU kernel rereads a revisited
// page as it was and keeps only the last row's write; the server never
// lets two slots write one page). One launch writes up to two (pool, row)
// pairs (k with v, or the int8 scale sidecars through their (P, kvh, 1, ps)
// views, hd = 1), and reads each row in place through its strides: the
// decode step passes k[:, 0] of the projection, hd contiguous and batch
// rows 3 * d apart. A thread owns 16 bytes of one (pair, batch row, kv head)
// row along hd: one 16-byte load where the view allows (hd contiguous, the
// address aligned), else scalar loads, issued together with the loads of
// page_b and off_b (nothing waits on those before the stores), then one
// store per element, ps elements apart (the pool is seq-minor). A decode
// step's write is 64 KB (bf16, 32 rows x 16 heads x 64): latency and the
// scattered 2-byte stores, not bytes, bound it, so the design keeps to one
// wave of one-warp blocks spread over the SMs, with no shared memory and no
// barrier (write_block_kernel's transposing tile would leave 63 of its 64
// token lanes idle at T = 1).
//
// K8 replaces _write_block_kernel (write_kv_block): cache[b, :, :, pos0_b + t]
// = rows[b, :, :, t], t < T <= 128, columns outside [0, L) dropped. K11
// replaces _write_page_block_kernel (write_kv_page_block): token t < n_valid
// of a (kvh, hd, T) chunk lands at pool[page, :, :, off0 + t] while
// 0 <= off0 + t < ps, page clamped into [0, P-1]; pads never touch the pool.
// One kernel serves both (write_block_kernel): a destination of nrow rows of
// (H, D, Lc) seq-minor elements, row = clamp(page) for K11 or the batch row
// for K8, first column pos0_b / off0 read on the device (no host sync), and
// up to two (destination, source) pairs per launch (k with v, or the int8
// scale sidecars ks with vs). The source is read in place through its
// strides: the callers pass the projection's (.., T, kvh, hd) output as a
// permuted view, hd the contiguous axis, tokens kvh * hd (or 3 * d) apart.
// A block (128 threads) owns one (pair, batch row, kv head, 64-token x
// 32-row tile). The source loads do not wait on the device-side scalars, and
// a thread issues all of its loads before its first store:
//   load:  hd contiguous (the path): 16-byte vector loads along hd, two
//          lanes a token (one full 32-byte sector), stored transposed into
//          a shared tile [d][t] whose rows are padded by 4 elements, so
//          that a warp's scalar stores fall in distinct banks for 1-, 2-
//          and 4-byte elements. Any other strides (the scale sidecars'
//          hd = 1, a misaligned view, rows already seq-minor): scalar
//          loads, in the same kernel.
//   store: each cache row (kv head, d) along its contiguous lane axis, a
//          lane per 16-byte destination chunk (a warp's stores coalesce),
//          16-byte vector stores where the chunk lies wholly inside the
//          written columns and scalar stores at the unaligned head and
//          tail (pos0 / off0 take any value, so alignment is a run-time
//          question).
// No cp.async or TMA: a tile is loaded once and stored once, with nothing
// to overlap the load with, and a launch moves at most a few hundred KB.
// Bound: bytes (the rows read once, the columns written once); at the
// serving path's sizes (0.5 MB a k/v pair) a launch costs more than the
// bytes, so the design's gain is launches and copies: no layout copy of
// the source, and one launch for the pair where there were four.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int BK = 128;       // cache tile = threads per block
constexpr int kThreads = BK;
constexpr int kWarps = kThreads / 32;
constexpr int VP = BK + 1;    // padded V / P tile row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int HD, int RT>
constexpr size_t decode_smem() {
  return sizeof(float) * ((size_t)RT * HD + (size_t)RT * VP + (size_t)HD * VP +
                          2 * (size_t)RT * kWarps + 3 * (size_t)RT);
}

// Where the paged pools live (unused by the dense K6).
struct Cols {
  const int* table;  // (b, mp) int32
  int mp, ps, P;
};

// The body K6 and K9 share; the PAGED flag picks the column address.
template <typename C, int HD, int RT, bool QUANT, bool BF16DOT, bool PAGED>
__device__ __forceinline__ void
decode_body(const float* __restrict__ q, const C* __restrict__ kc,
            const C* __restrict__ vc, const float* __restrict__ ksc,
            const float* __restrict__ vsc, const int* __restrict__ pos,
            float* __restrict__ out, int R, int r, int T, int L,
            int pos_stride, int nkv, float scale, const Cols& cols) {
  constexpr int RG = kThreads / HD;             // row groups in the P.V phase
  constexpr int NO = (RT + RG - 1) / RG;        // o accumulators per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // RT x HD
  float* p_s = q_s + RT * HD;         // RT x VP
  float* v_s = p_s + RT * VP;         // HD x VP
  float* red_m = v_s + HD * VP;       // RT x kWarps
  float* red_l = red_m + RT * kWarps; // RT x kWarps
  float* m_s = red_l + RT * kWarps;   // RT
  float* l_s = m_s + RT;              // RT
  float* c_s = l_s + RT;              // RT

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;                 // b * nkv + h
  const int row0 = blockIdx.y * RT;
  const int bi = bh / nkv;
  const int hh = bh - bi * nkv;
  const int p0 = pos[bi * pos_stride];
  // Where column j of this (row, head) lives. Dense: element d * L + j of
  // the (b, kvh, hd, L) cache row at kb (the scale at ksb[j]). Paged: lane
  // j % ps of page table[bi, j / ps] (clamped into [0, P-1]), element kcol
  // + d * ps of the pool (the scale at sidx). Each mode keeps the address
  // form measured fastest for it on the card (bf16, the two forms timed in
  // turns): a block base pointer with the uniform stride L for dense, a
  // per-thread 64-bit index and stride for paged.
  const size_t cbase = (size_t)bh * HD * L;
  const C* kb = kc + cbase;
  const C* vb = vc + cbase;
  const float* ksb = QUANT && !PAGED ? ksc + (size_t)bh * L : nullptr;
  const float* vsb = QUANT && !PAGED ? vsc + (size_t)bh * L : nullptr;

  for (int i = tid; i < RT * HD; i += kThreads) {
    int rr = i / HD, c = i % HD;
    q_s[i] = row0 + rr < R ? q[((size_t)bh * R + row0 + rr) * HD + c] : 0.f;
  }
  if (tid < RT) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float o[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) o[k] = 0.f;
  const int oc = tid % HD, org = tid / HD;

  // the last position any query of this tile attends; tiles past it skipped
  long long last = (long long)p0 + T - 1;
  int live_end = last + 1 < (long long)L ? (int)(last + 1) : L;
  __syncthreads();

  for (int k0 = 0; k0 < live_end; k0 += BK) {
    const int j = k0 + tid;
    const bool in_range = j < L;
    size_t kcol = 0, sidx = 0;
    int pstride = 0;
    if (PAGED && in_range) {
      int lp = j / cols.ps;
      int page = cols.table[(size_t)bi * cols.mp + lp];
      page = page < 0 ? 0 : (page >= cols.P ? cols.P - 1 : page);
      size_t ph = (size_t)page * nkv + hh;
      int off = j - lp * cols.ps;
      kcol = ph * HD * cols.ps + off;
      sidx = ph * cols.ps + off;
      pstride = cols.ps;
    }
    float acc[RT];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) acc[rr] = 0.f;
    if (in_range) {
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float kv = to_f(PAGED ? kc[kcol + (size_t)d * pstride]
                              : kb[(size_t)d * L + j]);
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) acc[rr] = fmaf(q_s[rr * HD + d], kv, acc[rr]);
      }
    }
    const float ks = (QUANT && in_range) ? (PAGED ? ksc[sidx] : ksb[j]) : 1.f;
    bool mask[RT];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      int row = row0 + rr;
      mask[rr] = in_range && row < R && (long long)j <= (long long)p0 + row / r;
      float s = acc[rr] * scale;
      if (QUANT) s = s * ks;
      acc[rr] = mask[rr] ? s : kNeg;
    }
    // V tile, zeroed past the last attended position
    const bool col_ok = in_range && (long long)j <= last;
    for (int c = 0; c < HD; ++c)
      v_s[c * VP + tid] =
          col_ok ? to_f(PAGED ? vc[kcol + (size_t)c * pstride]
                              : vb[(size_t)c * L + j])
                 : 0.f;

    // row max over the tile
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      float mx = acc[rr];
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red_m[rr * kWarps + warp] = mx;
    }
    __syncthreads();
    if (tid < RT) {
      float mx = red_m[tid * kWarps];
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_m[tid * kWarps + w]);
      float m_old = m_s[tid];
      float m_new = fmaxf(m_old, mx);
      c_s[tid] = expf(m_old - m_new);
      m_s[tid] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      float p = mask[rr] ? expf(acc[rr] - m_s[rr]) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) red_l[rr * kWarps + warp] = sum;
      float pv = p;
      if (QUANT) pv = mask[rr] ? p * (PAGED ? vsc[sidx] : vsb[j]) : 0.f;
      if (BF16DOT) pv = round_bf16(pv);
      p_s[rr * VP + tid] = pv;
    }
    __syncthreads();
    if (tid < RT) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red_l[tid * kWarps + w];
      l_s[tid] = l_s[tid] * c_s[tid] + sum;
    }
    // o = o * corr + pv . v
#pragma unroll
    for (int k = 0; k < NO; ++k) {
      int rr = org + k * RG;
      if (rr < RT) {
        float dot = 0.f;
        const float* pr = p_s + rr * VP;
        const float* vr = v_s + oc * VP;
#pragma unroll 8
        for (int jj = 0; jj < BK; ++jj) dot = fmaf(pr[jj], vr[jj], dot);
        o[k] = o[k] * c_s[rr] + dot;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < NO; ++k) {
    int rr = org + k * RG;
    if (rr < RT && row0 + rr < R)
      out[((size_t)bh * R + row0 + rr) * HD + oc] = o[k] / l_s[rr];
  }
}

// K6 and K9 under names of their own (a profile tells them apart)
template <typename C, int HD, int RT, bool QUANT, bool BF16DOT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const C* __restrict__ kc,
              const C* __restrict__ vc, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ pos,
              float* __restrict__ out, int R, int r, int T, int L,
              int pos_stride, int nkv, float scale, Cols cols) {
  decode_body<C, HD, RT, QUANT, BF16DOT, false>(q, kc, vc, ksc, vsc, pos, out,
                                                R, r, T, L, pos_stride, nkv,
                                                scale, cols);
}

template <typename C, int HD, int RT, bool QUANT, bool BF16DOT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const C* __restrict__ kc,
                    const C* __restrict__ vc, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ pos, float* __restrict__ out,
                    int R, int r, int T, int L, int pos_stride, int nkv,
                    float scale, Cols cols) {
  decode_body<C, HD, RT, QUANT, BF16DOT, true>(q, kc, vc, ksc, vsc, pos, out,
                                               R, r, T, L, pos_stride, nkv,
                                               scale, cols);
}

// Every argument of a decode launch, so the dispatch below passes one.
struct DecodeArgs {
  const float* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pos;
  float* out;
  int b, nkv, R, r, T, L, pos_stride;
  float scale;
  Cols cols;
  cudaStream_t s;
};

template <typename C, int HD, int RT, bool QUANT, bool BF16DOT, bool PAGED>
int launch(const DecodeArgs& a) {
  auto kern = PAGED ? paged_decode_kernel<C, HD, RT, QUANT, BF16DOT>
                    : decode_kernel<C, HD, RT, QUANT, BF16DOT>;
  constexpr size_t smem = decode_smem<HD, RT>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.b * a.nkv, (a.R + RT - 1) / RT);
  kern<<<grid, kThreads, smem, a.s>>>(
      a.q, static_cast<const C*>(a.k), static_cast<const C*>(a.v), a.ks, a.vs,
      a.pos, a.out, a.R, a.r, a.T, a.L, a.pos_stride, a.nkv, a.scale, a.cols);
  return (int)cudaGetLastError();
}

template <typename C, int HD, bool QUANT, bool BF16DOT, bool PAGED>
int dispatch_rt(const DecodeArgs& a) {
  if (a.R <= 1) return launch<C, HD, 1, QUANT, BF16DOT, PAGED>(a);
  if (a.R <= 2) return launch<C, HD, 2, QUANT, BF16DOT, PAGED>(a);
  if (a.R <= 4) return launch<C, HD, 4, QUANT, BF16DOT, PAGED>(a);
  return launch<C, HD, 8, QUANT, BF16DOT, PAGED>(a);
}

template <typename C, bool QUANT, bool BF16DOT, bool PAGED>
int dispatch_hd(int HD, const DecodeArgs& a) {
  switch (HD) {
    case 16: return dispatch_rt<C, 16, QUANT, BF16DOT, PAGED>(a);
    case 32: return dispatch_rt<C, 32, QUANT, BF16DOT, PAGED>(a);
    case 64: return dispatch_rt<C, 64, QUANT, BF16DOT, PAGED>(a);
    case 128: return dispatch_rt<C, 128, QUANT, BF16DOT, PAGED>(a);
  }
  return -1;
}

template <bool PAGED>
int dispatch_cache(int cache_code, int HD, const DecodeArgs& a) {
  switch (cache_code) {
    case 1: return dispatch_hd<float, false, false, PAGED>(HD, a);
    case 2: return dispatch_hd<__nv_bfloat16, false, true, PAGED>(HD, a);
    case 3:
      if (!a.ks || !a.vs) return -1;
      return dispatch_hd<int8_t, true, true, PAGED>(HD, a);
  }
  return -1;
}

// K7 row copies, by element size
template <typename E>
__global__ void write_row_kernel(E* cache, const E* row, const int* pos, int b,
                                 int inner, int L, int pos_stride) {
  int64_t n = (int64_t)b * inner;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int bi = (int)(i / inner);
    int p = pos[bi * pos_stride];
    if (p >= 0 && p < L) cache[i * L + p] = row[i];
  }
}

// K10: one launch writes up to two (pool, row) pairs of one row per batch row.
// A block is one warp, so that a decode step's scattered stores spread over
// every SM (blocks of 128 threads kept them on 32 SMs and ran slower).
constexpr int kRThreads = 32;

struct PageRowWrite {
  void* dst[2];                   // (P, H, D, ps) contiguous
  const void* src[2];             // element (bi, h, d) at
  long long sb[2], sh[2], sd[2];  //   bi*sb + h*sh + d*sd
  const int* page;                // page[bi * page_stride], clamped
  const int* off;                 // off[bi * off_stride], kept in [0, ps)
  int page_stride, off_stride;
  int nb, H, D, P, ps, n_chunks;  // n_chunks: 16-byte chunks of a row
};

template <typename E>
__global__ void __launch_bounds__(kRThreads)
write_page_row_kernel(PageRowWrite a) {
  constexpr int VEC = 16 / (int)sizeof(E);
  // the pair by selects, not a run-time index into the parameters (which
  // would copy them to local memory)
  const bool second = blockIdx.y != 0;
  const int i = blockIdx.x * kRThreads + threadIdx.x;
  const int per_b = a.H * a.n_chunks;
  if (i >= a.nb * per_b) return;
  const int bi = i / per_b, h = (i % per_b) / a.n_chunks;
  const int d0 = (i % a.n_chunks) * VEC;
  const int nd = a.D - d0 < VEC ? a.D - d0 : VEC;
  const int o = __ldg(a.off + (long long)bi * a.off_stride);
  int pg = __ldg(a.page + (long long)bi * a.page_stride);
  const long long sd = second ? a.sd[1] : a.sd[0];
  const E* src = static_cast<const E*>(second ? a.src[1] : a.src[0]) +
                 bi * (second ? a.sb[1] : a.sb[0]) +
                 h * (second ? a.sh[1] : a.sh[0]) + d0 * sd;
  uint4 x;
  E* e = reinterpret_cast<E*>(&x);
  if (nd == VEC && sd == 1 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    x = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < nd) e[j] = __ldg(src + j * sd);
  }
  if (o < 0 || o >= a.ps) return;
  pg = pg < 0 ? 0 : (pg >= a.P ? a.P - 1 : pg);
  E* out = static_cast<E*>(second ? a.dst[1] : a.dst[0]) +
           (((long long)pg * a.H + h) * a.D + d0) * a.ps + o;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j < nd) out[(long long)j * a.ps] = e[j];
}

// K8 / K11: one launch writes up to two (dst, src) pairs of T columns.
constexpr int WT = 64;            // tokens of a tile
constexpr int WD = 32;            // cache rows (d) of a tile
constexpr int WRS = WT + 4;       // padded shared row, in elements
constexpr int kWThreads = 128;

struct BlockWrite {
  void* dst[2];                   // (nrow, H, D, Lc) contiguous
  const void* src[2];             // element (bi, h, d, t) at
  long long sb[2], sh[2], sd[2], st[2];  // bi*sb + h*sh + d*sd + t*st
  const int* row;                 // K11: one page, clamped; null: row = bi
  const int* col0;                // first column of batch row bi at
  int col0_stride;                //   col0[bi * col0_stride]
  const int* n_valid;             // tokens to write (one value); null: T
  int H, D, T, Lc, nrow, n_t_tiles;
};

template <typename E>
__global__ void __launch_bounds__(kWThreads)
write_block_kernel(BlockWrite a) {
  constexpr int VEC = 16 / (int)sizeof(E);
  constexpr int NVEC = WT * WD / VEC;                   // vectors in a tile
  constexpr int NV = (NVEC + kWThreads - 1) / kWThreads;  // ... a thread
  constexpr int NS = WT * WD / kWThreads;               // scalars a thread
  __shared__ __align__(16) E tile[WD * WRS];
  const int pair = blockIdx.z;
  const int bi = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int t0 = (blockIdx.x % a.n_t_tiles) * WT;
  const int d0 = (blockIdx.x / a.n_t_tiles) * WD;
  const int nd = a.D - d0 < WD ? a.D - d0 : WD;
  const int nt = a.T - t0 < WT ? a.T - t0 : WT;
  // the device-side scalars load while the rows do: nothing waits on
  // them before the stores
  const long long c0 = a.col0[bi * a.col0_stride];
  const long long nv = a.n_valid ? a.n_valid[0] : a.T;
  int row = a.row ? a.row[0] : bi;

  // the tile's rows [t0, t0 + nt) x [d0, d0 + nd), loaded into registers;
  // __ldg: read-only loads need not wait on the tile's stores (a generic
  // pointer could alias shared memory), so a thread issues all of its
  // loads at once
  const E* src = static_cast<const E*>(a.src[pair]) + bi * a.sb[pair] +
                 h * a.sh[pair] + d0 * a.sd[pair];
  const long long sd = a.sd[pair], st = a.st[pair];
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  // hd contiguous (the projection's layout): 16-byte loads along d, two
  // lanes a token (one 32-byte sector), to be transposed
  const bool along_d = aligned && sd == 1 && a.D % VEC == 0 &&
                       (st * (long long)sizeof(E)) % 16 == 0;
  uint4 x[NV];
  E xs[NS];
  if (along_d) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * kWThreads;
      const int v = (i / (2 * WT)) * 2 + (i & 1), t = (i % (2 * WT)) / 2;
      if (i < NVEC && v * VEC < nd && t < nt)
        x[k] = __ldg(reinterpret_cast<const uint4*>(src + (t0 + t) * st) + v);
    }
  } else {
    // any other strides (the scale sidecars' hd = 1, a misaligned view,
    // rows already seq-minor)
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int i = threadIdx.x + k * kWThreads;
      const int t = i % WT, d = i / WT;
      if (d < nd && t < nt) xs[k] = __ldg(src + d * sd + (t0 + t) * st);
    }
  }

  // tokens [lo, hi) of the tile land inside [0, Lc) and below n_valid
  long long lo = t0 > -c0 ? t0 : -c0;
  long long hi = t0 + nt;
  if (hi > nv) hi = nv;
  if (hi > a.Lc - c0) hi = a.Lc - c0;
  if (lo >= hi) return;           // the whole block: no barrier skipped
  row = row < 0 ? 0 : (row >= a.nrow ? a.nrow - 1 : row);
  E* dst = static_cast<E*>(a.dst[pair]) +
           (((long long)row * a.H + h) * a.D + d0) * a.Lc;
  const bool vec_st = reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                      ((long long)a.Lc * sizeof(E)) % 16 == 0;

  // stage the tile as tile[d][t]: rows padded by 4 elements, so that a
  // warp's scalar stores of the transposed vectors fall in distinct banks
  // for 1-, 2- and 4-byte elements
  if (along_d) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * kWThreads;
      const int v = (i / (2 * WT)) * 2 + (i & 1), t = (i % (2 * WT)) / 2;
      if (i < NVEC && v * VEC < nd && t < nt) {
        const E* e = reinterpret_cast<const E*>(&x[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) tile[(v * VEC + j) * WRS + t] = e[j];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int i = threadIdx.x + k * kWThreads;
      const int t = i % WT, d = i / WT;
      if (d < nd && t < nt) tile[d * WRS + t] = xs[k];
    }
  }
  __syncthreads();

  // columns [clo, chi) of each of the tile's nd cache rows, in 16-byte
  // destination chunks (a lane each): vector stores where a chunk lies
  // wholly inside, scalar stores at the unaligned head and tail
  const long long clo = c0 + lo, chi = c0 + hi, k0 = clo / VEC;
  const int nk = (int)((chi - 1) / VEC - k0 + 1);
  const long long shift = c0 + t0;  // column c sits at tile[d][c - shift]
  for (int i = threadIdx.x; i < nk * nd; i += kWThreads) {
    const int d = i / nk;
    const long long cs = (k0 + i % nk) * VEC;
    E* out = dst + (long long)d * a.Lc;
    const E* in = tile + d * WRS;
    if (vec_st && cs >= clo && cs + VEC <= chi) {
      uint4 y;
      E* e = reinterpret_cast<E*>(&y);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = in[cs + j - shift];
      *reinterpret_cast<uint4*>(out + cs) = y;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const long long c = cs + j;
        if (c >= clo && c < chi) out[c] = in[c - shift];
      }
    }
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename E>
int launch_write_row(void* cache, const void* row, const int* pos, int b,
                     int inner, int L, int ps, cudaStream_t s) {
  write_row_kernel<E><<<grid_for((int64_t)b * inner), 256, 0, s>>>(
      static_cast<E*>(cache), static_cast<const E*>(row), pos, b, inner, L, ps);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_page_row(PageRowWrite& a, int pairs, cudaStream_t s) {
  a.n_chunks = (a.D + 16 / (int)sizeof(E) - 1) / (16 / (int)sizeof(E));
  const long long n = (long long)a.nb * a.H * a.n_chunks;
  if (n > 0x7fffffffLL - kRThreads) return -1;
  dim3 grid((unsigned)((n + kRThreads - 1) / kRThreads), pairs);
  write_page_row_kernel<E><<<grid, kRThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Whether two (dst, src) pairs alias: a destination of dn bytes overlapping
// the other destination or the other pair's source [s, s_end).
bool pairs_alias(uint64_t dst0, uint64_t dst1, uint64_t dn, uint64_t src0,
                 uint64_t src0_end, uint64_t src1, uint64_t src1_end) {
  auto overlap = [](uint64_t a0, uint64_t a1, uint64_t b0, uint64_t b1) {
    return a0 < b1 && b0 < a1;
  };
  return overlap(dst0, dst0 + dn, dst1, dst1 + dn) ||
         overlap(dst0, dst0 + dn, src1, src1_end) ||
         overlap(dst1, dst1 + dn, src0, src0_end);
}

template <typename E>
int launch_block_write(const BlockWrite& a, int nb, int pairs,
                       cudaStream_t s) {
  dim3 grid(a.n_t_tiles * ((a.D + WD - 1) / WD), nb * a.H, pairs);
  write_block_kernel<E><<<grid, kWThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns the cudaGetLastError()
// code after its launch (0 = success), or -1 for a shape or type it does not
// take; each launches on `stream`, does not synchronise and allocates nothing.

// K6. cache_code 1 = f32, 2 = bf16, 3 = int8 (ks, vs required). q and out
// (b, nkv, R, HD) f32; pos int32, one shared value (pos_per_row 0) or b.
extern "C" int rlo_flash_decode(int cache_code, const void* q, const void* k,
                                const void* v, const void* ks, const void* vs,
                                const void* pos, void* out, int b, int nkv,
                                int R, int r, int T, int HD, int L,
                                int pos_per_row, float scale, void* stream) {
  if (b <= 0 || nkv <= 0 || R <= 0) return 0;
  if (r <= 0 || T <= 0 || R != T * r || L <= 0) return -1;
  DecodeArgs a{static_cast<const float*>(q), k, v,
               static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const int*>(pos), static_cast<float*>(out),
               b, nkv, R, r, T, L, pos_per_row ? 1 : 0, scale,
               Cols{nullptr, 0, 0, 0}, static_cast<cudaStream_t>(stream)};
  return dispatch_cache<false>(cache_code, HD, a);
}

// K9. Pools (P, nkv, HD, ps) of cache_code's type (int8: scale pools
// (P, nkv, ps) f32 in ks, vs), table (b, mp) int32; q and out as K6.
extern "C" int rlo_paged_flash_decode(int cache_code, const void* q,
                                      const void* k, const void* v,
                                      const void* ks, const void* vs,
                                      const void* table, const void* pos,
                                      void* out, int b, int nkv, int R, int r,
                                      int T, int HD, int P, int ps, int mp,
                                      int pos_per_row, float scale,
                                      void* stream) {
  if (b <= 0 || nkv <= 0 || R <= 0) return 0;
  if (r <= 0 || T <= 0 || R != T * r || P <= 0 || ps <= 0 || mp <= 0 ||
      (long long)mp * ps > 0x7fffffffLL)
    return -1;
  DecodeArgs a{static_cast<const float*>(q), k, v,
               static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const int*>(pos), static_cast<float*>(out),
               b, nkv, R, r, T, mp * ps, pos_per_row ? 1 : 0, scale,
               Cols{static_cast<const int*>(table), mp, ps, P},
               static_cast<cudaStream_t>(stream)};
  return dispatch_cache<true>(cache_code, HD, a);
}

// K7. cache (b, inner, L), row (b, inner), inner = kvh * hd.
extern "C" int rlo_write_kv_row(void* cache, const void* row, const void* pos,
                                int b, int inner, int L, int elem_size,
                                int pos_per_row, void* stream) {
  if (b <= 0 || inner <= 0 || L <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int*>(pos);
  int ps = pos_per_row ? 1 : 0;
  switch (elem_size) {
    case 1: return launch_write_row<uint8_t>(cache, row, ip, b, inner, L, ps, s);
    case 2: return launch_write_row<uint16_t>(cache, row, ip, b, inner, L, ps, s);
    case 4: return launch_write_row<uint32_t>(cache, row, ip, b, inner, L, ps, s);
  }
  return -1;
}

// K10: up to two (pool, row) pairs (dst1 null: one pair), one launch,
// described by one parameter block. pool (P, H, D, ps) contiguous; row
// element (bi, h, d) at bi*sb + h*sh + d*sd elements from its pointer,
// bi < nb; row bi lands in lane off[bi * off_stride] of page
// page[bi * page_stride] (clamped into [0, P-1]) when that lane lies in
// [0, ps). Returns -2 when the two pairs alias.
struct PageRowParams {
  uint64_t dst0, src0, dst1, src1;
  int64_t sb0, sh0, sd0, sb1, sh1, sd1;
  uint64_t page, off;
  int32_t page_stride, off_stride, nb, H, D, P, ps, elem_size;
};
static_assert(sizeof(PageRowParams) == 128, "packed as <4Q6q2Q8i");

extern "C" int rlo_write_kv_page_rows(const void* params, void* stream) {
  PageRowParams p;
  memcpy(&p, params, sizeof p);
  if (p.nb <= 0 || p.H <= 0 || p.D <= 0) return 0;
  if (p.P <= 0 || p.ps <= 0 || !p.dst0 || !p.src0 || !p.page || !p.off ||
      (!p.dst1) != (!p.src1))
    return -1;
  if (p.dst1) {
    auto end = [&](uint64_t s, int64_t sb, int64_t sh, int64_t sd) {
      return s + (uint64_t)(1 + (p.nb - 1) * sb + (p.H - 1) * sh +
                            (p.D - 1) * sd) * p.elem_size;
    };
    if (pairs_alias(p.dst0, p.dst1,
                    (uint64_t)p.P * p.H * p.D * p.ps * p.elem_size, p.src0,
                    end(p.src0, p.sb0, p.sh0, p.sd0), p.src1,
                    end(p.src1, p.sb1, p.sh1, p.sd1)))
      return -2;
  }
  auto ptr = [](uint64_t x) { return reinterpret_cast<void*>(x); };
  PageRowWrite a{{ptr(p.dst0), ptr(p.dst1)}, {ptr(p.src0), ptr(p.src1)},
                 {p.sb0, p.sb1}, {p.sh0, p.sh1}, {p.sd0, p.sd1},
                 static_cast<const int*>(ptr(p.page)),
                 static_cast<const int*>(ptr(p.off)), p.page_stride,
                 p.off_stride, p.nb, p.H, p.D, p.P, p.ps, 0};
  const int pairs = p.dst1 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.elem_size) {
    case 1: return launch_page_row<uint8_t>(a, pairs, s);
    case 2: return launch_page_row<uint16_t>(a, pairs, s);
    case 4: return launch_page_row<uint32_t>(a, pairs, s);
  }
  return -1;
}

// K8 and K11: up to two (dst, src) pairs (dst1 null: one pair), one launch,
// described by one parameter block (a ctypes call's cost grows with its
// argument count: the block is packed on the host in one step). dst (nrow,
// H, D, Lc) contiguous; src element (bi, h, d, t) at bi*sb + h*sh + d*sd +
// t*st elements from its pointer, bi < nb, t < T. row: K11's page (one value,
// clamped into [0, nrow-1]) or null (K8: the batch row bi, nb == nrow).
// Column col0[bi * col0_stride] + t is written for t < n_valid[0] (null:
// every t) and 0 <= column < Lc. Returns -2 when the two pairs alias: a
// destination overlapping the other destination or the other pair's source.
struct BlockWriteParams {
  uint64_t dst0, src0, dst1, src1;
  int64_t sb0, sh0, sd0, st0, sb1, sh1, sd1, st1;
  uint64_t row, col0, n_valid;
  int32_t col0_stride, nb, H, D, T, Lc, nrow, elem_size;
};
static_assert(sizeof(BlockWriteParams) == 152, "packed as <4Q8q3Q8i");

extern "C" int rlo_write_kv_block_cols(const void* params, void* stream) {
  BlockWriteParams p;
  memcpy(&p, params, sizeof p);
  if (p.nb <= 0 || p.H <= 0 || p.D <= 0 || p.T <= 0 || p.Lc <= 0) return 0;
  if (p.nrow <= 0 || (!p.row && p.nb != p.nrow) || !p.dst0 || !p.src0 ||
      (!p.dst1) != (!p.src1) || (long long)p.nb * p.H > 65535)
    return -1;
  if (p.dst1) {
    auto end = [&](uint64_t s, int64_t sb, int64_t sh, int64_t sd,
                   int64_t st) {
      return s + (uint64_t)(1 + (p.nb - 1) * sb + (p.H - 1) * sh +
                            (p.D - 1) * sd + (p.T - 1) * st) * p.elem_size;
    };
    if (pairs_alias(p.dst0, p.dst1,
                    (uint64_t)p.nrow * p.H * p.D * p.Lc * p.elem_size, p.src0,
                    end(p.src0, p.sb0, p.sh0, p.sd0, p.st0), p.src1,
                    end(p.src1, p.sb1, p.sh1, p.sd1, p.st1)))
      return -2;
  }
  auto ptr = [](uint64_t x) { return reinterpret_cast<void*>(x); };
  BlockWrite a{{ptr(p.dst0), ptr(p.dst1)}, {ptr(p.src0), ptr(p.src1)},
               {p.sb0, p.sb1}, {p.sh0, p.sh1}, {p.sd0, p.sd1},
               {p.st0, p.st1}, static_cast<const int*>(ptr(p.row)),
               static_cast<const int*>(ptr(p.col0)), p.col0_stride ? 1 : 0,
               static_cast<const int*>(ptr(p.n_valid)), p.H, p.D, p.T, p.Lc,
               p.nrow, (p.T + WT - 1) / WT};
  const int pairs = p.dst1 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.elem_size) {
    case 1: return launch_block_write<uint8_t>(a, p.nb, pairs, s);
    case 2: return launch_block_write<uint16_t>(a, p.nb, pairs, s);
    case 4: return launch_block_write<uint32_t>(a, p.nb, pairs, s);
  }
  return -1;
}
