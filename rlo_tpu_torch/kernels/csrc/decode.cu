// K6, K7 and K8: decode attention against the dense KV cache, and the two
// in-place cache writes. K9, K10 and K11: the same against a page pool.
//
// K6 replaces rlo_tpu/pallas/decode.py:_decode_kernel (behind
// flash_block_decode and flash_decode). Cache (b, kvh, hd, L) seq-minor in
// f32, bf16 or int8 (with f32 scales (b, kvh, L)); q (b, T, nh, hd), f32 or
// bf16, read in place through its strides (the decode step passes a view of
// the qkv projection) and rounded to the dot dtype here; row t*r + rr of kv
// head h is token t of query head h*r + rr, at position pos_b + t; out (b,
// T, nh, hd) f32. Per cache tile of BK = 128 positions, as the TPU kernel
// does per grid step:
//   s    = (q . k) * scale, f32 accumulation of exact bf16 (or f32) products
//   s   *= k_scale                                            (int8 only)
//   s    = where(j <= pos + t && j < L, s, -1e30); v = 0 past the last
//          position the row tile attends
//   m'   = max(m, rowmax s);  p = where(mask, exp(s - m'), 0)
//   l'   = l * exp(m - m') + rowsum p
//   pv   = where(mask, p * v_scale, 0) (int8) else p, rounded to the dot dtype
//   o'   = o * exp(m - m') + pv . v
// Bound: bytes. Decode reads the live cache (k, v and the scales up to
// pos + T) once and does ~4 flops per byte of bf16 cache, far below the
// card's 295 flops/byte ridge: the least time is those bytes over 3.35 TB/s
// (H100 SXM). So the design is about keeping enough bytes in flight on
// every SM:
//   - Partition. The cache axis is cut into splits of S positions (S =
//     split_k, a multiple of BK: decode.py's SPLIT_K), fixed in absolute
//     positions: split s is [s*S, (s+1)*S), the same for every T, batch, L,
//     dtype and for K6 and K9. The grid is (b * kvh, row tiles of RT query
//     rows, splits); a split past its row tile's last attended position
//     returns at once. A block walks its split's BK tiles in order with the
//     online softmax above, from m = -1e30, l = 0, o = 0.
//   - Loads. A tile's K and V rows (and the int8 scales) are copied by
//     16-byte cp.async into a ring of 2 shared-memory stages (1 where two do
//     not fit: f32 at hd 128), so the next tile is in flight during this
//     one's arithmetic. Each (kv head, d) row of a tile is BK contiguous
//     elements of the seq-minor cache, or ps-element runs of pages; a
//     16-byte chunk never crosses a page when ps * elem is a multiple of 16.
//     Chunks past the live end are zero-filled, not read. Rows that are not
//     16-byte aligned (an odd L or ps) take plain loads into the same tiles.
//     Tile rows are padded by 16 bytes, so the P.V phase's 16-byte reads of
//     V rows fall in distinct banks.
//   - Arithmetic from shared memory. A row tile holds RT = 1..32 query
//     rows (the least power of two >= R, at most 32: the prefix is read
//     R / RT times); RT >= 16 runs two row groups of 128 threads, each on
//     half of the rows, so a prefill chunk keeps 8 warps a block. Scores:
//     thread j of a row group owns column j, a fmaf chain over d =
//     0..hd-1 from 0 for each of its rows. P.V: thread (column c of out,
//     part) runs a fmaf chain over its hd positions of the tile, the 128 /
//     hd parts summed by a fixed xor tree. Every row's arithmetic is the
//     same whatever RT or T (explicit _rn intrinsics: the compiler
//     contracts nothing differently between instantiations). No tensor
//     cores: at T = 1 the work is far below the ridge; a mma route for T
//     >= 16 would have to move every T at once.
//   - Merge, in the same launch. A row tile with one live split writes
//     out = o / l itself. Otherwise each split writes (m, l, o) to an f32
//     workspace, fences, and bumps an arrival counter of its (batch row, kv
//     head, row tile); the block that arrives last merges the live splits
//     in split-index order (never arrival order):
//       M = max_s m_s, l = sum_s l_s * e^(m_s - M), o = sum_s o_s *
//       e^(m_s - M), out = o / l
//     and sets the counter back to 0. The wrapper keeps the workspace and
//     counters per (device, stream) and never zeroes them per call. A split
//     wholly past a row's last position adds exactly 0 (e^(-1e30 - M) = 0,
//     l_s = 0), and one live split merges to its own o / l, so a row's bits
//     do not depend on T, the batch, its other rows or L (T = 1 equals row
//     t of T > 1), and K9 on a dense cache's columns equals K6.
// The TPU kernel's grid-per-tile and VMEM sizing (_pick_bk,
// _block_fits_vmem) are not carried over.
//
// K9 replaces rlo_tpu/pallas/decode.py:_paged_decode_kernel (behind
// paged_flash_decode): K6 through a page table. Pools (P, kvh, hd, ps), scale
// pools (P, kvh, ps), table (b, mp) int32; logical position j of row b lives
// at lane j % ps of physical page table[b, j / ps] (clamped into [0, P-1]),
// over a logical length L = mp * ps. The same kernel body as K6 with the
// chunk address swapped (the PAGED template flag): the tiles and splits are
// LOGICAL positions whatever ps is, so pages that hold a dense cache's
// columns give K6's result bit for bit. A block reads its split's table
// entries once, into shared memory, while its position loads. Unmapped
// entries point at the null page, whose positions the masks hide. Bound:
// the live bytes read (k, v and the scales up to pos + T, plus the table)
// over 3.35 TB/s.
//
// K7 replaces rlo_tpu/pallas/decode.py:_write_row_kernel (write_kv_row):
// cache[b, :, :, pos_b] = row[b]; a position outside [0, L) (negative ones
// included) matches no column and its write is dropped, as on the TPU; pos
// is read on the device, stride 0 (one shared position) or 1 (one per row).
// K10 replaces _write_page_row_kernel (write_kv_page_row): row b lands at
// pool[page_b, :, :, off_b], page clamped into [0, P-1]; an off outside
// [0, ps) (the server's off = ps sentinel for inactive slots) drops the
// write. Two rows on one page both land (the TPU kernel rereads a revisited
// page as it was and keeps only the last row's write; the server never
// lets two slots write one page).
// One kernel serves both (write_row_kernel): the dense cache (b, kvh, hd, L)
// is a pool of b pages whose page is the batch row (a null page pointer)
// and whose lane is pos_b. One launch writes up to two (destination, row)
// pairs (k with v, or the int8 scale sidecars through their (.., kvh, 1,
// L) views, hd = 1), and reads each row in place through its strides: the
// decode step passes k[:, 0] of the projection, hd contiguous and batch
// rows 3 * d apart. A thread owns 16 bytes of one (pair, batch row, kv
// head) row along hd: one 16-byte load where the view allows (hd
// contiguous, the address aligned), else scalar loads, issued together
// with the loads of page_b and the lane (nothing waits on those before the
// stores), then one store per element, L (ps) elements apart (the cache is
// seq-minor). A decode step's write is 64 KB (bf16, 32 rows x 16 heads x
// 64): latency and the scattered 2-byte stores, not bytes, bound it, so the
// design keeps to one wave of one-warp blocks spread over the SMs, with no
// shared memory and no barrier (write_block_kernel's transposing tile
// would leave 63 of its 64 token lanes idle at T = 1).
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
constexpr int BK = 128;       // cache tile = threads of a row group
constexpr int kWarps = BK / 32;  // warps of a row group

// Threads of a block: one row group of BK threads, two for the large row
// tiles (each thread then runs half of the tile's rows).
template <int RT>
__host__ __device__ constexpr int threads_of() {
  return RT >= 16 ? 2 * BK : BK;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read)
// when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The unsigned type of an element's bits (the plain-load path copies bits).
template <int N> struct RawOf;
template <> struct RawOf<1> { using type = uint8_t; };
template <> struct RawOf<2> { using type = uint16_t; };
template <> struct RawOf<4> { using type = uint32_t; };

// Every argument of a K6/K9 launch, passed to the kernel as one parameter.
struct DecodeArgs {
  const void* q;                    // element (bi, t, head, d) at
  long long qsb, qst, qsh, qsd;     //   bi*qsb + t*qst + head*qsh + d*qsd
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pos;                   // pos[bi * pos_stride]
  float* out;                       // (b, T, nkv * r, hd)
  float* ws;                        // (b * nkv, R, nsplit, hd + 2) partials
  int* cnt;                         // (b * nkv, row tiles) arrivals, all 0
  const int* table;                 // K9: (b, mp) int32
  int mp, ps, P;
  int b, nkv, R, r, T, L, pos_stride, split_k, nsplit, q_bf16, vec;
  float scale;
};

// The shared-memory plan of one instantiation: a ring of NST stages (K and
// V tiles of hd rows x BK, rows padded by 16 bytes; the int8 scales), then
// q, p, the row reductions and the running (m, l, correction).
template <typename C, int HD, int RT, bool QUANT>
struct Plan {
  static constexpr int VEC = 16 / (int)sizeof(C);  // elements a chunk
  static constexpr int KP = BK + VEC;              // padded tile row
  static constexpr int NCH = BK / VEC;             // chunks a tile row
  static constexpr size_t tile_bytes = (size_t)HD * KP * sizeof(C);
  static constexpr size_t stage_bytes =
      2 * tile_bytes + (QUANT ? 2 * BK * sizeof(float) : 0);
  static constexpr int NST = 2 * stage_bytes <= 160 * 1024 ? 2 : 1;
  static constexpr size_t rest_bytes =
      sizeof(float) * ((size_t)RT * HD + (size_t)RT * BK +
                       2 * (size_t)RT * kWarps + 3 * (size_t)RT) +
      4 * sizeof(int);
  static constexpr size_t bytes = NST * stage_bytes + rest_bytes;
};

// The body K6 and K9 share; the PAGED flag picks the chunk address.
template <typename C, int HD, int RT, bool QUANT, bool BF16DOT, bool PAGED>
__device__ __forceinline__ void decode_body(const DecodeArgs& a) {
  using Lay = Plan<C, HD, RT, QUANT>;
  using Raw = typename RawOf<sizeof(C)>::type;
  constexpr int VEC = Lay::VEC, KP = Lay::KP, NCH = Lay::NCH, NST = Lay::NST;
  constexpr int NT = threads_of<RT>();  // threads
  constexpr int RR = RT * BK / NT;      // rows a thread runs
  constexpr int NPART = BK / HD;        // partial chains of a P.V dot
  constexpr int OCW = 32 / NPART;       // out columns of a warp
  constexpr int PLEN = BK / NPART;      // positions of a partial chain
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + NST * Lay::stage_bytes);
  float* p_s = q_s + RT * HD;           // RT x BK
  float* red_m = p_s + RT * BK;         // RT x kWarps
  float* red_l = red_m + RT * kWarps;   // RT x kWarps
  float* m_s = red_l + RT * kWarps;     // RT
  float* l_s = m_s + RT;                // RT
  float* c_s = l_s + RT;                // RT
  int* last_s = reinterpret_cast<int*>(c_s + RT);
  int* pg_s = last_s + 4;               // K9: the split's pages

  // thread (row group g, column t): rows [g * RR, (g + 1) * RR) of the
  // tile, column t of a cache tile; lane and warp within the row group
  const int tid = threadIdx.x, g = tid / BK, t = tid - g * BK;
  const int lane = t & 31, warp = t >> 5, rg0 = g * RR;
  const int bh = blockIdx.x, rt = blockIdx.y, split = blockIdx.z;
  const int row0 = rt * RT;
  const int bi = bh / a.nkv, hh = bh - bi * a.nkv;
  const int R = a.R, r = a.r, L = a.L, S = a.split_k;
  const int c_begin = split * S;
  const int p0 = a.pos[bi * a.pos_stride];
  int pg0 = 0;
  if (PAGED) {
    // the split's table entries, loaded while the position is in flight
    pg0 = c_begin / a.ps;
    const int c_stop = c_begin + S < L ? c_begin + S : L;
    const int npg = (c_stop - 1) / a.ps + 1 - pg0;
    for (int i = tid; i < npg; i += NT) {
      int page = a.table[(size_t)bi * a.mp + pg0 + i];
      pg_s[i] = page < 0 ? 0 : (page >= a.P ? a.P - 1 : page);
    }
  }
  // the last position a row of this tile attends, the live columns' end
  const int row_last = (row0 + RT < R ? row0 + RT : R) - 1;
  const long long last = (long long)p0 + row_last / r;
  const long long live = last + 1 < (long long)L ? last + 1 : L;
  const int live_end = live > 0 ? (int)live : 0;
  const int n_live = live_end > S ? (live_end + S - 1) / S : 1;
  if (split >= n_live) return;
  const int c_end = c_begin + S < live_end ? c_begin + S : live_end;
  const int n_t = c_end > c_begin ? (c_end - c_begin + BK - 1) / BK : 0;
  if (PAGED) __syncthreads();  // pg_s

  const C* kc = static_cast<const C*>(a.k);
  const C* vc = static_cast<const C*>(a.v);
  // element offset of (d, column col) in k/v, and of col in the scales
  auto at = [&](int d, int col) -> size_t {
    if (PAGED) {
      const int lp = col / a.ps;
      const size_t ph = (size_t)pg_s[lp - pg0] * a.nkv + hh;
      return (ph * HD + d) * a.ps + (col - lp * a.ps);
    }
    return ((size_t)bh * HD + d) * L + col;
  };
  auto at_scale = [&](int col) -> size_t {
    if (PAGED) {
      const int lp = col / a.ps;
      return ((size_t)pg_s[lp - pg0] * a.nkv + hh) * a.ps + (col - lp * a.ps);
    }
    return (size_t)bh * L + col;
  };
  // tile i of the split into stage st: columns [c_begin + i*BK, +BK), those
  // at or past c_end zero-filled
  auto load_tile = [&](int i, int st) {
    C* k_t = reinterpret_cast<C*>(smem + st * Lay::stage_bytes);
    C* v_t = k_t + HD * KP;
    float* ks_t = reinterpret_cast<float*>(v_t + HD * KP);
    const int k0 = c_begin + i * BK;
    if (a.vec) {
      // a thread keeps one 16-byte column chunk of the tile and walks the
      // rows DSTEP apart: one address (one page lookup) a tile
      constexpr int DSTEP = NT / NCH;
      const int d0 = tid / NCH, j = (tid - d0 * NCH) * VEC, col = k0 + j;
      const bool ok = col < c_end;
      const size_t ga = ok && d0 < HD ? at(d0, col) : 0;
      const size_t gstep = ok ? (size_t)DSTEP * (PAGED ? a.ps : L) : 0;
#pragma unroll
      for (int k = 0; k < (HD + DSTEP - 1) / DSTEP; ++k) {
        const int d = d0 + k * DSTEP;
        if (HD % DSTEP == 0 || d < HD) {
          cp_async16(k_t + d * KP + j, kc + ga + k * gstep, ok);
          cp_async16(v_t + d * KP + j, vc + ga + k * gstep, ok);
        }
      }
      if (QUANT && tid < 2 * BK / 4) {
        const int j = (tid % (BK / 4)) * 4, col = k0 + j;
        const bool ok = col < c_end;
        const float* src = tid < BK / 4 ? a.ks : a.vs;
        cp_async16(ks_t + (tid < BK / 4 ? 0 : BK) + j,
                   src + (ok ? at_scale(col) : 0), ok);
      }
    } else {
      // rows not 16-byte aligned: plain loads of the element bits
      const Raw* kr = reinterpret_cast<const Raw*>(kc);
      const Raw* vr = reinterpret_cast<const Raw*>(vc);
      Raw* kt = reinterpret_cast<Raw*>(k_t);
      Raw* vt = reinterpret_cast<Raw*>(v_t);
      for (int e = tid; e < HD * BK; e += NT) {
        const int d = e / BK, j = e - d * BK, col = k0 + j;
        Raw x = 0, y = 0;
        if (col < c_end) {
          const size_t ge = at(d, col);
          x = kr[ge];
          y = vr[ge];
        }
        kt[d * KP + j] = x;
        vt[d * KP + j] = y;
      }
      if (QUANT && tid < BK) {
        const int col = k0 + tid;
        const bool ok = col < c_end;
        const size_t gs = ok ? at_scale(col) : 0;
        ks_t[tid] = ok ? a.ks[gs] : 0.f;
        ks_t[BK + tid] = ok ? a.vs[gs] : 0.f;
      }
    }
  };

  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_t) load_tile(i, i);
    cp_async_commit();
  }
  for (int i = tid; i < RT * HD; i += NT) {
    const int rr = i / HD, d = i - rr * HD, row = row0 + rr;
    float x = 0.f;
    if (row < R) {
      const int t = row / r, head = hh * r + (row - t * r);
      const long long off = bi * a.qsb + t * a.qst + head * a.qsh + d * a.qsd;
      x = a.q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.q)[off])
                   : static_cast<const float*>(a.q)[off];
      if (BF16DOT) x = round_bf16(x);
    }
    q_s[i] = x;
  }
  if (tid < RT) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float o[RR];
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) o[rr] = 0.f;
  const int oc = warp * OCW + lane % OCW, part = lane / OCW;

  for (int it = 0; it < n_t; ++it) {
    const int nxt = it + NST - 1;
    if (nxt < n_t) load_tile(nxt, nxt % NST);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    const int st = it % NST;
    const C* k_t = reinterpret_cast<const C*>(smem + st * Lay::stage_bytes);
    C* v_t = const_cast<C*>(k_t) + HD * KP;
    const float* ks_t = reinterpret_cast<const float*>(v_t + HD * KP);
    const int k0 = c_begin + it * BK;
    // V zeroed past c_end inside the 16-byte chunk that holds c_end - 1 (its
    // issuing thread, which sees its own copy after the wait)
    if (a.vec && c_end - k0 < BK && (c_end & (VEC - 1))) {
      const int jc = (c_end - 1 - k0) / VEC * VEC;
      for (int c = tid; c < HD * NCH; c += NT)
        if ((c % NCH) * VEC == jc) {
          Raw* vt = reinterpret_cast<Raw*>(v_t) + (c / NCH) * KP;
          for (int e = c_end - k0; e < jc + VEC; ++e) vt[e] = 0;
        }
    }
    __syncthreads();

    // scores of column j = k0 + t for the thread's rows
    const int j = k0 + t;
    float acc[RR];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) acc[rr] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += 4) {
      float kv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = to_f(k_t[(d0 + e) * KP + t]);
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (rg0 + rr) * HD + d0);
        acc[rr] = __fmaf_rn(qv.x, kv[0], acc[rr]);
        acc[rr] = __fmaf_rn(qv.y, kv[1], acc[rr]);
        acc[rr] = __fmaf_rn(qv.z, kv[2], acc[rr]);
        acc[rr] = __fmaf_rn(qv.w, kv[3], acc[rr]);
      }
    }
    const float ks = QUANT ? ks_t[t] : 1.f;
    bool mask[RR];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const int row = row0 + rg0 + rr;
      mask[rr] = j < L && row < R && (long long)j <= (long long)p0 + row / r;
      float s = __fmul_rn(acc[rr], a.scale);
      if (QUANT) s = __fmul_rn(s, ks);
      acc[rr] = mask[rr] ? s : kNeg;
    }

    // row max over the tile
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      float mx = acc[rr];
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red_m[(rg0 + rr) * kWarps + warp] = mx;
    }
    __syncthreads();
    if (tid < RT) {
      float mx = red_m[tid * kWarps];
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_m[tid * kWarps + w]);
      const float m_old = m_s[tid];
      const float m_new = fmaxf(m_old, mx);
      c_s[tid] = expf(m_old - m_new);
      m_s[tid] = m_new;
    }
    __syncthreads();
    const float vsc = QUANT ? ks_t[BK + t] : 1.f;
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const float p = mask[rr] ? expf(acc[rr] - m_s[rg0 + rr]) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) red_l[(rg0 + rr) * kWarps + warp] = sum;
      float pv = p;
      if (QUANT) pv = mask[rr] ? __fmul_rn(p, vsc) : 0.f;
      if (BF16DOT) pv = round_bf16(pv);
      p_s[(rg0 + rr) * BK + t] = pv;
    }
    __syncthreads();
    if (tid < RT) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum = __fadd_rn(sum, red_l[tid * kWarps + w]);
      l_s[tid] = __fadd_rn(__fmul_rn(l_s[tid], c_s[tid]), sum);
    }
    // o = o * corr + pv . v: out column oc, positions [part*PLEN, +PLEN)
    // in one fmaf chain, the parts summed by a fixed xor tree
    float dot[RR];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) dot[rr] = 0.f;
    const C* vrow = v_t + oc * KP + part * PLEN;
    const float* prow = p_s + rg0 * BK + part * PLEN;
#pragma unroll 2
    for (int jj = 0; jj < PLEN; jj += VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(vrow + jj);
      const C* ve = reinterpret_cast<const C*>(&raw);
      float vf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[e] = to_f(ve[e]);
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
        for (int e4 = 0; e4 < VEC; e4 += 4) {
          const float4 pv =
              *reinterpret_cast<const float4*>(prow + rr * BK + jj + e4);
          dot[rr] = __fmaf_rn(pv.x, vf[e4], dot[rr]);
          dot[rr] = __fmaf_rn(pv.y, vf[e4 + 1], dot[rr]);
          dot[rr] = __fmaf_rn(pv.z, vf[e4 + 2], dot[rr]);
          dot[rr] = __fmaf_rn(pv.w, vf[e4 + 3], dot[rr]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
      for (int off = OCW; off < 32; off <<= 1)
        dot[rr] = __fadd_rn(dot[rr], __shfl_xor_sync(0xffffffffu, dot[rr], off));
      o[rr] = __fadd_rn(__fmul_rn(o[rr], c_s[rg0 + rr]), dot[rr]);
    }
    __syncthreads();
  }

  const int nh = a.nkv * r;
  auto out_at = [&](int row, int c) -> size_t {
    const int tq = row / r;
    return (((size_t)bi * a.T + tq) * nh + hh * r + (row - tq * r)) * HD + c;
  };
  if (n_live == 1) {
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const int row = row0 + rg0 + rr;
      if (part == 0 && row < R)
        a.out[out_at(row, oc)] = __fdiv_rn(o[rr], l_s[rg0 + rr]);
    }
    return;
  }
  // this split's (m, l, o), then the last of the live splits to arrive
  // merges them in split order
  constexpr int W = HD + 2;
  const size_t wrow = (size_t)bh * R;
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    const int row = row0 + rg0 + rr;
    if (part == 0 && row < R)
      a.ws[((wrow + row) * a.nsplit + split) * W + oc] = o[rr];
  }
  if (tid < RT && row0 + tid < R) {
    float* w = a.ws + ((wrow + row0 + tid) * a.nsplit + split) * W + HD;
    w[0] = m_s[tid];
    w[1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  int* cnt = a.cnt + (size_t)bh * gridDim.y + rt;
  if (tid == 0) last_s[0] = atomicAdd(cnt, 1) == n_live - 1;
  __syncthreads();
  if (!last_s[0]) return;
  __threadfence();
  for (int i = tid; i < RT * HD; i += NT) {
    const int rr = i / HD, c = i - rr * HD, row = row0 + rr;
    if (row >= R) continue;
    const float* w = a.ws + (wrow + row) * a.nsplit * W;
    float M = kNeg;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, __ldcg(w + s * W + HD));
    float l = 0.f, sum = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float e = expf(__ldcg(w + s * W + HD) - M);
      l = __fadd_rn(l, __fmul_rn(__ldcg(w + s * W + HD + 1), e));
      sum = __fadd_rn(sum, __fmul_rn(__ldcg(w + s * W + c), e));
    }
    a.out[out_at(row, c)] = __fdiv_rn(sum, l);
  }
  if (tid == 0) *cnt = 0;
}

// K6 and K9 under names of their own (a profile tells them apart)
template <typename C, int HD, int RT, bool QUANT, bool BF16DOT>
__global__ void __launch_bounds__(threads_of<RT>())
decode_kernel(const DecodeArgs a) {
  decode_body<C, HD, RT, QUANT, BF16DOT, false>(a);
}

template <typename C, int HD, int RT, bool QUANT, bool BF16DOT>
__global__ void __launch_bounds__(threads_of<RT>())
paged_decode_kernel(const DecodeArgs a) {
  decode_body<C, HD, RT, QUANT, BF16DOT, true>(a);
}

struct Scratch {
  long long ws_cap, cnt_cap;  // floats, ints
};

template <typename C, int HD, int RT, bool QUANT, bool BF16DOT, bool PAGED>
int launch(const DecodeArgs& a, const Scratch& sc, cudaStream_t s) {
  auto kern = PAGED ? paged_decode_kernel<C, HD, RT, QUANT, BF16DOT>
                    : decode_kernel<C, HD, RT, QUANT, BF16DOT>;
  const size_t smem = Plan<C, HD, RT, QUANT>::bytes +
                      (PAGED ? sizeof(int) * ((size_t)a.split_k / a.ps + 2)
                             : 0);
  if (smem > 227 * 1024) return -1;
  const int nrt = (a.R + RT - 1) / RT;
  if (a.nsplit > 1 &&
      (!a.ws || !a.cnt ||
       sc.ws_cap < (long long)a.b * a.nkv * a.R * a.nsplit * (HD + 2) ||
       sc.cnt_cap < (long long)a.b * a.nkv * nrt))
    return -3;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.b * a.nkv, nrt, a.nsplit);
  kern<<<grid, threads_of<RT>(), smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename C, int HD, bool QUANT, bool BF16DOT, bool PAGED>
int dispatch_rt(const DecodeArgs& a, const Scratch& sc, cudaStream_t s) {
  if (a.R <= 1) return launch<C, HD, 1, QUANT, BF16DOT, PAGED>(a, sc, s);
  if (a.R <= 2) return launch<C, HD, 2, QUANT, BF16DOT, PAGED>(a, sc, s);
  if (a.R <= 4) return launch<C, HD, 4, QUANT, BF16DOT, PAGED>(a, sc, s);
  if (a.R <= 8) return launch<C, HD, 8, QUANT, BF16DOT, PAGED>(a, sc, s);
  if (a.R <= 16) return launch<C, HD, 16, QUANT, BF16DOT, PAGED>(a, sc, s);
  return launch<C, HD, 32, QUANT, BF16DOT, PAGED>(a, sc, s);
}

template <typename C, bool QUANT, bool BF16DOT, bool PAGED>
int dispatch_hd(int HD, const DecodeArgs& a, const Scratch& sc,
                cudaStream_t s) {
  switch (HD) {
    case 16: return dispatch_rt<C, 16, QUANT, BF16DOT, PAGED>(a, sc, s);
    case 32: return dispatch_rt<C, 32, QUANT, BF16DOT, PAGED>(a, sc, s);
    case 64: return dispatch_rt<C, 64, QUANT, BF16DOT, PAGED>(a, sc, s);
    case 128: return dispatch_rt<C, 128, QUANT, BF16DOT, PAGED>(a, sc, s);
  }
  return -1;
}

template <bool PAGED>
int dispatch_cache(int cache_code, int HD, const DecodeArgs& a,
                   const Scratch& sc, cudaStream_t s) {
  switch (cache_code) {
    case 1: return dispatch_hd<float, false, false, PAGED>(HD, a, sc, s);
    case 2: return dispatch_hd<__nv_bfloat16, false, true, PAGED>(HD, a, sc, s);
    case 3:
      if (!a.ks || !a.vs) return -1;
      return dispatch_hd<int8_t, true, true, PAGED>(HD, a, sc, s);
  }
  return -1;
}

// K7 / K10: one launch writes up to two (destination, row) pairs of one row
// per batch row. A block is one warp, so that a decode step's scattered
// stores spread over every SM (blocks of 128 threads kept them on 32 SMs and
// ran slower).
constexpr int kRThreads = 32;

struct RowWrite {
  void* dst[2];                   // (P, H, D, ps) contiguous
  const void* src[2];             // element (bi, h, d) at
  long long sb[2], sh[2], sd[2];  //   bi*sb + h*sh + d*sd
  const int* page;                // page[bi * page_stride], clamped; null:
                                  //   the batch row bi (K7, nb == P)
  const int* off;                 // off[bi * off_stride], kept in [0, ps)
  int page_stride, off_stride;
  int nb, H, D, P, ps, n_chunks;  // n_chunks: 16-byte chunks of a row
};

template <typename E>
__global__ void __launch_bounds__(kRThreads)
write_row_kernel(RowWrite a) {
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
  int pg = a.page ? __ldg(a.page + (long long)bi * a.page_stride) : bi;
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

template <typename E>
int launch_row_write(RowWrite& a, int pairs, cudaStream_t s) {
  a.n_chunks = (a.D + 16 / (int)sizeof(E) - 1) / (16 / (int)sizeof(E));
  const long long n = (long long)a.nb * a.H * a.n_chunks;
  if (n > 0x7fffffffLL - kRThreads) return -1;
  dim3 grid((unsigned)((n + kRThreads - 1) / kRThreads), pairs);
  write_row_kernel<E><<<grid, kRThreads, 0, s>>>(a);
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

// K6 and K9, one parameter block (packed on the host in one step; a ctypes
// call's cost grows with its argument count). cache_code 1 = f32, 2 = bf16,
// 3 = int8 (ks, vs required); q_code 1 = f32, 2 = bf16, element (bi, t,
// head, d) at bi*qsb + t*qst + head*qsh + d*qsd; out (b, T, nkv * r, HD)
// f32 contiguous; pos int32, one shared value (pos_per_row 0) or b. Dense
// (paged 0): caches (b, nkv, HD, L), scales (b, nkv, L). Paged: pools (P,
// nkv, HD, ps), scale pools (P, nkv, ps), table (b, mp) int32, L = mp * ps.
// split_k: the partition's width (decode.py's SPLIT_K), a positive multiple
// of 128. With more than one split, ws holds ws_cap f32 and cnt cnt_cap int32
// counters, all zero (each launch leaves them zero); -3 when they are too
// small.
struct DecodeParams {
  uint64_t q, k, v, ks, vs, pos, out, table, ws, cnt;
  int64_t qsb, qst, qsh, qsd, ws_cap, cnt_cap;
  int32_t cache_code, q_code, b, nkv, T, r, HD, L, pos_per_row, P, ps, mp,
      split_k, paged;
  float scale;
  int32_t pad;
};
static_assert(sizeof(DecodeParams) == 192, "packed as <10Q6q14ifi");

extern "C" int rlo_decode_attend(const void* params, void* stream) {
  DecodeParams p;
  memcpy(&p, params, sizeof p);
  if (p.b <= 0 || p.nkv <= 0 || p.T <= 0 || p.r <= 0) return 0;
  if ((p.q_code != 1 && p.q_code != 2) || p.split_k <= 0 ||
      p.split_k % BK || !p.q || !p.k || !p.v || !p.pos || !p.out ||
      (long long)p.T * p.r > 0x7fffffffLL)
    return -1;
  long long L = p.L;
  if (p.paged) {
    if (p.P <= 0 || p.ps <= 0 || p.mp <= 0 || !p.table) return -1;
    L = (long long)p.mp * p.ps;
  }
  if (L <= 0 || L > 0x7fffffffLL - p.split_k) return -1;
  const long long nsplit = (L + p.split_k - 1) / p.split_k;
  if (nsplit > 65535 || (long long)p.b * p.nkv > 0x7fffffffLL) return -1;
  const int esize = p.cache_code == 1 ? 4 : (p.cache_code == 2 ? 2 : 1);
  const bool quant = p.cache_code == 3;
  // 16-byte chunks: every cache (and scale) row starts on 16 bytes
  const long long run = p.paged ? p.ps : L;
  const bool vec = (run * esize) % 16 == 0 && p.k % 16 == 0 &&
                   p.v % 16 == 0 &&
                   (!quant || (p.ks % 16 == 0 && p.vs % 16 == 0));
  auto ptr = [](uint64_t x) { return reinterpret_cast<void*>(x); };
  DecodeArgs a{ptr(p.q), p.qsb, p.qst, p.qsh, p.qsd, ptr(p.k), ptr(p.v),
               static_cast<const float*>(ptr(p.ks)),
               static_cast<const float*>(ptr(p.vs)),
               static_cast<const int*>(ptr(p.pos)),
               static_cast<float*>(ptr(p.out)),
               static_cast<float*>(ptr(p.ws)), static_cast<int*>(ptr(p.cnt)),
               static_cast<const int*>(ptr(p.table)), p.mp, p.ps, p.P,
               p.b, p.nkv, p.T * p.r, p.r, p.T, (int)L,
               p.pos_per_row ? 1 : 0, p.split_k, (int)nsplit,
               p.q_code == 2 ? 1 : 0, vec ? 1 : 0, p.scale};
  const Scratch sc{p.ws_cap, p.cnt_cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.paged ? dispatch_cache<true>(p.cache_code, p.HD, a, sc, s)
                 : dispatch_cache<false>(p.cache_code, p.HD, a, sc, s);
}

// K7 and K10: up to two (destination, row) pairs (dst1 null: one pair), one
// launch, described by one parameter block. Destination (P, H, D, ps)
// contiguous; row element (bi, h, d) at bi*sb + h*sh + d*sd elements from
// its pointer, bi < nb; row bi lands in lane off[bi * off_stride] of page
// page[bi * page_stride] (clamped into [0, P-1]) when that lane lies in
// [0, ps). K7 passes a null page: the dense cache (b, H, D, L) is P = nb
// pages whose page is the batch row, and off is pos. Returns -2 when the
// two pairs alias.
struct RowWriteParams {
  uint64_t dst0, src0, dst1, src1;
  int64_t sb0, sh0, sd0, sb1, sh1, sd1;
  uint64_t page, off;
  int32_t page_stride, off_stride, nb, H, D, P, ps, elem_size;
};
static_assert(sizeof(RowWriteParams) == 128, "packed as <4Q6q2Q8i");

extern "C" int rlo_write_kv_rows(const void* params, void* stream) {
  RowWriteParams p;
  memcpy(&p, params, sizeof p);
  if (p.nb <= 0 || p.H <= 0 || p.D <= 0) return 0;
  if (p.P <= 0 || p.ps <= 0 || !p.dst0 || !p.src0 || !p.off ||
      (!p.page && p.nb != p.P) || (!p.dst1) != (!p.src1))
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
  RowWrite a{{ptr(p.dst0), ptr(p.dst1)}, {ptr(p.src0), ptr(p.src1)},
             {p.sb0, p.sb1}, {p.sh0, p.sh1}, {p.sd0, p.sd1},
             static_cast<const int*>(ptr(p.page)),
             static_cast<const int*>(ptr(p.off)), p.page_stride, p.off_stride,
             p.nb, p.H, p.D, p.P, p.ps, 0};
  const int pairs = p.dst1 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.elem_size) {
    case 1: return launch_row_write<uint8_t>(a, pairs, s);
    case 2: return launch_row_write<uint16_t>(a, pairs, s);
    case 4: return launch_row_write<uint32_t>(a, pairs, s);
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
