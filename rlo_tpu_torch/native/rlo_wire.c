/* Wire format: one variable-size frame per message.
 *
 * Layout (little-endian, matching rlo_tpu_torch/wire.py `<iiiiiQ>`):
 *   [origin:i32][pid:i32][vote:i32][seq:i32][epoch:i32][len:u64][payload]
 * The reference's pbuf (rootless_ops.c:1369-1410) carries the same logical
 * fields but always ships a fixed 32 KB buffer (:1588); frames here are
 * exactly header + payload. `seq` is the reliable-delivery layer's
 * per-(sender, receiver) link sequence number (-1 outside the ARQ path)
 * and `epoch` is the membership layer's LINK epoch for the edge (the
 * admission epoch of its last link-state reset, 0 on the original link;
 * receivers quarantine frames below their per-sender floor —
 * docs/DESIGN.md S8). Both are link state, not application fields.
 */
#include "rlo_core.h"

#include <string.h>

static void put_i32(uint8_t *p, int32_t v)
{
    p[0] = (uint8_t)(v & 0xff);
    p[1] = (uint8_t)((v >> 8) & 0xff);
    p[2] = (uint8_t)((v >> 16) & 0xff);
    p[3] = (uint8_t)((v >> 24) & 0xff);
}

static int32_t get_i32(const uint8_t *p)
{
    return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                     ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

static void put_u64(uint8_t *p, uint64_t v)
{
    for (int i = 0; i < 8; i++)
        p[i] = (uint8_t)((v >> (8 * i)) & 0xff);
}

static uint64_t get_u64(const uint8_t *p)
{
    uint64_t v = 0;
    for (int i = 0; i < 8; i++)
        v |= (uint64_t)p[i] << (8 * i);
    return v;
}

int64_t rlo_frame_encode(uint8_t *dst, int64_t cap, int32_t origin,
                         int32_t pid, int32_t vote, int32_t seq,
                         const uint8_t *payload, int64_t len)
{
    if (len < 0 || cap < RLO_HEADER_SIZE + len)
        return RLO_ERR_ARG;
    put_i32(dst, origin);
    put_i32(dst + 4, pid);
    put_i32(dst + 8, vote);
    put_i32(dst + RLO_SEQ_OFFSET, seq);
    put_i32(dst + RLO_EPOCH_OFFSET, 0); /* stamped by the send gate */
    put_u64(dst + 20, (uint64_t)len);
    if (len > 0)
        memcpy(dst + RLO_HEADER_SIZE, payload, (size_t)len);
    return RLO_HEADER_SIZE + len;
}

int64_t rlo_frame_decode(const uint8_t *raw, int64_t rawlen, int32_t *origin,
                         int32_t *pid, int32_t *vote, int32_t *seq,
                         const uint8_t **payload)
{
    if (rawlen < RLO_HEADER_SIZE)
        return RLO_ERR_ARG;
    uint64_t n = get_u64(raw + 20);
    if ((int64_t)n > rawlen - RLO_HEADER_SIZE)
        return RLO_ERR_ARG; /* truncated frame */
    if (origin)
        *origin = get_i32(raw);
    if (pid)
        *pid = get_i32(raw + 4);
    if (vote)
        *vote = get_i32(raw + 8);
    if (seq)
        *seq = get_i32(raw + RLO_SEQ_OFFSET);
    if (payload)
        *payload = raw + RLO_HEADER_SIZE;
    return (int64_t)n;
}

int32_t rlo_frame_epoch(const uint8_t *raw)
{
    return get_i32(raw + RLO_EPOCH_OFFSET);
}

void rlo_frame_set_epoch(uint8_t *raw, int32_t epoch)
{
    put_i32(raw + RLO_EPOCH_OFFSET, epoch);
}

/* ------------------------------------------------------------------ */
/* Telemetry digest codec (docs/DESIGN.md S17) — byte-identical to    */
/* wire.py encode_telem/decode_telem; parity asserted by              */
/* tests/test_observe.py. Layout:                                     */
/*   [magic:5][flags:u8][rank:i32][epoch:i32][seq:u32][mask:u64]      */
/*   [zigzag LEB128 varint per set mask bit, ascending]               */
/* ------------------------------------------------------------------ */

/* schema key names, mask-bit order: the rlo_stats counter fields
 * (ENGINE_COUNTER_KEYS) followed by the extras — rlo-lint R2 pins
 * this table against wire.py's TELEM_KEYS literal */
static const char *const k_telem_keys[RLO_TELEM_NKEYS] = {
    "sent_bcast", "recved_bcast", "total_pickup", "ops_failed",
    "arq_retransmits", "arq_dup_drops", "arq_gave_up", "arq_unacked",
    "epoch", "epoch_quarantined", "rejoins",
    "view_changes", "reflood_frames", "epoch_lag_max",
    "quar_mid_rejoin", "quar_failed_sender", "quar_below_floor",
    "admission_rounds",
    "epoch_syncs", "reflood_skipped", "batched_admits",
    "tx_frames", "rx_frames", "rtt_ewma_max_usec",
    "q_wait", "pickup_backlog", "pages_in_use", "pages_free",
    "serve_inflight", "ttft_p50_usec", "ttft_p99_usec",
    "e2e_p50_usec", "e2e_p99_usec",
    "coll_steps", "coll_bytes",
    "remedies_proposed", "remedies_executed",
    "quarantined", "backpressure_level",
};

const char *rlo_telem_key_name(int i)
{
    if (i < 0 || i >= RLO_TELEM_NKEYS)
        return 0;
    return k_telem_keys[i];
}

static void put_u32(uint8_t *p, uint32_t v)
{
    p[0] = (uint8_t)(v & 0xff);
    p[1] = (uint8_t)((v >> 8) & 0xff);
    p[2] = (uint8_t)((v >> 16) & 0xff);
    p[3] = (uint8_t)((v >> 24) & 0xff);
}

static uint32_t get_u32(const uint8_t *p)
{
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

int64_t rlo_telem_encode(uint8_t *dst, int64_t cap, int32_t rank,
                         int32_t epoch, uint32_t seq, int full,
                         const int64_t *vals, const int64_t *prev)
{
    if (!dst || !vals || cap < RLO_TELEM_HEADER_SIZE)
        return RLO_ERR_ARG;
    if (!prev)
        full = 1;
    memcpy(dst, RLO_TELEM_MAGIC, 5);
    dst[5] = full ? 1 : 0;
    put_i32(dst + 6, rank);
    put_i32(dst + 10, epoch);
    put_u32(dst + 14, seq);
    uint64_t mask = 0;
    int64_t pos = RLO_TELEM_HEADER_SIZE;
    for (int i = 0; i < RLO_TELEM_NKEYS; i++) {
        int64_t d = vals[i] - (full ? 0 : prev[i]);
        if (!full && d == 0)
            continue;
        mask |= (uint64_t)1 << i;
        /* zigzag, then LEB128 */
        uint64_t u = ((uint64_t)d << 1) ^ (uint64_t)(d >> 63);
        do {
            if (pos >= cap)
                return RLO_ERR_TOO_BIG;
            dst[pos++] = (uint8_t)((u & 0x7f) | (u >= 0x80 ? 0x80 : 0));
            u >>= 7;
        } while (u);
    }
    put_u64(dst + 18, mask);
    return pos;
}

int64_t rlo_telem_decode(const uint8_t *raw, int64_t rawlen,
                         int32_t *rank, int32_t *epoch, uint32_t *seq,
                         int *full, int64_t *deltas, uint64_t *mask)
{
    if (!raw || rawlen < RLO_TELEM_HEADER_SIZE ||
        memcmp(raw, RLO_TELEM_MAGIC, 5) != 0)
        return RLO_ERR_ARG;
    uint64_t m = get_u64(raw + 18);
    if (RLO_TELEM_NKEYS < 64 && (m >> RLO_TELEM_NKEYS))
        return RLO_ERR_ARG; /* mask bits beyond the schema */
    if (rank)
        *rank = get_i32(raw + 6);
    if (epoch)
        *epoch = get_i32(raw + 10);
    if (seq)
        *seq = get_u32(raw + 14);
    if (full)
        *full = raw[5] & 1;
    if (mask)
        *mask = m;
    int64_t pos = RLO_TELEM_HEADER_SIZE;
    for (int i = 0; i < RLO_TELEM_NKEYS; i++) {
        if (!(m & ((uint64_t)1 << i)))
            continue;
        uint64_t u = 0;
        int shift = 0;
        for (;;) {
            if (pos >= rawlen || shift > 63)
                return RLO_ERR_ARG; /* truncated/overlong varint */
            uint8_t b = raw[pos++];
            u |= (uint64_t)(b & 0x7f) << shift;
            shift += 7;
            if (!(b & 0x80))
                break;
        }
        if (deltas)
            deltas[i] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
    }
    return pos;
}

/* ------------------------------------------------------------------ */
/* Span context codec (docs/DESIGN.md S19) — byte-identical to        */
/* wire.py encode_span_ctx/decode_span_ctx; parity asserted by        */
/* tests/test_spans.py. Layout:                                       */
/*   [magic:5][flags:u8][stage:u8][gateway:i32][seq:i32][t_usec:u64]  */
/* ------------------------------------------------------------------ */

int64_t rlo_span_encode(uint8_t *dst, int64_t cap, int32_t gateway,
                        int32_t seq, int stage, int flags,
                        uint64_t t_usec)
{
    if (!dst || cap < RLO_SPAN_CTX_SIZE)
        return RLO_ERR_ARG;
    memcpy(dst, RLO_SPAN_MAGIC, 5);
    dst[5] = (uint8_t)(flags & 0xff);
    dst[6] = (uint8_t)(stage & 0xff);
    put_i32(dst + 7, gateway);
    put_i32(dst + 11, seq & 0x7fffffff);
    put_u64(dst + 15, t_usec);
    return RLO_SPAN_CTX_SIZE;
}

int64_t rlo_span_decode(const uint8_t *raw, int64_t rawlen,
                        int32_t *gateway, int32_t *seq, int *stage,
                        int *flags, uint64_t *t_usec)
{
    if (!raw || rawlen < RLO_SPAN_CTX_SIZE ||
        memcmp(raw, RLO_SPAN_MAGIC, 5) != 0)
        return RLO_ERR_ARG;
    if (flags)
        *flags = raw[5];
    if (stage)
        *stage = raw[6];
    if (gateway)
        *gateway = get_i32(raw + 7);
    if (seq)
        *seq = get_i32(raw + 11);
    if (t_usec)
        *t_usec = get_u64(raw + 15);
    return RLO_SPAN_CTX_SIZE;
}
