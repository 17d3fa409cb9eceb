/* Progress engine: cooperatively-polled state machine driving the rootless
 * broadcast and IAR leaderless-consensus ops.
 *
 * Native counterpart of rlo_tpu_torch/engine.py; both mirror the reference
 * (struct progress_engine rootless_ops.c:202-253, make_progress_gen :551,
 * RLO_bcast_gen :1581, _bc_forward :1104, IAR handlers :668-932, pickup
 * :938-992) with the deliberate departures listed in rlo_core.h.
 */
/* for clock_gettime(CLOCK_MONOTONIC) under -std=c11 (the profiler
 * clock, now_usec_f) — must precede every system header */
#define _POSIX_C_SOURCE 199309L

#include "rlo_internal.h"

#include <stdio.h>
#include <time.h>

/* depth of the recent-broadcast ring log re-flooded on view changes */
#define RLO_RECENT_LOG 64
/* settled consensus rounds remembered for decision dedup */
#define RLO_SETTLED_LOG 256
/* per-origin out-of-order dedup window (bits above the contiguous
 * watermark); reordering beyond this collapses to at-most-once */
#define RLO_SEEN_BITS 256
#define RLO_SEEN_WORDS (RLO_SEEN_BITS / 64)

/* ---------------- intrusive message queue (reference queue_append/
 * queue_remove, rootless_ops.c:345-404) ---------------- */

typedef struct rlo_msg rlo_msg;

typedef struct rlo_queue {
    rlo_msg *head, *tail;
    int len;
} rlo_queue;

/* ---------------- per-proposal consensus bookkeeping (reference
 * Proposal_state, rootless_ops.c:184-194) ---------------- */

typedef struct rlo_prop {
    int pid;
    int gen;       /* round generation (disambiguates pid reuse) */
    int recv_from; /* parent in the vote tree */
    int vote;
    int votes_needed, votes_recved;
    int state; /* enum rlo_state */
    uint8_t *payload;
    int64_t len;
    rlo_handle **decision_handles;
    int n_decision;
    int decision_pending;
    /* direct children whose votes are outstanding — lets the failure
     * detector discount a dead child (mirror of ProposalState.await_from
     * in rlo_tpu_torch/engine.py) */
    int await_from[64];
    int n_await;
    /* additional vote-tree parents acquired from duplicate proposals
     * (re-formed overlay trees); they receive the SAME merged vote as
     * recv_from when the round resolves — an interim verdict could
     * lose a subtree veto still in flight (round-2 advisor finding).
     * Mirror of ProposalState.dup_parents/resolved in engine.py. */
    int dup_parents[8];
    int n_dup;
    int resolved; /* merged vote determined and sent up */
} rlo_prop;

/* ---------------- ARQ retransmit entry (net-new; mirror of the Python
 * engine's _ArqEntry — the reference has no loss recovery at all,
 * SURVEY.md §5) ---------------- */

typedef struct rlo_rtx {
    /* main queue: doubly-linked, insertion (newest-first) order — the
     * retransmit SWEEP walks this list, so its walk order is exactly
     * the historical one */
    struct rlo_rtx *next, *prev;
    /* per-destination chain: cumulative ACKs from one peer touch only
     * that peer's entries (the ack scan was O(all unacked) before) */
    struct rlo_rtx *dnext, *dprev;
    int dst, tag, retries;
    int32_t seq;
    uint64_t due;  /* next retransmit time (usec) */
    uint64_t sent; /* first-transmission time (RTT sampling) */
    rlo_blob *frame;
    /* zero-copy large-payload entry (docs/DESIGN.md S13): frame is a
     * ref on the SHARED unstamped fan-out blob and hdr[] carries the
     * per-edge stamped header — sends and retransmits go through
     * rlo_world_isend_hdr, so the payload is never copied into a
     * per-frame arena. split == 0 entries own a stamped private
     * clone (the historical small-frame path, kept byte for byte). */
    int split;
    uint8_t hdr[RLO_HEADER_SIZE];
} rlo_rtx;

/* ---------------- in-flight message (reference RLO_msg_t,
 * rootless_ops.h:93-146) ---------------- */

struct rlo_msg {
    rlo_msg *prev, *next;
    int tag, src; /* src = immediate sender (~MPI_SOURCE) */
    int32_t origin, pid, vote, seq;
    rlo_blob *frame;        /* the encoded frame (owned ref) */
    const uint8_t *payload; /* aliases frame->data past the header */
    int64_t len;
    rlo_handle **handles;
    int n_handles, cap_handles;
    int pickup_done, fwd_done;
    rlo_prop *ps; /* for relayed IAR proposals */
    /* metrics stamps (0 = metrics were off at the event): initiation
     * time of a locally-initiated bcast and receipt time of a
     * deliverable message (mirror of _Msg.born/arrived in engine.py) */
    uint64_t born, arrived;
    /* profiler stamps (0 = profiler off at init, docs/DESIGN.md S10):
     * bcast init time for the first-forward/all-delivered phase
     * timers, and whether the first fan-out completion was observed
     * (mirror of _Msg.p_born/first_fwd in engine.py) */
    double p_born;
    int first_fwd;
};

struct rlo_engine {
    rlo_world *w;
    int rank, ws, comm;
    int64_t msg_size_max;
    rlo_judge_cb judge;
    void *judge_ctx;
    rlo_action_cb action;
    void *action_ctx;
    int my_level;
    int init_targets[64];
    int n_init;
    int fanout; /* RLO_FANOUT_* — bcast/IAR spanning-tree shape */
    rlo_queue q_wait, q_wait_pickup, q_pickup, q_iar_pending;
    int64_t sent_bcast, recved_bcast, total_pickup;
    rlo_prop own; /* my_own_proposal; own.payload = my proposal bytes */
    int err; /* sticky first protocol error */
    rlo_msg *peeked; /* message exposed by rlo_pickup_peek, not consumed */
    /* failure detection + elastic recovery (0 timeout = disabled;
     * mirror of the Python engine's failure_timeout machinery) */
    uint64_t fd_timeout, fd_interval;
    int gen_counter; /* per-engine round counter (see submit_proposal) */
    uint64_t hb_last_sent;
    uint64_t *hb_seen;  /* per rank: last heartbeat usec (0 = unseen) */
    uint8_t *failed;    /* per rank */
    int n_failed;
    int suspected_self;
    /* exactly-once broadcast (mirror of engine.py's _bcast_seq /
     * _seen_bcast / _recent_bcasts): every initiated BCAST frame is
     * stamped with a per-origin sequence number in the vote field;
     * receivers dedup on (origin, seq) before forwarding or
     * delivering, and on every adopted view change survivors re-flood
     * their recent-frame log point-to-point so a dead relay's
     * forwarding holes are plugged (dedup absorbs the duplication) */
    int32_t bcast_seq;
    int64_t *seen_contig;   /* per origin: all seqs <= contig seen */
    uint64_t *seen_mask;    /* per origin: 256-bit window above contig */
    rlo_blob *recent[RLO_RECENT_LOG];
    int recent_tag[RLO_RECENT_LOG]; /* BCAST or IAR_DECISION per entry */
    int recent_pos;
    /* settled consensus rounds (decision dedup across view changes) */
    struct { int32_t pid, gen; int used; } settled[RLO_SETTLED_LOG];
    int settled_pos;
    /* reliable delivery (ARQ; mirror of engine.py's arq_rto machinery,
     * net-new): per-dst link seq counters, a retransmit queue of
     * unacked frames, per-src receive dedup windows, and the per-src
     * "owes an ACK" flags flushed once per progress turn */
    uint64_t arq_rto; /* 0 = disabled */
    int arq_max_retries;
    int32_t *tx_seq;      /* per dst: next link seq */
    rlo_rtx *rtx_head;    /* unacked reliable frames (sweep order) */
    rlo_rtx **rtx_by_dst; /* per dst: that peer's chain (ack scans) */
    int64_t *rx_contig;   /* per src: all link seqs <= contig seen */
    uint64_t *rx_mask;    /* per src: window above contig */
    uint8_t *ack_due;     /* per src: cumulative ACK owed */
    /* per dst: highest given-up seq pending a SKIP notice (-1 none) +
     * its next-send time, and a per-tick scratch flag (see arq_tick) */
    int32_t *tx_skip;
    uint64_t *tx_skip_due;
    uint8_t *skip_hold;
    int64_t arq_retx, arq_dup, arq_gaveup, arq_unacked_cnt;
    /* lazy due-heap gating the retransmit sweep (docs/DESIGN.md S13;
     * C analogue of engine.py's _arq_due from PR 7): a binary
     * min-heap of wake-up times — one push per reliable send, per
     * retransmit re-arm, and per armed skip notice. Entries are PLAIN
     * DEADLINES (no identity): an acked frame's entry goes stale and
     * costs one empty sweep when it expires, which is what keeps the
     * hot path O(1) — arq_tick returns on a single heap peek while
     * the earliest deadline is in the future. INVARIANT: every live
     * retransmit entry and every armed skip notice has a heap entry
     * at or before its deadline, so the gate can never sleep past
     * real work. The sweep itself still walks the queue in insertion
     * order — wake-ups come from the heap, the walk order does not. */
    uint64_t *arq_heap;
    int arq_heap_len, arq_heap_cap;
    /* a wake-up was lost to a failed heap grow: the gate would sleep
     * past it, so sweeps run ungated until the queue fully drains and
     * the gate can re-arm from a clean slate */
    int arq_gate_degraded;
    int64_t arq_gated; /* sweeps skipped on the O(1) heap peek */
    /* lifetime frames polled off the transport (batched-progress
     * budget accounting; every polled frame counts, ACKs included) */
    int64_t frames_dispatched;
    /* metrics registry (mirror of engine.py's _mx_* machinery; see
     * rlo_core.h rlo_stats): per-peer link accounting + op-latency
     * histograms, collected only while metrics_on (one branch per
     * send/receive when off — the overhead contract) */
    int metrics_on;
    rlo_link_stats *links; /* ws entries; links[rank] stays zero */
    rlo_hist h_bcast, h_prop, h_pickup;
    uint64_t prop_born;
    /* in-engine phase profiler (docs/DESIGN.md S10; mirror of
     * engine.py's _prof_on/_ph machinery): per-stage log2 duration
     * histograms, collected only while profiler_on — one branch per
     * instrumented site when off (the overhead contract) */
    int profiler_on;
    rlo_phase_stats ph;
    double p_prop_born; /* submit stamp for the proposal phases (0=off) */
    /* membership-round watchdog: app op deadlines are Python-side,
     * but the ENGINE-initiated admission rounds need one here — a
     * round straddling a view change can park into a cyclic vote
     * tree (mixed old/new overlays) that never resolves, wedging the
     * own-proposal slot forever. 0 = unarmed. */
    uint64_t own_deadline;
    /* membership epochs + elastic rejoin (docs/DESIGN.md S8; mirror of
     * the Python engine's incarnation/epoch/JOIN machinery) */
    int32_t epoch;          /* monotone membership view counter */
    int64_t quarantined;    /* frames dropped by the epoch quarantine */
    int64_t rejoins_cnt;    /* admissions executed/adopted here */
    /* heal-cost counters (docs/DESIGN.md S17; mirror of engine.py's
     * view_changes/reflood_frames/... block — rlo-lint R2 pins the
     * rlo_stats schema): always-live plain counters */
    int64_t view_changes;   /* membership-view rebinds */
    int64_t reflood_frames; /* frames re-sent by the view-change flood */
    int64_t epoch_lag_max;  /* max(my epoch - accepted frame epoch) */
    int64_t quar_mid_rejoin, quar_failed_sender, quar_below_floor;
    int64_t admission_rounds; /* IAR admission rounds launched here */
    int64_t epoch_syncs;      /* MSYNC view adoptions (no full rejoin) */
    int64_t reflood_skipped;  /* advertised log entries already held */
    int64_t batched_admits;   /* joiners admitted in multi-joiner rounds */
    /* telemetry digest origination state (rlo_engine_telem_digest):
     * last-emitted sample (the delta base) + per-engine digest seq */
    int64_t telem_prev[RLO_TELEM_NKEYS];
    uint32_t telem_seq;
    int incarnation;        /* this engine's life at its rank */
    int awaiting_welcome;   /* joiner mode: quarantine + petition */
    int32_t welcome_epoch;  /* epoch of the last ADOPTED welcome */
    uint64_t join_last;     /* last JOIN probe burst (usec) */
    uint64_t join_interval; /* probe cadence (usec; 0 = default) */
    int32_t *epoch_floor;   /* per sender: min accepted link epoch
                             * (0 = no floor; floors are >= 1) */
    int32_t *link_epoch;    /* per dst: epoch of the edge's last
                             * link-state reset (the wire stamp) */
    int32_t *admit_epoch;   /* per joiner: highest admission epoch
                             * EXECUTED here (idempotence guard) */
    int32_t *admitted_inc;  /* per joiner: admitted incarnation (-1) */
    uint8_t *admitting;     /* joiners with an admission in flight */
    uint8_t *pending_join;  /* queued petitions awaiting the slot */
    int32_t *pending_inc;   /* petition incarnation per joiner */
    int32_t *pending_ep;    /* petition epoch per joiner */
    uint8_t *sub_excluded;  /* never probed/admitted (engine_new_sub) */
    uint8_t *gave_scratch;  /* per dst: ARQ give-up escalation flags */
    uint64_t *stale_probe_last; /* per src: last stale-sender nack */
    /* membership healing (docs/DESIGN.md S18): per member the CERTIFIED
     * link-reset epoch — set only when an admission executes HERE, so it
     * can seed third-party floors during MSYNC catch-up (the wholesale
     * welcome adoption cannot: it inflates admit_epoch for members whose
     * links were never reset) — plus the per-dst MSYNC request limiter */
    int32_t *reset_epoch;
    uint64_t *sync_req_last;
    int n_pending;          /* pending_join population */
    int n_excluded;         /* sub_excluded population */
};

/* Membership admission rounds live in the reserved pid namespace
 * pid <= RLO_MEMBER_PID_BASE (app pids are >= -1); pid =
 * BASE - (joiner * ws + proposer) keeps concurrent admissions of one
 * joiner by different proposers on distinct pids (a BATCHED round uses
 * the first joiner's pid). Record v2 (docs/DESIGN.md S18) admits k
 * queued joiners in ONE round: payload =
 * MAGIC + [new_epoch:i32][k:i32] + k x ([joiner:i32][incarnation:i32]).
 * Byte-identical to engine.py's MEMBER_MAGIC record. */
#define RLO_MEMBER_PID_BASE (-2)
#define RLO_MEMBER_MAGIC_LEN 5
static const uint8_t RLO_MEMBER_MAGIC[RLO_MEMBER_MAGIC_LEN] = {
    'R', 'L', 'O', 'J', 2};

/* MSYNC payload kind byte (first payload octet; mirrors engine.py's
 * MSYNC_REQ/RSP/AD/WANT constants — docs/DESIGN.md S18) */
#define RLO_MSYNC_REQ 0  /* <B><ii> requester epoch, incarnation */
#define RLO_MSYNC_RSP 1  /* <B><ii> epoch, n + n x <iii> + advert tail */
#define RLO_MSYNC_AD 2   /* <B><i> count + count x <iii> log idents */
#define RLO_MSYNC_WANT 3 /* <B><i> count + count x <iii> wanted idents */

static int32_t get_le32(const uint8_t *p)
{
    return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                     ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

/* Decode a batched admission record (see RLO_MEMBER_MAGIC above):
 * returns k >= 1 with *new_epoch set and *recs pointing at the
 * k x [joiner:i32][inc:i32] body, or 0 on malformed/foreign payloads
 * (mirror of engine.py _member_decode). */
static int member_decode(const uint8_t *payload, int64_t len,
                         int32_t *new_epoch, const uint8_t **recs)
{
    if (!payload || len < RLO_MEMBER_MAGIC_LEN + 8 ||
        memcmp(payload, RLO_MEMBER_MAGIC, RLO_MEMBER_MAGIC_LEN))
        return 0;
    int k = get_le32(payload + RLO_MEMBER_MAGIC_LEN + 4);
    if (k < 1 || len < RLO_MEMBER_MAGIC_LEN + 8 + 8 * (int64_t)k)
        return 0;
    *new_epoch = get_le32(payload + RLO_MEMBER_MAGIC_LEN);
    *recs = payload + RLO_MEMBER_MAGIC_LEN + 8;
    return k;
}

/* ---------------- metrics helpers ---------------- */

static void hist_obs(rlo_hist *h, double v)
{
    int64_t iv = v <= 0 ? 0 : (int64_t)v;
    int b = 0;
    while (iv >> b)
        b++; /* bit_length */
    if (b > RLO_HIST_BUCKETS - 1)
        b = RLO_HIST_BUCKETS - 1;
    if (h->count == 0) {
        h->min = v;
        h->max = v;
    } else {
        if (v < h->min)
            h->min = v;
        if (v > h->max)
            h->max = v;
    }
    h->count++;
    h->sum += v;
    h->buckets[b]++;
}

/* ---------------- phase profiler (docs/DESIGN.md S10) ---------------- */

/* field indices into rlo_phase_stats — the ENGINE_PHASE_KEYS snapshot
 * order shared with the Python engine (and the Ev.PHASE a field) */
enum {
    RLO_PH_FRAME_ENCODE = 0,
    RLO_PH_FRAME_DECODE,
    RLO_PH_SEND,
    RLO_PH_ARQ_SCAN,
    RLO_PH_TAG_DISPATCH,
    RLO_PH_PICKUP_DRAIN,
    RLO_PH_BCAST_FIRST_FWD,
    RLO_PH_BCAST_ALL_DELIVERED,
    RLO_PH_PROP_VOTES_AGGREGATED,
    RLO_PH_PROP_DECISION,
};

/* profiler clock: monotonic, sub-usec resolution as double usec —
 * rlo_now_usec's 1 usec granularity would round most hot-path stages
 * (a header pack, one isend into an in-process ring) to zero */
static double now_usec_f(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec * 1e6 + (double)ts.tv_nsec / 1e3;
}

/* Record one stage sample: duration since t0 into the phase histogram
 * (rlo_phase_stats is 10 contiguous rlo_hist fields, so indexing off
 * the first is well-defined), plus an RLO_EV_PHASE trace event when
 * the tracer is live. Callers gate on profiler_on — this is never
 * reached on the disabled path. */
static void ph_obs(rlo_engine *e, int idx, double t0)
{
    double dur = now_usec_f() - t0;
    hist_obs((rlo_hist *)&e->ph + idx, dur);
    if (rlo_trace_enabled())
        rlo_trace_emit(e->rank, RLO_EV_PHASE, idx,
                       dur >= 2147483647.0 ? 2147483647
                                           : (int)(dur < 0 ? 0 : dur),
                       0, 0);
}

static void rtt_sample(rlo_link_stats *ls, double usec)
{
    if (usec < 1.0)
        /* below clock resolution; clamp so a real sample can never
         * collide with the 0.0 "unmeasured" sentinel */
        usec = 1.0;
    if (ls->rtt_ewma_usec == 0.0)
        ls->rtt_ewma_usec = usec;
    else
        ls->rtt_ewma_usec += (usec - ls->rtt_ewma_usec) / 8.0;
}

/* correlation identity a trace event carries in its c field: the
 * per-origin exactly-once seq for BCAST frames (it travels in the
 * vote field), the pid for everything else */
static int32_t trace_ident(int tag, int32_t pid, int32_t vote)
{
    return tag == RLO_TAG_BCAST ? vote : pid;
}

/* ---------------- queue ops ---------------- */

/* rlo-sentinel: transfers(m) — the queue owns it until retired */
static void q_append(rlo_queue *q, rlo_msg *m)
{
    m->next = 0;
    m->prev = q->tail;
    if (q->tail)
        q->tail->next = m;
    else
        q->head = m;
    q->tail = m;
    q->len++;
}

static void q_remove(rlo_queue *q, rlo_msg *m)
{
    if (m->prev)
        m->prev->next = m->next;
    else
        q->head = m->next;
    if (m->next)
        m->next->prev = m->prev;
    else
        q->tail = m->prev;
    m->prev = m->next = 0;
    q->len--;
}

/* ---------------- msg lifecycle ---------------- */

/* Encode one frame into a fresh blob (the single copy a send makes;
 * every fan-out edge then shares it by ref; the ARQ path clones and
 * re-stamps per edge). */
static rlo_blob *frame_blob(rlo_world *w, int32_t origin, int32_t pid,
                            int32_t vote, const uint8_t *payload,
                            int64_t len)
{
    rlo_blob *b = rlo_blob_new_w(w, RLO_HEADER_SIZE + len);
    if (!b)
        return 0;
    if (rlo_frame_encode(b->data, b->len, origin, pid, vote, -1, payload,
                         len) < 0) {
        rlo_blob_unref(b);
        return 0;
    }
    return b;
}

/* Wrap a received or freshly-encoded frame blob into a message; STEALS
 * the caller's blob ref (unrefs it on failure, storing RLO_ERR_PROTO or
 * RLO_ERR_NOMEM in *err so callers report the true cause). */
/* rlo-sentinel: owns — returns a caller-owned message */
static rlo_msg *msg_from_frame(rlo_world *w, int tag, int src,
                               rlo_blob *frame, int *err)
{
    int32_t origin, pid, vote, seq;
    const uint8_t *payload;
    int64_t plen = rlo_frame_decode(frame->data, frame->len, &origin,
                                    &pid, &vote, &seq, &payload);
    if (plen < 0) {
        if (err)
            *err = RLO_ERR_PROTO;
        rlo_blob_unref(frame);
        return 0;
    }
    rlo_msg *m = (rlo_msg *)rlo_pool_alloc(w, sizeof(*m));
    if (m)
        memset(m, 0, sizeof(*m));
    if (!m) {
        if (err)
            *err = RLO_ERR_NOMEM;
        rlo_blob_unref(frame);
        return 0;
    }
    m->tag = tag;
    m->src = src;
    m->origin = origin;
    m->pid = pid;
    m->vote = vote;
    m->seq = seq;
    m->frame = frame;
    m->payload = payload;
    m->len = plen;
    return m;
}

/* rlo-sentinel: transfers(p) */
static void prop_free(rlo_prop *p)
{
    if (!p)
        return;
    for (int i = 0; i < p->n_decision; i++)
        rlo_handle_unref(p->decision_handles[i]);
    free(p->decision_handles);
    free(p->payload);
    free(p);
}

/* rlo-sentinel: transfers(m) */
static void msg_free(rlo_msg *m)
{
    if (!m)
        return;
    for (int i = 0; i < m->n_handles; i++)
        rlo_handle_unref(m->handles[i]);
    free(m->handles);
    rlo_blob_unref(m->frame);
    prop_free(m->ps);
    rlo_pool_free(m);
}

static int msg_track(rlo_msg *m, rlo_handle *h)
{
    if (m->n_handles == m->cap_handles) {
        int cap = m->cap_handles ? m->cap_handles * 2 : 4;
        rlo_handle **p = (rlo_handle **)realloc(
            m->handles, (size_t)cap * sizeof(void *));
        if (!p)
            return RLO_ERR_NOMEM;
        m->handles = p;
        m->cap_handles = cap;
    }
    m->handles[m->n_handles++] = h;
    return RLO_OK;
}

static int msg_sends_done(const rlo_msg *m)
{
    for (int i = 0; i < m->n_handles; i++)
        if (!m->handles[i]->delivered)
            return 0;
    return 1;
}

/* Any fan-out send completed (the profiler's first-forward phase
 * anchor); zero handles counts as none. */
static int msg_any_send_done(const rlo_msg *m)
{
    for (int i = 0; i < m->n_handles; i++)
        if (m->handles[i]->delivered)
            return 1;
    return 0;
}

/* ---------------- send helper ---------------- */

static void put_le32(uint8_t *dst, int v)
{
    dst[0] = (uint8_t)(v & 0xff);
    dst[1] = (uint8_t)((v >> 8) & 0xff);
    dst[2] = (uint8_t)((v >> 16) & 0xff);
    dst[3] = (uint8_t)((v >> 24) & 0xff);
}

static void arq_heap_push(rlo_engine *e, uint64_t due);

/* rlo-sentinel: transfers(rt) — the retransmit queue owns it */
static void rtx_link(rlo_engine *e, rlo_rtx *rt)
{
    rt->prev = 0;
    rt->next = e->rtx_head;
    if (e->rtx_head)
        e->rtx_head->prev = rt;
    e->rtx_head = rt;
    rt->dprev = 0;
    rt->dnext = e->rtx_by_dst[rt->dst];
    if (rt->dnext)
        rt->dnext->dprev = rt;
    e->rtx_by_dst[rt->dst] = rt;
    e->arq_unacked_cnt++;
}

/* Unlink from both lists and release; O(1). */
static void rtx_release(rlo_engine *e, rlo_rtx *rt)
{
    if (rt->prev)
        rt->prev->next = rt->next;
    else
        e->rtx_head = rt->next;
    if (rt->next)
        rt->next->prev = rt->prev;
    if (rt->dprev)
        rt->dprev->dnext = rt->dnext;
    else
        e->rtx_by_dst[rt->dst] = rt->dnext;
    if (rt->dnext)
        rt->dnext->dprev = rt->dprev;
    rlo_blob_unref(rt->frame);
    rlo_pool_free(rt);
    e->arq_unacked_cnt--;
}

/* Tags the ARQ layer neither stamps nor retransmits: heartbeats are
 * periodic by construction, and ACKs ack themselves by effect (a lost
 * ACK just costs one more retransmit, absorbed by the dedup). JOIN
 * probes repeat at their own cadence until answered, and a lost
 * WELCOME is replaced when the next probe arrives — both must also
 * work across the membership boundary where link state is reset. */
static int arq_exempt(int tag)
{
    return tag == RLO_TAG_HEARTBEAT || tag == RLO_TAG_ACK ||
           tag == RLO_TAG_JOIN || tag == RLO_TAG_JOIN_WELCOME ||
           tag == RLO_TAG_MSYNC;
}

/* isend one already-encoded frame blob; when track_in != NULL the
 * completion handle is retained on that message (votes pass NULL — fire
 * and forget; with ARQ enabled they are ALSO reliable: a dropped vote
 * retransmits until acked instead of wedging the consensus round).
 *
 * This is the one gate every engine frame leaves through: with ARQ on,
 * non-exempt frames are cloned, stamped with the next per-(src, dst)
 * link seq (the shared fan-out blob must not be mutated — each edge
 * carries a different seq), queued for retransmission, and only then
 * handed to the transport. */
/* rlo_world_isend with the profiler's send-stage timer (one branch on
 * the disabled path — the S10 overhead contract). */
static int isend_timed(rlo_engine *e, int dst, int tag, rlo_blob *frame,
                       rlo_handle **h)
{
    if (!e->profiler_on)
        return rlo_world_isend(e->w, e->rank, dst, e->comm, tag, frame,
                               h);
    double t0 = now_usec_f();
    int rc = rlo_world_isend(e->w, e->rank, dst, e->comm, tag, frame,
                             h);
    ph_obs(e, RLO_PH_SEND, t0);
    return rc;
}

/* Gather-send twin of isend_timed for the zero-copy ARQ path: the
 * stamped header travels as caller staging, the payload stays in the
 * shared fan-out blob (rlo_world_isend_hdr materializes a contiguous
 * copy only on transports without scatter-gather). */
static int isend_hdr_timed(rlo_engine *e, int dst, int tag,
                           const uint8_t *hdr, rlo_blob *frame,
                           rlo_handle **h)
{
    if (!e->profiler_on)
        return rlo_world_isend_hdr(e->w, e->rank, dst, e->comm, tag,
                                   hdr, frame, h);
    double t0 = now_usec_f();
    int rc = rlo_world_isend_hdr(e->w, e->rank, dst, e->comm, tag, hdr,
                                 frame, h);
    ph_obs(e, RLO_PH_SEND, t0);
    return rc;
}

static int eng_isend_frame(rlo_engine *e, int dst, int tag,
                           rlo_blob *frame, rlo_msg *track_in)
{
    rlo_handle *h = 0;
    int rc;
    if (e->metrics_on && dst >= 0 && dst < e->ws) {
        e->links[dst].tx_frames++;
        e->links[dst].tx_bytes += frame->len;
    }
    if (e->arq_rto && !arq_exempt(tag) && dst >= 0 && dst < e->ws) {
        rlo_rtx *rt = (rlo_rtx *)rlo_pool_alloc(e->w, sizeof(*rt));
        if (!rt)
            return RLO_ERR_NOMEM;
        memset(rt, 0, sizeof(*rt));
        /* large payloads take the zero-copy path (docs/DESIGN.md
         * S13): the per-edge seq/epoch is stamped into a 28-byte
         * header staging inside the retransmit entry and the SHARED
         * fan-out blob is ref'd as-is — no payload clone per edge.
         * Small frames keep the historical clone-and-stamp path.
         * Retransmits resend the same bytes either way. */
        int split = frame->len >= RLO_HEADER_SIZE + RLO_ZC_MIN_PAYLOAD;
        rlo_blob *stamped = 0;
        if (!split) {
            stamped = rlo_blob_new_w(e->w, frame->len);
            if (!stamped) {
                rlo_pool_free(rt);
                return RLO_ERR_NOMEM;
            }
            memcpy(stamped->data, frame->data, (size_t)frame->len);
        } else {
            memcpy(rt->hdr, frame->data, RLO_HEADER_SIZE);
        }
        uint8_t *stamp = split ? rt->hdr : stamped->data;
        int32_t seq = e->tx_seq[dst]++;
        put_le32(stamp + RLO_SEQ_OFFSET, seq);
        rlo_frame_set_epoch(stamp, e->link_epoch[dst]);
        rt->split = split;
        rt->dst = dst;
        rt->tag = tag;
        rt->seq = seq;
        rt->sent = rlo_now_usec();
        rt->due = rt->sent + e->arq_rto;
        rt->frame = rlo_blob_ref(split ? frame : stamped);
        rtx_link(e, rt);
        arq_heap_push(e, rt->due);
        rc = split ? isend_hdr_timed(e, dst, tag, rt->hdr, frame,
                                     track_in ? &h : 0)
                   : isend_timed(e, dst, tag, stamped,
                                 track_in ? &h : 0);
        rlo_blob_unref(stamped); /* NULL-safe on the split path */
    } else {
        /* link-epoch stamp (docs/DESIGN.md S8): the fan-out blob is
         * SHARED across edges and (zero-copy) with in-process
         * receivers, so when the edge's link epoch differs from what
         * the blob carries, stamp a private copy — with all link
         * epochs at 0 (no membership churn) this never copies */
        int32_t lep = (dst >= 0 && dst < e->ws) ? e->link_epoch[dst]
                                                : 0;
        if (frame->len >= RLO_HEADER_SIZE &&
            rlo_frame_epoch(frame->data) != lep) {
            rlo_blob *st = rlo_blob_new_w(e->w, frame->len);
            if (!st)
                return RLO_ERR_NOMEM;
            memcpy(st->data, frame->data, (size_t)frame->len);
            rlo_frame_set_epoch(st->data, lep);
            rc = isend_timed(e, dst, tag, st, track_in ? &h : 0);
            rlo_blob_unref(st);
        } else {
            rc = isend_timed(e, dst, tag, frame, track_in ? &h : 0);
        }
    }
    if (rc == RLO_OK && track_in)
        rc = msg_track(track_in, h);
    return rc;
}

/* Encode + send a one-off frame (votes). */
static int eng_isend(rlo_engine *e, int dst, int tag, int32_t origin,
                     int32_t pid, int32_t vote, const uint8_t *payload,
                     int64_t len, rlo_msg *track_in)
{
    rlo_blob *frame;
    if (e->profiler_on) {
        double t0 = now_usec_f();
        frame = frame_blob(e->w, origin, pid, vote, payload, len);
        ph_obs(e, RLO_PH_FRAME_ENCODE, t0);
    } else {
        frame = frame_blob(e->w, origin, pid, vote, payload, len);
    }
    if (!frame)
        return RLO_ERR_NOMEM;
    int rc = eng_isend_frame(e, dst, tag, frame, track_in);
    rlo_blob_unref(frame);
    return rc;
}

/* ---------------- engine create/free ---------------- */

rlo_engine *rlo_engine_new(rlo_world *w, int rank, int comm,
                           rlo_judge_cb judge, void *judge_ctx,
                           rlo_action_cb action, void *action_ctx,
                           int64_t msg_size_max)
{
    if (!w || rank < 0 || rank >= rlo_world_size(w))
        return 0;
    /* one-process-per-rank transports (shm/mpi) bind the world to a rank */
    if (rlo_world_my_rank(w) >= 0 && rank != rlo_world_my_rank(w))
        return 0;
    rlo_engine *e = (rlo_engine *)calloc(1, sizeof(*e));
    if (!e)
        return 0;
    e->w = w;
    e->rank = rank;
    e->ws = rlo_world_size(w);
    e->comm = comm;
    e->judge = judge;
    e->judge_ctx = judge_ctx;
    e->action = action;
    e->action_ctx = action_ctx;
    e->msg_size_max = msg_size_max > 0 ? msg_size_max : RLO_MSG_SIZE_MAX;
    e->my_level = rlo_level(e->ws, rank);
    e->n_init = rlo_initiator_targets(e->ws, rank, e->init_targets, 64);
    /* runtime schedule switch (net-new config surface, SURVEY.md §5):
     * RLO_FANOUT=flat makes every engine depth-1; the per-engine
     * setter overrides */
    {
        const char *fo = getenv("RLO_FANOUT");
        e->fanout = (fo && !strcmp(fo, "flat")) ? RLO_FANOUT_FLAT
                                                : RLO_FANOUT_SKIP_RING;
    }
    e->own.state = RLO_INVALID;
    e->own.pid = -1;
    /* always present so a FAILURE notice from a detecting peer is
     * adopted even when this engine's own detector is off */
    e->failed = (uint8_t *)calloc((size_t)e->ws, 1);
    e->hb_seen = (uint64_t *)calloc((size_t)e->ws, sizeof(uint64_t));
    e->seen_contig = (int64_t *)malloc((size_t)e->ws * sizeof(int64_t));
    e->seen_mask = (uint64_t *)calloc((size_t)e->ws * RLO_SEEN_WORDS,
                                      sizeof(uint64_t));
    e->tx_seq = (int32_t *)calloc((size_t)e->ws, sizeof(int32_t));
    e->rtx_by_dst =
        (rlo_rtx **)calloc((size_t)e->ws, sizeof(void *));
    e->rx_contig = (int64_t *)malloc((size_t)e->ws * sizeof(int64_t));
    e->rx_mask = (uint64_t *)calloc((size_t)e->ws * RLO_SEEN_WORDS,
                                    sizeof(uint64_t));
    e->ack_due = (uint8_t *)calloc((size_t)e->ws, 1);
    e->tx_skip = (int32_t *)malloc((size_t)e->ws * sizeof(int32_t));
    e->tx_skip_due =
        (uint64_t *)calloc((size_t)e->ws, sizeof(uint64_t));
    e->skip_hold = (uint8_t *)calloc((size_t)e->ws, 1);
    e->links = (rlo_link_stats *)calloc((size_t)e->ws,
                                        sizeof(rlo_link_stats));
    e->epoch_floor = (int32_t *)calloc((size_t)e->ws, sizeof(int32_t));
    e->link_epoch = (int32_t *)calloc((size_t)e->ws, sizeof(int32_t));
    e->admit_epoch = (int32_t *)calloc((size_t)e->ws, sizeof(int32_t));
    e->admitted_inc = (int32_t *)malloc((size_t)e->ws * sizeof(int32_t));
    e->admitting = (uint8_t *)calloc((size_t)e->ws, 1);
    e->pending_join = (uint8_t *)calloc((size_t)e->ws, 1);
    e->pending_inc = (int32_t *)calloc((size_t)e->ws, sizeof(int32_t));
    e->pending_ep = (int32_t *)calloc((size_t)e->ws, sizeof(int32_t));
    e->sub_excluded = (uint8_t *)calloc((size_t)e->ws, 1);
    e->gave_scratch = (uint8_t *)calloc((size_t)e->ws, 1);
    e->stale_probe_last =
        (uint64_t *)calloc((size_t)e->ws, sizeof(uint64_t));
    e->reset_epoch = (int32_t *)calloc((size_t)e->ws, sizeof(int32_t));
    e->sync_req_last =
        (uint64_t *)calloc((size_t)e->ws, sizeof(uint64_t));
    if (e->seen_contig)
        for (int r = 0; r < e->ws; r++)
            e->seen_contig[r] = -1;
    if (e->rx_contig)
        for (int r = 0; r < e->ws; r++)
            e->rx_contig[r] = -1;
    if (e->tx_skip)
        for (int r = 0; r < e->ws; r++)
            e->tx_skip[r] = -1;
    if (e->admitted_inc)
        for (int r = 0; r < e->ws; r++)
            e->admitted_inc[r] = -1;
    if (e->n_init < 0 || !e->failed || !e->hb_seen || !e->seen_contig ||
        !e->seen_mask || !e->tx_seq || !e->rtx_by_dst ||
        !e->rx_contig || !e->rx_mask ||
        !e->ack_due || !e->tx_skip || !e->tx_skip_due || !e->skip_hold ||
        !e->links || !e->epoch_floor || !e->link_epoch ||
        !e->admit_epoch || !e->admitted_inc || !e->admitting ||
        !e->pending_join || !e->pending_inc || !e->pending_ep ||
        !e->sub_excluded || !e->gave_scratch ||
        !e->stale_probe_last || !e->reset_epoch || !e->sync_req_last ||
        rlo_world_register(w, e) != RLO_OK) {
        free(e->failed);
        free(e->hb_seen);
        free(e->seen_contig);
        free(e->seen_mask);
        free(e->tx_seq);
        free(e->rtx_by_dst);
        free(e->rx_contig);
        free(e->rx_mask);
        free(e->ack_due);
        free(e->tx_skip);
        free(e->tx_skip_due);
        free(e->skip_hold);
        free(e->links);
        free(e->epoch_floor);
        free(e->link_epoch);
        free(e->admit_epoch);
        free(e->admitted_inc);
        free(e->admitting);
        free(e->pending_join);
        free(e->pending_inc);
        free(e->pending_ep);
        free(e->sub_excluded);
        free(e->gave_scratch);
        free(e->stale_probe_last);
        free(e->reset_epoch);
        free(e->sync_req_last);
        free(e);
        return 0;
    }
    return e;
}

rlo_engine *rlo_engine_new_sub(rlo_world *w, int rank, int comm,
                               const int *members, int n_members,
                               rlo_judge_cb judge, void *judge_ctx,
                               rlo_action_cb action, void *action_ctx,
                               int64_t msg_size_max)
{
    if (!members || n_members < 2 || n_members > rlo_world_size(w))
        return 0;
    int in_group = 0;
    for (int i = 0; i < n_members; i++) {
        if (members[i] < 0 || members[i] >= rlo_world_size(w))
            return 0;
        if (members[i] == rank)
            in_group = 1;
    }
    if (!in_group)
        return 0;
    rlo_engine *e = rlo_engine_new(w, rank, comm, judge, judge_ctx,
                                   action, action_ctx, msg_size_max);
    if (!e)
        return 0;
    /* subset = the elastic-reforming translation with the non-members
     * permanently excluded: every routed path (cur_init_targets,
     * cur_fwd_targets, ring_neighbors, reflood, discounting) already
     * consults the alive view (mirror of ProgressEngine(members=...)).
     * Excluded ranks are never probed or admitted (they are not
     * failed members — they were never members at all). */
    for (int r = 0; r < e->ws; r++)
        e->failed[r] = 1;
    for (int i = 0; i < n_members; i++)
        e->failed[members[i]] = 0;
    e->n_failed = 0;
    for (int r = 0; r < e->ws; r++) {
        e->n_failed += e->failed[r];
        e->sub_excluded[r] = e->failed[r];
    }
    e->n_excluded = e->n_failed;
    return e;
}

static void q_free_all(rlo_queue *q)
{
    for (rlo_msg *m = q->head; m;) {
        rlo_msg *nm = m->next;
        msg_free(m);
        m = nm;
    }
    q->head = q->tail = 0;
    q->len = 0;
}

void rlo_engine_free(rlo_engine *e)
{
    if (!e)
        return;
    rlo_world_unregister(e->w, e);
    q_free_all(&e->q_wait);
    q_free_all(&e->q_wait_pickup);
    q_free_all(&e->q_pickup);
    q_free_all(&e->q_iar_pending);
    for (int i = 0; i < e->own.n_decision; i++)
        rlo_handle_unref(e->own.decision_handles[i]);
    free(e->own.decision_handles);
    free(e->own.payload);
    free(e->failed);
    free(e->hb_seen);
    free(e->seen_contig);
    free(e->seen_mask);
    free(e->tx_seq);
    free(e->rx_contig);
    free(e->rx_mask);
    free(e->ack_due);
    free(e->tx_skip);
    free(e->tx_skip_due);
    free(e->skip_hold);
    free(e->links);
    free(e->epoch_floor);
    free(e->link_epoch);
    free(e->admit_epoch);
    free(e->admitted_inc);
    free(e->admitting);
    free(e->pending_join);
    free(e->pending_inc);
    free(e->pending_ep);
    free(e->sub_excluded);
    free(e->gave_scratch);
    free(e->stale_probe_last);
    free(e->reset_epoch);
    free(e->sync_req_last);
    while (e->rtx_head)
        rtx_release(e, e->rtx_head);
    free(e->rtx_by_dst);
    free(e->arq_heap);
    for (int i = 0; i < RLO_RECENT_LOG; i++)
        rlo_blob_unref(e->recent[i]);
    free(e);
}

/* ---------------- elastic topology (over the alive set) ------------
 * Mirror of the Python engine's _cur_initiator_targets/_fwd_targets:
 * identity to the static topology while nothing has failed; after a
 * failure, the skip-ring math runs on virtual ranks = indices into the
 * sorted alive set. */

static int vrank_of(const rlo_engine *e, int r)
{
    if (!e->n_failed)
        return r;
    if (e->failed[r])
        return -1;
    int v = 0;
    for (int i = 0; i < r; i++)
        if (!e->failed[i])
            v++;
    return v;
}

static int real_of(const rlo_engine *e, int v)
{
    if (!e->n_failed)
        return v;
    for (int r = 0; r < e->ws; r++)
        if (!e->failed[r] && v-- == 0)
            return r;
    return -1;
}

static int cur_init_targets(rlo_engine *e, int *out, int cap)
{
    if (e->fanout == RLO_FANOUT_FLAT) {
        /* flat spanning tree: the origin sends to every live member
         * directly; receivers are leaves. Depth-1 scheduling for
         * latency-bound cases where ONE rank should pay all sends.
         * Measured caveat (round-4 judge re-run, oversubscribed
         * 8-process host, 4 KB frames): flat was 1.22x native vs the
         * skip-ring's 1.10x — store-and-forward spreads the send
         * work over ranks and wins even there, so the skip-ring is
         * the default everywhere and case_nbcast races both each
         * run. Rootlessness, the (origin, seq) dedup, and IAR vote
         * accounting are schedule-independent — the proposer simply
         * awaits ws-1 leaf votes. */
        int n = 0;
        for (int r = 0; r < e->ws; r++) {
            if (r == e->rank || e->failed[r])
                continue;
            if (n >= cap)
                return RLO_ERR_ARG;
            out[n++] = r;
        }
        return n;
    }
    if (!e->n_failed) {
        int n = e->n_init < cap ? e->n_init : cap;
        memcpy(out, e->init_targets, (size_t)n * sizeof(int));
        return n;
    }
    int vws = e->ws - e->n_failed;
    if (vws < 2)
        return 0;
    int vt[64];
    int n = rlo_initiator_targets(vws, vrank_of(e, e->rank), vt, 64);
    if (n < 0 || n > cap)
        return RLO_ERR_ARG;
    for (int i = 0; i < n; i++)
        out[i] = real_of(e, vt[i]);
    return n;
}

static int cur_fwd_targets(rlo_engine *e, int origin, int src, int *out,
                           int cap)
{
    if (e->fanout == RLO_FANOUT_FLAT)
        return 0; /* flat: the origin reached everyone; deliver only */
    if (!e->n_failed)
        return rlo_fwd_targets(e->ws, e->rank, origin, src, out, cap);
    if (origin < 0 || origin >= e->ws || src < 0 || src >= e->ws ||
        e->failed[origin] || e->failed[src])
        return 0; /* stale pre-failure route: deliver-only */
    int vws = e->ws - e->n_failed;
    if (vws < 2)
        return 0;
    int vt[64];
    int n = rlo_fwd_targets(vws, vrank_of(e, e->rank),
                            vrank_of(e, origin), vrank_of(e, src), vt, 64);
    if (n < 0 || n > cap)
        return RLO_ERR_ARG;
    for (int i = 0; i < n; i++)
        out[i] = real_of(e, vt[i]);
    return n;
}

static int round_settled_peek(const rlo_engine *e, int32_t pid,
                              int32_t gen);
static int announce_failed(rlo_engine *e, int rank);
static void become_joiner(rlo_engine *e);
static int execute_admission(rlo_engine *e, int joiner, int inc,
                             int32_t new_epoch);
static void finish_member_round(rlo_engine *e);
static void request_sync(rlo_engine *e, int dst);
static void msync_serve(rlo_engine *e, int dst);
static void on_msync(rlo_engine *e, rlo_msg *m);

/* ---------------- exactly-once broadcast dedup -------------------- */

/* Shift the 256-bit window right by k bits (toward bit 0). */
static void seen_shift(uint64_t *m, int64_t k)
{
    while (k >= 64) {
        for (int i = 0; i < RLO_SEEN_WORDS - 1; i++)
            m[i] = m[i + 1];
        m[RLO_SEEN_WORDS - 1] = 0;
        k -= 64;
    }
    if (k > 0) {
        for (int i = 0; i < RLO_SEEN_WORDS; i++) {
            m[i] >>= k;
            if (i + 1 < RLO_SEEN_WORDS)
                m[i] |= m[i + 1] << (64 - k);
        }
    }
}

/* Record `seq` in a watermark+window dedup structure; returns 1 when it
 * was already seen. Bit i of the window is seq contig+1+i. Shared by
 * the app-level (origin, seq) broadcast dedup and the link-level
 * (sender, seq) ARQ dedup — same algorithm, different key spaces. */
static int window_record(int64_t *contig, uint64_t *mask, int64_t seq)
{
    if (seq <= *contig)
        return 1;
    int64_t off = seq - *contig - 1;
    if (off >= RLO_SEEN_BITS) {
        /* reorder beyond the window: absorb the oldest gaps as seen
         * (collapses to at-most-once for seqs that stale) */
        int64_t shift = off - (RLO_SEEN_BITS - 1);
        if (shift >= RLO_SEEN_BITS) /* clamp: a huge gap clears all */
            memset(mask, 0, RLO_SEEN_WORDS * sizeof(uint64_t));
        else
            seen_shift(mask, shift);
        *contig += shift;
        off = RLO_SEEN_BITS - 1;
    }
    if (mask[off >> 6] & (1ull << (off & 63)))
        return 1;
    mask[off >> 6] |= 1ull << (off & 63);
    while (mask[0] & 1) { /* advance the contiguous watermark */
        seen_shift(mask, 1);
        (*contig)++;
    }
    return 0;
}

/* Check-only variant of window_record: never mutates the window, so it
 * is safe inside the MSYNC advert filter (have_log_entry) — recording
 * there would poison the dedup against the real frame that the WANT
 * round is about to fetch. */
static int window_peek(const int64_t *contig, const uint64_t *mask,
                       int64_t seq)
{
    if (seq <= *contig)
        return 1;
    int64_t off = seq - *contig - 1;
    if (off >= RLO_SEEN_BITS)
        return 0;
    return (mask[off >> 6] & (1ull << (off & 63))) != 0;
}

/* (origin, seq) receipt check for BCAST frames. The initiator never
 * delivers its own broadcast, so a re-flooded copy of my own frame is
 * also a duplicate. */
static int bcast_is_dup(rlo_engine *e, const rlo_msg *m)
{
    if (m->origin == e->rank)
        return 1;
    if (m->vote < 0 || m->origin < 0 || m->origin >= e->ws)
        return 0; /* unstamped (foreign/legacy frame): best-effort */
    return window_record(&e->seen_contig[m->origin],
                         &e->seen_mask[(size_t)m->origin * RLO_SEEN_WORDS],
                         m->vote);
}

/* ---------------- reliable delivery (ARQ) ---------------- */

/* Push one wake-up deadline onto the lazy due-heap. Allocation
 * failure degrades gracefully: heap_len 0 with a non-empty queue
 * makes arq_tick fall back to the ungated sweep. */
static void arq_heap_push(rlo_engine *e, uint64_t due)
{
    if (e->arq_heap_len == e->arq_heap_cap) {
        int cap = e->arq_heap_cap ? e->arq_heap_cap * 2 : 64;
        uint64_t *h = (uint64_t *)realloc(
            e->arq_heap, (size_t)cap * sizeof(uint64_t));
        if (!h) {
            /* the lost wake-up breaks the gate invariant: degrade to
             * ungated sweeps (arq_tick re-arms once the queue drains) */
            e->arq_gate_degraded = 1;
            return;
        }
        e->arq_heap = h;
        e->arq_heap_cap = cap;
    }
    int i = e->arq_heap_len++;
    uint64_t *h = e->arq_heap;
    while (i > 0 && h[(i - 1) / 2] > due) {
        h[i] = h[(i - 1) / 2];
        i = (i - 1) / 2;
    }
    h[i] = due;
}

/* Pop every deadline at or before `now` (they are consumed whether
 * live or stale: a sweep follows and re-arms whatever remains). */
static void arq_heap_pop_due(rlo_engine *e, uint64_t now)
{
    uint64_t *h = e->arq_heap;
    while (e->arq_heap_len && h[0] <= now) {
        uint64_t last = h[--e->arq_heap_len];
        int i = 0;
        for (;;) {
            int kid = 2 * i + 1;
            if (kid >= e->arq_heap_len)
                break;
            if (kid + 1 < e->arq_heap_len && h[kid + 1] < h[kid])
                kid++;
            if (h[kid] >= last)
                break;
            h[i] = h[kid];
            i = kid;
        }
        if (e->arq_heap_len)
            h[i] = last;
    }
}

/* Cumulative ACK from `src`: drop everything it covers from the
 * retransmit queue (and retire a pending SKIP notice the ACK proves
 * was absorbed). */
static void arq_on_ack(rlo_engine *e, int src, int32_t cum)
{
    uint64_t now = e->metrics_on ? rlo_now_usec() : 0;
    int32_t lo = INT32_MAX; /* lowest seq still held for src */
    if (e->tx_skip[src] >= 0 && cum >= e->tx_skip[src])
        e->tx_skip[src] = -1;
    for (rlo_rtx *rt = e->rtx_by_dst[src]; rt;) {
        rlo_rtx *nrt = rt->dnext;
        if (rt->seq <= cum) {
            if (e->metrics_on && rt->retries == 0 && now >= rt->sent)
                /* RTT from ack timing — never-retransmitted frames
                 * only (Karn's rule: a retransmitted frame's ack is
                 * ambiguous about which copy it answers). now >= sent
                 * guards a backwards wall-clock step (rlo_now_usec is
                 * gettimeofday): an underflowed delta would poison
                 * the EWMA for the process lifetime */
                rtt_sample(&e->links[src],
                           (double)(now - rt->sent));
            rtx_release(e, rt);
        } else if (rt->seq < lo) {
            lo = rt->seq;
        }
        rt = nrt;
    }
    /* unfillable hole: the receiver's watermark sits below seqs we no
     * longer hold (its window was reset by an admission/welcome while
     * ours carried on — tx seqs are monotone per lifetime). We can
     * never retransmit (cum, lo) — ACKs are FIFO per channel, so the
     * gap is permanent — so tell it to skip ahead now instead of
     * retransmitting the held frames to exhaustion (which would end
     * in a spurious half-dead-link FAILURE). */
    if (lo != INT32_MAX && lo > cum + 1 && lo - 1 > e->tx_skip[src]) {
        e->tx_skip[src] = lo - 1;
        e->tx_skip_due[src] = 0; /* send at the next tick */
    }
    /* any ACK that leaves a notice armed wakes the gated sweep NOW:
     * it may have just released the lower-seq entry that was HOLDING
     * the notice back, and the notice's own wake could be a full rto
     * away (review finding: the pre-gate code sent it next tick) */
    if (e->tx_skip[src] >= 0)
        arq_heap_push(e, 0);
}

/* SKIP notice from a SENDER: it gave up on everything <= upto; advance
 * the receive watermark over the permanent hole so cumulative ACKs for
 * later frames are unblocked. */
static void arq_rx_skip(rlo_engine *e, int src, int32_t upto)
{
    if ((int64_t)upto <= e->rx_contig[src])
        return;
    uint64_t *mask = &e->rx_mask[(size_t)src * RLO_SEEN_WORDS];
    int64_t shift = (int64_t)upto - e->rx_contig[src];
    if (shift >= RLO_SEEN_BITS)
        memset(mask, 0, RLO_SEEN_WORDS * sizeof(uint64_t));
    else
        seen_shift(mask, shift);
    e->rx_contig[src] = upto;
    while (mask[0] & 1) { /* holes below upto may now be contiguous */
        seen_shift(mask, 1);
        e->rx_contig[src]++;
    }
    e->ack_due[src] = 1; /* tell the sender the new cum */
}

/* Drop every retransmit entry addressed to a (now dead) rank. */
static void arq_drop_dst(rlo_engine *e, int dst)
{
    for (rlo_rtx *rt = e->rtx_by_dst[dst]; rt;) {
        rlo_rtx *nrt = rt->dnext;
        rtx_release(e, rt);
        rt = nrt;
    }
}

/* Retransmit sweep: resend overdue unacked frames with exponential
 * backoff; give up after max_retries (a peer that silent is the
 * failure detector's problem, not ARQ's). Every give-up arms a SKIP
 * notice (ACK frame, vote = -2 sentinel, pid = abandoned seq) so the
 * receiver's watermark advances over the permanent hole — sent only
 * once no lower seq is still being retried (an advanced watermark
 * would misread those retransmits as duplicates), repeating at rto
 * cadence until an ACK at/past the skipped seq retires it
 * (mirror of ProgressEngine._arq_tick). */
static void arq_tick(rlo_engine *e)
{
    uint64_t now = rlo_now_usec();
    int armed = 0;
    /* lazy due-heap gate (PR 7's Python _arq_wake, docs/DESIGN.md
     * S13): while the earliest armed wake-up is in the future nothing
     * anywhere can be due, so the common idle tick is one heap peek.
     * Stale entries (acked / re-timed frames) pop when they expire
     * and cost one empty sweep — laziness is the O(1) deal. An empty
     * heap with a non-empty queue (a failed heap allocation) falls
     * back to the ungated sweep. */
    if (e->arq_gate_degraded) {
        /* a wake-up was lost to a failed heap grow: sweep ungated
         * until everything armed has drained, then reset the gate
         * from a clean slate (all future wakes get fresh pushes) */
        if (!e->rtx_head) {
            int armed_skip = 0;
            for (int d = 0; d < e->ws; d++)
                if (e->tx_skip[d] >= 0)
                    armed_skip = 1;
            if (!armed_skip) {
                e->arq_gate_degraded = 0;
                e->arq_heap_len = 0; /* stale entries, wholesale */
                e->arq_gated++;
                return;
            }
        }
    } else {
        if (e->arq_heap_len && e->arq_heap[0] > now) {
            e->arq_gated++;
            return;
        }
        if (!e->arq_heap_len && !e->rtx_head) {
            /* nothing unacked and no wake-ups armed (armed skip
             * notices always hold a heap entry, so none starve here) */
            e->arq_gated++;
            return;
        }
    }
    arq_heap_pop_due(e, now);
    for (rlo_rtx **pp = &e->rtx_head; *pp;) {
        rlo_rtx *rt = *pp;
        if (rt->due > now) {
            pp = &rt->next;
            continue;
        }
        if (rt->retries >= e->arq_max_retries ||
            (rt->dst >= 0 && rt->dst < e->ws && e->failed[rt->dst])) {
            if (rt->dst >= 0 && rt->dst < e->ws &&
                !e->failed[rt->dst]) {
                /* retries exhausted on a LIVE peer (a dead peer's
                 * entries are dropped, not given up on — mirror of
                 * the Python tick's failed-dst clear). A give-up is a
                 * half-dead link: escalate to the failure detector
                 * after the sweep (announce_failed mutates this
                 * queue) */
                e->arq_gaveup++;
                rlo_trace_emit(e->rank, RLO_EV_ARQ_GIVEUP, rt->dst,
                               rt->retries, 0, 0);
                if (!e->awaiting_welcome)
                    e->gave_scratch[rt->dst] = 1;
                if (rt->seq > e->tx_skip[rt->dst]) {
                    e->tx_skip[rt->dst] = rt->seq;
                    e->tx_skip_due[rt->dst] = now; /* send now */
                }
            }
            /* rtx_release unlinks by writing rt->prev->next — the
             * very field *pp aliases — so *pp is now rt's successor
             * and the walk continues without advancing pp */
            rtx_release(e, rt);
            continue;
        }
        rt->retries++;
        /* clamped shift: retries is bounded by enable_arq, but keep
         * the backoff well-defined for any config */
        rt->due = now + (e->arq_rto
                         << (rt->retries < 32 ? rt->retries : 32));
        arq_heap_push(e, rt->due); /* re-arm the gate */
        e->arq_retx++;
        if (e->metrics_on && rt->dst >= 0 && rt->dst < e->ws) {
            e->links[rt->dst].retransmits++;
            e->links[rt->dst].tx_frames++;
            e->links[rt->dst].tx_bytes += rt->frame->len;
        }
        /* same bytes, same seq: the receiver dedups the retransmit */
        if (rt->split)
            isend_hdr_timed(e, rt->dst, rt->tag, rt->hdr, rt->frame, 0);
        else
            isend_timed(e, rt->dst, rt->tag, rt->frame, 0);
        pp = &rt->next;
    }
    for (int d = 0; d < e->ws; d++) {
        e->skip_hold[d] = 0;
        if (e->tx_skip[d] >= 0)
            armed = 1;
    }
    if (!armed)
        return;
    /* hold a notice back while a lower seq is still in the queue */
    for (rlo_rtx *rt = e->rtx_head; rt; rt = rt->next)
        if (e->tx_skip[rt->dst] >= 0 && rt->seq <= e->tx_skip[rt->dst])
            e->skip_hold[rt->dst] = 1;
    for (int d = 0; d < e->ws; d++) {
        if (e->tx_skip[d] < 0 || e->skip_hold[d] ||
            now < e->tx_skip_due[d] || e->failed[d] || d == e->rank)
            continue;
        eng_isend(e, d, RLO_TAG_ACK, e->rank, e->tx_skip[d], -2, 0, 0,
                  0);
        e->tx_skip_due[d] = now + e->arq_rto;
    }
    /* re-arm the gate for every notice still armed (just sent, held
     * behind a lower seq, or not yet due): the heap invariant needs a
     * wake at or before each notice's next action time */
    for (int d = 0; d < e->ws; d++)
        if (e->tx_skip[d] >= 0)
            arq_heap_push(e, e->tx_skip_due[d] > now
                                 ? e->tx_skip_due[d]
                                 : now + e->arq_rto);
}

/* ARQ give-up escalation, AFTER the retransmit sweep: a peer that
 * swallowed max_retries retransmits is a half-dead link — declared
 * FAILED exactly like a silent heartbeat predecessor (mirror of the
 * Python tick's gave_up_on epilogue). */
static void arq_escalate_gaveup(rlo_engine *e)
{
    for (int d = 0; d < e->ws; d++) {
        if (!e->gave_scratch[d])
            continue;
        e->gave_scratch[d] = 0;
        if (e->failed[d] || e->awaiting_welcome)
            continue;
        if (!getenv("RLO_QUIET"))
            fprintf(stderr,
                    "rlo_tpu_torch: rank %d declaring rank %d FAILED: ARQ "
                    "gave up after %d retries (half-dead link)\n",
                    e->rank, d, e->arq_max_retries);
        rlo_trace_emit(e->rank, RLO_EV_FAILURE, d, 1, 0, 0);
        announce_failed(e, d);
    }
}

/* Flush the cumulative ACKs this turn's receipts owe (at most one per
 * sender per turn; ACKs are themselves unreliable). */
static void arq_flush_acks(rlo_engine *e)
{
    for (int src = 0; src < e->ws; src++) {
        if (!e->ack_due[src])
            continue;
        e->ack_due[src] = 0;
        if (src == e->rank || e->failed[src])
            continue;
        eng_isend(e, src, RLO_TAG_ACK, e->rank, -1,
                  (int32_t)e->rx_contig[src], 0, 0, 0);
    }
}

/* Remember a BCAST or IAR_DECISION frame for view-change re-flooding.
 * Decisions ride the same log: one lost in a view-change window would
 * otherwise leave parent-died relayed rounds parked forever (the
 * settled (pid, gen) ring absorbs the flood like (origin, seq) does
 * for broadcasts). */
static void recent_log_push(rlo_engine *e, rlo_blob *frame, int tag)
{
    rlo_blob_unref(e->recent[e->recent_pos]);
    e->recent[e->recent_pos] = rlo_blob_ref(frame);
    e->recent_tag[e->recent_pos] = tag;
    e->recent_pos = (e->recent_pos + 1) % RLO_RECENT_LOG;
}

/* (tag, a, b) wire identity of one recent-log entry — the coordinates
 * the MSYNC advert/WANT pair exchanges instead of payloads (mirror of
 * engine.py _log_entry_ident). Returns 0 for entries with no
 * recoverable identity. The C log holds BCAST/IAR_DECISION/FAILURE
 * entries only (no ABORT receive path — see abort_own_round). */
static int log_entry_ident(const rlo_engine *e, int idx, int32_t *t,
                           int32_t *a, int32_t *b)
{
    rlo_blob *blob = e->recent[idx];
    if (!blob)
        return 0;
    int tag = e->recent_tag[idx];
    int32_t origin, pid, vote;
    const uint8_t *pl;
    int64_t plen = rlo_frame_decode(blob->data, blob->len, &origin,
                                    &pid, &vote, 0, &pl);
    if (plen < 0)
        return 0;
    if (tag == RLO_TAG_BCAST) {
        *t = tag;
        *a = origin; /* (origin, bcast seq) */
        *b = vote;
        return 1;
    }
    if (tag == RLO_TAG_IAR_DECISION || tag == RLO_TAG_ABORT) {
        if (plen < 4)
            return 0;
        *t = tag;
        *a = pid; /* (pid, gen) */
        *b = get_le32(pl);
        return *b >= 0;
    }
    if (tag == RLO_TAG_FAILURE) {
        *t = tag;
        *a = pid; /* (failed rank, declarer epoch) */
        *b = vote;
        return 1;
    }
    return 0;
}

/* Build the MSYNC_AD payload ([kind:u8][count:i32] + count x
 * [tag:i32][a:i32][b:i32]) for the current recent log into `out`
 * (cap >= 5 + 12 * RLO_RECENT_LOG); returns the payload length, or 0
 * when the log holds nothing advertisable. */
static int64_t advert_payload(const rlo_engine *e, uint8_t *out)
{
    int cnt = 0;
    int64_t pos = 5;
    for (int i = 0; i < RLO_RECENT_LOG; i++) {
        int32_t t, a, b;
        if (!log_entry_ident(e, i, &t, &a, &b))
            continue;
        put_le32(out + pos, t);
        put_le32(out + pos + 4, a);
        put_le32(out + pos + 8, b);
        pos += 12;
        cnt++;
    }
    if (!cnt)
        return 0;
    out[0] = RLO_MSYNC_AD;
    put_le32(out + 1, cnt);
    return pos;
}

/* Does this rank provably already hold the advertised entry? Reads
 * exactly the dedup state that would have dropped the old blast's
 * duplicate (mirror of engine.py _have_log_entry) — an entry this
 * returns 1 for would have been a wasted re-flood frame (counted in
 * reflood_skipped). Check-only: window_peek and round_settled_peek
 * never record. */
static int have_log_entry(const rlo_engine *e, int32_t t, int32_t a,
                          int32_t b)
{
    if (t == RLO_TAG_BCAST) {
        if (a == e->rank || b < 0 || a < 0 || a >= e->ws)
            return 1; /* my own, or unstamped (not recoverable) */
        return window_peek(&e->seen_contig[a],
                           &e->seen_mask[(size_t)a * RLO_SEEN_WORDS],
                           b);
    }
    if (t == RLO_TAG_IAR_DECISION || t == RLO_TAG_ABORT) {
        if (t == RLO_TAG_IAR_DECISION && a <= RLO_MEMBER_PID_BASE)
            /* membership decisions are never WANTed: the welcome /
             * sync-response member records are the authoritative
             * channel, and a stale admission about a since-re-failed
             * rank must not resurrect it (the same rule replay_recent
             * applies) */
            return 1;
        return b < 0 || round_settled_peek(e, a, b);
    }
    if (t == RLO_TAG_FAILURE) {
        if (a < 0 || a >= e->ws)
            return 1;
        /* a = failed rank, b = declarer epoch: already adopted, about
         * myself (heal probes cover self-failure learning), or stale
         * against an admission executed since */
        return a == e->rank || e->failed[a] || b < e->admit_epoch[a];
    }
    return 1;
}

/* Plug forwarding holes a dead relay left — digest-scoped
 * (docs/DESIGN.md S18). The pre-PR-16 heal re-sent every recent
 * frame point-to-point to every alive rank on every view change:
 * O(n^2 * ring) frames per churn episode, the dominant term of the
 * measured rejoin cascade. Now each view change sends one MSYNC
 * advert per alive peer carrying only the log entries' IDENTITIES; a
 * peer answers with a WANT naming exactly the entries it provably
 * misses, and only those payloads are re-sent. An empty log sends
 * nothing at all — kill-only fleets heal for free. Delivery
 * exactly-once composes the same way: the WANT check reads the same
 * dedup state that would have dropped the blast's duplicates.
 * Adverts are best-effort (ARQ-exempt): every later view change
 * re-adverts, and the admission replay / welcome path covers the
 * rejoin side independently. */
static void reflood_recent(rlo_engine *e)
{
    uint8_t ad[5 + 12 * RLO_RECENT_LOG];
    int64_t n = advert_payload(e, ad);
    if (!n)
        return;
    for (int dst = 0; dst < e->ws; dst++)
        if (dst != e->rank && !e->failed[dst])
            eng_isend(e, dst, RLO_TAG_MSYNC, e->rank, -1, -1, ad, n,
                      0);
}

/* ---------------- rootless broadcast ---------------- */

/* Initiate without progressing (handlers use this; the public entry
 * progresses after). Returns the tracking msg via *out. */
static int bcast_init(rlo_engine *e, int tag, int32_t pid, int32_t vote,
                      const uint8_t *payload, int64_t len, rlo_msg **out)
{
    if (len < 0 || len > e->msg_size_max)
        return RLO_ERR_TOO_BIG;
    /* encode ONCE; every fan-out edge shares the blob by ref */
    rlo_blob *frame;
    if (e->profiler_on) {
        double t0 = now_usec_f();
        frame = frame_blob(e->w, e->rank, pid, vote, payload, len);
        ph_obs(e, RLO_PH_FRAME_ENCODE, t0);
    } else {
        frame = frame_blob(e->w, e->rank, pid, vote, payload, len);
    }
    if (!frame)
        return RLO_ERR_NOMEM;
    int err = RLO_ERR_NOMEM;
    rlo_msg *m = msg_from_frame(e->w, tag, -1, frame,
                                &err); /* steals the ref */
    if (!m)
        return err;
    int targets[64];
    int nt = cur_init_targets(e, targets, 64);
    if (nt < 0) {
        msg_free(m);
        return nt;
    }
    for (int i = 0; i < nt; i++) { /* furthest-first */
        int rc = eng_isend_frame(e, targets[i], tag, m->frame, m);
        if (rc != RLO_OK) {
            msg_free(m);
            return rc;
        }
    }
    q_append(&e->q_wait, m);
    e->sent_bcast++;
    rlo_trace_emit(e->rank, RLO_EV_BCAST_INIT, tag, (int)len,
                   trace_ident(tag, pid, vote), 0);
    if (out)
        *out = m;
    return RLO_OK;
}

int rlo_bcast(rlo_engine *e, const uint8_t *payload, int64_t len)
{
    /* stamp the exactly-once sequence number in the (otherwise unused)
     * vote field; log the frame for view-change re-flooding. The seq is
     * consumed BEFORE sending (matching engine.py): a partial-send
     * failure may have leaked the seq to some peers, and reusing it
     * would make them silently drop the next broadcast as a duplicate.
     * A burnt seq just leaves a gap the dedup window absorbs. */
    rlo_msg *m = 0;
    int rc = bcast_init(e, RLO_TAG_BCAST, -1, e->bcast_seq++, payload,
                        len, &m);
    if (rc == RLO_OK) {
        if (e->metrics_on)
            m->born = rlo_now_usec();
        if (e->profiler_on)
            m->p_born = now_usec_f();
        recent_log_push(e, m->frame, RLO_TAG_BCAST);
        rlo_progress_all(e->w);
    }
    return rc;
}

/* Forward a received broadcast along the overlay (reference _bc_forward,
 * rootless_ops.c:1104-1225). Returns the number of forwards or <0. */
/* rlo-sentinel: transfers(m) — queued on success; on rc<0 nothing
 * was queued and the CALLER reclaims (progress dispatch) */
static int bc_forward(rlo_engine *e, rlo_msg *m)
{
    int targets[64];
    int n = cur_fwd_targets(e, m->origin, m->src, targets, 64);
    if (n < 0)
        return n;
    for (int i = 0; i < n; i++) {
        /* zero-copy store-and-forward: every hop shares the one blob */
        int rc = eng_isend_frame(e, targets[i], m->tag, m->frame, m);
        if (rc != RLO_OK)
            return rc;
    }
    /* receipt+forward step — emitted even for leaf receipts (zero
     * targets) so the timeline merger always has a receive-side
     * anchor carrying (origin, identity, immediate sender) */
    rlo_trace_emit(e->rank, RLO_EV_BCAST_FWD, m->tag, m->origin,
                   trace_ident(m->tag, m->pid, m->vote), m->src);
    if (m->tag == RLO_TAG_IAR_PROPOSAL) {
        /* proposals are engine-internal: parked for the decision, never
         * user-visible (make_progress_gen :591-596) */
        q_append(&e->q_iar_pending, m);
    } else if (m->tag == RLO_TAG_IAR_DECISION) {
        /* delivery handled by on_decision */
    } else if (n > 0) {
        q_append(&e->q_wait_pickup, m);
    } else {
        m->fwd_done = 1;
        q_append(&e->q_pickup, m);
    }
    return n;
}

/* ---------------- IAR consensus ---------------- */

static int eng_judge(rlo_engine *e, const uint8_t *payload, int64_t len,
                     int pid)
{
    int verdict;
    if (len >= RLO_MEMBER_MAGIC_LEN && payload &&
        !memcmp(payload, RLO_MEMBER_MAGIC, RLO_MEMBER_MAGIC_LEN))
        /* internal membership admission round (docs/DESIGN.md S8):
         * the engine judges it itself — the app's judge never sees
         * protocol-internal rounds */
        verdict = 1;
    else
        verdict = e->judge ? (e->judge(payload, len, e->judge_ctx) ? 1 : 0)
                           : 1;
    rlo_trace_emit(e->rank, RLO_EV_JUDGE, pid, verdict, 0, 0);
    return verdict;
}

/* Send my (merged) vote to the rank the proposal came from (reference
 * _vote_back :728-741; nonblocking here). The payload echoes the round
 * generation so a stale vote from an earlier same-pid round can never
 * be counted into a later one. */
static int vote_back(rlo_engine *e, const rlo_prop *ps, int vote)
{
    uint8_t genb[4];
    put_le32(genb, ps->gen);
    rlo_trace_emit(e->rank, RLO_EV_VOTE, ps->pid, vote, ps->gen, 0);
    return eng_isend(e, ps->recv_from, RLO_TAG_IAR_VOTE, e->rank, ps->pid,
                     vote, genb, 4, 0);
}

/* The relay's merged vote is final: send it to the vote-tree parent
 * AND to every duplicate parent from re-formed overlay trees — one
 * merged verdict everywhere, so a subtree veto survives even when the
 * original parent is the dead rank that triggered the view change
 * (mirror of ProgressEngine._resolve_relay). */
static int resolve_relay(rlo_engine *e, rlo_prop *ps)
{
    ps->resolved = 1;
    int rc = vote_back(e, ps, ps->vote);
    for (int i = 0; i < ps->n_dup && rc == RLO_OK; i++) {
        rlo_prop vb = {0};
        vb.pid = ps->pid;
        vb.gen = ps->gen;
        vb.recv_from = ps->dup_parents[i];
        rc = vote_back(e, &vb, ps->vote);
    }
    ps->n_dup = 0;
    return rc;
}

static int vote_gen(const rlo_msg *m)
{
    if (m->len < 4)
        return -1;
    return (int)((uint32_t)m->payload[0] |
                 ((uint32_t)m->payload[1] << 8) |
                 ((uint32_t)m->payload[2] << 16) |
                 ((uint32_t)m->payload[3] << 24));
}

/* Matched on (pid, generation) so rounds reusing a pid never shadow
 * each other in the pending queue (~_find_proposal_msg :1036-1053). */
static rlo_msg *find_proposal_msg(rlo_engine *e, int pid, int gen)
{
    for (rlo_msg *m = e->q_iar_pending.head; m; m = m->next)
        if (m->ps && m->ps->pid == pid && m->ps->gen == gen)
            return m;
    return 0;
}

static void set_err(rlo_engine *e, int err)
{
    if (e->err == RLO_OK)
        e->err = err;
}

/* Forward a duplicate store-and-forward frame along the overlay with
 * no local processing; parked in the wait-only queue until the sends
 * complete. */
/* rlo-sentinel: transfers(m) */
static void bc_forward_only(rlo_engine *e, rlo_msg *m)
{
    int targets[64];
    int n = cur_fwd_targets(e, m->origin, m->src, targets, 64);
    if (n < 0) {
        set_err(e, n);
        msg_free(m);
        return;
    }
    for (int i = 0; i < n; i++) {
        int rc = eng_isend_frame(e, targets[i], m->tag, m->frame, m);
        if (rc != RLO_OK) {
            set_err(e, rc);
            msg_free(m);
            return;
        }
    }
    q_append(&e->q_wait, m);
}

/* rlo-sentinel: transfers(m) */
static void on_proposal(rlo_engine *e, rlo_msg *m)
{
    if (m->origin == e->rank) {
        /* my own proposal echoed back around a re-formed overlay
         * cycle (mixed views while membership converges): the
         * proposer holds no relay state and must not re-forward */
        msg_free(m);
        return;
    }
    /* duplicate across a view change (mixed old/new overlay trees):
     * never re-judge or re-park — a second proposal state voting to a
     * second parent would corrupt the vote accounting. Forward for
     * coverage. A PENDING duplicate's sender is a live relay awaiting
     * my vote, but my subtree's veto may still be in flight, so an
     * interim verdict could approve a round a live rank vetoed:
     * resolved rounds send the final merged vote now, unresolved ones
     * record the sender as a duplicate parent for resolve_relay.
     * A SETTLED duplicate needs no vote — the decision already
     * broadcast, and on_decision frees the sender's pending state. */
    rlo_msg *dup = find_proposal_msg(e, m->pid, m->vote);
    if (dup || (m->vote >= 0 && round_settled_peek(e, m->pid, m->vote))) {
        if (dup && m->src != dup->ps->recv_from) {
            rlo_prop *dps = dup->ps;
            int known = 0;
            for (int i = 0; i < dps->n_dup; i++)
                if (dps->dup_parents[i] == m->src)
                    known = 1;
            if (!known) {
                if (dps->resolved) {
                    rlo_prop vb = {0};
                    vb.pid = m->pid;
                    vb.gen = m->vote;
                    vb.recv_from = m->src;
                    vote_back(e, &vb, dps->vote);
                } else if (dps->n_dup <
                           (int)(sizeof(dps->dup_parents) /
                                 sizeof(dps->dup_parents[0]))) {
                    dps->dup_parents[dps->n_dup++] = m->src;
                } else {
                    /* 8 concurrent re-formed trees mid-round: out of
                     * slots — vote the interim verdict rather than
                     * deadlock the sender (degraded, bounded) */
                    rlo_prop vb = {0};
                    vb.pid = m->pid;
                    vb.gen = m->vote;
                    vb.recv_from = m->src;
                    vote_back(e, &vb, dps->vote);
                }
            }
        }
        bc_forward_only(e, m);
        return;
    }
    if (e->own.state == RLO_IN_PROGRESS && m->pid == e->own.pid) {
        /* pid collision with my active proposal — the reference only
         * printf-warns (:690-692) and corrupts vote accounting; fail
         * loudly instead (matches the Python engine) */
        set_err(e, RLO_ERR_PROTO);
        msg_free(m);
        return;
    }
    rlo_prop *ps = (rlo_prop *)calloc(1, sizeof(*ps));
    if (!ps) {
        set_err(e, RLO_ERR_NOMEM);
        msg_free(m);
        return;
    }
    ps->pid = m->pid;
    ps->gen = m->vote; /* round generation (see rlo_submit_proposal) */
    ps->recv_from = m->src;
    ps->vote = 1;
    ps->state = RLO_IN_PROGRESS;
    /* equal to bc_forward's target list by construction, including
     * after elastic re-forming */
    ps->n_await = cur_fwd_targets(e, m->origin, m->src,
                                  ps->await_from, 64);
    if (ps->n_await < 0) {
        set_err(e, ps->n_await);
        m->ps = ps;
        msg_free(m);
        return;
    }
    ps->votes_needed = ps->n_await;
    m->ps = ps;
    if (!eng_judge(e, m->payload, m->len, ps->pid)) {
        /* decline: NO to parent immediately, don't forward — the
         * subtree below only ever sees the decision. Parked anyway
         * (resolved, vote 0) so duplicates from re-formed trees find
         * the verdict instead of re-judging, and an approved decision
         * (possible when this veto was discounted with a dead subtree)
         * still fires the action callback here like everywhere else */
        ps->vote = 0;
        ps->votes_needed = 0;
        ps->n_await = 0;
        resolve_relay(e, ps);
        q_append(&e->q_iar_pending, m);
        return;
    }
    int sent = bc_forward(e, m); /* parks m in q_iar_pending */
    if (sent < 0) {
        /* bc_forward only fails before queueing — reclaim the msg */
        set_err(e, sent);
        msg_free(m);
    } else if (sent == 0) {
        resolve_relay(e, ps); /* leaf: merged vote == my own */
    }
}

static void decision_bcast(rlo_engine *e)
{
    rlo_prop *p = &e->own;
    rlo_msg *m = 0;
    /* decision in the vote field, round generation in the payload.
     * Membership rounds append the admission record (MAGIC + joiner/
     * incarnation/epoch) so every member can execute the admission
     * from the decision alone, even if it never saw the proposal
     * (generation readers only unpack the first 4 bytes). */
    uint8_t genb[4 + RLO_MEMBER_MAGIC_LEN + 12];
    int64_t plen = 4;
    put_le32(genb, p->gen);
    if (p->pid <= RLO_MEMBER_PID_BASE && p->payload &&
        p->len <= (int64_t)sizeof(genb) - 4) {
        memcpy(genb + 4, p->payload, (size_t)p->len);
        plen += p->len;
    }
    int rc = bcast_init(e, RLO_TAG_IAR_DECISION, p->pid, p->vote, genb,
                        plen, &m);
    if (rc != RLO_OK) {
        set_err(e, rc);
        return;
    }
    recent_log_push(e, m->frame, RLO_TAG_IAR_DECISION);
    /* retain the decision sends: the proposal completes only once the
     * decision has fanned out (reference :554-566) */
    p->decision_handles = (rlo_handle **)malloc(
        (size_t)(m->n_handles ? m->n_handles : 1) * sizeof(void *));
    if (!p->decision_handles) {
        set_err(e, RLO_ERR_NOMEM);
        return;
    }
    p->n_decision = m->n_handles;
    for (int i = 0; i < m->n_handles; i++) {
        p->decision_handles[i] = m->handles[i];
        m->handles[i]->refs++;
    }
    p->decision_pending = 1;
    rlo_trace_emit(e->rank, RLO_EV_DECISION, p->pid, p->vote, p->gen, 0);
}

/* Drop src from the awaited-children list; 0 if it was not awaited. */
static int await_remove(rlo_prop *p, int src)
{
    for (int i = 0; i < p->n_await; i++)
        if (p->await_from[i] == src) {
            p->await_from[i] = p->await_from[--p->n_await];
            return 1;
        }
    return 0;
}

static void complete_own(rlo_engine *e)
{
    rlo_prop *p = &e->own;
    if (e->p_prop_born != 0)
        /* S10 prop_votes_aggregated: submit -> every awaited vote
         * merged (or discounted); the decision fan-out starts here */
        ph_obs(e, RLO_PH_PROP_VOTES_AGGREGATED, e->p_prop_born);
    if (p->vote)
        /* re-judge: a competing proposal may have changed app state
         * since submission (reference :773) */
        p->vote = eng_judge(e, p->payload, p->len, p->pid);
    decision_bcast(e);
    if (p->pid <= RLO_MEMBER_PID_BASE)
        /* membership round: the admitting proposer executes the
         * admission right after fanning the decision out (the
         * decision itself was routed over the PRE-admission
         * member-only overlay), then welcomes + replays to the
         * joiner (docs/DESIGN.md S8) */
        finish_member_round(e);
}

/* rlo-sentinel: transfers(m) */
static void on_vote(rlo_engine *e, rlo_msg *m)
{
    int pid = m->pid, vote = m->vote;
    int gen = vote_gen(m);
    rlo_prop *p = &e->own;
    /* claim the vote for my own proposal ONLY while it is in progress
     * AND the generations match: a later proposer may legitimately
     * reuse this pid (pid collisions are only forbidden between
     * CONCURRENT proposals, on_proposal errors on those), and a stale
     * vote from an earlier same-pid round must never merge into a
     * newer one */
    if (pid == p->pid && p->state == RLO_IN_PROGRESS && gen == p->gen) {
        /* only votes from still-awaited children count: a vote from a
         * discounted (suspected-dead) child must not advance the count
         * past a live child's pending veto */
        if (await_remove(p, m->src)) {
            p->votes_recved++;
            p->vote &= vote;
            if (p->votes_recved == p->votes_needed)
                complete_own(e);
        }
        msg_free(m);
        return;
    }
    rlo_msg *pm = find_proposal_msg(e, pid, gen);
    if (!pm) {
        if ((pid == p->pid && p->state != RLO_INVALID) ||
            round_settled_peek(e, pid, gen) ||
            e->fd_timeout || e->n_failed)
            ; /* stale round, settled/aborted round, or a membership
                 change; drop */
        else
            set_err(e, RLO_ERR_PROTO);
        msg_free(m);
        return;
    }
    if (!await_remove(pm->ps, m->src)) {
        msg_free(m); /* late/duplicate vote from a discounted child */
        return;
    }
    pm->ps->vote &= vote;
    pm->ps->votes_recved++;
    if (pm->ps->votes_recved == pm->ps->votes_needed)
        resolve_relay(e, pm->ps);
    msg_free(m);
}

/* settled-round dedup: a decision forwarded by a mix of old- and new-
 * topology trees during a view change can reach a rank twice; record
 * (pid, gen) of delivered decisions in a ring and drop repeats — the
 * IAR analogue of the (origin, seq) broadcast dedup. Returns 1 when
 * the round was already settled. */
/* Non-recording membership test of the settled-round ring. */
static int round_settled_peek(const rlo_engine *e, int32_t pid,
                              int32_t gen)
{
    for (int i = 0; i < RLO_SETTLED_LOG; i++)
        if (e->settled[i].pid == pid && e->settled[i].gen == gen &&
            e->settled[i].used)
            return 1;
    return 0;
}

static int round_settled(rlo_engine *e, int32_t pid, int32_t gen)
{
    if (gen < 0)
        return 0; /* ungenerated (foreign/legacy) frame: best-effort */
    if (round_settled_peek(e, pid, gen))
        return 1;
    e->settled[e->settled_pos].pid = pid;
    e->settled[e->settled_pos].gen = gen;
    e->settled[e->settled_pos].used = 1;
    e->settled_pos = (e->settled_pos + 1) % RLO_SETTLED_LOG;
    return 0;
}

/* rlo-sentinel: transfers(m) */
static void on_decision(rlo_engine *e, rlo_msg *m)
{
    if (m->origin == e->rank) {
        /* a re-flooded copy of my own decision (the proposer learns
         * its decision from the vote merge, never from the wire) */
        msg_free(m);
        return;
    }
    if (round_settled(e, m->pid, vote_gen(m))) {
        /* duplicate across a view change: deliver exactly once, but
         * STILL forward — a descendant reachable only through this
         * second tree (its old-view parent died) has no other way to
         * learn the decision. */
        bc_forward_only(e, m);
        return;
    }
    /* first sight: log for view-change re-flooding (parked parent-died
     * rounds depend on the decision surviving any one relay's death) */
    recent_log_push(e, m->frame, RLO_TAG_IAR_DECISION);
    rlo_msg *pm = find_proposal_msg(e, m->pid, vote_gen(m));
    int rc = bc_forward(e, m); /* forward first; delivery below */
    if (rc < 0)
        set_err(e, rc);
    if (m->pid <= RLO_MEMBER_PID_BASE) {
        /* membership round: engine-internal. Execute the admission
         * from the decision's embedded record (works even when this
         * rank never saw the proposal), unpark any relayed round
         * WITHOUT the app action, and never deliver to pickup — but
         * keep tracking the forward handles (docs/DESIGN.md S8). */
        if (pm) {
            pm->ps->state = m->vote ? RLO_COMPLETED : RLO_FAILED;
            q_remove(&e->q_iar_pending, pm);
            msg_free(pm);
        }
        int32_t new_epoch;
        const uint8_t *recs;
        int k = m->len >= 4 ? member_decode(m->payload + 4, m->len - 4,
                                            &new_epoch, &recs)
                            : 0;
        for (int j = 0; j < k; j++) {
            int joiner = get_le32(recs + 8 * j);
            int inc = get_le32(recs + 8 * j + 4);
            if (joiner < 0 || joiner >= e->ws)
                continue;
            e->admitting[joiner] = 0;
            if (e->pending_join[joiner]) {
                e->pending_join[joiner] = 0;
                e->n_pending--;
            }
            if (m->vote &&
                execute_admission(e, joiner, inc, new_epoch) && k > 1)
                e->batched_admits++;
        }
        q_append(&e->q_wait, m);
        return;
    }
    if (pm) {
        if (m->vote && e->action)
            e->action(pm->payload, pm->len, e->action_ctx);
        q_remove(&e->q_iar_pending, pm);
        msg_free(pm);
    }
    /* deliver the decision to the user either way (reference :852-854) */
    q_append(&e->q_pickup, m);
}

int rlo_submit_proposal(rlo_engine *e, const uint8_t *proposal, int64_t len,
                        int pid)
{
    rlo_prop *p = &e->own;
    if (p->state == RLO_IN_PROGRESS)
        return RLO_ERR_BUSY;
    if (len < 0 || len > e->msg_size_max)
        return RLO_ERR_TOO_BIG;
    free(p->payload);
    for (int i = 0; i < p->n_decision; i++)
        rlo_handle_unref(p->decision_handles[i]);
    free(p->decision_handles);
    memset(p, 0, sizeof(*p));
    e->own_deadline = 0; /* the watchdog never outlives its round */
    p->pid = pid;
    /* rank-qualified (counter * world_size + rank) so two proposers
     * reusing one pid can never collide on generation either, with no
     * overflow for any realistic rank or round count */
    p->gen = (++e->gen_counter) * e->ws + e->rank;
    p->vote = 1;
    p->n_await = cur_init_targets(e, p->await_from, 64);
    if (p->n_await < 0)
        return p->n_await;
    p->votes_needed = p->n_await;
    p->state = RLO_IN_PROGRESS;
    p->len = len;
    if (len > 0) {
        p->payload = (uint8_t *)malloc((size_t)len);
        if (!p->payload)
            return RLO_ERR_NOMEM;
        memcpy(p->payload, proposal, (size_t)len);
    }
    if (e->metrics_on)
        e->prop_born = rlo_now_usec();
    if (e->profiler_on)
        e->p_prop_born = now_usec_f();
    rlo_trace_emit(e->rank, RLO_EV_PROPOSAL_SUBMIT, pid, 0, p->gen, 0);
    /* the proposal frame's vote field carries the round generation */
    int rc = bcast_init(e, RLO_TAG_IAR_PROPOSAL, pid, p->gen, proposal,
                        len, 0);
    if (rc != RLO_OK) {
        p->state = RLO_FAILED;
        return rc;
    }
    if (p->votes_needed == 0)
        /* no awaited voters (sole survivor after elastic re-forming):
         * nothing will ever call on_vote — complete immediately */
        complete_own(e);
    rlo_progress_all(e->w);
    if (p->state == RLO_COMPLETED)
        return p->vote;
    return -1;
}

int rlo_check_proposal_state(rlo_engine *e)
{
    rlo_progress_all(e->w);
    return e->own.state;
}

int rlo_vote_my_proposal(rlo_engine *e)
{
    rlo_progress_all(e->w);
    if (e->own.state != RLO_COMPLETED)
        return -1;
    return e->own.vote;
}

void rlo_proposal_reset(rlo_engine *e)
{
    rlo_prop *p = &e->own;
    free(p->payload);
    for (int i = 0; i < p->n_decision; i++)
        rlo_handle_unref(p->decision_handles[i]);
    free(p->decision_handles);
    memset(p, 0, sizeof(*p));
    p->pid = -1;
    p->vote = 1;
    p->state = RLO_INVALID;
}

/* ---------------- failure detection + elastic recovery --------------
 * Mirror of rlo_tpu_torch/engine.py's failure machinery (see rlo_core.h for
 * the contract). Membership changes are not view-synchronous, but
 * BCAST delivery is exactly-once across them for any initiator that
 * survived: (origin, seq) dedup makes twice impossible and the
 * view-change re-flood (reflood_recent) makes zero impossible — for
 * broadcasts within the RLO_RECENT_LOG most recent frames a survivor
 * holds (older evicted frames degrade to at-most-once, as does
 * traffic whose initiator died before handing any survivor a copy). */

static void ring_neighbors(const rlo_engine *e, int *succ, int *pred)
{
    int ws = e->ws;
    int s = -1, p = -1;
    for (int d = 1; d < ws; d++) {
        int r = (e->rank + d) % ws;
        if (!e->failed[r]) {
            s = r;
            break;
        }
    }
    for (int d = 1; d < ws; d++) {
        int r = (e->rank - d % ws + ws) % ws;
        if (!e->failed[r]) {
            p = r;
            break;
        }
    }
    *succ = s;
    *pred = p;
}

static void discount_failed_voter(rlo_engine *e, int rank)
{
    rlo_prop *p = &e->own;
    if (p->state == RLO_IN_PROGRESS && !p->decision_pending &&
        await_remove(p, rank)) {
        p->votes_needed--;
        if (p->votes_recved == p->votes_needed)
            complete_own(e);
    }
    for (rlo_msg *pm = e->q_iar_pending.head; pm; pm = pm->next) {
        if (pm->ps && await_remove(pm->ps, rank)) {
            pm->ps->votes_needed--;
            if (pm->ps->votes_recved == pm->ps->votes_needed)
                resolve_relay(e, pm->ps);
        }
    }
}

static void abort_orphaned_proposals(rlo_engine *e, int rank)
{
    /* relays whose PROPOSER died can never resolve (no decision will
     * ever broadcast): unpark and drop them. Rounds whose vote-tree
     * PARENT died stay parked: the surviving proposer discounts the
     * dead subtree and its decision still reaches this rank through
     * the re-formed overlay, clearing the round (and firing the
     * action) like a healthy one — and the child votes already merged
     * stay live for duplicate parents (mirror of the Python engine's
     * _abort_orphaned_proposals; round-2 advisor finding). */
    for (rlo_msg *pm = e->q_iar_pending.head; pm;) {
        rlo_msg *nm = pm->next;
        if (pm->ps && pm->origin == rank) {
            pm->ps->state = RLO_FAILED;
            q_remove(&e->q_iar_pending, pm);
            msg_free(pm);
        }
        pm = nm;
    }
}

/* Adopt a failure; returns 1 when newly learned (idempotent). */
static int mark_failed(rlo_engine *e, int rank)
{
    if (!e->failed || rank == e->rank || rank < 0 || rank >= e->ws ||
        e->failed[rank])
        return 0;
    int old_succ, old_pred;
    ring_neighbors(e, &old_succ, &old_pred);
    e->failed[rank] = 1;
    e->n_failed++;
    e->view_changes++;
    e->hb_seen[rank] = 0;
    /* every failure adoption bumps the membership epoch; the edge's
     * floor/link-epoch bookkeeping is obsolete — the failed-sender
     * quarantine now covers the rank entirely (docs/DESIGN.md S8) */
    e->epoch++;
    e->epoch_floor[rank] = 0;
    e->link_epoch[rank] = 0;
    /* the certified link-reset record dies with the link: a sync
     * response must never vouch floors for a failed member (S18) */
    e->reset_epoch[rank] = 0;
    if (e->pending_join[rank]) {
        e->pending_join[rank] = 0;
        e->n_pending--;
    }
    /* ARQ: a dead peer will never ack — stop retransmitting at it */
    arq_drop_dst(e, rank);
    e->ack_due[rank] = 0;
    e->tx_skip[rank] = -1;
    if (e->fd_timeout && e->ws - e->n_failed >= 2) {
        int succ, pred;
        ring_neighbors(e, &succ, &pred);
        /* fresh grace only when my predecessor actually changed */
        if (pred >= 0 && pred != old_pred)
            e->hb_seen[pred] = rlo_now_usec();
    }
    discount_failed_voter(e, rank);
    abort_orphaned_proposals(e, rank);
    reflood_recent(e);
    return 1;
}

/* Adopt + announce a failure THIS rank detected (heartbeat silence or
 * ARQ give-up): mark, then tell the world — overlay broadcast AND
 * point-to-point to every alive rank (overlay forwarding can have
 * holes while views are converging; receivers suppress duplicates).
 * The notice's vote field carries the DECLARER's epoch at declaration
 * time: unlike the header link epoch it is immutable through
 * re-floods, so receivers can recognize a stale notice about a rank
 * readmitted since. Returns 0 when the failure was already known. */
static int announce_failed(rlo_engine *e, int rank)
{
    if (!mark_failed(e, rank))
        return 0;
    rlo_msg *fm = 0;
    int rc = bcast_init(e, RLO_TAG_FAILURE, rank, e->epoch, 0, 0, &fm);
    if (rc != RLO_OK)
        set_err(e, rc);
    else if (fm)
        /* declarations join the re-flood log (docs/DESIGN.md S8);
         * admission purges stale notices about the readmitted rank */
        recent_log_push(e, fm->frame, RLO_TAG_FAILURE);
    for (int dst = 0; dst < e->ws; dst++) {
        if (dst == e->rank || e->failed[dst])
            continue;
        rc = eng_isend(e, dst, RLO_TAG_FAILURE, e->rank, rank,
                       e->epoch, 0, 0, 0);
        if (rc != RLO_OK)
            set_err(e, rc);
    }
    return 1;
}

static void declare_failed(rlo_engine *e, int rank)
{
    /* capture the evidence BEFORE mark_failed clears the slot: the
     * last-seen heartbeat age is what makes a false-positive
     * declaration diagnosable after the fact */
    uint64_t now = rlo_now_usec();
    uint64_t age = (rank >= 0 && rank < e->ws && e->hb_seen[rank] &&
                    now > e->hb_seen[rank])
                       ? now - e->hb_seen[rank]
                       : (uint64_t)INT32_MAX;
    if (age > (uint64_t)INT32_MAX)
        age = (uint64_t)INT32_MAX;
    if (!announce_failed(e, rank))
        return;
    if (!getenv("RLO_QUIET"))
        /* suppressible like the Python twin's logging.Logger route */
        fprintf(stderr,
                "rlo_tpu_torch: rank %d declaring rank %d FAILED: no "
                "heartbeat for %.1f ms (timeout %.1f ms, interval "
                "%.1f ms)\n",
                e->rank, rank, (double)age / 1e3,
                (double)e->fd_timeout / 1e3,
                (double)e->fd_interval / 1e3);
    rlo_trace_emit(e->rank, RLO_EV_FAILURE, rank, 1, (int)age, 0);
}

/* rlo-sentinel: transfers(m) */
static void on_failure(rlo_engine *e, rlo_msg *m)
{
    int rank = m->pid;
    int32_t declared = m->vote; /* declarer's epoch (-1 on legacy) */
    if (rank == e->rank) {
        if (declared >= 0 && declared < e->welcome_epoch) {
            msg_free(m); /* pre-rejoin leftover about my old life */
            return;
        }
        /* somebody declared me failed: the group re-formed without me
         * and quarantines my traffic — record the suspicion AND
         * petition for readmission (docs/DESIGN.md S8; rejoin
         * replaces the old "no un-fail protocol" dead end) */
        if (e->suspected_self) {
            msg_free(m); /* duplicate */
            return;
        }
        e->suspected_self = 1;
        int rc0 = bc_forward(e, m);
        if (rc0 < 0) {
            set_err(e, rc0);
            msg_free(m);
        }
        /* rlo-model: edge failure->joiner */
        become_joiner(e);
        return;
    }
    if (declared >= 0 && rank >= 0 && rank < e->ws &&
        declared < e->admit_epoch[rank]) {
        /* stale notice (declared before an admission we already
         * executed): adopting it would flap the fresh member out */
        msg_free(m);
        return;
    }
    if (!mark_failed(e, rank)) {
        msg_free(m); /* already known: suppress the duplicate */
        return;
    }
    rlo_trace_emit(e->rank, RLO_EV_FAILURE, rank, 0, 0, 0);
    int rc = bc_forward(e, m); /* adopt-before-forward ordering */
    if (rc < 0) {
        set_err(e, rc);
        msg_free(m);
    }
}

static void failure_tick(rlo_engine *e)
{
    if (!e->fd_timeout || e->ws - e->n_failed < 2)
        return;
    uint64_t now = rlo_now_usec();
    int succ, pred;
    ring_neighbors(e, &succ, &pred);
    if (succ >= 0 && now - e->hb_last_sent >= e->fd_interval) {
        /* piggyback the cumulative link ACK for the successor: even
         * with no reverse data traffic, its retransmit queue to us
         * drains at heartbeat cadence */
        uint8_t ackb[4];
        int64_t n_ack = 0;
        if (e->arq_rto) {
            put_le32(ackb, (int)e->rx_contig[succ]);
            n_ack = 4;
        }
        eng_isend(e, succ, RLO_TAG_HEARTBEAT, e->rank, -1, -1, ackb,
                  n_ack, 0);
        e->hb_last_sent = now;
        rlo_trace_emit(e->rank, RLO_EV_HEARTBEAT, succ, 0, 0, 0);
    }
    if (pred < 0)
        return;
    if (e->hb_seen[pred] == 0) {
        e->hb_seen[pred] = now; /* grace on first watch */
        return;
    }
    /* hb_seen may sit in the FUTURE for a freshly admitted joiner
     * (admission grace, docs/DESIGN.md S18) — the unsigned subtraction
     * must not underflow into an instant re-declaration */
    if (now > e->hb_seen[pred] && now - e->hb_seen[pred] > e->fd_timeout)
        declare_failed(e, pred);
}

int rlo_engine_enable_failure_detection(rlo_engine *e,
                                        uint64_t timeout_usec,
                                        uint64_t interval_usec)
{
    if (!e || !timeout_usec)
        return RLO_ERR_ARG;
    e->fd_timeout = timeout_usec;
    e->fd_interval = interval_usec ? interval_usec : timeout_usec / 4;
    return RLO_OK;
}

int rlo_engine_enable_arq(rlo_engine *e, uint64_t rto_usec,
                          int max_retries)
{
    /* max_retries capped at 32: the backoff shift must stay defined
     * (and 2^32 * rto is already far beyond any useful horizon) */
    if (!e || !rto_usec || max_retries < 0 || max_retries > 32)
        return RLO_ERR_ARG;
    e->arq_rto = rto_usec;
    e->arq_max_retries = max_retries;
    return RLO_OK;
}

int64_t rlo_engine_arq_retransmits(const rlo_engine *e)
{
    return e->arq_retx;
}

int64_t rlo_engine_arq_dup_drops(const rlo_engine *e)
{
    return e->arq_dup;
}

int64_t rlo_engine_arq_unacked(const rlo_engine *e)
{
    return e->arq_unacked_cnt;
}

int64_t rlo_engine_arq_heap_len(const rlo_engine *e)
{
    return e->arq_heap_len;
}

int64_t rlo_engine_arq_scan_gated(const rlo_engine *e)
{
    return e->arq_gated;
}

int64_t rlo_engine_frames_dispatched(const rlo_engine *e)
{
    return e->frames_dispatched;
}

int64_t rlo_engine_arq_gave_up(const rlo_engine *e)
{
    return e->arq_gaveup;
}

/* ---------------- metrics registry (see rlo_core.h rlo_stats) ------- */

int rlo_engine_enable_metrics(rlo_engine *e, int on)
{
    if (!e)
        return RLO_ERR_ARG;
    e->metrics_on = on ? 1 : 0;
    return RLO_OK;
}

int rlo_engine_stats(const rlo_engine *e, rlo_stats *out)
{
    if (!e || !out)
        return RLO_ERR_ARG;
    memset(out, 0, sizeof(*out));
    out->sent_bcast = e->sent_bcast;
    out->recved_bcast = e->recved_bcast;
    out->total_pickup = e->total_pickup;
    out->ops_failed = 0; /* op deadlines are Python-side (schema parity) */
    out->arq_retransmits = e->arq_retx;
    out->arq_dup_drops = e->arq_dup;
    out->arq_gave_up = e->arq_gaveup;
    out->arq_unacked = e->arq_unacked_cnt;
    out->epoch = e->epoch;
    out->epoch_quarantined = e->quarantined;
    out->rejoins = e->rejoins_cnt;
    out->view_changes = e->view_changes;
    out->reflood_frames = e->reflood_frames;
    out->epoch_lag_max = e->epoch_lag_max;
    out->quar_mid_rejoin = e->quar_mid_rejoin;
    out->quar_failed_sender = e->quar_failed_sender;
    out->quar_below_floor = e->quar_below_floor;
    out->admission_rounds = e->admission_rounds;
    out->epoch_syncs = e->epoch_syncs;
    out->reflood_skipped = e->reflood_skipped;
    out->batched_admits = e->batched_admits;
    out->q_wait = e->q_wait.len;
    out->q_pickup = e->q_pickup.len;
    out->q_wait_and_pickup = e->q_wait_pickup.len;
    out->q_iar_pending = e->q_iar_pending.len;
    out->bcast_complete = e->h_bcast;
    out->proposal_resolve = e->h_prop;
    out->pickup_wait = e->h_pickup;
    return RLO_OK;
}

int rlo_engine_link_stats(const rlo_engine *e, rlo_link_stats *out,
                          int cap)
{
    if (!e || !out || cap < 0)
        return RLO_ERR_ARG;
    int n = cap < e->ws ? cap : e->ws; /* partial fill, per header */
    memcpy(out, e->links, (size_t)n * sizeof(rlo_link_stats));
    return e->ws;
}

/* Engine-originated telemetry digest (docs/DESIGN.md S17): sample the
 * engine's own telemetry into the wire.py TELEM_KEYS order — the
 * rlo_stats counter block, then the extras (link rollups, worst RTT
 * EWMA, queue depth, pickup backlog; the serving page keys are always
 * 0 here — the C engine hosts no paged server) — and delta-encode vs
 * the last digest THIS engine emitted (rlo_telem_encode). */
int64_t rlo_engine_telem_digest(rlo_engine *e, int full, uint8_t *buf,
                                int64_t cap)
{
    if (!e || !buf)
        return RLO_ERR_ARG;
    int64_t v[RLO_TELEM_NKEYS];
    int i = 0;
    v[i++] = e->sent_bcast;
    v[i++] = e->recved_bcast;
    v[i++] = e->total_pickup;
    v[i++] = 0; /* ops_failed: op deadlines are Python-side */
    v[i++] = e->arq_retx;
    v[i++] = e->arq_dup;
    v[i++] = e->arq_gaveup;
    v[i++] = e->arq_unacked_cnt;
    v[i++] = e->epoch;
    v[i++] = e->quarantined;
    v[i++] = e->rejoins_cnt;
    v[i++] = e->view_changes;
    v[i++] = e->reflood_frames;
    v[i++] = e->epoch_lag_max;
    v[i++] = e->quar_mid_rejoin;
    v[i++] = e->quar_failed_sender;
    v[i++] = e->quar_below_floor;
    v[i++] = e->admission_rounds;
    v[i++] = e->epoch_syncs;
    v[i++] = e->reflood_skipped;
    v[i++] = e->batched_admits;
    int64_t tx = 0, rx = 0;
    double rtt = 0.0;
    for (int r = 0; r < e->ws; r++) {
        tx += e->links[r].tx_frames;
        rx += e->links[r].rx_frames;
        if (e->links[r].rtt_ewma_usec > rtt)
            rtt = e->links[r].rtt_ewma_usec;
    }
    v[i++] = tx;
    v[i++] = rx;
    v[i++] = (int64_t)rtt;
    v[i++] = e->q_wait.len;
    v[i++] = e->q_pickup.len + e->q_wait_pickup.len;
    v[i++] = 0; /* pages_in_use */
    v[i++] = 0; /* pages_free */
    v[i++] = 0; /* serve_inflight: the serving fabric is Python-side */
    v[i++] = 0; /* ttft_p50_usec */
    v[i++] = 0; /* ttft_p99_usec */
    v[i++] = 0; /* e2e_p50_usec */
    v[i++] = 0; /* e2e_p99_usec */
    v[i++] = 0; /* coll_steps: tensor collectives are Python-side */
    v[i++] = 0; /* coll_bytes */
    v[i++] = 0; /* remedies_proposed: remediation is Python-side */
    v[i++] = 0; /* remedies_executed */
    v[i++] = 0; /* quarantined */
    v[i++] = 0; /* backpressure_level */
    /* digest seqs are incarnation-partitioned like the broadcast
     * seqs (mirror of TelemetryPlane): re-base on a bumped life and
     * re-anchor receivers with a full snapshot; the first digest of
     * any life is always full */
    uint32_t base = (uint32_t)e->incarnation << 20;
    if (e->telem_seq <= base) {
        if (e->telem_seq < base)
            e->telem_seq = base;
        full = 1;
    }
    /* full_every=8 cadence (mirror of TelemetryPlane's default): a
     * receiver that lost a delta parks the entry as `gap` and ONLY a
     * full snapshot heals it — without the cadence one lost digest
     * would stale this rank in every fleet view for the rest of the
     * run (the base is 8-aligned, so the mod matches Python's) */
    if ((e->telem_seq & 7u) == 0)
        full = 1;
    int64_t n = rlo_telem_encode(buf, cap, e->rank, e->epoch,
                                 e->telem_seq, full, v,
                                 full ? 0 : e->telem_prev);
    if (n < 0)
        return n;
    memcpy(e->telem_prev, v, sizeof(v));
    e->telem_seq++;
    return n;
}

int rlo_engine_enable_profiler(rlo_engine *e, int on)
{
    if (!e)
        return RLO_ERR_ARG;
    e->profiler_on = on ? 1 : 0;
    return RLO_OK;
}

int rlo_engine_phase_stats(const rlo_engine *e, rlo_phase_stats *out)
{
    if (!e || !out)
        return RLO_ERR_ARG;
    *out = e->ph;
    return RLO_OK;
}

int rlo_engine_rank_failed(const rlo_engine *e, int rank)
{
    return e->failed && rank >= 0 && rank < e->ws && e->failed[rank];
}

int rlo_engine_failed_count(const rlo_engine *e)
{
    return e->n_failed;
}

int rlo_engine_suspected_self(const rlo_engine *e)
{
    return e->suspected_self;
}

/* ---------------- membership epochs + elastic rejoin ----------------
 * Mirror of rlo_tpu_torch/engine.py's membership machinery (docs/DESIGN.md
 * S8; see the protocol paragraph in rlo_core.h). Every rank carries a
 * monotone membership epoch; a failed-but-alive rank converges back
 * in by JOIN probes + an IAR admission round over the member set —
 * the rootless op voting on its own membership — finished by a
 * JOIN_WELCOME + recent-broadcast replay. */

static int member_pid(const rlo_engine *e, int joiner)
{
    return RLO_MEMBER_PID_BASE - (joiner * e->ws + e->rank);
}

/* Fail my own in-flight round deterministically (watchdog expiry or
 * entering joiner mode): free the slot, and for a membership round
 * clear the admitting flag so the joiner's next probe re-petitions.
 * Decision-pending rounds are left alone — their completion needs
 * only the local send handles, no inbound frame.
 *
 * Known divergence from the Python twin: no RLO_TAG_ABORT broadcast
 * (the C engine has no ABORT receive path — unknown tags go to app
 * pickup, and leaking engine-internal frames there would be worse).
 * Relays that parked the round are swept by the next successful
 * admission of the same joiner (execute_admission); only a joiner
 * that dies for good leaves its in-flight rounds parked, a bounded
 * retention (no new petitions => no new rounds). */
static void abort_own_round(rlo_engine *e)
{
    rlo_prop *p = &e->own;
    if (p->state != RLO_IN_PROGRESS || p->decision_pending)
        return;
    p->state = RLO_FAILED;
    e->prop_born = 0;
    e->p_prop_born = 0; /* phase timers track successes only */
    e->own_deadline = 0;
    rlo_trace_emit(e->rank, RLO_EV_DECISION, p->pid, -1, p->gen, 0);
    if (p->pid <= RLO_MEMBER_PID_BASE && p->payload) {
        /* aborted admission round: free every batched joiner for a
         * retry (their next JOIN probes re-petition) */
        int32_t new_epoch;
        const uint8_t *recs;
        int k = member_decode(p->payload, p->len, &new_epoch, &recs);
        for (int j = 0; j < k; j++) {
            int joiner = get_le32(recs + 8 * j);
            if (joiner >= 0 && joiner < e->ws)
                e->admitting[joiner] = 0;
        }
    }
}

static int min_alive(const rlo_engine *e)
{
    /* self always counts as alive (failed[rank] is never set) */
    for (int r = 0; r < e->ws; r++)
        if (r == e->rank || !e->failed[r])
            return r;
    return e->rank;
}

static uint64_t join_iv(const rlo_engine *e)
{
    if (e->join_interval)
        return e->join_interval;
    /* the failure detector's heartbeat interval when it is on, else a
     * conservative default for explicit rejoin on detector-less
     * engines (mirror of ProgressEngine.join_interval) */
    return e->fd_interval ? e->fd_interval : 500000;
}

/* Total order on membership views: higher epoch wins, then the side
 * containing the lower rank (disjoint split-brain views always differ
 * there); exact ties break by rank id. Returns 1 when MY view wins
 * against (ep, malive) as reported by `src`. */
static int view_wins(const rlo_engine *e, int32_t ep, int malive,
                     int src)
{
    int my_min = min_alive(e);
    if (e->epoch != ep)
        return e->epoch > ep;
    if (my_min != malive)
        return my_min < malive; /* -min_alive: lower base rank wins */
    return e->rank < src;
}

/* Enter joiner mode: quarantine everything except membership frames
 * and petition for readmission until a JOIN_WELCOME arrives. The
 * full-quarantine gate is what makes the admission's link-sequence
 * reset safe — no stale ACK or old-seq frame can touch the fresh
 * link state. */
static void become_joiner(rlo_engine *e)
{
    if (e->awaiting_welcome)
        return;
    /* my own in-flight round can never resolve once I quarantine
     * everything (its votes would be dropped unread): fail it now
     * and free the slot instead of wedging it forever */
    abort_own_round(e);
    e->awaiting_welcome = 1;
    e->join_last = 0; /* probe immediately */
}

/* (incarnation, epoch, min-alive-rank, petition, member): petition=1
 * marks a JOINER's plea (it has reset itself and quarantines
 * everything) vs a survivor's heal probe at a failed peer; member=1
 * tells dst it is ALIVE in the sender's view — a losing-view receiver
 * then catches up with a Tag.MSYNC view sync instead of a full rejoin
 * (docs/DESIGN.md S18). Old 4-field probes parse as member=0 (full
 * rejoin: status quo). */
static void send_join_probe(rlo_engine *e, int dst)
{
    uint8_t payload[20];
    put_le32(payload, e->incarnation);
    put_le32(payload + 4, e->epoch);
    put_le32(payload + 8, min_alive(e));
    put_le32(payload + 12, e->awaiting_welcome ? 1 : 0);
    put_le32(payload + 16,
             (e->awaiting_welcome ||
              (dst >= 0 && dst < e->ws && e->failed[dst]))
                 ? 0
                 : 1);
    eng_isend(e, dst, RLO_TAG_JOIN, e->rank, -1, -1, payload, 20, 0);
    rlo_trace_emit(e->rank, RLO_EV_JOIN, dst, 1, e->incarnation,
                   e->epoch);
}

/* Drop stale FAILURE notices about `keep`-flagged ranks from the
 * re-flood log: a re-flooded declaration about a readmitted rank
 * would kill the fresh incarnation. */
static void purge_stale_failures_impl(rlo_engine *e,
                                      const uint8_t *target, int rank)
{
    for (int i = 0; i < RLO_RECENT_LOG; i++) {
        rlo_blob *b = e->recent[i];
        if (!b || e->recent_tag[i] != RLO_TAG_FAILURE)
            continue;
        int32_t pid;
        if (rlo_frame_decode(b->data, b->len, 0, &pid, 0, 0, 0) < 0)
            continue;
        if (target ? (pid >= 0 && pid < e->ws && target[pid])
                   : pid == rank) {
            rlo_blob_unref(b);
            e->recent[i] = 0;
        }
    }
}

static void purge_stale_failures(rlo_engine *e, const uint8_t *target)
{
    purge_stale_failures_impl(e, target, -1);
}

static void purge_stale_failure_rank(rlo_engine *e, int rank)
{
    purge_stale_failures_impl(e, 0, rank);
}

/* Adopt an admission decision into the membership view (idempotent):
 * re-form the overlay to include the joiner, raise the epoch to the
 * agreed value, set the joiner's epoch floor (its dead incarnation's
 * frames all fall below it), and clear the RECEIVE-side ARQ window
 * toward the joiner — a restarted joiner's link seqs start at 0,
 * which the old window would misread as duplicates. The send-side
 * seq counter is never reset (monotone for this process's lifetime),
 * so a peer that keeps its window across our reset can never misread
 * our fresh frames as duplicates either. Returns 1 when the admission
 * actually executed (passed the idempotence guard). */
static int execute_admission(rlo_engine *e, int joiner, int inc,
                             int32_t new_epoch)
{
    if (joiner < 0 || joiner >= e->ws || joiner == e->rank ||
        e->sub_excluded[joiner])
        return 0;
    if (new_epoch <= e->admit_epoch[joiner])
        /* stale or duplicate admission artifact (an old decision
         * re-flooded out of a replaced view): executing it would
         * re-run the link reset ONE-SIDED and permanently desync the
         * ARQ windows on that edge */
        return 0;
    e->admit_epoch[joiner] = new_epoch;
    /* a CERTIFIED link-reset epoch (unlike the wholesale welcome
     * inflation of admit_epoch): sync responses built from it can
     * tell a laggard which floor is safe for this member (S18) */
    e->reset_epoch[joiner] = new_epoch;
    if (new_epoch > e->epoch)
        e->epoch = new_epoch;
    if (inc > e->admitted_inc[joiner])
        e->admitted_inc[joiner] = inc;
    e->epoch_floor[joiner] = new_epoch;
    e->link_epoch[joiner] = new_epoch;
    /* clear the receive window even when we never marked the joiner
     * failed ourselves (another member re-declared and re-admitted
     * it; the joiner reset its half at the welcome, so keeping ours
     * would swallow its fresh seqs as duplicates). Our tx seq counter
     * is NOT reset — seq spaces are monotone per process lifetime, so
     * the joiner's window (fresh or kept) never misreads our next
     * frames; the unfillable-hole rule in arq_on_ack re-syncs its
     * cumulative-ACK watermark in one round trip. App-level dedup
     * ((origin, seq) windows + the settled-round ring) keeps delivery
     * exactly-once across the reset. */
    arq_drop_dst(e, joiner);
    e->tx_skip[joiner] = -1;
    e->rx_contig[joiner] = -1;
    memset(&e->rx_mask[(size_t)joiner * RLO_SEEN_WORDS], 0,
           RLO_SEEN_WORDS * sizeof(uint64_t));
    e->ack_due[joiner] = 0;
    /* joiner-liveness grace (S18): a mid-rejoin joiner does not
     * heartbeat until its JOIN_WELCOME (or superseding sync) lands,
     * so a plain now-stamp re-declares it failed whenever the welcome
     * leg outlasts fd_timeout — the self-reinforcing half of the
     * rejoin cascade. Date the stamp into the future by half the
     * admission-round deadline; any accepted frame from the joiner
     * refreshes it to a live stamp. */
    {
        uint64_t grace = 2 * e->fd_timeout;
        uint64_t g2 = 10 * join_iv(e);
        if (g2 > grace)
            grace = g2;
        e->hb_seen[joiner] = rlo_now_usec() + grace;
    }
    /* abandoned concurrent admission rounds for this joiner (their
     * proposer's watchdog fired, or the round wedged in a mixed-view
     * tree) are settled by THIS admission: unpark their parked relays
     * so they don't accumulate across heal churn */
    for (rlo_msg *pm = e->q_iar_pending.head; pm;) {
        rlo_msg *nm = pm->next;
        if (pm->ps && pm->pid <= RLO_MEMBER_PID_BASE &&
            (RLO_MEMBER_PID_BASE - pm->pid) / e->ws == joiner) {
            pm->ps->state = RLO_FAILED;
            q_remove(&e->q_iar_pending, pm);
            msg_free(pm);
        }
        pm = nm;
    }
    purge_stale_failure_rank(e, joiner);
    if (!e->failed[joiner])
        return 1; /* view unchanged (concurrent admitting proposer) */
    e->failed[joiner] = 0;
    e->n_failed--;
    e->rejoins_cnt++;
    e->view_changes++;
    rlo_trace_emit(e->rank, RLO_EV_ADMIT, joiner, e->epoch, inc, 0);
    if (!getenv("RLO_QUIET"))
        fprintf(stderr,
                "rlo_tpu_torch: rank %d admitted rank %d (incarnation %d, "
                "epoch %d)\n",
                e->rank, joiner, inc, (int)e->epoch);
    /* plug forwarding holes across the overlay re-form, exactly like
     * the failure path does */
    reflood_recent(e);
    return 1;
}

static void send_welcome(rlo_engine *e, int joiner, int inc,
                         int32_t new_epoch)
{
    int64_t cap = 12 + 4 * (int64_t)e->ws;
    uint8_t *payload = (uint8_t *)malloc((size_t)cap);
    if (!payload) {
        set_err(e, RLO_ERR_NOMEM);
        return;
    }
    int n = 0;
    for (int r = 0; r < e->ws; r++)
        if (r == e->rank || !e->failed[r])
            put_le32(payload + 12 + 4 * n++, r);
    put_le32(payload, new_epoch);
    put_le32(payload + 4, inc);
    put_le32(payload + 8, n);
    eng_isend(e, joiner, RLO_TAG_JOIN_WELCOME, e->rank, -1, -1, payload,
              12 + 4 * (int64_t)n, 0);
    free(payload);
}

/* Point-to-point replay of the recent-broadcast log to a freshly
 * admitted joiner so it converges on recent traffic (its (origin,
 * seq) dedup absorbs anything it already saw). FAILURE notices AND
 * membership decisions are skipped — the welcome's member list is
 * the authoritative view, and a stale admission decision about a
 * since-re-failed rank would pass the joiner's admit_epoch guard
 * (reset by the welcome) and resurrect the dead rank in its view. */
static void replay_recent(rlo_engine *e, int joiner)
{
    for (int i = 0; i < RLO_RECENT_LOG; i++) {
        rlo_blob *b = e->recent[i];
        if (!b || e->recent_tag[i] == RLO_TAG_FAILURE)
            continue;
        if (e->recent_tag[i] == RLO_TAG_IAR_DECISION) {
            int32_t pid;
            if (rlo_frame_decode(b->data, b->len, 0, &pid, 0, 0,
                                 0) >= 0 &&
                pid <= RLO_MEMBER_PID_BASE)
                continue;
        }
        eng_isend_frame(e, joiner, e->recent_tag[i], b, 0);
    }
}

/* Admitting proposer's epilogue: execute the batch of admissions,
 * then welcome + replay to each joiner. */
static void finish_member_round(rlo_engine *e)
{
    rlo_prop *p = &e->own;
    int32_t new_epoch;
    const uint8_t *recs;
    int k = p->payload
                ? member_decode(p->payload, p->len, &new_epoch, &recs)
                : 0;
    if (!k)
        return;
    for (int j = 0; j < k; j++) {
        int joiner = get_le32(recs + 8 * j);
        if (joiner < 0 || joiner >= e->ws)
            continue;
        e->admitting[joiner] = 0;
        if (e->pending_join[joiner]) {
            e->pending_join[joiner] = 0;
            e->n_pending--;
        }
    }
    if (!p->vote)
        return;
    for (int j = 0; j < k; j++) {
        int joiner = get_le32(recs + 8 * j);
        int inc = get_le32(recs + 8 * j + 4);
        if (joiner < 0 || joiner >= e->ws)
            continue;
        if (execute_admission(e, joiner, inc, new_epoch) && k > 1)
            e->batched_admits++;
        send_welcome(e, joiner, inc, new_epoch);
        replay_recent(e, joiner);
    }
}

/* A JOIN probe/petition arrived: compare view keys. If the sender's
 * view loses and it is failed here, petition to admit it (IAR over
 * the member set). If its view wins, become a joiner ourselves
 * (split-brain heal = mutual rejoin, higher epoch winning). If it
 * probes us while we hold the winning view but consider it alive,
 * answer with our own probe so it petitions us. Does NOT consume m. */
static void on_join(rlo_engine *e, rlo_msg *m)
{
    int src = m->src;
    if (src < 0 || src >= e->ws || src == e->rank ||
        e->sub_excluded[src] || m->len < 16)
        return;
    int inc = get_le32(m->payload);
    int32_t ep = get_le32(m->payload + 4);
    int malive = get_le32(m->payload + 8);
    int petition = get_le32(m->payload + 12);
    /* 5th field (PR-16): dst-is-a-member flag; absent on old 4-field
     * probes, which parse as 0 (full rejoin: status quo) */
    int member = m->len >= 20 ? get_le32(m->payload + 16) : 0;
    rlo_trace_emit(e->rank, RLO_EV_JOIN, src, 0, inc, ep);
    if (e->awaiting_welcome)
        return; /* mid-rejoin ourselves; the winning side sorts us */
    int mine_wins = view_wins(e, ep, malive, src);
    if (e->failed[src]) {
        if (!mine_wins) {
            if (member) {
                /* the winning view still holds me as a member: I am
                 * merely epoch-lagging, not excluded — catch up with
                 * a view-state sync instead of the full rejoin that
                 * used to strand every laggard (S18) */
                request_sync(e, src);
                return;
            }
            /* rlo-model: edge join->joiner */
            become_joiner(e);
            return;
        }
        if (inc < e->admitted_inc[src])
            return; /* stale probe from an already-replaced life */
        if (e->admitting[src] || e->pending_join[src])
            return; /* a round for it is already queued/in flight */
        e->pending_join[src] = 1;
        e->pending_inc[src] = inc;
        e->pending_ep[src] = ep;
        e->n_pending++;
    } else if (!mine_wins) {
        if (member) {
            request_sync(e, src);
            return;
        }
        /* rlo-model: edge join->joiner */
        become_joiner(e);
    } else if (petition) {
        if (inc < e->admitted_inc[src])
            return; /* stale petition from an already-replaced life */
        if (inc == e->admitted_inc[src] && e->reset_epoch[src]) {
            /* sync-supersedes-welcome (S18): this exact life was
             * already admitted here, so its JOIN_WELCOME was lost in
             * flight. The old answer — re-declare it failed and
             * re-admit — was the measured rejoin-cascade amplifier; a
             * view-state sync response carries everything the welcome
             * did and repeats for free on the petition cadence until
             * one lands. */
            msync_serve(e, src);
            return;
        }
        /* a rank we consider ALIVE is petitioning against our winning
         * view: it has reset itself and quarantines our traffic, so
         * it is effectively failed here — adopt + announce that, then
         * run the normal admission (without this, a lone stale-view
         * winner would answer petitions with probes forever and
         * nobody would ever admit anyone) */
        announce_failed(e, src);
        if (inc >= e->admitted_inc[src] && !e->admitting[src]) {
            if (!e->pending_join[src]) {
                e->pending_join[src] = 1;
                e->n_pending++;
            }
            e->pending_inc[src] = inc;
            e->pending_ep[src] = ep;
        }
    } else {
        /* the prober holds a losing view yet thinks we are alive
         * (asymmetric partition): show it the winning view */
        send_join_probe(e, src);
    }
}

/* Wholesale view adoption — the shared core of JOIN_WELCOME and the
 * sync-supersede path (docs/DESIGN.md S18): a certified admission of
 * THIS life at `new_epoch` whose notification reached us either as
 * the welcome itself or as a sync response after the welcome was
 * lost. `mem` is a ws-sized member-flag array (self included).
 * Adopts epoch, member list, fresh link state and heartbeat grace
 * everywhere, per-member epoch floors at the agreed epoch (members
 * only send to us AFTER executing the admission, so everything below
 * the floor is pre-partition leftovers). */
static void adopt_view(rlo_engine *e, int32_t new_epoch,
                       const uint8_t *mem, int inc, int src)
{
    e->awaiting_welcome = 0;
    e->suspected_self = 0;
    if (new_epoch > e->welcome_epoch)
        e->welcome_epoch = new_epoch;
    if (new_epoch > e->epoch)
        e->epoch = new_epoch;
    e->n_failed = 0;
    for (int r = 0; r < e->ws; r++) {
        if (mem[r] && r != e->rank && e->admit_epoch[r] < new_epoch)
            /* members of the adopted view are known-alive at this
             * epoch: FAILURE notices declared below it are stale */
            e->admit_epoch[r] = new_epoch;
        e->failed[r] = (!mem[r] || e->sub_excluded[r]) ? 1 : 0;
        if (r == e->rank)
            e->failed[r] = 0;
        e->n_failed += e->failed[r];
        /* fresh receive state everywhere (skip notices, windows,
         * floors); tx_seq is PRESERVED — seq spaces are monotone per
         * process lifetime, so a member whose matching admission
         * execution was suppressed as stale (its rx watermark intact)
         * still reads our next frames as fresh instead of silently
         * dup-dropping them into a half-dead-link deadlock */
        e->tx_skip[r] = -1;
        e->tx_skip_due[r] = 0;
        e->skip_hold[r] = 0;
        e->ack_due[r] = 0;
        e->rx_contig[r] = -1;
        e->hb_seen[r] = 0;
        int in_view = mem[r] && r != e->rank;
        e->epoch_floor[r] = in_view ? new_epoch : 0;
        e->link_epoch[r] = in_view ? new_epoch : 0;
        /* our pre-adoption link-reset certifications described a view
         * we just replaced wholesale; serving sync floors from them
         * would hand laggards one-sided floors (S18) */
        e->reset_epoch[r] = 0;
        e->sync_req_last[r] = 0;
    }
    memset(e->rx_mask, 0,
           (size_t)e->ws * RLO_SEEN_WORDS * sizeof(uint64_t));
    while (e->rtx_head)
        /* rtx_release keeps the per-dst ack chains and the unacked
         * counter consistent in one place — no companion bookkeeping
         * for the next editor to forget */
        rtx_release(e, e->rtx_head);
    e->hb_last_sent = 0;
    purge_stale_failures(e, mem);
    /* relayed rounds whose proposer is outside the adopted view can
     * never resolve here — unpark them as FAILED (the mirror of
     * abort_orphaned_proposals for the joiner side) */
    for (rlo_msg *pm = e->q_iar_pending.head; pm;) {
        rlo_msg *nm = pm->next;
        if (pm->ps &&
            (pm->origin < 0 || pm->origin >= e->ws || !mem[pm->origin])) {
            pm->ps->state = RLO_FAILED;
            q_remove(&e->q_iar_pending, pm);
            msg_free(pm);
        }
        pm = nm;
    }
    e->rejoins_cnt++;
    e->view_changes++;
    e->join_last = 0;
    /* advertise the log retained across the rejoin: this rank may be
     * the SOLE holder of its old life's entries (e.g. an abort
     * flooded while partitioned alone), and no later view change is
     * guaranteed to occur here — the WANT-side guards
     * (have_log_entry) make stale entries harmless */
    reflood_recent(e);
    rlo_trace_emit(e->rank, RLO_EV_ADMIT, e->rank, e->epoch, inc,
                   src);
    if (!getenv("RLO_QUIET"))
        fprintf(stderr,
                "rlo_tpu_torch: rank %d rejoined at epoch %d (welcomed by "
                "rank %d)\n",
                e->rank, (int)e->epoch, src);
}

/* The admitting proposer's JOIN_WELCOME: validate + adopt its
 * membership view wholesale (adopt_view). The replay of the
 * proposer's recent-broadcast log follows on the same FIFO channel.
 * Does NOT consume m. */
static void on_welcome(rlo_engine *e, rlo_msg *m)
{
    if (m->len < 12)
        return;
    int32_t new_epoch = get_le32(m->payload);
    int inc = get_le32(m->payload + 4);
    int n = get_le32(m->payload + 8);
    if (inc != e->incarnation)
        return; /* welcome addressed to an older life of this rank */
    if (n < 0 || m->len < 12 + 4 * (int64_t)n)
        return;
    if (!e->awaiting_welcome && new_epoch <= e->welcome_epoch)
        /* duplicate/stale welcome (concurrent admitting proposers).
         * Deliberately compared against the last ADOPTED welcome
         * epoch, not e->epoch: our own epoch can outrun the round's
         * agreed epoch via local declarations, and rejecting the
         * welcome then would leave the admitting side's link-state
         * reset one-sided (a permanently desynced ARQ window) — the
         * exact mirror of the members' admit_epoch idempotence rule */
        return;
    uint8_t *mem = (uint8_t *)calloc((size_t)e->ws, 1);
    if (!mem) {
        set_err(e, RLO_ERR_NOMEM);
        return;
    }
    mem[e->rank] = 1;
    for (int i = 0; i < n; i++) {
        int r = get_le32(m->payload + 12 + 4 * i);
        if (r >= 0 && r < e->ws)
            mem[r] = 1;
    }
    /* rlo-model: edge welcome->member */
    adopt_view(e, new_epoch, mem, inc, m->src);
    free(mem);
}

/* -- Tag.MSYNC: view-state sync (docs/DESIGN.md S18) ----------------
 * Byte-compatible with engine.py's MSYNC_REQ/RSP/AD/WANT payloads;
 * ARQ- and epoch-exempt exactly like JOIN, so a lost frame costs
 * latency, never correctness. */

/* Ask an up-to-date peer for a view-state sync: the epoch catch-up
 * path that replaces the full rejoin a laggard used to be stranded
 * into. Rate-limited per destination at the join-probe cadence — the
 * probes that trigger it repeat on the peer's heal-probe cadence, so
 * one outstanding REQ per peer is enough and loss costs one cadence
 * interval, never progress. */
static void request_sync(rlo_engine *e, int dst)
{
    uint64_t now = rlo_now_usec();
    if (e->sync_req_last[dst] &&
        now - e->sync_req_last[dst] < join_iv(e))
        return;
    e->sync_req_last[dst] = now;
    uint8_t payload[9];
    payload[0] = RLO_MSYNC_REQ;
    put_le32(payload + 1, e->epoch);
    put_le32(payload + 5, e->incarnation);
    eng_isend(e, dst, RLO_TAG_MSYNC, e->rank, -1, -1, payload, 9, 0);
}

/* Build + send a MSYNC_RSP: epoch, member records, and the recent-log
 * advert. Per-member records carry only CERTIFIED link-reset epochs
 * (reset_epoch, set solely by execute_admission) — never the
 * wholesale welcome inflation of admit_epoch, which would hand the
 * laggard a one-sided floor for members whose links were never
 * actually reset (S18). */
static void msync_serve(rlo_engine *e, int dst)
{
    if (e->awaiting_welcome)
        return; /* mid-rejoin: nothing certifiable to serve */
    int64_t cap = 9 + 12 * (int64_t)e->ws + 5 + 12 * RLO_RECENT_LOG;
    uint8_t *payload = (uint8_t *)malloc((size_t)cap);
    if (!payload)
        return; /* best-effort: the next petition retries */
    int n = 0;
    int64_t pos = 9;
    for (int r = 0; r < e->ws; r++) {
        if (r != e->rank && e->failed[r])
            continue;
        put_le32(payload + pos, r);
        if (r == e->rank) {
            put_le32(payload + pos + 4, e->welcome_epoch);
            put_le32(payload + pos + 8, e->incarnation);
        } else {
            put_le32(payload + pos + 4, e->reset_epoch[r]);
            put_le32(payload + pos + 8, e->admitted_inc[r]);
        }
        pos += 12;
        n++;
    }
    payload[0] = RLO_MSYNC_RSP;
    put_le32(payload + 1, e->epoch);
    put_le32(payload + 5, n);
    /* embedded advert tail: same [count:i32] + triple body as a
     * standalone MSYNC_AD, minus its kind byte */
    uint8_t ad[5 + 12 * RLO_RECENT_LOG];
    int64_t adlen = advert_payload(e, ad);
    if (adlen > 0) {
        memcpy(payload + pos, ad + 1, (size_t)(adlen - 1));
        pos += adlen - 1;
    } else {
        put_le32(payload + pos, 0);
        pos += 4;
    }
    if (pos + 64 > e->msg_size_max) {
        /* view too large for one frame (pathological world_size):
         * fall back to the full-rejoin path rather than truncate */
        free(payload);
        send_join_probe(e, dst);
        return;
    }
    eng_isend(e, dst, RLO_TAG_MSYNC, e->rank, -1, -1, payload, pos, 0);
    free(payload);
}

/* MSYNC_AD body at `off`: [count:i32] + count x [tag][a][b]
 * recent-log identities. Answer with a WANT naming exactly the
 * entries this rank provably misses; each entry already held is a
 * re-flood frame the old blast would have wasted (reflood_skipped);
 * every read below is dominated by a length guard. */
static void msync_advert(rlo_engine *e, int src, const uint8_t *p,
                         int64_t plen, int64_t off)
{
    if (plen < off + 4)
        return;
    int cnt = get_le32(p + off);
    if (cnt < 0 || plen < off + 4 + 12 * (int64_t)cnt)
        return;
    uint8_t *out = (uint8_t *)malloc((size_t)(5 + 12 * (int64_t)cnt));
    if (!out)
        return;
    int nw = 0;
    for (int i = 0; i < cnt; i++) {
        int32_t t = get_le32(p + off + 4 + 12 * i);
        int32_t a = get_le32(p + off + 4 + 12 * i + 4);
        int32_t b = get_le32(p + off + 4 + 12 * i + 8);
        if (have_log_entry(e, t, a, b)) {
            e->reflood_skipped++;
        } else {
            put_le32(out + 5 + 12 * nw, t);
            put_le32(out + 5 + 12 * nw + 4, a);
            put_le32(out + 5 + 12 * nw + 8, b);
            nw++;
        }
    }
    if (nw) {
        out[0] = RLO_MSYNC_WANT;
        put_le32(out + 1, nw);
        eng_isend(e, src, RLO_TAG_MSYNC, e->rank, -1, -1, out,
                  5 + 12 * (int64_t)nw, 0);
    }
    free(out);
}

/* A WANT reply to our advert: re-send exactly the named recent-log
 * entries (through the ARQ gate, fresh link seqs — a new
 * transmission, not a retransmit; app-level dedup absorbs any
 * crossing duplicates). */
static void msync_want(rlo_engine *e, int src, const uint8_t *p,
                       int64_t plen)
{
    if (plen < 5)
        return;
    int cnt = get_le32(p + 1);
    if (cnt < 0 || plen < 5 + 12 * (int64_t)cnt)
        return;
    for (int i = 0; i < RLO_RECENT_LOG; i++) {
        int32_t t, a, b;
        if (!log_entry_ident(e, i, &t, &a, &b))
            continue;
        for (int j = 0; j < cnt; j++)
            if (get_le32(p + 5 + 12 * j) == t &&
                get_le32(p + 5 + 12 * j + 4) == a &&
                get_le32(p + 5 + 12 * j + 8) == b) {
                e->reflood_frames++;
                eng_isend_frame(e, src, e->recent_tag[i],
                                e->recent[i], 0);
                break;
            }
    }
}

/* A MSYNC_RSP arrived: catch up to the responder's view without a
 * full rejoin. Three cases: (1) the response certifies an admission
 * of THIS life we never saw the welcome for — wholesale adoption,
 * exactly as the welcome would have done (sync-supersedes-welcome);
 * (2) we are a mere epoch laggard — execute the certified per-member
 * admissions we missed and adopt the responder's failures; (3)
 * nothing certifiable heals the link to the responder — fall back to
 * a full rejoin, the pre-S18 status quo, so every sync exchange
 * strictly progresses. */
static void msync_adopt(rlo_engine *e, int src, const uint8_t *p,
                        int64_t plen)
{
    if (plen < 9)
        return;
    int32_t rsp_epoch = get_le32(p + 1);
    int n = get_le32(p + 5);
    if (n < 0 || plen < 9 + 12 * (int64_t)n)
        return;
    /* staleness, judged at ARRIVAL epoch (adoption below may raise
     * it): a response no newer than my view means I progressed past
     * the request in flight — I am not the laggard anymore */
    int stale = rsp_epoch <= e->epoch;
    int64_t ad_off = 9 + 12 * (int64_t)n;
    int32_t my_aep = 0, my_ainc = 0;
    int have_mine = 0;
    for (int i = 0; i < n; i++)
        if (get_le32(p + 9 + 12 * i) == e->rank) {
            my_aep = get_le32(p + 9 + 12 * i + 4);
            my_ainc = get_le32(p + 9 + 12 * i + 8);
            have_mine = 1;
            break;
        }
    if (!have_mine) {
        /* the responder's view does not hold me at all: if it wins,
         * only a full rejoin gets me back in */
        if (rsp_epoch > e->epoch)
            /* rlo-model: edge msync->joiner */
            become_joiner(e);
        return;
    }
    int adopted = 0;
    if (my_ainc == e->incarnation && my_aep > e->welcome_epoch) {
        /* lost-welcome supersede: the responder certifies THIS life
         * was admitted at my_aep but no welcome ever landed — adopt
         * the view wholesale with the welcome's exact semantics
         * (un-wedges awaiting_welcome) */
        uint8_t *mem = (uint8_t *)calloc((size_t)e->ws, 1);
        if (!mem)
            return;
        mem[e->rank] = 1;
        for (int i = 0; i < n; i++) {
            int r = get_le32(p + 9 + 12 * i);
            if (r >= 0 && r < e->ws)
                mem[r] = 1;
        }
        /* rlo-model: edge msync->member */
        adopt_view(e, my_aep, mem, e->incarnation, src);
        free(mem);
        if (rsp_epoch > e->epoch)
            e->epoch = rsp_epoch;
        adopted = 1;
    } else if (e->awaiting_welcome) {
        /* mid-rejoin and the response does not certify this life:
         * keep petitioning — only an admission can help now */
        return;
    } else {
        /* laggard catch-up: execute certified admissions (aep > 0
         * entries only; a zero means "no reset I can vouch for") */
        for (int i = 0; i < n; i++) {
            int r = get_le32(p + 9 + 12 * i);
            int32_t aep = get_le32(p + 9 + 12 * i + 4);
            int ainc = get_le32(p + 9 + 12 * i + 8);
            if (r != e->rank && aep > 0 && r >= 0 && r < e->ws &&
                aep > e->admit_epoch[r] &&
                execute_admission(e, r, ainc, aep))
                adopted = 1;
        }
        if (rsp_epoch > e->epoch) {
            /* adopt the responder's failures: ranks alive here but
             * absent from its strictly-newer view, unless an
             * admission we already executed post-dates it */
            for (int r = 0; r < e->ws; r++) {
                if (r == e->rank || e->failed[r])
                    continue;
                int present = 0;
                for (int i = 0; i < n; i++)
                    if (get_le32(p + 9 + 12 * i) == r) {
                        present = 1;
                        break;
                    }
                if (!present && rsp_epoch > e->admit_epoch[r])
                    mark_failed(e, r);
            }
            if (rsp_epoch > e->epoch)
                e->epoch = rsp_epoch;
            adopted = 1;
        }
    }
    if (e->failed[src]) {
        /* a stale RSP (predates local progress) is dropped, not
         * acted on: becoming a joiner off stale state can wedge the
         * whole fleet in joiner mode (the last member self-demoting
         * leaves no admitter) — my frames at the responder trigger
         * ITS sync or rejoin instead */
        if (stale)
            return;
        /* progress fallback: nothing in the response re-certified
         * the responder's link, so the two views cannot converge by
         * sync alone — full rejoin (status quo ante) */
        /* rlo-model: edge msync->joiner */
        become_joiner(e);
        return;
    }
    if (adopted)
        e->epoch_syncs++;
    if (plen >= ad_off + 4)
        msync_advert(e, src, p, plen, ad_off);
}

/* Dispatch a Tag.MSYNC frame by kind byte. Does NOT consume m;
 * every payload read is dominated by a length guard. */
static void on_msync(rlo_engine *e, rlo_msg *m)
{
    int src = m->src;
    if (src < 0 || src >= e->ws || src == e->rank ||
        e->sub_excluded[src] || m->len < 1)
        return;
    int kind = m->payload[0];
    if (kind == RLO_MSYNC_REQ) {
        if (m->len < 9)
            return;
        if (e->failed[src]) {
            /* can't certify link state toward a rank this view holds
             * failed: show it the winning view so it petitions for
             * readmission instead */
            send_join_probe(e, src);
            return;
        }
        if (get_le32(m->payload + 5) < e->admitted_inc[src])
            return; /* stale REQ from an already-replaced life */
        msync_serve(e, src);
    } else if (kind == RLO_MSYNC_RSP) {
        msync_adopt(e, src, m->payload, m->len);
    } else if (kind == RLO_MSYNC_AD) {
        /* a joiner's dedup state is mid-reset and a failed peer's
         * link is quarantined: neither side can exchange WANTs */
        if (!e->awaiting_welcome && !e->failed[src])
            msync_advert(e, src, m->payload, m->len, 1);
    } else if (kind == RLO_MSYNC_WANT) {
        if (!e->awaiting_welcome && !e->failed[src])
            msync_want(e, src, m->payload, m->len);
    }
}

/* Designated admitter's launch: drain EVERY servable queued petition
 * into one IAR round. Batched admissions (docs/DESIGN.md S18) —
 * under churn the petitions arrive in bursts (every victim of a
 * partition heals at once), and k sequential rounds were the
 * measured admission_rounds amplifier. */
static void launch_admission_round(rlo_engine *e, uint64_t now,
                                   uint64_t iv)
{
    int64_t cap = RLO_MEMBER_MAGIC_LEN + 8 + 8 * (int64_t)e->ws;
    uint8_t *payload = (uint8_t *)malloc((size_t)cap);
    if (!payload)
        return;
    int k = 0, first = -1;
    int32_t max_jep = e->epoch;
    for (int r = 0; r < e->ws; r++) {
        if (!e->pending_join[r])
            continue;
        e->pending_join[r] = 0;
        e->n_pending--;
        if (!e->failed[r] || e->admitting[r])
            continue;
        if (first < 0)
            first = r;
        e->admitting[r] = 1;
        put_le32(payload + RLO_MEMBER_MAGIC_LEN + 8 + 8 * k, r);
        put_le32(payload + RLO_MEMBER_MAGIC_LEN + 12 + 8 * k,
                 e->pending_inc[r]);
        if (e->pending_ep[r] > max_jep)
            max_jep = e->pending_ep[r];
        k++;
    }
    if (k) {
        /* the agreed post-admission epoch: above EVERY side's
         * view, so each joiner's fresh frames clear every
         * member's floor and their old lives' frames never
         * do. The round rides the FIRST joiner's pid slot. */
        int32_t new_epoch = max_jep + 1;
        memcpy(payload, RLO_MEMBER_MAGIC, RLO_MEMBER_MAGIC_LEN);
        put_le32(payload + RLO_MEMBER_MAGIC_LEN, new_epoch);
        put_le32(payload + RLO_MEMBER_MAGIC_LEN + 4, k);
        e->admission_rounds++;
        rlo_submit_proposal(e, payload,
                            RLO_MEMBER_MAGIC_LEN + 8 + 8 * (int64_t)k,
                            member_pid(e, first));
        /* arm the membership watchdog: if the round wedges
         * (mixed-view vote-tree cycle), fail it and let the
         * joiners' next probes retry on the settled view */
        if (e->own.state == RLO_IN_PROGRESS) {
            uint64_t budget = 4 * e->fd_timeout;
            if (20 * iv > budget)
                budget = 20 * iv;
            e->own_deadline = now + budget;
        }
    }
    free(payload);
}

/* Joiner side: petition every potential member at join_interval.
 * Survivor side: launch queued admission rounds once the (single)
 * own-proposal slot frees up, and probe failed-but-maybe-alive peers
 * so a healed partition or silent restart is discovered without any
 * out-of-band signal. */
static void membership_tick(rlo_engine *e)
{
    uint64_t now = rlo_now_usec();
    uint64_t iv = join_iv(e);
    if (e->awaiting_welcome) {
        if (now - e->join_last >= iv) {
            e->join_last = now;
            for (int dst = 0; dst < e->ws; dst++)
                if (dst != e->rank && !e->sub_excluded[dst])
                    send_join_probe(e, dst);
        }
        return;
    }
    /* thundering-herd damper (mirror of ProgressEngine._join_tick,
     * docs/DESIGN.md §14): only the DESIGNATED admitter — the lowest
     * alive rank in my view — launches admission rounds; everyone
     * else keeps the petition queued in case designation shifts. */
    if (e->n_pending && e->own.state != RLO_IN_PROGRESS &&
        min_alive(e) == e->rank)
        launch_admission_round(e, now, iv);
    int probe = 0;
    for (int r = 0; r < e->ws; r++)
        if (e->failed[r] && !e->sub_excluded[r])
            probe = 1;
    if (probe && now - e->join_last >= iv) {
        e->join_last = now;
        for (int r = 0; r < e->ws; r++)
            if (e->failed[r] && !e->sub_excluded[r])
                send_join_probe(e, r);
    }
}

int rlo_engine_set_incarnation(rlo_engine *e, int incarnation)
{
    /* bounded so the shifted base fits the int32 wire fields AFTER
     * the rank-qualification multiply in rlo_submit_proposal
     * (gen = gen_counter * ws + rank; mirror of engine.py's
     * _incarnation_cap — the plain INT32_MAX >> 20 bound would let
     * the multiply overflow signed int, which is UB) */
    if (!e || incarnation < 0 || incarnation < e->incarnation ||
        (int64_t)incarnation >
            ((int64_t)INT32_MAX / e->ws) >> 20)
        return RLO_ERR_ARG;
    e->incarnation = incarnation;
    /* re-partition the broadcast-seq and round-generation spaces so
     * peers' dedup windows never swallow the new life's frames */
    int32_t base = (int32_t)incarnation << 20;
    if (e->bcast_seq < base)
        e->bcast_seq = base;
    if (e->gen_counter < base)
        e->gen_counter = base;
    if (incarnation > 0)
        /* rlo-model: edge restart->joiner */
        become_joiner(e);
    return RLO_OK;
}

int rlo_engine_rejoin(rlo_engine *e)
{
    if (!e)
        return RLO_ERR_ARG;
    int rc = rlo_engine_set_incarnation(e, e->incarnation + 1);
    if (rc != RLO_OK)
        return rc;
    e->join_last = 0;
    rlo_progress_all(e->w);
    return e->incarnation;
}

int64_t rlo_engine_epoch(const rlo_engine *e)
{
    return e->epoch;
}

int64_t rlo_engine_epoch_quarantined(const rlo_engine *e)
{
    return e->quarantined;
}

int64_t rlo_engine_rejoins(const rlo_engine *e)
{
    return e->rejoins_cnt;
}

int rlo_engine_awaiting_welcome(const rlo_engine *e)
{
    return e->awaiting_welcome;
}

/* ---------------- delivery ---------------- */

static int64_t copy_out(rlo_msg *m, int *tag, int *origin, int *pid,
                        int *vote, uint8_t *buf, int64_t cap)
{
    if (m->len > cap)
        return RLO_ERR_TOO_BIG;
    if (tag)
        *tag = m->tag;
    if (origin)
        *origin = m->origin;
    if (pid)
        *pid = m->pid;
    if (vote)
        *vote = m->vote;
    if (m->len > 0)
        memcpy(buf, m->payload, (size_t)m->len);
    return m->len;
}

/* Head deliverable message: still-forwarding messages are eligible
 * first (reference order, RLO_user_pickup_next :938-979). */
static rlo_msg *pickup_head(rlo_engine *e, int *from_wait)
{
    if (e->q_wait_pickup.head) {
        *from_wait = 1;
        return e->q_wait_pickup.head;
    }
    *from_wait = 0;
    return e->q_pickup.head;
}

/* Retire one deliverable message (shared by pickup_next and
 * peek/consume). */
static void pickup_retire(rlo_engine *e, rlo_msg *m, int from_wait)
{
    e->total_pickup++;
    if (m->arrived) {
        /* clamp against a backwards wall-clock step (see arq_on_ack) */
        uint64_t now = rlo_now_usec();
        if (now >= m->arrived)
            hist_obs(&e->h_pickup, (double)(now - m->arrived));
    }
    rlo_trace_emit(e->rank, RLO_EV_DELIVER, m->tag, m->origin,
                   trace_ident(m->tag, m->pid, m->vote), m->src);
    /* span-stamped fabric record? emit the wire-hop span (b = -1
     * marks a hop receipt, not a stage boundary). The trailer check
     * runs only when tracing is on — zero cost on the disabled path. */
    if (rlo_trace_enabled() && m->len >= RLO_SPAN_CTX_SIZE) {
        int32_t gw, sq;
        int st, fl;
        if (rlo_span_decode(m->payload + m->len - RLO_SPAN_CTX_SIZE,
                            RLO_SPAN_CTX_SIZE, &gw, &sq, &st, &fl,
                            0) >= 0)
            rlo_trace_emit(e->rank, RLO_EV_SPAN, st, -1, sq, gw);
    }
    if (m == e->peeked)
        e->peeked = 0;
    if (from_wait) {
        q_remove(&e->q_wait_pickup, m);
        m->pickup_done = 1;
        q_append(&e->q_wait, m); /* keep tracking its forwards */
    } else {
        q_remove(&e->q_pickup, m);
        msg_free(m);
    }
}

/* Which delivery queue currently holds `m` (a progress turn may have
 * moved it from wait_and_pickup to pickup when its forwards finished). */
static int in_wait_pickup(const rlo_engine *e, const rlo_msg *m)
{
    for (const rlo_msg *x = e->q_wait_pickup.head; x; x = x->next)
        if (x == m)
            return 1;
    return 0;
}

int64_t rlo_pickup_next(rlo_engine *e, int *tag, int *origin, int *pid,
                        int *vote, uint8_t *buf, int64_t cap)
{
    double t0 = e->profiler_on ? now_usec_f() : 0;
    int from_wait;
    rlo_msg *m = pickup_head(e, &from_wait);
    if (!m)
        return -1;
    int64_t n = copy_out(m, tag, origin, pid, vote, buf, cap);
    if (n < 0)
        return n;
    pickup_retire(e, m, from_wait);
    if (e->profiler_on)
        ph_obs(e, RLO_PH_PICKUP_DRAIN, t0);
    return n;
}

int64_t rlo_pickup_peek(rlo_engine *e, int *tag, int *origin, int *pid,
                        int *vote, const uint8_t **payload)
{
    int from_wait;
    rlo_msg *m = pickup_head(e, &from_wait);
    if (!m)
        return -1;
    e->peeked = m;
    if (tag)
        *tag = m->tag;
    if (origin)
        *origin = m->origin;
    if (pid)
        *pid = m->pid;
    if (vote)
        *vote = m->vote;
    if (payload)
        *payload = m->payload;
    return m->len;
}

int rlo_pickup_consume(rlo_engine *e)
{
    /* retire exactly the peeked message — a progress turn between peek
     * and consume may have changed the queue heads (or moved the peeked
     * message between delivery queues), and retiring whatever is head
     * now would silently swallow an undelivered message */
    rlo_msg *m = e->peeked;
    if (!m)
        return RLO_ERR_ARG;
    /* the peek/consume pair is one delivery: time the retire leg (the
     * peek already handed the payload out zero-copy) */
    double t0 = e->profiler_on ? now_usec_f() : 0;
    pickup_retire(e, m, in_wait_pickup(e, m));
    if (e->profiler_on)
        ph_obs(e, RLO_PH_PICKUP_DRAIN, t0);
    return RLO_OK;
}

/* ---------------- the gear (reference make_progress_gen :551-641) ------ */

/* One progress turn. max_frames < 0 = unbounded (the historical
 * progress_once); >= 0 caps how many frames the transport drain may
 * poll this turn — the remainder stays queued in FIFO order for the
 * next turn, so budgeted and unbudgeted driving deliver identical
 * sequences. Returns frames polled (the batched entry points slice
 * their budget through this; every polled frame counts, ACKs and
 * quarantined frames included). */
int64_t rlo_engine_progress_budget(rlo_engine *e, int64_t max_frames)
{
    int64_t polled = 0;
    /* (a) my own decision fan-out completion -> proposal COMPLETED */
    rlo_prop *p = &e->own;
    if (p->state == RLO_IN_PROGRESS && p->decision_pending) {
        int done = 1;
        for (int i = 0; i < p->n_decision; i++)
            if (!p->decision_handles[i]->delivered)
                done = 0;
        if (done) {
            p->state = RLO_COMPLETED;
            p->decision_pending = 0;
            e->own_deadline = 0;
            if (e->prop_born) {
                uint64_t now = rlo_now_usec();
                if (now >= e->prop_born)
                    hist_obs(&e->h_prop,
                             (double)(now - e->prop_born));
                e->prop_born = 0;
            }
            if (e->p_prop_born != 0) {
                /* submit -> decision fan-out complete (S10 phase) */
                ph_obs(e, RLO_PH_PROP_DECISION, e->p_prop_born);
                e->p_prop_born = 0;
            }
        }
    }
    if (p->state == RLO_IN_PROGRESS && !p->decision_pending &&
        e->own_deadline && rlo_now_usec() > e->own_deadline)
        abort_own_round(e); /* membership watchdog expired */

    /* (b) drain the transport, dispatch on tag (:569-624) */
    for (;;) {
        if (max_frames >= 0 && polled >= max_frames)
            break; /* frame budget: the rest waits, FIFO intact */
        rlo_wire_node *n = rlo_world_poll(e->w, e->rank, e->comm);
        if (!n)
            break;
        polled++;
        e->frames_dispatched++;
        /* steal the node's frame ref into the message — no copy */
        int err = RLO_ERR_PROTO;
        rlo_msg *m;
        if (e->profiler_on) {
            double t0 = now_usec_f();
            m = msg_from_frame(e->w, n->tag, n->src, n->frame, &err);
            ph_obs(e, RLO_PH_FRAME_DECODE, t0);
        } else {
            m = msg_from_frame(e->w, n->tag, n->src, n->frame, &err);
        }
        rlo_handle_unref(n->handle);
        rlo_pool_free(n);
        if (!m) {
            set_err(e, err);
            continue;
        }
        if (e->metrics_on) {
            if (m->src >= 0 && m->src < e->ws) {
                e->links[m->src].rx_frames++;
                e->links[m->src].rx_bytes += m->frame->len;
            }
            m->arrived = rlo_now_usec();
        }
        /* membership frames cross the boundaries the quarantine below
         * enforces — dispatch them first (docs/DESIGN.md S8) */
        if (m->tag == RLO_TAG_JOIN) {
            on_join(e, m);
            msg_free(m);
            continue;
        }
        if (m->tag == RLO_TAG_JOIN_WELCOME) {
            on_welcome(e, m);
            msg_free(m);
            continue;
        }
        if (m->tag == RLO_TAG_MSYNC) {
            /* epoch-exempt like JOIN: a sync response must reach a
             * mid-rejoin laggard (sync-supersedes-welcome) and a REQ
             * must cross the failed-sender boundary; on_msync guards
             * per kind (docs/DESIGN.md S18) */
            on_msync(e, m);
            msg_free(m);
            continue;
        }
        /* stale-epoch / failed-sender quarantine, BEFORE ACK handling
         * and the ARQ dedup: a dead incarnation's traffic (and
         * everything while this rank is itself mid-rejoin) must not
         * touch link state, liveness, or app state */
        if (e->awaiting_welcome) {
            e->quarantined++;
            e->quar_mid_rejoin++;
            msg_free(m);
            continue;
        }
        if (m->src >= 0 && m->src < e->ws) {
            if (e->failed[m->src]) {
                e->quarantined++;
                e->quar_failed_sender++;
                msg_free(m);
                continue;
            }
            if (e->epoch_floor[m->src] &&
                rlo_frame_epoch(m->frame->data) <
                    e->epoch_floor[m->src]) {
                e->quarantined++;
                e->quar_below_floor++;
                /* stale-sender nack: an ALIVE sender stamping below
                 * our floor missed its one-shot JOIN_WELCOME — show
                 * it the winning view so it re-petitions (no heal
                 * probe fires at it: neither side holds the other
                 * failed). Rate-limited at the probe cadence. */
                uint64_t snow = rlo_now_usec();
                if (snow - e->stale_probe_last[m->src] >= join_iv(e)) {
                    e->stale_probe_last[m->src] = snow;
                    send_join_probe(e, m->src);
                }
                msg_free(m);
                continue;
            }
            /* heal-cost signal (docs/DESIGN.md S17): how far my view
             * epoch has outrun the link-epoch stamp of frames I
             * still ACCEPT (mirror of engine.py's epoch_lag_max) */
            int64_t lag =
                (int64_t)e->epoch - rlo_frame_epoch(m->frame->data);
            if (lag > e->epoch_lag_max)
                e->epoch_lag_max = lag;
        }
        /* ANY accepted frame proves the sender alive — prevents
         * heartbeat starvation when membership views transiently
         * diverge */
        if (e->fd_timeout && m->src >= 0 && m->src < e->ws)
            e->hb_seen[m->src] = rlo_now_usec();
        if (m->tag == RLO_TAG_ACK) {
            if (m->src >= 0 && m->src < e->ws) {
                if (m->vote == -2 && m->pid >= 0)
                    arq_rx_skip(e, m->src, m->pid);
                else
                    arq_on_ack(e, m->src, m->vote);
            }
            msg_free(m);
            continue;
        }
        if (e->arq_rto && !arq_exempt(m->tag) && m->seq >= 0 &&
            m->src >= 0 && m->src < e->ws) {
            /* link-level exactly-once BEFORE tag dispatch: a
             * retransmitted frame must be idempotent everywhere, and
             * its receipt owes the sender a cumulative ACK either way */
            e->ack_due[m->src] = 1;
            if (window_record(&e->rx_contig[m->src],
                              &e->rx_mask[(size_t)m->src * RLO_SEEN_WORDS],
                              m->seq)) {
                e->arq_dup++;
                if (e->metrics_on)
                    e->links[m->src].dup_drops++;
                msg_free(m);
                continue;
            }
        }
        /* S10 tag_dispatch phase: dispatch + handler for one protocol
         * frame (quarantine/ACK/dedup exits above are not counted —
         * they never reach a handler) */
        double t_disp = e->profiler_on ? now_usec_f() : 0;
        switch (m->tag) {
        case RLO_TAG_BCAST: {
            e->recved_bcast++;
            if (bcast_is_dup(e, m)) {
                /* exactly-once: drop, don't re-forward or deliver.
                 * `continue` (not break): a dup drop is not a
                 * dispatch, so no tag_dispatch phase sample — keeps
                 * the profiler counts in lockstep with the Python
                 * engine's `continue` on this path */
                msg_free(m);
                continue;
            }
            recent_log_push(e, m->frame, RLO_TAG_BCAST);
            int rc = bc_forward(e, m);
            if (rc < 0) {
                /* bc_forward only fails before queueing — reclaim */
                set_err(e, rc);
                msg_free(m);
            }
            break;
        }
        case RLO_TAG_IAR_PROPOSAL:
            on_proposal(e, m);
            break;
        case RLO_TAG_IAR_VOTE:
            on_vote(e, m);
            break;
        case RLO_TAG_IAR_DECISION:
            e->recved_bcast++;
            on_decision(e, m);
            break;
        case RLO_TAG_HEARTBEAT:
            /* liveness already refreshed above for any frame; a
             * piggybacked cumulative ACK rides the payload */
            if (e->arq_rto && m->len >= 4 && m->src >= 0 &&
                m->src < e->ws)
                arq_on_ack(e, m->src, (int32_t)vote_gen(m));
            msg_free(m);
            break;
        case RLO_TAG_FAILURE:
            on_failure(e, m);
            break;
        default:
            /* aux tags go straight to pickup */
            m->fwd_done = 1;
            q_append(&e->q_pickup, m);
            break;
        }
        if (e->profiler_on)
            ph_obs(e, RLO_PH_TAG_DISPATCH, t_disp);
    }

    /* (b2) liveness: heartbeat my ring successor, watch my predecessor
     * — suspended while mid-rejoin (a joiner quarantines everything,
     * so its detector would only produce false declarations against
     * peers it cannot hear) */
    if (!e->awaiting_welcome)
        failure_tick(e);

    /* (b2b) membership: JOIN petitions (joiner side), heal probes at
     * failed-but-maybe-alive peers, and queued admission rounds
     * waiting for the own-proposal slot (docs/DESIGN.md S8) */
    if (e->awaiting_welcome || e->n_pending ||
        e->n_failed > e->n_excluded)
        membership_tick(e);

    /* (b3) reliable delivery: retransmit overdue unacked frames,
     * escalate give-ups to the failure detector, then flush the
     * cumulative ACKs this turn's receipts owe */
    if (e->arq_rto) {
        if (e->profiler_on) {
            double t0 = now_usec_f();
            arq_tick(e);
            ph_obs(e, RLO_PH_ARQ_SCAN, t0);
        } else {
            arq_tick(e);
        }
        arq_escalate_gaveup(e);
        arq_flush_acks(e);
    }

    /* (c) wait_and_pickup sweep (:995-1013): forwards done -> deliverable */
    for (rlo_msg *m = e->q_wait_pickup.head; m;) {
        rlo_msg *nm = m->next;
        if (msg_sends_done(m)) {
            m->fwd_done = 1;
            q_remove(&e->q_wait_pickup, m);
            q_append(&e->q_pickup, m);
        }
        m = nm;
    }

    /* (d) wait-only sweep (:1015-1034): completed sends are released */
    for (rlo_msg *m = e->q_wait.head; m;) {
        rlo_msg *nm = m->next;
        if (m->p_born != 0 && !m->first_fwd && msg_any_send_done(m)) {
            /* S10 bcast_first_fwd: init -> the FIRST fan-out send
             * completed; observed once per locally-initiated bcast */
            m->first_fwd = 1;
            ph_obs(e, RLO_PH_BCAST_FIRST_FWD, m->p_born);
        }
        if (msg_sends_done(m)) {
            m->fwd_done = 1;
            if (m->born) {
                /* locally-initiated bcast: init -> fan-out complete */
                uint64_t now = rlo_now_usec();
                if (now >= m->born)
                    hist_obs(&e->h_bcast, (double)(now - m->born));
            }
            if (m->p_born != 0)
                ph_obs(e, RLO_PH_BCAST_ALL_DELIVERED, m->p_born);
            q_remove(&e->q_wait, m);
            msg_free(m);
        }
        m = nm;
    }
    return polled;
}

void rlo_engine_progress_once(rlo_engine *e)
{
    rlo_engine_progress_budget(e, -1);
}

/* Batched single-engine progress (docs/DESIGN.md S13; contract in
 * rlo_core.h): loop turns in C until the budget fills, the deadline
 * expires, or — with no deadline — the first fruitless turn. The
 * world's stepping guard is held through each turn so a judge/action
 * callback initiating a broadcast re-enters as a no-op, exactly as it
 * does inside rlo_progress_all. */
int64_t rlo_engine_progress_n(rlo_engine *e, int64_t max_frames,
                              uint64_t deadline_usec)
{
    if (!e)
        return RLO_ERR_ARG;
    rlo_world *w = e->w;
    if (w->stepping)
        return 0; /* re-entered from a handler: no-op */
    uint64_t end = deadline_usec ? rlo_now_usec() + deadline_usec : 0;
    int64_t total = 0;
    for (;;) {
        w->stepping = 1;
        int64_t got = rlo_engine_progress_budget(
            e, max_frames > 0 ? max_frames - total : -1);
        w->stepping = 0;
        total += got;
        if (max_frames > 0 && total >= max_frames)
            break;
        if (got == 0 && !end)
            break; /* fruitless turn, no poll-wait requested */
        if (end && rlo_now_usec() >= end)
            break;
    }
    return total;
}

/* ---------------- snapshot/restore (see rlo_core.h) ---------------- */

int rlo_engine_state_get(const rlo_engine *e, rlo_engine_state *out)
{
    if (!e || !out)
        return RLO_ERR_ARG;
    if (!rlo_engine_idle(e) || e->own.state == RLO_IN_PROGRESS ||
        e->q_iar_pending.len || e->q_pickup.len || e->q_wait_pickup.len)
        return RLO_ERR_BUSY;
    out->rank = e->rank;
    out->world_size = e->ws;
    out->sent_bcast = e->sent_bcast;
    out->recved_bcast = e->recved_bcast;
    out->total_pickup = e->total_pickup;
    out->prop_pid = e->own.pid;
    out->prop_state = e->own.state;
    out->prop_vote = e->own.vote;
    out->prop_votes_needed = e->own.votes_needed;
    out->prop_votes_recved = e->own.votes_recved;
    out->gen_counter = e->gen_counter;
    out->bcast_seq = e->bcast_seq;
    return RLO_OK;
}

int rlo_engine_state_set(rlo_engine *e, const rlo_engine_state *in)
{
    if (!e || !in)
        return RLO_ERR_ARG;
    if (in->rank != e->rank || in->world_size != e->ws)
        return RLO_ERR_ARG;
    /* state_get can only ever emit settled states — an IN_PROGRESS (or
     * out-of-range) snapshot is corrupt and would wedge the engine */
    if (in->prop_state != RLO_COMPLETED && in->prop_state != RLO_FAILED &&
        in->prop_state != RLO_INVALID)
        return RLO_ERR_ARG;
    e->sent_bcast = in->sent_bcast;
    e->recved_bcast = in->recved_bcast;
    e->total_pickup = in->total_pickup;
    e->own.pid = in->prop_pid;
    e->own.state = in->prop_state;
    e->own.vote = in->prop_vote;
    e->own.votes_needed = in->prop_votes_needed;
    e->own.votes_recved = in->prop_votes_recved;
    /* never rewind below the incarnation base: a restarted process
     * that set a fresh incarnation BEFORE restoring a pre-crash
     * snapshot would otherwise reissue its dead life's (pid, gen)
     * and bcast seqs, which peers' dedup windows silently swallow */
    int32_t inc_base = (int32_t)e->incarnation << 20;
    e->gen_counter =
        in->gen_counter < inc_base ? inc_base : in->gen_counter;
    e->bcast_seq = in->bcast_seq < inc_base ? inc_base : in->bcast_seq;
    return RLO_OK;
}

/* ---------------- introspection ---------------- */

int rlo_engine_idle(const rlo_engine *e)
{
    /* with ARQ enabled, unacked reliable frames are outstanding work:
     * an idle engine's sends are acknowledged, not merely handed off */
    return e->q_wait.len == 0 && e->q_wait_pickup.len == 0 &&
           !e->own.decision_pending && e->rtx_head == 0;
}

int rlo_engine_err(const rlo_engine *e)
{
    return e->err;
}

int rlo_engine_set_fanout(rlo_engine *e, int mode)
{
    if (!e || (mode != RLO_FANOUT_SKIP_RING && mode != RLO_FANOUT_FLAT))
        return RLO_ERR_ARG;
    /* schedule switches only between settled rounds: frames already in
     * flight were routed (and their votes counted) under the old shape */
    if (!rlo_engine_idle(e) || e->own.state == RLO_IN_PROGRESS ||
        e->q_iar_pending.len)
        return RLO_ERR_BUSY;
    e->fanout = mode;
    return RLO_OK;
}

int64_t rlo_engine_total_pickup(const rlo_engine *e)
{
    return e->total_pickup;
}

int64_t rlo_engine_sent_bcast(const rlo_engine *e)
{
    return e->sent_bcast;
}

int64_t rlo_engine_recved_bcast(const rlo_engine *e)
{
    return e->recved_bcast;
}
