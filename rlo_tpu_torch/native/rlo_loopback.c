/* In-process loopback transport world: N ranks in one address space.
 *
 * Native counterpart of rlo_tpu_torch/transport/loopback.py. The reference has no
 * equivalent — its tests need mpirun even on one host (SURVEY.md §4).
 * Guarantees mirror MPI and the Python loopback: per-(src,dst,comm) FIFO
 * order even under latency injection, reliable delivery, unspecified
 * cross-pair order (which the seeded latency deliberately perturbs).
 *
 * Single-threaded by design: the engine model is cooperative polling
 * (reference rootless_ops.h:216 documents thread-unsafety; we keep the
 * model and make it explicit).
 */
#include "rlo_internal.h"

/* per-(src,dst,comm) FIFO of frames still "in flight" */
typedef struct rlo_channel {
    struct rlo_channel *next;      /* global list: pump/teardown order */
    struct rlo_channel *pair_next; /* per-(src,dst) lookup chain */
    int src, dst, comm;
    rlo_wire_node *head, *tail;
} rlo_channel;

typedef struct rlo_loop_world {
    rlo_world base;
    int latency;
    uint64_t rng;
    uint64_t tick;
    int64_t sent_cnt, delivered_cnt;
    /* frames currently in flight or waiting in an inbox — kept live
     * so quiescent() is O(1) (docs/DESIGN.md S13: the batched
     * progress loop and the drain spin consult it every sweep; the
     * historical walk was O(channels + ranks) per call) */
    int64_t pending;
    rlo_channel *channels;
    rlo_channel **pair_idx; /* ws*ws buckets: O(1) channel lookup
                             * (the linear scan of `channels` was the
                             * hottest line under batched progress) */
    rlo_wire_node **inbox_head; /* per-rank delivered FIFO */
    rlo_wire_node **inbox_tail;
    uint8_t *dead;  /* fault injection: killed ranks */
    int *drops;     /* fault injection: per (src*ws+dst) pending drops */
    int *dups;      /* fault injection: per (src*ws+dst) pending dups */
    int *pgroup;    /* fault injection: partition group per rank
                     * (NULL = no partition); frames crossing groups
                     * are dropped at send time */
} rlo_loop_world;

static uint64_t xorshift64(uint64_t *s)
{
    uint64_t x = *s;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    return *s = x;
}

/* rlo-sentinel: transfers(n) */
static void free_node(rlo_wire_node *n)
{
    rlo_handle_unref(n->handle);
    rlo_blob_unref(n->frame);
    rlo_pool_free(n);
}

static void loop_free(rlo_world *base)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    for (rlo_channel *c = w->channels; c;) {
        rlo_channel *nc = c->next;
        for (rlo_wire_node *n = c->head; n;) {
            rlo_wire_node *nn = n->next;
            free_node(n);
            n = nn;
        }
        free(c);
        c = nc;
    }
    for (int r = 0; r < base->world_size; r++) {
        for (rlo_wire_node *n = w->inbox_head[r]; n;) {
            rlo_wire_node *nn = n->next;
            free_node(n);
            n = nn;
        }
    }
    free(w->pair_idx);
    free(w->inbox_head);
    free(w->inbox_tail);
    free(w->dead);
    free(w->drops);
    free(w->dups);
    free(w->pgroup);
    free(base->engines);
    rlo_pool_drain(base);
    free(w);
}

static int64_t loop_sent(const rlo_world *base)
{
    return ((const rlo_loop_world *)base)->sent_cnt;
}

static int64_t loop_delivered(const rlo_world *base)
{
    return ((const rlo_loop_world *)base)->delivered_cnt;
}

static int loop_quiescent(const rlo_world *base)
{
    return ((const rlo_loop_world *)base)->pending == 0;
}

/* rlo-sentinel: transfers(n) — the inbox owns it until polled */
static void inbox_push(rlo_loop_world *w, rlo_wire_node *n)
{
    n->next = 0;
    if (w->inbox_tail[n->dst])
        w->inbox_tail[n->dst]->next = n;
    else
        w->inbox_head[n->dst] = n;
    w->inbox_tail[n->dst] = n;
    n->handle->delivered = 1;
    w->delivered_cnt++;
}

static rlo_channel *get_channel(rlo_loop_world *w, int src, int dst,
                                int comm)
{
    rlo_channel **bucket =
        &w->pair_idx[src * w->base.world_size + dst];
    for (rlo_channel *c = *bucket; c; c = c->pair_next)
        if (c->comm == comm)
            return c;
    rlo_channel *c = (rlo_channel *)calloc(1, sizeof(*c));
    if (!c)
        return 0;
    c->src = src;
    c->dst = dst;
    c->comm = comm;
    c->next = w->channels; /* same global order as the historical scan */
    w->channels = c;
    c->pair_next = *bucket;
    *bucket = c;
    return c;
}

static int loop_isend(rlo_world *base, int src, int dst, int comm, int tag,
                      rlo_blob *frame, rlo_handle **out)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    if (dst < 0 || dst >= base->world_size || !frame || frame->len < 0)
        return RLO_ERR_ARG;
    if (w->dead[src] || w->dead[dst] ||
        (w->pgroup && w->pgroup[src] != w->pgroup[dst]) ||
        w->drops[src * base->world_size + dst] > 0) {
        /* a dead host's packets never leave it; packets to a dead host
         * (or hit by loss injection) vanish — the handle completes
         * done-but-failed so the sender's queues drain */
        if (w->drops[src * base->world_size + dst] > 0)
            w->drops[src * base->world_size + dst]--;
        if (out) {
            rlo_handle *h = rlo_handle_new_w(base, 1);
            if (!h)
                return RLO_ERR_NOMEM;
            h->delivered = 1;
            h->failed = 1;
            *out = h;
        }
        return RLO_OK;
    }
    int dup = 0;
    if (w->dups[src * base->world_size + dst] > 0) {
        w->dups[src * base->world_size + dst]--;
        dup = 1; /* duplication injection: deliver this frame twice */
    }
    int caller_tracks = out != 0;
    rlo_handle *h = rlo_handle_new_w(base, caller_tracks ? 2 : 1);
    rlo_wire_node *n =
        (rlo_wire_node *)rlo_pool_alloc(base, sizeof(*n));
    if (!h || !n) {
        rlo_pool_free(h);
        rlo_pool_free(n);
        return RLO_ERR_NOMEM;
    }
    n->next = 0;
    n->src = src;
    n->dst = dst;
    n->tag = tag;
    n->comm = comm;
    n->handle = h;
    n->frame = rlo_blob_ref(frame); /* zero-copy in-process delivery */
    w->sent_cnt++;
    for (int copy = 0; copy <= dup; copy++) {
        if (copy == 1) {
            /* duplication injection: a second node sharing the frame
             * blob, with its own (untracked) completion handle */
            rlo_wire_node *n2 =
                (rlo_wire_node *)rlo_pool_alloc(base, sizeof(*n2));
            rlo_handle *h2 = rlo_handle_new_w(base, 1);
            if (!n2 || !h2) { /* injection is best-effort: skip */
                rlo_pool_free(n2);
                rlo_pool_free(h2);
                break;
            }
            *n2 = *n;
            n2->next = 0;
            n2->handle = h2;
            n2->frame = rlo_blob_ref(frame);
            n = n2;
        }
        if (w->latency <= 0) {
            inbox_push(w, n);
        } else {
            n->due =
                w->tick + xorshift64(&w->rng) % (uint64_t)(w->latency + 1);
            rlo_channel *c = get_channel(w, src, dst, comm);
            if (!c) {
                /* free_node drops the NODE's handle ref only; on this
                 * error return *out is never set, so the ref reserved
                 * for the caller must be dropped here too or a
                 * tracked send leaks its handle (rlo-sentinel S3
                 * audit, round 15) */
                free_node(n);
                if (caller_tracks)
                    rlo_handle_unref(h);
                return RLO_ERR_NOMEM;
            }
            if (c->tail)
                c->tail->next = n;
            else
                c->head = n;
            c->tail = n;
            n->next = 0;
        }
        w->pending++; /* enqueued (inbox or channel): in flight */
    }
    if (out)
        *out = h;
    /* rlo-sentinel: trusted — the copy loop runs at least once
     * (copy = 0 <= dup), so every node was pushed or freed above;
     * the zero-iteration path the CFG sees is infeasible */
    return RLO_OK;
}

static int loop_drop_next(rlo_world *base, int src, int dst, int count)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    if (src < 0 || src >= base->world_size || dst < 0 ||
        dst >= base->world_size || count < 0)
        return RLO_ERR_ARG;
    w->drops[src * base->world_size + dst] += count;
    return RLO_OK;
}

static int loop_dup_next(rlo_world *base, int src, int dst, int count)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    if (src < 0 || src >= base->world_size || dst < 0 ||
        dst >= base->world_size || count < 0)
        return RLO_ERR_ARG;
    w->dups[src * base->world_size + dst] += count;
    return RLO_OK;
}

/* Group partition: sends crossing the cut vanish (handles complete
 * done-but-failed); frames already in flight across the cut are
 * dropped too, like a link going dark. NULL group_of = heal. */
static int loop_partition(rlo_world *base, const int *group_of, int n)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    if (!group_of) {
        free(w->pgroup);
        w->pgroup = 0;
        return RLO_OK;
    }
    if (n != base->world_size)
        return RLO_ERR_ARG;
    if (!w->pgroup) {
        w->pgroup = (int *)malloc((size_t)n * sizeof(int));
        if (!w->pgroup)
            return RLO_ERR_NOMEM;
    }
    memcpy(w->pgroup, group_of, (size_t)n * sizeof(int));
    for (rlo_channel *c = w->channels; c; c = c->next) {
        if (w->pgroup[c->src] == w->pgroup[c->dst])
            continue;
        for (rlo_wire_node *nd = c->head; nd;) {
            rlo_wire_node *nn = nd->next;
            nd->handle->delivered = 1;
            nd->handle->failed = 1;
            free_node(nd);
            w->pending--;
            nd = nn;
        }
        c->head = c->tail = 0;
    }
    return RLO_OK;
}

/* Revive a killed rank's endpoint (empty inbox; the harness builds a
 * fresh engine with a bumped incarnation on top). */
static int loop_revive(rlo_world *base, int rank)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    if (rank < 0 || rank >= base->world_size)
        return RLO_ERR_ARG;
    w->dead[rank] = 0;
    for (rlo_wire_node *n = w->inbox_head[rank]; n;) {
        rlo_wire_node *nn = n->next;
        free_node(n);
        w->pending--;
        n = nn;
    }
    w->inbox_head[rank] = w->inbox_tail[rank] = 0;
    return RLO_OK;
}

/* Move every due channel head to its inbox. Only heads can become due,
 * which preserves per-channel FIFO under latency injection. */
static void pump(rlo_loop_world *w)
{
    w->tick++;
    for (rlo_channel *c = w->channels; c; c = c->next) {
        while (c->head && c->head->due <= w->tick) {
            rlo_wire_node *n = c->head;
            c->head = n->next;
            if (!c->head)
                c->tail = 0;
            inbox_push(w, n);
        }
    }
}

static int loop_kill_rank(rlo_world *base, int rank)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    if (rank < 0 || rank >= base->world_size)
        return RLO_ERR_ARG;
    w->dead[rank] = 1;
    /* drop frames in flight to or from the dead rank */
    for (rlo_channel *c = w->channels; c; c = c->next) {
        if (c->src != rank && c->dst != rank)
            continue;
        for (rlo_wire_node *n = c->head; n;) {
            rlo_wire_node *nn = n->next;
            n->handle->delivered = 1;
            n->handle->failed = 1;
            free_node(n);
            w->pending--;
            n = nn;
        }
        c->head = c->tail = 0;
    }
    for (rlo_wire_node *n = w->inbox_head[rank]; n;) {
        rlo_wire_node *nn = n->next;
        free_node(n);
        w->pending--;
        n = nn;
    }
    w->inbox_head[rank] = w->inbox_tail[rank] = 0;
    return RLO_OK;
}

/* Dead-time skip for the batched progress loop (rlo_internal.h
 * `advance`): jump the tick clock straight to the earliest due frame
 * and move every head due by then — identical per-channel FIFO and the
 * same cross-channel walk order as pump(), just without burning one
 * poll per empty tick. */
static int64_t loop_advance(rlo_world *base)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    uint64_t min_due = 0;
    int have = 0;
    for (rlo_channel *c = w->channels; c; c = c->next)
        if (c->head && (!have || c->head->due < min_due)) {
            min_due = c->head->due;
            have = 1;
        }
    if (!have)
        return 0;
    if (min_due > w->tick)
        w->tick = min_due;
    int64_t moved = 0;
    for (rlo_channel *c = w->channels; c; c = c->next) {
        while (c->head && c->head->due <= w->tick) {
            rlo_wire_node *n = c->head;
            c->head = n->next;
            if (!c->head)
                c->tail = 0;
            inbox_push(w, n);
            moved++;
        }
    }
    return moved;
}

/* Direct delivery for rlo_world_inject: bypasses latency and fault
 * injection so a DEAD rank can source a stale frame (the quarantine
 * scenarios) — only a dead destination rejects, its inbox is gone.
 * Mirrors LoopbackWorld.inject: delivered_cnt counts it, sent_cnt
 * does not (it never crossed a channel). */
static int loop_inject(rlo_world *base, int src, int dst, int comm,
                       int tag, rlo_blob *frame)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    if (w->dead[dst])
        return RLO_ERR_ARG;
    rlo_handle *h = rlo_handle_new_w(base, 1);
    rlo_wire_node *n =
        (rlo_wire_node *)rlo_pool_alloc(base, sizeof(*n));
    if (!h || !n) {
        rlo_pool_free(h);
        rlo_pool_free(n);
        return RLO_ERR_NOMEM;
    }
    n->next = 0;
    n->src = src;
    n->dst = dst;
    n->tag = tag;
    n->comm = comm;
    n->due = 0;
    n->handle = h;
    n->frame = rlo_blob_ref(frame);
    w->pending++;
    inbox_push(w, n);
    return RLO_OK;
}

static rlo_wire_node *loop_poll(rlo_world *base, int rank, int comm)
{
    rlo_loop_world *w = (rlo_loop_world *)base;
    if (w->dead[rank])
        return 0;
    pump(w);
    rlo_wire_node *prev = 0;
    for (rlo_wire_node *n = w->inbox_head[rank]; n;
         prev = n, n = n->next) {
        if (n->comm != comm)
            continue;
        if (prev)
            prev->next = n->next;
        else
            w->inbox_head[rank] = n->next;
        if (w->inbox_tail[rank] == n)
            w->inbox_tail[rank] = prev;
        n->next = 0;
        w->pending--; /* handed to the engine */
        return n;
    }
    return 0;
}

static const rlo_transport_ops LOOP_OPS = {
    .name = "loopback",
    .isend = loop_isend,
    .poll = loop_poll,
    .quiescent = loop_quiescent,
    .sent_cnt = loop_sent,
    .delivered_cnt = loop_delivered,
    .drain = rlo_drain_local,
    .kill_rank = loop_kill_rank,
    .drop_next = loop_drop_next,
    .dup_next = loop_dup_next,
    .partition = loop_partition,
    .revive = loop_revive,
    .free_ = loop_free,
    .advance = loop_advance,
    .inject = loop_inject,
};

rlo_world *rlo_world_new(int world_size, int latency, uint64_t seed)
{
    if (world_size < 2) /* reference rejects at bcomm_init :1464 */
        return 0;
    rlo_loop_world *w = (rlo_loop_world *)calloc(1, sizeof(*w));
    if (!w)
        return 0;
    w->base.ops = &LOOP_OPS;
    w->base.world_size = world_size;
    w->base.my_rank = -1; /* hosts every rank */
    w->latency = latency;
    w->rng = seed ? seed : 0x9e3779b97f4a7c15ull;
    w->inbox_head =
        (rlo_wire_node **)calloc((size_t)world_size, sizeof(void *));
    w->inbox_tail =
        (rlo_wire_node **)calloc((size_t)world_size, sizeof(void *));
    w->dead = (uint8_t *)calloc((size_t)world_size, 1);
    w->drops = (int *)calloc((size_t)world_size * world_size, sizeof(int));
    w->dups = (int *)calloc((size_t)world_size * world_size, sizeof(int));
    w->pair_idx = (rlo_channel **)calloc(
        (size_t)world_size * world_size, sizeof(void *));
    if (!w->inbox_head || !w->inbox_tail || !w->dead || !w->drops ||
        !w->dups || !w->pair_idx) {
        free(w->pair_idx);
        free(w->inbox_head);
        free(w->inbox_tail);
        free(w->dead);
        free(w->drops);
        free(w->dups);
        free(w);
        return 0;
    }
    return &w->base;
}
