/* Engine-substrate ring data collectives over the transport vtable.
 *
 * C counterpart of the Python coroutine collectives
 * (rlo_tpu_torch/ops/collectives.py:183-259): ring reduce-scatter +
 * all-gather allreduce (bandwidth-optimal, 2*(ws-1) rounds of
 * 1/ws-sized chunks), the ring halves exposed directly, a rotation
 * all-to-all, and a dissemination barrier — generalizing the
 * reference's single-bit vote merge (vote &= v, rootless_ops.c:1060)
 * to tensor payloads, as BASELINE.json's config-1 op set requires.
 * These replace the O(ws^2) every-rank-broadcasts-everything
 * data-collective fallback in the Native/Mpi backend facades.
 *
 * Execution model mirrors the Python generators: since C has no
 * coroutines, each op is an explicit state machine — `*_start` arms
 * it, `rlo_coll_poll` advances one bounded slice (send at most one
 * frame, consume at most one arrival) and returns 1 when complete.
 * One process per rank spins its own poll (shm/mpi transports); a
 * single-process driver (loopback worlds, rlo_bench) round-robins
 * polls across ranks exactly like run_collectives().
 *
 * Message matching is the Python scheme verbatim: every phase draws a
 * fresh op id (frame pid) and stamps the round in the frame vote;
 * out-of-order arrivals park in a per-coll pending list until their
 * (src, opid, round) is awaited. A coll object owns a transport comm
 * id — it must differ from every engine's comm on the same world (the
 * world inbox is demultiplexed by comm).
 */
#include "rlo_internal.h"

#include <sched.h>
#include <string.h>

typedef struct coll_pend {
    struct coll_pend *next;
    int src;
    int32_t pid, vote;
    rlo_blob *frame;       /* owned ref */
    const uint8_t *payload;
    int64_t len;
} coll_pend;

/* op kinds */
enum {
    COLL_NONE = 0,
    COLL_ALLREDUCE,
    COLL_REDUCE_SCATTER,
    COLL_ALL_GATHER,
    COLL_ALL_TO_ALL,
    COLL_BARRIER,
};

/* phases of the ring ops */
enum { PH_RS = 0, PH_AG, PH_ROT, PH_DONE };

struct rlo_coll {
    rlo_world *w;
    int rank, ws, comm;
    /* sub-communicator support: ring/slot math runs on VIRTUAL ranks
     * 0..ws-1 (vrank = this rank's ring position); for subsets
     * (sub=1, <= 64 members) transport endpoints map through real[],
     * full-world contexts use identity arithmetic at ANY world size */
    int vrank;
    int sub;
    int real[64];
    int next_opid;
    coll_pend *pend;

    /* armed op state */
    int kind, op, phase, step, sent;
    int opid;               /* opid of the current phase */
    int64_t count;          /* caller elements (fp32 ops) */
    int64_t chunk;          /* elements per ring chunk (padded) */
    float *fbuf;            /* ws*chunk staging (fp32 ops) */
    float *fout;            /* caller output (allreduce: in-place) */
    int64_t blen;           /* bytes per slot (byte ops) */
    uint8_t *bbuf;          /* ws*blen staging (byte ops) */
    uint8_t *bout;          /* caller output (byte ops) */
};

rlo_coll *rlo_coll_new(rlo_world *w, int rank, int comm)
{
    if (!w || rank < 0 || rank >= rlo_world_size(w))
        return 0;
    if (rlo_world_my_rank(w) >= 0 && rank != rlo_world_my_rank(w))
        return 0;
    rlo_coll *c = (rlo_coll *)calloc(1, sizeof(*c));
    if (!c)
        return 0;
    c->w = w;
    c->rank = rank;
    c->ws = rlo_world_size(w);
    c->comm = comm;
    c->vrank = rank; /* full-world: endpoints are identity (endp) */
    return c;
}

/* virtual ring position -> real transport endpoint */
static int endp(const rlo_coll *c, int v)
{
    return c->sub ? c->real[v] : v;
}

rlo_coll *rlo_coll_new_sub(rlo_world *w, int rank, int comm,
                           const int *members, int n_members)
{
    if (!members || n_members < 2 || n_members > 64 ||
        n_members > rlo_world_size(w))
        return 0;
    int vr = -1;
    for (int i = 0; i < n_members; i++) {
        if (members[i] < 0 || members[i] >= rlo_world_size(w))
            return 0;
        for (int j = 0; j < i; j++)
            if (members[j] == members[i])
                return 0; /* duplicate member: the ring could never
                             complete (two positions, one rank) */
        if (members[i] == rank)
            vr = i;
    }
    if (vr < 0)
        return 0;
    rlo_coll *c = rlo_coll_new(w, rank, comm);
    if (!c)
        return 0;
    c->ws = n_members;
    c->vrank = vr;
    c->sub = 1;
    for (int i = 0; i < n_members; i++)
        c->real[i] = members[i];
    return c;
}

void rlo_coll_free(rlo_coll *c)
{
    if (!c)
        return;
    for (coll_pend *p = c->pend; p;) {
        coll_pend *np = p->next;
        rlo_blob_unref(p->frame);
        free(p);
        p = np;
    }
    free(c->fbuf);
    free(c->bbuf);
    free(c);
}

/* ---------------- plumbing ---------------- */

static int coll_send(rlo_coll *c, int dst, int32_t opid, int32_t rnd,
                     const void *data, int64_t len)
{
    rlo_blob *b = rlo_blob_new(RLO_HEADER_SIZE + len);
    if (!b)
        return RLO_ERR_NOMEM;
    if (rlo_frame_encode(b->data, b->len, c->rank, opid, rnd, -1,
                         (const uint8_t *)data, len) < 0) {
        rlo_blob_unref(b);
        return RLO_ERR_PROTO;
    }
    int rc = rlo_world_isend(c->w, c->rank, dst, c->comm, RLO_TAG_DATA,
                             b, 0);
    rlo_blob_unref(b);
    return rc;
}

/* pump at most one inbound frame into the pending list */
static int coll_pump(rlo_coll *c)
{
    rlo_wire_node *n = rlo_world_poll(c->w, c->rank, c->comm);
    if (!n)
        return 0;
    coll_pend *p = (coll_pend *)malloc(sizeof(*p));
    if (!p) {
        rlo_handle_unref(n->handle);
        rlo_blob_unref(n->frame);
        rlo_pool_free(n);
        return RLO_ERR_NOMEM;
    }
    int32_t origin = -1;
    p->len = rlo_frame_decode(n->frame->data, n->frame->len, &origin,
                              &p->pid, &p->vote, 0, &p->payload);
    rlo_handle_unref(n->handle);
    if (p->len < 0) {
        /* drop the undecodable frame BEFORE linking: a parked node
         * with garbage (src, pid, vote) and negative len could later
         * match a coll_take and memcpy from junk (advisor finding) */
        rlo_blob_unref(n->frame);
        rlo_pool_free(n);
        free(p);
        return RLO_ERR_PROTO;
    }
    p->src = n->src >= 0 ? n->src : origin;
    p->frame = n->frame; /* steal the ref */
    p->next = c->pend;
    c->pend = p;
    rlo_pool_free(n);
    return 1;
}

/* take a parked (src, opid, rnd) arrival; NULL if not yet here */
static coll_pend *coll_take(rlo_coll *c, int src, int32_t opid,
                            int32_t rnd)
{
    coll_pend **pp = &c->pend;
    while (*pp) {
        coll_pend *p = *pp;
        if (p->src == src && p->pid == opid && p->vote == rnd) {
            *pp = p->next;
            p->next = 0;
            return p;
        }
        pp = &p->next;
    }
    return 0;
}

static void reduce_f32(int op, float *acc, const float *in, int64_t n)
{
    switch (op) {
    case RLO_COLL_SUM:
        for (int64_t i = 0; i < n; i++)
            acc[i] += in[i];
        break;
    case RLO_COLL_MIN:
        for (int64_t i = 0; i < n; i++)
            if (in[i] < acc[i])
                acc[i] = in[i];
        break;
    case RLO_COLL_MAX:
        for (int64_t i = 0; i < n; i++)
            if (in[i] > acc[i])
                acc[i] = in[i];
        break;
    }
}

static float identity_f32(int op)
{
    switch (op) {
    case RLO_COLL_MIN: return 3.402823466e38f;  /* +FLT_MAX */
    case RLO_COLL_MAX: return -3.402823466e38f;
    default: return 0.0f;
    }
}

/* ---------------- arming ---------------- */

static int coll_busy(const rlo_coll *c)
{
    return c->kind != COLL_NONE;
}

/* stage caller fp32 data into a ws*chunk padded ring buffer */
static int stage_f32(rlo_coll *c, const float *data, int64_t count,
                     int op)
{
    c->count = count;
    c->chunk = (count + c->ws - 1) / c->ws;
    free(c->fbuf);
    c->fbuf = (float *)malloc((size_t)(c->ws * c->chunk) * sizeof(float));
    if (!c->fbuf)
        return RLO_ERR_NOMEM;
    memcpy(c->fbuf, data, (size_t)count * sizeof(float));
    float ident = identity_f32(op);
    for (int64_t i = count; i < c->ws * c->chunk; i++)
        c->fbuf[i] = ident;
    return RLO_OK;
}

int rlo_coll_allreduce_f32_start(rlo_coll *c, float *data, int64_t count,
                                 int op)
{
    if (!c || !data || count <= 0 || coll_busy(c))
        return RLO_ERR_ARG;
    int rc = stage_f32(c, data, count, op);
    if (rc != RLO_OK)
        return rc;
    c->kind = COLL_ALLREDUCE;
    c->op = op;
    c->fout = data;
    c->phase = c->ws > 1 ? PH_RS : PH_DONE;
    c->step = 0;
    c->sent = 0;
    c->opid = c->next_opid++;
    return RLO_OK;
}

int rlo_coll_reduce_scatter_f32_start(rlo_coll *c, const float *data,
                                      int64_t count, float *out, int op)
{
    if (!c || !data || !out || count <= 0 || coll_busy(c))
        return RLO_ERR_ARG;
    int rc = stage_f32(c, data, count, op);
    if (rc != RLO_OK)
        return rc;
    c->kind = COLL_REDUCE_SCATTER;
    c->op = op;
    c->fout = out;
    c->phase = c->ws > 1 ? PH_RS : PH_DONE;
    c->step = 0;
    c->sent = 0;
    c->opid = c->next_opid++;
    return RLO_OK;
}

int rlo_coll_all_gather_start(rlo_coll *c, const uint8_t *data,
                              int64_t len, uint8_t *out)
{
    if (!c || !data || !out || len <= 0 || coll_busy(c))
        return RLO_ERR_ARG;
    c->blen = len;
    free(c->bbuf);
    c->bbuf = (uint8_t *)malloc((size_t)(c->ws * len));
    if (!c->bbuf)
        return RLO_ERR_NOMEM;
    memcpy(c->bbuf + (size_t)c->vrank * len, data, (size_t)len);
    c->kind = COLL_ALL_GATHER;
    c->bout = out;
    c->phase = c->ws > 1 ? PH_AG : PH_DONE;
    c->step = 0;
    c->sent = 0;
    c->opid = c->next_opid++;
    return RLO_OK;
}

int rlo_coll_all_to_all_start(rlo_coll *c, const uint8_t *data,
                              int64_t len_per_rank, uint8_t *out)
{
    if (!c || !data || !out || len_per_rank <= 0 || coll_busy(c))
        return RLO_ERR_ARG;
    c->blen = len_per_rank;
    free(c->bbuf);
    c->bbuf = (uint8_t *)malloc((size_t)(c->ws * len_per_rank));
    if (!c->bbuf)
        return RLO_ERR_NOMEM;
    memcpy(c->bbuf, data, (size_t)(c->ws * len_per_rank));
    memcpy(out + (size_t)c->vrank * len_per_rank,
           data + (size_t)c->vrank * len_per_rank, (size_t)len_per_rank);
    c->kind = COLL_ALL_TO_ALL;
    c->bout = out;
    c->phase = c->ws > 1 ? PH_AG : PH_DONE;
    c->step = 1; /* round d in [1, ws) */
    c->sent = 0;
    c->opid = c->next_opid++;
    return RLO_OK;
}

int rlo_coll_barrier_start(rlo_coll *c)
{
    if (!c || coll_busy(c))
        return RLO_ERR_ARG;
    c->kind = COLL_BARRIER;
    c->phase = c->ws > 1 ? PH_AG : PH_DONE;
    c->step = 0; /* round k: distance 2^k */
    c->sent = 0;
    c->opid = c->next_opid++;
    return RLO_OK;
}

/* ---------------- the gear ---------------- */

static void coll_finish(rlo_coll *c)
{
    if (c->kind == COLL_ALLREDUCE)
        memcpy(c->fout, c->fbuf, (size_t)c->count * sizeof(float));
    else if (c->kind == COLL_REDUCE_SCATTER)
        memcpy(c->fout, c->fbuf + (size_t)c->vrank * c->chunk,
               (size_t)c->chunk * sizeof(float));
    else if (c->kind == COLL_ALL_GATHER)
        memcpy(c->bout, c->bbuf, (size_t)(c->ws * c->blen));
    c->kind = COLL_NONE;
}

/* Advance one bounded slice. Returns 1 when the armed op completed
 * (result delivered), 0 when still in progress, <0 on error. */
int rlo_coll_poll(rlo_coll *c)
{
    if (!c)
        return RLO_ERR_ARG;
    if (c->kind == COLL_NONE)
        return RLO_ERR_ARG;
    if (c->phase == PH_DONE) {
        coll_finish(c);
        return 1;
    }
    int ws = c->ws, rank = c->vrank; /* ring position */
    int nxt = endp(c, (rank + 1) % ws);       /* transport endpoints */
    int prv = endp(c, (rank - 1 + ws) % ws);
    int rc;

    switch (c->kind) {
    case COLL_ALLREDUCE:
    case COLL_REDUCE_SCATTER:
        if (c->phase == PH_RS) {
            /* ring reduce-scatter: step s sends chunk (rank-s), folds
             * the arrival into chunk (rank-s-1) (collectives.py:190) */
            if (!c->sent) {
                int64_t idx = ((rank - c->step) % ws + ws) % ws;
                rc = coll_send(c, nxt, c->opid, c->step,
                               c->fbuf + idx * c->chunk,
                               c->chunk * (int64_t)sizeof(float));
                if (rc != RLO_OK)
                    return rc;
                c->sent = 1;
            }
            coll_pend *p = coll_take(c, prv, c->opid, c->step);
            if (!p) {
                rc = coll_pump(c);
                if (rc < 0)
                    return rc;
                p = coll_take(c, prv, c->opid, c->step);
                if (!p)
                    return 0;
            }
            int64_t idx = ((rank - c->step - 1) % ws + ws) % ws;
            if (p->len != c->chunk * (int64_t)sizeof(float)) {
                rlo_blob_unref(p->frame);
                free(p);
                return RLO_ERR_PROTO;
            }
            reduce_f32(c->op, c->fbuf + idx * c->chunk,
                       (const float *)p->payload, c->chunk);
            rlo_blob_unref(p->frame);
            free(p);
            c->sent = 0;
            if (++c->step == ws - 1) {
                c->step = 0;
                c->opid = c->next_opid++;
                if (c->kind == COLL_ALLREDUCE) {
                    c->phase = PH_AG; /* own chunk = (rank+1) % ws */
                } else {
                    /* reduce-scatter: rank holds chunk (rank+1);
                     * rotate one hop so rank r returns chunk r */
                    c->phase = PH_ROT;
                }
            }
            return 0;
        }
        if (c->phase == PH_ROT) {
            if (!c->sent) {
                int64_t own = (rank + 1) % ws;
                rc = coll_send(c, nxt, c->opid, 0,
                               c->fbuf + own * c->chunk,
                               c->chunk * (int64_t)sizeof(float));
                if (rc != RLO_OK)
                    return rc;
                c->sent = 1;
            }
            coll_pend *p = coll_take(c, prv, c->opid, 0);
            if (!p) {
                rc = coll_pump(c);
                if (rc < 0)
                    return rc;
                p = coll_take(c, prv, c->opid, 0);
                if (!p)
                    return 0;
            }
            memcpy(c->fbuf + (size_t)rank * c->chunk, p->payload,
                   (size_t)c->chunk * sizeof(float));
            rlo_blob_unref(p->frame);
            free(p);
            c->phase = PH_DONE;
            coll_finish(c);
            return 1;
        }
        /* PH_AG: forward chunks around the ring; step s sends chunk
         * (own - s), the arrival is chunk (own - s - 1)
         * (collectives.py:206-219) */
        {
            int64_t own = (rank + 1) % ws;
            if (!c->sent) {
                int64_t idx = ((own - c->step) % ws + ws) % ws;
                rc = coll_send(c, nxt, c->opid, c->step,
                               c->fbuf + idx * c->chunk,
                               c->chunk * (int64_t)sizeof(float));
                if (rc != RLO_OK)
                    return rc;
                c->sent = 1;
            }
            coll_pend *p = coll_take(c, prv, c->opid, c->step);
            if (!p) {
                rc = coll_pump(c);
                if (rc < 0)
                    return rc;
                p = coll_take(c, prv, c->opid, c->step);
                if (!p)
                    return 0;
            }
            if (p->len != c->chunk * (int64_t)sizeof(float)) {
                rlo_blob_unref(p->frame);
                free(p);
                return RLO_ERR_PROTO;
            }
            int64_t idx = ((own - c->step - 1) % ws + ws) % ws;
            memcpy(c->fbuf + idx * c->chunk, p->payload,
                   (size_t)c->chunk * sizeof(float));
            rlo_blob_unref(p->frame);
            free(p);
            c->sent = 0;
            if (++c->step == ws - 1) {
                c->phase = PH_DONE;
                coll_finish(c);
                return 1;
            }
            return 0;
        }

    case COLL_ALL_GATHER: {
        /* ring all-gather of per-rank byte slots; own slot = rank */
        if (!c->sent) {
            int64_t idx = ((rank - c->step) % ws + ws) % ws;
            rc = coll_send(c, nxt, c->opid, c->step,
                           c->bbuf + idx * c->blen, c->blen);
            if (rc != RLO_OK)
                return rc;
            c->sent = 1;
        }
        coll_pend *p = coll_take(c, prv, c->opid, c->step);
        if (!p) {
            rc = coll_pump(c);
            if (rc < 0)
                return rc;
            p = coll_take(c, prv, c->opid, c->step);
            if (!p)
                return 0;
        }
        if (p->len != c->blen) {
            rlo_blob_unref(p->frame);
            free(p);
            return RLO_ERR_PROTO;
        }
        int64_t idx = ((rank - c->step - 1) % ws + ws) % ws;
        memcpy(c->bbuf + idx * c->blen, p->payload, (size_t)c->blen);
        rlo_blob_unref(p->frame);
        free(p);
        c->sent = 0;
        if (++c->step == ws - 1) {
            c->phase = PH_DONE;
            coll_finish(c);
            return 1;
        }
        return 0;
    }

    case COLL_ALL_TO_ALL: {
        /* rotation: round d sends slot (rank+d) to rank+d, receives
         * slot for me from rank-d (collectives.py:241-259); slots are
         * virtual positions, send/take endpoints are real ranks */
        int dst = (rank + c->step) % ws;
        int src = ((rank - c->step) % ws + ws) % ws;
        if (!c->sent) {
            rc = coll_send(c, endp(c, dst), c->opid, c->step,
                           c->bbuf + (size_t)dst * c->blen, c->blen);
            if (rc != RLO_OK)
                return rc;
            c->sent = 1;
        }
        coll_pend *p = coll_take(c, endp(c, src), c->opid, c->step);
        if (!p) {
            rc = coll_pump(c);
            if (rc < 0)
                return rc;
            p = coll_take(c, endp(c, src), c->opid, c->step);
            if (!p)
                return 0;
        }
        if (p->len != c->blen) {
            rlo_blob_unref(p->frame);
            free(p);
            return RLO_ERR_PROTO;
        }
        memcpy(c->bout + (size_t)src * c->blen, p->payload,
               (size_t)c->blen);
        rlo_blob_unref(p->frame);
        free(p);
        c->sent = 0;
        if (++c->step == ws) {
            c->phase = PH_DONE;
            c->kind = COLL_NONE;
            return 1;
        }
        return 0;
    }

    case COLL_BARRIER: {
        /* dissemination barrier: round k exchanges tokens at distance
         * 2^k (collectives.py:261-273) */
        int dist = 1 << c->step;
        if (!c->sent) {
            uint8_t token = 1;
            rc = coll_send(c, endp(c, (rank + dist) % ws), c->opid,
                           c->step, &token, 1);
            if (rc != RLO_OK)
                return rc;
            c->sent = 1;
        }
        int from = endp(c, ((rank - dist) % ws + ws) % ws);
        coll_pend *p = coll_take(c, from, c->opid, c->step);
        if (!p) {
            rc = coll_pump(c);
            if (rc < 0)
                return rc;
            p = coll_take(c, from, c->opid, c->step);
            if (!p)
                return 0;
        }
        rlo_blob_unref(p->frame);
        free(p);
        c->sent = 0;
        c->step++;
        if ((1 << c->step) >= ws) {
            c->phase = PH_DONE;
            c->kind = COLL_NONE;
            return 1;
        }
        return 0;
    }
    }
    return RLO_ERR_ARG;
}

/* Blocking convenience: spin poll to completion (one-process-per-rank
 * transports; single-process drivers must round-robin poll instead).
 * Yields the CPU periodically — ranks are commonly oversubscribed on
 * few cores, where a hot spin starves the very peer being awaited. */
int rlo_coll_wait(rlo_coll *c, long max_spins)
{
    for (long i = 0; i < max_spins; i++) {
        int rc = rlo_coll_poll(c);
        if (rc != 0)
            return rc < 0 ? rc : RLO_OK;
        if (rlo_world_failed(c->w))
            return RLO_ERR_STALL;
        if ((i & 63) == 63)
            sched_yield();
    }
    return RLO_ERR_STALL;
}

/* ------------------------------------------------------------------ */
/* In-process ring-allreduce benchmark: the config-1 comparison line    */
/* against rlo_bench_allreduce's bcast-gather (every-rank-broadcasts,   */
/* O(ws^2) bytes). The ring moves 2*(ws-1)/ws of the buffer per rank.   */
/* Same loopback world, same median-of-reps timing. Returns median      */
/* usec per allreduce, or <0 (rlo_err) on failure/wrong numerics.       */
/* ------------------------------------------------------------------ */
double rlo_bench_allreduce_ring(int world_size, int64_t count, int reps)
{
    if (world_size < 2 || count <= 0 || reps <= 0 || reps > 1000)
        return RLO_ERR_ARG;
    rlo_world *w = rlo_world_new(world_size, 0, 0);
    if (!w)
        return RLO_ERR_NOMEM;
    double rc = RLO_ERR_NOMEM;
    rlo_coll **colls = (rlo_coll **)calloc((size_t)world_size,
                                           sizeof(void *));
    float **bufs = (float **)calloc((size_t)world_size, sizeof(void *));
    double *times = (double *)calloc((size_t)reps, sizeof(double));
    if (!colls || !bufs || !times)
        goto out;
    for (int r = 0; r < world_size; r++) {
        colls[r] = rlo_coll_new(w, r, 0);
        bufs[r] = (float *)malloc((size_t)count * sizeof(float));
        if (!colls[r] || !bufs[r])
            goto out;
    }
    for (int rep = 0; rep < reps; rep++) {
        for (int r = 0; r < world_size; r++)
            for (int64_t i = 0; i < count; i++)
                bufs[r][i] = (float)((r + 1) * ((i % 13) + 1));
        uint64_t t0 = rlo_now_usec();
        for (int r = 0; r < world_size; r++) {
            int src = rlo_coll_allreduce_f32_start(colls[r], bufs[r],
                                                   count, RLO_COLL_SUM);
            if (src != RLO_OK) {
                rc = src;
                goto out;
            }
        }
        /* round-robin the state machines, run_collectives() style */
        int done = 0;
        for (long spin = 0; done < world_size && spin < 100000000L;
             spin++) {
            done = 0;
            for (int r = 0; r < world_size; r++) {
                int pr = rlo_coll_poll(colls[r]);
                if (pr < 0 && pr != RLO_ERR_ARG) {
                    rc = pr;
                    goto out;
                }
                if (pr == 1 || pr == RLO_ERR_ARG) /* ARG = already done */
                    done++;
            }
        }
        if (done < world_size) {
            rc = RLO_ERR_STALL;
            goto out;
        }
        times[rep] = (double)(rlo_now_usec() - t0);
        double want =
            (double)world_size * (world_size + 1) / 2.0 * ((0 % 13) + 1);
        if (bufs[0][0] != (float)want || bufs[1][0] != (float)want) {
            rc = RLO_ERR_PROTO;
            goto out;
        }
    }
    for (int i = 0; i < reps; i++)
        for (int j = i + 1; j < reps; j++)
            if (times[j] < times[i]) {
                double t = times[i];
                times[i] = times[j];
                times[j] = t;
            }
    rc = times[reps / 2];

out:
    if (colls)
        for (int r = 0; r < world_size; r++)
            rlo_coll_free(colls[r]);
    if (bufs)
        for (int r = 0; r < world_size; r++)
            free(bufs[r]);
    free(colls);
    free(bufs);
    free(times);
    rlo_world_free(w);
    return rc;
}
