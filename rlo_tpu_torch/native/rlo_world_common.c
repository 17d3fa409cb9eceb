/* Transport-independent world machinery: engine registry, cooperative
 * progress loop, and dispatch to the transport vtable.
 *
 * The registry + progress loop mirror the reference's EngineManager /
 * Active_Engines / RLO_make_progress_all (rootless_ops.c:33-47, 407-466,
 * 538-549): multiple engines may live on one world (each on its own comm
 * id — the analogue of the dup'ed MPI communicator per engine,
 * rootless_ops.c:1461), and one progress turn steps all of them so
 * engines co-progress each other (testcases.c:110-241 relies on this).
 */
#include "rlo_internal.h"

#include <string.h>

/* ---- small-object pool (rlo_internal.h has the design notes) ---- */

static const size_t POOL_CEILING[RLO_POOL_CLASSES] = {
    RLO_POOL_C0, RLO_POOL_C1, RLO_POOL_C2, RLO_POOL_C3};

void *rlo_pool_alloc(rlo_world *w, size_t size)
{
#ifdef RLO_POOL_PASSTHROUGH
    w = 0; /* sanitizer builds: every object is a fresh malloc */
#endif
    size_t cls = RLO_POOL_CLASSES;
    if (w)
        for (cls = 0; cls < RLO_POOL_CLASSES; cls++)
            if (size <= POOL_CEILING[cls])
                break;
    if (w && cls < RLO_POOL_CLASSES && w->pool_free[cls]) {
        rlo_pool_hdr *h = (rlo_pool_hdr *)w->pool_free[cls];
        w->pool_free[cls] = h->link;
        h->link = w;
        return h + 1;
    }
    rlo_pool_hdr *h = (rlo_pool_hdr *)malloc(
        sizeof(*h) +
        (cls < RLO_POOL_CLASSES ? POOL_CEILING[cls] : size));
    if (!h)
        return 0;
    h->link = cls < RLO_POOL_CLASSES ? (void *)w : 0;
    h->cls = cls;
    return h + 1;
}

void rlo_pool_free(void *p)
{
    if (!p)
        return;
    rlo_pool_hdr *h = (rlo_pool_hdr *)p - 1;
    rlo_world *w = (rlo_world *)h->link;
    if (!w || h->cls >= RLO_POOL_CLASSES) {
        free(h);
        return;
    }
    h->link = w->pool_free[h->cls];
    w->pool_free[h->cls] = h;
}

void rlo_pool_drain(rlo_world *w)
{
    for (int c = 0; c < RLO_POOL_CLASSES; c++) {
        for (void *p = w->pool_free[c]; p;) {
            void *next = ((rlo_pool_hdr *)p)->link;
            free(p);
            p = next;
        }
        w->pool_free[c] = 0;
    }
    free(w->sweep_scratch);
    w->sweep_scratch = 0;
    w->sweep_cap = 0;
}

int rlo_world_size(const rlo_world *w)
{
    return w->world_size;
}

int rlo_world_my_rank(const rlo_world *w)
{
    return w->my_rank;
}

const char *rlo_world_transport(const rlo_world *w)
{
    return w->ops->name;
}

int64_t rlo_world_sent_cnt(const rlo_world *w)
{
    return w->ops->sent_cnt(w);
}

int64_t rlo_world_delivered_cnt(const rlo_world *w)
{
    return w->ops->delivered_cnt(w);
}

int rlo_world_quiescent(const rlo_world *w)
{
    return w->ops->quiescent(w);
}

int rlo_world_failed(const rlo_world *w)
{
    return w->ops->failed ? w->ops->failed(w) : 0;
}

/* Test support: inject one raw frame as if `src` had sent it —
 * duplicate/stale-frame scenarios (e.g. a decision replayed by a
 * mixed-overlay forward during a view change) need a way to place
 * arbitrary wire bytes on a channel. In-process worlds only. */
int rlo_world_inject(rlo_world *w, int src, int dst, int comm, int tag,
                     const uint8_t *raw, int64_t len)
{
    if (!w || !raw || len < 0 || src < 0 || src >= w->world_size ||
        dst < 0 || dst >= w->world_size)
        return RLO_ERR_ARG;
    rlo_blob *b = rlo_blob_new(len);
    if (!b)
        return RLO_ERR_NOMEM;
    memcpy(b->data, raw, (size_t)len);
    /* prefer the transport's direct-delivery hook: it bypasses latency
     * and fault injection, so src may be a dead rank (mirror of
     * LoopbackWorld.inject — the stale-frame quarantine scenarios) */
    int rc = w->ops->inject
                 ? w->ops->inject(w, src, dst, comm, tag, b)
                 : rlo_world_isend(w, src, dst, comm, tag, b, 0);
    rlo_blob_unref(b);
    return rc;
}

void rlo_world_barrier(rlo_world *w)
{
    if (w->ops->barrier)
        w->ops->barrier(w);
}

int rlo_world_peer_alive(const rlo_world *w, int rank,
                         uint64_t timeout_usec)
{
    if (rank < 0 || rank >= w->world_size)
        return 0;
    if (!w->ops->peer_alive)
        return 1; /* no liveness signal: in-process peers can't die */
    return w->ops->peer_alive(w, rank, timeout_usec);
}

int rlo_world_kill_rank(rlo_world *w, int rank)
{
    if (!w->ops->kill_rank)
        return RLO_ERR_ARG;
    return w->ops->kill_rank(w, rank);
}

int rlo_world_drop_next(rlo_world *w, int src, int dst, int count)
{
    if (!w->ops->drop_next)
        return RLO_ERR_ARG;
    return w->ops->drop_next(w, src, dst, count);
}

int rlo_world_dup_next(rlo_world *w, int src, int dst, int count)
{
    if (!w->ops->dup_next)
        return RLO_ERR_ARG;
    return w->ops->dup_next(w, src, dst, count);
}

int rlo_world_partition(rlo_world *w, const int *group_of, int n)
{
    if (!w->ops->partition)
        return RLO_ERR_ARG;
    return w->ops->partition(w, group_of, n);
}

int rlo_world_revive_rank(rlo_world *w, int rank)
{
    if (!w->ops->revive)
        return RLO_ERR_ARG;
    return w->ops->revive(w, rank);
}

void rlo_world_free(rlo_world *w)
{
    if (!w)
        return;
    w->ops->free_(w);
}

int rlo_world_isend(rlo_world *w, int src, int dst, int comm, int tag,
                    rlo_blob *frame, rlo_handle **out)
{
    return w->ops->isend(w, src, dst, comm, tag, frame, out);
}

int rlo_world_isend_hdr(rlo_world *w, int src, int dst, int comm,
                        int tag, const uint8_t *hdr, rlo_blob *frame,
                        rlo_handle **out)
{
    if (frame->len < RLO_HEADER_SIZE)
        return RLO_ERR_ARG;
    if (w->ops->isend_hdr)
        return w->ops->isend_hdr(w, src, dst, comm, tag, hdr, frame,
                                 out);
    /* fallback: materialize the stamped header + shared payload into
     * one contiguous frame (one copy — the pre-S13 behavior for
     * transports without scatter-gather) */
    rlo_blob *b = rlo_blob_new_w(w, frame->len);
    if (!b)
        return RLO_ERR_NOMEM;
    memcpy(b->data, hdr, RLO_HEADER_SIZE);
    memcpy(b->data + RLO_HEADER_SIZE, frame->data + RLO_HEADER_SIZE,
           (size_t)(frame->len - RLO_HEADER_SIZE));
    int rc = w->ops->isend(w, src, dst, comm, tag, b, out);
    rlo_blob_unref(b);
    return rc;
}

/* rlo-sentinel: owns — the polled node belongs to the caller */
rlo_wire_node *rlo_world_poll(rlo_world *w, int rank, int comm)
{
    return w->ops->poll(w, rank, comm);
}

int rlo_world_register(rlo_world *w, rlo_engine *e)
{
    if (w->n_engines == w->cap_engines) {
        int cap = w->cap_engines ? w->cap_engines * 2 : 8;
        rlo_engine **p = (rlo_engine **)realloc(
            w->engines, (size_t)cap * sizeof(void *));
        if (!p)
            return RLO_ERR_NOMEM;
        w->engines = p;
        w->cap_engines = cap;
    }
    w->engines[w->n_engines++] = e;
    return RLO_OK;
}

void rlo_world_unregister(rlo_world *w, rlo_engine *e)
{
    for (int i = 0; i < w->n_engines; i++) {
        if (w->engines[i] == e) {
            memmove(&w->engines[i], &w->engines[i + 1],
                    (size_t)(w->n_engines - i - 1) * sizeof(void *));
            w->n_engines--;
            return;
        }
    }
}

/* One sweep: every engine gets one progress turn, sharing a frame
 * budget (budget < 0 = unbounded). Returns frames polled across the
 * sweep. Re-entrant calls are no-ops returning 0. */
static int64_t world_sweep(rlo_world *w, int64_t budget)
{
    /* handlers may initiate broadcasts (decision bcast inside the vote
     * handler) which re-enter; make nested turns no-ops (mirrors
     * EngineManager._stepping, rlo_tpu_torch/engine.py) */
    if (w->stepping)
        return 0;
    w->stepping = 1;
    int64_t total = 0;
    /* step over a snapshot: callbacks may register/unregister engines
     * mid-turn (the Python side iterates a copy for the same reason).
     * The snapshot buffer is world-owned scratch, reused sweep to
     * sweep — the stepping guard rules out concurrent sweeps. */
    int n = w->n_engines;
    if (n > w->sweep_cap) {
        int cap = w->sweep_cap ? w->sweep_cap * 2 : 8;
        while (cap < n)
            cap *= 2;
        rlo_engine **s = (rlo_engine **)realloc(
            w->sweep_scratch, (size_t)cap * sizeof(void *));
        if (s) {
            w->sweep_scratch = s;
            w->sweep_cap = cap;
        }
    }
    rlo_engine **snap = w->sweep_scratch;
    if (snap && n <= w->sweep_cap) {
        if (n > 0) /* engines may be NULL pre-registration (UBSan) */
            memcpy(snap, w->engines, (size_t)n * sizeof(void *));
        for (int i = 0; i < n; i++) {
            if (budget >= 0 && total >= budget)
                break; /* the rest of the sweep waits for more budget */
            /* skip engines freed by an earlier engine's callback */
            int live = 0;
            for (int j = 0; j < w->n_engines; j++)
                if (w->engines[j] == snap[i])
                    live = 1;
            if (live)
                total += rlo_engine_progress_budget(
                    snap[i], budget >= 0 ? budget - total : -1);
        }
    }
    w->stepping = 0;
    return total;
}

void rlo_progress_all(rlo_world *w)
{
    world_sweep(w, -1);
}

/* Batched world progress (docs/DESIGN.md S13; contract in rlo_core.h):
 * sweep until the budget fills, the deadline expires, or — with no
 * deadline — the first fruitless sweep with a quiescent transport
 * (in-flight latency frames keep it sweeping: every loopback poll
 * advances the delivery clock, so a non-quiescent world always makes
 * progress toward the next due frame). A fruitless-sweep fuse bounds
 * the pathological case of in-flight frames no registered engine will
 * ever poll (a comm whose engine was freed mid-traffic). */
#define RLO_PROGRESS_FRUITLESS_FUSE 65536

int64_t rlo_world_progress_all_n(rlo_world *w, int64_t max_frames,
                                 uint64_t deadline_usec)
{
    if (!w)
        return RLO_ERR_ARG;
    if (w->stepping)
        return 0; /* re-entered from a handler: no-op */
    uint64_t end = deadline_usec ? rlo_now_usec() + deadline_usec : 0;
    int64_t total = 0;
    int64_t fruitless = 0;
    for (;;) {
        /* dead-time skip BEFORE each sweep: frames waiting out
         * injected latency jump straight to deliverable (the one-poll-
         * per-tick path would burn a sweep per dead tick); a no-op on
         * real-time transports and on latency-free worlds */
        int64_t moved = w->ops->advance ? w->ops->advance(w) : 0;
        int64_t got = world_sweep(
            w, max_frames > 0 ? max_frames - total : -1);
        total += got;
        if (max_frames > 0 && total >= max_frames)
            break;
        if (got == 0 && moved == 0) {
            if (!end && (rlo_world_quiescent(w) ||
                         ++fruitless >= RLO_PROGRESS_FRUITLESS_FUSE))
                break;
        } else {
            fruitless = 0;
        }
        if (end && rlo_now_usec() >= end)
            break;
    }
    return total;
}

int rlo_drain(rlo_world *w, int max_spins)
{
    return w->ops->drain(w, max_spins);
}

/* Shared single-process drain loop used by transports whose quiescent()
 * predicate is globally accurate from one process (loopback; MPI uses its
 * own collective protocol). */
int rlo_drain_local(rlo_world *w, int max_spins)
{
    for (int i = 0; i < max_spins; i++) {
        rlo_progress_all(w);
        if (rlo_world_quiescent(w)) {
            int idle = 1;
            for (int j = 0; j < w->n_engines; j++)
                if (!rlo_engine_idle(w->engines[j]))
                    idle = 0;
            if (idle)
                return i;
        }
    }
    return RLO_ERR_STALL;
}
