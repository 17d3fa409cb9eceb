/* POSIX shared-memory multi-process transport: N real OS processes as
 * ranks — the framework's `mpirun -n N ./demo` analogue (the reference
 * can only run multi-rank under mpirun, Makefile:5, SURVEY.md §4).
 *
 * Layout: one anonymous MAP_SHARED segment created by the launcher before
 * fork, holding a header (global sent/consumed counters, a sense-reversing
 * barrier, per-rank idle flags) and world_size^2 SPSC byte-ring channels,
 * one per (src, dst) pair. Writer = src process, reader = dst process, so
 * a release-store on head / acquire-load on tail is all the
 * synchronization a channel needs — the shared-memory analogue of the
 * one-sided remote-write transport the reference abandoned in
 * rma_util.c:29-62 (mailbag over MPI_Win_lock/MPI_Put epochs).
 *
 * Send semantics match MPI buffered isend: the frame is copied into the
 * ring, so the completion handle is delivered immediately (the reference
 * tests per-destination isend requests only to learn buffer reuse safety,
 * rootless_ops.c:319-325). When a ring is full the sender pumps its own
 * inbound rings into a local inbox (breaking send-send cycles) and
 * yields until space frees or a timeout trips RLO_ERR_STALL.
 *
 * Termination detection (reference rootless_ops.c:1613-1625 uses an
 * MPI_Iallreduce over bcast counts): non-blocking. One atomic global
 * `in_flight` counter (incremented before a frame enters a ring,
 * decremented when the destination engine polls it) plus per-rank idle
 * flags. A rank exits its drain when in_flight == 0 and every idle flag
 * is set, stable across a few sweeps. Safety: with in_flight == 0 and
 * all engines idle, no rank can ever send again — a new send requires
 * either an app call (excluded during drain, as in the reference's
 * cleanup) or a poll of an in-flight frame (none exist) — so ranks may
 * observe the condition at different times and exit independently
 * without a blocking barrier (which could livelock: a parked rank
 * cannot poll, holding in_flight above zero forever).
 */
#define _GNU_SOURCE
#include "rlo_internal.h"

#include <errno.h>
#include <sched.h>
#include <signal.h>
#include <stdatomic.h>
#include <stdio.h>
#include <sys/mman.h>
#include <sys/wait.h>
#include <time.h>
#include <unistd.h>

#define SHM_DEFAULT_RING (256 * 1024)
#define SHM_MAX_RANKS 256
#define SHM_ALIGN 8
/* ring-full wait budget before declaring a stall */
#define SHM_FULL_TIMEOUT_SEC 30

/* per-channel SPSC byte ring; data[] follows the struct */
typedef struct shm_ring {
    _Atomic uint64_t head; /* bytes written (monotonic) */
    _Atomic uint64_t tail; /* bytes consumed (monotonic) */
    char pad[64 - 2 * sizeof(_Atomic uint64_t)];
} shm_ring;

/* record header inside a ring, 8-byte aligned */
typedef struct shm_rec {
    uint32_t size; /* total record bytes incl. header + padding */
    int32_t tag;
    int32_t comm;
    int32_t src;
    int64_t len; /* frame bytes that follow */
} shm_rec;

typedef struct shm_hdr {
    int world_size;
    int64_t ring_bytes;
    _Atomic int64_t sent_cnt;     /* frames entered a ring */
    _Atomic int64_t consumed_cnt; /* frames handed to an engine */
    _Atomic int64_t in_flight;    /* sent but not yet polled by an engine */
    _Atomic int barrier_cnt;
    _Atomic int barrier_gen;
    _Atomic int abort_flag; /* a rank hit a fatal error */
    _Atomic int idle_flag[SHM_MAX_RANKS];
    /* per-rank heartbeat (usec clock): stamped on every ring pump so a
     * crashed/exited peer goes stale within one failure timeout — the
     * net-new failure-detection signal (the reference has none,
     * SURVEY.md §5); read by rlo_world_peer_alive */
    _Atomic uint64_t hb_usec[SHM_MAX_RANKS];
} shm_hdr;

typedef struct rlo_shm_world {
    rlo_world base;
    shm_hdr *hdr;
    uint8_t *rings; /* world_size^2 rings, index src*ws + dst */
    size_t ring_stride;
    size_t seg_size;
    /* local inbox of frames already pumped out of my inbound rings
     * (holds frames for every comm; poll filters) */
    rlo_wire_node *inbox_head, *inbox_tail;
} rlo_shm_world;

static shm_ring *ring_at(const rlo_shm_world *w, int src, int dst)
{
    return (shm_ring *)(w->rings +
                        w->ring_stride *
                            ((size_t)src * (size_t)w->base.world_size +
                             (size_t)dst));
}

static uint8_t *ring_data(shm_ring *r)
{
    return (uint8_t *)(r + 1);
}

/* copy in/out with wraparound */
static void ring_write(shm_ring *r, int64_t cap, uint64_t at,
                       const void *src, size_t n)
{
    uint8_t *d = ring_data(r);
    size_t off = (size_t)(at % (uint64_t)cap);
    size_t first = (size_t)cap - off;
    if (first > n)
        first = n;
    memcpy(d + off, src, first);
    if (n > first)
        memcpy(d, (const uint8_t *)src + first, n - first);
}

static void ring_read(shm_ring *r, int64_t cap, uint64_t at, void *dst,
                      size_t n)
{
    const uint8_t *d = ring_data(r);
    size_t off = (size_t)(at % (uint64_t)cap);
    size_t first = (size_t)cap - off;
    if (first > n)
        first = n;
    memcpy(dst, d + off, first);
    if (n > first)
        memcpy((uint8_t *)dst + first, d, n - first);
}

static size_t rec_size(int64_t len)
{
    size_t n = sizeof(shm_rec) + (size_t)len;
    return (n + (SHM_ALIGN - 1)) & ~(size_t)(SHM_ALIGN - 1);
}

/* ---- pump: drain all my inbound rings into the local inbox ---- */

/* rlo-sentinel: transfers(n) — the inbox owns it until polled */
static void shm_inbox_push(rlo_shm_world *w, rlo_wire_node *n)
{
    n->next = 0;
    if (w->inbox_tail)
        w->inbox_tail->next = n;
    else
        w->inbox_head = n;
    w->inbox_tail = n;
}

static int shm_pump(rlo_shm_world *w)
{
    int moved = 0;
    int ws = w->base.world_size;
    int me = w->base.my_rank;
    atomic_store_explicit(&w->hdr->hb_usec[me], rlo_now_usec(),
                          memory_order_relaxed);
    int64_t cap = w->hdr->ring_bytes;
    for (int src = 0; src < ws; src++) {
        if (src == me)
            continue;
        shm_ring *r = ring_at(w, src, me);
        for (;;) {
            uint64_t tail = atomic_load_explicit(&r->tail,
                                                 memory_order_relaxed);
            uint64_t head = atomic_load_explicit(&r->head,
                                                 memory_order_acquire);
            if (head == tail)
                break;
            shm_rec rec;
            ring_read(r, cap, tail, &rec, sizeof(rec));
            /* rec is WIRE INPUT from a shared segment a crashed or
             * hostile peer may have scribbled over (rlo-sentinel S2):
             * every field that sizes an allocation/copy or advances
             * the consume cursor is validated against the ring
             * geometry before use — the TCP receive path applies the
             * same symmetric cap (tcp_pump), including the src pin:
             * each ring is per (src, me) and senders stamp their own
             * rank, so any other value is a scribble that would let
             * frames impersonate a healthy rank past the
             * failed-sender/epoch quarantine. A violation poisons the
             * world (abort_flag), it must never poison this process. */
            if (rec.len < 0 ||
                rec.len > cap - (int64_t)sizeof(shm_rec) ||
                rec.size != rec_size(rec.len) ||
                rec.src != src) {
                atomic_store(&w->hdr->abort_flag, 1);
                return RLO_ERR_PROTO;
            }
            rlo_wire_node *n = (rlo_wire_node *)rlo_pool_alloc(
                &w->base, sizeof(*n));
            rlo_blob *frame = rlo_blob_new_w(&w->base, rec.len);
            if (!n || !frame) {
                rlo_pool_free(n);
                rlo_blob_unref(frame);
                return RLO_ERR_NOMEM;
            }
            n->next = 0;
            n->src = rec.src;
            n->dst = me;
            n->tag = rec.tag;
            n->comm = rec.comm;
            n->due = 0;
            n->frame = frame;
            n->handle = rlo_handle_new_w(&w->base, 1);
            if (!n->handle) {
                rlo_pool_free(n);
                rlo_blob_unref(frame);
                return RLO_ERR_NOMEM;
            }
            n->handle->delivered = 1;
            if (rec.len > 0)
                ring_read(r, cap, tail + sizeof(rec), frame->data,
                          (size_t)rec.len);
            atomic_store_explicit(&r->tail, tail + rec.size,
                                  memory_order_release);
            shm_inbox_push(w, n);
            moved++;
        }
    }
    return moved;
}

/* ---- vtable ops ---- */

static int shm_isend(rlo_world *base, int src, int dst, int comm, int tag,
                     rlo_blob *frame, rlo_handle **out)
{
    rlo_shm_world *w = (rlo_shm_world *)base;
    if (dst < 0 || dst >= base->world_size || !frame ||
        src != base->my_rank)
        return RLO_ERR_ARG;
    const uint8_t *raw = frame->data;
    int64_t len = frame->len;
    if (len < 0)
        return RLO_ERR_ARG;
    if (dst == src)
        return RLO_ERR_ARG; /* overlay never self-sends */
    int64_t cap = w->hdr->ring_bytes;
    size_t need = rec_size(len);
    if ((int64_t)need > cap)
        return RLO_ERR_TOO_BIG;
    /* sending means this rank is active: take the idle flag down so no
     * peer's drain can conclude global quiescence around this send */
    atomic_store(&w->hdr->idle_flag[base->my_rank], 0);
    /* allocate the caller's completion handle before committing the
     * frame — a post-commit allocation failure would report a send that
     * actually happened */
    rlo_handle *h = 0;
    if (out) {
        h = rlo_handle_new_w(base, 1);
        if (!h)
            return RLO_ERR_NOMEM;
        h->delivered = 1; /* buffered-send semantics */
    }
    shm_ring *r = ring_at(w, src, dst);
    struct timespec t0, tn;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (;;) {
        uint64_t head = atomic_load_explicit(&r->head,
                                             memory_order_relaxed);
        uint64_t tail = atomic_load_explicit(&r->tail,
                                             memory_order_acquire);
        if ((uint64_t)cap - (head - tail) >= need) {
            shm_rec rec = {.size = (uint32_t)need,
                           .tag = tag,
                           .comm = comm,
                           .src = src,
                           .len = len};
            ring_write(r, cap, head, &rec, sizeof(rec));
            if (len > 0)
                ring_write(r, cap, head + sizeof(rec), raw, (size_t)len);
            /* in_flight rises before the frame becomes visible so an
             * observer can never see the frame without the count */
            atomic_fetch_add_explicit(&w->hdr->in_flight, 1,
                                      memory_order_relaxed);
            atomic_store_explicit(&r->head, head + need,
                                  memory_order_release);
            atomic_fetch_add_explicit(&w->hdr->sent_cnt, 1,
                                      memory_order_relaxed);
            break;
        }
        /* ring full: keep consuming my own inbound traffic so two
         * mutually-full ranks can't deadlock, then yield to the reader */
        if (atomic_load(&w->hdr->abort_flag)) {
            rlo_handle_unref(h);
            return RLO_ERR_STALL;
        }
        int rc = shm_pump(w);
        if (rc < 0) {
            rlo_handle_unref(h);
            return rc;
        }
        sched_yield();
        clock_gettime(CLOCK_MONOTONIC, &tn);
        if (tn.tv_sec - t0.tv_sec > SHM_FULL_TIMEOUT_SEC) {
            atomic_store(&w->hdr->abort_flag, 1);
            rlo_handle_unref(h);
            return RLO_ERR_STALL;
        }
    }
    if (out)
        *out = h;
    return RLO_OK;
}

static rlo_wire_node *shm_poll(rlo_world *base, int rank, int comm)
{
    rlo_shm_world *w = (rlo_shm_world *)base;
    if (rank != base->my_rank)
        return 0;
    shm_pump(w);
    rlo_wire_node *prev = 0;
    for (rlo_wire_node *n = w->inbox_head; n; prev = n, n = n->next) {
        if (n->comm != comm)
            continue;
        if (prev)
            prev->next = n->next;
        else
            w->inbox_head = n->next;
        if (w->inbox_tail == n)
            w->inbox_tail = prev;
        n->next = 0;
        /* handing a frame to an engine whose dispatch may send: the
         * idle flag must be observably down BEFORE in_flight can read 0,
         * or a peer's drain could conclude global quiescence in the
         * window between this decrement and the dispatch's own sends
         * (both seq_cst to keep the store ordered before the sub) */
        atomic_store(&w->hdr->idle_flag[base->my_rank], 0);
        atomic_fetch_add_explicit(&w->hdr->consumed_cnt, 1,
                                  memory_order_relaxed);
        atomic_fetch_sub(&w->hdr->in_flight, 1);
        return n;
    }
    return 0;
}

static int shm_quiescent(const rlo_world *base)
{
    const rlo_shm_world *w = (const rlo_shm_world *)base;
    return atomic_load(&w->hdr->in_flight) == 0;
}

static int64_t shm_sent(const rlo_world *base)
{
    return atomic_load(&((const rlo_shm_world *)base)->hdr->sent_cnt);
}

static int64_t shm_delivered(const rlo_world *base)
{
    return atomic_load(&((const rlo_shm_world *)base)->hdr->consumed_cnt);
}

/* Sense-reversing barrier. While spinning, keep pumping inbound rings
 * into the local inbox (not counted as consumed until poll) so a rank
 * still working outside the barrier can never block on a full ring whose
 * reader is parked here. */
static void shm_barrier_w(rlo_shm_world *w)
{
    shm_hdr *h = w->hdr;
    int ws = w->base.world_size;
    int gen = atomic_load(&h->barrier_gen);
    if (atomic_fetch_add(&h->barrier_cnt, 1) == ws - 1) {
        atomic_store(&h->barrier_cnt, 0);
        atomic_fetch_add(&h->barrier_gen, 1);
    } else {
        while (atomic_load(&h->barrier_gen) == gen) {
            if (atomic_load(&h->abort_flag)) {
                /* leave the barrier accounting consistent on abort */
                atomic_fetch_sub(&h->barrier_cnt, 1);
                return;
            }
            shm_pump(w);
            sched_yield();
        }
    }
}

void rlo_shm_barrier(rlo_world *base)
{
    if (!base || base->ops->quiescent != shm_quiescent)
        return; /* not an shm world */
    shm_barrier_w((rlo_shm_world *)base);
}

static int shm_local_idle(rlo_shm_world *w)
{
    for (int j = 0; j < w->base.n_engines; j++)
        if (!rlo_engine_idle(w->base.engines[j]))
            return 0;
    return w->inbox_head == 0;
}

static int shm_drain(rlo_world *base, int max_spins)
{
    rlo_shm_world *w = (rlo_shm_world *)base;
    shm_hdr *h = w->hdr;
    int me = base->my_rank;
    int stable = 0;
    for (int i = 0; i < max_spins; i++) {
        /* flag down while we might dispatch (a dispatch can send) */
        atomic_store(&h->idle_flag[me], 0);
        rlo_progress_all(base);
        if (atomic_load(&h->abort_flag))
            return RLO_ERR_STALL;
        if (!shm_local_idle(w) || atomic_load(&h->in_flight) != 0) {
            stable = 0;
            sched_yield();
            continue;
        }
        atomic_store(&h->idle_flag[me], 1);
        int ok = atomic_load(&h->in_flight) == 0;
        for (int r = 0; ok && r < base->world_size; r++)
            if (!atomic_load(&h->idle_flag[r]))
                ok = 0;
        stable = ok ? stable + 1 : 0;
        if (stable >= 3) {
            atomic_store(&h->idle_flag[me], 1); /* stay up for peers */
            return i;
        }
        sched_yield();
    }
    return RLO_ERR_STALL;
}

static void shm_free(rlo_world *base)
{
    rlo_shm_world *w = (rlo_shm_world *)base;
    for (rlo_wire_node *n = w->inbox_head; n;) {
        rlo_wire_node *nn = n->next;
        rlo_handle_unref(n->handle);
        rlo_blob_unref(n->frame);
        rlo_pool_free(n);
        n = nn;
    }
    /* the segment is unmapped at process exit; unmapping here would break
     * other engines still bound to it in this process */
    free(base->engines);
    rlo_pool_drain(base);
    free(w);
}

static int shm_failed(const rlo_world *base)
{
    return atomic_load(&((const rlo_shm_world *)base)->hdr->abort_flag);
}

static int shm_peer_alive(const rlo_world *base, int rank,
                          uint64_t timeout_usec)
{
    const rlo_shm_world *w = (const rlo_shm_world *)base;
    if (rank == base->my_rank)
        return 1;
    uint64_t last = atomic_load_explicit(&w->hdr->hb_usec[rank],
                                         memory_order_relaxed);
    uint64_t now = rlo_now_usec();
    return now < last || now - last <= timeout_usec;
}

static void shm_barrier_op(rlo_world *base)
{
    shm_barrier_w((rlo_shm_world *)base);
}

static const rlo_transport_ops SHM_OPS = {
    .name = "shm",
    .barrier = shm_barrier_op,
    .isend = shm_isend,
    .poll = shm_poll,
    .quiescent = shm_quiescent,
    .sent_cnt = shm_sent,
    .delivered_cnt = shm_delivered,
    .drain = shm_drain,
    .failed = shm_failed,
    .peer_alive = shm_peer_alive,
    .free_ = shm_free,
};

/* ---- launcher ---- */

static rlo_world *shm_world_bind(void *seg, size_t seg_size, int rank)
{
    shm_hdr *h = (shm_hdr *)seg;
    rlo_shm_world *w = (rlo_shm_world *)calloc(1, sizeof(*w));
    if (!w)
        return 0;
    w->base.ops = &SHM_OPS;
    w->base.world_size = h->world_size;
    w->base.my_rank = rank;
    w->hdr = h;
    w->ring_stride = sizeof(shm_ring) + (size_t)h->ring_bytes;
    w->rings = (uint8_t *)seg + sizeof(shm_hdr);
    w->seg_size = seg_size;
    return &w->base;
}

int rlo_shm_launch(int world_size, int64_t ring_bytes, rlo_rank_fn fn,
                   void *ctx)
{
    if (world_size < 2 || world_size > SHM_MAX_RANKS || !fn)
        return RLO_ERR_ARG;
    if (ring_bytes <= 0)
        ring_bytes = SHM_DEFAULT_RING;
    ring_bytes = (ring_bytes + (SHM_ALIGN - 1)) &
                 ~(int64_t)(SHM_ALIGN - 1);
    size_t stride = sizeof(shm_ring) + (size_t)ring_bytes;
    size_t seg_size = sizeof(shm_hdr) +
                      stride * (size_t)world_size * (size_t)world_size;
    void *seg = mmap(0, seg_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_ANONYMOUS, -1, 0);
    if (seg == MAP_FAILED)
        return RLO_ERR_NOMEM;
    shm_hdr *h = (shm_hdr *)seg;
    memset(h, 0, sizeof(*h));
    h->world_size = world_size;
    h->ring_bytes = ring_bytes;
    /* stamp every heartbeat slot now so no rank reads stale-at-birth */
    uint64_t now = rlo_now_usec();
    for (int r = 0; r < world_size; r++)
        atomic_store(&h->hb_usec[r], now);

    pid_t pids[SHM_MAX_RANKS];
    int nforked = 0;
    for (int r = 0; r < world_size; r++) {
        pid_t pid = fork();
        if (pid < 0) {
            atomic_store(&h->abort_flag, 1);
            for (int k = 0; k < nforked; k++)
                kill(pids[k], SIGKILL);
            for (int k = 0; k < nforked; k++)
                waitpid(pids[k], 0, 0);
            munmap(seg, seg_size);
            return RLO_ERR_NOMEM;
        }
        if (pid == 0) {
            rlo_world *w = shm_world_bind(seg, seg_size, r);
            if (!w)
                _exit(120);
            int rc = fn(w, r, ctx);
            rlo_world_free(w);
            _exit(rc < 0 || rc > 255 ? 119 : rc);
        }
        pids[nforked++] = pid;
    }

    /* reap in completion order: a rank that fails must raise the abort
     * flag immediately so peers parked in a barrier or full-ring spin
     * notice and exit instead of spinning forever */
    int status_out = 0;
    for (int k = 0; k < nforked; k++) {
        int st = 0;
        pid_t pid = waitpid(-1, &st, 0);
        if (pid < 0)
            break;
        int rc;
        if (WIFEXITED(st))
            rc = WEXITSTATUS(st);
        else
            rc = 128 + (WIFSIGNALED(st) ? WTERMSIG(st) : 0);
        if (rc != 0 && status_out == 0) {
            status_out = rc;
            /* wake ranks stuck in a barrier/full-ring spin */
            atomic_store(&h->abort_flag, 1);
        }
    }
    munmap(seg, seg_size);
    return status_out;
}
