/* Internal structures shared between transport worlds and the engine.
 *
 * The world is polymorphic — a transport vtable (SURVEY.md §7 "transport
 * vtable" design stance): the engine only ever talks through
 * rlo_world_isend / rlo_world_poll / rlo_world_register, and each
 * transport (in-process loopback, POSIX-SHM multi-process, compile-gated
 * MPI) supplies the ops. This is the seam the reference lacks — its MPI
 * calls are hard-wired throughout rootless_ops.c (SURVEY.md §2 C11).
 */
#ifndef RLO_INTERNAL_H
#define RLO_INTERNAL_H

#include "rlo_core.h"

#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Small-object pool (docs/DESIGN.md S13). The hot path allocates and */
/* frees a handful of tiny objects PER FRAME (wire node, completion   */
/* handle, message struct, ARQ entry, small frame blobs); under the   */
/* batched progress loop that malloc/free traffic dominated the       */
/* per-frame cost. Worlds own size-classed freelists; every pooled    */
/* object carries a one-pointer header naming its owning world (NULL  */
/* = plain malloc), so the type-blind unref/free helpers route each   */
/* object back where it came from. Single-threaded per world, like    */
/* every other world structure (the cooperative-polling model).       */
/*                                                                    */
/* Under ASan/TSan the pool compiles to plain malloc/free so the      */
/* sanitizers keep full poisoning/race precision — the sanitizer      */
/* gates verify the allocation DISCIPLINE, the pool only changes the  */
/* allocator behind it.                                               */
/*                                                                    */
/* LIFETIME RULE: a pooled object's free writes through its header    */
/* into the owning world's freelists, so every engine, coll, and      */
/* stray blob/handle/node ref MUST be released before rlo_world_free  */
/* (this was already the de-facto rule — engine_free dereferences     */
/* e->w — but the pool makes violations memory corruption instead of  */
/* a benign leak; the Python bindings close tracked engines AND colls */
/* in NativeWorld.close() for exactly this reason).                   */
/* ------------------------------------------------------------------ */
#if defined(__SANITIZE_ADDRESS__) || defined(__SANITIZE_THREAD__)
#define RLO_POOL_PASSTHROUGH 1
#endif
#if !defined(RLO_POOL_PASSTHROUGH) && defined(__has_feature)
#if __has_feature(address_sanitizer) || __has_feature(thread_sanitizer)
#define RLO_POOL_PASSTHROUGH 1
#endif
#endif

#define RLO_POOL_CLASSES 4
/* class ceilings: node/handle/ack-blob | msg/rtx | bench-size frame
 * blobs | anything small enough to be worth keeping */
#define RLO_POOL_C0 64
#define RLO_POOL_C1 192
#define RLO_POOL_C2 512
#define RLO_POOL_C3 2048

typedef struct rlo_pool_hdr {
    /* allocated: the owning world (NULL = plain malloc);
     * on a freelist: the next free chunk */
    void *link;
    size_t cls; /* size class, stable across reuse */
} rlo_pool_hdr;

void *rlo_pool_alloc(rlo_world *w, size_t size);
void rlo_pool_free(void *p);
/* world teardown: release every chunk parked on the freelists */
void rlo_pool_drain(rlo_world *w);

/* Refcounted send-completion handle (~MPI_Request tested by MPI_Test;
 * reference keeps per-destination isend req arrays, rootless_ops.c:296).
 * One ref is held by the in-flight wire node, one by the tracking message
 * (when the sender tracks completion at all — votes don't). */
typedef struct rlo_handle {
    int delivered;
    /* set alongside delivered when the send terminated WITHOUT
     * delivering (peer dead, frame dropped by fault injection) — the
     * MPI_ERR_*-in-status analogue; done-but-failed, never hung */
    int failed;
    int refs;
} rlo_handle;

/* Pool-aware constructor: handles are freed type-blind through
 * rlo_handle_unref -> rlo_pool_free, so EVERY handle must carry the
 * pool header — w == NULL just means the plain-malloc class. */
static inline rlo_handle *rlo_handle_new_w(rlo_world *w, int refs)
{
    rlo_handle *h = (rlo_handle *)rlo_pool_alloc(w, sizeof(*h));
    if (h) {
        memset(h, 0, sizeof(*h));
        h->refs = refs;
    }
    return h;
}

static inline rlo_handle *rlo_handle_new(int refs)
{
    return rlo_handle_new_w(0, refs);
}

static inline void rlo_handle_unref(rlo_handle *h)
{
    if (h && --h->refs == 0)
        rlo_pool_free(h);
}

/* Refcounted immutable frame blob. One encoded frame is shared across
 * every fan-out send, the engine's tracking message, and (for in-process
 * transports) the receiver — the native analogue of the Python engine
 * passing one immutable `bytes` to every isend, and the zero-copy spirit
 * of the one-sided remote-write transport the reference abandoned
 * (rma_util.c:29-62). Single-threaded refcounts (the engine model is
 * cooperative polling; rootless_ops.h:216). */
typedef struct rlo_blob {
    int refs;
    int64_t len;
    uint8_t data[];
} rlo_blob;

/* Pool-aware constructor (same rule as handles: unref routes through
 * rlo_pool_free, so every blob carries the header; small blobs from a
 * world-owning call site recycle through that world's freelists). */
static inline rlo_blob *rlo_blob_new_w(rlo_world *w, int64_t len)
{
    rlo_blob *b = (rlo_blob *)rlo_pool_alloc(
        w, sizeof(rlo_blob) + (size_t)(len > 0 ? len : 0));
    if (b) {
        b->refs = 1;
        b->len = len;
    }
    return b;
}

static inline rlo_blob *rlo_blob_new(int64_t len)
{
    return rlo_blob_new_w(0, len);
}

static inline rlo_blob *rlo_blob_ref(rlo_blob *b)
{
    b->refs++;
    return b;
}

static inline void rlo_blob_unref(rlo_blob *b)
{
    if (b && --b->refs == 0)
        rlo_pool_free(b);
}

/* One in-flight or delivered wire frame. Owned by the world until the
 * receiving engine polls it off its inbox; then owned by the engine
 * (which steals the frame ref). */
typedef struct rlo_wire_node {
    struct rlo_wire_node *next;
    int src, dst, tag, comm;
    uint64_t due; /* deliver-at tick (latency injection) */
    rlo_handle *handle;
    rlo_blob *frame; /* encoded frame bytes */
} rlo_wire_node;

/* ---- transport vtable ---- */
typedef struct rlo_transport_ops {
    const char *name;
    /* Send one encoded frame. The transport takes its own ref on `frame`
     * if it retains it (in-process delivery, pending MPI request);
     * cross-process transports may instead copy out of it. The caller
     * keeps its ref. */
    int (*isend)(rlo_world *w, int src, int dst, int comm, int tag,
                 rlo_blob *frame, rlo_handle **out);
    /* next frame addressed to (rank, comm), or NULL; caller owns it */
    rlo_wire_node *(*poll)(rlo_world *w, int rank, int comm);
    int (*quiescent)(const rlo_world *w);
    int64_t (*sent_cnt)(const rlo_world *w);
    int64_t (*delivered_cnt)(const rlo_world *w);
    /* transport-specific termination detection (reference cleanup drain,
     * rootless_ops.c:1613-1625); collective for multi-process transports */
    int (*drain)(rlo_world *w, int max_spins);
    /* 1 when the world is dead (a peer process failed); NULL = never */
    int (*failed)(const rlo_world *w);
    /* 1 when `rank` showed liveness within timeout_usec; NULL = the
     * transport has no liveness signal (peers always considered alive) */
    int (*peer_alive)(const rlo_world *w, int rank, uint64_t timeout_usec);
    /* fault injection: simulate `rank`'s process dying (in-process
     * transports only); NULL = unsupported */
    int (*kill_rank)(rlo_world *w, int rank);
    /* fault injection: drop / duplicate the next `count` frames sent
     * src -> dst (in-process transports only); NULL = unsupported */
    int (*drop_next)(rlo_world *w, int src, int dst, int count);
    int (*dup_next)(rlo_world *w, int src, int dst, int count);
    /* fault injection: group partition (NULL group_of = heal) and
     * killed-rank revival (in-process transports only);
     * NULL = unsupported */
    int (*partition)(rlo_world *w, const int *group_of, int n);
    int (*revive)(rlo_world *w, int rank);
    /* block until every rank reaches the barrier (multi-process
     * transports); NULL = no-op (single-process worlds need none) */
    void (*barrier)(rlo_world *w);
    void (*free_)(rlo_world *w);
    /* OPTIONAL zero-copy gather send (docs/DESIGN.md S13): transmit
     * `hdr` (exactly RLO_HEADER_SIZE bytes, copied out by the
     * transport — it is caller-stack staging) followed by `frame`'s
     * PAYLOAD bytes (frame->data + RLO_HEADER_SIZE, taken by ref) as
     * one wire frame of frame->len bytes. Lets the ARQ send gate
     * restamp the per-edge seq/epoch of a large message without
     * cloning the payload into a per-frame arena. NULL = unsupported
     * (rlo_world_isend_hdr materializes a contiguous copy instead). */
    int (*isend_hdr)(rlo_world *w, int src, int dst, int comm, int tag,
                     const uint8_t *hdr, rlo_blob *frame,
                     rlo_handle **out);
    /* OPTIONAL dead-time skip for the batched progress loop (docs/
     * DESIGN.md S13): jump the transport's virtual delivery clock
     * straight to the next due frame and make it pollable. Returns
     * the number of frames made deliverable (0 = nothing to
     * advance). rlo_world_progress_all_n MAY call this before any
     * sweep — the batched driver treats injected latency as dead
     * virtual time to be skipped, so relative ordering of deliveries
     * (due order per channel, pump walk order across channels) is
     * the contract, not the wall-time interleaving of in-flight
     * frames with engine activity (the one-sweep-per-call driver
     * keeps the historical tick-at-a-time pacing). Only meaningful
     * for transports with an injected-latency clock (loopback);
     * real-time transports leave it NULL. */
    int64_t (*advance)(rlo_world *w);
    /* OPTIONAL test-support direct delivery (rlo_world_inject): place
     * one frame in dst's inbox bypassing latency and fault injection —
     * the mirror of LoopbackWorld.inject, where src MAY be a dead rank
     * (a dead incarnation's stale frame arriving late is the point of
     * the quarantine scenarios). NULL = rlo_world_inject falls back to
     * ops->isend, which applies fault injection. */
    int (*inject)(rlo_world *w, int src, int dst, int comm, int tag,
                  rlo_blob *frame);
} rlo_transport_ops;

/* Payload size (bytes) at which the ARQ send gate switches from the
 * clone-and-stamp path to the header-staging zero-copy path. Small
 * frames keep the clone: a 28-byte-header gather costs more in
 * bookkeeping than a sub-page memcpy saves, and keeping the seeded
 * small-frame schedules on the historical path preserves them
 * byte for byte. */
#define RLO_ZC_MIN_PAYLOAD 4096

/* Base world: first member of every transport's world struct. */
struct rlo_world {
    const rlo_transport_ops *ops;
    int world_size;
    int my_rank; /* bound rank for one-process-per-rank transports; -1 =
                    this process hosts every rank (loopback) */
    rlo_engine **engines;
    int n_engines, cap_engines;
    int stepping; /* re-entrancy guard for rlo_progress_all */
    /* small-object freelists (see the pool block above); drained by
     * each transport's free_ right before it releases the struct */
    void *pool_free[RLO_POOL_CLASSES];
    /* world_sweep's engine snapshot, reused across sweeps (the
     * stepping guard makes one scratch per world safe) */
    rlo_engine **sweep_scratch;
    int sweep_cap;
};

/* World-side transport API used by the engine (dispatch wrappers in
 * rlo_world_common.c). */
int rlo_world_isend(rlo_world *w, int src, int dst, int comm, int tag,
                    rlo_blob *frame, rlo_handle **out);
/* Gather send: dispatches to ops->isend_hdr when the transport has
 * one, else materializes hdr + frame payload into a contiguous blob
 * and falls back to ops->isend (one copy — the pre-S13 behavior). */
int rlo_world_isend_hdr(rlo_world *w, int src, int dst, int comm,
                        int tag, const uint8_t *hdr, rlo_blob *frame,
                        rlo_handle **out);
rlo_wire_node *rlo_world_poll(rlo_world *w, int rank, int comm);
int rlo_world_register(rlo_world *w, rlo_engine *e);
void rlo_world_unregister(rlo_world *w, rlo_engine *e);

/* Engine-side hooks the world's progress loop drives. */
void rlo_engine_progress_once(rlo_engine *e);
/* One progress turn with a frame budget: the transport drain stops
 * after max_frames polled frames (the rest stay queued for the next
 * turn); max_frames < 0 = unbounded (progress_once). Returns frames
 * polled this turn. The batched entry points slice their budget
 * through this. */
int64_t rlo_engine_progress_budget(rlo_engine *e, int64_t max_frames);

/* Drain loop for transports whose quiescent() is globally accurate from
 * one process. */
int rlo_drain_local(rlo_world *w, int max_spins);

#endif /* RLO_INTERNAL_H */
