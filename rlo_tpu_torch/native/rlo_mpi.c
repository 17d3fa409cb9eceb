/* MPI point-to-point transport — CPU-cluster parity with the reference.
 *
 * The reference hardwires nonblocking MPI P2P throughout rootless_ops.c
 * (MPI_Isend :1123/1152/1588, MPI_Irecv :656, MPI_Test :647); here the
 * same calls sit behind the transport vtable so the engine code is
 * shared with the loopback and SHM transports. Compile-gated on
 * RLO_HAVE_MPI (the build autodetects mpi.h): without MPI the stubs
 * below keep the library linkable and `rlo_mpi_available()` reports 0 so
 * the ROOTLESS_BACKEND=mpi switch can fail with a clear message instead
 * of an undefined symbol.
 *
 * Differences from the reference worth noting:
 *   - variable-size frames (MPI_Get_count sizes the receive) instead of
 *     fixed 32 KB sends (rootless_ops.c:1588);
 *   - engine `comm` ids are multiplexed into the MPI tag
 *     (mpi_tag = comm * 16 + rlo_tag) rather than one dup'ed MPI
 *     communicator per engine (:1461) — same isolation, no collective
 *     setup per engine;
 *   - termination detection generalizes the reference's
 *     MPI_Iallreduce-over-bcast-counts drain (:1613-1625): a nonblocking
 *     allreduce of [global sent, global delivered] must agree twice in a
 *     row while every local engine is idle.
 */
#include "rlo_internal.h"

#include <sched.h>
#include <stdio.h>

int rlo_mpi_available(void)
{
#ifdef RLO_HAVE_MPI
    return 1;
#else
    return 0;
#endif
}

#ifndef RLO_HAVE_MPI

rlo_world *rlo_mpi_world_new(void)
{
    return 0;
}

#else /* RLO_HAVE_MPI */

#include <mpi.h>

#define MPI_TAG_STRIDE 16 /* rlo tags occupy [0, 16) */

/* one outstanding MPI_Isend: the buffer must stay alive until tested
 * complete (the reference parks msgs in queue_wait for the same reason,
 * rootless_ops.c:1594) */
typedef struct mpi_send_node {
    struct mpi_send_node *next;
    MPI_Request req;
    rlo_handle *handle;
    rlo_blob *frame; /* ref held until MPI_Test reports completion */
} mpi_send_node;

typedef struct rlo_mpi_world {
    rlo_world base;
    MPI_Comm comm;
    mpi_send_node *sends; /* untested isends */
    rlo_wire_node *inbox_head, *inbox_tail; /* received, un-polled */
    int64_t sent_cnt, recv_cnt;
} rlo_mpi_world;

static void mpi_test_sends(rlo_mpi_world *w)
{
    mpi_send_node **pp = &w->sends;
    while (*pp) {
        mpi_send_node *n = *pp;
        int done = 0;
        MPI_Test(&n->req, &done, MPI_STATUS_IGNORE);
        if (done) {
            n->handle->delivered = 1;
            rlo_handle_unref(n->handle);
            rlo_blob_unref(n->frame);
            *pp = n->next;
            free(n);
        } else {
            pp = &n->next;
        }
    }
}

static int mpi_isend(rlo_world *base, int src, int dst, int comm, int tag,
                     rlo_blob *frame, rlo_handle **out)
{
    rlo_mpi_world *w = (rlo_mpi_world *)base;
    if (dst < 0 || dst >= base->world_size || !frame || frame->len < 0 ||
        src != base->my_rank)
        return RLO_ERR_ARG;
    int64_t len = frame->len;
    mpi_send_node *n = (mpi_send_node *)calloc(1, sizeof(*n));
    /* world ref + optional caller ref */
    rlo_handle *h = rlo_handle_new_w(base, out ? 2 : 1);
    if (!n || !h) {
        free(n);
        rlo_pool_free(h);
        return RLO_ERR_NOMEM;
    }
    /* zero-copy: MPI sends straight from the shared frame blob, whose
     * ref is held until MPI_Test reports completion */
    n->frame = rlo_blob_ref(frame);
    n->handle = h;
    if (MPI_Isend(frame->data, (int)len, MPI_BYTE, dst,
                  comm * MPI_TAG_STRIDE + tag, w->comm,
                  &n->req) != MPI_SUCCESS) {
        rlo_blob_unref(n->frame);
        free(n);
        rlo_pool_free(h);
        return RLO_ERR_PROTO;
    }
    n->next = w->sends;
    w->sends = n;
    w->sent_cnt++;
    if (out)
        *out = h;
    return RLO_OK;
}

/* move every probe-able incoming message into the local inbox */
static int mpi_pump(rlo_mpi_world *w)
{
    for (;;) {
        int flag = 0;
        MPI_Status st;
        MPI_Iprobe(MPI_ANY_SOURCE, MPI_ANY_TAG, w->comm, &flag, &st);
        if (!flag)
            return RLO_OK;
        int nbytes = 0;
        MPI_Get_count(&st, MPI_BYTE, &nbytes);
        rlo_wire_node *n =
            (rlo_wire_node *)rlo_pool_alloc(&w->base, sizeof(*n));
        rlo_blob *frame = rlo_blob_new_w(&w->base, nbytes);
        if (!n || !frame) {
            rlo_pool_free(n);
            rlo_blob_unref(frame);
            return RLO_ERR_NOMEM;
        }
        n->next = 0;
        n->src = st.MPI_SOURCE;
        n->dst = w->base.my_rank;
        n->tag = st.MPI_TAG % MPI_TAG_STRIDE;
        n->comm = st.MPI_TAG / MPI_TAG_STRIDE;
        n->due = 0;
        n->frame = frame;
        n->handle = rlo_handle_new_w(&w->base, 1);
        if (!n->handle) {
            rlo_pool_free(n);
            rlo_blob_unref(frame);
            return RLO_ERR_NOMEM;
        }
        n->handle->delivered = 1;
        MPI_Recv(frame->data, nbytes, MPI_BYTE, st.MPI_SOURCE, st.MPI_TAG,
                 w->comm, MPI_STATUS_IGNORE);
        w->recv_cnt++;
        if (w->inbox_tail)
            w->inbox_tail->next = n;
        else
            w->inbox_head = n;
        w->inbox_tail = n;
    }
}

static rlo_wire_node *mpi_poll(rlo_world *base, int rank, int comm)
{
    rlo_mpi_world *w = (rlo_mpi_world *)base;
    if (rank != base->my_rank)
        return 0;
    mpi_test_sends(w);
    mpi_pump(w);
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
        return n;
    }
    return 0;
}

static int mpi_quiescent(const rlo_world *base)
{
    const rlo_mpi_world *w = (const rlo_mpi_world *)base;
    /* local view only; global truth needs the drain protocol */
    return w->sends == 0 && w->inbox_head == 0;
}

static int64_t mpi_sent(const rlo_world *base)
{
    return ((const rlo_mpi_world *)base)->sent_cnt;
}

static int64_t mpi_delivered(const rlo_world *base)
{
    return ((const rlo_mpi_world *)base)->recv_cnt;
}

/* Drain: nonblocking allreduce of [sent, recvd]; terminate when the
 * global sums agree twice consecutively with all local engines idle
 * (generalizes reference rootless_ops.c:1613-1625). Collective. */
static int mpi_drain(rlo_world *base, int max_spins)
{
    rlo_mpi_world *w = (rlo_mpi_world *)base;
    int64_t prev_sum[2] = {-1, -2};
    for (int i = 0; i < max_spins; i++) {
        rlo_progress_all(base);
        int local_idle = 1;
        for (int j = 0; j < base->n_engines; j++)
            if (!rlo_engine_idle(base->engines[j]))
                local_idle = 0;
        if (!local_idle || !mpi_quiescent(base)) {
            if ((i & 7) == 7) /* oversubscribed cores: let peers run */
                sched_yield();
            continue;
        }
        int64_t local[2] = {w->sent_cnt, w->recv_cnt};
        int64_t sum[2] = {0, 0};
        MPI_Request req;
        MPI_Iallreduce(local, sum, 2, MPI_INT64_T, MPI_SUM, w->comm,
                       &req);
        int done = 0;
        for (long t = 0; !done; t++) {
            if (t > (long)max_spins * 1000L) {
                /* a peer never posted its matching Iallreduce (it
                 * stalled or died). The request cannot be cancelled
                 * portably; leaking it is the least-bad option on this
                 * already-fatal path. */
                return RLO_ERR_STALL;
            }
            MPI_Test(&req, &done, MPI_STATUS_IGNORE);
            rlo_progress_all(base); /* keep draining while reducing */
            if (!done && (t & 7) == 7)
                sched_yield(); /* peers must reach their Iallreduce */
        }
        if (sum[0] == sum[1] && sum[0] == prev_sum[0] &&
            prev_sum[0] == prev_sum[1])
            return i;
        prev_sum[0] = sum[0];
        prev_sum[1] = sum[1];
    }
    return RLO_ERR_STALL;
}

static void mpi_free(rlo_world *base)
{
    rlo_mpi_world *w = (rlo_mpi_world *)base;
    mpi_test_sends(w);
    for (mpi_send_node *n = w->sends; n;) {
        mpi_send_node *nn = n->next;
        /* Never MPI_Cancel a send: Open MPI >= 4 aborts on it and a
         * cancel that no-ops would leave MPI_Wait blocking on a dead
         * receiver. Real-time deadline; on timeout leak the request AND
         * the buffer (MPI may still be reading it) — this path is only
         * reachable after a failed drain, where the job is lost anyway. */
        int done = 0;
        uint64_t deadline = rlo_now_usec() + 5 * 1000 * 1000;
        while (!done && rlo_now_usec() < deadline)
            MPI_Test(&n->req, &done, MPI_STATUS_IGNORE);
        rlo_handle_unref(n->handle);
        if (done) {
            rlo_blob_unref(n->frame);
            free(n);
        }
        n = nn;
    }
    for (rlo_wire_node *n = w->inbox_head; n;) {
        rlo_wire_node *nn = n->next;
        rlo_handle_unref(n->handle);
        rlo_blob_unref(n->frame);
        rlo_pool_free(n);
        n = nn;
    }
    MPI_Comm_free(&w->comm);
    free(base->engines);
    rlo_pool_drain(base);
    free(w);
}

static void mpi_barrier(rlo_world *base)
{
    MPI_Barrier(((rlo_mpi_world *)base)->comm);
}

static const rlo_transport_ops MPI_OPS = {
    .name = "mpi",
    .isend = mpi_isend,
    .poll = mpi_poll,
    .quiescent = mpi_quiescent,
    .sent_cnt = mpi_sent,
    .delivered_cnt = mpi_delivered,
    .drain = mpi_drain,
    .barrier = mpi_barrier,
    .free_ = mpi_free,
};

rlo_world *rlo_mpi_world_new(void)
{
    int inited = 0;
    MPI_Initialized(&inited);
    if (!inited)
        MPI_Init(0, 0);
    rlo_mpi_world *w = (rlo_mpi_world *)calloc(1, sizeof(*w));
    if (!w)
        return 0;
    w->base.ops = &MPI_OPS;
    /* isolated traffic, like the reference's dup at bcomm_init :1461 */
    if (MPI_Comm_dup(MPI_COMM_WORLD, &w->comm) != MPI_SUCCESS) {
        free(w);
        return 0;
    }
    MPI_Comm_size(w->comm, &w->base.world_size);
    MPI_Comm_rank(w->comm, &w->base.my_rank);
    if (w->base.world_size < 2) {
        MPI_Comm_free(&w->comm);
        free(w);
        return 0;
    }
    return &w->base;
}

#endif /* RLO_HAVE_MPI */
