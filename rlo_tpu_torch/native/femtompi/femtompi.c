/* femtompi implementation — see mpi.h for scope and purpose.
 *
 * Architecture: the femtompirun launcher creates one POSIX shm segment
 * holding a header plus ws*ws SPSC byte rings (ring (s,d) is written
 * only by rank s and read only by rank d, so head/tail need only
 * acquire/release atomics — the same discipline as the framework's own
 * SHM transport, rlo_shm.c). Every rank mmaps the segment at MPI_Init
 * via env FEMTOMPI_SHM/FEMTOMPI_RANK.
 *
 * Point-to-point is eager: MPI_Isend copies the payload into a
 * request-owned staging buffer, then pushes [len|tag|comm|payload] into
 * ring (me, dst) — immediately, or lazily from the progress loop when
 * the ring is momentarily full (per-destination FIFO order preserved).
 * Receivers pump every inbound ring into a local unexpected-message
 * queue; MPI_Iprobe/MPI_Recv/MPI_Irecv match on (comm, source, tag)
 * with MPI_ANY_SOURCE and MPI_ANY_TAG (>= 0 tags only) wildcards.
 *
 * Collectives ride the same rings on reserved NEGATIVE tags with a
 * per-communicator lockstep sequence number (all ranks enter
 * collectives in the same order — an MPI requirement). MPI_Iallreduce
 * is a genuinely nonblocking state machine advanced by MPI_Test: ranks
 * send contributions to rank 0, rank 0 reduces and fans the result
 * back out; it reports completion only after every result frame is in
 * a ring, so a fast rank exiting right after completion cannot strand
 * a slow rank.
 */
#include "mpi.h"

#include <fcntl.h>
#include <sched.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/time.h>
#include <unistd.h>

#define FMPI_MAGIC 0xf3a90de5u
#define FMPI_MAX_COMMS 64
#define FMPI_REC_HDR 12 /* [len:u32][tag:i32][comm:i32] */

typedef struct fmpi_ring {
    _Atomic uint64_t head; /* written by the ring's writer rank */
    _Atomic uint64_t tail; /* written by the ring's reader rank */
    uint8_t buf[];         /* hdr->ring_bytes data bytes */
} fmpi_ring;

typedef struct fmpi_hdr {
    uint32_t magic;
    int32_t ws;
    uint64_t ring_bytes;
    uint64_t slot_size; /* sizeof(fmpi_ring) + ring_bytes, 64-aligned */
    _Atomic int abort_flag;
} fmpi_hdr;

typedef struct unode { /* one unexpected (pumped, unmatched) message */
    struct unode *next;
    int src, tag, comm;
    uint32_t len;
    uint8_t data[];
} unode;

struct fmpi_req {
    struct fmpi_req *next;
    int kind; /* 1 send, 2 recv, 3 iallreduce */
    int done, cancelled;
    /* send */
    int dst, tag, comm;
    uint32_t len;
    uint8_t *sbuf;
    /* recv */
    void *rbuf;
    uint64_t rcap;
    int rsrc, rtag, rcomm;
    MPI_Status st;
    /* iallreduce */
    MPI_Op op;
    MPI_Datatype dt;
    int count, ctag, got, stage;
    void *arbuf;
    uint8_t *acc;
    struct fmpi_req **fan; /* rank 0: result sends, ws entries;
                              non-root: the 1 contribution send */
    int n_fan;             /* entries in fan (for req_free reclaim) */
    uint64_t fan_made;     /* bit r: fan[r] was successfully created —
                              distinguishes 'reclaimed' (NULL, made)
                              from 'creation failed, retry' (NULL, not
                              made); ws <= 64 enforced at init */
};

static struct {
    int inited, rank, ws;
    fmpi_hdr *hdr;
    uint8_t *base;
    int next_comm;
    int coll_seq[FMPI_MAX_COMMS];
    unode *uq_head, *uq_tail;
    struct fmpi_req *act_head, *act_tail; /* active requests, FIFO */
} G;

/* ---------------- rings ---------------- */

static fmpi_ring *ring_of(int src, int dst)
{
    return (fmpi_ring *)(G.base + sizeof(fmpi_hdr) +
                         G.hdr->slot_size *
                             ((uint64_t)src * (uint64_t)G.hdr->ws + dst));
}

static uint64_t align8(uint64_t n)
{
    return (n + 7) & ~7ull;
}

static void ring_write(fmpi_ring *r, uint64_t pos, const void *src,
                       uint64_t n)
{
    uint64_t cap = G.hdr->ring_bytes, off = pos % cap;
    uint64_t first = n < cap - off ? n : cap - off;
    memcpy(r->buf + off, src, first);
    if (n > first)
        memcpy(r->buf, (const uint8_t *)src + first, n - first);
}

static void ring_read(fmpi_ring *r, uint64_t pos, void *dst, uint64_t n)
{
    uint64_t cap = G.hdr->ring_bytes, off = pos % cap;
    uint64_t first = n < cap - off ? n : cap - off;
    memcpy(dst, r->buf + off, first);
    if (n > first)
        memcpy((uint8_t *)dst + first, r->buf, n - first);
}

/* try to push one record; 1 on success, 0 when the ring is full */
static int ring_push(int dst, int tag, int comm, const uint8_t *data,
                     uint32_t len)
{
    fmpi_ring *r = ring_of(G.rank, dst);
    uint64_t need = align8(FMPI_REC_HDR + (uint64_t)len);
    uint64_t head = atomic_load_explicit(&r->head, memory_order_relaxed);
    uint64_t tail = atomic_load_explicit(&r->tail, memory_order_acquire);
    if (G.hdr->ring_bytes - (head - tail) < need)
        return 0;
    uint8_t hdr[FMPI_REC_HDR];
    memcpy(hdr, &len, 4);
    memcpy(hdr + 4, &tag, 4);
    memcpy(hdr + 8, &comm, 4);
    ring_write(r, head, hdr, FMPI_REC_HDR);
    if (len)
        ring_write(r, head + FMPI_REC_HDR, data, len);
    atomic_store_explicit(&r->head, head + need, memory_order_release);
    return 1;
}

/* pop every available record from every inbound ring into the
 * unexpected queue */
static int fmpi_pump(void)
{
    for (int s = 0; s < G.ws; s++) {
        if (s == G.rank)
            continue;
        fmpi_ring *r = ring_of(s, G.rank);
        for (;;) {
            uint64_t tail =
                atomic_load_explicit(&r->tail, memory_order_relaxed);
            uint64_t head =
                atomic_load_explicit(&r->head, memory_order_acquire);
            if (head == tail)
                break;
            uint8_t hdr[FMPI_REC_HDR];
            ring_read(r, tail, hdr, FMPI_REC_HDR);
            uint32_t len;
            int tag, comm;
            memcpy(&len, hdr, 4);
            memcpy(&tag, hdr + 4, 4);
            memcpy(&comm, hdr + 8, 4);
            unode *n = (unode *)malloc(sizeof(*n) + len);
            if (!n)
                return MPI_ERR_OTHER;
            n->next = 0;
            n->src = s;
            n->tag = tag;
            n->comm = comm;
            n->len = len;
            if (len)
                ring_read(r, tail + FMPI_REC_HDR, n->data, len);
            atomic_store_explicit(&r->tail,
                                  tail + align8(FMPI_REC_HDR + len),
                                  memory_order_release);
            if (G.uq_tail)
                G.uq_tail->next = n;
            else
                G.uq_head = n;
            G.uq_tail = n;
        }
    }
    return MPI_SUCCESS;
}

/* match (and optionally remove) the first unexpected message for
 * (comm, src, tag); ANY_TAG matches only tags >= 0 (negative tags are
 * internal collective traffic) */
static unode *uq_match(int comm, int src, int tag, int remove)
{
    unode *prev = 0;
    for (unode *n = G.uq_head; n; prev = n, n = n->next) {
        if (n->comm != comm)
            continue;
        if (src != MPI_ANY_SOURCE && n->src != src)
            continue;
        if (tag == MPI_ANY_TAG ? n->tag < 0 : n->tag != tag)
            continue;
        if (remove) {
            if (prev)
                prev->next = n->next;
            else
                G.uq_head = n->next;
            if (G.uq_tail == n)
                G.uq_tail = prev;
            n->next = 0;
        }
        return n;
    }
    return 0;
}

/* ---------------- requests + progress ---------------- */

static void act_append(struct fmpi_req *q)
{
    q->next = 0;
    if (G.act_tail)
        G.act_tail->next = q;
    else
        G.act_head = q;
    G.act_tail = q;
}

static void act_remove(struct fmpi_req *q)
{
    struct fmpi_req *prev = 0;
    for (struct fmpi_req *n = G.act_head; n; prev = n, n = n->next) {
        if (n != q)
            continue;
        if (prev)
            prev->next = n->next;
        else
            G.act_head = n->next;
        if (G.act_tail == n)
            G.act_tail = prev;
        n->next = 0;
        return;
    }
}

static int dt_size(MPI_Datatype dt)
{
    switch (dt) {
    case MPI_BYTE: return 1;
    case MPI_INT: case MPI_FLOAT: return 4;
    case MPI_INT64_T: case MPI_DOUBLE: return 8;
    }
    return -1;
}

static void reduce_in(MPI_Datatype dt, MPI_Op op, void *acc,
                      const void *in, int count)
{
#define CASE(T)                                                         \
    do {                                                                \
        T *a = (T *)acc;                                                \
        const T *b = (const T *)in;                                     \
        for (int i = 0; i < count; i++)                                 \
            a[i] = op == MPI_SUM   ? a[i] + b[i]                        \
                   : op == MPI_MIN ? (b[i] < a[i] ? b[i] : a[i])        \
                                   : (b[i] > a[i] ? b[i] : a[i]);       \
    } while (0)
    switch (dt) {
    case MPI_INT: CASE(int32_t); break;
    case MPI_INT64_T: CASE(int64_t); break;
    case MPI_FLOAT: CASE(float); break;
    case MPI_DOUBLE: CASE(double); break;
    default: break; /* MPI_BYTE reduction unsupported */
    }
#undef CASE
}

static void req_free(struct fmpi_req *q);

/* Does a frame of `len` payload bytes fit the per-pair ring at all?
 * Collectives check this symmetrically on EVERY rank before any
 * traffic: the sender-side failure alone would leave the peers parked
 * in blocking waits with no timeout (review finding). */
static int frame_fits(uint64_t len)
{
    return align8(FMPI_REC_HDR + len) <= G.hdr->ring_bytes;
}

static struct fmpi_req *send_req_new(int dst, int tag, int comm,
                                     const void *buf, uint64_t len)
{
    /* capacity check for EVERY send path (Isend, Bcast, Reduce,
     * Iallreduce fans): an oversized frame can never leave the queue —
     * ring_push would fail forever and the rank would spin until the
     * launcher timeout instead of returning an error (round-2 advisor
     * finding; the check used to live only in MPI_Isend) */
    if (!frame_fits(len)) {
        fprintf(stderr,
                "femtompi: message of %llu bytes exceeds ring capacity "
                "%llu (raise femtompirun -r)\n",
                (unsigned long long)len,
                (unsigned long long)G.hdr->ring_bytes);
        return 0;
    }
    struct fmpi_req *q = (struct fmpi_req *)calloc(1, sizeof(*q));
    if (!q)
        return 0;
    q->kind = 1;
    q->dst = dst;
    q->tag = tag;
    q->comm = comm;
    q->len = (uint32_t)len;
    q->sbuf = (uint8_t *)malloc(len ? len : 1);
    if (!q->sbuf) {
        free(q);
        return 0;
    }
    if (len)
        memcpy(q->sbuf, buf, len);
    act_append(q);
    return q;
}

static void fmpi_progress(void)
{
    /* 1. flush queued sends, preserving per-destination FIFO order */
    uint64_t blocked = 0; /* dst bitmask (ws <= 64 enforced at init) */
    for (struct fmpi_req *q = G.act_head; q; q = q->next) {
        if (q->kind != 1 || q->done)
            continue;
        if (q->dst < 64 && (blocked >> q->dst) & 1)
            continue;
        if (ring_push(q->dst, q->tag, q->comm, q->sbuf, q->len)) {
            q->done = 1;
            free(q->sbuf);
            q->sbuf = 0;
        } else if (q->dst < 64) {
            blocked |= 1ull << q->dst;
        }
    }
    /* 2. pump inbound traffic */
    fmpi_pump();
    /* 3. advance recvs and allreduces */
    for (struct fmpi_req *q = G.act_head; q; q = q->next) {
        if (q->done)
            continue;
        if (q->kind == 2) {
            unode *n = uq_match(q->rcomm, q->rsrc, q->rtag, 1);
            if (!n)
                continue;
            uint32_t cp = n->len < q->rcap ? n->len : (uint32_t)q->rcap;
            if (cp)
                memcpy(q->rbuf, n->data, cp);
            q->st.MPI_SOURCE = n->src;
            q->st.MPI_TAG = n->tag;
            q->st.MPI_ERROR = MPI_SUCCESS;
            q->st._count = (int)n->len;
            free(n);
            q->done = 1;
        } else if (q->kind == 3) {
            int64_t bytes = (int64_t)q->count * dt_size(q->dt);
            if (G.rank != 0) {
                /* stage 0: contribution queued at post time; wait for
                 * the result from rank 0 */
                unode *n = uq_match(q->comm, 0, q->ctag, 1);
                if (!n)
                    continue;
                memcpy(q->arbuf, n->data, bytes);
                free(n);
                /* the contribution send must be done by now (rank 0
                 * reduced it); reclaim it */
                if (q->fan && q->fan[0]) {
                    req_free(q->fan[0]);
                    q->fan[0] = 0;
                }
                q->done = 1;
            } else {
                while (q->got < G.ws - 1) {
                    unode *n =
                        uq_match(q->comm, MPI_ANY_SOURCE, q->ctag, 1);
                    if (!n)
                        break;
                    reduce_in(q->dt, q->op, q->acc, n->data, q->count);
                    free(n);
                    q->got++;
                }
                if (q->got < G.ws - 1)
                    continue;
                if (q->stage == 0) { /* fan the result out once */
                    if (!q->fan) {
                        q->fan = (struct fmpi_req **)calloc(
                            (size_t)G.ws, sizeof(*q->fan));
                        if (!q->fan)
                            continue;
                        q->n_fan = G.ws;
                    }
                    /* retry creation until every result send exists:
                     * treating a failed creation like a reclaimed
                     * (delivered) send would report success while the
                     * peer waits forever (review finding) */
                    int missing = 0;
                    for (int r = 1; r < G.ws; r++) {
                        if (q->fan_made & (1ull << r))
                            continue;
                        q->fan[r] = send_req_new(r, q->ctag, q->comm,
                                                 q->acc,
                                                 (uint64_t)bytes);
                        if (q->fan[r])
                            q->fan_made |= 1ull << r;
                        else
                            missing = 1;
                    }
                    if (missing)
                        continue;
                    memcpy(q->arbuf, q->acc, bytes);
                    q->stage = 1;
                }
                /* complete only when every result frame is in a ring:
                 * a fast rank exiting right after completion must not
                 * strand a slow one. Reclaim fan sends as they land. */
                int all = 1;
                for (int r = 1; r < G.ws; r++) {
                    if (!q->fan[r])
                        continue;
                    if (q->fan[r]->done) {
                        req_free(q->fan[r]);
                        q->fan[r] = 0;
                    } else {
                        all = 0;
                    }
                }
                if (all)
                    q->done = 1;
            }
        }
    }
}

static void req_free(struct fmpi_req *q)
{
    act_remove(q);
    free(q->sbuf);
    free(q->acc);
    if (q->fan) {
        /* freeing an in-flight collective: release any still-active
         * fan sub-requests too, or they stay on the active list
         * forever (round-2 advisor finding) */
        for (int i = 0; i < q->n_fan; i++)
            if (q->fan[i])
                req_free(q->fan[i]);
        free(q->fan);
    }
    free(q);
}

/* ---------------- init / teardown ---------------- */

int MPI_Init(int *argc, char ***argv)
{
    (void)argc;
    (void)argv;
    if (G.inited)
        return MPI_ERR_OTHER;
    const char *name = getenv("FEMTOMPI_SHM");
    const char *rank = getenv("FEMTOMPI_RANK");
    if (!name || !rank) {
        fprintf(stderr,
                "femtompi: not launched under femtompirun "
                "(FEMTOMPI_SHM/FEMTOMPI_RANK unset)\n");
        return MPI_ERR_OTHER;
    }
    int fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0)
        return MPI_ERR_OTHER;
    struct stat stbuf;
    if (fstat(fd, &stbuf) != 0) {
        close(fd);
        return MPI_ERR_OTHER;
    }
    void *m = mmap(0, (size_t)stbuf.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
    close(fd);
    if (m == MAP_FAILED)
        return MPI_ERR_OTHER;
    G.hdr = (fmpi_hdr *)m;
    G.base = (uint8_t *)m;
    if (G.hdr->magic != FMPI_MAGIC || G.hdr->ws < 2 || G.hdr->ws > 64)
        return MPI_ERR_OTHER;
    G.rank = atoi(rank);
    G.ws = G.hdr->ws;
    G.next_comm = 1;
    G.inited = 1;
    return MPI_SUCCESS;
}

int MPI_Initialized(int *flag)
{
    *flag = G.inited;
    return MPI_SUCCESS;
}

int MPI_Finalize(void)
{
    if (!G.inited)
        return MPI_ERR_OTHER;
    MPI_Barrier(MPI_COMM_WORLD);
    G.inited = 0;
    return MPI_SUCCESS;
}

int MPI_Abort(MPI_Comm comm, int errorcode)
{
    (void)comm;
    if (G.hdr)
        atomic_store(&G.hdr->abort_flag, 1);
    _exit(errorcode ? errorcode : 1);
}

double MPI_Wtime(void)
{
    struct timeval tv;
    gettimeofday(&tv, 0);
    return (double)tv.tv_sec + (double)tv.tv_usec * 1e-6;
}

/* ---------------- communicators ---------------- */

int MPI_Comm_dup(MPI_Comm comm, MPI_Comm *newcomm)
{
    (void)comm;
    if (G.next_comm >= FMPI_MAX_COMMS)
        return MPI_ERR_OTHER;
    *newcomm = G.next_comm++; /* all ranks dup in the same order */
    return MPI_SUCCESS;
}

int MPI_Comm_free(MPI_Comm *comm)
{
    *comm = MPI_COMM_NULL;
    return MPI_SUCCESS;
}

int MPI_Comm_size(MPI_Comm comm, int *size)
{
    (void)comm;
    *size = G.ws;
    return MPI_SUCCESS;
}

int MPI_Comm_rank(MPI_Comm comm, int *rank)
{
    (void)comm;
    *rank = G.rank;
    return MPI_SUCCESS;
}

/* ---------------- point-to-point ---------------- */

int MPI_Isend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm, MPI_Request *req)
{
    int sz = dt_size(dt);
    if (!G.inited || sz < 0 || count < 0 || dest < 0 || dest >= G.ws ||
        dest == G.rank)
        return MPI_ERR_OTHER;
    uint64_t len = (uint64_t)count * (uint64_t)sz;
    struct fmpi_req *q = send_req_new(dest, tag, comm, buf, len);
    if (!q) /* includes the ring-capacity check (reported to stderr) */
        return MPI_ERR_OTHER;
    fmpi_progress(); /* often completes the push immediately */
    *req = q;
    return MPI_SUCCESS;
}

int MPI_Send(const void *buf, int count, MPI_Datatype dt, int dest,
             int tag, MPI_Comm comm)
{
    MPI_Request q;
    int rc = MPI_Isend(buf, count, dt, dest, tag, comm, &q);
    if (rc != MPI_SUCCESS)
        return rc;
    return MPI_Wait(&q, MPI_STATUS_IGNORE);
}

int MPI_Irecv(void *buf, int count, MPI_Datatype dt, int source, int tag,
              MPI_Comm comm, MPI_Request *req)
{
    int sz = dt_size(dt);
    if (!G.inited || sz < 0 || count < 0)
        return MPI_ERR_OTHER;
    struct fmpi_req *q = (struct fmpi_req *)calloc(1, sizeof(*q));
    if (!q)
        return MPI_ERR_OTHER;
    q->kind = 2;
    q->rbuf = buf;
    q->rcap = (uint64_t)count * (uint64_t)sz;
    q->rsrc = source;
    q->rtag = tag;
    q->rcomm = comm;
    act_append(q);
    fmpi_progress();
    *req = q;
    return MPI_SUCCESS;
}

int MPI_Recv(void *buf, int count, MPI_Datatype dt, int source, int tag,
             MPI_Comm comm, MPI_Status *status)
{
    MPI_Request q;
    int rc = MPI_Irecv(buf, count, dt, source, tag, comm, &q);
    if (rc != MPI_SUCCESS)
        return rc;
    return MPI_Wait(&q, status);
}

int MPI_Iprobe(int source, int tag, MPI_Comm comm, int *flag,
               MPI_Status *status)
{
    if (!G.inited)
        return MPI_ERR_OTHER;
    fmpi_progress();
    unode *n = uq_match(comm, source, tag, 0);
    *flag = n != 0;
    if (n && status) {
        status->MPI_SOURCE = n->src;
        status->MPI_TAG = n->tag;
        status->MPI_ERROR = MPI_SUCCESS;
        status->_count = (int)n->len;
    }
    return MPI_SUCCESS;
}

int MPI_Get_count(const MPI_Status *status, MPI_Datatype dt, int *count)
{
    int sz = dt_size(dt);
    if (!status || sz <= 0)
        return MPI_ERR_OTHER;
    *count = status->_count / sz;
    return MPI_SUCCESS;
}

int MPI_Test(MPI_Request *req, int *flag, MPI_Status *status)
{
    if (!req)
        return MPI_ERR_OTHER;
    if (*req == MPI_REQUEST_NULL) { /* null/inactive: complete */
        *flag = 1;
        return MPI_SUCCESS;
    }
    fmpi_progress();
    struct fmpi_req *q = *req;
    *flag = q->done || q->cancelled;
    if (*flag) {
        if (status)
            *status = q->st;
        req_free(q);
        *req = MPI_REQUEST_NULL;
    }
    return MPI_SUCCESS;
}

int MPI_Wait(MPI_Request *req, MPI_Status *status)
{
    int flag = 0;
    while (!flag) {
        int rc = MPI_Test(req, &flag, status);
        if (rc != MPI_SUCCESS)
            return rc;
        if (!flag)
            sched_yield();
    }
    return MPI_SUCCESS;
}

int MPI_Cancel(MPI_Request *req)
{
    if (!req || *req == MPI_REQUEST_NULL)
        return MPI_ERR_OTHER;
    (*req)->cancelled = 1; /* recvs only; sends are eager (always run) */
    return MPI_SUCCESS;
}

int MPI_Request_free(MPI_Request *req)
{
    if (req && *req != MPI_REQUEST_NULL) {
        req_free(*req);
        *req = MPI_REQUEST_NULL;
    }
    return MPI_SUCCESS;
}

/* ---------------- collectives ---------------- */

static int coll_tag(MPI_Comm comm)
{
    /* lockstep per-comm sequence -> unique negative tag per instance */
    if (comm < 0 || comm >= FMPI_MAX_COMMS)
        return MPI_ANY_TAG; /* unreachable for valid comms */
    return -2 - (G.coll_seq[comm]++ & 0x0fffffff);
}

int MPI_Iallreduce(const void *sendbuf, void *recvbuf, int count,
                   MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
                   MPI_Request *req)
{
    int sz = dt_size(dt);
    if (!G.inited || sz <= 0 || count < 0)
        return MPI_ERR_OTHER;
    /* int64: count * sz overflows int for large counts (advisor) */
    int64_t bytes = (int64_t)count * sz;
    if (!frame_fits((uint64_t)bytes))
        return MPI_ERR_OTHER; /* symmetric: every rank rejects */
    struct fmpi_req *q = (struct fmpi_req *)calloc(1, sizeof(*q));
    if (!q)
        return MPI_ERR_OTHER;
    q->kind = 3;
    q->op = op;
    q->dt = dt;
    q->count = count;
    q->comm = comm;
    q->ctag = coll_tag(comm);
    q->arbuf = recvbuf;
    if (G.rank == 0) {
        q->acc = (uint8_t *)malloc((size_t)(bytes ? bytes : 1));
        if (!q->acc) {
            free(q);
            return MPI_ERR_OTHER;
        }
        memcpy(q->acc, sendbuf, (size_t)bytes);
        act_append(q);
    } else {
        q->fan = (struct fmpi_req **)calloc(1, sizeof(*q->fan));
        q->n_fan = 1;
        act_append(q);
        if (!q->fan ||
            !(q->fan[0] = send_req_new(0, q->ctag, comm, sendbuf,
                                       (uint64_t)bytes))) {
            act_remove(q);
            free(q->fan);
            free(q);
            return MPI_ERR_OTHER;
        }
    }
    fmpi_progress();
    *req = q;
    return MPI_SUCCESS;
}

int MPI_Allreduce(const void *sendbuf, void *recvbuf, int count,
                  MPI_Datatype dt, MPI_Op op, MPI_Comm comm)
{
    MPI_Request q;
    int rc = MPI_Iallreduce(sendbuf, recvbuf, count, dt, op, comm, &q);
    if (rc != MPI_SUCCESS)
        return rc;
    return MPI_Wait(&q, MPI_STATUS_IGNORE);
}

int MPI_Barrier(MPI_Comm comm)
{
    int in = 0, out = 0;
    return MPI_Allreduce(&in, &out, 1, MPI_INT, MPI_SUM, comm);
}

int MPI_Bcast(void *buf, int count, MPI_Datatype dt, int root,
              MPI_Comm comm)
{
    int sz = dt_size(dt);
    if (!G.inited || sz <= 0 || count < 0 || root < 0 || root >= G.ws)
        return MPI_ERR_OTHER;
    int tag = coll_tag(comm);
    int64_t bytes = (int64_t)count * sz;
    if (!frame_fits((uint64_t)bytes))
        return MPI_ERR_OTHER; /* symmetric: every rank rejects */
    if (G.rank == root) {
        for (int r = 0; r < G.ws; r++) {
            if (r == root)
                continue;
            struct fmpi_req *s =
                send_req_new(r, tag, comm, buf, (uint64_t)bytes);
            if (!s)
                return MPI_ERR_OTHER;
            while (!s->done) { /* block until in the ring */
                fmpi_progress();
                if (!s->done)
                    sched_yield();
            }
            req_free(s);
        }
        return MPI_SUCCESS;
    }
    return MPI_Recv(buf, count, dt, root, tag, comm, MPI_STATUS_IGNORE);
}

int MPI_Reduce(const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype dt, MPI_Op op, int root, MPI_Comm comm)
{
    int sz = dt_size(dt);
    if (!G.inited || sz <= 0 || count < 0 || root < 0 || root >= G.ws)
        return MPI_ERR_OTHER;
    int tag = coll_tag(comm);
    int64_t bytes = (int64_t)count * sz;
    if (!frame_fits((uint64_t)bytes))
        return MPI_ERR_OTHER; /* symmetric: every rank rejects */
    if (G.rank != root) {
        struct fmpi_req *s =
            send_req_new(root, tag, comm, sendbuf, (uint64_t)bytes);
        if (!s)
            return MPI_ERR_OTHER;
        while (!s->done) {
            fmpi_progress();
            if (!s->done)
                sched_yield();
        }
        req_free(s);
        return MPI_SUCCESS;
    }
    memcpy(recvbuf, sendbuf, (size_t)bytes);
    for (int got = 0; got < G.ws - 1;) {
        fmpi_progress();
        unode *n = uq_match(comm, MPI_ANY_SOURCE, tag, 1);
        if (!n) {
            sched_yield();
            continue;
        }
        reduce_in(dt, op, recvbuf, n->data, count);
        free(n);
        got++;
    }
    return MPI_SUCCESS;
}
