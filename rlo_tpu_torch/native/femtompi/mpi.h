/* femtompi — a FUNCTIONAL single-host MPI subset over POSIX shared
 * memory, with standard MPI-3 signatures.
 *
 * Purpose: the container has no MPI installation, but the framework's
 * MPI transport (rlo_mpi.c, compile-gated on RLO_HAVE_MPI) must be
 * EXECUTED, not just syntax-checked (BASELINE config 1 runs "testcases
 * via mpirun on CPU"; the reference's whole L0 is live MPI P2P,
 * rootless_ops.c:656,1123,1613). femtompi implements the
 * exact subset rlo_mpi.c and the demo benchmark cases use — eager
 * point-to-point over per-pair SPSC shared-memory rings, ANY_SOURCE/
 * ANY_TAG probing, nonblocking sends, a nonblocking allreduce, and the
 * classic blocking collectives — so `femtompirun -n 8 ./rlo_demo_mpi`
 * drives every rlo_mpi.c code path with real multi-process traffic.
 * The same sources compile unmodified against a real MPI (signatures
 * are standard); femtompi is the vehicle, not the destination.
 *
 * Scope notes (documented deviations, all safe for our callers):
 *   - MPI_ANY_TAG matches only tags >= 0; negative tags are reserved
 *     for femtompi's internal collective protocol messages.
 *   - Communicators are small integer ids; MPI_Comm_dup is collective
 *     only in the sense that all ranks must dup in the same order
 *     (true for rlo_mpi_world_new, and for ordinary MPI programs).
 *   - One process per rank, one host; rendezvous via the segment the
 *     femtompirun launcher creates (env FEMTOMPI_SHM/RANK/SIZE).
 */
#ifndef FEMTOMPI_MPI_H
#define FEMTOMPI_MPI_H

#ifdef __cplusplus
extern "C" {
#endif

typedef int MPI_Comm;
typedef struct fmpi_req *MPI_Request;
typedef struct {
    int MPI_SOURCE, MPI_TAG, MPI_ERROR;
    int _count; /* internal: payload bytes of the matched message */
} MPI_Status;
typedef int MPI_Datatype;
typedef int MPI_Op;

#define MPI_SUCCESS 0
#define MPI_ERR_OTHER 15
#define MPI_COMM_WORLD ((MPI_Comm)0)
#define MPI_COMM_NULL ((MPI_Comm)-1)
#define MPI_REQUEST_NULL ((MPI_Request)0)

#define MPI_BYTE ((MPI_Datatype)0)
#define MPI_INT ((MPI_Datatype)1)
#define MPI_INT64_T ((MPI_Datatype)2)
#define MPI_FLOAT ((MPI_Datatype)3)
#define MPI_DOUBLE ((MPI_Datatype)4)

#define MPI_SUM ((MPI_Op)0)
#define MPI_MIN ((MPI_Op)1)
#define MPI_MAX ((MPI_Op)2)

#define MPI_ANY_SOURCE (-2)
#define MPI_ANY_TAG (-1)
#define MPI_STATUS_IGNORE ((MPI_Status *)0)

int MPI_Init(int *argc, char ***argv);
int MPI_Initialized(int *flag);
int MPI_Finalize(void);
int MPI_Abort(MPI_Comm comm, int errorcode);
double MPI_Wtime(void);

int MPI_Comm_dup(MPI_Comm comm, MPI_Comm *newcomm);
int MPI_Comm_free(MPI_Comm *comm);
int MPI_Comm_size(MPI_Comm comm, int *size);
int MPI_Comm_rank(MPI_Comm comm, int *rank);

int MPI_Isend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm, MPI_Request *req);
int MPI_Send(const void *buf, int count, MPI_Datatype dt, int dest,
             int tag, MPI_Comm comm);
int MPI_Irecv(void *buf, int count, MPI_Datatype dt, int source, int tag,
              MPI_Comm comm, MPI_Request *req);
int MPI_Recv(void *buf, int count, MPI_Datatype dt, int source, int tag,
             MPI_Comm comm, MPI_Status *status);
int MPI_Iprobe(int source, int tag, MPI_Comm comm, int *flag,
               MPI_Status *status);
int MPI_Get_count(const MPI_Status *status, MPI_Datatype dt, int *count);
int MPI_Test(MPI_Request *req, int *flag, MPI_Status *status);
int MPI_Wait(MPI_Request *req, MPI_Status *status);
int MPI_Cancel(MPI_Request *req);
int MPI_Request_free(MPI_Request *req);

int MPI_Iallreduce(const void *sendbuf, void *recvbuf, int count,
                   MPI_Datatype dt, MPI_Op op, MPI_Comm comm,
                   MPI_Request *req);
int MPI_Allreduce(const void *sendbuf, void *recvbuf, int count,
                  MPI_Datatype dt, MPI_Op op, MPI_Comm comm);
int MPI_Reduce(const void *sendbuf, void *recvbuf, int count,
               MPI_Datatype dt, MPI_Op op, int root, MPI_Comm comm);
int MPI_Bcast(void *buf, int count, MPI_Datatype dt, int root,
              MPI_Comm comm);
int MPI_Barrier(MPI_Comm comm);

#ifdef __cplusplus
}
#endif

#endif /* FEMTOMPI_MPI_H */
