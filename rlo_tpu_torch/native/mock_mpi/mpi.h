/* Minimal MPI-3 declaration shim — COMPILE CHECKING ONLY.
 *
 * The container has no MPI installation, so the real rlo_mpi.c transport
 * path (#ifdef RLO_HAVE_MPI) would otherwise never be seen by a
 * compiler. `make mpicheck` (and tests/test_native_core.py) runs
 *   cc -fsyntax-only -DRLO_HAVE_MPI -Imock_mpi rlo_mpi.c
 * against this header to keep that path syntactically and
 * type-checkably valid. It declares exactly the subset rlo_mpi.c uses,
 * with standard MPI-3 signatures; it implements nothing and must never
 * be linked.
 */
#ifndef RLO_MOCK_MPI_H
#define RLO_MOCK_MPI_H

typedef struct rlo_mock_comm *MPI_Comm;
typedef struct rlo_mock_req *MPI_Request;
typedef struct { int MPI_SOURCE, MPI_TAG, MPI_ERROR; } MPI_Status;
typedef int MPI_Datatype;
typedef int MPI_Op;

#define MPI_SUCCESS 0
#define MPI_COMM_WORLD ((MPI_Comm)0)
#define MPI_BYTE ((MPI_Datatype)1)
#define MPI_INT64_T ((MPI_Datatype)2)
#define MPI_SUM ((MPI_Op)1)
#define MPI_ANY_SOURCE (-2)
#define MPI_ANY_TAG (-1)
#define MPI_STATUS_IGNORE ((MPI_Status *)0)

int MPI_Init(int *argc, char ***argv);
int MPI_Initialized(int *flag);
int MPI_Comm_dup(MPI_Comm comm, MPI_Comm *newcomm);
int MPI_Comm_free(MPI_Comm *comm);
int MPI_Comm_size(MPI_Comm comm, int *size);
int MPI_Comm_rank(MPI_Comm comm, int *rank);
int MPI_Isend(const void *buf, int count, MPI_Datatype dt, int dest,
              int tag, MPI_Comm comm, MPI_Request *req);
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
int MPI_Barrier(MPI_Comm comm);
int MPI_Bcast(void *buf, int count, MPI_Datatype dt, int root,
              MPI_Comm comm);
double MPI_Wtime(void);

#endif /* RLO_MOCK_MPI_H */
