/* rlo_core — native C core of the rlo_tpu_torch framework.
 *
 * The reference ("Rootless Operations for MPI") is a C11
 * library; this is its native-parity counterpart in the rebuild: skip-ring
 * overlay topology (reference rootless_ops.c:1412-1579), variable-size wire
 * frames (pbuf_serialize, rootless_ops.c:1369-1410 — minus the fixed 32 KB
 * frame flaw), intrusive message queues (rootless_ops.c:54-58, 345-404),
 * a cooperatively-polled progress engine (make_progress_gen,
 * rootless_ops.c:551-658), rootless broadcast (RLO_bcast_gen :1581,
 * _bc_forward :1104) and IAR leaderless consensus (:668-932), all over an
 * in-process loopback transport world (net-new: the reference can only run
 * under mpirun).
 *
 * Semantics are kept in lockstep with the Python engine
 * (rlo_tpu_torch/engine.py) so the two implementations cross-check each other in
 * tests. Deliberate departures from the reference mirror the Python side:
 * nonblocking votes, variable-size frames, explicit state enums, and hard
 * errors instead of printf-warnings on protocol violations.
 *
 * Everything is single-threaded and cooperatively polled — there is no
 * background thread, matching the reference's documented model
 * (rootless_ops.h:216).
 */
#ifndef RLO_CORE_H
#define RLO_CORE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- message tags (reference RLO_COMM_TAGS, rootless_ops.h:50-61) ---- */
/* Tags without their own dispatch case go straight to pickup through
 * the progress switch's default label; rlo-lint R4 requires each such
 * tag to carry the `rlo-lint: default-route` annotation below (the
 * Python twin's annotations live on wire.py's Tag members). */
enum rlo_tag {
    RLO_TAG_BCAST = 0,
    RLO_TAG_JOB_DONE = 1,     /* rlo-lint: default-route */
    RLO_TAG_IAR_PROPOSAL = 2,
    RLO_TAG_IAR_VOTE = 3,
    RLO_TAG_IAR_DECISION = 4,
    RLO_TAG_BC_TEARDOWN = 5,  /* rlo-lint: default-route */
    RLO_TAG_IAR_TEARDOWN = 6, /* rlo-lint: default-route */
    RLO_TAG_P2P = 7,          /* rlo-lint: default-route */
    RLO_TAG_SYS = 8,          /* rlo-lint: default-route */
    RLO_TAG_DATA = 9,         /* rlo-lint: default-route */
    RLO_TAG_BARRIER = 10,     /* rlo-lint: default-route */
    RLO_TAG_HEARTBEAT = 11, /* point-to-point ring liveness probe */
    RLO_TAG_FAILURE = 12,   /* rootless failure notification */
    RLO_TAG_ACK = 13,       /* cumulative link ACK (ARQ); vote = seq */
    RLO_TAG_ABORT = 14,     /* rootless op-abort (deadline expiry);
                             * the C engine has no op deadlines, so a
                             * received ABORT delivers via pickup
                             * (documented divergence, rlo_engine.c).
                             * rlo-lint: default-route */
    RLO_TAG_JOIN = 15,      /* membership probe/petition: payload =
                             * (incarnation, epoch, min-alive, petition,
                             * member), 5 x le32 (docs/DESIGN.md S8/S18;
                             * member=1 tells the DESTINATION it is
                             * alive in the sender's view — catch up
                             * via MSYNC, not a full rejoin. Old
                             * 4-field probes parse as member=0) */
    RLO_TAG_JOIN_WELCOME = 16, /* admission notice: payload = (epoch,
                             * incarnation echo, n) + n member ranks;
                             * followed by a point-to-point replay of
                             * the recent-broadcast log */
    RLO_TAG_SERVE = 17,     /* serving-fabric point-to-point frame
                             * (load reports, docs/DESIGN.md S11):
                             * ARQ-stamped, epoch-gated, delivered
                             * straight to pickup.
                             * rlo-lint: default-route */
    RLO_TAG_TELEM = 18,     /* in-band telemetry digest (docs/DESIGN.md
                             * S17): ARQ-stamped, epoch-gated,
                             * delivered straight to pickup; payload =
                             * a delta-encoded digest (rlo_telem_encode
                             * below), consumed by the telemetry plane.
                             * rlo-lint: default-route */
    RLO_TAG_MSYNC = 19,     /* membership view-state sync (docs/
                             * DESIGN.md S18): payload = kind byte
                             * (0 REQ / 1 RSP / 2 AD / 3 WANT) +
                             * kind-specific body. ARQ- and epoch-
                             * exempt like JOIN: the catch-up channel
                             * must cross the quarantine it heals. */
};

/* ---- request/proposal states (reference RLO_Req_stat) ---- */
enum rlo_state {
    RLO_COMPLETED = 0,
    RLO_IN_PROGRESS = 1,
    RLO_FAILED = 2,
    RLO_INVALID = 3,
};

/* ---- error codes (negative returns) ----
 * Numbering starts at -10 so errors never collide with the -1 "nothing
 * yet / still pending" sentinel used by pickup and submit_proposal. */
enum rlo_err {
    RLO_OK = 0,
    RLO_ERR_ARG = -10,      /* bad argument */
    RLO_ERR_TOO_BIG = -11,  /* payload exceeds msg_size_max */
    RLO_ERR_BUSY = -12,     /* own proposal still in progress */
    RLO_ERR_PROTO = -13,    /* protocol violation (dup pid, unknown vote) */
    RLO_ERR_NOMEM = -14,
    RLO_ERR_STALL = -15,    /* drain did not reach quiescence */
};

/* default per-message payload cap (reference RLO_MSG_SIZE_MAX,
 * rootless_ops.h:49); frames themselves are variable-size */
#define RLO_MSG_SIZE_MAX 32768

/* ------------------------------------------------------------------ */
/* Topology: pure skip-ring math (reference rootless_ops.c:1412-1579). */
/* ------------------------------------------------------------------ */
int rlo_is_pow2(int n);
int rlo_level(int world_size, int rank);
int rlo_last_wall(int world_size, int rank);
/* Fills out[] with the raw send list, returns its length; *channel_cnt
 * (optional) receives the forwarding-channel count. cap must be >= 32. */
int rlo_send_list(int world_size, int rank, int *out, int cap,
                  int *channel_cnt);
int rlo_check_passed_origin(int world_size, int my_rank, int origin,
                            int to_rank);
/* Forward targets for a broadcast arriving at `rank` from `from_rank`
 * (furthest-first). Returns count. */
int rlo_fwd_targets(int world_size, int rank, int origin, int from_rank,
                    int *out, int cap);
int rlo_fwd_send_cnt(int world_size, int rank, int origin, int from_rank);
/* Targets the broadcast origin itself sends to (furthest-first). */
int rlo_initiator_targets(int world_size, int rank, int *out, int cap);

/* ------------------------------------------------------------------ */
/* Wire format: little-endian [origin:i32][pid:i32][vote:i32][seq:i32]  */
/* [epoch:i32][len:u64] header + payload (reference pbuf layout,        */
/* rootless_ops.c:64-73, extended with the ARQ link sequence number and */
/* the membership LINK epoch — both stamped by the sending engine per   */
/* (src, dst) edge; seq is -1 outside the reliable path, epoch is the   */
/* admission epoch of the edge's last link reset, 0 on the original     */
/* link. Matches rlo_tpu_torch/wire.py `<iiiiiQ>` byte for byte.)             */
/* ------------------------------------------------------------------ */
#define RLO_HEADER_SIZE 28
/* byte offset of the seq field (the ARQ send path patches encoded
 * frames in place: one encode per broadcast, one stamp per edge) */
#define RLO_SEQ_OFFSET 12
/* byte offset of the link-epoch field (patched by the engine send
 * gate; receivers quarantine frames below their per-sender floor) */
#define RLO_EPOCH_OFFSET 16
/* Encodes into dst (cap >= RLO_HEADER_SIZE + len); returns frame size.
 * The epoch field is written as 0 — the send gate stamps it. */
int64_t rlo_frame_encode(uint8_t *dst, int64_t cap, int32_t origin,
                         int32_t pid, int32_t vote, int32_t seq,
                         const uint8_t *payload, int64_t len);
/* Decodes header; returns payload length or RLO_ERR_ARG on truncation.
 * *payload points into raw. */
int64_t rlo_frame_decode(const uint8_t *raw, int64_t rawlen, int32_t *origin,
                         int32_t *pid, int32_t *vote, int32_t *seq,
                         const uint8_t **payload);
/* Link-epoch accessors (raw must hold >= RLO_HEADER_SIZE bytes). */
int32_t rlo_frame_epoch(const uint8_t *raw);
void rlo_frame_set_epoch(uint8_t *raw, int32_t epoch);

/* ------------------------------------------------------------------ */
/* Loopback transport world: N in-process ranks, per-(src,dst,comm)     */
/* FIFO channels, optional seeded delivery latency in poll ticks.       */
/* ------------------------------------------------------------------ */
typedef struct rlo_world rlo_world;
typedef struct rlo_engine rlo_engine;

rlo_world *rlo_world_new(int world_size, int latency, uint64_t seed);
void rlo_world_free(rlo_world *w);
int rlo_world_size(const rlo_world *w);
/* bound rank for one-process-per-rank transports (shm/mpi); -1 when this
 * process hosts every rank (loopback) */
int rlo_world_my_rank(const rlo_world *w);
/* transport name: "loopback" / "shm" / "mpi" */
const char *rlo_world_transport(const rlo_world *w);
/* 1 when no frames are in flight or waiting in any inbox */
int rlo_world_quiescent(const rlo_world *w);
/* 1 when the world is dead (a peer rank's process failed/aborted);
 * always 0 for in-process transports. Spin loops should poll this. */
int rlo_world_failed(const rlo_world *w);
/* Liveness of one peer: 1 when `rank`'s process showed activity within
 * the last timeout_usec (net-new failure detection — the reference
 * defines RLO_FAILED, rootless_ops.h:66, but never assigns it and has no
 * timeouts or rank-failure handling, SURVEY.md §5). Transports without a
 * liveness signal (loopback: in-process) always return 1. On shm, every
 * rank stamps a shared heartbeat slot whenever it pumps its rings, so a
 * crashed or exited peer goes stale within one timeout. */
int rlo_world_peer_alive(const rlo_world *w, int rank,
                         uint64_t timeout_usec);
/* Fault injection (loopback only): simulate `rank`'s process dying —
 * its inbox is discarded, frames in flight to/from it are dropped
 * (handles complete), future traffic involving it is blackholed, its
 * polls return nothing. RLO_ERR_ARG on transports without injection.
 * Mirror of LoopbackWorld.kill_rank (rlo_tpu_torch/transport/loopback.py). */
int rlo_world_kill_rank(rlo_world *w, int rank);
/* Fault injection (loopback only): silently drop / duplicate the next
 * `count` frames sent src -> dst — the loss/duplication legs of the
 * chaos harness (mirror of LoopbackWorld.drop_next / dup_next).
 * RLO_ERR_ARG on transports without injection. */
int rlo_world_drop_next(rlo_world *w, int src, int dst, int count);
int rlo_world_dup_next(rlo_world *w, int src, int dst, int count);
/* Fault injection (loopback only): network partition — frames whose
 * endpoints fall in different groups of group_of[0..n-1] (n ==
 * world_size; group_of[r] = r's group id) are silently dropped.
 * Passing NULL heals the partition. RLO_ERR_ARG where unsupported. */
int rlo_world_partition(rlo_world *w, const int *group_of, int n);
/* Fault injection (loopback only): revive a killed rank's endpoint
 * with an empty inbox (the harness then builds a fresh engine with a
 * bumped incarnation — the restart leg of the membership tests). */
int rlo_world_revive_rank(rlo_world *w, int rank);
int64_t rlo_world_sent_cnt(const rlo_world *w);
int64_t rlo_world_delivered_cnt(const rlo_world *w);
/* Collective barrier across all ranks (shm: sense-reversing spin;
 * mpi: MPI_Barrier; no-op on single-process transports). */
void rlo_world_barrier(rlo_world *w);
/* Test support (in-process worlds): inject one raw frame as if `src`
 * sent it — for duplicate/stale-frame scenarios. */
int rlo_world_inject(rlo_world *w, int src, int dst, int comm, int tag,
                     const uint8_t *raw, int64_t len);

/* ------------------------------------------------------------------ */
/* SHM transport: N real OS processes as ranks over a shared-memory     */
/* segment of SPSC ring channels — the `mpirun -n N` analogue           */
/* (reference Makefile:5). The launcher forks world_size children; each */
/* child receives a world bound to its rank and runs `fn`.              */
/* ------------------------------------------------------------------ */
typedef int (*rlo_rank_fn)(rlo_world *w, int rank, void *ctx);
/* Returns 0 when every rank returned 0, else the first nonzero child
 * status (or a negative rlo_err for setup failures). ring_bytes <= 0
 * picks a default (256 KB per src->dst channel). */
int rlo_shm_launch(int world_size, int64_t ring_bytes, rlo_rank_fn fn,
                   void *ctx);
/* Collective barrier across all ranks of an shm world (sense-reversing;
 * spins with sched_yield). No-op on other transports. */
void rlo_shm_barrier(rlo_world *w);

/* ------------------------------------------------------------------ */
/* MPI transport: CPU-cluster parity with the reference's backend       */
/* (nonblocking MPI P2P, rootless_ops.c passim). Compile-gated on       */
/* RLO_HAVE_MPI — rlo_mpi_available() reports whether this build has    */
/* it; without it rlo_mpi_world_new returns NULL. Requires a process    */
/* launched under mpirun; initializes MPI if the app hasn't.            */
/* ------------------------------------------------------------------ */
int rlo_mpi_available(void);
rlo_world *rlo_mpi_world_new(void);

/* ------------------------------------------------------------------ */
/* TCP transport: one process per rank over a full mesh of stream      */
/* sockets — the control plane crossing real host boundaries (the      */
/* reference's any-MPI-cluster deployment, rootless_ops.c:1123).       */
/* Endpoints from RLO_TCP_RANK/RLO_TCP_WORLD plus RLO_TCP_HOSTS        */
/* ("host:port,...", one per rank) or RLO_TCP_PORT_BASE on localhost.  */
/* ------------------------------------------------------------------ */
int rlo_tcp_available(void);
rlo_world *rlo_tcp_world_new(void);

/* ------------------------------------------------------------------ */
/* Progress engine (reference struct progress_engine + EngineManager).  */
/* ------------------------------------------------------------------ */
/* judgement callback: 1 approve / 0 decline (reference iar_cb_func_t,
 * rootless_ops.h:77) */
typedef int (*rlo_judge_cb)(const uint8_t *payload, int64_t len, void *ctx);
/* action callback: executed on every rank when a proposal is approved */
typedef void (*rlo_action_cb)(const uint8_t *payload, int64_t len,
                              void *ctx);

/* Engines on the same `comm` id across ranks form one communicator;
 * different comm ids on one world are fully isolated (the analogue of the
 * reference's dup'ed MPI comm per engine, rootless_ops.c:1461). */
rlo_engine *rlo_engine_new(rlo_world *w, int rank, int comm,
                           rlo_judge_cb judge, void *judge_ctx,
                           rlo_action_cb action, void *action_ctx,
                           int64_t msg_size_max);
/* Engine over a RANK SUBSET — the reference's engines-over-sub-
 * communicators capability (RLO_progress_engine_new on any MPI_Comm,
 * rootless_ops.c:467, 1461). bcast/IAR span exactly `members` (overlay
 * topology over virtual ranks 0..n_members-1); non-members never see
 * this engine's traffic. `rank` must be a member; create the engine on
 * member ranks only, with a `comm` distinct from any full-world
 * engine's on the same world. */
rlo_engine *rlo_engine_new_sub(rlo_world *w, int rank, int comm,
                               const int *members, int n_members,
                               rlo_judge_cb judge, void *judge_ctx,
                               rlo_action_cb action, void *action_ctx,
                               int64_t msg_size_max);
void rlo_engine_free(rlo_engine *e);

/* Step every engine in the world once (reference RLO_make_progress_all,
 * rootless_ops.c:538-549); re-entrant calls are no-ops. */
void rlo_progress_all(rlo_world *w);

/* ------------------------------------------------------------------ */
/* Batched progress (docs/DESIGN.md S13): loop progress turns INSIDE C */
/* so a driver (the ctypes bindings release the GIL for the call's     */
/* whole duration) pays one crossing for thousands of frames instead   */
/* of one per turn. Both entry points return the number of frames      */
/* polled off the transport (every frame counts: ACKs, heartbeats,     */
/* quarantined and duplicate frames included), or a negative rlo_err.  */
/*                                                                     */
/* Stop conditions (first one wins):                                   */
/*   - max_frames > 0 and that many frames were processed (the budget  */
/*     binds exactly: a turn stops polling mid-inbox, the remainder    */
/*     waits for the next call);                                       */
/*   - deadline_usec > 0 and that many MICROSECONDS have elapsed since */
/*     call entry: the call becomes a busy poll-wait that keeps        */
/*     progressing through idle periods — the serving-pump shape       */
/*     (GIL released, one wakeup per deadline window);                 */
/*   - with no deadline armed, the natural end of the currently        */
/*     flowing work: rlo_world_progress_all_n returns at the first     */
/*     fruitless sweep with the world quiescent (in-flight latency     */
/*     frames on the loopback keep it sweeping until delivered);       */
/*     rlo_engine_progress_n — the single-engine face for the          */
/*     one-process-per-rank transports (shm/tcp/mpi) — returns at the  */
/*     first fruitless turn (it must not spin a multi-engine world     */
/*     whose pending frames belong to other engines).                  */
/* Re-entrant calls (from a judge/action callback) are no-ops          */
/* returning 0, like rlo_progress_all.                                 */
int64_t rlo_engine_progress_n(rlo_engine *e, int64_t max_frames,
                              uint64_t deadline_usec);
int64_t rlo_world_progress_all_n(rlo_world *w, int64_t max_frames,
                                 uint64_t deadline_usec);
/* lifetime count of frames this engine polled off the transport */
int64_t rlo_engine_frames_dispatched(const rlo_engine *e);

/* Rootless broadcast from this rank (reference RLO_bcast_gen :1581). */
int rlo_bcast(rlo_engine *e, const uint8_t *payload, int64_t len);

/* IAR leaderless consensus (reference RLO_submit_proposal :876).
 * Returns the decision (0/1) if it completed within this call, else -1
 * (poll with rlo_check_proposal_state / rlo_vote_my_proposal), or a
 * negative rlo_err. pids must be unique across concurrent proposers. */
int rlo_submit_proposal(rlo_engine *e, const uint8_t *proposal, int64_t len,
                        int pid);
int rlo_check_proposal_state(rlo_engine *e);     /* enum rlo_state */
int rlo_vote_my_proposal(rlo_engine *e);         /* -1 / 0 / 1 */
void rlo_proposal_reset(rlo_engine *e);

/* Delivery (reference RLO_user_pickup_next/RLO_user_msg_recycle
 * :938-992). Copies the payload into buf (cap bytes) and returns its
 * length, filling tag/origin/pid/vote; returns -1 when nothing is
 * deliverable, RLO_ERR_TOO_BIG if cap is too small (message stays
 * queued). */
int64_t rlo_pickup_next(rlo_engine *e, int *tag, int *origin, int *pid,
                        int *vote, uint8_t *buf, int64_t cap);

/* Zero-copy delivery, the native analogue of the reference's
 * pickup-then-recycle pair (the payload stays in the engine's buffer
 * while the app reads it, like RLO_user_pickup_next handing out the
 * engine's own msg buffer until RLO_user_msg_recycle :981-992):
 * rlo_pickup_peek exposes the head deliverable message — fills the
 * fields, points *payload into engine-owned memory, returns the length —
 * without consuming it; rlo_pickup_consume (the `recycle`) then retires
 * exactly the message last peeked, even if progress turns ran in
 * between and changed the queue heads. The payload pointer is valid
 * only until the next call into the engine. peek returns -1 when
 * nothing is deliverable; consume without a pending peek is
 * RLO_ERR_ARG. */
int64_t rlo_pickup_peek(rlo_engine *e, int *tag, int *origin, int *pid,
                        int *vote, const uint8_t **payload);
int rlo_pickup_consume(rlo_engine *e);

/* ------------------------------------------------------------------ */
/* Failure detection + elastic recovery on the engine (net-new — the    */
/* reference defines RLO_FAILED but never assigns it, SURVEY.md §5;     */
/* mirror of the Python engine's failure_timeout machinery): ranks      */
/* heartbeat their ring successor every interval_usec and declare a     */
/* silent predecessor failed after timeout_usec, announce it with a     */
/* rootless FAILURE broadcast, and every survivor re-forms the overlay  */
/* over the alive set so bcast and consensus keep working (pending      */
/* consensus rounds discount dead voters; proposals orphaned by a dead  */
/* proposer or vote-tree parent are dropped). Disabled by default.      */
/* Unlike the Python engine, a late decision for a dropped orphaned     */
/* proposal delivers but does not re-run the action callback.           */
/* ------------------------------------------------------------------ */
int rlo_engine_enable_failure_detection(rlo_engine *e,
                                        uint64_t timeout_usec,
                                        uint64_t interval_usec);

/* ------------------------------------------------------------------ */
/* Reliable delivery (ARQ; net-new — the reference has no timeouts,    */
/* retries, or loss recovery, SURVEY.md §5; mirror of the Python       */
/* engine's arq_rto machinery): every engine frame except heartbeats   */
/* and ACKs carries a per-(src, dst) link sequence number and sits in  */
/* a retransmit queue until the destination's cumulative ACK covers    */
/* it; overdue frames retransmit with exponential backoff, giving up   */
/* after max_retries (a persistently silent peer is the failure        */
/* detector's job). Receivers dedup on (sender, seq) BEFORE tag        */
/* dispatch, so retransmits are idempotent through the                 */
/* store-and-forward broadcast path, and owe the sender a cumulative   */
/* ACK (flushed once per progress turn). Disabled by default.          */
/* ------------------------------------------------------------------ */
int rlo_engine_enable_arq(rlo_engine *e, uint64_t rto_usec,
                          int max_retries);
int64_t rlo_engine_arq_retransmits(const rlo_engine *e);
int64_t rlo_engine_arq_dup_drops(const rlo_engine *e);
/* outstanding reliable frames not yet covered by an ACK */
int64_t rlo_engine_arq_unacked(const rlo_engine *e);
/* frames the ARQ layer abandoned after max_retries (skip notices) */
int64_t rlo_engine_arq_gave_up(const rlo_engine *e);
/* due-heap introspection (docs/DESIGN.md S13; C analogue of the
 * Python engine's _arq_due lazy heap): live heap population (stale
 * entries for acked/re-timed frames linger until their deadline pops
 * them — lazy by design) and the count of O(1) gated retransmit
 * sweeps (ticks that returned on the heap peek alone) */
int64_t rlo_engine_arq_heap_len(const rlo_engine *e);
int64_t rlo_engine_arq_scan_gated(const rlo_engine *e);
/* 1 when this engine has marked `rank` failed */
int rlo_engine_rank_failed(const rlo_engine *e, int rank);
int rlo_engine_failed_count(const rlo_engine *e);
/* 1 when a FAILURE notice about THIS rank arrived (false positive) */
int rlo_engine_suspected_self(const rlo_engine *e);

/* ------------------------------------------------------------------ */
/* Membership epochs + elastic rejoin (net-new, docs/DESIGN.md S8;     */
/* mirror of the Python engine's incarnation/epoch/JOIN machinery).    */
/* Every rank carries a monotone membership epoch (bumped on every     */
/* failure adoption and admission); the send gate stamps the LINK      */
/* epoch of each edge into outgoing frames and receivers quarantine    */
/* (a) traffic from senders they consider failed, (b) frames below    */
/* the per-sender floor set at that sender's admission, (c)           */
/* everything while mid-rejoin. A failed-but-alive rank converges     */
/* back in via Tag.JOIN probes + an IAR admission round over the      */
/* member set, finished by a JOIN_WELCOME + recent-broadcast replay.  */
/* ------------------------------------------------------------------ */
/* Partition the engine's life at this rank: a RESTARTED process       */
/* passes a fresh incarnation BEFORE any traffic; broadcast seqs and   */
/* round generations start at incarnation << 20 so peers' dedup        */
/* windows never swallow the new life's frames. incarnation > 0 also   */
/* starts the engine in JOINER mode (petitioning until welcomed).      */
int rlo_engine_set_incarnation(rlo_engine *e, int incarnation);
/* Explicit rejoin: bump the incarnation, enter joiner mode, petition. */
int rlo_engine_rejoin(rlo_engine *e);
int64_t rlo_engine_epoch(const rlo_engine *e);
int64_t rlo_engine_epoch_quarantined(const rlo_engine *e);
int64_t rlo_engine_rejoins(const rlo_engine *e);
/* 1 while the engine is mid-rejoin (quarantining everything) */
int rlo_engine_awaiting_welcome(const rlo_engine *e);

/* ------------------------------------------------------------------ */
/* Metrics registry (rlo_stats) — native twin of ProgressEngine        */
/* metrics() (rlo_tpu_torch/utils/metrics.py; docs/DESIGN.md §7). Counter    */
/* keys, nesting, and histogram layout are kept IDENTICAL across the   */
/* two engines (bindings.py assembles the same nested dict), asserted  */
/* by the metrics-parity test. Collection of per-link accounting and   */
/* latency histograms is opt-in (rlo_engine_enable_metrics); when off, */
/* the residual hot-path cost is one branch per send/receive — plain   */
/* counters (ARQ totals, bcast/pickup counts) are always live.         */
/* ------------------------------------------------------------------ */

/* log2 latency histogram: bucket i counts samples whose integer part
 * has bit_length i (i.e. [2^(i-1), 2^i) usec); bucket 0 is <= 0, the
 * last bucket absorbs overflow. Mirror of metrics.Histogram. */
#define RLO_HIST_BUCKETS 28
typedef struct rlo_hist {
    int64_t count;
    double sum, min, max;
    int64_t buckets[RLO_HIST_BUCKETS];
} rlo_hist;

/* per-peer link accounting: frames/bytes both ways, retransmits,
 * duplicate drops, and an RTT EWMA measured from ARQ ack timing
 * (first-transmission frames only — Karn's rule — smoothed 1/8).
 * Mirror of metrics.LinkStats. */
typedef struct rlo_link_stats {
    int64_t tx_frames, tx_bytes, rx_frames, rx_bytes;
    int64_t retransmits, dup_drops;
    double rtt_ewma_usec; /* 0 = unmeasured */
} rlo_link_stats;

/* engine-level snapshot: counters + live queue depths (q_pickup +
 * q_wait_and_pickup = the pickup backlog) + op-latency histograms
 * (bcast init -> fan-out complete, proposal submit -> decision,
 * frame receipt -> pickup). ops_failed is always 0 in the C engine
 * (op deadlines are Python-side); the key exists for schema parity. */
typedef struct rlo_stats {
    int64_t sent_bcast, recved_bcast, total_pickup, ops_failed;
    int64_t arq_retransmits, arq_dup_drops, arq_gave_up, arq_unacked;
    /* membership (docs/DESIGN.md S8): current view epoch, frames
     * dropped by the stale-epoch / failed-sender quarantine, and
     * admissions executed (or adopted, joiner side) */
    int64_t epoch, epoch_quarantined, rejoins;
    /* heal-cost block (docs/DESIGN.md S17): membership-view rebinds,
     * frames re-sent by the view-change re-flood, the high-water mark
     * of (my epoch - accepted frame's link epoch), the per-reason
     * breakdown of epoch_quarantined (the three sum to it), and IAR
     * admission rounds LAUNCHED here (designated-admitter side) */
    int64_t view_changes, reflood_frames, epoch_lag_max;
    int64_t quar_mid_rejoin, quar_failed_sender, quar_below_floor;
    int64_t admission_rounds;
    /* churn-proof healing (docs/DESIGN.md S18): epoch catch-ups
     * adopted via Tag.MSYNC (instead of full rejoins), advert entries
     * a re-flood receiver already held (frames the pre-S18 blast
     * would have wasted), and joiners admitted through multi-joiner
     * batched admission records */
    int64_t epoch_syncs, reflood_skipped, batched_admits;
    int64_t q_wait, q_pickup, q_wait_and_pickup, q_iar_pending;
    rlo_hist bcast_complete, proposal_resolve, pickup_wait;
} rlo_stats;

int rlo_engine_enable_metrics(rlo_engine *e, int on);
int rlo_engine_stats(const rlo_engine *e, rlo_stats *out);
/* Fills out[0..min(cap, world_size)-1] (out[rank] for this engine's
 * own rank stays zeroed); returns world_size or RLO_ERR_ARG. */
int rlo_engine_link_stats(const rlo_engine *e, rlo_link_stats *out,
                          int cap);

/* ------------------------------------------------------------------ */
/* In-engine phase profiler (docs/DESIGN.md S10) — native twin of the  */
/* Python engine's ENGINE_PHASE_KEYS schema (rlo_tpu_torch/utils/metrics.py):*/
/* one log2 duration histogram (usec) per stage, FIELD ORDER IDENTICAL */
/* to the Python tuple (rlo-lint R2 pins the pair; the profiler parity */
/* test asserts snapshot equality). Hot-path stages: wire encode /     */
/* decode, one transport isend, one ARQ retransmit-window sweep, tag   */
/* dispatch + handler, one pickup delivery. Per-op protocol phases     */
/* (local observation points): bcast init -> first fan-out send done   */
/* -> all fan-out sends done; proposal submit -> all votes merged ->   */
/* decision fan-out done. Off by default; the disabled path costs one  */
/* predictable branch per instrumented site (no clock read) — the same */
/* overhead contract as the metrics registry. With tracing enabled,    */
/* every sample also emits RLO_EV_PHASE (a = field index, b = usec)    */
/* for the Chrome-timeline duration slices.                            */
/* ------------------------------------------------------------------ */
typedef struct rlo_phase_stats {
    rlo_hist frame_encode, frame_decode, send, arq_scan, tag_dispatch,
             pickup_drain, bcast_first_fwd, bcast_all_delivered,
             prop_votes_aggregated, prop_decision;
} rlo_phase_stats;

int rlo_engine_enable_profiler(rlo_engine *e, int on);
int rlo_engine_phase_stats(const rlo_engine *e, rlo_phase_stats *out);

/* ------------------------------------------------------------------ */
/* Telemetry digest codec (docs/DESIGN.md S17) — the C half of the    */
/* byte-pinned layout in rlo_tpu_torch/wire.py (encode_telem/decode_telem): */
/*   [magic "RLOT\x01":5][flags:u8 bit0=FULL][rank:i32][epoch:i32]    */
/*   [seq:u32][mask:u64][zigzag-LEB128 delta per set mask bit]        */
/* Key order = wire.py TELEM_KEYS: the rlo_stats counter fields       */
/* (ENGINE_COUNTER_KEYS) followed by the extras in k_telem_keys       */
/* (rlo_wire.c) — rlo-lint R2 pins the three against each other.      */
/* ------------------------------------------------------------------ */
#define RLO_TELEM_MAGIC "RLOT\x01"
#define RLO_TELEM_HEADER_SIZE 26
#define RLO_TELEM_NKEYS 39
/* Pure codec (no engine): encode vals[RLO_TELEM_NKEYS] as a digest,
 * delta vs prev (NULL or full != 0 => full snapshot, deltas vs zero).
 * Returns bytes written or RLO_ERR_TOO_BIG/RLO_ERR_ARG. */
int64_t rlo_telem_encode(uint8_t *dst, int64_t cap, int32_t rank,
                         int32_t epoch, uint32_t seq, int full,
                         const int64_t *vals, const int64_t *prev);
/* Decode: fills deltas[RLO_TELEM_NKEYS] (unset keys stay untouched),
 * *mask says which. Returns bytes consumed or RLO_ERR_ARG. */
int64_t rlo_telem_decode(const uint8_t *raw, int64_t rawlen,
                         int32_t *rank, int32_t *epoch, uint32_t *seq,
                         int *full, int64_t *deltas, uint64_t *mask);
/* schema key name for mask bit i (NULL out of range) — the parity
 * surface rlo-lint R2 checks against wire.py's TELEM_KEYS */
const char *rlo_telem_key_name(int i);

/* ------------------------------------------------------------------ */
/* Span context codec (docs/DESIGN.md S19) — the C half of the        */
/* byte-pinned trailer in rlo_tpu_torch/wire.py (encode_span_ctx):          */
/*   [magic "RLOS\x01":5][flags:u8 bit0=sampled][stage:u8]            */
/*   [gateway:i32][seq:i32][t_usec:u64 stage start, origin clock]     */
/* Appended as a TRAILER to fabric record payloads; SIZE % 4 == 3     */
/* makes it structurally unambiguous against i32-word record bodies.  */
/* The engine's pickup path decodes it to emit RLO_EV_SPAN wire-hop   */
/* events — zero cost when tracing is off.                            */
/* ------------------------------------------------------------------ */
#define RLO_SPAN_MAGIC "RLOS\x01"
#define RLO_SPAN_CTX_SIZE 23
/* Pure codec: write one span context into dst. Returns bytes written
 * (RLO_SPAN_CTX_SIZE) or RLO_ERR_ARG on a short buffer. */
int64_t rlo_span_encode(uint8_t *dst, int64_t cap, int32_t gateway,
                        int32_t seq, int stage, int flags,
                        uint64_t t_usec);
/* Decode a span context at raw[0..RLO_SPAN_CTX_SIZE): returns bytes
 * consumed or RLO_ERR_ARG when the bytes are not a span context
 * (absence is the common case, not corruption). */
int64_t rlo_span_decode(const uint8_t *raw, int64_t rawlen,
                        int32_t *gateway, int32_t *seq, int *stage,
                        int *flags, uint64_t *t_usec);
/* Engine-originated digest: samples the engine's own telemetry
 * (counters + link rollups + queue depths; the serving page keys are
 * always 0 in C), delta-encodes vs the last digest THIS call emitted,
 * bumps the per-engine digest seq, and writes the frame payload into
 * buf. full != 0 forces a full snapshot (the first call always is).
 * Returns bytes written or a negative rlo_err. */
int64_t rlo_engine_telem_digest(rlo_engine *e, int full, uint8_t *buf,
                                int64_t cap);

/* ------------------------------------------------------------------ */
/* Engine snapshot/restore (mirror of the checkpoint subsystem's        */
/* engine_state_dict, rlo_tpu_torch/utils/checkpoint.py): a quiesced engine's */
/* durable identity — bcast/pickup counters and own-proposal            */
/* bookkeeping — captured into a flat struct and re-applied onto a      */
/* fresh engine after a process restart. state_get returns RLO_ERR_BUSY */
/* unless the engine is idle, not mid-consensus (own proposal awaiting  */
/* votes or relayed proposals pending), and fully picked up (unlike the */
/* Python snapshot, undelivered pickup messages are NOT captured —      */
/* drain them first). state_set rejects a rank/world mismatch.          */
/* ------------------------------------------------------------------ */
typedef struct rlo_engine_state {
    int32_t rank, world_size;
    int64_t sent_bcast, recved_bcast, total_pickup;
    int32_t prop_pid, prop_state, prop_vote;
    int32_t prop_votes_needed, prop_votes_recved;
    /* round-generation counter: a restored engine must never reissue a
     * pre-snapshot generation (stale in-flight votes could otherwise
     * match a post-restore round) */
    int32_t gen_counter;
    /* exactly-once broadcast sequence counter: a restored engine must
     * never reissue a pre-snapshot seq (peers remembering it as seen
     * would drop the fresh broadcast). The per-origin dedup window and
     * recent-frame log are NOT captured (this struct is a flat POD):
     * the C snapshot assumes whole-world restart, where peers restart
     * with fresh logs and nothing pre-snapshot is ever re-flooded.
     * The Python engine snapshot captures both (checkpoint.py). */
    int32_t bcast_seq;
} rlo_engine_state;
int rlo_engine_state_get(const rlo_engine *e, rlo_engine_state *out);
int rlo_engine_state_set(rlo_engine *e, const rlo_engine_state *in);

/* Spanning-tree shape for bcast/IAR (runtime-selectable; the skip-ring
 * is the reference's overlay, rootless_ops.c:1489; FLAT is depth-1 —
 * origin sends to every live member directly, receivers are leaves.
 * Env default RLO_FANOUT=flat; per-engine override below, only while
 * the engine is idle between rounds). Rootlessness, dedup, and vote
 * accounting are schedule-independent. */
#define RLO_FANOUT_SKIP_RING 0
#define RLO_FANOUT_FLAT 1
int rlo_engine_set_fanout(rlo_engine *e, int mode);

/* 1 when this engine has no outstanding forwards or pending decision */
int rlo_engine_idle(const rlo_engine *e);
int rlo_engine_err(const rlo_engine *e);         /* sticky first error */
int64_t rlo_engine_total_pickup(const rlo_engine *e);
int64_t rlo_engine_sent_bcast(const rlo_engine *e);
int64_t rlo_engine_recved_bcast(const rlo_engine *e);

/* Termination-detection drain (reference cleanup drain,
 * rootless_ops.c:1613-1625): progress until the world is quiescent and
 * every engine idle. Returns spins used, or RLO_ERR_STALL. Collective on
 * multi-process transports (every rank must call it, like the
 * reference's MPI_Iallreduce-based drain). */
int rlo_drain(rlo_world *w, int max_spins);

/* ------------------------------------------------------------------ */
/* Engine-substrate ring data collectives (rlo_coll.c) — the C mirror  */
/* of rlo_tpu_torch/ops/collectives.py: ring reduce-scatter/all-gather       */
/* allreduce, rotation all-to-all, dissemination barrier, over the     */
/* same transport vtable. Explicit state machines: `*_start` arms an   */
/* op, rlo_coll_poll advances one slice (1 = done, 0 = in progress,    */
/* <0 = error). One op may be armed per coll at a time; every rank     */
/* must issue collectives in the same order. The coll's `comm` id      */
/* must differ from every engine comm on the same world.               */
/* Collectives are NOT failure-elastic (MPI-collective semantics): a   */
/* rank dying mid-op stalls the survivors' polls until their spin      */
/* budget (rlo_coll_wait returns RLO_ERR_STALL; on transports with a   */
/* failed() signal the wait aborts as soon as the world is dead). The  */
/* elastic path is the engine substrate: bcast/IAR survive failures    */
/* via the detector + re-formed overlay (rlo_engine.c).                */
/* ------------------------------------------------------------------ */
typedef struct rlo_coll rlo_coll;

enum rlo_coll_op { RLO_COLL_SUM = 0, RLO_COLL_MIN = 1, RLO_COLL_MAX = 2 };

rlo_coll *rlo_coll_new(rlo_world *w, int rank, int comm);
/* Data collectives over a RANK SUBSET (the collective face of
 * rlo_engine_new_sub): ring/rotation schedules run over virtual ranks
 * 0..n_members-1; slot layouts (all_gather / reduce_scatter /
 * all_to_all) are indexed by subset position. `rank` must be a member;
 * use a comm distinct from any full-world context on the same world. */
rlo_coll *rlo_coll_new_sub(rlo_world *w, int rank, int comm,
                           const int *members, int n_members);
void rlo_coll_free(rlo_coll *c);
/* in-place ring allreduce of count floats */
int rlo_coll_allreduce_f32_start(rlo_coll *c, float *data, int64_t count,
                                 int op);
/* rank r receives the r-th of ws equal chunks (identity-padded);
 * out must hold ceil(count/ws) floats */
int rlo_coll_reduce_scatter_f32_start(rlo_coll *c, const float *data,
                                      int64_t count, float *out, int op);
/* out must hold ws*len bytes; slot r = rank r's data */
int rlo_coll_all_gather_start(rlo_coll *c, const uint8_t *data,
                              int64_t len, uint8_t *out);
/* data/out are ws slots of len_per_rank bytes; out slot s = the chunk
 * rank s addressed to this rank */
int rlo_coll_all_to_all_start(rlo_coll *c, const uint8_t *data,
                              int64_t len_per_rank, uint8_t *out);
int rlo_coll_barrier_start(rlo_coll *c);
int rlo_coll_poll(rlo_coll *c);
/* spin poll to completion — one-process-per-rank transports only */
int rlo_coll_wait(rlo_coll *c, long max_spins);

/* ------------------------------------------------------------------ */
/* Wholly-native micro-benchmarks (rlo_bench.c / rlo_coll.c): median   */
/* usec per op on an in-process loopback world, no Python in the       */
/* measured loop. ctypes entry points for benchmarks/suite.py; also    */
/* linked by rlo_demo's nbcast floor analysis. Negative = rlo_err.     */
/* ------------------------------------------------------------------ */
/* bcast-gather fp32 allreduce over the engine substrate */
double rlo_bench_allreduce(int world_size, int64_t count, int reps);
/* ring fp32 allreduce (rlo_coll.c state machines round-robined in C) —
 * the bandwidth-optimal comparison line against bcast-gather */
double rlo_bench_allreduce_ring(int world_size, int64_t count, int reps);
/* one rootless broadcast of nbytes, initiation to full delivery */
double rlo_bench_bcast_usec(int world_size, int64_t nbytes, int reps);

/* ------------------------------------------------------------------ */
/* Timing utils (reference RLO_get_time_usec, rootless_ops.c:128-132).  */
/* ------------------------------------------------------------------ */
uint64_t rlo_now_usec(void);

/* ------------------------------------------------------------------ */
/* Structured event tracing. The reference has none beyond printf       */
/* tracepoints and an unused Log global (SURVEY.md §5). Event kinds and */
/* semantics are shared with the Python tracer                          */
/* (rlo_tpu_torch/utils/tracing.py); disabled by default — one branch per     */
/* emit when off. Process-local ring; oldest events drop when full.     */
/* ------------------------------------------------------------------ */
/* Field semantics are shared with the Python tracer (tracing.Ev); the
 * c/d fields carry the correlation identity the cross-rank timeline
 * merger (rlo_tpu_torch/utils/timeline.py) keys on: identity = the
 * per-origin exactly-once seq for BCAST frames, the pid for IAR /
 * FAILURE / ABORT traffic; d = the immediate sender (what turns
 * per-rank logs into send->recv flow edges). */
enum rlo_ev {
    RLO_EV_BCAST_INIT = 1, /* a = tag, b = payload len, c = seq/pid */
    RLO_EV_BCAST_FWD = 2,  /* receipt+forward step (emitted even for
                            * zero-target leaf receipts): a = tag,
                            * b = origin, c = seq/pid, d = sender */
    RLO_EV_DELIVER = 3,    /* a = tag, b = origin, c = seq/pid,
                            * d = sender */
    RLO_EV_PROPOSAL_SUBMIT = 4, /* a = pid, c = round generation */
    RLO_EV_JUDGE = 5,      /* a = pid of the judged proposal, b = verdict */
    RLO_EV_VOTE = 6,       /* a = pid, b = merged vote, c = generation */
    RLO_EV_DECISION = 7,   /* a = pid, b = decision, c = generation */
    RLO_EV_DRAIN = 8,      /* a = spins */
    RLO_EV_HEARTBEAT = 9,  /* a = destination rank */
    RLO_EV_FAILURE = 10,   /* a = failed rank, b = 1 local / 0 learned;
                            * c = last-seen heartbeat age (usec, clamped
                            * to int32) on local detections */
    RLO_EV_ARQ_GIVEUP = 11, /* ARQ exhausted its retries at a live peer
                             * (now declared failed): a = peer,
                             * b = retransmit count */
    RLO_EV_JOIN = 12,      /* membership probe: a = peer, b = 1 sent /
                            * 0 received, c = incarnation, d = epoch */
    RLO_EV_ADMIT = 13,     /* admission executed/adopted: a = joiner,
                            * b = new epoch, c = joiner incarnation */
    RLO_EV_PHASE = 14,     /* phase-profiler stage sample (docs/DESIGN.md
                            * S10): a = field index in rlo_phase_stats /
                            * ENGINE_PHASE_KEYS order, b = duration
                            * (usec, clamped to int32); the timeline
                            * merger renders a duration slice ENDING at
                            * ts_usec */
    RLO_EV_SPAN = 15,      /* request-scoped causal span (docs/DESIGN.md
                            * S19): a = stage id, b = duration (usec;
                            * -1 = wire-hop receipt of a span-stamped
                            * record), c = rid seq, d = rid gateway */
    RLO_EV_STEP = 16,      /* collective data-plane step (docs/DESIGN.md
                            * S21): a = schedule id (observe.ledger
                            * ALGORITHMS index), b = step duration
                            * (usec, clamped to int32), c = op id * 1024
                            * + step index, d = rank received from (-1
                            * for send-only steps). The C engine hosts
                            * no tensor collectives yet and never emits
                            * it; the id is reserved here so the merged
                            * timeline's numbering can't be reused. */
};

typedef struct rlo_trace_event {
    uint64_t ts_usec;
    int32_t rank;
    int32_t kind; /* enum rlo_ev */
    int32_t a, b, c, d;
} rlo_trace_event;

void rlo_trace_set(int enabled);
int rlo_trace_enabled(void);
void rlo_trace_emit(int rank, int kind, int a, int b, int c, int d);
/* Copies up to max oldest-first events into out and removes them;
 * returns the count. */
int rlo_trace_drain(rlo_trace_event *out, int max);
int64_t rlo_trace_dropped(void);
int rlo_trace_capacity(void);
void rlo_trace_clear(void);

#ifdef __cplusplus
}
#endif
#endif /* RLO_CORE_H */
