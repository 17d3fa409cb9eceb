/* `demo` — multi-process scenario runner over the SHM transport.
 *
 * The analogue of the reference's one test binary driven by
 * `mpirun -n N ./demo` (reference Makefile:5, testcases.c:742-780): each
 * rank is a real OS process; scenarios replicate the reference suite
 * (SURVEY.md §4) with its behavior-level oracles:
 *
 *   bcast    ~ test_gen_bcast (testcases.c:59-108): one root broadcasts
 *              `cnt` messages, every other rank spin-picks-up exactly cnt
 *   wrapper  ~ test_wrapper_bcast (:699-724): every rank roots in turn
 *   hacky    ~ hacky_sack_progress_engine (:638-697): random ball
 *              passing; every catch triggers a new broadcast; per-rank
 *              pickup-count oracle
 *   iar      ~ test_IAllReduce_single_proposal (:243-332): one proposer,
 *              optional dissenting rank; decision verified on every rank
 *   iar2     ~ test_concurrent_iar_single_proposal (:110-241): two
 *              engines on one world, concurrent proposals, both verified
 *   multi    ~ test_iar_multi_proposal (:401-486): several simultaneous
 *              proposers; every rank counts the expected decisions
 *   multi2   ~ test_concurrent_iar_multi_proposal (:488-594): engine
 *              multiplexing x several simultaneous proposers per
 *              engine, with pid reuse across two sequential rounds
 *   fail     net-new (no reference analogue): one rank crashes; the
 *              others detect it through shm heartbeat staleness
 *              (rlo_world_peer_alive) instead of hanging in a drain
 *   efail    net-new: full engine-level elastic recovery across real
 *              processes — heartbeat detection, FAILURE broadcast,
 *              survivor overlay re-forming, and a working bcast after
 *
 * Usage: ./rlo_demo [-n ranks] [-c case|all] [-m msgs] [-v]
 * Exit status 0 iff every rank's oracle held.
 */
#include "rlo_core.h"

#include <sched.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct demo_cfg {
    int msgs;       /* bcast count / hacky rounds / bench reps */
    int veto;       /* iar: rank that votes NO (-1 = none) */
    int verbose;
    int64_t bytes;  /* bench payload bytes per rank */
} demo_cfg;

#define RCHECK(cond)                                                       \
    do {                                                                   \
        if (!(cond)) {                                                     \
            fprintf(stderr, "rank %d FAIL %s:%d: %s\n", rank, __FILE__,    \
                    __LINE__, #cond);                                      \
            return 1;                                                      \
        }                                                                  \
    } while (0)

#define DRAIN_SPINS 50000000

/* spin progress until pickup returns something, a peer rank dies, or the
 * budget runs out. Progress is BATCHED (docs/DESIGN.md S13): each
 * iteration lets the C loop run sweeps until the currently flowing
 * work is done, so the demo exercises rlo_world_progress_all_n on
 * every transport (shm rings, the tcp sendmsg coalescing, femtompi). */
static int64_t pickup_spin(rlo_world *w, rlo_engine *e, int *tag,
                           int *origin, int *pid, int *vote, uint8_t *buf,
                           int64_t cap)
{
    for (long i = 0; i < 200000000L; i++) {
        int64_t n = rlo_pickup_next(e, tag, origin, pid, vote, buf, cap);
        if (n >= 0)
            return n;
        if (rlo_world_failed(w))
            return -1;
        /* bounded deadline: on shm the no-deadline world call would
         * spin its fruitless fuse whenever the GLOBAL in-flight count
         * is nonzero because of OTHER ranks' traffic; 200 usec per
         * crossing keeps every local engine co-progressing (a rank
         * may host several) without hogging an oversubscribed core */
        if (rlo_world_progress_all_n(w, 0, 200) == 0)
            sched_yield(); /* nothing for us: let the sender run */
    }
    return -1;
}

/* spin until my own proposal leaves IN_PROGRESS; 0 on success */
static int proposal_spin(rlo_world *w, rlo_engine *e)
{
    for (long i = 0; i < 200000000L; i++) {
        if (rlo_check_proposal_state(e) != RLO_IN_PROGRESS)
            return 0;
        if (rlo_world_failed(w))
            return -1;
        if ((i & 63) == 63)
            sched_yield();
    }
    return -1;
}

/* ---- bcast: root broadcasts cnt msgs; others expect exactly cnt ---- */
static int case_bcast(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    int ws = rlo_world_size(w);
    int cnt = cfg->msgs;
    rlo_engine *e = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    RCHECK(e);
    uint64_t t0 = rlo_now_usec();
    if (rank == 0) {
        for (int i = 0; i < cnt; i++) {
            char buf[64];
            int n = snprintf(buf, sizeof buf, "bcast-%d", i);
            RCHECK(rlo_bcast(e, (const uint8_t *)buf, n) == RLO_OK);
        }
    } else {
        for (int i = 0; i < cnt; i++) {
            uint8_t buf[64];
            int tag, origin, pid, vote;
            int64_t n = pickup_spin(w, e, &tag, &origin, &pid, &vote, buf,
                                    sizeof buf);
            RCHECK(n >= 0);
            RCHECK(origin == 0 && tag == RLO_TAG_BCAST);
        }
    }
    RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
    RCHECK(rlo_engine_total_pickup(e) == (rank == 0 ? 0 : cnt));
    RCHECK(rlo_engine_err(e) == RLO_OK);
    if (cfg->verbose && rank == 0)
        fprintf(stderr, "bcast: %d msgs x %d ranks in %llu usec\n", cnt,
                ws, (unsigned long long)(rlo_now_usec() - t0));
    rlo_engine_free(e);
    return 0;
}

/* ---- wrapper: every rank roots one round in turn ---- */
static int case_wrapper(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    (void)cfg;
    int ws = rlo_world_size(w);
    rlo_engine *e = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    RCHECK(e);
    for (int root = 0; root < ws; root++) {
        if (rank == root) {
            char buf[64];
            int n = snprintf(buf, sizeof buf, "round-%d", root);
            RCHECK(rlo_bcast(e, (const uint8_t *)buf, n) == RLO_OK);
        } else {
            uint8_t buf[64];
            int tag, origin, pid, vote;
            int64_t n = pickup_spin(w, e, &tag, &origin, &pid, &vote, buf,
                                    sizeof buf);
            RCHECK(n >= 0);
            RCHECK(origin == root);
        }
        RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
        rlo_shm_barrier(w); /* keep rounds from bleeding into oracles */
    }
    RCHECK(rlo_engine_total_pickup(e) == ws - 1);
    RCHECK(rlo_engine_err(e) == RLO_OK);
    rlo_engine_free(e);
    return 0;
}

/* ---- hacky sack: every catch triggers a new broadcast ----
 * Ball payload = {round, holder}. Rank 0 throws round 0; whoever the
 * ball names as holder throws the next round until `msgs` rounds are
 * out. Oracle (reference :691-692 adapted): pickups == rounds_total -
 * my_throws, since a rank sees every ball but its own. */
static int case_hacky(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    int ws = rlo_world_size(w);
    int rounds = cfg->msgs;
    rlo_engine *e = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    RCHECK(e);
    uint64_t t0 = rlo_now_usec();
    int my_throws = 0;
    int32_t ball[2];
    if (rank == 0) { /* round 0 */
        ball[0] = 0;
        ball[1] = (int32_t)(1 % ws);
        RCHECK(rlo_bcast(e, (const uint8_t *)ball, sizeof ball) == RLO_OK);
        my_throws++;
    }
    int seen = 0;
    /* every rank sees rounds 0..rounds-1 except the ones it threw */
    while (seen + my_throws < rounds) {
        uint8_t buf[64];
        int tag, origin, pid, vote;
        int64_t n = pickup_spin(w, e, &tag, &origin, &pid, &vote, buf,
                                sizeof buf);
        RCHECK(n == sizeof ball);
        memcpy(ball, buf, sizeof ball);
        seen++;
        int rnd = ball[0], holder = ball[1];
        if (holder == rank && rnd + 1 < rounds) {
            /* deterministic "random" next holder, never myself */
            int32_t nxt = (int32_t)((rank + rnd * 2654435761u) % ws);
            if (nxt == rank)
                nxt = (int32_t)((nxt + 1) % ws);
            int32_t nb[2] = {(int32_t)(rnd + 1), nxt};
            RCHECK(rlo_bcast(e, (const uint8_t *)nb, sizeof nb) == RLO_OK);
            my_throws++;
        }
    }
    RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
    /* a final sweep: nothing further may arrive */
    RCHECK(rlo_engine_total_pickup(e) + my_throws == rounds);
    RCHECK(rlo_engine_err(e) == RLO_OK);
    if (cfg->verbose && rank == 0)
        fprintf(stderr, "hacky: %d rounds x %d ranks in %llu usec\n",
                rounds, ws, (unsigned long long)(rlo_now_usec() - t0));
    rlo_engine_free(e);
    return 0;
}

/* ---- IAR single proposal (veto rank optional) ---- */
typedef struct iar_ctx {
    int veto;
    int actions;
} iar_ctx;

static int judge_cb(const uint8_t *p, int64_t n, void *vc)
{
    (void)p;
    (void)n;
    return ((iar_ctx *)vc)->veto ? 0 : 1;
}

static void action_cb(const uint8_t *p, int64_t n, void *vc)
{
    (void)p;
    (void)n;
    ((iar_ctx *)vc)->actions++;
}

static int case_iar(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    int ws = rlo_world_size(w);
    int expect = cfg->veto >= 0 && cfg->veto < ws ? 0 : 1;
    iar_ctx ctx = {.veto = rank == cfg->veto, .actions = 0};
    rlo_engine *e =
        rlo_engine_new(w, rank, 0, judge_cb, &ctx, action_cb, &ctx, 0);
    RCHECK(e);
    if (rank == 0) {
        int rc = rlo_submit_proposal(e, (const uint8_t *)"move-x", 6, 0);
        RCHECK(rc == -1 || rc == expect);
        /* poll to completion (reference spin on check_proposal_state,
         * testcases.c:262-266) */
        RCHECK(proposal_spin(w, e) == 0);
        RCHECK(rlo_vote_my_proposal(e) == expect);
    } else {
        /* every non-proposer must see the decision in its pickup */
        uint8_t buf[64];
        int tag, origin, pid, vote;
        int64_t n = pickup_spin(w, e, &tag, &origin, &pid, &vote, buf,
                                sizeof buf);
        RCHECK(n >= 0);
        RCHECK(tag == RLO_TAG_IAR_DECISION);
        RCHECK(pid == 0 && vote == expect);
        /* approved proposals ran the action exactly once — except on a
         * vetoing rank, which never forwards and never acts */
        RCHECK(ctx.actions == (expect && !ctx.veto ? 1 : 0));
    }
    RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
    RCHECK(rlo_engine_err(e) == RLO_OK);
    rlo_engine_free(e);
    return 0;
}

/* ---- two engines on one world, concurrent proposals ---- */
static int case_iar2(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    (void)cfg;
    int ws = rlo_world_size(w);
    rlo_engine *a = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    rlo_engine *b = rlo_engine_new(w, rank, 1, 0, 0, 0, 0, 0);
    RCHECK(a && b);
    int pa = 0, pb = 1 % ws; /* proposer ranks per engine */
    if (rank == pa)
        RCHECK(rlo_submit_proposal(a, (const uint8_t *)"on-A", 4, pa) >=
               -1);
    if (rank == pb)
        RCHECK(rlo_submit_proposal(b, (const uint8_t *)"on-B", 4, pb) >=
               -1);
    /* both engines progress each other through the shared world */
    if (rank == pa) {
        RCHECK(proposal_spin(w, a) == 0);
        RCHECK(rlo_vote_my_proposal(a) == 1);
    } else {
        uint8_t buf[64];
        int tag, origin, pid, vote;
        RCHECK(pickup_spin(w, a, &tag, &origin, &pid, &vote, buf,
                           sizeof buf) >= 0);
        RCHECK(tag == RLO_TAG_IAR_DECISION && pid == pa && vote == 1);
    }
    if (rank == pb) {
        RCHECK(proposal_spin(w, b) == 0);
        RCHECK(rlo_vote_my_proposal(b) == 1);
    } else {
        uint8_t buf[64];
        int tag, origin, pid, vote;
        RCHECK(pickup_spin(w, b, &tag, &origin, &pid, &vote, buf,
                           sizeof buf) >= 0);
        RCHECK(tag == RLO_TAG_IAR_DECISION && pid == pb && vote == 1);
    }
    RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
    RCHECK(rlo_engine_err(a) == RLO_OK && rlo_engine_err(b) == RLO_OK);
    rlo_engine_free(a);
    rlo_engine_free(b);
    return 0;
}

/* ---- several simultaneous proposers on one engine ---- */
static int case_multi(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    (void)cfg;
    int ws = rlo_world_size(w);
    rlo_engine *e = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    RCHECK(e);
    /* proposers: rank 1 plus every rank = 0 mod 4 (reference active_1 +
     * active_2_mod pattern, testcases.c:401-486); pid = rank */
    int am_proposer = rank == 1 % ws || rank % 4 == 0;
    int n_prop = 0;
    for (int r = 0; r < ws; r++)
        if (r == 1 % ws || r % 4 == 0)
            n_prop++;
    if (am_proposer)
        RCHECK(rlo_submit_proposal(e, (const uint8_t *)"multi", 5, rank) >=
               -1);
    /* expect decisions for every proposal but my own via pickup */
    int want = n_prop - (am_proposer ? 1 : 0);
    int seen[256] = {0};
    for (int i = 0; i < want; i++) {
        uint8_t buf[64];
        int tag, origin, pid, vote;
        int64_t n = pickup_spin(w, e, &tag, &origin, &pid, &vote, buf,
                                sizeof buf);
        RCHECK(n >= 0);
        RCHECK(tag == RLO_TAG_IAR_DECISION && vote == 1);
        RCHECK(pid >= 0 && pid < 256 && !seen[pid]);
        seen[pid] = 1;
    }
    if (am_proposer) {
        RCHECK(proposal_spin(w, e) == 0);
        RCHECK(rlo_vote_my_proposal(e) == 1);
    }
    RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
    RCHECK(rlo_engine_err(e) == RLO_OK);
    rlo_engine_free(e);
    return 0;
}

/* ---- concurrent multi-proposal on TWO engines ----
 * Reference test_concurrent_iar_multi_proposal (testcases.c:488-594):
 * the product of engine multiplexing (iar2) and several simultaneous
 * proposers (multi), plus pid reuse across two sequential rounds (each
 * proposer reuses pid=rank; the round generation disambiguates). */
static int case_multi2(rlo_world *w, int rank, void *vcfg)
{
    (void)vcfg;
    int ws = rlo_world_size(w);
    rlo_engine *a = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    rlo_engine *b = rlo_engine_new(w, rank, 1, 0, 0, 0, 0, 0);
    RCHECK(a && b);
    int am_proposer = rank == 1 % ws || rank % 4 == 0;
    int n_prop = 0;
    for (int r = 0; r < ws; r++)
        if (r == 1 % ws || r % 4 == 0)
            n_prop++;
    for (int round = 0; round < 2; round++) {
        if (am_proposer) {
            RCHECK(rlo_submit_proposal(a, (const uint8_t *)"mA", 2,
                                       rank) >= -1);
            RCHECK(rlo_submit_proposal(b, (const uint8_t *)"mB", 2,
                                       rank) >= -1);
        }
        /* decision-count oracle per engine: one decision per foreign
         * proposal, each pid exactly once, all approved */
        int want = n_prop - (am_proposer ? 1 : 0);
        for (int ei = 0; ei < 2; ei++) {
            rlo_engine *e = ei ? b : a;
            int seen[256] = {0};
            for (int i = 0; i < want; i++) {
                uint8_t buf[64];
                int tag, origin, pid, vote;
                int64_t n = pickup_spin(w, e, &tag, &origin, &pid, &vote,
                                        buf, sizeof buf);
                RCHECK(n >= 0);
                RCHECK(tag == RLO_TAG_IAR_DECISION && vote == 1);
                RCHECK(pid >= 0 && pid < 256 && !seen[pid]);
                seen[pid] = 1;
            }
        }
        if (am_proposer) {
            RCHECK(proposal_spin(w, a) == 0);
            RCHECK(rlo_vote_my_proposal(a) == 1);
            RCHECK(proposal_spin(w, b) == 0);
            RCHECK(rlo_vote_my_proposal(b) == 1);
        }
        RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
        /* the drain is collective but its EXIT is not simultaneous: a
         * fast rank submitting round r+1 immediately would regenerate
         * traffic and keep a slow rank's drain from ever observing
         * global idle. Barrier between rounds closes that race. */
        rlo_world_barrier(w);
    }
    RCHECK(rlo_engine_err(a) == RLO_OK && rlo_engine_err(b) == RLO_OK);
    rlo_engine_free(a);
    rlo_engine_free(b);
    return 0;
}

/* ---- bench: engine-substrate fp32 allreduce timing ----
 * BASELINE config 1 ("float32 allreduce, 8 MPI ranks, 1 MB buffer,
 * testcases via mpirun on CPU"): the bcast-gather allreduce over the
 * rootless overlay — every rank broadcasts its buffer, drains, and
 * sums everything through the zero-copy peek/consume path. Runs on any
 * multi-process transport (shm or MPI), one real process per rank; the
 * in-process variant is rlo_bench.c. Rank 0 prints median usec. */
static int case_bench(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    int ws = rlo_world_size(w);
    int64_t nbytes = cfg->bytes > 0 ? cfg->bytes : 1 << 20;
    int64_t count = nbytes / (int64_t)sizeof(float);
    int reps = cfg->msgs > 0 && cfg->msgs <= 100 ? cfg->msgs : 5;
    nbytes = count * (int64_t)sizeof(float);
    rlo_engine *e = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, nbytes + 64);
    RCHECK(e);
    float *buf = (float *)malloc((size_t)nbytes);
    float *acc = (float *)malloc((size_t)nbytes);
    double *times = (double *)calloc((size_t)reps, sizeof(double));
    RCHECK(buf && acc && times);
    for (int64_t i = 0; i < count; i++)
        buf[i] = (float)((rank + 1) * ((i % 13) + 1));
    rlo_world_barrier(w);
    for (int rep = 0; rep < reps; rep++) {
        uint64_t t0 = rlo_now_usec();
        RCHECK(rlo_bcast(e, (const uint8_t *)buf, nbytes) == RLO_OK);
        RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
        memcpy(acc, buf, (size_t)nbytes);
        for (int got = 0; got < ws - 1; got++) {
            const uint8_t *payload = 0;
            int64_t n = rlo_pickup_peek(e, 0, 0, 0, 0, &payload);
            RCHECK(n == nbytes);
            const float *f = (const float *)payload;
            for (int64_t i = 0; i < count; i++)
                acc[i] += f[i];
            rlo_pickup_consume(e);
        }
        times[rep] = (double)(rlo_now_usec() - t0);
        /* oracle: sum over ranks of (r+1)*k at i=0 (k=1) */
        RCHECK(acc[0] == (float)(ws * (ws + 1) / 2));
        rlo_world_barrier(w);
    }
    for (int i = 0; i < reps; i++)
        for (int j = i + 1; j < reps; j++)
            if (times[j] < times[i]) {
                double t = times[i];
                times[i] = times[j];
                times[j] = t;
            }
    if (rank == 0)
        printf("bench[%s]: engine allreduce (bcast-gather) %lld B x %d "
               "ranks: median %.0f usec\n",
               rlo_world_transport(w), (long long)nbytes, ws,
               times[reps / 2]);
    fflush(stdout);

    /* ring allreduce over the same transport (rlo_coll.c) — the
     * bandwidth-optimal schedule, one real process per rank */
    rlo_coll *coll = rlo_coll_new(w, rank, 64);
    RCHECK(coll);
    for (int rep = 0; rep < reps; rep++) {
        for (int64_t i = 0; i < count; i++)
            buf[i] = (float)((rank + 1) * ((i % 13) + 1));
        rlo_world_barrier(w);
        uint64_t t0 = rlo_now_usec();
        RCHECK(rlo_coll_allreduce_f32_start(coll, buf, count,
                                            RLO_COLL_SUM) == RLO_OK);
        RCHECK(rlo_coll_wait(coll, 2000000000L) == RLO_OK);
        times[rep] = (double)(rlo_now_usec() - t0);
        RCHECK(buf[0] == (float)(ws * (ws + 1) / 2));
        rlo_world_barrier(w);
    }
    for (int i = 0; i < reps; i++)
        for (int j = i + 1; j < reps; j++)
            if (times[j] < times[i]) {
                double t = times[i];
                times[i] = times[j];
                times[j] = t;
            }
    if (rank == 0)
        printf("bench[%s]: ring allreduce (rlo_coll) %lld B x %d ranks: "
               "median %.0f usec\n",
               rlo_world_transport(w), (long long)nbytes, ws,
               times[reps / 2]);
    fflush(stdout);
    rlo_coll_free(coll);
    free(buf);
    free(acc);
    free(times);
    RCHECK(rlo_engine_err(e) == RLO_OK);
    rlo_engine_free(e);
    return 0;
}

#ifdef RLO_HAVE_MPI
#include <mpi.h>

/* ---- nbcast: overlay bcast vs native MPI_Bcast ----
 * Reference native_benchmark_single_point_bcast
 * (rootless_ops.c:1675-1709): time `msgs` rootless
 * broadcasts from rank 0 over the overlay vs the same traffic as
 * native MPI_Bcast calls. MPI builds only (needs direct MPI calls).
 *
 * Protocol (round 4): on the oversubscribed single-core launch the
 * scheduler drifts by whole timeslices between windows, so a
 * single overlay-window/native-window comparison swings 0.7x-2.7x run
 * to run. Like bench.py's paired-ratio protocol, the two sides are
 * timed in ADJACENT per-block windows and the reported ratio is the
 * MEDIAN of per-block ratios — common-mode scheduler phases cancel,
 * asymmetric spikes are rejected. */
#define NB_BLOCKS 7
static int case_nbcast(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    int64_t nbytes = cfg->bytes > 0 ? cfg->bytes : 4096;
    int reps = cfg->msgs > 0 ? cfg->msgs : 16;
    rlo_engine *e = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, nbytes + 64);
    RCHECK(e);
    uint8_t *buf = (uint8_t *)malloc((size_t)nbytes);
    RCHECK(buf);
    memset(buf, rank == 0 ? 0x5a : 0, (size_t)nbytes);
    /* per block, THREE adjacent windows — skip-ring overlay, flat
     * overlay (depth-1, rlo_engine_set_fanout), native MPI_Bcast —
     * in an order rotated per block so no side systematically pays a
     * first-window warmup */
    double r_skip[NB_BLOCKS], r_flat[NB_BLOCKS];
    double us[3][NB_BLOCKS];
    for (int b = 0; b < NB_BLOCKS; b++) {
        uint64_t t_side[3] = {0, 0, 0};
        for (int s = 0; s < 3; s++) {
            int side = (s + b) % 3;
            if (side < 2)
                RCHECK(rlo_engine_set_fanout(
                           e, side == 0 ? RLO_FANOUT_SKIP_RING
                                        : RLO_FANOUT_FLAT) == RLO_OK);
            rlo_world_barrier(w);
            uint64_t t0 = rlo_now_usec();
            if (side < 2) {
                /* overlay: rank 0 broadcasts; others pick up; the
                 * window ends at settlement — every rank idle (all
                 * reps consumed and forwarded) + one barrier, the
                 * SAME end semantics as the native side's
                 * MPI_Barrier. (The full termination-detection drain
                 * would cost ~3 extra collective rounds the native
                 * side never pays; it is for when the recipient set
                 * is unknown.) */
                for (int i = 0; i < reps; i++) {
                    if (rank == 0)
                        RCHECK(rlo_bcast(e, buf, nbytes) == RLO_OK);
                    else {
                        const uint8_t *payload = 0;
                        int64_t n = -1;
                        for (long spin = 0;
                             spin < 200000000L && n < 0; spin++) {
                            n = rlo_pickup_peek(e, 0, 0, 0, 0,
                                                &payload);
                            if (n < 0) {
                                rlo_progress_all(w);
                                /* hand the CPU to the feeding rank
                                 * promptly (most of the round-2 19x
                                 * gap) */
                                if ((spin & 7) == 7)
                                    sched_yield();
                            }
                        }
                        RCHECK(n == nbytes && payload[0] == 0x5a);
                        rlo_pickup_consume(e);
                    }
                }
                for (long spin = 0; !rlo_engine_idle(e); spin++) {
                    RCHECK(spin < 200000000L);
                    rlo_progress_all(w);
                    if ((spin & 7) == 7)
                        sched_yield();
                }
                rlo_world_barrier(w);
            } else {
                /* native window; ends at a barrier — the settlement
                 * analogue (root-side send timing alone would flatter
                 * the native side) */
                for (int i = 0; i < reps; i++)
                    RCHECK(MPI_Bcast(buf, (int)nbytes, MPI_BYTE, 0,
                                     MPI_COMM_WORLD) == MPI_SUCCESS);
                RCHECK(buf[0] == 0x5a);
                MPI_Barrier(MPI_COMM_WORLD);
            }
            t_side[side] = rlo_now_usec() - t0;
        }
        for (int side = 0; side < 3; side++)
            us[side][b] = (double)t_side[side] / reps;
        double tn = t_side[2] ? (double)t_side[2] : 1.0;
        r_skip[b] = (double)t_side[0] / tn;
        r_flat[b] = (double)t_side[1] / tn;
    }
    rlo_world_barrier(w);
    if (rank == 0) {
        /* medians by insertion sort (NB_BLOCKS is tiny) */
        double *arrs[5] = {r_skip, r_flat, us[0], us[1], us[2]};
        for (int a = 0; a < 5; a++)
            for (int i = 1; i < NB_BLOCKS; i++)
                for (int j = i;
                     j > 0 && arrs[a][j] < arrs[a][j - 1]; j--) {
                    double t = arrs[a][j];
                    arrs[a][j] = arrs[a][j - 1];
                    arrs[a][j - 1] = t;
                }
        int m = NB_BLOCKS / 2;
        printf("nbcast: %dx%d x %lld B: overlay skip-ring %.1f / flat "
               "%.1f / MPI_Bcast %.1f usec/bcast (medians of %d "
               "3-window blocks: skip-ring/native %.2fx, flat/native "
               "%.2fx; skip",
               NB_BLOCKS, reps, (long long)nbytes, us[0][m], us[1][m],
               us[2][m], NB_BLOCKS, r_skip[m], r_flat[m]);
        for (int b = 0; b < NB_BLOCKS; b++)
            printf(" %.2f", r_skip[b]);
        printf("; flat");
        for (int b = 0; b < NB_BLOCKS; b++)
            printf(" %.2f", r_flat[b]);
        printf(")\n");
        /* ---- floor analysis (round-5 VERDICT item 7) ----
         * Why the overlay cannot reach 1.00x here: both sides move
         * the same ws-1 frames through the same femtompi rings on one
         * oversubscribed core, so the overlay's extra cost is the
         * engine machinery those frames pass through (wire header
         * serialize/parse, (origin, seq) dedup, queue ops, pickup
         * API) that a bare MPI_Bcast never runs. Quantify it on an
         * in-process loopback world — same engine code, no scheduler,
         * no transport contention — and report how much of the
         * overlay-native gap the serialized engine CPU accounts for. */
        double lb = rlo_bench_bcast_usec(rlo_world_size(w), nbytes,
                                         64);
        if (lb >= 0) {
            int frames = rlo_world_size(w) - 1;
            double gap = us[0][m] - us[2][m];
            printf("nbcast floor: loopback overlay %.2f usec/bcast "
                   "(%d frames, %.2f usec/frame engine+wire CPU); "
                   "overlay-native gap %.2f usec -> engine CPU "
                   "accounts for %.0f%%\n",
                   lb, frames, lb / frames, gap,
                   gap > 0 ? 100.0 * (lb < gap ? lb / gap : 1.0)
                           : 100.0);
        }
    }
    fflush(stdout);
    free(buf);
    RCHECK(rlo_engine_err(e) == RLO_OK);
    rlo_engine_free(e);
    return 0;
}
#endif /* RLO_HAVE_MPI */

#ifdef RLO_HAVE_MPI
/* ---- toobig: oversized collectives fail symmetrically ----
 * A frame larger than the femtompi per-pair ring can never be
 * delivered; every rank must get MPI_ERR_OTHER promptly instead of
 * the sender erroring alone while peers park in blocking waits until
 * the launcher timeout (the round-3 review finding). */
static int case_toobig(rlo_world *w, int rank, void *vcfg)
{
    (void)vcfg;
    (void)w;
    /* far above any configured ring (femtompirun default 4 MB) */
    int count = 256 << 20;
    static uint8_t tiny[1]; /* never touched: the size check fires
                               before any buffer access */
    uint64_t t0 = rlo_now_usec();
    RCHECK(MPI_Bcast(tiny, count, MPI_BYTE, 0, MPI_COMM_WORLD) ==
           MPI_ERR_OTHER);
    RCHECK(MPI_Reduce(tiny, tiny, count, MPI_BYTE, MPI_SUM, 0,
                      MPI_COMM_WORLD) == MPI_ERR_OTHER);
    MPI_Request req;
    RCHECK(MPI_Iallreduce(tiny, tiny, count / 4, MPI_INT, MPI_SUM,
                          MPI_COMM_WORLD, &req) == MPI_ERR_OTHER);
    /* symmetric + prompt: nobody blocked on a peer */
    RCHECK(rlo_now_usec() - t0 < 5 * 1000 * 1000ull);
    MPI_Barrier(MPI_COMM_WORLD); /* everyone got here: no hang */
    return 0;
}
#endif /* RLO_HAVE_MPI */

/* ---- subcomm: engine over a rank subset (sub-communicator) ----
 * Reference parity: RLO_progress_engine_new on any MPI_Comm — an
 * engine spanning ranks {0,2,ws-1} (rootless_ops.c:467, 1461) — while
 * a full-world engine runs interleaved traffic on comm 0. Oracles:
 * subset bcast/IAR deliveries span exactly the member set, the
 * bystander full-world broadcast is undisturbed, and the subset
 * decision reflects a member's veto. */
static int case_subcomm(rlo_world *w, int rank, void *vcfg)
{
    (void)vcfg;
    int ws = rlo_world_size(w);
    /* members {0, 2, ws-1} when the world is big enough for true
     * bystanders; degenerate {0, ws-1} pair otherwise (ws 2-3) */
    int members[3], n_m;
    if (ws >= 4) {
        members[0] = 0; members[1] = 2; members[2] = ws - 1;
        n_m = 3;
    } else {
        members[0] = 0; members[1] = ws - 1;
        n_m = 2;
    }
    int is_member = 0;
    for (int i = 0; i < n_m; i++)
        if (members[i] == rank)
            is_member = 1;
    int sub_bcaster = members[1];
    rlo_engine *ef = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    RCHECK(ef);
    iar_ctx ctx = {.veto = rank == ws - 1, .actions = 0};
    rlo_engine *es = 0;
    if (is_member) {
        es = rlo_engine_new_sub(w, rank, 1, members, n_m, judge_cb,
                                &ctx, action_cb, &ctx, 0);
        RCHECK(es);
    } else {
        /* a non-member must be rejected */
        RCHECK(!rlo_engine_new_sub(w, rank, 1, members, n_m, 0, 0, 0, 0,
                                   0));
    }
    /* interleaved: rank 1 broadcasts on the full comm, member
     * sub_bcaster on the subset, member 0 proposes (ws-1 vetoes) */
    if (rank == 1)
        RCHECK(rlo_bcast(ef, (const uint8_t *)"full", 4) == RLO_OK);
    if (rank == sub_bcaster)
        RCHECK(rlo_bcast(es, (const uint8_t *)"sub", 3) == RLO_OK);
    if (rank == 0) {
        int rc = rlo_submit_proposal(es, (const uint8_t *)"p", 1, 0);
        RCHECK(rc == -1 || rc == 0);
        RCHECK(proposal_spin(w, es) == 0);
        RCHECK(rlo_vote_my_proposal(es) == 0); /* the veto won */
    }
    /* full comm: everyone but the initiator picks up "full" */
    if (rank != 1) {
        uint8_t buf[64];
        int tag, origin, pid, vote;
        int64_t n = pickup_spin(w, ef, &tag, &origin, &pid, &vote, buf,
                                sizeof buf);
        RCHECK(n == 4 && origin == 1 && tag == RLO_TAG_BCAST);
    }
    /* subset comm: members pick up the subset bcast (except its
     * initiator) and the declined decision (except the proposer),
     * arrival order unknown */
    if (is_member) {
        int want = (rank == sub_bcaster ? 0 : 1) + (rank == 0 ? 0 : 1);
        int got_b = 0, got_d = 0;
        for (int i = 0; i < want; i++) {
            uint8_t buf[64];
            int tag, origin, pid, vote;
            int64_t n = pickup_spin(w, es, &tag, &origin, &pid, &vote,
                                    buf, sizeof buf);
            RCHECK(n >= 0);
            if (tag == RLO_TAG_BCAST) {
                RCHECK(n == 3 && origin == sub_bcaster);
                got_b++;
            } else {
                RCHECK(tag == RLO_TAG_IAR_DECISION && pid == 0 &&
                       vote == 0);
                got_d++;
            }
        }
        RCHECK(got_b == (rank == sub_bcaster ? 0 : 1));
        RCHECK(got_d == (rank == 0 ? 0 : 1));
        RCHECK(ctx.actions == 0); /* declined round: no actions */
    }
    RCHECK(rlo_drain(w, DRAIN_SPINS) >= 0);
    RCHECK(rlo_engine_err(ef) == RLO_OK);
    if (es)
        RCHECK(rlo_engine_err(es) == RLO_OK);
    rlo_engine_free(ef);
    if (es)
        rlo_engine_free(es);
    return 0;
}

/* ---- fail: a rank dies; survivors detect it via shm heartbeats ----
 * Net-new failure detection (the reference defines RLO_FAILED,
 * rootless_ops.h:66, but never assigns it; no timeouts or rank-failure
 * handling anywhere — SURVEY.md §5). The victim (last rank) exits right
 * after the start barrier without draining, simulating a crash: its
 * heartbeat slot goes stale. Survivors spin progress (which pumps rings
 * and stamps their own heartbeats) until rlo_world_peer_alive reports
 * the victim dead, while confirming no false positive on launch-fresh
 * peers. No global drain — that is the point: a dead rank would hang
 * the reference's MPI_Iallreduce-style drain forever. */
static int case_fail(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    int ws = rlo_world_size(w);
    int victim = ws - 1;
    const uint64_t timeout_usec = 300 * 1000;
    /* everyone is up and launch-stamped: no peer may look dead yet
     * against a generous window */
    for (int r = 0; r < ws; r++)
        RCHECK(rlo_world_peer_alive(w, r, 60 * 1000 * 1000));
    rlo_shm_barrier(w);
    if (rank == victim)
        return 0; /* "crash": stop pumping, heartbeat goes stale */
    rlo_engine *e = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    RCHECK(e);
    uint64_t t0 = rlo_now_usec();
    int detected = 0;
    while (rlo_now_usec() - t0 < 30ull * 1000 * 1000) {
        rlo_progress_all(w); /* pumps rings -> stamps my heartbeat */
        if (!rlo_world_peer_alive(w, victim, timeout_usec)) {
            detected = 1;
            break;
        }
    }
    RCHECK(detected);
    RCHECK(rlo_world_peer_alive(w, rank, timeout_usec)); /* self alive */
    if (cfg->verbose)
        fprintf(stderr, "rank %d: victim %d detected dead in %llu usec\n",
                rank, victim,
                (unsigned long long)(rlo_now_usec() - t0));
    rlo_engine_free(e);
    return 0;
}

/* ---- efail: engine-level elastic recovery across real processes ----
 * The full failure story on the multi-process transport: every rank
 * runs a progress engine with heartbeat detection; the victim crashes
 * after the start barrier; survivors detect it through missed ENGINE
 * heartbeats (not just transport staleness), adopt the FAILURE
 * broadcast, re-form the overlay, and complete a broadcast among
 * themselves — all without a global drain, which a dead rank would
 * stall forever. */
static int case_efail(rlo_world *w, int rank, void *vcfg)
{
    const demo_cfg *cfg = (const demo_cfg *)vcfg;
    int ws = rlo_world_size(w);
    int victim = ws - 1;
    int origin = 0;
    rlo_shm_barrier(w);
    if (rank == victim)
        return 0; /* crash: no drain, no goodbye */
    rlo_engine *e = rlo_engine_new(w, rank, 0, 0, 0, 0, 0, 0);
    RCHECK(e);
    RCHECK(rlo_engine_enable_failure_detection(e, 100 * 1000,
                                               20 * 1000) == RLO_OK);
    uint64_t t0 = rlo_now_usec();
    while (!rlo_engine_rank_failed(e, victim)) {
        rlo_progress_all(w);
        RCHECK(rlo_now_usec() - t0 < 30ull * 1000 * 1000);
    }
    if (cfg->verbose)
        fprintf(stderr, "rank %d: engine detected %d dead (%llu usec)\n",
                rank, victim,
                (unsigned long long)(rlo_now_usec() - t0));
    /* give every survivor time to adopt before re-using the overlay
     * (no pickup flush here: an early-arriving broadcast would be
     * swallowed; the receive loop below skips FAILURE notices instead) */
    t0 = rlo_now_usec();
    while (rlo_now_usec() - t0 < 300ull * 1000)
        rlo_progress_all(w);
    uint8_t buf[256];
    if (rank == origin)
        RCHECK(rlo_bcast(e, (const uint8_t *)"elastic", 7) == RLO_OK);
    if (rank != origin) {
        /* straggler FAILURE notices (duplicated during the view
         * transition) may still arrive — skip them, wait for the bcast */
        for (;;) {
            int tag = -1, org = -1, pid, vote;
            int64_t n = pickup_spin(w, e, &tag, &org, &pid, &vote, buf,
                                    sizeof buf);
            RCHECK(n >= 0);
            if (tag == RLO_TAG_FAILURE)
                continue;
            RCHECK(n == 7 && org == origin && tag == RLO_TAG_BCAST);
            break;
        }
    }
    /* settle outstanding forwards without a global drain */
    t0 = rlo_now_usec();
    while (rlo_now_usec() - t0 < 300ull * 1000)
        rlo_progress_all(w);
    rlo_engine_free(e);
    return 0;
}

/* ------------------------------------------------------------------ */

typedef struct demo_case {
    const char *name;
    rlo_rank_fn fn;
} demo_case;

static const demo_case CASES[] = {
    {"bcast", case_bcast},   {"wrapper", case_wrapper},
    {"hacky", case_hacky},   {"iar", case_iar},
    {"iar2", case_iar2},     {"multi", case_multi},
    {"multi2", case_multi2}, {"bench", case_bench},
    {"subcomm", case_subcomm},
#ifdef RLO_HAVE_MPI
    {"nbcast", case_nbcast},
    {"toobig", case_toobig},
#endif
    {"fail", case_fail},     {"efail", case_efail},
};
#define N_CASES (int)(sizeof CASES / sizeof *CASES)

/* cases that need shm-specific machinery (process-crash injection,
 * shared heartbeat slots) and cannot run over the MPI/TCP transports */
static int shm_only(const char *name)
{
    return !strcmp(name, "fail") || !strcmp(name, "efail");
}

/* Under the TCP launcher (tcprun / RLO_TCP_RANK env): one rank per
 * process over a real socket mesh — the transport that crosses host
 * boundaries (round-4 VERDICT; reference deploys on any MPI cluster,
 * rootless_ops.c:1123). nbcast/toobig additionally need an MPI
 * library and stay mpirun-only. */
static int tcp_main(const char *which, demo_cfg *cfg)
{
    rlo_world *w = rlo_tcp_world_new();
    if (!w) {
        fprintf(stderr, "rlo_tcp_world_new failed (env/ports?)\n");
        return 1;
    }
    int rank = rlo_world_my_rank(w);
    int ws = rlo_world_size(w);
    int failures = 0, matched = 0;
    for (int c = 0; c < N_CASES; c++) {
        if (strcmp(which, "all") && strcmp(which, CASES[c].name))
            continue;
        matched++;
        if (shm_only(CASES[c].name) ||
            !strcmp(CASES[c].name, "nbcast") ||
            !strcmp(CASES[c].name, "toobig")) {
            if (rank == 0)
                printf("%-8s n=%-3d SKIP (%s)\n", CASES[c].name, ws,
                       shm_only(CASES[c].name) ? "shm-only"
                                               : "mpirun-only");
            fflush(stdout);
            continue;
        }
        uint64_t t0 = rlo_now_usec();
        int rc = CASES[c].fn(w, rank, cfg);
        rlo_world_barrier(w);
        if (rank == 0)
            printf("%-8s n=%-3d %s (%llu usec) [tcp]\n", CASES[c].name,
                   ws, rc == 0 ? "PASS" : "FAIL",
                   (unsigned long long)(rlo_now_usec() - t0));
        fflush(stdout);
        if (rc != 0)
            failures++;
    }
    if (!matched && rank == 0)
        fprintf(stderr, "unknown case '%s'\n", which);
    rlo_world_free(w);
    return failures || !matched ? 1 : 0;
}

#ifdef RLO_HAVE_MPI
/* Under mpirun (femtompirun or a real MPI launcher) the demo runs ONE
 * rank per process over the MPI transport — `mpirun -n N ./rlo_demo_mpi
 * -c case`, the reference's own run shape (SURVEY.md §4). */
static int mpi_main(const char *which, demo_cfg *cfg)
{
    rlo_world *w = rlo_mpi_world_new();
    if (!w) {
        fprintf(stderr, "rlo_mpi_world_new failed\n");
        return 1;
    }
    int rank = rlo_world_my_rank(w);
    int ws = rlo_world_size(w);
    int failures = 0, matched = 0;
    for (int c = 0; c < N_CASES; c++) {
        if (strcmp(which, "all") && strcmp(which, CASES[c].name))
            continue;
        matched++;
        if (shm_only(CASES[c].name)) {
            if (rank == 0)
                printf("%-8s n=%-3d SKIP (shm-only)\n", CASES[c].name,
                       ws);
            continue;
        }
        uint64_t t0 = rlo_now_usec();
        int rc = CASES[c].fn(w, rank, cfg);
        rlo_world_barrier(w);
        if (rank == 0)
            printf("%-8s n=%-3d %s (%llu usec) [mpi]\n", CASES[c].name,
                   ws, rc == 0 ? "PASS" : "FAIL",
                   (unsigned long long)(rlo_now_usec() - t0));
        if (rc != 0)
            failures++;
    }
    if (!matched && rank == 0)
        fprintf(stderr, "unknown case '%s'\n", which);
    rlo_world_free(w);
    return failures || !matched ? 1 : 0;
}
#endif /* RLO_HAVE_MPI */

int main(int argc, char **argv)
{
    int ws = 8;
    const char *which = "all";
    demo_cfg cfg = {.msgs = 16, .veto = -1, .verbose = 0, .bytes = 0};
    for (int i = 1; i < argc; i++) {
        if (!strcmp(argv[i], "-n") && i + 1 < argc)
            ws = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-c") && i + 1 < argc)
            which = argv[++i];
        else if (!strcmp(argv[i], "-m") && i + 1 < argc)
            cfg.msgs = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-b") && i + 1 < argc)
            cfg.bytes = atoll(argv[++i]);
        else if (!strcmp(argv[i], "-veto") && i + 1 < argc)
            cfg.veto = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-v"))
            cfg.verbose = 1;
        else {
            fprintf(stderr,
                    "usage: %s [-n ranks] [-c case|all] [-m msgs] "
                    "[-b bytes] [-veto rank] [-v]\ncases:",
                    argv[0]);
            for (int c = 0; c < N_CASES; c++)
                fprintf(stderr, " %s", CASES[c].name);
            fprintf(stderr, "\n");
            return 2;
        }
    }
    /* launched under tcprun? run one rank over the socket mesh */
    if (getenv("RLO_TCP_RANK"))
        return tcp_main(which, &cfg);
#ifdef RLO_HAVE_MPI
    /* launched under mpirun? run one rank over the MPI transport */
    if (getenv("FEMTOMPI_RANK") || getenv("OMPI_COMM_WORLD_RANK") ||
        getenv("PMI_RANK"))
        return mpi_main(which, &cfg);
#endif
    int failures = 0, matched = 0;
    for (int c = 0; c < N_CASES; c++) {
        if (strcmp(which, "all") && strcmp(which, CASES[c].name))
            continue;
        matched++;
#ifdef RLO_HAVE_MPI
        if (!strcmp(CASES[c].name, "nbcast") ||
            !strcmp(CASES[c].name, "toobig")) {
            /* needs a live MPI runtime: only valid under an mpirun
             * launcher (mpi_main); calling MPI_Bcast from the shm
             * children without MPI_Init would abort */
            printf("%-8s n=%-3d SKIP (mpirun-only)\n", CASES[c].name,
                   ws);
            fflush(stdout);
            continue;
        }
#endif
        /* iar additionally runs the dissent variant (reference
         * parameterized agree/disagree, testcases.c:243-332) */
        int reps = !strcmp(CASES[c].name, "iar") && cfg.veto < 0 ? 2 : 1;
        for (int rep = 0; rep < reps; rep++) {
            demo_cfg run = cfg;
            if (reps == 2 && rep == 1)
                run.veto = ws - 1;
            /* the bench case ships full payload frames through the
             * rings; size them to hold several in flight */
            int64_t ring = 0;
            if (!strcmp(CASES[c].name, "bench")) {
                int64_t payload = run.bytes > 0 ? run.bytes : 1 << 20;
                ring = 4 * payload + (64 << 10);
            }
            uint64_t t0 = rlo_now_usec();
            int rc = rlo_shm_launch(ws, ring, CASES[c].fn, &run);
            printf("%-8s n=%-3d %s (%llu usec)%s\n", CASES[c].name, ws,
                   rc == 0 ? "PASS" : "FAIL",
                   (unsigned long long)(rlo_now_usec() - t0),
                   reps == 2 && rep == 1 ? " [veto]" : "");
            /* flush BEFORE the next fork: children inherit the stdio
             * buffer, and their own flushes would replay it */
            fflush(stdout);
            if (rc != 0)
                failures++;
        }
    }
    if (!matched) {
        fprintf(stderr, "unknown case '%s'\n", which);
        return 2;
    }
    if (failures)
        fprintf(stderr, "%d case(s) FAILED\n", failures);
    return failures ? 1 : 0;
}
