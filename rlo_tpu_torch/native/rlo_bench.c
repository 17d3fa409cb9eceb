/* Wholly-native micro-benchmark entry points, driven by one ctypes call.
 *
 * The BASELINE.json config-1 comparison ("allreduce on the engine
 * substrate") must measure the C engines themselves, not the Python
 * driver's ctypes boundary copies — so the full workload (bcast-gather
 * allreduce over the rootless broadcast overlay, the NativeBackend
 * data-collective algorithm) runs inside the library: every rank
 * broadcasts its fp32 buffer, the world drains, every rank sums what it
 * picks up through the zero-copy peek/consume path. The reference's own
 * benchmark harnesses are likewise all-native timing loops
 * (testcases.c:71-98, rootless_ops.c:1675-1709).
 */
#include "rlo_internal.h"

#include <stdio.h>

/* Median usec per allreduce over `reps` runs of a bcast-gather fp32
 * allreduce of `count` floats per rank, world_size in-process loopback
 * ranks. Returns <0 (rlo_err) on failure or a wrong reduction result. */
double rlo_bench_allreduce(int world_size, int64_t count, int reps)
{
    if (world_size < 2 || count <= 0 || reps <= 0 || reps > 1000)
        return RLO_ERR_ARG;
    rlo_world *w = rlo_world_new(world_size, 0, 0);
    if (!w)
        return RLO_ERR_NOMEM;
    double rc = RLO_ERR_NOMEM;
    int64_t nbytes = count * (int64_t)sizeof(float);
    rlo_engine **engines = 0;
    float **bufs = 0;   /* per-rank payloads */
    float *acc = 0;
    double *times = 0;

    engines = (rlo_engine **)calloc((size_t)world_size, sizeof(void *));
    bufs = (float **)calloc((size_t)world_size, sizeof(void *));
    acc = (float *)malloc((size_t)nbytes);
    times = (double *)calloc((size_t)reps, sizeof(double));
    if (!engines || !bufs || !acc || !times)
        goto out;
    for (int r = 0; r < world_size; r++) {
        engines[r] = rlo_engine_new(w, r, 0, 0, 0, 0, 0, nbytes + 64);
        bufs[r] = (float *)malloc((size_t)nbytes);
        if (!engines[r] || !bufs[r])
            goto out;
        for (int64_t i = 0; i < count; i++)
            bufs[r][i] = (float)((r + 1) * ((i % 13) + 1));
    }

    for (int rep = 0; rep < reps; rep++) {
        uint64_t t0 = rlo_now_usec();
        for (int r = 0; r < world_size; r++) {
            int src = rlo_bcast(engines[r], (const uint8_t *)bufs[r],
                                nbytes);
            if (src != RLO_OK) {
                rc = src;
                goto out;
            }
        }
        int spun = rlo_drain(w, 1000000);
        if (spun < 0) {
            rc = spun;
            goto out;
        }
        for (int r = 0; r < world_size; r++) {
            memcpy(acc, bufs[r], (size_t)nbytes);
            for (int got = 0; got < world_size - 1; got++) {
                const uint8_t *payload = 0;
                int64_t n = rlo_pickup_peek(engines[r], 0, 0, 0, 0,
                                            &payload);
                if (n != nbytes) {
                    rc = RLO_ERR_PROTO;
                    goto out;
                }
                const float *f = (const float *)payload;
                for (int64_t i = 0; i < count; i++)
                    acc[i] += f[i];
                rlo_pickup_consume(engines[r]);
            }
        }
        times[rep] = (double)(rlo_now_usec() - t0);
        /* oracle: sum over ranks of (r+1)*k = k * ws*(ws+1)/2 */
        double want =
            (double)world_size * (world_size + 1) / 2.0 * ((0 % 13) + 1);
        if (acc[0] != (float)want) {
            rc = RLO_ERR_PROTO;
            goto out;
        }
    }
    /* median */
    for (int i = 0; i < reps; i++)
        for (int j = i + 1; j < reps; j++)
            if (times[j] < times[i]) {
                double t = times[i];
                times[i] = times[j];
                times[j] = t;
            }
    rc = times[reps / 2];

out:
    if (engines)
        for (int r = 0; r < world_size; r++)
            rlo_engine_free(engines[r]);
    if (bufs)
        for (int r = 0; r < world_size; r++)
            free(bufs[r]);
    free(engines);
    free(bufs);
    free(acc);
    free(times);
    rlo_world_free(w);
    return rc;
}

/* Median usec per SINGLE-ROOT broadcast (rank 0 -> all) of `nbytes`
 * over an in-process loopback world — the engine+wire machinery cost
 * of one overlay bcast with no transport contention and no scheduler:
 * every frame is a loopback queue hop (one memcpy) plus the engine's
 * serialize/demux/dedup/forward/pickup work. case_nbcast's floor
 * analysis divides this by (ws-1) frames to quantify the per-frame
 * engine CPU that the native MPI_Bcast path never pays (round-5
 * VERDICT item 7). Returns <0 (rlo_err) on failure. */
double rlo_bench_bcast_usec(int world_size, int64_t nbytes, int reps)
{
    if (world_size < 2 || nbytes <= 0 || reps <= 0 || reps > 10000)
        return RLO_ERR_ARG;
    rlo_world *w = rlo_world_new(world_size, 0, 0);
    if (!w)
        return RLO_ERR_NOMEM;
    double rc = RLO_ERR_NOMEM;
    rlo_engine **engines =
        (rlo_engine **)calloc((size_t)world_size, sizeof(void *));
    uint8_t *buf = (uint8_t *)malloc((size_t)nbytes);
    double *times = (double *)calloc((size_t)reps, sizeof(double));
    if (!engines || !buf || !times)
        goto out;
    memset(buf, 0x5a, (size_t)nbytes);
    for (int r = 0; r < world_size; r++) {
        engines[r] = rlo_engine_new(w, r, 0, 0, 0, 0, 0, nbytes + 64);
        if (!engines[r])
            goto out;
    }
    for (int rep = -2; rep < reps; rep++) { /* 2 warmup reps */
        uint64_t t0 = rlo_now_usec();
        int src = rlo_bcast(engines[0], buf, nbytes);
        if (src != RLO_OK) {
            rc = src;
            goto out;
        }
        int spun = rlo_drain(w, 1000000);
        if (spun < 0) {
            rc = spun;
            goto out;
        }
        for (int r = 1; r < world_size; r++) {
            const uint8_t *payload = 0;
            int64_t n = rlo_pickup_peek(engines[r], 0, 0, 0, 0,
                                        &payload);
            if (n != nbytes || payload[0] != 0x5a) {
                rc = RLO_ERR_PROTO;
                goto out;
            }
            rlo_pickup_consume(engines[r]);
        }
        if (rep >= 0)
            times[rep] = (double)(rlo_now_usec() - t0);
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
    if (engines)
        for (int r = 0; r < world_size; r++)
            rlo_engine_free(engines[r]);
    free(engines);
    free(buf);
    free(times);
    rlo_world_free(w);
    return rc;
}
