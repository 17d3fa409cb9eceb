/* Structured event tracing — native twin of rlo_tpu_torch/utils/tracing.py.
 *
 * The reference's only observability is gettimeofday timestamps and
 * commented-out printf tracepoints (SURVEY.md §5); this replaces them
 * with a bounded process-local ring of typed events the engine emits at
 * every protocol step.
 *
 * Concurrency (docs/DESIGN.md §15, rlo-sentinel S1): the ring is the
 * ONE piece of process-global mutable state reachable from the
 * GIL-releasing batched progress entry points.  Each world is
 * single-threaded cooperative polling, but two app threads may drive
 * two DIFFERENT worlds concurrently (the PR-8 serving-pump shape), and
 * both emit into this ring — so it is mutex-protected.  The
 * enabled flag is a relaxed atomic: the disabled fast path stays one
 * branch + one relaxed load, no lock, preserving the "one predictable
 * branch per instrumented site" overhead contract of rlo_core.h.
 */
#include "rlo_internal.h"

#include <pthread.h>
#include <stdatomic.h>

#define TRACE_CAP 65536

/* every field below is read/written only under trace_mu (the enabled
 * flag is atomic; the mutex itself is a concurrency primitive and out
 * of S1 scope) */
static pthread_mutex_t trace_mu = PTHREAD_MUTEX_INITIALIZER;
/* rlo-sentinel: guarded-by(trace_mu) */
static rlo_trace_event ring[TRACE_CAP];
static int head;    /* next write slot; rlo-sentinel: guarded-by(trace_mu) */
static int count;   /* live events; rlo-sentinel: guarded-by(trace_mu) */
static atomic_int enabled;
static int64_t dropped; /* rlo-sentinel: guarded-by(trace_mu) */

void rlo_trace_set(int on)
{
    atomic_store_explicit(&enabled, on, memory_order_relaxed);
}

int rlo_trace_enabled(void)
{
    return atomic_load_explicit(&enabled, memory_order_relaxed);
}

void rlo_trace_emit(int rank, int kind, int a, int b, int c, int d)
{
    if (!atomic_load_explicit(&enabled, memory_order_relaxed))
        return;
    uint64_t now = rlo_now_usec();
    pthread_mutex_lock(&trace_mu);
    rlo_trace_event *e = &ring[head];
    e->ts_usec = now;
    e->rank = rank;
    e->kind = kind;
    e->a = a;
    e->b = b;
    e->c = c;
    e->d = d;
    head = (head + 1) % TRACE_CAP;
    if (count < TRACE_CAP)
        count++;
    else
        dropped++;
    pthread_mutex_unlock(&trace_mu);
}

int rlo_trace_capacity(void)
{
    return TRACE_CAP;
}

int rlo_trace_drain(rlo_trace_event *out, int max)
{
    pthread_mutex_lock(&trace_mu);
    int n = count < max ? count : max;
    int start = (head - count + TRACE_CAP) % TRACE_CAP;
    for (int i = 0; i < n; i++)
        out[i] = ring[(start + i) % TRACE_CAP];
    count -= n;
    pthread_mutex_unlock(&trace_mu);
    return n;
}

int64_t rlo_trace_dropped(void)
{
    pthread_mutex_lock(&trace_mu);
    int64_t d = dropped;
    pthread_mutex_unlock(&trace_mu);
    return d;
}

void rlo_trace_clear(void)
{
    pthread_mutex_lock(&trace_mu);
    head = count = 0;
    dropped = 0;
    pthread_mutex_unlock(&trace_mu);
}
