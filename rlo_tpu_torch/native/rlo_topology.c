/* Skip-ring overlay topology — pure functions, no state.
 *
 * Native counterpart of rlo_tpu_torch/topology.py; semantics match the reference
 * bcomm math (get_level rootless_ops.c:1427, last_wall :1444, send-list
 * construction in bcomm_init :1483-1515, check_passed_origin :1534,
 * fwd_send_cnt :1559) including the non-power-of-2 truncation rules.
 */
#include "rlo_core.h"

#include <sys/time.h>

int rlo_is_pow2(int n)
{
    return n > 0 && (n & (n - 1)) == 0;
}

static int floor_log2(int n)
{
    int l = -1;
    while (n > 0) {
        n >>= 1;
        l++;
    }
    return l;
}

int rlo_level(int world_size, int rank)
{
    if (rank == 0) {
        int l = floor_log2(world_size);
        return rlo_is_pow2(world_size) ? l - 1 : l;
    }
    /* count trailing zero bits */
    int l = 0;
    while (((rank >> l) & 1) == 0)
        l++;
    return l;
}

int rlo_last_wall(int world_size, int rank)
{
    if (rank == 0)
        return 1 << rlo_level(world_size, 0);
    return rank & (rank - 1); /* clear lowest set bit */
}

int rlo_send_list(int world_size, int rank, int *out, int cap,
                  int *channel_cnt)
{
    int lvl = rlo_level(world_size, rank);
    int chan = lvl;
    int n = 0;
    if (lvl + 1 > cap)
        return RLO_ERR_ARG;
    if (rlo_is_pow2(world_size)) {
        for (int i = 0; i <= lvl; i++)
            out[n++] = (rank + (1 << i)) % world_size;
    } else {
        for (int i = 0; i <= lvl; i++) {
            int dest = rank + (1 << i);
            if (dest >= world_size) {
                if (rank == world_size - 1) {
                    chan = 0;
                    out[0] = 0;
                    n = 1;
                } else {
                    chan = i;
                    out[i] = 0;
                    n = i + 1;
                }
                break;
            }
            out[n++] = dest;
        }
    }
    if (channel_cnt)
        *channel_cnt = chan;
    return n;
}

int rlo_check_passed_origin(int world_size, int my_rank, int origin,
                            int to_rank)
{
    (void)world_size;
    if (to_rank == origin)
        return 1;
    if (my_rank >= origin) {
        if (to_rank > my_rank)
            return 0;
        /* to_rank < my_rank: duplicate iff it wrapped into [0, origin) */
        return !(to_rank >= 0 && to_rank < origin);
    }
    /* my_rank < origin: safe only inside (my_rank, origin) */
    return !(my_rank < to_rank && to_rank < origin);
}

int rlo_fwd_targets(int world_size, int rank, int origin, int from_rank,
                    int *out, int cap)
{
    if (rlo_level(world_size, rank) == 0)
        return 0;
    int list[64];
    int chan;
    int len = rlo_send_list(world_size, rank, list, 64, &chan);
    if (len < 0)
        return len;
    int n = 0;
    if (from_rank > rlo_last_wall(world_size, rank)) {
        /* full fan-out, furthest-first */
        for (int j = len - 1; j >= 0; j--) {
            if (n >= cap)
                return RLO_ERR_ARG;
            out[n++] = list[j];
        }
        return n;
    }
    for (int j = chan - 1; j >= 0; j--) {
        if (!rlo_check_passed_origin(world_size, rank, origin, list[j])) {
            if (n >= cap)
                return RLO_ERR_ARG;
            out[n++] = list[j];
        }
    }
    return n;
}

int rlo_fwd_send_cnt(int world_size, int rank, int origin, int from_rank)
{
    int tmp[64];
    return rlo_fwd_targets(world_size, rank, origin, from_rank, tmp, 64);
}

int rlo_initiator_targets(int world_size, int rank, int *out, int cap)
{
    int list[64];
    int len = rlo_send_list(world_size, rank, list, 64, 0);
    if (len < 0)
        return len;
    if (len > cap)
        return RLO_ERR_ARG;
    for (int j = 0; j < len; j++)
        out[j] = list[len - 1 - j]; /* furthest-first */
    return len;
}

uint64_t rlo_now_usec(void)
{
    struct timeval tv;
    gettimeofday(&tv, 0);
    return (uint64_t)tv.tv_sec * 1000000u + (uint64_t)tv.tv_usec;
}
