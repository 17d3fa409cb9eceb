/* femtompirun — the `mpirun -n N prog` launcher for femtompi.
 *
 * Creates the shared-memory segment (header + ws*ws SPSC rings), forks
 * N children with FEMTOMPI_SHM/FEMTOMPI_RANK/FEMTOMPI_SIZE set, execs
 * the program, and reaps: exit status 0 iff every rank exited 0. A
 * wall-clock timeout (default 300 s) kills the whole job — a hung rank
 * must fail the run, not wedge CI (the reference's `mpirun -n N ./demo`
 * has the same job-level contract, SURVEY.md §4).
 *
 * Usage: femtompirun [-n ranks] [-r ring_bytes] [-t timeout_s]
 *                    prog [args...]
 */
#define _GNU_SOURCE
#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/time.h>
#include <sys/wait.h>
#include <unistd.h>

#define FMPI_MAGIC 0xf3a90de5u

typedef struct fmpi_hdr { /* must match femtompi.c */
    uint32_t magic;
    int32_t ws;
    uint64_t ring_bytes;
    uint64_t slot_size;
    int abort_flag; /* _Atomic int in femtompi.c; layout-compatible */
} fmpi_hdr;

static uint64_t now_usec(void)
{
    struct timeval tv;
    gettimeofday(&tv, 0);
    return (uint64_t)tv.tv_sec * 1000000ull + (uint64_t)tv.tv_usec;
}

int main(int argc, char **argv)
{
    int ws = 2;
    uint64_t ring_bytes = 4ull << 20;
    int timeout_s = 300;
    int i = 1;
    for (; i < argc; i++) {
        if (!strcmp(argv[i], "-n") && i + 1 < argc)
            ws = atoi(argv[++i]);
        else if (!strcmp(argv[i], "-r") && i + 1 < argc)
            ring_bytes = strtoull(argv[++i], 0, 0);
        else if (!strcmp(argv[i], "-t") && i + 1 < argc)
            timeout_s = atoi(argv[++i]);
        else
            break;
    }
    if (i >= argc || ws < 2 || ws > 64 || ring_bytes < 4096) {
        fprintf(stderr,
                "usage: %s [-n ranks(2-64)] [-r ring_bytes] "
                "[-t timeout_s] prog [args...]\n",
                argv[0]);
        return 2;
    }

    char name[64];
    snprintf(name, sizeof name, "/fmpi.%d", (int)getpid());
    int fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0600);
    if (fd < 0) {
        perror("shm_open");
        return 1;
    }
    uint64_t ring_sz = sizeof(uint64_t) * 2 /* head+tail */ + ring_bytes;
    uint64_t slot = (ring_sz + 63) & ~63ull;
    uint64_t total = sizeof(fmpi_hdr) + slot * (uint64_t)ws * (uint64_t)ws;
    total = (total + 4095) & ~4095ull;
    if (ftruncate(fd, (off_t)total) != 0) {
        perror("ftruncate");
        shm_unlink(name);
        return 1;
    }
    fmpi_hdr *hdr = (fmpi_hdr *)mmap(0, sizeof(fmpi_hdr),
                                     PROT_READ | PROT_WRITE, MAP_SHARED,
                                     fd, 0);
    close(fd);
    if (hdr == MAP_FAILED) {
        perror("mmap");
        shm_unlink(name);
        return 1;
    }
    hdr->ws = ws;
    hdr->ring_bytes = ring_bytes;
    hdr->slot_size = slot;
    hdr->abort_flag = 0;
    hdr->magic = FMPI_MAGIC; /* last: children validate it */

    pid_t *pids = (pid_t *)calloc((size_t)ws, sizeof(pid_t));
    char envbuf[32];
    for (int r = 0; r < ws; r++) {
        pid_t pid = fork();
        if (pid < 0) {
            perror("fork");
            for (int k = 0; k < r; k++)
                kill(pids[k], SIGKILL);
            shm_unlink(name);
            return 1;
        }
        if (pid == 0) {
            setenv("FEMTOMPI_SHM", name, 1);
            snprintf(envbuf, sizeof envbuf, "%d", r);
            setenv("FEMTOMPI_RANK", envbuf, 1);
            snprintf(envbuf, sizeof envbuf, "%d", ws);
            setenv("FEMTOMPI_SIZE", envbuf, 1);
            execvp(argv[i], &argv[i]);
            perror("execvp");
            _exit(127);
        }
        pids[r] = pid;
    }

    uint64_t deadline = now_usec() + (uint64_t)timeout_s * 1000000ull;
    int live = ws, failures = 0;
    while (live > 0) {
        int st = 0;
        pid_t got = waitpid(-1, &st, WNOHANG);
        if (got > 0) {
            live--;
            /* forget reaped pids: the OS may recycle them, and a later
             * kill sweep must never signal an unrelated process */
            for (int r = 0; r < ws; r++)
                if (pids[r] == got)
                    pids[r] = 0;
            int bad = !WIFEXITED(st) || WEXITSTATUS(st) != 0;
            if (bad) {
                failures++;
                /* one rank failed: the job is lost; kill the rest so
                 * the run terminates promptly */
                for (int r = 0; r < ws; r++)
                    if (pids[r] > 0)
                        kill(pids[r], SIGKILL);
            }
            continue;
        }
        if (now_usec() > deadline) {
            fprintf(stderr, "femtompirun: timeout after %d s, killing\n",
                    timeout_s);
            for (int r = 0; r < ws; r++)
                if (pids[r] > 0)
                    kill(pids[r], SIGKILL);
            failures++;
            deadline = (uint64_t)-1; /* kill once, then reap */
        }
        usleep(2000);
    }
    shm_unlink(name);
    free(pids);
    return failures ? 1 : 0;
}
