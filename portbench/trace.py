"""The device trace of a sub-window, reduced to what the readers need.

``Trace`` wraps ``torch.profiler`` (CPU and CUDA activity). ``stop()``
returns the union of device operation intervals (``busy_s``), the
traced wall time (``window_s``), device seconds and operation counts by
kernel name, the device time by group (the port's kernels by their CUDA
function names, the cuBLAS/CUTLASS products by theirs, as
``rlo_tpu_torch/tools/profile_train.py`` groups them), and the idle gaps
summed by the harness annotation (``pb.*``) open on the host over each
gap's middle.
"""

from __future__ import annotations

import bisect
import time

#: (group, name fragments), first match wins
GROUPS = (("K9 paged decode attention", ("paged_decode_kernel",)),
          ("K6 decode attention", ("decode_kernel",)),
          ("K7/K10 row write", ("write_row_kernel",)),
          ("K8/K11 block write", ("write_block_kernel",)),
          ("decode split combine", ("combine_",)),
          ("K2 flash forward", ("flash_fwd_",)),
          ("K3 tie counts", ("flash_rowstats_",)),
          ("K4 flash dq", ("flash_bwd_dq_",)),
          ("K5 flash dk/dv", ("flash_bwd_dkv_",)),
          ("matrix products", ("gemm", "cutlass", "sm90_xmma", "nvjet",
                               "cublas")),
          ("AdamW", ("adam",)),
          ("copies", ("memcpy", "memset", "copy")))


#: the activity kinds that are work on the device
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


#: the names CUPTI gives its synchronisation records, which some
#: PyTorch versions hand over as device events without their kind
SYNC_NAMES = ("Event Sync", "Stream Sync", "Context Sync",
              "Stream Wait Event", "Unknown Sync")


def _kind(e) -> str:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if name in SYNC_NAMES or name.endswith(" Sync"):
        return "cuda_sync"
    # a host annotation's range, mirrored on the device's timeline
    if name.startswith("pb.") or (hasattr(e, "is_user_annotation")
                                  and e.is_user_annotation()):
        return "gpu_user_annotation"
    return "kernel"


def group(name: str) -> str:
    low = name.lower()
    for label, frags in GROUPS:
        if any(f in low for f in frags):
            return label
    return "other"


def kernel_seconds(trace: dict, fragment: str, exclude: str = "") -> float:
    """Device seconds of the traced operations whose name holds
    ``fragment`` (and not ``exclude``)."""
    return sum(s for name, (s, _) in trace["ops"].items()
               if fragment in name and not (exclude and exclude in name))


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        torch = self._torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        dev, notes = [], []
        ops, skipped = {}, {}
        for e in self._prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                kind = _kind(e)
                if kind not in DEVICE_OPS:
                    # synchronisations and the like: waits, not work
                    skipped[kind] = skipped.get(kind, 0.0) + d * 1e-9
                    continue
                if d <= 0:
                    continue
                dev.append((s, s + d))
                secs, n = ops.get(e.name(), (0.0, 0))
                ops[e.name()] = (secs + d * 1e-9, n + 1)
            elif e.name().startswith("pb."):
                notes.append((s, s + d, e.name()))
        if not dev:
            raise RuntimeError("the profiler recorded no device time")
        busy = _union(dev)
        busy_s = sum(e - s for s, e in busy) * 1e-9
        groups = {}
        for name, (secs, _) in ops.items():
            g = group(name)
            groups[g] = groups.get(g, 0.0) + secs
        # idle gaps between device operations, named by the innermost
        # harness annotation open on the host at each gap's middle
        notes.sort()
        starts = [n[0] for n in notes]
        idle = {}
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = (e0 + s1) / 2
            name = "no annotation"
            i = bisect.bisect_right(starts, mid)
            best = None
            for s, e, nm in notes[:i]:
                if s <= mid <= e and (best is None or s >= best[0]):
                    best = (s, nm)
            if best is not None:
                name = best[1]
            idle[name] = idle.get(name, 0.0) + (s1 - e0) * 1e-9
        return {"busy_s": busy_s, "window_s": wall, "ops": ops,
                "groups": groups, "idle": idle, "skipped": skipped}


def top_ops(trace: dict, n: int = 15) -> list:
    """The ``n`` device operations by time: (name, seconds, count)."""
    return [(k[:120], v[0], v[1]) for k, v in
            sorted(trace["ops"].items(), key=lambda kv: -kv[1][0])[:n]]


def breakdown(trace: dict) -> dict:
    top = sorted(trace["groups"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
