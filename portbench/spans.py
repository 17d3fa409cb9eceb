"""The stream time of the program's own spans, by path, per traced step.

The port times each ``utils.tracing.annotate`` range closed while a
profiler records, with a CUDA event at each end, and files it under its
path (the names of the ranges its thread holds open, outermost first):
``rlo_tpu_torch.utils.tracing.DEVICE_SPANS``. A span's time is its
stream's between the two events, the device's idle gaps inside it
included. Those totals are the process's; they are the traced steps'
only where they hold as many ``rlo.train.step`` ranges as the trace has
steps, and everything here is None otherwise, and where the run took
no trace or the program keeps no such record.
"""

from __future__ import annotations

STEP = "rlo.train.step"


def totals(ctx) -> dict:
    """{path: (stream seconds, ranges)} of the traced steps, or None."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    from rlo_tpu_torch.utils import tracing
    spans = getattr(tracing, "DEVICE_SPANS", None)
    tot = spans.totals() if spans is not None else None
    if not tot or ranges(tot, STEP) != tr["steps"]:
        return None
    return tot


def _named(path: str, name: str) -> bool:
    return path.rsplit("/", 1)[-1] == name


def seconds(tot: dict, name: str) -> float:
    """Stream seconds of the ranges named ``name``, on any path."""
    return sum(secs for path, (secs, _) in tot.items() if _named(path, name))


def ranges(tot: dict, name: str) -> int:
    return sum(n for path, (_, n) in tot.items() if _named(path, name))


def ms_per_step(ctx, name: str, less: str = None) -> float:
    """Stream milliseconds a traced step under the ranges named
    ``name``, less those of the ranges named ``less`` (which run inside
    them, on this or another thread); None where no range is named
    ``name``."""
    tot = totals(ctx)
    if tot is None or not ranges(tot, name):
        return None
    secs = seconds(tot, name)
    if less is not None:
        secs -= seconds(tot, less)
    return 1e3 * secs / ctx["trace"]["steps"]
