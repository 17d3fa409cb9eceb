"""The bytes a schedule really hands to its ``Axis``.

The port's counterpart of ``rlo_tpu/utils/hlo.py``. The JAX package
pins its cost models (``allreduce_cost``, ``hierarchical_allreduce_cost``,
``all_to_all_cost``) to the collective operands it reads out of the
lowered StableHLO text; the port has no lowered program, so it records
what a per-rank function passes to its axis instead:

    rec = RecordingAxis(axis)          # any Axis: LocalAxis, DistAxis
    out = allreduce(x, rec, algorithm="ring", pipeline_chunks=1)
    total, n = permute_total_bytes(rec, require=True)

``RecordingAxis`` forwards every call unchanged (the result is the
wrapped axis's, bit for bit) and appends one record per call. The three
readers return what ``hlo.py``'s do, with the same ``require`` guard:
a caller that knows the collective ran gets an error, not a silent 0,
when nothing was recorded (a schedule that bypassed the wrapper).
Unlike the HLO text, the record holds every executed call, so a loop's
steps are all counted (the HLO text shows a rolled loop's body once).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

#: hlo.py's dtype names, so records compare with the JAX package's
_DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64",
                torch.bfloat16: "bf16", torch.int32: "i32",
                torch.int8: "i8"}


def _dtype_name(x: torch.Tensor) -> str:
    return _DTYPE_NAMES.get(x.dtype, str(x.dtype).replace("torch.", ""))


class RecordingAxis:
    """An ``Axis`` that forwards to ``axis`` and records each call.

    ``permutes``: (pairs, nbytes, dtype) per ``ppermute``;
    ``all_gathers``, ``all_to_alls``: (elems, dtype) of each operand;
    ``all_reduces``: (elems, dtype, op)."""

    def __init__(self, axis):
        self.axis = axis
        self.permutes: List[Tuple[Tuple[Tuple[int, int], ...], int,
                                  str]] = []
        self.all_gathers: List[Tuple[int, str]] = []
        self.all_to_alls: List[Tuple[int, str]] = []
        self.all_reduces: List[Tuple[int, str, str]] = []

    @property
    def size(self) -> int:
        return self.axis.size

    @property
    def index(self) -> int:
        return self.axis.index

    @property
    def device(self):
        return self.axis.device

    @property
    def leader(self) -> bool:
        return self.axis.leader

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        self.permutes.append((tuple((int(s), int(d)) for s, d in pairs),
                              x.numel() * x.element_size(),
                              _dtype_name(x)))
        return self.axis.ppermute(x, pairs)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self.all_gathers.append((x.numel(), _dtype_name(x)))
        return self.axis.all_gather(x)

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        self.all_reduces.append((x.numel(), _dtype_name(x), op))
        return self.axis.all_reduce(x, op)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self.all_to_alls.append((x.numel(), _dtype_name(x)))
        return self.axis.all_to_all(x)

    def barrier(self) -> None:
        return self.axis.barrier()


def _check_matched(n: int, what: str, require: bool) -> None:
    """The byte-pinning guard: a caller that knows the collective ran
    and finds no record fails loudly (hlo.py's ``_check_matched``)."""
    if require and n == 0:
        raise ValueError(
            f"no {what} calls were recorded, but the caller asserts the "
            f"collective ran — the schedule bypassed the RecordingAxis")


def permute_total_bytes(rec: RecordingAxis, require: bool = False):
    """Total ``ppermute`` operand bytes and the number of calls."""
    total = sum(nbytes for _pairs, nbytes, _dt in rec.permutes)
    _check_matched(len(rec.permutes), "ppermute", require)
    return total, len(rec.permutes)


def permute_entries(rec: RecordingAxis, require: bool = False
                    ) -> List[Tuple[int, int, int]]:
    """(src, dst, nbytes) of the first pair of every ``ppermute`` —
    enough to classify ring direction or shift offset."""
    out = [(pairs[0][0], pairs[0][1], nbytes)
           for pairs, nbytes, _dt in rec.permutes if pairs]
    _check_matched(len(out), "ppermute", require)
    return out


def all_gather_operands(rec: RecordingAxis, require: bool = False
                        ) -> List[Tuple[int, str]]:
    """(elems, dtype) of every ``all_gather`` operand."""
    out = list(rec.all_gathers)
    _check_matched(len(out), "all_gather", require)
    return out


def recording_axes(axes: dict, names: Sequence[str]) -> dict:
    """``axes`` with each axis in ``names`` wrapped (a LocalMesh rank's
    axis dict, say)."""
    return {k: RecordingAxis(v) if k in names else v
            for k, v in axes.items()}
