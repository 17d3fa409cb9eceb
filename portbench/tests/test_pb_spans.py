"""The readers of the program's span timing and build counter on a
hand-made run context: the phases of a traced step from
``DEVICE_SPANS``' paths, the device operations from the trace, nvcc's
seconds from ``build_stats``, and None where there is nothing to read
(no trace, a program that keeps no such record, or a record that holds
more steps than the trace)."""

import pytest

from portbench import common, spans
from rlo_tpu_torch.kernels import build
from rlo_tpu_torch.utils import tracing

STEP = "pb.train_step/rlo.train.step"
FWD, BWD = f"{STEP}/rlo.train.forward", f"{STEP}/rlo.train.backward"
#: autograd's device thread runs the recompute: a path of its own
REC = "rlo.train.recompute"
#: two traced steps of a model of two layers, seconds and ranges by path
TOTALS = {"pb.train_step": (3.0, 2), STEP: (2.9, 2), FWD: (0.6, 2),
          f"{FWD}/rlo.layer.attention": (0.2, 4),
          f"{FWD}/rlo.layer.ffn": (0.3, 4),
          f"{FWD}/rlo.train.head": (0.1, 2),
          BWD: (2.0, 2), REC: (0.5, 4),
          f"{REC}/rlo.layer.attention": (0.2, 4),
          f"{REC}/rlo.layer.ffn": (0.3, 4),
          f"{STEP}/rlo.train.optimizer": (0.25, 2)}
NEW = ("train.forward_ms", "train.recompute_ms", "train.backward_ms",
       "train.optimizer_ms", "train.device_ops")


class _Spans:
    def __init__(self, totals):
        self._t = totals

    def totals(self):
        return dict(self._t)


def _ctx(trace=True):
    tr = {"steps": 2, "ops": {"nvjet_gemm": (1.0, 400),
                              "elementwise_kernel": (0.5, 3000),
                              "Memcpy DtoD": (0.2, 1200)}}
    return {"kind": "train", "trace": tr if trace else None}


def _read(name, ctx):
    return common.metric_reader(name)(ctx)


def test_step_phases_from_span_paths(monkeypatch):
    monkeypatch.setattr(tracing, "DEVICE_SPANS", _Spans(TOTALS))
    ctx = _ctx()
    assert _read("train.forward_ms", ctx) == pytest.approx(300.0)
    assert _read("train.recompute_ms", ctx) == pytest.approx(250.0)
    assert _read("train.backward_ms", ctx) == pytest.approx(750.0)
    assert _read("train.optimizer_ms", ctx) == pytest.approx(125.0)
    assert _read("train.device_ops", ctx) == 2300.0
    tot = spans.totals(ctx)
    assert spans.seconds(tot, "rlo.layer.ffn") == pytest.approx(0.6)
    assert spans.ranges(tot, "rlo.layer.ffn") == 8


def test_span_readers_read_nothing_without_a_trace_or_a_record(
        monkeypatch):
    monkeypatch.setattr(tracing, "DEVICE_SPANS", _Spans(TOTALS))
    for name in NEW:
        assert _read(name, _ctx(trace=False)) is None, name
    # a span the run never opened reads nothing, not 0
    monkeypatch.setattr(tracing, "DEVICE_SPANS", _Spans(
        {k: v for k, v in TOTALS.items() if "recompute" not in k}))
    assert _read("train.recompute_ms", _ctx()) is None
    assert _read("train.backward_ms", _ctx()) == pytest.approx(1000.0)
    monkeypatch.setattr(tracing, "DEVICE_SPANS", _Spans({}))
    assert _read("train.forward_ms", _ctx()) is None
    # another profile in the process added its steps: not the trace's
    monkeypatch.setattr(tracing, "DEVICE_SPANS", _Spans(
        {**TOTALS, "rlo.train.step": (2.9, 2)}))
    for name in NEW[:4]:
        assert _read(name, _ctx()) is None, name
    # a program without the span timing (the parent's) reads nothing
    monkeypatch.delattr(tracing, "DEVICE_SPANS")
    for name in NEW[:4]:
        assert _read(name, _ctx()) is None, name


def test_build_seconds_from_the_program_counter(monkeypatch):
    monkeypatch.setattr(build, "_stats", {
        "flash": {"builds": 1, "nvcc_s": 21.5, "loads": 1},
        "reduce": {"builds": 0, "nvcc_s": 0.0, "loads": 1}})
    assert _read("setup.build_s", _ctx()) == 21.5
    monkeypatch.setattr(build, "_stats", {})
    assert _read("setup.build_s", _ctx()) == 0
    monkeypatch.delattr(build, "build_stats")
    assert _read("setup.build_s", _ctx()) is None
