"""``chip_smoke.py``'s profiled windows on the CPU, with a stub profiler:
a window idles inside its edges, one that records no CUDA kernel is
taken again with a longer idle, three empty takes fail, and the
pair-write gate
(``_one_launch``) takes its launch count from the wrapper's own counter
and fails on any kernel other than the write kernel (a copy of its
source) or on no launch; K6/K9's device-time window (``_attend_device_ms``)
is also their one-launch gate. The windows' real behaviour on the card
is ``chip_smoke.py``'s own run."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

CUDA = torch.autograd.DeviceType.CUDA
WRITE = "void write_page_row_kernel<unsigned short>(PageRowWrite)"


def _evt(key, count=1, us=2.0, device_type=CUDA):
    return SimpleNamespace(key=key, count=count, device_time_total=us,
                           device_type=device_type)


@pytest.fixture
def stub(monkeypatch):
    """A profiler whose windows record, in turn, the event lists of
    ``stub.windows`` (the last one repeats); ``stub.log`` records the
    synchronises, pauses and windows in their order."""
    state = SimpleNamespace(windows=[[]], log=[], calls=0, opened=0)

    class Profile:
        def __init__(self, activities):
            self.events = state.windows[min(state.opened,
                                            len(state.windows) - 1)]
            state.opened += 1

        def __enter__(self):
            state.log.append("window")
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: state.log.append("sync"))
    monkeypatch.setattr(cs.time, "sleep",
                        lambda s: state.log.append(("idle", s)))
    monkeypatch.setattr(cs, "windows", {"taken": 0, "empty": 0})
    return state


def _call(state):
    def fn():
        state.calls += 1
    return fn


def test_empty_windows_are_taken_again(stub):
    stub.windows = [[], [_evt("Memcpy HtoD", device_type=None)],
                    [_evt(WRITE, 3, 6.0), _evt("aten::copy_", 1, 0.0,
                                               torch.autograd.DeviceType.CPU)]]
    ran = cs.profiled(_call(stub), reps=3)
    assert ran == {WRITE: (3, 6.0)}
    assert cs.windows == {"taken": 3, "empty": 2}
    assert stub.calls == 9          # each take runs all its calls
    # each take: a synchronise, then inside the window an idle, the
    # calls, a synchronise and an idle ten times the last take's
    take = ["sync", "window", ("idle", cs.WINDOW_IDLE_S), "sync",
            ("idle", cs.WINDOW_IDLE_S)]
    assert stub.log[:5] == take
    assert stub.log[-5:] == ["sync", "window",
                             ("idle", cs.WINDOW_IDLE_S * 100), "sync",
                             ("idle", cs.WINDOW_IDLE_S * 100)]


def test_three_empty_windows_fail(stub):
    stub.windows = [[]]
    with pytest.raises(RuntimeError, match="no CUDA kernel in 3 windows"):
        cs.profiled(_call(stub))
    assert cs.windows == {"taken": 3, "empty": 3}
    assert cs.WINDOW_TAKES == 3


def test_a_partial_window_is_not_taken_again(stub):
    """Only a window that records nothing is taken again: one over 50
    calls that records 49 kernels stands (the idle inside its edges is
    what keeps records whole)."""
    stub.windows = [[_evt(WRITE, 49, 98.0)], [_evt(WRITE, 50, 100.0)]]
    assert cs.profiled(_call(stub), 50) == {WRITE: (49, 98.0)}
    assert cs.windows == {"taken": 1, "empty": 0}


def test_windows_line_reports_and_resets(stub, capsys):
    stub.windows = [[], [_evt(WRITE)]]
    cs.profiled(_call(stub))
    cs.windows_line("k10/k11")
    assert "[k10/k11] profiler windows: 2, of which 1 recorded no kernel " \
           "and were taken again" in capsys.readouterr().out
    assert cs.windows == {"taken": 0, "empty": 0}


def test_device_ms_sums_kernels_over_the_calls(stub):
    stub.windows = [[], [_evt(WRITE, 50, 80.0), _evt("Memcpy DtoD", 50,
                                                     20.0)]]
    assert cs.device_ms(_call(stub), 50) == pytest.approx(100.0 / 50 / 1e3)
    assert stub.calls == 1 + 50 + 50    # a warm-up call, then two takes


def _counted(launches_per_call):
    def path():
        path.counted.launches += launches_per_call
    path.counted = SimpleNamespace(launches=0)
    return path


def test_one_launch_passes_for_the_write_kernel_alone(stub):
    stub.windows = [[], [_evt(WRITE)]]          # a dropped record: retaken
    path = _counted(1)
    cs._one_launch(path, path.counted, "write_page_row_kernel", "K10")
    assert cs.windows == {"taken": 2, "empty": 1}


def test_one_launch_fails_on_a_foreign_kernel(stub):
    stub.windows = [[_evt(WRITE), _evt("void at::native::elementwise_"
                                       "kernel<128, 4>(copy)")]]
    path = _counted(1)
    with pytest.raises(RuntimeError, match="not write_page_row_kernel "
                                           "alone"):
        cs._one_launch(path, path.counted, "write_page_row_kernel", "K10")


@pytest.mark.parametrize("launches", [0, 2])
def test_one_launch_counts_launches_on_the_host(stub, launches):
    """The count comes from the wrapper's counter, not the profiler: a
    window that shows one kernel does not pass two launches or none."""
    stub.windows = [[_evt(WRITE)]]
    path = _counted(launches)
    with pytest.raises(RuntimeError, match=f"took {launches} launches"):
        cs._one_launch(path, path.counted, "write_page_row_kernel", "K10")


def test_one_launch_fails_when_nothing_is_recorded(stub):
    stub.windows = [[]]
    path = _counted(1)
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        cs._one_launch(path, path.counted, "write_page_row_kernel", "K10")


K6 = "void (anonymous namespace)::decode_kernel<__nv_bfloat16, 64, 1, false, true>(DecodeArgs)"
K9 = "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, 64, 1, true, true>(DecodeArgs)"


@pytest.mark.parametrize("paged", [False, True])
def test_attend_device_ms_is_the_one_launch_gate(stub, paged):
    """K6/K9's device time comes from a window whose 50 calls are 50
    launches of the kernel on the host counter and on the card."""
    stub.windows = [[], [_evt(K9 if paged else K6, 50, 100.0)]]
    path = _counted(1)
    assert cs._attend_device_ms(path, path.counted, paged, "K") == \
        pytest.approx(100.0 / 50 / 1e3)
    assert path.counted.launches == 1 + 50 + 50     # warm-up, two takes
    assert cs.windows == {"taken": 2, "empty": 1}


@pytest.mark.parametrize("window,match", [
    ([_evt(K6, 50), _evt("void at::native::elementwise_kernel<128, 4>("
                         "copy)", 50)], "not 50 launches"),
    ([_evt(K6, 49)], "not 50 launches"),
    ([_evt(K9, 50)], "not 50 launches"),
])
def test_attend_device_ms_fails_on_other_kernels_or_counts(stub, window,
                                                           match):
    """A copy of q, a missing or extra launch, or the other kernel (K9
    where K6 was called) fails the gate."""
    stub.windows = [window]
    path = _counted(1)
    with pytest.raises(RuntimeError, match=match):
        cs._attend_device_ms(path, path.counted, False, "K6")


def test_attend_device_ms_takes_a_short_window_again(stub):
    """A window that shows fewer launches of the kernel and nothing else
    lost records: it is taken again, and the next full window gives the
    time; short windows only fail after ``WINDOW_TAKES`` takes."""
    stub.windows = [[_evt(K6, 49, 98.0)], [_evt(K6, 50, 100.0)]]
    path = _counted(1)
    assert cs._attend_device_ms(path, path.counted, False, "K6") == \
        pytest.approx(100.0 / 50 / 1e3)
    assert path.counted.launches == 1 + 50 + 50
    stub.windows = [[_evt(K6, 49)]]
    stub.opened = 0
    with pytest.raises(RuntimeError, match=f"in {cs.WINDOW_TAKES} windows"):
        cs._attend_device_ms(path, path.counted, False, "K6")


@pytest.mark.parametrize("launches", [0, 2])
def test_attend_device_ms_counts_launches_on_the_host(stub, launches):
    stub.windows = [[_evt(K6, 50)]]
    path = _counted(launches)
    with pytest.raises(RuntimeError, match=f"took {50 * launches} "
                                           f"launches"):
        cs._attend_device_ms(path, path.counted, False, "K6")


def _picks(rows):
    """One recorded verify call: (picks, gaps) as numpy."""
    picks, gaps = rows
    return np.array(picks), np.array(gaps, dtype=np.float32)


def test_partings_replays_greedy_acceptance():
    """Phase 11's self-draft gate: a rejection of a row still short of
    max_new counts, with the verify's gap at the first rejected
    proposal; the last proposal's mismatch and a finished row's do not."""
    gamma, max_new = 3, 5
    # round 0: row 0's only mismatch is its last proposal (4 tokens
    # out), row 1 rejects at proposal 1 (3 out); round 1: row 0 rejects
    # at proposal 0, row 1 again mismatches only its last proposal
    draft = [([1, 4], None), ([2, 5], None), ([3, 6], None),
             ([1, 8], None), ([1, 8], None), ([1, 8], None)]
    verify = [([[1, 2, 9], [4, 7, 6]], [[.5, .5, .5], [.5, .004, .5]]),
              ([[2, 1, 1], [8, 8, 0]], [[.007, .5, .5], [.5, .5, .5]])]
    rec = {"draft": [(np.asarray(p), np.zeros(2)) for p, _ in draft],
           "verify": [_picks(v) for v in verify]}
    got = cs._partings(rec, gamma, max_new)
    assert [(r, row) for r, row, _ in got] == [(0, 1), (1, 0)]
    assert [g for _, _, g in got] == pytest.approx([0.004, 0.007])
    # with max_new 4 row 0 is done after round 0: its round-1 rejection
    # no longer counts
    assert [(r, row) for r, row, _ in cs._partings(rec, gamma, 4)] == \
        [(0, 1)]
