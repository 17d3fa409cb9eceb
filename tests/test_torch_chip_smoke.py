"""``chip_smoke.py``'s profiled windows on the CPU, with a stub profiler:
a window opens with its opener kernel and idles inside its edges, one
that records no CUDA kernel but the opener is
taken again with a longer idle, three empty takes fail, and the
pair-write gate
(``_one_launch``) takes its launch count from the wrapper's own counter
and fails on any kernel other than the write kernel (a copy of its
source) or on no launch; K6/K9's device-time window (``_attend_device_ms``)
is also their one-launch gate; phase 14 (pipeline training) runs at a
tiny size with the plain versions counting the launches, and so do
phases 15-19 (phase 18: the host facades and their process workers on
CPU tensors; phase 19: the developer tools, after phase 17's dense fleet
with span recorders). The windows' real behaviour on the card is
``chip_smoke.py``'s own run."""

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
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: state.log.append("open"))
    monkeypatch.setattr(cs, "windows", {"taken": 0, "empty": 0})
    monkeypatch.setattr(cs, "openers", {"lost": 0})
    return state


def _call(state):
    def fn():
        state.calls += 1
    return fn


def test_empty_windows_are_taken_again(stub):
    """A window whose only kernel is its opener recorded none of the
    calls' kernels: it is empty too."""
    stub.windows = [[_evt("void at::cuda::(anonymous namespace)::"
                          "spin_kernel(long)")],
                    [_evt("Memcpy HtoD", device_type=None)],
                    [_evt(WRITE, 3, 6.0), _evt("aten::copy_", 1, 0.0,
                                               torch.autograd.DeviceType.CPU)]]
    ran = cs.profiled(_call(stub), reps=3)
    assert ran == {WRITE: (3, 6.0)}
    assert cs.windows == {"taken": 3, "empty": 2}
    assert stub.calls == 9          # each take runs all its calls
    # each take: a synchronise, then inside the window the openers and a
    # synchronise, an idle, the calls, a synchronise and an idle ten
    # times the last take's
    opened = ["sync", "window"] + ["open"] * cs.WINDOW_OPENERS + ["sync"]
    n = len(opened) + 3
    assert stub.log[:n] == opened + [("idle", cs.WINDOW_IDLE_S), "sync",
                                     ("idle", cs.WINDOW_IDLE_S)]
    assert stub.log[-n:] == opened + [("idle", cs.WINDOW_IDLE_S * 100),
                                      "sync", ("idle", cs.WINDOW_IDLE_S * 100)]


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
    """The line counts the windows, the empty ones and the most opener
    launches a window did not record."""
    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    stub.windows = [[_evt(spin, cs.WINDOW_OPENERS - 5)],
                    [_evt(spin, cs.WINDOW_OPENERS), _evt(WRITE)]]
    cs.profiled(_call(stub))
    cs.windows_line("k10/k11")
    assert "[k10/k11] profiler windows: 2, of which 1 recorded no kernel " \
           f"and were taken again; at most 5 of a window's " \
           f"{cs.WINDOW_OPENERS} opener launches went unrecorded" in \
           capsys.readouterr().out
    assert cs.windows == {"taken": 0, "empty": 0}
    assert cs.openers == {"lost": 0}


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


def test_spread_places_a_window_s_launches(monkeypatch):
    """A short window prints where its recorded launches lie: the first
    start, the last end, and the largest gap between launches (a lost
    record in the middle shows as a gap twice the median)."""
    def kernel(start, end, key=K6):
        return SimpleNamespace(key=key, device_type=CUDA,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))
    ev = [kernel(5000.0 + 66 * i, 5060.0 + 66 * i) for i in range(6)
          if i != 3] + [kernel(1.0, 2.0, "Memcpy DtoD")]
    monkeypatch.setitem(cs.last_window, "prof",
                        SimpleNamespace(events=lambda: ev))
    monkeypatch.setitem(cs.last_window, "host_us", 10500.0)
    monkeypatch.setitem(cs.last_window, "idle_us", 5000.0)
    monkeypatch.setitem(cs.last_window, "openers_lost", 3)
    assert cs._spread(lambda k: k == K6) == (
        f"3 of {cs.WINDOW_OPENERS} openers unrecorded; "
        "recorded launches from 5000 to 5390 us into a 10500 us window "
        "with 5000 us idle edges; gaps between launches median 66.0 us, "
        "largest 132.0 us after launch 2")
    monkeypatch.setitem(cs.last_window, "prof", object())
    assert cs._spread(lambda k: True) == "no event times"


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


def _routes(b=4, ranks=2, n=3, layers=2, plen=2, seed=0):
    """One-rank router records for ``routes_against`` (gates of a
    prefill call per layer, then each decode step's per layer) with a
    clear top-2 gap at every token, and each rank's records of its rows
    one 1e-4 logit off; edits go through the returned logits."""
    g = torch.Generator().manual_seed(seed)
    want = []
    for k in range(layers * n):
        t = b * plen if k < layers else b
        want.append(torch.randn(t, 3, generator=g) +
                    torch.tensor([3.0, 0.0, -3.0])[torch.randperm(3,
                                                                  generator=g)])
    rows = b // ranks

    def mine(r):
        out = []
        for k, lw in enumerate(want):
            span = plen if k < layers else 1
            out.append(lw[r * rows * span:(r + 1) * rows * span] + 1e-4)
        return out
    return want, [mine(r) for r in range(ranks)]


def _gates(calls):
    return [torch.softmax(c, dim=-1) for c in calls]


def test_rel_l2_and_partings_by_gap():
    """Phase 13's comparisons: the relative L2 of two tensors, and each
    EP row's first parting with the reference's logit gap there and the
    first routing difference before it (``routes_against``)."""
    w = torch.tensor([[3.0, 4.0]])
    assert cs.rel_l2(w + torch.tensor([[0.0, 0.5]]), w) == pytest.approx(0.1)
    assert cs.rel_l2(w, w) == 0.0
    want_l, rank_l = _routes()
    want = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [1, 1, 1]])
    gaps = np.full((4, 3), 0.5)
    got = want.copy()
    full, partings, noise = cs.routes_against(
        got, want, gaps, [_gates(c) for c in rank_l], _gates(want_l), 2, 2)
    assert (full, partings) == (4, []) and noise < 1e-3
    # row 1 parts at a logit near-tie; row 2 parts away from one, after a
    # token of its prompt (position 1, layer 1) changed expert at a
    # router near-tie (rank 1's local row 0)
    got[1, 2], gaps[1, 2] = 0, cs.NEAR_TIE / 2
    got[2, 1] = 0
    want_l[1][5] = torch.tensor([1.0, 0.99, -1.0])
    rank_l[1][1][1] = torch.tensor([0.99, 1.0, -1.0])
    full, partings, noise = cs.routes_against(
        got, want, gaps, [_gates(c) for c in rank_l], _gates(want_l), 2, 2)
    assert full == 2 and noise < cs.ROUTER_TOL
    assert partings == [(1, 2, round(cs.NEAR_TIE / 2, 4), None),
                        (2, 1, 0.5, (1, 1, 0.01))]


def test_routes_against_fails_away_from_near_ties():
    """A parting with no routing difference before it and a wide logit
    gap fails, and so do router log-probabilities off by more than
    ROUTER_TOL (a misplaced row) and records of the wrong length."""
    want_l, rank_l = _routes()
    want = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [1, 1, 1]])
    gaps = np.full((4, 3), 0.5)
    got = want.copy()
    got[3, 0] = 0
    with pytest.raises(RuntimeError, match="no routing difference"):
        cs.routes_against(got, want, gaps, [_gates(c) for c in rank_l],
                          _gates(want_l), 2, 2)
    rank_l[0][3][1, 0] += 1.0       # rank 0's row 1, the first decode step
    with pytest.raises(RuntimeError, match="router log-probabilities"):
        cs.routes_against(want, want, gaps, [_gates(c) for c in rank_l],
                          _gates(want_l), 2, 2)
    with pytest.raises(RuntimeError, match="router records"):
        cs.routes_against(want, want, gaps, [_gates(c[:-1]) for c in rank_l],
                          _gates(want_l), 2, 2)


def test_router_log_keeps_each_thread_s_gates():
    """``RouterLog`` keeps the gates of every route call a thread makes
    between its start and take, the tensors themselves, and puts
    ``moe.route`` back when it leaves."""
    import threading
    from rlo_tpu_torch.models import moe
    route = moe.route
    g = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(g, 8, 16, 4)
    h = torch.randn(2, 5, 8, generator=g)
    out = {}
    with cs.RouterLog() as log:
        def rank(i):
            log.start()
            moe.moe_ffn(params, h[i], 4)
            moe.moe_ffn(params, h[i], 4)
            out[i] = log.take()
        threads = [threading.Thread(target=rank, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        moe.moe_ffn(params, h[0], 4)       # no start on this thread
    assert moe.route is route
    for i in (0, 1):
        assert len(out[i]) == 2
        want = moe.route(params["wr"], h[i], 4, 2.0)[0]
        assert torch.equal(out[i][0], want) and torch.equal(out[i][1], want)


def test_tokens_against_holds_rows_by_the_near_tie_rule():
    """A parting at a near-tie ends that row's comparison; one away from
    a near-tie fails, and so do too few rows compared to the end."""
    want = np.array([[1, 2, 3], [4, 5, 6]])
    gaps = np.full((2, 3), 0.5)
    gaps[1, 1] = cs.NEAR_TIE / 2
    got = np.array([[1, 2, 3], [4, 0, 0]])
    assert cs._tokens_against(got, want, gaps, "t", 1) == 1
    with pytest.raises(RuntimeError, match="only 1 of 2 rows"):
        cs._tokens_against(got, want, gaps, "t", 2)
    with pytest.raises(RuntimeError, match="top-2 gap"):
        cs._tokens_against(np.array([[1, 0, 3], [4, 5, 6]]), want, gaps,
                           "t", 1)


def test_mesh_shards_and_on_ranks(stub, monkeypatch):
    """Each rank of phase 13's meshes gets its own slices, and runs with
    grad mode off; ``measured`` runs the path once inside a profiled
    window, counting its launches from 0, and a take the profiler
    recorded nothing of runs it again with the same launches."""
    tree = {"w": torch.arange(8.0).reshape(2, 4)}
    from rlo_tpu_torch.parallel.sharding import PartitionSpec as P
    mesh, shards = cs.mesh_shards("cpu", "tp", 2, tree, {"w": P(None, "tp")})
    assert [s["w"].tolist() for s in shards] == [[[0, 1], [4, 5]],
                                                 [[2, 3], [6, 7]]]
    out = cs.on_ranks(mesh, lambda ax, s: (ax.index, torch.is_grad_enabled(),
                                           s["w"].sum().item()), shards)
    assert out == [(0, False, 10.0), (1, False, 18.0)]

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 2 ** 30)
    counter = SimpleNamespace(__name__="k", launches=5)

    def fn():
        counter.launches += 1
        return counter.launches

    stub.windows = [[_evt("kern", us=3000.0),
                     _evt("Memcpy DtoD (Device -> Device)", us=1000.0)]]
    out, st = cs.measured((counter,), fn)
    assert out == 1 and st["launches"] == {"k": 1}
    assert st["wall_ms"] >= 0
    assert st["device_ms"] == pytest.approx(4.0)
    assert st["dtod_copy_ms"] == pytest.approx(1.0)
    assert st["peak_gib"] == 1.0
    counter.launches = 7
    stub.windows, stub.opened = [[], [_evt("kern", us=3000.0)]], 0
    out, st = cs.measured((counter,), fn)
    assert out == 2 and st["launches"] == {"k": 1}
    assert st["device_ms"] == pytest.approx(3.0)


def test_phase_pipeline_rehearsal(monkeypatch):
    """Phase 14 at a tiny f32 size on the CPU (the launches counted where
    the plain versions stand in for K2, K4 and K5): both schedules hold
    against the single-card step, each rank's ppermute calls and the
    1F1B ring equal pipeline_cost's, the launches per step are GPipe's
    64/64/64 and 1F1B's 112/64/64 (its recompute; the last stage skips
    its forward sub-step), and the resumed run is bit-identical."""
    from rlo_tpu_torch.kernels import flash as kf
    counted = (kf.flash_block_update_hld, kf.bwd_dq, kf.bwd_dkv)
    for plain, wrapper in zip(("flash_block_update_hld_plain",
                               "bwd_dq_plain", "bwd_dkv_plain"), counted):
        def bump(*a, _orig=getattr(kf, plain), _w=wrapper, **kw):
            _w.launches += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(kf, plain, bump)
        monkeypatch.setattr(wrapper, "launches", 0)
    for name, value in (("synchronize", None), ("reset_peak_memory_stats",
                                                None),
                        ("max_memory_allocated", 0),
                        ("memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _v=value: _v)
    monkeypatch.setattr(cs, "SERVE_CFG", dict(
        vocab=64, d_model=32, n_heads=4, n_layers=8, d_ff=64,
        dtype="float32"))
    monkeypatch.setattr(cs, "PIPE", dict(cs.PIPE, batch=8, seq=16, reps=1))
    out = cs.phase_pipeline(torch.device("cpu"), counted)
    names = [f.__name__ for f in counted]
    assert out["gpipe"]["launches_per_step"] == dict.fromkeys(names, 64)
    assert out["1f1b"]["launches_per_step"] == dict(zip(names,
                                                        (112, 64, 64)))
    assert (out["gpipe"]["permutes_per_rank"],
            out["1f1b"]["permutes_per_rank"]) == (22, 28)
    assert (out["gpipe"]["peak_stage_graphs"], out["1f1b"]["ring_slots"]) \
        == (8, 7)
    assert out["resume"]["bit_identical"]
    for k in ("gpipe", "1f1b", "1f1b_vs_gpipe", "dp_gpipe", "dp_1f1b"):
        assert out[k]["loss_rel"] <= 1e-5
        assert out[k]["update_rel_l2_max"] <= 1e-3


def test_phase_bridge_rehearsal(monkeypatch):
    """Phase 15a/c at a tiny size on the CPU, the plain K1 counting its
    launches: the gated rounds approve and equal the ungated calls bit
    for bit, the shape and dtype vetoes launch nothing, the device-judge
    vetoes hold, and the round's engine events equal the CPU's."""
    from rlo_tpu_torch.kernels import reduce as k1

    def bump(*a, _orig=k1.fused_combine_plain, **kw):
        k1.fused_combine.launches += 1
        return _orig(*a, **kw)
    monkeypatch.setattr(k1, "fused_combine_plain", bump)
    monkeypatch.setattr(k1.fused_combine, "launches", 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out = cs.phase_bridge(torch.device("cpu"), 4096)
    assert k1.fused_combine.launches > out["k1_gated_launches"] > 0
    assert out["shape_veto"] == out["dtype_veto"] == dict(
        decision=0, kernels=0, openers_recorded=0)
    assert out["trace_events"] > 0
    for key in ("gated_allreduce_ms", "ungated_allreduce_ms",
                "consensus_round_host_us", "judged_round_host_us"):
        assert out[key] > 0


def test_phase_multihost_rehearsal():
    """Phase 15b on the CPU: four ``chip_smoke.py --multihost-worker``
    processes run the demo's rounds 1-4 and each prints MULTIHOST-OK."""
    out = cs.phase_multihost(torch.device("cpu"))
    assert out["procs"] == 4
    assert sorted(out["round_ms_max"]) == ["round1", "round2", "round3",
                                           "round4"]


def test_phase_train_parallel_rehearsal(monkeypatch):
    """Phase 16 at a tiny f32 size on the CPU: four ``chip_smoke.py
    --train-parallel-worker`` processes (gloo, device type cpu, the plain
    versions counting their wrappers' launches) take each sub-phase's
    step; every one holds against the single-card step, every process
    the same loss, the replicated slices the same bits, the launches a
    step layers x ring steps; and the ring-step K4/K5 check holds with
    the masked block's exact zeros."""
    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value: _v)
    monkeypatch.setattr(cs, "SERVE_CFG", dict(
        vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        dtype="float32"))
    monkeypatch.setattr(cs, "TRAIN_BATCH", 4)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "TRAIN_PARALLEL", dict(cs.TRAIN_PARALLEL,
                                                   reps=2))
    monkeypatch.setattr(cs, "RING_STEP", dict(heads=4, blk=32, shard=1))
    out = cs.phase_train_parallel(torch.device("cpu"))
    want = {"16a sp 4 ring": 8, "16b sp 4 Ulysses": 2, "16c tp 4": 2,
            "16d sp 2 x tp 2 ring": 4, "16e ep 4 MoE": 2}
    for tag, n in want.items():
        st = out[tag]
        assert st["launches_per_step"] == {"flash_block_update_hld": n,
                                           "bwd_dq": n, "bwd_dkv": n}
        assert st["update_rel_l2_max"] <= 1e-4, tag
        assert st["loss_rel"] <= 1e-5, tag
        assert st["staged_bytes_per_step"] == 0      # CPU tensors
    # sp 4: each of the 14 leaves held whole by 4 processes
    assert out["16a sp 4 ring"]["replicated_copies_equal"] == 3 * 14
    assert out["ring_step"]["later shard"]["nonzero"] == dict(dq=0, dk=0,
                                                              dv=0)


def test_phase_grad_parallel_rehearsal(monkeypatch):
    """Phase 20's 20b and 20c at a tiny f32 size on the CPU: four
    ``chip_smoke.py --grad-parallel-worker`` processes (gloo, device type
    cpu, the plain versions counting their wrappers' launches) take every
    differentiable collective's gradient, each equal to its closed form
    with K1 launched the schedule's combines in a forward and none in a
    backward, and ``forward``'s gradient under each manual tp schedule
    within f32's class of 4 x the single card's, replicated slices the
    same bits, K1 launched layers x 2 sums x combines (one sub-chunk a
    row on the CPU). 20a (the card's K1 against its plain version) is
    stubbed: the CPU launches no kernel."""
    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value: _v)
    monkeypatch.setattr(cs, "phase_k1_grad", lambda dev: {})
    monkeypatch.setattr(cs, "SERVE_CFG", dict(
        vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        dtype="float32"))
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 16)
    monkeypatch.setattr(cs, "GRAD_PARALLEL", dict(cs.GRAD_PARALLEL, n=64,
                                                  reps=1))
    out = cs.phase_grad_parallel(torch.device("cpu"))
    assert len(out["20b"]) == 18
    assert out["20b"]["allreduce bidir_ring sum"]["k1_forward"] == 6
    assert out["20b"]["hierarchical 2 x 2 ring"]["k1_forward"] == 2
    assert out["20b"]["all_gather ring"]["k1_forward"] == 0
    want = {"ring": 12, "bidir_ring": 24, "recursive_doubling": 8,
            "halving_doubling": 8}
    for alg, k1 in want.items():
        st = out[f"20c tp 4 {alg}"]
        assert st["launches"] == {"fused_combine": k1,
                                  "fused_combine_forward": k1,
                                  "flash_block_update_hld": 2, "bwd_dq": 2,
                                  "bwd_dkv": 2}
        assert st["grad_rel_l2_max"] <= 1e-4, alg
        assert st["staged_bytes"] == 0          # CPU tensors
        # embed, ln_f and the 2 x 2 norm gains held whole by 4 processes
        assert st["replicated_copies_equal"] == 3 * 6


def test_phase_grid_limits_rehearsal(monkeypatch):
    """Phase 21a's logic at tiny shapes on the CPU (the plain versions
    stand in for the kernels and count their wrappers' launches, one a
    call, with the limit raised so that every call is one launch): K2-K5
    within their tolerances, K3's counts equal, K8/K11 bit-equal to
    indexed assignment, K6 over its planted keys and its rows."""
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.kernels import flash as kf
    for mod, names in ((kf, ("flash_block_update_hld", "rowstats",
                             "bwd_dq", "bwd_dkv")),
                       (kd, ("write_kv_block", "write_kv_page_block",
                             "flash_block_decode"))):
        for name in names:
            _count_plain(monkeypatch, mod, getattr(mod, name))
    for name, value in (("synchronize", None), ("empty_cache", None)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value: _v)
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "MAX_GRID_YZ", 1 << 30)
    monkeypatch.setattr(cs, "GRID", dict(
        heads=(5, 7), flash_l=16, blocks=(6, 9), k6_positions=3 * 256 + 1,
        k6_rows_t=40, k6_rows_l=384, iters=1))
    out = cs.phase_grid_limits(torch.device("cpu"))
    assert sorted(out) == sorted(
        [f"K2-K5 {h} heads {d}" for h in (5, 7)
         for d in ("bfloat16", "float32")]
        + ["K8 6 rows x 1 heads", "K8 1 rows x 9 heads", "K11 6 heads",
           "K11 9 heads", "K6 positions", "K6 rows"])
    assert all(st["launches"] == 1 for st in out.values())


def test_phase_proc_parallel_rehearsal(monkeypatch):
    """Phase 21b at a tiny size on the CPU: four ``chip_smoke.py
    --proc-parallel-worker`` processes (gloo, device type cpu, the plain
    versions counting their wrappers' launches) run TP generate (ring tp
    schedule), EP generate and a GPipe and a 1F1B step at pp 4; tokens,
    stage updates and losses bit-equal to the same runs on a CPU
    ``LocalMesh``, K1 launched by the TP ring, K2/K6/K7 by both
    generates and K2/K4/K5 by both steps."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "SERVE_CFG", dict(
        vocab=64, d_model=32, n_heads=4, n_layers=8, d_ff=64,
        dtype="float32"))
    monkeypatch.setattr(cs, "TP_DECODE", dict(cs.TP_DECODE, batch=4,
                                              plen=8))
    monkeypatch.setattr(cs, "EP_DECODE", dict(cs.EP_DECODE, batch=4,
                                              plen=8))
    monkeypatch.setattr(cs, "PIPE", dict(cs.PIPE, batch=8, seq=16))
    monkeypatch.setattr(cs, "MOE_EXPERTS", 4)
    monkeypatch.setattr(cs, "PROC_PARALLEL", dict(cs.PROC_PARALLEL,
                                                  max_new=3))
    out = cs.phase_proc_parallel(torch.device("cpu"))
    for tag in ("tp", "ep", "gpipe", "1f1b"):
        assert len(out[tag]["launches"]) == 4
        assert out[tag]["staged_bytes"] == [0] * 4     # CPU tensors
    assert all(n["fused_combine"] > 0 for n in out["tp"]["launches"])
    for tag in ("gpipe", "1f1b"):
        assert all(n["bwd_dkv"] > 0 for n in out[tag]["launches"])


def test_phase_grad_parallel_launch_arithmetic():
    """20c's K1 counts at the flagship config on the card (8 layers, tp 4,
    two sub-chunks a bidir row): 48, 192, 32 and 32 launches a forward."""
    got = {alg: cs.SERVE_CFG["n_layers"] * 2 * cs._combines(
        "allreduce", alg, cs.GRAD_PARALLEL["procs"], 2)
        for alg in cs.GRAD_TP_ALGORITHMS}
    assert got == {"ring": 48, "bidir_ring": 192, "recursive_doubling": 32,
                   "halving_doubling": 32}
    assert [cs._combines("reduce_scatter", a, 4, 2)
            for a in ("ring", "halving")] == [3, 2]


def test_phase_fabric_rehearsal(monkeypatch):
    """Phase 17 at a tiny f32 width on the CPU, the plain versions
    counting their wrappers' launches: in the dense and the paged
    four-rank fleet the busiest rank is killed mid-decode, every request
    completes exactly once on every live rank, at least one is re-queued,
    every completion equals its prompt's generate (here to the end), the
    dense fleet launches K2, K6, K7 and K8 and the paged one K9, K10 and
    K11, and the dense fleet's second run repeats its schedule digest and
    its tokens."""
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.kernels import flash as kf
    counted = (kf.flash_block_update_hld, kd.flash_block_decode,
               kd.write_kv_row, kd.write_kv_block, kd.paged_flash_decode,
               kd.write_kv_page_row, kd.write_kv_page_block)
    for mod, wrapper in zip((kf,) + (kd,) * 6, counted):
        def bump(*a, _orig=getattr(mod, wrapper.__name__ + "_plain"),
                 _w=wrapper, **kw):
            _w.launches += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, wrapper.__name__ + "_plain", bump)
        monkeypatch.setattr(wrapper, "launches", 0)
    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value: _v)
    monkeypatch.setattr(cs, "SERVE_CFG", dict(
        vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        dtype="float32"))
    monkeypatch.setattr(cs, "FABRIC", dict(
        cs.FABRIC, requests=16, n_slots=2, max_len=64, round_len=4,
        buckets=(8, 16), plens=(8, 12, 16, 24), max_new=(6, 12), page_size=8,
        prefix_len=16, tails=(4, 8, 12)))
    out = cs.phase_fabric(torch.device("cpu"), counted)
    for tag in ("17a dense", "17b paged"):
        st = out[tag]
        assert st["requeues"] >= 1 and st["dup_done"] == 0
        assert st["compared_to_end"] == 16
        assert len(st["rounds"]) == 4 and st["virtual_s"] < 120.0
    assert out["17a dense"]["rerun_same_digest"]
    assert out["17a dense"]["rerun_same_tokens"]
    dense, paged = out["17a dense"]["launches"], out["17b paged"]["launches"]
    for name in ("flash_block_update_hld", "flash_block_decode",
                 "write_kv_row", "write_kv_block"):
        assert dense[name] > 0, name
    for name in ("paged_flash_decode", "write_kv_page_row",
                 "write_kv_page_block"):
        assert paged[name] > 0 and dense[name] == 0, name
    assert out["17b paged"]["prefix_hits"] > 0


def test_phase_host_facades_rehearsal(monkeypatch):
    """Phase 18a/b at a tiny size on the CPU, the plain K1 counting its
    launches: the native and loopback facades fed tensors give
    TorchBackend's bits for every op (the ring ones by the same
    association), tensors back, and a split of each op's wall."""
    from rlo_tpu_torch.kernels import reduce as k1

    def bump(*a, _orig=k1.fused_combine_plain, **kw):
        k1.fused_combine.launches += 1
        return _orig(*a, **kw)
    monkeypatch.setattr(k1, "fused_combine_plain", bump)
    monkeypatch.setattr(k1.fused_combine, "launches", 0)
    monkeypatch.setattr(cs, "HOST", dict(
        cs.HOST, n_int=2 ** 10, n_a2a=2 ** 6,
        bcast={"native": 2 ** 10, "loopback": 2 ** 8}))
    out = cs.phase_host_facades(torch.device("cpu"), 2 ** 14)
    assert k1.fused_combine.launches > 0
    for tag in ("18a native", "18b loopback"):
        rows = out[tag]
        assert rows["consensus yes"]["decision"] == 1
        assert rows["consensus veto"]["decision"] == 0
        ring = rows["allreduce f32 sum ring"]
        assert ring["torch_k1_launches"] == 7 * 8 and ring["gb_s"] > 0
        assert ring["ms"] >= ring["protocol_ms"] > 0


def test_phase_host_procs_rehearsal(monkeypatch):
    """Phase 18c/d on the CPU: four ``chip_smoke.py --host-worker``
    processes under the port's femtompirun and its tcprun, each one rank
    of ``init("mpi")``/``init("tcp")``, their digests equal to
    TorchBackend's on the same tensors."""
    monkeypatch.setattr(cs, "HOST_PROCS", dict(cs.HOST_PROCS,
                                               n_small=2 ** 8))
    out = cs.phase_host_procs(torch.device("cpu"), 2 ** 14)
    for tag in ("18c mpi", "18d tcp"):
        assert out[tag]["allreduce"]["ms"] > 0
        assert out[tag]["gb_s"] > 0


def _count_plain(monkeypatch, mod, wrapper):
    """The wrapper's plain version bumps the wrapper's launch count."""
    def bump(*a, _orig=getattr(mod, wrapper.__name__ + "_plain"),
             _w=wrapper, **kw):
        _w.launches += 1
        return _orig(*a, **kw)
    monkeypatch.setattr(mod, wrapper.__name__ + "_plain", bump)
    monkeypatch.setattr(wrapper, "launches", 0)


def test_phase_tools_rehearsal(monkeypatch, tmp_path):
    """Phase 19 on the CPU after phase 17's recorded dense fleet (tiny
    f32 widths, the plain versions counting their wrappers' launches,
    the hostile probes in this process): the runner reports no finding,
    every schedule's recorded bytes equal the cost model and its
    results an unrecorded run's, the hostile cases equal their plain
    twins with dropped rows untouched, rlo-scope joins the loopback
    ring's dumps without a finding and rlo-trace finds undelivered only
    the killed gateway's requests."""
    from rlo_tpu_torch.kernels import build
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.kernels import flash as kf
    from rlo_tpu_torch.kernels import reduce as k1
    counted = (kf.flash_block_update_hld, kd.flash_block_decode,
               kd.write_kv_row, kd.write_kv_block, kd.paged_flash_decode,
               kd.write_kv_page_row, kd.write_kv_page_block)
    for mod, wrapper in zip((kf,) + (kd,) * 6, counted):
        _count_plain(monkeypatch, mod, wrapper)
    _count_plain(monkeypatch, k1, k1.fused_combine)
    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value: _v)
    monkeypatch.setattr(build, "load", lambda name: None)
    monkeypatch.setattr(cs, "SERVE_CFG", dict(
        vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        dtype="float32"))
    monkeypatch.setattr(cs, "FABRIC", dict(
        cs.FABRIC, requests=16, n_slots=2, max_len=64, round_len=4,
        buckets=(8, 16), plens=(8, 12, 16, 24), max_new=(6, 12),
        page_size=8, prefix_len=16, tails=(4, 8, 12)))
    monkeypatch.setattr(cs, "TOOLS", dict(cs.TOOLS, scope_n=2 ** 10))
    dev = torch.device("cpu")
    monkeypatch.setattr(cs, "phase_hostile", lambda: {
        "cases": cs.hostile_probes(dev)})
    fabric = cs.phase_fabric(dev, counted, str(tmp_path))
    victim = fabric["17a dense"]["victim"]
    assert sum(fabric["17a dense"]["recorded"]["span_events"]) > 0
    out = cs.phase_tools(dev, 2 ** 12, str(tmp_path), victim)
    assert out["19a"]["tool_seconds"].keys() == {
        "rlo-lint", "rlo-sentinel", "rlo-prover", "rlo-model"}
    assert set(out["19b"]) >= {"ring", "bidir_ring q1", "bidir_ring q2",
                               "bidir_ring q4", "halving_doubling",
                               "recursive_doubling", "hierarchical int8",
                               "all_to_all direct"}
    assert out["k1_launches_19b"] > 0
    cases = out["19c"]["cases"]
    assert len([c for c in cases if c.startswith("K6")]) == 8
    assert all(k in " ".join(cases) for k in ("K7", "K8", "K9", "K10",
                                               "K11"))
    assert all(g > 0 for g in out["19d"]["scope_gbps"].values())
    assert all(r.startswith(f"{victim}:")
               for r in out["19d"]["trace_undelivered"])
