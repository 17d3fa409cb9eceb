"""The port's consensus-gated bridge (``rlo_tpu_torch.bridge``) against the
JAX package's ``HybridBackend`` on the same seeded inputs.

Every test of ``tests/test_bridge.py`` has its counterpart here, run on
both backends: decisions must be equal; approved results exact for
integer data and within the reference tests' tolerance (rtol = atol =
1e-5) for float sums. The reference's two compile-cache tests
(``test_device_judge_reuse_hits_compile_cache``,
``test_bound_method_judge_reuse_hits_compile_cache``) have no
counterpart: the port calls a judge on each rank's tensor eagerly, so
it compiles nothing and keeps no judge cache to grow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rlo_tpu
import rlo_tpu_torch
from rlo_tpu.native.bindings import run_judged_proposal as ref_round
from rlo_tpu_torch.backend import NativeBackend
from rlo_tpu_torch.bridge import _describe, run_judged_proposal
from rlo_tpu_torch.native import bindings as native

WS = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    with rlo_tpu.init(backend="hybrid", world_size=WS) as b:
        yield b


@pytest.fixture(scope="module")
def port():
    with rlo_tpu_torch.init(backend="hybrid", world_size=WS,
                            device="cpu") as b:
        yield b


def _xs(ws=WS, n=64, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(dtype) for _ in range(ws)]


def _ints(ws=WS, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-1000, 1000, n).astype(np.int32)
            for _ in range(ws)]


def ref_finite(v):
    return jnp.all(jnp.isfinite(v)).astype(jnp.int32)


def port_finite(v):
    return torch.isfinite(v).all().to(torch.int32)


def both(ref, port, *args, **kw):
    """The same propose_collective call on both backends."""
    rj = kw.pop("device_judge", None)
    want = ref.propose_collective(
        *args, **kw, **({"device_judge": ref_finite} if rj else {}))
    got = port.propose_collective(
        *args, **kw, **({"device_judge": port_finite} if rj else {}))
    assert got[0] == want[0]
    return want, got


def assert_outs(got, want, exact):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if exact:
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            np.testing.assert_allclose(g, np.asarray(w), **TOL)


class TestPlanes:
    def test_data_plane_allreduce(self, ref, port):
        xs = _xs()
        out = port.allreduce(xs)
        assert_outs(out, ref.allreduce(xs), exact=False)
        np.testing.assert_allclose(out[2], np.sum(xs, axis=0), **TOL)
        ints = _ints(seed=9)
        assert_outs(port.allreduce(ints, algorithm="ring"),
                    ref.allreduce(ints), exact=True)

    def test_control_plane_bcast_and_consensus(self, ref, port):
        xs = _xs()
        got = port.bcast(origin=3, x=xs[1])
        assert_outs(got, ref.bcast(origin=3, x=xs[1]), exact=True)
        np.testing.assert_array_equal(got[0], xs[1])
        for votes in ([1] * WS, [1, 1, 0, 1], [0, 1, 1, 1], [0] * WS):
            for proposer in range(WS):
                assert port.consensus(votes, proposer=proposer) == \
                    ref.consensus(votes, proposer=proposer) == \
                    int(all(votes))


class TestProposedCollective:
    def test_approved_runs_collective(self, ref, port):
        xs = _xs(seed=1)
        want, got = both(ref, port, "allreduce", xs, proposer=2)
        assert got[0] == 1
        assert_outs(got[1], want[1], exact=False)
        np.testing.assert_allclose(got[1][0], np.sum(xs, axis=0), **TOL)

    @pytest.mark.parametrize("op", ["allreduce", "reduce_scatter",
                                    "all_gather"])
    @pytest.mark.parametrize("proposer", range(WS))
    def test_integer_data_exact_from_every_proposer(self, ref, port, op,
                                                    proposer):
        xs = _ints(seed=20 + proposer)
        want, got = both(ref, port, op, xs, proposer=proposer)
        assert got[0] == 1
        assert_outs(got[1], want[1], exact=True)

    def test_mismatched_shape_vetoes(self, ref, port):
        xs = _xs(seed=2)
        xs[3] = xs[3][:32]  # rank 3's tensor disagrees with the proposal
        want, got = both(ref, port, "allreduce", xs, proposer=0)
        assert got == (0, None) and want == (0, None)

    def test_mismatched_dtype_vetoes(self, ref, port):
        xs = _xs(seed=3)
        xs[1] = xs[1].astype(np.float64)
        want, got = both(ref, port, "all_gather", xs)
        assert got == (0, None) and want == (0, None)

    def test_reduce_scatter_gated(self, ref, port):
        xs = _xs(seed=4)
        want, got = both(ref, port, "reduce_scatter", xs)
        assert got[0] == 1
        assert_outs(got[1], want[1], exact=False)
        full = np.sum(xs, axis=0)
        np.testing.assert_allclose(got[1][1], full.reshape(WS, -1)[1],
                                   **TOL)

    def test_unknown_op_rejected(self, ref, port):
        for b in (ref, port):
            with pytest.raises(ValueError, match="unknown collective"):
                b.propose_collective("transpose", _xs())

    def test_device_judge_shard_vetoes(self, ref, port):
        """Each rank's vote comes from its own device tensor; one rank's
        non-finite tensor vetoes the round although every structural
        judge approves."""
        xs = _xs(seed=5)
        want, got = both(ref, port, "allreduce", xs, device_judge=True)
        assert got[0] == 1
        assert_outs(got[1], want[1], exact=False)
        xs[2][7] = np.inf  # poison only rank 2's shard
        want, got = both(ref, port, "allreduce", xs, device_judge=True)
        assert got == (0, None) and want == (0, None)

    def test_device_judge_proposer_self_veto(self, ref, port):
        xs = _xs(seed=6)
        xs[0][0] = np.nan  # proposer rank 0's own shard
        want, got = both(ref, port, "allreduce", xs, proposer=0,
                         device_judge=True)
        assert got == (0, None) and want == (0, None)


class TestPortSurface:
    def test_tensors_in_tensors_out(self, port):
        xs = [torch.from_numpy(x) for x in _ints(seed=30)]
        d, out = port.propose_collective("allreduce", xs, proposer=3,
                                         algorithm="ring")
        assert d == 1 and all(isinstance(o, torch.Tensor) for o in out)
        want = torch.stack(xs).sum(0)
        assert all(torch.equal(o, want) for o in out)
        got = port.bcast(2, xs[2])
        assert all(torch.equal(g, xs[2]) for g in got)

    def test_payload_matches_reference_descriptor(self):
        from rlo_tpu.bridge import _describe as ref_describe
        x = np.zeros((3, 5), np.float32)
        assert _describe("allreduce", "sum", x) == \
            ref_describe("allreduce", "sum", [x])
        assert _describe("allreduce", "sum", torch.from_numpy(x)) == \
            ref_describe("allreduce", "sum", [x])

    @pytest.mark.parametrize("ws", [2, 5, 8])
    def test_judged_round_matches_native_round(self, ws):
        """``run_judged_proposal`` on the port's engines against the
        JAX package's on its C engines: the same decision for every
        proposer and veto pattern, and the action on the same ranks."""
        for proposer in range(ws):
            for veto in (None, proposer, (proposer + 1) % ws):
                def judge_for(r, veto=veto):
                    return lambda p, ctx: 0 if r == veto else 1
                acts = ([], [])
                d_port = run_judged_proposal(
                    ws, b"x", proposer, judge_for,
                    lambda r, p: acts[0].append(r))
                d_ref = ref_round(ws, b"x", proposer, judge_for,
                                  lambda r, p: acts[1].append(r))
                assert d_port == d_ref == int(veto is None)
                assert sorted(acts[0]) == sorted(acts[1])

    def test_engine_backend_every_origin(self):
        """The hybrid's control plane (the C engines of ``NativeBackend``)
        at ws 7: every origin's broadcast and a gated consensus."""
        with rlo_tpu_torch.init(backend="hybrid", world_size=7,
                                device="cpu") as b:
            x = np.arange(12, dtype=np.int64).reshape(3, 4)
            for origin in range(7):
                assert all(np.array_equal(o, x) for o in b.bcast(origin, x))
            assert b.consensus([1] * 7, proposer=5) == 1
            assert b.consensus([1, 1, 1, 1, 1, 1, 0], proposer=5) == 0

    @pytest.mark.parametrize("proposer", range(WS))
    def test_hybrid_decides_on_the_c_engines(self, ref, port, proposer,
                                             monkeypatch):
        """The control plane is ``NativeBackend`` and the gate is the C
        core's round (``native.bindings.run_judged_proposal``, once a
        proposal); every veto pattern (none, the proposer's own device
        tensor, another rank's, a shape) decides as the JAX
        ``HybridBackend`` does, with equal outputs on approval."""
        assert isinstance(port._native, NativeBackend)
        calls = []
        real = native.run_judged_proposal

        def counted(*a, **kw):
            calls.append(a[2])
            return real(*a, **kw)
        monkeypatch.setattr(native, "run_judged_proposal", counted)
        other = (proposer + 1) % WS
        for veto in (None, proposer, other, "shape"):
            xs = _ints(seed=50 + proposer)
            xs = [x.astype(np.float32) for x in xs]
            if veto == "shape":
                xs[other] = xs[other][:32]
            elif veto is not None:
                xs[veto][3] = np.nan
            want, got = both(ref, port, "allreduce", xs, proposer=proposer,
                             device_judge=True)
            assert got[0] == want[0] == int(veto is None)
            if veto is None:
                assert_outs(got[1], want[1], exact=True)
        assert calls == [proposer] * 4

    def test_round_trace_is_deterministic(self, port):
        """The C core's trace ring holds one gated round's events (kind,
        rank, a..d), the same every time: what the card phase holds
        against the CPU's."""
        xs = _xs(seed=40)
        streams = []
        native.trace_set(True)
        try:
            for _ in range(2):
                native.trace_clear()
                port.propose_collective("allreduce", xs, proposer=5 % WS,
                                        device_judge=port_finite)
                streams.append([(e["kind"], e["rank"], e["a"], e["b"],
                                 e["c"], e["d"])
                                for e in native.trace_drain()])
        finally:
            native.trace_set(False)
            native.trace_clear()
        assert streams[0] == streams[1]
        assert {"PROPOSAL_SUBMIT", "VOTE", "DECISION"} <= \
            {k for k, *_ in streams[0]}

    def test_hybrid_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rlo_tpu_torch.init(backend="hybrid", world_size=2)
        with pytest.raises(ValueError, match="unknown backend"):
            rlo_tpu_torch.init(backend="tpu")
