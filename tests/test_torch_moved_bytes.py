"""Byte pinning without HLO (rlo_tpu_torch/utils/moved_bytes.py).

The port's counterparts of tests/test_tpu_collectives.py's lowered-HLO
byte pins: on the same shapes and algorithm three numbers agree —

  - the bytes the port's schedule hands to its ``Axis`` (a
    ``RecordingAxis`` around each rank's CPU ``LocalMesh`` axis);
  - the port's cost models (``allreduce_cost``,
    ``hierarchical_allreduce_cost``, ``all_to_all_cost``) and, where it
    has the schedule, ``observe.ledger``;
  - ``rlo_tpu.utils.hlo``'s count over the JAX program's lowered text.

The lowered text shows a rolled loop's body once (the ring's
``fori_loop``), so there the HLO figure times the trip count is pinned;
the recording holds every executed call. ``pipeline_chunks`` is given
to the port explicitly: its default follows the device.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rlo_tpu.ops import tpu_collectives as tc
from rlo_tpu.parallel.mesh import make_mesh, shard_jit
from rlo_tpu.utils import hlo
from rlo_tpu_torch.observe.ledger import ledger
from rlo_tpu_torch.ops import device_collectives as dc
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.utils import moved_bytes as mb

WS = 8


def _record(fn, shape, names, xs):
    """Run ``fn(axes, x)`` on a CPU LocalMesh with every axis recorded
    and once without; returns (per-rank {name: RecordingAxis}, outs),
    after checking the recorded run equals the plain one bit for bit."""
    mesh = LocalMesh(shape, names, "cpu")
    recs = [None] * mesh.world_size

    def rank(axes, x, r):
        wrapped = mb.recording_axes(axes, names)
        recs[r] = wrapped
        return fn(wrapped, x)

    outs = mesh.run(rank, xs, list(range(mesh.world_size)))
    plain = mesh.run(lambda axes, x: fn(axes, x), xs)
    assert all(torch.equal(a, b) for a, b in zip(outs, plain))
    return recs, outs


def _rand(n, per, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal(per).astype(np.float32))
            for _ in range(n)]


def _by_direction(entries, ws):
    fwd = bwd = other = 0
    for src, dst, nbytes in entries:
        if dst == (src + 1) % ws:
            fwd += nbytes
        elif dst == (src - 1) % ws:
            bwd += nbytes
        else:
            other += nbytes
    return fwd, bwd, other


def _lowered(fn, x, shape, names, spec):
    mesh = make_mesh(shape, names)
    return shard_jit(fn, mesh, spec, spec).lower(x).as_text()


@pytest.fixture(scope="module")
def xmesh():
    return make_mesh((WS,), ("x",))


def _allreduce_all_ranks(alg, per, nq):
    recs, outs = _record(
        lambda axes, v: dc.allreduce(v, axes["x"], algorithm=alg,
                                     pipeline_chunks=nq),
        (WS,), ("x",), _rand(WS, per))
    totals = {mb.permute_total_bytes(r["x"], require=True) for r in recs}
    assert len(totals) == 1          # every rank hands over the same
    return recs[0]["x"], outs


@pytest.mark.parametrize("pad", [0, 7], ids=["even", "padded"])
def test_bidir_ring(pad):
    nq = 2
    per = 2 * WS * nq * 32 + pad
    rec, _ = _allreduce_all_ranks("bidir_ring", per, nq)
    fwd, bwd, other = _by_direction(mb.permute_entries(rec), WS)
    total, n = mb.permute_total_bytes(rec)
    model = dc.allreduce_cost("bidir_ring", WS, per * 4,
                              pipeline_chunks=nq)
    txt = _lowered(lambda v: tc.allreduce(
        v, "x", algorithm="bidir_ring", use_pallas=False,
        pipeline_chunks=nq), jnp.zeros((WS, per), jnp.float32), (WS,),
        ("x",), P("x"))
    h_fwd, h_bwd, h_other = _by_direction(hlo.permute_entries(
        txt, require=True), WS)
    h_total, h_n = hlo.permute_total_bytes(txt, require=True)
    assert other == h_other == 0
    assert fwd == bwd == model["fwd_bytes"] == h_fwd == h_bwd
    assert n == model["n_permutes"] == h_n == 4 * (WS - 1) * nq
    assert total == model["total_bytes"] == h_total


def test_ring():
    per = WS * 64
    rec, _ = _allreduce_all_ranks("ring", per, 1)
    fwd, bwd, other = _by_direction(mb.permute_entries(rec), WS)
    total, n = mb.permute_total_bytes(rec)
    model = dc.allreduce_cost("ring", WS, per * 4, pipeline_chunks=1)
    led = ledger("ring_allreduce", WS, per * 4)
    txt = _lowered(lambda v: tc.allreduce(v, "x", algorithm="ring",
                                          use_pallas=False),
                   jnp.zeros((WS, per), jnp.float32), (WS,), ("x",),
                   P("x"))
    h_fwd, h_bwd, h_other = _by_direction(hlo.permute_entries(txt), WS)
    _h_total, h_n = hlo.permute_total_bytes(txt, require=True)
    assert bwd == other == h_bwd == h_other == 0
    # the two rolled loops: one permute each in the text, ws - 1 trips
    assert fwd == total == model["fwd_bytes"] == h_fwd * (WS - 1) \
        == led.bytes_per_rank
    assert n == model["n_permutes"] == h_n * (WS - 1) == led.num_steps


@pytest.mark.parametrize("alg,sched", [
    ("halving_doubling", "halving_doubling"),
    ("recursive_doubling", "recursive_doubling")])
def test_xor_schedules(alg, sched):
    per = WS * 96
    rec, _ = _allreduce_all_ranks(alg, per, 1)
    total, n = mb.permute_total_bytes(rec)
    model = dc.allreduce_cost(alg, WS, per * 4, pipeline_chunks=1)
    led = ledger(sched, WS, per * 4)
    txt = _lowered(lambda v: tc.allreduce(v, "x", algorithm=alg,
                                          use_pallas=False),
                   jnp.zeros((WS, per), jnp.float32), (WS,), ("x",),
                   P("x"))
    h_total, h_n = hlo.permute_total_bytes(txt, require=True)
    assert total == model["total_bytes"] == led.bytes_per_rank == h_total
    assert n == model["n_permutes"] == led.num_steps == h_n


def _hier(**kw):
    wd, wi = 2, 4
    per = wi * 96
    recs, _ = _record(
        lambda axes, v: dc.hierarchical_allreduce(
            v, axes["ici"], axes["dcn"], **kw),
        (wd, wi), ("dcn", "ici"), _rand(wd * wi, per, seed=1))
    txt = _lowered(lambda v: tc.hierarchical_allreduce(
        v, "ici", "dcn", use_pallas=False, **kw),
        jnp.zeros((wd, wi, per), jnp.float32), (wd, wi), ("dcn", "ici"),
        P("dcn", "ici"))
    model = dc.hierarchical_allreduce_cost(wi, wd, per * 4, **kw)
    return recs[0], txt, model, wi, per


def test_hierarchical_ici():
    rec, txt, model, wi, per = _hier()
    total, n = mb.permute_total_bytes(rec["ici"], require=True)
    h_total, h_n = hlo.permute_total_bytes(txt, require=True)
    led = ledger("halving_doubling", wi, per * 4)
    assert total == model["ici_bytes"] == h_total == led.bytes_per_rank
    assert n == model["ici_permutes"] == h_n
    # the dcn tier reduces the scattered shard: psum's one operand
    assert rec["dcn"].all_reduces == [(model["dcn_elems"], "f32", "sum")]
    assert rec["dcn"].permutes == []


def test_hierarchical_forced_ring():
    rec, txt, model, wi, per = _hier(ici_algorithm="ring")
    total, n = mb.permute_total_bytes(rec["ici"], require=True)
    h_total, h_n = hlo.permute_total_bytes(txt, require=True)
    chunk = per // wi * 4
    k = wi.bit_length() - 1
    assert total == model["ici_bytes"] == (2 * wi - 1) * chunk
    assert n == model["ici_permutes"] == wi + k
    # the text: the rolled reduce-scatter's one permute (wi - 1 trips),
    # the ownership rotation, the unrolled doubling all-gather
    assert h_n == 2 + k
    assert h_total + (wi - 2) * chunk == total


def test_hierarchical_int8_dcn():
    rec, txt, model, _wi, _per = _hier(dcn_algorithm="int8")
    payload = [e for e, dt in mb.all_gather_operands(rec["dcn"],
                                                     require=True)
               if dt == "i8"]
    h_payload = [e for e, dt in hlo.all_gather_operands(txt, require=True)
                 if dt == "i8"]
    assert payload == [model["dcn_elems"]]
    assert h_payload and set(h_payload) == {model["dcn_elems"]}
    scales = [(e, dt) for e, dt in rec["dcn"].all_gathers if dt != "i8"]
    assert scales == [(1, "f32")]
    wd = 2
    assert model["dcn_bytes"] == (wd - 1) * (payload[0] + 4)


def test_all_to_all_direct(xmesh):
    chunk = 32
    xs = [torch.arange(WS * chunk, dtype=torch.float32).reshape(WS, chunk)
          + 1000 * r for r in range(WS)]
    recs, outs = _record(
        lambda axes, v: dc.all_to_all(v, axes["x"], algorithm="direct"),
        (WS,), ("x",), xs)
    txt = shard_jit(lambda v: tc.all_to_all(v[0], "x",
                                            algorithm="direct")[None],
                    xmesh, P("x"), P("x")).lower(
        jnp.zeros((WS, WS, chunk), jnp.float32)).as_text()
    model = dc.all_to_all_cost("direct", WS, WS * chunk * 4)

    def account(entries):
        injected = hops = 0
        for src, dst, nbytes in entries:
            injected += nbytes
            hops += ((dst - src) % WS) * nbytes
        return injected, hops, len(entries)

    got = account(mb.permute_entries(recs[0]["x"], require=True))
    want = (model["injected_bytes"], model["link_hop_bytes"],
            model["n_permutes"])
    assert got == want == account(hlo.permute_entries(txt, require=True))
    for r in range(WS):
        assert torch.equal(outs[r], torch.stack([xs[s][r]
                                                 for s in range(WS)]))


def test_require_guards_an_empty_record():
    mesh = LocalMesh((2,), ("x",), "cpu")
    rec = mb.RecordingAxis(mesh.axes(0)["x"])
    assert mb.permute_total_bytes(rec) == (0, 0)
    assert mb.permute_entries(rec) == mb.all_gather_operands(rec) == []
    for fn in (mb.permute_total_bytes, mb.permute_entries,
               mb.all_gather_operands):
        with pytest.raises(ValueError, match="bypassed the RecordingAxis"):
            fn(rec, require=True)
    with pytest.raises(ValueError, match="StableHLO printer"):
        hlo.permute_total_bytes("", require=True)


def test_psum_records_the_operand_and_no_permute():
    recs, outs = _record(
        lambda axes, v: dc.allreduce(v, axes["x"], algorithm="psum"),
        (4,), ("x",), _rand(4, 40))
    assert recs[0]["x"].all_reduces == [(40, "f32", "sum")]
    assert recs[0]["x"].permutes == []
    assert dc.allreduce_cost("ring", 4, 160, pipeline_chunks=1)[
        "total_bytes"] == 2 * 3 * 40
