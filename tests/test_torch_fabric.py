"""The port's serving fabric (``rlo_tpu_torch/serving``) against the JAX
package's (``rlo_tpu/serving``) on the CPU, on the same seeded inputs:

  - placement and routing (``rendezvous_owner``, ``owner_of``,
    ``pick_owner``, ``healthy_members``) and every record codec (ADMIT,
    DONE, PLACE, LOAD, the remedy records): equal values and equal
    bytes, over hypothesis-drawn members, seeds and loads;
  - ``stub_tokens`` and both stub backends over a seeded random sequence
    of submits, cancels and rounds;
  - every fabric scenario kind of the simulator at seeds 0-2: the run's
    result dict equals the reference's key for key (the schedule digest,
    the event count, the completion tokens, the re-queues, the duplicate
    completions and the remedy log included), and a traced run's span
    events equal the reference's;
  - fleets of the port's ``DecodeServer`` (dense and paged, f32 tiny
    weights carried across by ``convert.params_from_numpy``) behind the
    port's fabric against the JAX fleet on the same schedule, with and
    without an owner killed mid-decode: completions, re-queues and the
    schedule digest exactly equal.

All of it is exact: the fabric is host-side scheduling over the standard
library, and the tiny f32 servers give the JAX servers' tokens.
"""

import logging
import random

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rlo_tpu.engine import EngineManager as RefManager
from rlo_tpu.engine import ProgressEngine as RefEngine
from rlo_tpu.models import serve as js
from rlo_tpu.models import transformer as jt
from rlo_tpu.observe import remedy as ref_remedy
from rlo_tpu.serving import backend as ref_backend
from rlo_tpu.serving import fabric as ref_fabric
from rlo_tpu.serving import placement as ref_place
from rlo_tpu.serving import scenario as ref_scenario
from rlo_tpu.transport.sim import SimWorld as RefWorld
from rlo_tpu.utils.metrics import Registry as RefRegistry
from rlo_tpu_torch.convert import params_from_numpy
from rlo_tpu_torch.engine import EngineManager, ProgressEngine
from rlo_tpu_torch.models import serve as ts
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.observe import remedy as port_remedy
from rlo_tpu_torch.serving import backend as port_backend
from rlo_tpu_torch.serving import fabric as port_fabric
from rlo_tpu_torch.serving import placement as port_place
from rlo_tpu_torch.serving import scenario as port_scenario
from rlo_tpu_torch.transport.sim import SimWorld as PortWorld
from rlo_tpu_torch.utils.metrics import Registry as PortRegistry

logging.getLogger("rlo_tpu").setLevel(logging.ERROR)
logging.getLogger("rlo_tpu_torch").setLevel(logging.ERROR)

SEEDS = (0, 1, 2)
members_st = st.lists(st.integers(0, 63), min_size=1, max_size=12,
                      unique=True)


# ---------------------------------------------------------------------------
# placement, routing and the record codecs
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(members=members_st, gateway=st.integers(0, 63),
       seq=st.integers(0, 2 ** 31 - 1),
       quarantined=st.lists(st.integers(0, 63), max_size=4),
       avoid=st.lists(st.integers(0, 63), max_size=4),
       version=st.integers(-2 ** 31, 2 ** 31 - 1),
       proposer=st.integers(0, 63))
def test_placement_and_routing_equal_reference(members, gateway, seq,
                                                quarantined, avoid,
                                                version, proposer):
    assert port_place.rendezvous_owner(gateway, seq, members) == \
        ref_place.rendezvous_owner(gateway, seq, members)
    assert port_place.healthy_members(members, quarantined) == \
        ref_place.healthy_members(members, quarantined)
    pp = port_place.Placement(version, proposer, tuple(members))
    rp = ref_place.Placement(version, proposer, tuple(members))
    assert pp.encode() == rp.encode()
    back, want = (port_place.Placement.decode(rp.encode()),
                  ref_place.Placement.decode(rp.encode()))
    assert (back.version, back.proposer, back.members) == \
        (want.version, want.proposer, want.members)
    assert port_place.Placement.decode(rp.encode()[:-1]) is None
    for admit_owner in (members[0], gateway):
        assert port_place.owner_of((gateway, seq), admit_owner, pp,
                                   quarantined, avoid) == \
            ref_place.owner_of((gateway, seq), admit_owner, rp,
                               quarantined, avoid)


@settings(max_examples=200, deadline=None)
@given(members=members_st, self_rank=st.integers(0, 63),
       loads=st.dictionaries(st.integers(0, 63),
                             st.tuples(st.integers(0, 8),
                                       st.integers(0, 64)), max_size=12))
def test_pick_owner_equals_reference(members, self_rank, loads):
    assert port_place.pick_owner(self_rank, members, loads) == \
        ref_place.pick_owner(self_rank, members, loads)
    assert port_place.pick_owner(self_rank, [], loads) == self_rank


@settings(max_examples=200, deadline=None)
@given(rid=st.tuples(st.integers(0, 63), st.integers(0, 2 ** 31 - 1)),
       owner=st.integers(0, 63), max_new=st.integers(0, 4096),
       eos=st.integers(-1, 32767),
       prompt=st.lists(st.integers(0, 32767), max_size=40),
       ctx=st.binary(max_size=24), free=st.integers(0, 64),
       depth=st.integers(0, 1024), version=st.integers(0, 2 ** 20),
       proposer=st.integers(0, 63),
       kind=st.sampled_from(ref_remedy.REMEDY_KINDS),
       level=st.integers(-1, 16))
def test_record_codecs_byte_equal(rid, owner, max_new, eos, prompt, ctx,
                                  free, depth, version, proposer, kind,
                                  level):
    P, R = port_fabric, ref_fabric
    assert P.FABRIC_MAGIC == R.FABRIC_MAGIC
    assert P.FABRIC_PID_BASE == R.FABRIC_PID_BASE
    assert [(m.name, int(m)) for m in P.Rec] == \
        [(m.name, int(m)) for m in R.Rec]
    assert P._enc_admit(rid, owner, max_new, eos, prompt, ctx) == \
        R._enc_admit(rid, owner, max_new, eos, prompt, ctx)
    assert P._enc_done(rid, owner, prompt, ctx) == \
        R._enc_done(rid, owner, prompt, ctx)
    place = tuple(sorted({owner, proposer}))
    assert P._enc_place(port_place.Placement(version, proposer, place),
                        ctx) == \
        R._enc_place(ref_place.Placement(version, proposer, place), ctx)
    assert P._enc_load(free, depth) == R._enc_load(free, depth)
    prec = port_remedy.RemedyRecord(kind, owner, level, version, proposer)
    rrec = ref_remedy.RemedyRecord(kind, owner, level, version, proposer)
    assert prec.encode() == rrec.encode() and prec.name() == rrec.name()
    assert P._enc_remedy(prec) == R._enc_remedy(rrec)
    back = port_remedy.RemedyRecord.decode(kind, rrec.encode())
    assert (back.kind, back.target, back.level, back.version,
            back.proposer) == (kind, owner, level, version, proposer)


def test_remedy_vocabulary_equals_reference():
    for name in ("REMEDY_KINDS", "REMEDY_PID_BASE", "KIND_NAMES",
                 "DEFAULT_ACTIONS"):
        assert getattr(port_remedy, name) == getattr(ref_remedy, name), name


# ---------------------------------------------------------------------------
# the stub backends
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(prompt=st.lists(st.integers(0, 2 ** 31 - 1), max_size=32),
       max_new=st.integers(0, 80),
       eos=st.one_of(st.none(), st.integers(0, 99)),
       vocab=st.sampled_from((100, 32768)))
def test_stub_tokens_equal_reference(prompt, max_new, eos, vocab):
    assert port_backend.stub_tokens(prompt, max_new, eos, vocab) == \
        ref_backend.stub_tokens(prompt, max_new, eos, vocab)


def _drive_stub(pkg, paged, seed):
    """A seeded random sequence of submits (shared prefixes, exact
    repeats, duplicate keys), cancels and rounds; returns everything the backend reported."""
    rng = random.Random(seed)
    be = (pkg.PagedStubBackend(n_slots=3, round_len=5, n_pages=17,
                               page_size=4) if paged
          else pkg.StubBackend(n_slots=3, round_len=5))
    prefixes = [tuple(rng.randrange(100) for _ in range(9))
                for _ in range(3)]
    log, keys, prompts = [], [], []
    for step in range(120):
        op = rng.random()
        if op < 0.45:
            key = (rng.randrange(4), step)
            prompt = rng.choice(prefixes)[:rng.randrange(1, 10)] + tuple(
                rng.randrange(100) for _ in range(rng.randrange(0, 6)))
            if prompts and rng.random() < 0.3:
                prompt = rng.choice(prompts)    # an exact repeat: COW
            prompts.append(prompt)
            if keys and rng.random() < 0.1:
                key = rng.choice(keys)          # a duplicate submit
            be.submit(key, prompt, rng.randrange(1, 20),
                      rng.choice((None, 7)))
            keys.append(key)
        elif op < 0.55 and keys:
            log.append(("cancel", be.cancel(rng.choice(keys))))
        else:
            log.append(("round", be.step_round()))
        log.append((be.load(), be.active_keys(), be.has_work()))
    log.append(be.stats())
    return log


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("paged", (False, True), ids=("stub", "paged"))
def test_stub_backends_equal_reference(paged, seed):
    want = _drive_stub(ref_backend, paged, seed)
    assert _drive_stub(port_backend, paged, seed) == want
    if paged:
        assert want[-1]["prefix_hits"] > 0 and want[-1]["cow_copies"] > 0


# ---------------------------------------------------------------------------
# the simulator's fabric scenarios
# ---------------------------------------------------------------------------

def test_fabric_scenario_kinds_equal_reference():
    assert port_scenario.FABRIC_SCENARIO_KINDS == \
        ref_scenario.FABRIC_SCENARIO_KINDS


EXACT = ("digest", "events", "done_tokens", "requeues", "dup_done",
         "remedy")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ref_scenario.FABRIC_SCENARIO_KINDS)
def test_fabric_scenario_equals_reference(kind, seed):
    want = ref_scenario.make_fabric_scenario(kind, seed).run()
    got = port_scenario.make_fabric_scenario(kind, seed).run()
    for key in EXACT:
        if key != "remedy" or key in want:
            assert key in want, key
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


def _traced(mod, seed):
    s = mod.FabricScenario(
        world_size=4, seed=seed, duration=120.0,
        script=[(0.5 + 0.5 * i, "submit", i % 4, 2) for i in range(8)]
        + [(4.0, "kill", 1)], decode_interval=1.0,
        trace_sample=1, telemetry=True)
    res = s.run()
    spans = [(e.rank, e.kind.name, e.a, e.b, e.c, e.d)
             for e in s.tracer.events()]
    return res, spans


@pytest.mark.parametrize("seed", SEEDS)
def test_traced_fabric_spans_equal_reference(seed):
    want, want_spans = _traced(ref_scenario, seed)
    got, got_spans = _traced(port_scenario, seed)
    assert want_spans and got == want and got_spans == want_spans


# ---------------------------------------------------------------------------
# fleets of the real DecodeServer behind the fabric
# ---------------------------------------------------------------------------

KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          dtype="float32")


@pytest.fixture(scope="module")
def models():
    jc = jt.TransformerConfig(**KW)
    tc = tt.TransformerConfig(**KW)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return {"ref": (jp, jc), "port": (tp, tc)}


def _server(pkg, params, cfg, paged):
    srv, reg = (js, RefRegistry) if pkg == "ref" else (ts, PortRegistry)
    if paged:
        return srv.DecodeServer(params, cfg, n_slots=2, max_len=64,
                                round_len=4, paged=True, page_size=8,
                                metrics=reg())
    return srv.DecodeServer(params, cfg, n_slots=2, max_len=64,
                            round_len=4, prompt_buckets=(8, 16),
                            metrics=reg())


def _fleet(pkg, model, paged, kill, n_ranks=3):
    """The model-backed fleet of the JAX package's fabric tests, in
    package ``pkg``: five requests through two gateways, rank 0 (the
    first admit-time owner) killed at virtual t = 2.5 when ``kill``."""
    World, Manager, Engine, fab, be = (
        (RefWorld, RefManager, RefEngine, ref_fabric, ref_backend)
        if pkg == "ref" else
        (PortWorld, EngineManager, ProgressEngine, port_fabric,
         port_backend))
    params, cfg = model
    world = World(n_ranks, seed=0)
    mgr = Manager()
    engines = [Engine(world.transport(r), manager=mgr, clock=world.clock,
                      failure_timeout=6.0, heartbeat_interval=1.0,
                      arq_rto=1.5, arq_max_retries=6, op_deadline=20.0)
               for r in range(n_ranks)]
    fabrics = [fab.DecodeFabric(
        engines[r], be.ModelBackend(_server(pkg, params, cfg, paged)),
        decode_interval=1.0) for r in range(n_ranks)]
    rng = np.random.default_rng(1)
    shared = tuple(int(t) for t in rng.integers(0, cfg.vocab, (9,)))
    reqs = []
    for i, (plen, m) in enumerate(((6, 14), (5, 6), (9, 8), (4, 3),
                                   (3, 10))):
        tail = tuple(int(t) for t in rng.integers(0, cfg.vocab, (plen,)))
        reqs.append((shared + tail if paged and i % 2 else tail, m))
    rids = [fabrics[1 + i % 2].submit(p, m) for i, (p, m) in enumerate(reqs)]
    live = set(range(n_ranks))
    killed = False
    while world.now < 90.0:
        if kill and not killed and world.now >= 2.5:
            killed = True
            world.kill_rank(0)
            engines[0].cleanup()
            live.discard(0)
        world.step()
        mgr.progress_all()
        for r in sorted(live):
            fabrics[r].pump()
        if (killed or not kill) and all(
                fabrics[r].result(rid) is not None
                for r in live for rid in rids):
            break
    out = {"digest": world.schedule_digest(), "now": world.now,
           "live": sorted(live)}
    for r in sorted(live):
        f = fabrics[r]
        out[r] = dict(results=[f.result(rid) for rid in rids],
                      completions=list(f.completions),
                      requeues=f.requeues, dup_done=f.dup_done,
                      placement=f.placement.encode(),
                      counters=f.stats()["counters"])
    for e in engines:
        e.cleanup()
    return out


@pytest.mark.parametrize("kill", (False, True), ids=("steady", "kill"))
@pytest.mark.parametrize("paged", (False, True), ids=("dense", "paged"))
def test_model_fleet_equals_reference(models, paged, kill):
    want = _fleet("ref", models["ref"], paged, kill)
    got = _fleet("port", models["port"], paged, kill)
    assert got == want
    for r in want["live"]:
        assert None not in want[r]["results"]
        assert sorted(want[r]["completions"]) == \
            sorted(set(want[r]["completions"]))
    if kill:
        assert want["live"] == [1, 2]
        assert sum(want[r]["requeues"] for r in want["live"]) > 0
