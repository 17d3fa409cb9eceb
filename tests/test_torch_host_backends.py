"""The port's host facades against the JAX package's, on the CPU.

``rlo_tpu_torch.init("loopback" | "native")`` runs the same Python
engines and ``Comm`` (copies of the JAX package's) and the same C core
(the port's copy of ``rlo_tpu/native``) as ``rlo_tpu.init`` of the same
name, so every op must give the same bits, at world sizes 2, 3, 5 and 8
and on sub-groups. The port's side takes tensors and must give tensors
back (numpy in gives numpy out); ``init``'s switch resolves as the JAX
package's does, except that with no name it is the card's and raises
without one.
"""

import numpy as np
import pytest
import torch

import rlo_tpu
import rlo_tpu.backend as rb
import rlo_tpu_torch
import rlo_tpu_torch.backend as pb

WORLD_SIZES = [2, 3, 5, 8]
HOST = ["loopback", "native"]
#: each facade's allreduce schedules (the JAX package's names)
ALGORITHMS = {"loopback": ["auto", "ring", "recursive_doubling"],
              "native": ["auto", "ring", "bcast_gather"]}


@pytest.fixture(params=[(n, ws) for n in HOST for ws in WORLD_SIZES],
                ids=lambda p: f"{p[0]}-ws{p[1]}")
def pair(request):
    name, ws = request.param
    ref = rlo_tpu.init(name, world_size=ws)
    port = rlo_tpu_torch.init(name, world_size=ws)
    yield name, ws, ref, port
    port.close()
    ref.close()


def _arrays(seed, ws, shape, dtype):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return [rng.integers(-1000, 1000, shape).astype(dtype)
                for _ in range(ws)]
    return [rng.standard_normal(shape).astype(dtype) for _ in range(ws)]


def _tensors(xs):
    return [torch.from_numpy(x.copy()) for x in xs]


def _same(got, want):
    """``got`` (the port's, tensors) equals ``want`` (the JAX package's,
    numpy) bit for bit, list for list."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert isinstance(got, torch.Tensor), type(got)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, \
        (g.dtype, g.shape, want.dtype, want.shape)
    assert g.tobytes() == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("dtype,ops", [
    (np.float32, ["sum", "min", "max", "prod"]),
    (np.float64, ["sum", "max"]),
    (np.int32, ["sum", "min", "and", "or"])], ids=["f32", "f64", "i32"])
def test_allreduce(pair, dtype, ops):
    name, ws, ref, port = pair
    for i, op in enumerate(ops):
        for alg in ALGORITHMS[name]:
            if alg == "ring" and name == "native" and not (
                    dtype == np.float32 and op in ("sum", "min", "max")):
                with pytest.raises(ValueError, match="float32"):
                    port.allreduce(_tensors(_arrays(0, ws, 5, dtype)),
                                   op=op, algorithm=alg)
                continue
            # 1 MB a rank takes Comm's 'auto' to the ring
            shape = (3, 7) if i % 2 else (2 ** 18 // ws,)
            xs = _arrays(i, ws, shape, dtype)
            _same(port.allreduce(_tensors(xs), op=op, algorithm=alg),
                  ref.allreduce(xs, op=op, algorithm=alg))


@pytest.mark.parametrize("dtype,op", [
    (np.float64, "sum"), (np.int32, "sum"), (np.float32, "prod")],
    ids=["f64-sum", "i32-sum", "f32-prod"])
def test_allreduce_0d(pair, dtype, op):
    """A 0-d tensor (a loss, a count) comes back a 0-d tensor under every
    schedule: for two 0-d arrays the bcast-gather's ufuncs give numpy
    scalars, which must not reach the caller."""
    name, ws, ref, port = pair
    xs = _arrays(4, ws, (), dtype)
    for alg in ALGORITHMS[name]:
        if alg == "ring" and name == "native":
            continue  # float32 sum/min/max only: test_allreduce's raise
        _same(port.allreduce(_tensors(xs), op=op, algorithm=alg),
              ref.allreduce(xs, op=op, algorithm=alg))


@pytest.mark.parametrize("size", [1, 13, 64])
def test_reduce_scatter(pair, size):
    name, ws, ref, port = pair
    for op, dtype in (("sum", np.float32), ("min", np.float32),
                      ("max", np.int32), ("sum", np.float64)):
        xs = _arrays(size, ws, (size,), dtype)
        _same(port.reduce_scatter(_tensors(xs), op=op),
              ref.reduce_scatter(xs, op=op))


def test_all_gather_and_all_to_all(pair):
    name, ws, ref, port = pair
    for shape, dtype in (((4, 3), np.float32), ((5,), np.int64),
                         ((), np.float64)):
        xs = _arrays(1, ws, shape, dtype)
        _same(port.all_gather(_tensors(xs)), ref.all_gather(xs))
    rng = np.random.default_rng(2)
    # equal chunks take the native C rotation; rows of unequal chunk
    # sizes its bcast-gather of stacked rows
    for ragged in (False, True):
        xss = [[rng.standard_normal((2 + (ragged and s % 2), 3))
                .astype(np.float32) for d in range(ws)] for s in range(ws)]
        _same(port.all_to_all([_tensors(row) for row in xss]),
              ref.all_to_all(xss))


def test_bcast_consensus_barrier(pair):
    name, ws, ref, port = pair
    # 16 KB: under the loopback engines' 32 KB frame cap
    n = 4096 if name == "loopback" else 2 ** 18
    for origin in range(ws):
        x = _arrays(origin, 1, (n,), np.float32)[0]
        _same(port.bcast(origin, torch.from_numpy(x)),
              ref.bcast(origin, x))
    for proposer in range(ws):
        for veto in (None, (proposer + 1) % ws, proposer):
            votes = [0 if r == veto else 1 for r in range(ws)]
            want = int(veto is None)
            assert port.consensus(votes, proposer=proposer) == want
            assert ref.consensus(votes, proposer=proposer) == want
    port.barrier()
    ref.barrier()


def test_sub_group(pair):
    name, ws, ref, port = pair
    # at world size 2 the sub-group is the whole world, on its own comms
    members = list(range(1, ws, 2)) + [0]
    rs, ps = ref.sub_group(members), port.sub_group(members)
    try:
        m = len(members)
        assert ps.world_size == rs.world_size == m
        xs = _arrays(3, m, (257,), np.float32)
        _same(ps.allreduce(_tensors(xs)), rs.allreduce(xs))
        _same(ps.allreduce(_tensors(xs), op="max"),
              rs.allreduce(xs, op="max"))
        _same(ps.reduce_scatter(_tensors(xs)), rs.reduce_scatter(xs))
        _same(ps.all_gather(_tensors(xs)), rs.all_gather(xs))
        x = xs[0][:100]
        _same(ps.bcast(m - 1, torch.from_numpy(x)), rs.bcast(m - 1, x))
        votes = [1] * m
        votes[-1] = 0
        assert ps.consensus(votes, proposer=0) == \
            rs.consensus(votes, proposer=0) == 0
        assert ps.consensus([1] * m, proposer=m - 1) == 1
        ps.barrier()
        with pytest.raises(NotImplementedError, match="nested"):
            ps.sub_group(members[:2])
    finally:
        ps.close()
        rs.close()
    # the parent still works after its sub-group closed
    xs = _arrays(4, ws, (9,), np.float32)
    _same(port.allreduce(_tensors(xs)), ref.allreduce(xs))


def test_numpy_in_numpy_out(pair):
    name, ws, ref, port = pair
    xs = _arrays(5, ws, (6,), np.float32)
    for got, want in zip(port.allreduce(xs), ref.allreduce(xs)):
        assert isinstance(got, np.ndarray)
        assert got.tobytes() == want.tobytes()
    assert port.last_staging is None


def test_tensors_come_back_where_they_were_with_the_split():
    with rlo_tpu_torch.init("native", world_size=3) as port:
        xs = [torch.arange(6, dtype=torch.float32) + r for r in range(3)]
        outs = port.allreduce(xs)
        assert all(o.device == xs[0].device and o.dtype == torch.float32
                   for o in outs)
        assert torch.equal(outs[1], 3 * torch.arange(6.) + 3)
        st = port.last_staging
        assert sorted(st) == ["protocol_s", "to_device_s", "to_host_s"]
        assert all(v >= 0 for v in st.values())
        # the caller's tensors are left as they were
        assert torch.equal(xs[2], torch.arange(6.) + 2)


@pytest.mark.parametrize("name", HOST)
def test_bfloat16_is_refused_not_cast(name):
    with rlo_tpu_torch.init(name, world_size=2) as port:
        xs = [torch.ones(4, dtype=torch.bfloat16)] * 2
        with pytest.raises(TypeError, match="bfloat16"):
            port.allreduce(xs)
        with pytest.raises(TypeError, match="numpy"):
            port.bcast(0, torch.ones(2, dtype=torch.bfloat16))


# -- init's switch ---------------------------------------------------------

@pytest.mark.parametrize("name", HOST)
def test_init_gives_the_same_facade(name, monkeypatch):
    monkeypatch.delenv("ROOTLESS_BACKEND", raising=False)
    with rlo_tpu.init(name) as ref, rlo_tpu_torch.init(name) as port:
        assert type(port).__name__ == type(ref).__name__
        assert type(port).__module__ == "rlo_tpu_torch.backend"
        assert port.name == ref.name == name
        assert port.world_size == ref.world_size == 4


@pytest.mark.parametrize("name", HOST)
def test_rootless_backend_picks_the_facade(name, monkeypatch):
    monkeypatch.setenv("ROOTLESS_BACKEND", name)
    with rlo_tpu_torch.init(world_size=3) as port:
        assert port.name == name and port.world_size == 3
    # the argument beats the environment
    monkeypatch.setenv("ROOTLESS_BACKEND", "no-such-backend")
    with rlo_tpu_torch.init(name, world_size=2) as port:
        assert port.name == name


def test_unknown_name_lists_the_known(monkeypatch):
    with pytest.raises(ValueError, match="unknown backend 'tpu'") as e:
        rlo_tpu_torch.init("tpu")
    for name in ("cuda", "hybrid", "loopback", "mpi", "native", "shm",
                 "tcp"):
        assert repr(name) in str(e.value)
    monkeypatch.setenv("ROOTLESS_BACKEND", "bogus")
    with pytest.raises(ValueError, match="ROOTLESS_BACKEND"):
        rlo_tpu_torch.init()
    assert sorted(pb._FACTORIES) == sorted(
        set(rb._FACTORIES) - {"tpu"} | {"cuda"})


def test_no_name_and_no_card_raises(monkeypatch):
    """The default is the card: with no name, no $ROOTLESS_BACKEND and no
    card, init raises; it never falls back to a host facade."""
    monkeypatch.delenv("ROOTLESS_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rlo_tpu_torch.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rlo_tpu_torch.init(world_size=2)


def test_process_facades_raise_outside_their_launchers(monkeypatch):
    """shm points at the demo binary; mpi and tcp outside femtompirun /
    tcprun raise as the JAX package's do, naming the port's launchers."""
    for var in ("FEMTOMPI_RANK", "RLO_TCP_RANK", "RLO_TCP_WORLD"):
        monkeypatch.delenv(var, raising=False)
    for name, words in (("shm", "rlo_tpu_torch/native/_build/rlo_demo"),
                        ("mpi", "rlo_tpu_torch/native/_build/femtompirun"),
                        ("tcp", "rlo_tpu_torch/native/tcprun")):
        with pytest.raises(RuntimeError) as want:
            rlo_tpu.init(name)
        with pytest.raises(RuntimeError) as got:
            rlo_tpu_torch.init(name)
        assert type(got.value) is type(want.value)
        assert words in str(got.value)
        assert "rlo_tpu/" not in str(got.value)
