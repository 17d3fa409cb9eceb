"""LocalMesh, the port's ranks-as-threads transport: lockstep exchange,
lax.ppermute's zeros for ranks that are no destination, 2-D meshes, and
that a failing or diverging rank ends the run with an error instead of
a hang."""

import threading
import time

import pytest
import torch

from rlo_tpu_torch.parallel.mesh import LocalMesh


def test_ppermute_gives_zeros_to_non_destinations():
    mesh = LocalMesh((4,), ("x",), "cpu", timeout=10)
    outs = mesh.run(lambda axes, v: axes["x"].ppermute(v, [(0, 2), (1, 3)]),
                    [torch.full((3,), float(r + 1)) for r in range(4)])
    assert [o.tolist() for o in outs] == [[0.0] * 3, [0.0] * 3,
                                          [1.0] * 3, [2.0] * 3]


def test_collectives_of_one_axis_of_2d_mesh():
    mesh = LocalMesh((2, 3), ("dcn", "ici"), "cpu", timeout=10)
    assert [mesh.coords(r) for r in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]

    def fn(axes, v):
        ici, dcn = axes["ici"], axes["dcn"]
        return (ici.all_reduce(v, "sum"), dcn.all_gather(v),
                ici.ppermute(v, [(i, (i + 1) % 3) for i in range(3)]),
                (ici.index, dcn.index, ici.size, dcn.size))

    outs = mesh.run(fn, [torch.tensor([float(r)]) for r in range(6)])
    for r, (s, g, p, idx) in enumerate(outs):
        d, i = divmod(r, 3)
        assert s.item() == sum(range(3 * d, 3 * d + 3))
        assert g.reshape(-1).tolist() == [float(i), float(3 + i)]
        assert p.item() == float(3 * d + (i - 1) % 3)
        assert idx == (i, d, 3, 2)


def test_all_to_all_and_all_reduce_ops():
    mesh = LocalMesh((3,), ("x",), "cpu", timeout=10)
    xs = [torch.arange(3, dtype=torch.int32) + 10 * r for r in range(3)]
    outs = mesh.run(lambda axes, v: (axes["x"].all_to_all(v),
                                     axes["x"].all_reduce(v, "min"),
                                     axes["x"].all_reduce(v % 2, "or")), xs)
    for r, (a2a, mn, orr) in enumerate(outs):
        assert a2a.tolist() == [r, 10 + r, 20 + r]
        assert mn.tolist() == [0, 1, 2]
        assert orr.tolist() == [0, 1, 0]  # 0+10r, 1+10r, 2+10r mod 2


def test_error_in_one_rank_aborts_the_others():
    mesh = LocalMesh((4,), ("x",), "cpu", timeout=30)

    def fn(axes, v):
        if axes["x"].index == 2:
            raise KeyError("rank 2 failed")
        return axes["x"].all_gather(v)

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 2 failed"):
        mesh.run(fn, [torch.zeros(1)] * 4)
    assert time.monotonic() - t0 < 10  # aborted, not timed out
    # the mesh is usable again afterwards
    outs = mesh.run(lambda axes, v: axes["x"].all_reduce(v, "sum"),
                    [torch.ones(1)] * 4)
    assert outs[0].item() == 4.0


def test_diverging_ranks_time_out():
    mesh = LocalMesh((2,), ("x",), "cpu", timeout=0.5)

    def fn(axes, v):
        if axes["x"].index == 0:
            return axes["x"].all_gather(v)  # rank 1 never joins
        return v

    with pytest.raises(RuntimeError, match="did not reach a collective"):
        mesh.run(fn, [torch.zeros(1)] * 2)
    assert not any(t.name.startswith("rank") and t.is_alive()
                   for t in threading.enumerate())


def test_default_device_is_the_card(monkeypatch):
    """A LocalMesh asked for no device runs on the card, and without one
    it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalMesh((2,), ("x",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalMesh((2,), ("x",), "cuda")
    assert LocalMesh((2,), ("x",), "cpu").device == torch.device("cpu")


def test_bad_meshes_and_pairs():
    with pytest.raises(ValueError):
        LocalMesh((2, 2, 2, 2), ("a", "b", "c", "d"))
    with pytest.raises(ValueError):
        LocalMesh((2, 2), ("a", "a"))
    mesh = LocalMesh((2,), ("x",), "cpu", timeout=5)
    with pytest.raises(ValueError, match="not a permutation"):
        mesh.run(lambda axes, v: axes["x"].ppermute(v, [(0, 1), (1, 1)]),
                 [torch.zeros(1)] * 2)
    with pytest.raises(ValueError, match="one argument per rank"):
        mesh.run(lambda axes, v: v, [torch.zeros(1)])
