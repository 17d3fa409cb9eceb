"""The port's pytree checkpoints against the JAX package's on the CPU.

Files cross-load both ways with the JAX package's ``backend="npz"``
(f32 and int32 leaves bit-exact; bf16 leaves as the same raw 2-byte
records); the counterparts of ``tests/test_checkpoint.py``'s pytree and
manager tests; a resumed training run equals the uninterrupted one bit
for bit, and a save from a pp-4 layout restores onto pp 2.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rlo_tpu.models import transformer as jt
from rlo_tpu.utils import checkpoint as jck
from rlo_tpu_torch.convert import params_from_numpy
from rlo_tpu_torch.models import pipeline as tpl
from rlo_tpu_torch.models import transformer as tt
from rlo_tpu_torch.parallel.mesh import LocalMesh
from rlo_tpu_torch.parallel.sharding import gather_tree, shard_tree
from rlo_tpu_torch.utils import checkpoint as ck

SMALL = dict(vocab=32, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             dtype="float32")


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "layers": [{"g": rng.standard_normal(5)
                                   .astype(np.float32)}
                                  for _ in range(2)]},
            "step": np.int32(7),
            "half": rng.standard_normal((2, 6)).astype(ml_dtypes.bfloat16)}


def _torch_tree(tree):
    """The numpy tree as tensors (bf16 by its bits)."""
    return params_from_numpy(tree, "cpu")


def _same(t: torch.Tensor, a) -> bool:
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes() == \
            a.view(np.int16).tobytes()
    return t.dtype == torch.from_numpy(np.zeros(0, a.dtype)).dtype and \
        t.numpy().tobytes() == a.tobytes()


def _assert_equal_trees(got, want):
    """Same leaf paths, each leaf equal bit for bit (dict order aside)."""
    got, want = ck._flatten_paths(got), ck._flatten_paths(want)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _no_half(tree):
    return {k: v for k, v in tree.items() if k != "half"}


class TestCrossLoad:
    def test_reference_npz_restores_in_the_port(self, tmp_path):
        """A file the JAX package writes (f32, int32 and bf16 leaves)
        restores in the port bit for bit."""
        tree = _np_tree()
        jck.save_pytree(str(tmp_path / "c"), jax.tree.map(jnp.asarray, tree),
                        backend="npz")
        like = jax.tree.map(torch.zeros_like, _torch_tree(tree))
        out = ck.restore_pytree(str(tmp_path / "c"), like=like)
        assert _same(out["params"]["w"], tree["params"]["w"])
        assert _same(out["params"]["layers"][1]["g"],
                     tree["params"]["layers"][1]["g"])
        assert _same(out["step"], tree["step"])
        assert out["half"].dtype == torch.bfloat16
        assert _same(out["half"], tree["half"])

    def test_port_npz_restores_in_the_reference(self, tmp_path):
        tree = _np_tree(1)
        ck.save_pytree(str(tmp_path / "c"), _torch_tree(_no_half(tree)),
                       backend="npz")
        out = jck.restore_pytree(str(tmp_path / "c"), like=_no_half(tree))
        for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(_no_half(tree))):
            assert np.asarray(a).dtype == b.dtype
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()

    def test_both_write_the_same_records(self, tmp_path):
        """Same keys, dtypes and bytes in both files, bf16 as raw |V2."""
        tree = _np_tree(2)
        jck.save_pytree(str(tmp_path / "j"), jax.tree.map(jnp.asarray, tree),
                        backend="npz")
        ck.save_pytree(str(tmp_path / "t"), _torch_tree(tree))
        with np.load(tmp_path / "j" / "state.npz") as j, \
                np.load(tmp_path / "t" / "state.npz") as t:
            assert sorted(j.files) == sorted(t.files)
            assert "['params']['layers'][1]['g']" in t.files
            for k in j.files:
                assert j[k].dtype.str == t[k].dtype.str, k
                assert j[k].tobytes() == t[k].tobytes(), k
            assert t["['half']"].dtype.str == "|V2"

    def test_port_restores_its_own_bf16(self, tmp_path):
        tree = _torch_tree(_np_tree(3))
        ck.save_pytree(str(tmp_path / "c"), tree)
        out = ck.restore_pytree(str(tmp_path / "c"), like=tree)
        assert torch.equal(out["half"].view(torch.int16),
                           tree["half"].view(torch.int16))

    def test_reference_cannot_restore_bf16_npz(self, tmp_path):
        """Quirk of the reference (ROADMAP): its npz restore casts the
        stored |V2 records with ``astype(bfloat16)``, which numpy
        refuses, so it cannot read a bf16 leaf it wrote itself."""
        tree = {"half": jnp.ones((2, 3), jnp.bfloat16)}
        jck.save_pytree(str(tmp_path / "c"), tree, backend="npz")
        with pytest.raises(ValueError, match="No cast function"):
            jck.restore_pytree(str(tmp_path / "c"), like=tree)

    def test_model_params_cross_load(self, tmp_path):
        """The JAX package's params, saved by it, restore in the port
        onto a tree of the port's params, every leaf bit for bit."""
        jc = jt.TransformerConfig(**dict(SMALL, n_kv_heads=2))
        jp = jt.init_params(jax.random.PRNGKey(0), jc)
        jck.save_pytree(str(tmp_path / "c"), jp, backend="npz")
        tc = tt.TransformerConfig(**dict(SMALL, n_kv_heads=2))
        like = tt.init_params(tc, seed=1, device="cpu")
        out = ck.restore_pytree(str(tmp_path / "c"), like=like)
        _assert_equal_trees(
            out, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))

    def test_orbax_refused(self, tmp_path):
        with pytest.raises(ValueError, match="orbax"):
            ck.save_pytree(str(tmp_path / "c"), {"a": torch.ones(2)},
                           backend="orbax")
        with pytest.raises(ValueError, match="orbax"):
            ck.CheckpointManager(str(tmp_path / "m"), backend="orbax")
        with pytest.raises(ValueError, match="unknown backend"):
            ck.save_pytree(str(tmp_path / "c"), {"a": torch.ones(2)},
                           backend="pickle")
        jck.save_pytree(str(tmp_path / "o"), {"a": jnp.ones(2)},
                        backend="orbax")
        with pytest.raises(ValueError, match="'orbax' backend"):
            ck.restore_pytree(str(tmp_path / "o"), like={"a": torch.ones(2)})


class TestPytreeRoundTrip:
    def test_template_sets_dtype_and_kind(self, tmp_path):
        path = str(tmp_path / "c")
        ck.save_pytree(path, {"w": torch.arange(6.0).reshape(2, 3),
                              "n": np.arange(3)})
        out = ck.restore_pytree(path, like={
            "w": torch.zeros(2, 3, dtype=torch.float64),
            "n": np.zeros(3, np.int32)})
        assert out["w"].dtype == torch.float64
        assert torch.equal(out["w"], torch.arange(6.0, dtype=torch.float64)
                           .reshape(2, 3))
        assert isinstance(out["n"], np.ndarray) and out["n"].dtype == np.int32

    def test_v2_onto_other_template_refused(self, tmp_path):
        path = str(tmp_path / "c")
        ck.save_pytree(path, {"h": torch.ones(3, dtype=torch.bfloat16)})
        with pytest.raises(ValueError, match="bfloat16 template"):
            ck.restore_pytree(path, like={"h": torch.ones(3)})

    def test_npz_requires_template(self, tmp_path):
        path = str(tmp_path / "ckpt")
        ck.save_pytree(path, {"a": torch.ones(3)}, backend="npz")
        with pytest.raises(ValueError, match="template"):
            ck._npz_restore(path, None)
        with pytest.raises(ValueError, match="template"):
            ck.restore_pytree(path)

    def test_npz_missing_leaf(self, tmp_path):
        path = str(tmp_path / "ckpt")
        ck.save_pytree(path, {"a": torch.ones(3)}, backend="npz")
        with pytest.raises(KeyError, match="missing"):
            ck.restore_pytree(path, like={"a": torch.ones(3),
                                          "b": torch.ones(2)})


class TestManager:
    def test_retention_and_latest(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path / "run"), max_to_keep=3,
                                   backend="npz")
        for step in (1, 2, 5, 9, 10):
            mgr.save(step, {"x": torch.full((2,), float(step))})
        assert mgr.all_steps() == [5, 9, 10]
        assert mgr.latest_step() == 10
        out = mgr.restore(like={"x": torch.zeros(2)})
        assert out["x"].tolist() == [10.0, 10.0]
        out5 = mgr.restore(step=5, like={"x": torch.zeros(2)})
        assert out5["x"].tolist() == [5.0, 5.0]

    def test_partial_checkpoint_falls_back_to_last_good(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path), backend="npz")
        mgr.save(9, {"w": torch.arange(4.0)})
        partial = os.path.join(str(tmp_path), "step_10")
        os.makedirs(partial)
        with open(os.path.join(partial, "state.npz"), "wb") as f:
            f.write(b"\x00\x01truncated")
        assert mgr.latest_step() == 9
        out = mgr.restore(like={"w": torch.zeros(4)})
        assert torch.equal(out["w"], torch.arange(4.0))
        mgr.save(11, {"w": torch.arange(4.0) + 1})
        assert not os.path.exists(partial)

    def test_overwrite_is_swap_not_delete_first(self, tmp_path):
        path = str(tmp_path / "ckpt")
        ck.save_pytree(path, {"w": torch.arange(3.0)})
        ck.save_pytree(path, {"w": torch.arange(3.0) * 2})
        out = ck.restore_pytree(path, like={"w": torch.zeros(3)})
        assert torch.equal(out["w"], torch.arange(3.0) * 2)
        assert [n for n in os.listdir(str(tmp_path))
                if n.endswith((".tmp-rlo", ".old-rlo"))] == []

    def test_crash_inside_swap_window_recovers(self, tmp_path):
        path = str(tmp_path / "ckpt")
        ck.save_pytree(path, {"w": torch.arange(5.0)})
        os.rename(path, path + ".old-rlo")
        shutil.copytree(path + ".old-rlo", path + ".tmp-rlo")
        out = ck.restore_pytree(path, like={"w": torch.zeros(5)})
        assert torch.equal(out["w"], torch.arange(5.0))
        assert os.path.exists(path)
        mgr = ck.CheckpointManager(str(tmp_path / "m"))
        mgr.save(4, {"w": torch.arange(2.0)})
        os.rename(mgr._step_dir(4), mgr._step_dir(4) + ".tmp-rlo")
        assert mgr.latest_step() == 4
        out = mgr.restore(like={"w": torch.zeros(2)})
        assert torch.equal(out["w"], torch.arange(2.0))

    def test_restore_empty_raises(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path / "empty"))
        with pytest.raises(FileNotFoundError):
            mgr.restore()


class TestResumeTraining:
    def test_resume_matches_uninterrupted(self, tmp_path):
        """4 steps straight against 2, a checkpoint, a restore into a
        fresh tree and 2 more: parameters equal bit for bit."""
        cfg = tt.TransformerConfig(vocab=32, d_model=32, n_heads=2,
                                   n_layers=1, d_ff=64, dtype="float32")
        params = tt.init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))
                                    .astype(np.int32)) for _ in range(4)]
        straight = params
        for b in batches:
            straight, _ = tt.train_step(straight, b, cfg, lr=1e-2)
        half = params
        for b in batches[:2]:
            half, _ = tt.train_step(half, b, cfg, lr=1e-2)
        mgr = ck.CheckpointManager(str(tmp_path / "run"))
        mgr.save(2, {"params": half, "step": 2})
        fresh = tt.init_params(cfg, seed=9, device="cpu")
        restored = mgr.restore(like={"params": fresh, "step": 0})
        assert int(restored["step"]) == 2
        resumed = restored["params"]
        for b in batches[2:]:
            resumed, _ = tt.train_step(resumed, b, cfg, lr=1e-2)
        _assert_equal_trees(resumed, straight)

    @pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
    def test_pp4_save_restores_onto_pp2(self, tmp_path, schedule):
        """A pipelined train state saved from a pp-4 layout (gathered)
        restores onto pp 2, and training continues there bit for bit as
        a run that never saw the checkpoint."""
        cfg = tt.TransformerConfig(**SMALL)
        fn = {"gpipe": tpl.pipeline_train_step,
              "1f1b": tpl.pipeline_1f1b_train_step}[schedule]
        specs = tpl.pipeline_pspecs("pp", cfg)
        stacked = tpl.stack_layers(tt.init_params(cfg, seed=0, device="cpu"))
        tok = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (8, 16)).astype(np.int32))

        def run(pp, tree):
            mesh = LocalMesh((pp,), ("pp",), device="cpu")
            shards = [shard_tree(tree, specs, mesh.axes(r))
                      for r in range(pp)]
            outs = mesh.run(lambda axes, p: fn(p, tok, cfg, axes["pp"], 4,
                                               lr=0.05), shards)
            return gather_tree([o[0] for o in outs], specs, mesh), \
                float(outs[0][1])

        p4, _ = run(4, stacked)
        ck.save_pytree(str(tmp_path / "pp"), p4)
        like = jax.tree.map(torch.zeros_like, stacked)
        restored = ck.restore_pytree(str(tmp_path / "pp"), like=like)
        _assert_equal_trees(restored, p4)
        cont, cont_loss = run(2, restored)
        want, want_loss = run(2, p4)
        assert cont_loss == want_loss
        _assert_equal_trees(cont, want)
