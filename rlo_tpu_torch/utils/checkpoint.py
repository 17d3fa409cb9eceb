"""Pytree checkpoints: save, restore and stepped retention.

The port of the pytree half of ``rlo_tpu/utils/checkpoint.py``
(``save_pytree``, ``restore_pytree``, ``CheckpointManager``), with the
same crash-atomic swap, ``RLO_BACKEND`` marker and retention:

- A tree (nested dicts, lists and tuples of tensors, numpy arrays or
  numbers: params, optimizer state, a step count) is written as one
  ``state.npz`` under a directory, each leaf keyed by the path string
  ``jax.tree_util.keystr`` gives it (``['layers'][0]['wqkv']``,
  ``['stacked']['w1']``), so a file cross-loads both ways with the JAX
  package's ``backend="npz"``.
- The checkpoint is assembled in a sibling ``.tmp-rlo`` directory, the
  ``RLO_BACKEND`` marker written last, and swapped in by renames; save
  and restore first promote a complete ``.tmp-rlo``/``.old-rlo``
  sibling back into place, so a kill at any point leaves a complete
  checkpoint reachable. A directory without the marker is a crashed
  partial: ``CheckpointManager`` skips and prunes it.
- Only the npz backend exists here (``"auto"`` is npz); ``"orbax"`` is
  refused, and so is restoring a directory whose marker says orbax.
- bfloat16 leaves are stored as raw 2-byte ``|V2`` records, the bytes
  numpy writes for the JAX package's bfloat16 arrays, and a ``|V2``
  leaf is read back as bfloat16 bits where the template's leaf is
  bfloat16.

``restore_pytree(path, like)`` needs the template tree ``like``: each
restored tensor takes its template leaf's dtype and device (restore onto
the card by handing it a template on the card). A checkpoint holds the
whole tree: save the gathered params (``parallel.sharding.gather_tree``)
and cut the restored tree for any layout with ``shard_tree``.

The JAX module's engine-state helpers (``engine_state_dict``,
``load_engine_state`` and the JSON file pair) belong with the engine and
are not ported here.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
BACKENDS = ("npz",)


# ---------------------------------------------------------------------------
# npz backend
# ---------------------------------------------------------------------------

def _flatten_paths(tree, prefix: str = "") -> dict:
    """{keystr path: leaf} in ``jax.tree_util.keystr``'s notation: a dict
    key as ``[repr(key)]``, a list or tuple index as ``[i]``."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flatten_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_paths(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _to_array(leaf) -> np.ndarray:
    """A leaf as numpy; bfloat16 tensors as their raw 2-byte records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _npz_save(path: str, tree) -> None:
    os.makedirs(path, exist_ok=True)
    arrays = {k: _to_array(v) for k, v in _flatten_paths(tree).items()}
    np.savez(os.path.join(path, "state.npz"), **arrays)


def _place(a: np.ndarray, like, key: str):
    """The stored array ``a`` as ``like``'s leaf type, dtype and device."""
    if isinstance(like, torch.Tensor):
        if a.dtype.kind == "V":
            if a.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
                raise ValueError(
                    f"leaf {key} is stored as raw {a.dtype.str} records, "
                    f"which restore only onto a bfloat16 template leaf "
                    f"(the template's is {like.dtype})")
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=like.device, dtype=like.dtype)
    return np.asarray(a).astype(np.asarray(like).dtype)


def _rebuild(like, flat: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, flat, f"{prefix}[{i}]")
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return _place(flat[prefix], like, prefix)


def _npz_restore(path: str, like):
    if like is None:
        raise ValueError("npz backend requires a `like` template tree")
    with np.load(os.path.join(path, "state.npz")) as data:
        flat = dict(data)
    missing = [k for k in _flatten_paths(like) if k not in flat]
    if missing:
        raise KeyError(f"checkpoint at {path} missing leaves {missing}")
    return _rebuild(like, flat)


# ---------------------------------------------------------------------------
# Pytree save/restore
# ---------------------------------------------------------------------------

def _recover_swap(path: str) -> None:
    """Heal a crash inside save_pytree's rename swap: if ``path`` is gone
    but a COMPLETE copy (RLO_BACKEND marker present) sits at the
    .tmp-rlo (newer) or .old-rlo (previous) sibling, promote it back
    into place before anything deletes it."""
    if os.path.exists(path):
        return
    for cand in (path + ".tmp-rlo", path + ".old-rlo"):
        if os.path.exists(os.path.join(cand, "RLO_BACKEND")):
            os.rename(cand, path)
            return


def _backend(backend: str) -> str:
    if backend == "auto":
        return "npz"
    if backend == "orbax":
        raise ValueError("backend 'orbax' is not available in the port: "
                         "use 'npz' (or 'auto')")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def save_pytree(path: str, tree, *, backend: str = "auto") -> None:
    """Write ``tree`` under directory ``path`` (backend 'npz' or 'auto',
    which is npz). Crash-atomic: assembled in a sibling temp directory,
    the RLO_BACKEND marker written last, then swapped in by renames."""
    path = os.path.abspath(path)
    backend = _backend(backend)
    _recover_swap(path)
    tmp, old = path + ".tmp-rlo", path + ".old-rlo"
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    _npz_save(tmp, tree)
    with open(os.path.join(tmp, "RLO_BACKEND"), "w") as f:
        f.write(backend)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def restore_pytree(path: str, like=None):
    """Restore the tree ``save_pytree`` wrote, shaped like the template
    ``like``, each tensor on its template leaf's device and dtype. A
    directory without a marker is read as npz; one whose marker says
    orbax (the JAX package's default where orbax is installed) is
    refused."""
    path = os.path.abspath(path)
    _recover_swap(path)
    marker = os.path.join(path, "RLO_BACKEND")
    backend = open(marker).read().strip() if os.path.exists(marker) \
        else "npz"
    if backend != "npz":
        raise ValueError(f"checkpoint at {path} was written by the "
                         f"{backend!r} backend; the port reads only 'npz' "
                         f"(save with backend='npz')")
    return _npz_restore(path, like)


class CheckpointManager:
    """Stepped checkpoints with retention: ``<directory>/step_<n>``.

    save(step, tree) prunes to the newest ``max_to_keep`` steps on
    success; restore() with no step loads the latest."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 backend: str = "auto"):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.backend = _backend(backend)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> List[int]:
        """Steps with a COMPLETE checkpoint (RLO_BACKEND marker present),
        after promoting complete checkpoints stranded mid-swap."""
        for name in os.listdir(self.directory):
            for suffix in (".tmp-rlo", ".old-rlo"):
                if name.endswith(suffix):
                    _recover_swap(os.path.join(self.directory,
                                               name[:-len(suffix)]))
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, "RLO_BACKEND")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree) -> str:
        path = self._step_dir(step)
        save_pytree(path, tree, backend=self.backend)
        for old in self.all_steps()[:-self.max_to_keep or None]:
            if old != step:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        # sweep crashed partials (unmarked step dirs, leftover swap dirs)
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            stale = name.endswith((".tmp-rlo", ".old-rlo")) or (
                _STEP_RE.match(name)
                and not os.path.exists(os.path.join(full, "RLO_BACKEND")))
            if stale and full != path:
                shutil.rmtree(full, ignore_errors=True)
        return path

    def restore(self, step: Optional[int] = None, like=None):
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        return restore_pytree(self._step_dir(step), like)
