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

The engine-state helpers (``engine_state_dict``, ``load_engine_state``,
``save_engine_state``, ``load_engine_state_file``) are copies of the JAX
module's, on the port's ``ProgressEngine``: the JSON schema is the same,
so a snapshot of either package's engine loads onto the other's.
"""

from __future__ import annotations

import base64
import json
import os
import re
import shutil
from typing import List, Optional

import numpy as np
import torch

from rlo_tpu_torch.wire import Tag

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


# ---------------------------------------------------------------------------
# Progress-engine snapshot/restore (host-side, quiesced engines only)
# ---------------------------------------------------------------------------

def engine_state_dict(engine) -> dict:
    """Snapshot a quiesced ProgressEngine's durable state.

    Requires the engine to be idle (no outbound work in flight) and not
    mid-consensus — an own proposal awaiting votes or a relayed proposal
    awaiting subtree votes cannot be checkpointed, because the votes
    would arrive at a process that no longer exists; complete or drain
    the round first (the reference's quiesce-then-teardown contract,
    rootless_ops.c:1606-1647). Delivered-but-unpicked messages ARE
    captured (and restored), so applications resume with their pickup
    queue intact.
    """
    from rlo_tpu_torch.engine import ReqState

    if not engine.idle():
        raise RuntimeError(
            "engine has in-flight messages; drain before checkpointing")
    p = engine.my_own_proposal
    if p.state == ReqState.IN_PROGRESS or engine.queue_iar_pending:
        raise RuntimeError(
            "engine is mid-consensus (own proposal awaiting votes or "
            "relayed proposals pending); complete the round before "
            "checkpointing")
    pickup = [{"tag": m.tag, "origin": m.frame.origin, "pid": m.frame.pid,
               "vote": m.frame.vote,
               "data": base64.b64encode(m.frame.payload).decode()}
              for m in engine.queue_pickup]
    return {
        "rank": engine.rank,
        "world_size": engine.world_size,
        "sent_bcast_cnt": engine.sent_bcast_cnt,
        "recved_bcast_cnt": engine.recved_bcast_cnt,
        "total_pickup": engine.total_pickup,
        "proposal": {"pid": p.pid, "state": int(p.state), "vote": p.vote,
                     "votes_needed": p.votes_needed,
                     "votes_recved": p.votes_recved},
        # generation counter: a restored engine must never reissue a
        # pre-snapshot round generation (stale in-flight votes could
        # otherwise match a post-restore round)
        "gen_next": engine._gen_next,
        # exactly-once broadcast state: the seq counter (a restored
        # engine must never reissue a pre-snapshot seq — peers
        # remembering it as seen would silently drop the fresh
        # broadcast), the per-origin seen map (so a restored engine
        # cannot re-deliver a pre-snapshot broadcast a survivor
        # re-floods at it), and the recent-frame log (so it can still
        # plug holes for traffic it forwarded pre-snapshot)
        "bcast_seq": engine._bcast_seq,
        "seen_bcast": {str(o): [ent[0], sorted(ent[1])]
                       for o, ent in engine._seen_bcast.items()},
        "recent_bcasts": [[tag, base64.b64encode(raw).decode()]
                          for tag, raw in engine._recent_bcasts],
        # ARQ link state: a restored engine must never reissue a
        # pre-snapshot link seq (peers remembering it as seen would
        # silently drop the fresh frame), and must keep its receive
        # windows so a peer's retransmit of a pre-snapshot frame is
        # still recognized as a duplicate. The retransmit queue itself
        # is empty by construction (idle() requires arq_unacked()==0).
        "arq_tx_seq": {str(d): s for d, s in engine._tx_seq.items()},
        "arq_rx_seen": {str(s): [ent[0], sorted(ent[1])]
                        for s, ent in engine._rx_seen.items()},
        "pickup": pickup,
    }


def load_engine_state(engine, state: dict) -> None:
    """Re-apply a snapshot onto a freshly constructed engine of the same
    rank/world shape."""
    if (state["rank"], state["world_size"]) != (engine.rank,
                                               engine.world_size):
        raise ValueError(
            f"snapshot is for rank {state['rank']}/{state['world_size']}, "
            f"engine is rank {engine.rank}/{engine.world_size}")
    from rlo_tpu_torch.engine import ReqState, _Msg
    from rlo_tpu_torch.wire import Frame

    engine.sent_bcast_cnt = state["sent_bcast_cnt"]
    engine.recved_bcast_cnt = state["recved_bcast_cnt"]
    engine.total_pickup = state["total_pickup"]
    p = engine.my_own_proposal
    snap = state["proposal"]
    if ReqState(snap["state"]) == ReqState.IN_PROGRESS:
        # engine_state_dict can only emit settled states — an
        # IN_PROGRESS snapshot is corrupt and would wedge the engine
        raise ValueError(
            "corrupt snapshot: proposal state IN_PROGRESS cannot have "
            "been captured from a quiesced engine")
    p.pid, p.vote = snap["pid"], snap["vote"]
    p.state = type(p.state)(snap["state"])
    p.votes_needed, p.votes_recved = snap["votes_needed"], snap["votes_recved"]
    # never rewind below the incarnation base: a restarted process
    # that bumped its incarnation BEFORE restoring a pre-crash
    # snapshot would otherwise reissue its dead life's (pid, gen)
    # and bcast seqs, which peers' dedup windows silently swallow
    from rlo_tpu_torch.engine import INCARNATION_SHIFT
    inc_base = engine.incarnation << INCARNATION_SHIFT
    engine._gen_next = max(state.get("gen_next", engine._gen_next),
                           inc_base + 1)
    engine._bcast_seq = max(state.get("bcast_seq", engine._bcast_seq),
                            inc_base)
    if "seen_bcast" in state:  # pre-feature snapshots: preserve current
        engine._seen_bcast = {int(o): [ent[0], set(ent[1])]
                              for o, ent in state["seen_bcast"].items()}
    if "recent_bcasts" in state:  # replace, not merge (rollback must not
        engine._recent_bcasts.clear()  # leave post-snapshot frames behind)
        for ent in state["recent_bcasts"]:
            if isinstance(ent, str):  # pre-round-3 snapshot: BCAST-only
                engine._recent_bcasts.append(
                    (int(Tag.BCAST), base64.b64decode(ent)))
            else:
                tag, s = ent
                engine._recent_bcasts.append((int(tag),
                                              base64.b64decode(s)))
    if "arq_tx_seq" in state:  # pre-ARQ snapshots: preserve current
        engine._tx_seq = {int(d): int(s)
                          for d, s in state["arq_tx_seq"].items()}
    if "arq_rx_seen" in state:
        engine._rx_seen = {int(s): [ent[0], set(ent[1])]
                           for s, ent in state["arq_rx_seen"].items()}
    for m in state.get("pickup", []):
        frame = Frame(origin=m["origin"], pid=m["pid"], vote=m["vote"],
                      payload=base64.b64decode(m["data"]))
        engine.queue_pickup.append(
            _Msg(frame=frame, tag=m["tag"], fwd_done=True))


def save_engine_state(path: str, engines) -> None:
    """Write every rank's engine snapshot as one JSON file."""
    snaps = [engine_state_dict(e) for e in engines]
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(snaps, f)


def load_engine_state_file(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)
