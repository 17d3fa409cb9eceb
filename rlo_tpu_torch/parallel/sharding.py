"""Partition specs and the per-rank slices of a params or cache tree.

The port's counterpart of ``shard_map``'s ``in_specs``/``out_specs``: a
``PartitionSpec`` names, per dimension of one tensor, the mesh axis that
dimension is split over (or None: whole on every rank), as
``jax.sharding.PartitionSpec`` does. A spec tree has the structure of
the tensor tree it describes (dicts and lists, a ``PartitionSpec`` in
place of each tensor).

``shard_tree`` gives one rank its slices of a full tree, where ``axes``
maps each axis name to that rank's ``Axis`` (its ``size`` and
``index``); ``gather_tree`` puts the ranks' slices back together (the
tests' view of a sharded result). A split dimension must divide by its
axis's size, as under ``shard_map``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Mapping, Optional, Sequence

import torch


class PartitionSpec(tuple):
    """One axis name or None per leading dimension of a tensor;
    dimensions past the spec's length are whole (``PartitionSpec()``
    replicates the tensor)."""

    def __new__(cls, *names: Optional[str]):
        return super().__new__(cls, names)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _slices(t: torch.Tensor, spec: PartitionSpec, axes: Mapping[str, Any]):
    """(dim, start, length) of one rank's block of ``t`` per split dim."""
    if len(spec) > t.dim():
        raise ValueError(f"{spec} has more entries than the tensor's "
                         f"{t.dim()} dimensions")
    out = []
    for dim, name in enumerate(spec):
        if name is None:
            continue
        axis = axes[name]
        if t.shape[dim] % axis.size:
            raise ValueError(f"dimension {dim} of size {t.shape[dim]} does "
                             f"not divide by axis {name!r} of size "
                             f"{axis.size}")
        n = t.shape[dim] // axis.size
        out.append((dim, axis.index * n, n))
    return out


def _map(fn, tree, specs):
    if isinstance(specs, PartitionSpec):
        return fn(tree, specs)
    if isinstance(specs, dict):
        if set(specs) != set(tree):
            raise ValueError(f"spec keys {sorted(specs)} != tree keys "
                             f"{sorted(tree)}")
        return {k: _map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(specs, (list, tuple)):
        if len(specs) != len(tree):
            raise ValueError(f"{len(specs)} specs for {len(tree)} entries")
        return [_map(fn, t, s) for t, s in zip(tree, specs)]
    raise TypeError(f"not a spec tree node: {specs!r}")


def leaf_specs(tree, specs) -> list:
    """The ``PartitionSpec`` of each tensor of ``tree``, in the order of
    ``models.transformer.tree_leaves(tree)`` (dicts by the tree's own key
    order, lists in order), matched to ``specs`` by key."""
    out = []

    def walk(t, s):
        if isinstance(s, PartitionSpec):
            out.append(s)
        elif isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
        elif isinstance(t, (list, tuple)):
            if len(s) != len(t):
                raise ValueError(f"{len(s)} specs for {len(t)} entries")
            for a, b in zip(t, s):
                walk(a, b)
        else:
            raise TypeError(f"no spec for a tensor: {s!r}")
    walk(tree, specs)
    return out


def shard_tree(tree, specs, axes: Mapping[str, Any]):
    """This rank's slices of the full ``tree``: each tensor cut along its
    spec's named dimensions at the rank's index on those axes (``axes``:
    axis name -> ``Axis``). Every slice is a fresh contiguous tensor the
    rank owns (a cache shard is then written in place without touching
    another rank's)."""
    def cut(t, spec):
        for dim, start, n in _slices(t, spec, axes):
            t = t.narrow(dim, start, n)
        return t.clone(memory_format=torch.contiguous_format)
    return _map(cut, tree, specs)


def gather_tree(shards: Sequence, specs, mesh):
    """The full tree from every rank's slices: ``shards[r]`` is the tree
    of rank r of ``mesh`` (a ``LocalMesh``, or anything with its
    ``names``, ``shape`` and ``coords(rank)``). Replicated dimensions
    come from the last rank; the ranks are not checked to agree."""
    def axes(r):
        return {n: SimpleNamespace(size=s, index=i) for n, s, i in
                zip(mesh.names, mesh.shape, mesh.coords(r))}

    sizes = dict(zip(mesh.names, mesh.shape))

    def whole(parts, spec):
        shape = list(parts[0].shape)
        for dim, name in enumerate(spec):
            if name is not None:
                shape[dim] *= sizes[name]
        out = parts[0].new_empty(shape)
        for r, t in enumerate(parts):
            view = out
            for dim, start, n in _slices(out, spec, axes(r)):
                view = view.narrow(dim, start, n)
            view.copy_(t)
        return out

    def walk(parts, spec):
        if isinstance(spec, PartitionSpec):
            return whole(parts, spec)
        if isinstance(spec, dict):
            return {k: walk([p[k] for p in parts], spec[k])
                    for k in parts[0]}
        return [walk([p[i] for p in parts], s) for i, s in enumerate(spec)]

    return walk(list(shards), specs)
