"""Buffers and trees between numpy (the JAX package's currency) and torch.

What crosses from the JAX package is numpy: each rank's array for the
collective facade, and for the model the params tree
(``jax.tree.map(np.asarray, params)``: nested dicts and lists of
arrays) and the per-layer KV cache (a list of {"k", "v"[, "ks", "vs"]}
dicts). ``ml_dtypes.bfloat16`` arrays cross as their 16 bits (numpy has
no bfloat16 of its own), so ``ml_dtypes`` is imported only when a
bfloat16 tensor goes back to numpy.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def from_numpy(xs: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """One fresh tensor on ``device`` per array (never a view of the
    caller's memory)."""
    out = []
    for x in xs:
        a = np.array(x, copy=True, order="C")
        if _is_bf16(a):
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out.append(t.to(device))
    return out


def to_numpy(ts: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """One numpy array per tensor; bfloat16 comes back as
    ``ml_dtypes.bfloat16``."""
    out = []
    for t in ts:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            out.append(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        else:
            out.append(t.numpy())
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree: Any, device) -> Any:
    """The JAX package's params tree (dicts and lists of numpy arrays)
    as the port's: the same tree of fresh tensors on ``device``."""
    return _tree_map(lambda a: from_numpy([a], device)[0], tree)


def params_to_numpy(tree: Any) -> Any:
    """The port's params tree as numpy arrays, the same structure."""
    return _tree_map(lambda t: to_numpy([t])[0], tree)


def cache_from_numpy(cache: Sequence[dict], device) -> List[dict]:
    """A per-layer KV cache list ({"k", "v"[, "ks", "vs"]} of numpy
    arrays) as tensors on ``device``."""
    return params_from_numpy(list(cache), device)


def cache_to_numpy(cache: Sequence[dict]) -> List[dict]:
    """The port's per-layer KV cache as numpy arrays."""
    return params_to_numpy(list(cache))
