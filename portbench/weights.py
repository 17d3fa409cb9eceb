"""Seeded weights in the port's parameter layout, made on the device.

The tree is ``rlo_tpu_torch.models.transformer.init_params``' (GQA
layout: ``wq`` (d, d), ``wkv`` (d, 2, kv_heads * head_dim), ``wo``,
``w1`` (d, d_ff), ``w2`` (d_ff, d), norm gains, ``embed`` (vocab, d)
tied with the head) with its init scales (the output projections damped
by 1 / sqrt(2 L)), but made here: one ``randn``
call from a ``torch.Generator`` on the device fills one flat buffer in
the dtype the cell runs, and each leaf is a scaled view of it. The same
seed gives the same bits, so the reference can make them again.
"""

from __future__ import annotations

from typing import List, Tuple


def leaf_specs(m: dict) -> List[Tuple[tuple, tuple, float]]:
    """(path, shape, scale) of every leaf in tree order; scale 0 marks a
    norm gain (ones)."""
    d, f, L = m["d_model"], m["d_ff"], m["n_layers"]
    hd = d // m["n_heads"]
    kvh = m.get("n_kv_heads") or m["n_heads"]
    damp = 2 * L
    out = [(("embed",), (m["vocab"], d), 0.02)]
    for i in range(L):
        out += [(("layers", i, "ln1", "g"), (d,), 0.0),
                (("layers", i, "wo"), (d, d), (damp * d) ** -0.5),
                (("layers", i, "ln2", "g"), (d,), 0.0),
                (("layers", i, "wq"), (d, d), d ** -0.5),
                (("layers", i, "wkv"), (d, 2, kvh * hd), d ** -0.5),
                (("layers", i, "w1"), (d, f), d ** -0.5),
                (("layers", i, "w2"), (f, d), (damp * f) ** -0.5)]
    out.append((("ln_f", "g"), (d,), 0.0))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(m: dict, seed: int, dtype, device) -> dict:
    """The parameter tree of model dims ``m`` from ``seed``."""
    import torch
    specs = leaf_specs(m)
    total = sum(_numel(s) for _, s, sc in specs if sc)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree = {"layers": [dict() for _ in range(m["n_layers"])]}
    off = 0
    for path, shape, scale in specs:
        if scale:
            n = _numel(shape)
            leaf = flat[off:off + n].view(shape).mul_(scale)
            off += n
        else:
            leaf = torch.ones(shape, device=device, dtype=dtype)
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else \
                node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree) -> list:
    """Leaves in ``leaf_specs`` order (the port's ``tree_leaves`` order
    is by sorted keys; this is the spec's)."""
    out = [tree["embed"]]
    for layer in tree["layers"]:
        out += [layer["ln1"]["g"], layer["wo"], layer["ln2"]["g"],
                layer["wq"], layer["wkv"], layer["w1"], layer["w2"]]
    out.append(tree["ln_f"]["g"])
    return out


def tree(m: dict, leaf_list) -> dict:
    """The parameter tree over ``leaf_list`` (in ``leaves`` order)."""
    it = iter(leaf_list)
    out = {"embed": next(it), "layers": []}
    for _ in range(m["n_layers"]):
        out["layers"].append({"ln1": {"g": next(it)}, "wo": next(it),
                              "ln2": {"g": next(it)}, "wq": next(it),
                              "wkv": next(it), "w1": next(it),
                              "w2": next(it)})
    out["ln_f"] = {"g": next(it)}
    return out
