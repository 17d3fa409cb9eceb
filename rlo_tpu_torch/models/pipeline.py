"""Pipeline parallelism: transformer layers split over a ``pp`` axis,
microbatches streamed stage to stage with ``ppermute``.

The port of ``rlo_tpu/models/pipeline.py``. ``stack_layers`` turns the
per-layer list of ``transformer.init_params`` into leaves stacked over a
leading layer axis, which ``pipeline_pspecs`` splits over ``pp`` (each
stage owns n_layers/pp layers; ``parallel.sharding.shard_tree`` cuts
them); embed and the final norm are whole on every stage (stage 0
embeds, the last stage unembeds). A stage runs its layers through
``transformer.apply_layer`` with positions 0..blk-1, the same layer math
as ``forward``, so GQA and RoPE configs work and attention is the flash
kernel K2 (its backward K4/K5).

Both schedules are explicit loops over the ticks the JAX package's
scans run, with every collective *between* autograd calls and never
inside one (a collective inside a backward waits on the device's one
autograd thread on a ``LocalMesh``):

- GPipe (``pipeline_train_step``): ``fwd_ticks = M + pp - 1`` forward
  ticks, one chain ``ppermute`` a tick; each stage keeps the autograd
  graph of each of its live ticks. Then the mirrored ticks backwards,
  one reverse-chain ``ppermute`` a tick: each makes one
  ``torch.autograd.grad`` of that tick's stage output (the last stage:
  of its loss sum, seeded with 1 / the valid-token count) with respect
  to the stage's weights and its input, seeded with the cotangent
  received from the successor.
- 1F1B (``pipeline_1f1b_train_step``): ``M + 2(pp - 1)`` ticks, each a
  forward and a backward sub-step (two ``ppermute``s). The forward runs
  without a graph and saves the stage *input* in a ring of
  ``min(2pp - 1, M + pp - 1)`` slots; the backward recomputes the block
  from the ring under ``torch.enable_grad()``. Seeds are unnormalised
  (d nll_sum) and every grad is scaled by 1 / the total count at the
  end.

What a stage sends is detached (``LocalAxis.ppermute`` clones the
sender's tensor, and a clone that requires grad would drag the sender's
graph into the receiver's backward); a received stage input is made a
leaf with ``requires_grad_()``. Bubble ticks (no microbatch at this
stage) skip the stage's compute, as host control flow may (their
outputs never reach the loss, and the JAX package masks them), but
still call ``ppermute`` with zeros, so each rank makes the ticks and
permutes a tick that ``pipeline_cost`` gives. The last stage's 1F1B
forward sub-step has no successor and is skipped as well.

The combines the JAX package gets from vma typing are explicit
``all_reduce``s after the backward: embed and ln_f grads summed over
``pp`` (stage 0's embedding and the last stage's head), the loss the
``pp`` sum of the last stage's value; with ``dp_axis`` every grad and
the loss are averaged over it. ``pp_axis``/``dp_axis`` are ``Axis``
objects of ``parallel.mesh`` (a ``LocalMesh`` axis or a ``DistAxis``);
the spec trees name the axis. Dense layers only.
"""

from __future__ import annotations

from typing import Optional

import torch

from rlo_tpu_torch.models.transformer import (TransformerConfig, _rebuild,
                                              _rmsnorm, apply_layer,
                                              embed_tokens,
                                              next_token_targets, nll_sum,
                                              tree_leaves)


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def stack_layers(params: dict) -> dict:
    """``init_params``' per-layer list as stacked (L, ...) leaves (the
    leading axis is what ``pp`` splits)."""
    stacked = _map(lambda *xs: torch.stack(xs), *params["layers"])
    return {"embed": params["embed"], "ln_f": params["ln_f"],
            "stacked": stacked}


def unstack_layers(pparams: dict, n_layers: int) -> dict:
    """Inverse of ``stack_layers`` (the whole tree): layer i's leaves are
    views of the stacked leaves."""
    layers = [_map(lambda x: x[i], pparams["stacked"])
              for i in range(n_layers)]
    return {"embed": pparams["embed"], "ln_f": pparams["ln_f"],
            "layers": layers}


def pipeline_pspecs(pp_axis: Optional[str] = None,
                    cfg: Optional[TransformerConfig] = None) -> dict:
    """``PartitionSpec`` tree of ``stack_layers``' output: the stacked
    layer leaves split over ``pp`` on the layer axis, embed/ln_f whole.
    Pass ``cfg`` so the attention-projection leaves match it (GQA
    configs carry wq/wkv instead of the fused wqkv); without it the tree
    is MHA's."""
    from rlo_tpu_torch.parallel.sharding import PartitionSpec as P
    layer = {
        "ln1": {"g": P(pp_axis, None)},
        "wo": P(pp_axis, None, None),
        "ln2": {"g": P(pp_axis, None)},
        "w1": P(pp_axis, None, None),
        "w2": P(pp_axis, None, None),
    }
    if cfg is not None and cfg.kv_heads != cfg.n_heads:
        layer["wq"] = P(pp_axis, None, None)
        layer["wkv"] = P(pp_axis, None, None, None)
    else:
        layer["wqkv"] = P(pp_axis, None, None, None)
    return {"embed": P(), "ln_f": {"g": P()}, "stacked": layer}


def pipeline_cost(schedule: str, pp: int, n_micro: int) -> dict:
    """The schedules' analytic model, the JAX package's numbers: the
    ticks and permutes a tick each rank runs, the bubble fraction and
    the peak boundary storage in microbatch blocks (GPipe: the scan's
    carry history, M + pp - 1; 1F1B: its ring of saved inputs,
    min(2pp - 1, M + pp - 1), independent of M)."""
    if pp < 1 or n_micro < 1:
        raise ValueError("pp >= 1 and n_micro >= 1 required")
    if schedule == "gpipe":
        fwd = n_micro + pp - 1
        return {"fwd_ticks": fwd, "total_ticks": 2 * fwd,
                "permutes_per_tick": 1,
                "bubble_fraction": (pp - 1) / fwd,
                "peak_boundary_blocks": fwd}
    if schedule == "1f1b":
        ticks = n_micro + 2 * (pp - 1)
        return {"fwd_ticks": ticks, "total_ticks": ticks,
                "permutes_per_tick": 2,
                "bubble_fraction": 2 * (pp - 1) / ticks,
                "peak_boundary_blocks": min(2 * pp - 1, n_micro + pp - 1)}
    raise ValueError(f"no cost model for schedule {schedule!r}")


def _make_stage_fn(cfg: TransformerConfig):
    """Apply this stage's stacked layers to an activation block through
    ``apply_layer`` with positions 0..blk-1 (each microbatch is whole
    sequences)."""
    def stage(stacked_local, x):
        pos = torch.arange(x.shape[1], device=x.device)
        leaves = tree_leaves(stacked_local)
        per_leaf = [t.unbind(0) for t in leaves]
        for i in range(leaves[0].shape[0]):
            layer = _rebuild(stacked_local, iter(u[i] for u in per_leaf))
            x, _aux = apply_layer(x, layer, cfg, pos=pos)
        return x

    return stage


def _head_sums(x, lnf_g, embed, tok):
    """The last stage's loss head on one microbatch: (summed NLL, valid
    count), the logits in f32 from the tied embedding."""
    xn = _rmsnorm(x, lnf_g)
    logits = (xn @ embed.t().to(x.dtype)).float()
    targets, valid = next_token_targets(tok)
    return nll_sum(logits, targets, valid)


class _Plan:
    """What every schedule derives from its arguments."""

    def __init__(self, pparams, tokens, cfg, pp_axis, n_micro):
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "pipeline parallelism supports dense layers only; MoE "
                "(n_experts > 0) trains through models.transformer."
                "train_step instead")
        b, blk = tokens.shape
        if b % n_micro:
            raise AssertionError(f"batch {b} % n_micro {n_micro} != 0")
        self.pp, self.s = pp_axis.size, pp_axis.index
        self.last = self.s == self.pp - 1
        self.M = n_micro
        self.tokens_mb = tokens.reshape(n_micro, b // n_micro, blk)
        self.pos = torch.arange(blk, device=tokens.device)
        self.stage = _make_stage_fn(cfg)
        self.chain = [(i, i + 1) for i in range(self.pp - 1)]
        self.rchain = [(i + 1, i) for i in range(self.pp - 1)]
        emb = pparams["embed"]
        self.zeros = torch.zeros((b // n_micro, blk, cfg.d_model),
                                 dtype=cfg.act_dtype, device=emb.device)
        self.cfg = cfg

    def embed(self, emb, m):
        return embed_tokens(emb, self.tokens_mb[m], self.pos, self.cfg)


def _live(t):
    return t.detach().requires_grad_(True)


def _finish(pparams, grads, loss, lr, dp_axis):
    """The dp mean (when asked) and the SGD update."""
    if dp_axis is not None:
        n = dp_axis.size
        grads = _map(lambda g: dp_axis.all_reduce(g, "sum") / n, grads)
        loss = dp_axis.all_reduce(loss, "sum") / n
    with torch.no_grad():
        new = _map(lambda p, g: p - lr * g.to(p.dtype), pparams, grads)
    return new, loss


def _forward_ticks(plan, pp_axis, W, emb, lnf):
    """GPipe's forward ticks at this stage: {m: (stage input, stage
    output, the head's (NLL sum, count) on the last stage)} for each
    live tick, and the most entries held at once. Under grad mode each
    entry keeps its graph, its input a leaf on stages past the first."""
    tape, peak, recv = {}, 0, plan.zeros
    for t in range(plan.M + plan.pp - 1):
        m, send = t - plan.s, plan.zeros
        if 0 <= m < plan.M:
            x_in = plan.embed(emb, m) if plan.s == 0 else \
                recv.requires_grad_(torch.is_grad_enabled())
            out = plan.stage(W, x_in)
            head = _head_sums(out, lnf, emb, plan.tokens_mb[m]) \
                if plan.last else None
            tape[m] = (x_in, out, head)
            peak = max(peak, len(tape))
            send = out.detach()
        recv = pp_axis.ppermute(send, plan.chain)
    return tape, peak


def _mean_nll(plan, tape, device):
    """(the last stage's mean NLL, its valid count); zeros elsewhere."""
    if not plan.last:
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return zero, zero
    heads = [tape[m][2] for m in range(plan.M)]
    total = torch.stack([c for _, c in heads]).sum()
    return torch.stack([s_m.detach() for s_m, _ in heads]).sum() / total, \
        total


def pipeline_loss(pparams: dict, tokens, cfg: TransformerConfig, pp_axis,
                  n_micro: int):
    """Mean next-token cross-entropy through the pipeline (GPipe's
    forward ticks), the same value on every stage.

    tokens: (batch, blk), whole on every stage (batch % n_micro == 0);
    ``pparams`` this stage's slices (``pipeline_pspecs``). Equals
    ``transformer.loss_fn`` on the same params and tokens up to
    summation order. Runs without a graph: the gradient of the
    pipelined loss is ``pipeline_train_step``'s explicit backward."""
    plan = _Plan(pparams, tokens, cfg, pp_axis, n_micro)
    with torch.no_grad():
        tape, _ = _forward_ticks(plan, pp_axis, pparams["stacked"],
                                 pparams["embed"], pparams["ln_f"]["g"])
        local, _ = _mean_nll(plan, tape, tokens.device)
        return pp_axis.all_reduce(local, "sum")


def pipeline_train_step(pparams: dict, tokens, cfg: TransformerConfig,
                        pp_axis, n_micro: int, lr: float = 1e-2,
                        dp_axis=None, stats: Optional[dict] = None):
    """One SGD step on the GPipe schedule; returns (new stage params,
    loss). Composes with dp (``tokens`` this dp rank's rows). Stage-local
    layer grads stay on their stage; embed/ln_f grads are summed over
    ``pp``. ``stats``, if given, is filled with the schedule's ticks and
    the most stage graphs held at once."""
    plan = _Plan(pparams, tokens, cfg, pp_axis, n_micro)
    s, M, last = plan.s, plan.M, plan.last
    T = M + plan.pp - 1
    W = _map(_live, pparams["stacked"])
    w_leaves = tree_leaves(W)
    emb, lnf = _live(pparams["embed"]), _live(pparams["ln_f"]["g"])
    with torch.enable_grad():
        tape, peak = _forward_ticks(plan, pp_axis, W, emb, lnf)
    local, total = _mean_nll(plan, tape, emb.device)
    seed = 1.0 / total

    # the mirrored ticks: one grad a live tick, cotangents up the chain
    acc = [torch.zeros_like(w) for w in w_leaves]
    g_emb, g_lnf = torch.zeros_like(emb), torch.zeros_like(lnf)
    recv_b = plan.zeros
    for t in reversed(range(T)):
        m, send_b = t - s, plan.zeros
        if 0 <= m < M:
            x_in, out, head = tape.pop(m)
            inputs = list(w_leaves)
            if last:
                inputs += [lnf, emb]
                outputs, seeds = [head[0]], [seed]
            else:
                outputs, seeds = [out], [recv_b]
                if s == 0:
                    inputs.append(emb)
            if s > 0:
                inputs.append(x_in)
            got = torch.autograd.grad(outputs, inputs, seeds)
            for a, g in zip(acc, got):
                a += g
            rest = got[len(w_leaves):]
            if last:
                g_lnf += rest[0]
                g_emb += rest[1]
            elif s == 0:
                g_emb += rest[0]
            if s > 0:
                send_b = rest[-1].detach()
            del x_in, out, head, got, rest
        recv_b = pp_axis.ppermute(send_b, plan.rchain)
    del W, w_leaves

    grads = {"embed": pp_axis.all_reduce(g_emb, "sum"),
             "ln_f": {"g": pp_axis.all_reduce(g_lnf, "sum")},
             "stacked": _rebuild(pparams["stacked"], iter(acc))}
    loss = pp_axis.all_reduce(local, "sum")
    if stats is not None:
        stats.update(schedule="gpipe", ticks=2 * T, fwd_ticks=T,
                     peak_live_graphs=peak)
    return _finish(pparams, grads, loss, lr, dp_axis)


def pipeline_1f1b_train_step(pparams: dict, tokens, cfg: TransformerConfig,
                             pp_axis, n_micro: int, lr: float = 1e-2,
                             dp_axis=None, stats: Optional[dict] = None):
    """One SGD step on the 1F1B schedule; its grads equal the GPipe
    step's up to summation order (same math, another schedule).

    M + 2(pp-1) ticks; tick t at stage s runs the forward of microbatch
    m_f = t - s and the backward of m_b = t - 2(pp-1) + s (each when in
    range). The backward recomputes the stage's block from its saved
    input (a ring of min(2pp - 1, M + pp - 1) slots, the only boundary
    storage) and takes the successor's cotangent off the reverse chain;
    at the last stage m_b == m_f, so the loss seed is computed in place.
    ``stats``, if given, is filled with the ticks, the ring's slots and
    how many of them were written."""
    plan = _Plan(pparams, tokens, cfg, pp_axis, n_micro)
    s, M, last, pp = plan.s, plan.M, plan.last, plan.pp
    S = min(2 * pp - 1, M + pp - 1)
    T = M + 2 * (pp - 1)
    W = _map(_live, pparams["stacked"])
    w_leaves = tree_leaves(W)
    emb, lnf = _live(pparams["embed"]), _live(pparams["ln_f"]["g"])
    acc = [torch.zeros_like(w) for w in w_leaves]
    g_emb, g_lnf = torch.zeros_like(emb), torch.zeros_like(lnf)
    f32 = dict(dtype=torch.float32, device=emb.device)
    loss_s, loss_c = torch.zeros((), **f32), torch.zeros((), **f32)
    ring, written = [None] * S, set()
    recv_f = recv_b = plan.zeros
    for t in range(T):
        # forward sub-step: save the stage input, send the output on
        m_f, send_f = t - s, plan.zeros
        if 0 <= m_f < M:
            with torch.no_grad():
                inp = plan.embed(emb, m_f) if s == 0 else recv_f
                ring[m_f % S] = inp
                written.add(m_f % S)
                if not last:   # the last stage's output goes nowhere
                    send_f = plan.stage(W, inp)

        # backward sub-step: recompute the block, pull the cotangent
        m_b, send_b = t - 2 * (pp - 1) + s, plan.zeros
        if 0 <= m_b < M:
            xin = ring[m_b % S].detach().requires_grad_(True)
            with torch.enable_grad():
                out = plan.stage(W, xin)
                if last:
                    l_s, l_c = _head_sums(out, lnf, emb, plan.tokens_mb[m_b])
                    got = torch.autograd.grad(
                        [l_s], w_leaves + [lnf, emb, xin],
                        [torch.ones_like(l_s)])
                    g_lnf += got[-3]
                    g_emb += got[-2]
                    loss_s += l_s.detach()
                    loss_c += l_c
                else:
                    got = torch.autograd.grad([out], w_leaves + [xin],
                                              [recv_b])
            for a, g in zip(acc, got):
                a += g
            dx_in = got[-1]
            if s == 0:
                # stage 0: pull the input cotangent through the embedding
                with torch.enable_grad():
                    (d_emb,) = torch.autograd.grad(
                        [plan.embed(emb, m_b)], [emb], [dx_in])
                g_emb += d_emb
            send_b = dx_in.detach()
            del xin, out, got, dx_in
        recv_f = pp_axis.ppermute(send_f, plan.chain)
        recv_b = pp_axis.ppermute(send_b, plan.rchain)
    del W, w_leaves, ring

    zero = torch.zeros_like(loss_c)
    total_c = torch.clamp(
        pp_axis.all_reduce(loss_c if last else zero, "sum"), min=1.0)
    scale = 1.0 / total_c
    grads = {"embed": pp_axis.all_reduce(g_emb, "sum") * scale,
             "ln_f": {"g": pp_axis.all_reduce(g_lnf, "sum") * scale},
             "stacked": _rebuild(pparams["stacked"],
                                 iter(a * scale for a in acc))}
    loss = pp_axis.all_reduce(loss_s if last else zero, "sum") / total_c
    if stats is not None:
        stats.update(schedule="1f1b", ticks=T, fwd_ticks=T, ring_slots=S,
                     ring_written=len(written), peak_live_graphs=1)
    return _finish(pparams, grads, loss, lr, dp_axis)
