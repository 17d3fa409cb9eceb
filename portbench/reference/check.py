"""The comparisons that decide ``correct``.

Training: the reference follows the program's first checked steps
(three, or two where the mix says so to keep it shorter than the
window) from the same seeded weights and batches, in f32 with TF32 off,
and three numbers are compared, each against its limit in
``limits/<cell>.json``:

  loss_gap    the largest |loss - loss_ref| / loss_ref over the steps;
  grad_gap    the worst leaf's |‖g‖ - ‖g_ref‖| over the larger of
              ‖g_ref‖ and the median leaf's ‖g_ref‖, of step 1's
              gradient as the optimizer got it;
  change_gap  the same of each leaf's change after the checked steps,
              over the leaves whose reference gradient is at least a
              thousandth of the median leaf's.

With ``control`` the reference in float8 (``model.fp8_mm``) is read
the same way, in the program's place: its checked steps against the f32
reference's.
"""

from __future__ import annotations

import statistics

from portbench import common, weights
from portbench.reference import model as ref


def _gap(prog, refv):
    """Worst |prog - ref| / max(|ref|, the median |ref|)."""
    floor = statistics.median(abs(r) for r in refv)
    return max(abs(p - r) / max(abs(r), floor, 1e-30)
               for p, r in zip(prog, refv))


def _follow(torch, m, t, seed, batches, dev, mm):
    """The reference's checked steps: (losses, step-1 gradient norms,
    change norms) by leaf."""
    o = t["optimizer"]
    W = weights.make(m, common.sub_seed(seed, 1), torch.float32, dev)
    leaves = weights.leaves(W)
    live = [p.detach().requires_grad_(True) for p in leaves]
    Wl = weights.tree(m, live)
    opt = ref.AdamW(live, o["lr"], tuple(o["betas"]), o["eps"],
                    o["weight_decay"])
    losses, grads = [], None
    for i, tok in enumerate(batches):
        losses.append(ref.loss_backward(Wl, tok, m, mm))
        if i == 0:
            grads = torch.stack([p.grad.norm() for p in live]).tolist()
        opt.step()
    del opt
    w0 = weights.leaves(weights.make(m, common.sub_seed(seed, 1),
                                     torch.float32, dev))
    change = torch.stack([(p.detach() - p0).norm()
                          for p, p0 in zip(live, w0)]).tolist()
    return losses, grads, change


def _train_numbers(prog, refr):
    (pl, pg, pc), (rl, rg, rc) = prog, refr
    med = statistics.median(rg)
    keep = [i for i, g in enumerate(rg) if g >= 1e-3 * med]
    return {"loss_gap": _gap(pl, rl),
            "grad_gap": _gap(pg, rg),
            "change_gap": _gap([pc[i] for i in keep],
                               [rc[i] for i in keep])}


def train(torch, m, t, seed, batches, prog, dev, limits, control=False):
    ref.no_tf32()
    refr = _follow(torch, m, t, seed, batches, dev, ref.f32_mm)
    got = _train_numbers((prog["loss"], prog["grad"], prog["change"]), refr)
    out = {"checks": {k: {"value": v, "limit": limits[k]}
                      for k, v in got.items()},
           "readings": {"loss": prog["loss"], "loss_ref": refr[0]}}
    if control:
        ctl = _follow(torch, m, t, seed, batches, dev, ref.fp8_mm)
        out["control"] = _train_numbers(ctl, refr)
    return out

