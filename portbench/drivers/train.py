"""Training cells: ``rlo_tpu_torch.models.transformer.train_step_optim``
with ``torch.optim.AdamW`` over the seeded weights, on the batches of
the mix's generator.

Set-up builds the one training object (the weights and the optimizer)
and drives it through its first ``checked_steps`` steps (three unless
the mix says fewer), which warm every shape and are the steps the
reference follows. The program's readings are taken on the way: each
step's loss, each leaf's first gradient as the optimizer got it (its
``exp_avg`` after step 1 over 1 - beta1) and each leaf's change after
the last checked step, before the next runs. The same object
then runs the window: steps until ``--seconds`` have passed, the window
closing at the end of the last one, so the rate is all tokens over all
the time. A traced run profiles two more steps after the window.
"""

from __future__ import annotations

import gc
import time

from portbench import common, roofline, weights

#: the port's kernel libraries this driver runs, built before set-up
LIBS = ("flash",)


def _leaf_norms(torch, ts):
    return torch.stack([t.float().norm() for t in ts]).tolist()


def _change_norms(torch, m, params_now, seed, dtype, device):
    w0 = weights.make(m, common.sub_seed(seed, 1), dtype, device)
    out = _leaf_norms(torch, [p - p0 for p, p0 in
                              zip(weights.leaves(params_now),
                                  weights.leaves(w0))])
    del w0
    return out


def run(torch, job: dict) -> dict:
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  train_step_optim)
    from rlo_tpu_torch.utils.tracing import annotate
    m, t, seed, dev = job["model"], job["traffic"], job["seed"], job["device"]
    opt_cfg = t["optimizer"]
    pdt = getattr(torch, job["config"]["param_dtype"])
    cfg = TransformerConfig(**m, remat=t["remat"],
                            loss_vocab_chunk=t.get("loss_vocab_chunk"))
    step_fn = job.get("step_fn") or train_step_optim

    params = weights.make(m, common.sub_seed(seed, 1), pdt, dev)
    opt = torch.optim.AdamW(weights.leaves(params), lr=opt_cfg["lr"],
                            betas=tuple(opt_cfg["betas"]),
                            eps=opt_cfg["eps"],
                            weight_decay=opt_cfg["weight_decay"],
                            fused=dev.type == "cuda")
    batches = job["inputs"](torch, t, m, seed, dev)
    checked = []
    prog = {"loss": []}
    for i in range(t.get("checked_steps", 3)):
        tok = next(batches)
        checked.append(tok.clone())
        with annotate("pb.train_step"):
            params, loss = step_fn(params, opt, tok, cfg)
        prog["loss"].append(float(loss))
        if i == 0:
            b1 = opt_cfg["betas"][0]
            # a leaf the optimizer never stepped has no state: nought
            prog["grad"] = [g / (1 - b1) for g in _leaf_norms(
                torch, [opt.state.get(p, {}).get("exp_avg",
                                                 torch.zeros(()))
                        for p in weights.leaves(params)])]
    # the steps' cached blocks go back to the card before the initial
    # weights are made again beside the program's, and that copy's after
    job["free"]()
    prog["change"] = _change_norms(torch, m, params, seed, pdt, dev)
    job["free"]()

    # ---- the window ----------------------------------------------------
    t_open = time.perf_counter()
    setup_s = t_open - job["t_start"]
    steps, walls = 0, []
    while True:
        t0 = time.perf_counter()
        with annotate("pb.train_step"):
            params, loss = step_fn(params, opt, next(batches), cfg)
        job["sync"]()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        steps += 1
        if t1 - t_open >= job["seconds"]:
            break
    window_s = t1 - t_open
    trace = None
    if job["trace"]:
        from portbench.trace import Trace
        tr = Trace()
        tr.start()
        for _ in range(2):
            with annotate("pb.train_step"):
                params, loss = step_fn(params, opt, next(batches), cfg)
        trace = tr.stop()
        trace["steps"] = 2
    job["window_closed"]()

    del params, opt, loss, batches
    gc.collect()
    job["free"]()
    from portbench.reference import check
    checks = check.train(torch, m, t, seed, checked, prog, dev,
                         job["limits"],
                         control=job.get("control", False))
    tokens = steps * t["batch"] * t["seq"]
    ctx = {"kind": "train", "model": m, "traffic": t, "setup_s": setup_s,
           "window_s": window_s, "steps": steps, "tokens": tokens,
           "step_walls": walls, "trace": trace,
           "step_flops": roofline.train_step_flops(m, t["batch"], t["seq"])}
    return {"ctx": ctx, "checks": checks, "attempted": steps, "failed": 0}
