"""The flash kernels' share of their roofline over the traced training
steps: the bound of the attention they compute, one causal attention a
layer a step, forward and backward, counted once
(``roofline.attention_bound``), over the device time of every kernel of
the port's flash family (``flash_`` in its name: K2 forward, K4 dq and
K5 dk/dv today, whatever they recompute or however they split the
work)."""
from portbench import roofline
from portbench.trace import kernel_seconds


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None:
        return None
    m, t = ctx["model"], ctx["traffic"]
    bound = tr["steps"] * m["n_layers"] * roofline.attention_bound(
        m, t["batch"], t["seq"])
    secs = kernel_seconds(tr, "flash_")
    return 100.0 * bound / secs if secs else None
