"""Device operations (kernels, copies and sets) a traced step: every one
the trace holds, over its steps; the glue count beside the time."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None:
        return None
    return sum(n for _, n in tr["ops"].values()) / tr["steps"]
