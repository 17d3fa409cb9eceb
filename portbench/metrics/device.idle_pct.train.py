"""The device's idle share of the traced sub-window: 1 - (the union of
its operations' intervals) / (the sub-window's wall time)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
