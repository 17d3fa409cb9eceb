"""Tokens trained in all the window's steps over the window (host
clock; the window closes at the end of its last step)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["window_s"]:
        return None
    return ctx["tokens"] / ctx["window_s"]
