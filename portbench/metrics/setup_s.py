"""Process start until the window opens (host clock), in seconds."""


def read(ctx):
    return ctx["setup_s"]
