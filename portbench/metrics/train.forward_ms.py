"""Stream milliseconds a traced step under the program's
``rlo.train.forward`` span: the loss's forward (embedding, layers, final
norm, head and NLL), idle gaps included, by the port's own span
timing."""
from portbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "rlo.train.forward")
