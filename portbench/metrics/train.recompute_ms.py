"""Stream milliseconds a traced step under the program's
``rlo.train.recompute`` spans: remat's second forward of each layer,
which autograd runs inside the backward, idle gaps included."""
from portbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "rlo.train.recompute")
