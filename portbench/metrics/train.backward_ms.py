"""Stream milliseconds a traced step under the program's
``rlo.train.backward`` span, less the ``rlo.train.recompute`` spans that
autograd runs inside it: the gradients' own work (K4/K5, the GEMMs'
transposes, the glue's backward), idle gaps included."""
from portbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "rlo.train.backward",
                             less="rlo.train.recompute")
