"""Stream milliseconds a traced step under the program's
``rlo.train.optimizer`` span: handing over ``.grad``, the optimizer's
step and clearing ``.grad``, idle gaps included."""
from portbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "rlo.train.optimizer")
