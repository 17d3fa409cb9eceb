"""Seconds this process spent in ``nvcc`` building the port's kernels,
as the program counts them (``kernels.build.build_stats``): the cold
share of ``setup_s``, 0 where every library was built before."""


def read(ctx):
    from rlo_tpu_torch.kernels import build
    stats = getattr(build, "build_stats", None)
    if stats is None:
        return None
    return sum(s["nvcc_s"] for s in stats().values())
