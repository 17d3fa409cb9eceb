"""Model FLOPs of the window's steps (6 per parameter and token plus
causal attention, no recompute) over the window at the bf16 peak."""
from portbench import roofline


def read(ctx):
    if ctx["kind"] != "train" or not ctx["window_s"]:
        return None
    return 100.0 * ctx["steps"] * ctx["step_flops"] / (
        ctx["window_s"] * roofline.PEAK_BF16_FLOPS)
