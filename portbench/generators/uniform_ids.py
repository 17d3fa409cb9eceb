"""Packed training rows of token ids drawn uniformly from the vocabulary.

The mix gives ``batch`` rows of ``seq`` tokens a step; every step gets a
fresh batch. The ids come from a ``torch.Generator`` on the device,
seeded from ``--seed``'s token stream, so the same seed gives the same
batches in the same order and every seed the same shapes.
"""

from portbench import common


def inputs(torch, mix, model, seed, device):
    """An endless iterator of (batch, seq) int32 id tensors on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(common.sub_seed(seed, 2))
    while True:
        yield torch.randint(0, model["vocab"], (mix["batch"], mix["seq"]),
                            generator=gen, device=device, dtype=torch.int32)
