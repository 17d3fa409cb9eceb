"""Every generator gives the same inputs for the same seed, other inputs
for another seed, and the shapes and bounds its mix states."""

import itertools

import torch

from portbench import common

CPU = torch.device("cpu")


def _take(mix_name, seed, n, model):
    mix = common.traffic(mix_name)
    gen = common.generator(mix["generator"])
    return list(itertools.islice(gen.inputs(torch, mix, model, seed, CPU),
                                 n))


def test_uniform_ids_are_deterministic_by_seed_and_in_bounds():
    mix = common.traffic("packed-4k")
    model = {"vocab": 49152}
    big = 2 ** 32 + 7
    a, b = _take("packed-4k", big, 3, model), _take("packed-4k", big, 3,
                                                    model)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert x.shape == (mix["batch"], mix["seq"])
        assert x.dtype == torch.int32
        assert 0 <= int(x.min()) and int(x.max()) < model["vocab"]
    assert not torch.equal(a[0], a[1])          # a fresh batch a step
    c = _take("packed-4k", big + 1, 1, model)
    assert not torch.equal(a[0], c[0])
    assert mix["seq"] <= 4096                   # the sliding window never binds
