"""``rlo_tpu_torch.tools.twin_bits`` (the plain twins' bits across fresh
processes, a loop of minutes the tests do not run) measures its case."""

from rlo_tpu_torch.tools import twin_bits


def test_case_matches_the_split_test():
    """The tool's inputs are those of the split test's
    ``[scalar-1-1-f32-128]`` case."""
    import numpy as np
    import test_torch_decode_split as split
    (q, kc, vc, p, _, _), _ = split._dense_case("f32", 1, 1, "scalar")
    tq, tk, tv, tpos, _ = twin_bits._case()
    for a, b in ((q, tq), (kc, tk), (vc, tv)):
        np.testing.assert_array_equal(a, b)
    assert int(p) == tpos
