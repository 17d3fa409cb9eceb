"""Mutation parity of the port's rlo-sentinel and rlo-model with the
JAX package's: the rlo_sentinel and rlo_model cases of the table in
tests/test_torch_tools_parity.py, which says what parity means."""

from __future__ import annotations

import pytest

from tests.test_torch_tools_parity import (  # noqa: F401 (fixtures)
    PARITY, bases, check_parity, trees)

ENGINES = [c for c in PARITY if c[1] in ("rlo_sentinel", "rlo_model")]


@pytest.mark.parametrize("case", ENGINES, ids=[c[0] for c in ENGINES])
def test_mutation_parity(trees, case):
    check_parity(trees, case)
