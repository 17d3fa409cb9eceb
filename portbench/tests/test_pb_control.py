"""The control, the reference in float8 put in the program's place,
reads well above the program at the same (tiny, CPU) size: at least
three times on one of the cell's numbers. At the cells' own sizes it
runs on the card (``portbench/tools/control.py``); ``test_control_on_card``
runs it there for one seed of the training cell."""

import os
import subprocess
import sys

import pytest

from portbench import common, run
from portbench.tests import tiny


def test_control_reads_far_above_the_program():
    res = run.run_cell("sc2-3b-train-4k", 1234, 2.0, False, device="cpu",
                       overrides=tiny.TRAIN, control=True)
    ratios = [v / max(res["checks"][k]["value"], 1e-12)
              for k, v in res["control"].items()]
    assert max(ratios) >= 3.0, (res["checks"], res["control"])


@pytest.mark.gpu
def test_control_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(common.HERE / "tools" / "control.py"),
         "--workload", "sc2-3b-train-4k", "--seeds", "5", "--seconds", "3"],
        capture_output=True, text=True, timeout=1200,
        env={**os.environ, "PYTHONPATH": str(common.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"control_fails": true' in out.stdout
