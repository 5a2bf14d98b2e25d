"""On a CUDA card: the control (the reference one precision lower, float32
with TF32 products, in the program's place) fails at least one of each
cell's numbers, and the program passes them, at a size a test run holds:
every cell's configuration cut to 2,048 traits (32 for the permutation
blocks) and 100 shuffles. Skips without a card.

    python -m pytest portbench/tests/test_pb_card.py
"""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.core import spec
from portbench.tests.conftest import WORKLOADS


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_and_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec.cell(workload)
    c.config = dict(c.config, m=min(c.config["m"], 2048))
    c.traffic = dict(c.traffic, kwargs=dict(c.traffic["kwargs"]))
    if "nperms" in c.traffic["kwargs"]:
        c.traffic["kwargs"]["nperms"] = 100
    limits = c.checks["limits"]
    for seed in (1, 2, 3):
        got = control.readings(c, seed, torch.device("cuda", 0), program=True)
        assert all(v <= limits[k] for k, v in got["program"].items()), got
        assert any(v > limits[k] for k, v in got["control"].items()), got
