"""The output check's control on the card: with the reference in the
precision below the configuration's in the program's place (TF32
extraction, bfloat16 tracking and BA), every cell's check must come out not
correct; the program's own run of the same cell correct. Smaller problems
and shorter windows than the cells', the same widths.

    python3 -m pytest benchmark/test_bm_control.py -q      # on the card
"""
from __future__ import annotations

import pytest
import torch

from benchmark import run as harness

SIZES = {
    "ba-large": {"config": {"problem": {"n_kfs": 16, "n_points": 10000, "n_obs": 100000}}},
    "orb-pipeline": {"traffic": {"check_frames": 2, "check_local_ba": 1}},
    "orb-localize": {"traffic": {"check_frames": 2}},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 matmuls exist only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_and_program_passes(card, workload):
    args = (workload, 2 ** 31 + 41, 8.0, False)
    control = harness.run_cell(*args, device=card, overrides=SIZES[workload], control=True)
    assert not control["correct"], control["checks"]
    program = harness.run_cell(*args, device=card, overrides=SIZES[workload])
    assert program["correct"], program["checks"]
