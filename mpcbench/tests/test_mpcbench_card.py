"""On the card (marker `cuda`): a short run of a cell is correct, and the
control, the reference in float32 with TF32 matrix products put in the
program's place, is not. Both decide about the card inside a fixture."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from mpcbench import compare
from mpcbench.tests.small import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    out = subprocess.run([sys.executable, "mpcbench/run.py", "--workload", "cen-walk", "--seed",
                          str(2 ** 31 + 11), "--seconds", "4", "--trace", "0"],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["kind"] == card
    assert list(result)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cen-walk"])
def test_the_control_is_not_correct(card, workload, tmp_path):
    seed = 2 ** 31 + 23
    out_file = tmp_path / "control.jsonl"
    out = subprocess.run([sys.executable, "mpcbench/control.py", "--workload", workload,
                          "--seeds", str(seed), "--control-seeds", str(seed), "--seconds", "12",
                          "--out", str(out_file)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out_file.read_text().splitlines()[-1])
    tol = repr(compare.BRANCH_TOL)
    program = row["program"]["values"][tol]
    assert all(program[k] <= compare.LIMITS[k] for k in program)
    control = row["control_tf32"]["values"][tol]
    assert any(control[k] > compare.LIMITS[k] for k in control)
