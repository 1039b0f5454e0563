"""A saved solve of the benchmark's whole-body cell (`wb-walk`, seed
2147490101, episode 2, step 77): the inputs the program's solve received
there (t0, x0, the shifted warm start, the node params, the multipliers,
float32 as on the card), and the benchmark's plain reference
(`mpcbench/reference/`) answering them in float64.

The solve follows a 12-iteration recovery and ends far from converged (max
|g| about 6.7), where a small error of the LQ solve moves the answer a long
way. There the port's K1 once summed each stage-cost entry and its
products in an order that lost precision in float32, and its policy came
out 4.3e-2 from float64 against a limit of 1.2e-2 (`mpcbench/compare.py`),
where the plain LQ solve in float32 reads 4.3e-4. `tests/test_torch_cuda.py`
holds the graphed program to the limit there; `tests/test_torch_wb_reference.py`
the port's eager path on the CPU."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mpcbench import compare, harness
from mpcbench.reference.mpc.runtime import Answer

SAVED = Path(__file__).resolve().parent / "data" / "wb_walk_solve_2147490101_e2s77.npz"
FILES = ("urdf", "task", "reference", "gait")


def cell() -> harness.Cell:
    return harness.Cell(harness.load_benchmark(), "wb-walk")


def files(c: harness.Cell) -> list[str]:
    return [str(c.path(c.config[k])) for k in FILES]


def inputs(traj_cls, params_cls, dtype, device) -> tuple:
    """(t0, x0, warm start, node params, multipliers) of the saved solve as
    `traj_cls` and `params_cls` tensors in `dtype` on `device`."""
    s = np.load(SAVED)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    params = params_cls(*(t(s["p_" + f]) for f in params_cls._fields))
    return (float(s["t0"]), t(s["x0"]), traj_cls(xs=t(s["xs"]), us=t(s["us"])), params,
            t(s["lam"]))


def iterations() -> int:
    return int(np.load(SAVED)["iterations"])


def answer(sol) -> Answer:
    return Answer(xs=sol.traj.xs.double().cpu().numpy(), us=sol.traj.us.double().cpu().numpy(),
                  g_norm=float(sol.g_norm), step_size=float(sol.step_size), recovery=False)


def reference_answer(device) -> Answer:
    """The plain reference's answer in float64 on `device` to the saved
    inputs (float32 values, taken as float64)."""
    from mpcbench.reference.ocp.wb_ocp import WBNodeParams
    from mpcbench.reference.solver.transcription import Trajectory

    c = cell()
    ref = compare.reference_for(c, torch.device(device), torch.float64)
    with torch.no_grad():
        sol = ref.runtime.solve_fn(*inputs(Trajectory, WBNodeParams, torch.float64, device))
    return answer(sol)


def gap(sol, ref: Answer) -> float:
    """The gap of the port's solution `sol` against the reference's answer,
    as `mpcbench/compare.py` measures a policy."""
    return compare.answer_gap(answer(sol), ref)
