"""PyTorch port, the flow variant of K2 (`ops/fkvel.py::flow_map_cuda`: the
whole-body flow map in one launch) from `csrc/fkvel.cu` compiled by the host
C++ compiler against the host-thread shim of tests/test_torch_kernel_emulation.py,
as tests/test_torch_kernel_emulation_fkvel.py builds the tree pass. Held
against `WholeBodyModel.flow_map_batch(backend="plain")` and against the JAX
package's whole-body flow map, for humanoid23 and toy_biped, f32 and f64, at
the main path's flow-map rows (29 for the RK4 tail, 58 for the top-2 sweep,
174 for the lower ladder), with stance wrenches (both feet loaded) and
walking ones (one foot carries the robot, the other swings with none).

The output starts as NaN, so a value the kernel leaves unwritten fails the
test, and shared memory starts as NaN bytes, so does a read of anything no
lane wrote. The test says nothing about speed or about what `nvcc` accepts:
the card tier (tests/test_torch_cuda.py) covers that.

Tolerances as tests/test_torch_fkvel.py holds the flow map: f32 rtol 2e-4,
atol 2e-5; f64 1e-10. Both references run in float64 on the inputs as the
kernel gets them (rounded to float32 for the f32 cases), so a case measures
the kernel's own rounding: with the wrenches of a standing robot, the plain
version's own float32 rounding alone reaches 0.94 of that tolerance on one
toy_biped element (the kernel's 0.35), and a float32 reference would hold the
kernel to the sum of both."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import DTYPES, assert_close, jax_wb, port_wb, to_numpy
from tests.test_torch_kernel_emulation import build_host_library
from tests.test_torch_kernel_emulation_fkvel import EDITS, HOST_LAUNCH, LAUNCH
from wb_humanoid_mpc_tpu_torch.ops import fkvel

FLOW_TOL = {"f64": dict(rtol=1e-10, atol=1e-10), "f32": dict(rtol=2e-4, atol=2e-5)}
ROWS = (29, 58, 174)
CASES = [(robot, dtype, rows, wrenches) for robot in ("humanoid23", "toy_biped")
         for dtype in ("f32", "f64") for rows in ROWS for wrenches in ("stance", "walk")]


def _case_id(case):
    return "-".join(map(str, case))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The flow variant's C entry points, built from csrc/fkvel.cu for the host."""
    return build_host_library(tmp_path_factory.mktemp("k2_flow_host"), "fkvel.cu", EDITS, LAUNCH,
                              HOST_LAUNCH, ("wbmpc_fkvel_flow_f32", "wbmpc_fkvel_flow_f64"))


@functools.lru_cache(maxsize=None)
def _inputs(robot: str, wrenches: str):
    """(xs, us) of max(ROWS) rows near a standing pose: the smaller cases take
    the first rows. Stance: each foot about half the weight; walk: the left
    foot all of it, the right none."""
    model = port_wb(robot)[1]
    rng = np.random.default_rng(len(robot) + len(wrenches))
    B, nq, n_j = max(ROWS), model.robot.nq, model.robot.n_joints
    q = np.concatenate([rng.normal(size=(B, 2)) * 0.5, 0.75 + rng.normal(size=(B, 1)) * 0.03,
                        rng.normal(size=(B, 3)) * 0.1, rng.normal(size=(B, n_j)) * 0.3], 1)
    v = rng.normal(size=(B, nq)) * 0.5
    weight = model.robot.total_mass * model.robot.gravity
    share = (0.5, 0.5) if wrenches == "stance" else (1.0, 0.0)
    us = [np.concatenate([rng.normal(size=(B, 2)) * 5.0 * s,
                          s * weight + rng.normal(size=(B, 1)) * 10.0 * s,
                          rng.normal(size=(B, 3)) * 2.0 * s], 1) for s in share]
    us = np.concatenate(us + [rng.normal(size=(B, n_j)) * 3.0], 1)
    return np.concatenate([q, v], 1), us


def _as_given(dtype: str, *arrays):
    """The arrays as the kernel gets them in `dtype`, back in float64."""
    npdt = np.float32 if dtype == "f32" else np.float64
    return tuple(np.asarray(a, dtype=npdt).astype(np.float64) for a in arrays)


def _kernel(lib, robot: str, dtype: str, xs, us):
    model = port_wb(robot)[1]
    r = model.robot
    tdt = DTYPES[dtype][1]
    xt, ut = torch.as_tensor(xs, dtype=tdt), torch.as_tensor(us, dtype=tdt)
    joints, geo, n_levels = fkvel._tables(r, torch.device("cpu"), tdt)
    contacts, dyn = fkvel._flow_tables(model, torch.device("cpu"), tdt)
    out = torch.full_like(xt, float("nan"))
    fn = lib.wbmpc_fkvel_flow_f32 if dtype == "f32" else lib.wbmpc_fkvel_flow_f64
    code = fn(xt.data_ptr(), ut.data_ptr(), joints.data_ptr(), geo.data_ptr(), float(r.gravity),
              contacts.data_ptr(), dyn.data_ptr(), out.data_ptr(), xs.shape[0], r.n_joints,
              n_levels, len(model.contact_frames), None)
    assert code == 0
    return out.numpy()


@functools.lru_cache(maxsize=None)
def _jax_flow(robot: str, dtype: str, wrenches: str):
    """The JAX package's flow map (`vmap(flow_map)`) in float64 on every row
    of _inputs as the kernel gets them in `dtype`."""
    jm = jax_wb(robot)[1]
    xs, us = _as_given(dtype, *_inputs(robot, wrenches))
    fn = jax.jit(lambda t, x, u: jm.flow_map_batch(t, x, u, backend="xla"))
    return np.asarray(fn(jnp.zeros(xs.shape[0]), jnp.asarray(xs), jnp.asarray(us)))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_flow_matches_plain(emulated, case):
    robot, dtype, rows, wrenches = case
    xs, us = (a[:rows] for a in _inputs(robot, wrenches))
    ref = port_wb(robot)[1].flow_map_batch(
        None, *(torch.as_tensor(a) for a in _as_given(dtype, xs, us)), backend="plain")
    assert_close(_kernel(emulated, robot, dtype, xs, us), to_numpy(ref), **FLOW_TOL[dtype],
                 what=f"{_case_id(case)} vs plain")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_flow_matches_jax(emulated, case):
    robot, dtype, rows, wrenches = case
    xs, us = (a[:rows] for a in _inputs(robot, wrenches))
    assert_close(_kernel(emulated, robot, dtype, xs, us),
                 _jax_flow(robot, dtype, wrenches)[:rows], **FLOW_TOL[dtype],
                 what=f"{_case_id(case)} vs JAX")


def test_emulated_flow_refuses_bad_launch_geometry(emulated):
    """No row, no joint, no level, more levels than joints, or a negative
    number of contacts: refused."""
    model = port_wb("toy_biped")[1]
    r = model.robot
    xs = torch.zeros(2, model.state_dim, dtype=torch.float64)
    us = torch.zeros(2, model.input_dim, dtype=torch.float64)
    out = torch.empty_like(xs)
    joints, geo, n_levels = fkvel._tables(r, torch.device("cpu"), torch.float64)
    contacts, dyn = fkvel._flow_tables(model, torch.device("cpu"), torch.float64)
    for B, n_j, levels, n_c in ((0, r.n_joints, n_levels, 2), (2, 0, n_levels, 2),
                                (2, r.n_joints, 0, 2), (2, r.n_joints, r.n_joints + 1, 2),
                                (2, r.n_joints, n_levels, -1)):
        code = emulated.wbmpc_fkvel_flow_f64(xs.data_ptr(), us.data_ptr(), joints.data_ptr(),
                                             geo.data_ptr(), 9.81, contacts.data_ptr(),
                                             dyn.data_ptr(), out.data_ptr(), B, n_j, levels, n_c,
                                             None)
        assert code != 0
