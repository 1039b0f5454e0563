"""PyTorch port, K2's CUDA source on the CPU: `csrc/fkvel.cu` compiled by the
host C++ compiler against the host-thread shim of
tests/test_torch_kernel_emulation.py (a `std::thread` per CUDA thread, block
barriers as `std::barrier`, shared memory filled with NaN bytes), then held
against the plain version and the Pallas kernel in interpret mode, for
humanoid23 (7 tree levels, 23 joints) and toy_biped (6 levels, 12 joints).

Batch sizes 1, 7, 28 (the main path) and 130, one block per element. The
outputs start as NaN, so a value the kernel leaves unwritten fails the test,
as does a read of shared memory no lane wrote.
The test says nothing about speed or about what `nvcc` accepts: the card
tier (tests/test_torch_cuda.py) covers that.

Tolerances as tests/test_torch_fkvel.py: f32 atol 2e-6, f64 atol 1e-12."""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import DTYPES, assert_close, jax_mode, jax_wb, port_wb, to_numpy
from tests.test_torch_kernel_emulation import build_host_library
from wb_humanoid_mpc_tpu.ops.fkvel import pallas_fkvel
from wb_humanoid_mpc_tpu_torch.ops import fkvel

FK_TOL = {"f64": dict(rtol=0.0, atol=1e-12), "f32": dict(rtol=0.0, atol=2e-6)}

# (what the card runs, what the host runs instead)
EDITS = (
    ("#include <cuda_runtime.h>", '#include "emu_shim.h"'),
    ('asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n" ::"r"(d), "l"(src),\n'
     '               "n"(static_cast<int>(sizeof(T))));', "(void)d; *dst = *src;"),
    ('asm volatile("cp.async.commit_group;\\n" ::);', ";"),
    ('asm volatile("cp.async.wait_group 0;\\n" ::: "memory");', ";"),
    ("extern __shared__ __align__(16) unsigned char smem_raw[];",
     "unsigned char* smem_raw = emu_smem;"),
)
LAUNCH = re.compile(r"fkvel_kernel<T><<<B, kThreads, smem, "
                    r"static_cast<cudaStream_t>\(stream\)>>>\(")
CASES = [(robot, dtype, B) for robot in ("humanoid23", "toy_biped") for dtype in ("f32", "f64")
         for B in (1, 7, 28, 130)]


def _case_id(case):
    return f"{case[0]}-{case[1]}-B{case[2]}"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K2's C entry points, built from csrc/fkvel.cu for the host."""
    return build_host_library(tmp_path_factory.mktemp("k2_host"), "fkvel.cu", EDITS, LAUNCH,
                              "emu_launch(fkvel_kernel<T>, B, kThreads, smem, ",
                              ("wbmpc_fkvel_f32", "wbmpc_fkvel_f64"))


def _inputs(robot: str, B: int):
    rng = np.random.default_rng(B + len(robot))
    nq = port_wb(robot)[1].robot.nq
    return rng.normal(size=(B, nq)) * 0.3, rng.normal(size=(B, nq)) * 0.5


def _kernel(lib, robot: str, dtype: str, q, v):
    """The emulated kernel's packed outputs (R, p, vb, axes, E) as numpy."""
    r = port_wb(robot)[1].robot
    tdt = DTYPES[dtype][1]
    qt, vt = torch.as_tensor(q, dtype=tdt), torch.as_tensor(v, dtype=tdt)
    joints, geo, n_levels = fkvel._tables(r, torch.device("cpu"), tdt)
    outs = fkvel._outputs(q.shape[0], r.n_bodies, r.n_joints, qt)
    for o in outs:
        o.fill_(float("nan"))
    fn = lib.wbmpc_fkvel_f32 if dtype == "f32" else lib.wbmpc_fkvel_f64
    code = fn(qt.data_ptr(), vt.data_ptr(), joints.data_ptr(), geo.data_ptr(), float(r.gravity),
              *(o.data_ptr() for o in outs), q.shape[0], r.n_joints, n_levels, None)
    assert code == 0
    return to_numpy(outs)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_fkvel_matches_plain(emulated, case):
    robot, dtype, B = case
    q, v = _inputs(robot, B)
    tdt = DTYPES[dtype][1]
    fk, vb = fkvel.fkvel_plain(port_wb(robot)[1].robot, torch.as_tensor(q, dtype=tdt),
                               torch.as_tensor(v, dtype=tdt))
    ref = (fk.R, fk.p, torch.stack([vb.v_o, vb.omega, vb.a_o, vb.domega], 2), fk.joint_axis_w,
           fk.E_base)
    assert_close(_kernel(emulated, robot, dtype, q, v), to_numpy(ref), **FK_TOL[dtype],
                 what=f"{_case_id(case)} vs plain")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_fkvel_matches_pallas(emulated, case):
    robot, dtype, B = case
    q, v = _inputs(robot, B)
    jdt = DTYPES[dtype][0]
    with jax_mode(dtype):
        ref = to_numpy(pallas_fkvel(jax_wb(robot)[1].robot, jnp.asarray(q, dtype=jdt),
                                    jnp.asarray(v, dtype=jdt), interpret=True))
    assert_close(_kernel(emulated, robot, dtype, q, v), ref, **FK_TOL[dtype],
                 what=f"{_case_id(case)} vs Pallas interpret")


def test_emulated_fkvel_refuses_bad_launch_geometry(emulated):
    """No element, no level, or more levels than joints: refused."""
    r = port_wb("toy_biped")[1].robot
    q = torch.zeros(2, r.nq, dtype=torch.float64)
    joints, geo, n_levels = fkvel._tables(r, torch.device("cpu"), torch.float64)
    outs = fkvel._outputs(2, r.n_bodies, r.n_joints, q)
    for B, levels in ((0, n_levels), (2, 0), (2, r.n_joints + 1)):
        code = emulated.wbmpc_fkvel_f64(q.data_ptr(), q.data_ptr(), joints.data_ptr(),
                                        geo.data_ptr(), 9.81, *(o.data_ptr() for o in outs), B,
                                        r.n_joints, levels, None)
        assert code != 0
