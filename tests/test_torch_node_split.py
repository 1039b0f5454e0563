"""The node linearization's split (`solver/transcription.py::node_lq_fused`):
its x-pass differentiates `ocp.fused_node` on `ocp.state_terms(x)` and hands
out the state terms, and its u-pass differentiates `ocp.fused_node` on those
terms held fixed, so the x-only work (the FK pass, M and nle's base rows and
their Cholesky factor, the contact and frame kinematics, the collision and
joint-limit rows) runs once a linearization instead of twice.

The route before the split linearized `ocp.fused_node(t, x, u, p)` whole in
both passes: `_tangent_jacobians` over x and over u. `_Unsplit` gives
`make_node_lq` exactly that route (its state terms are x itself, so both
passes run the whole node), and the split must reproduce it bit for bit in
all 15 outputs: the u-pass drops only operations that never carried a
u-tangent, and every value it keeps is computed by the same operations on
the same inputs. No JAX here.
"""

from __future__ import annotations

import functools
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.core.config import load_reference_config, load_task_config
from wb_humanoid_mpc_tpu_torch.models.centroidal_model import CentroidalModel
from wb_humanoid_mpc_tpu_torch.models.layout import CentroidalLayout
from wb_humanoid_mpc_tpu_torch.models.robot.factory import build_robot_model, mpc_joint_names
from wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp import CentroidalOcp
from wb_humanoid_mpc_tpu_torch.ocp.params import make_centroidal_node_params, weight_comp_input
from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WholeBodyOcp, make_wb_node_params
from wb_humanoid_mpc_tpu_torch.solver.transcription import _tangent_jacobians, make_node_lq

torch.set_num_threads(1)

DTYPES = {"f64": torch.float64, "f32": torch.float32}


@functools.lru_cache(maxsize=None)
def _ocp(robot: str, formulation: str):
    """(cfg, ocp) of an asset robot, built as `interface.py`'s `build_*_mpc` build them."""
    asset = interface.ASSETS / robot
    if formulation == "wb":
        cfg, model = interface.load_wb_model(asset)
        return cfg, WholeBodyOcp(model=model, cfg=cfg)
    urdf, task, ref, _ = interface.mpc_files(asset, "centroidal")
    probe = load_task_config(task, "centroidal", 1, 1)
    layout = CentroidalLayout(n_joints=len(mpc_joint_names(
        urdf, probe.model_settings.fixed_joint_names)))
    cfg = load_task_config(task, "centroidal", layout.state_dim, layout.input_dim)
    model = CentroidalModel(
        robot=build_robot_model(urdf, cfg), layout=layout,
        contact_frames=tuple(cfg.model_settings.contact_names),
        srbm=cfg.centroidal_model_type == 1,
        nominal_joint_angles=tuple(
            load_reference_config(ref, layout.n_joints).default_joint_state.tolist()))
    return cfg, CentroidalOcp(model=model, cfg=cfg)


def _node_lq(ocp, cfg, dtype):
    return make_node_lq(ocp, ocp.model.flow_map, cfg.sqp.dt, ocp.barrier_params("cpu", dtype),
                        sensitivity="node")


def _inputs(ocp, cfg, n: int, dtype, seed: int = 0):
    """make_node_lq's arguments at N = n nodes of the walking schedule
    (double support, left swing, double support, right swing: stance and
    swing rows both), states and inputs perturbed from the nominal ones."""
    model = ocp.model
    rng = np.random.default_rng(seed)
    nx, nu = model.layout.state_dim, model.layout.input_dim
    x0 = np.asarray(cfg.initial_state)
    swing = interface.walking_reference(n)
    x_ref = torch.as_tensor(x0 + 0.01 * rng.normal(size=(n + 1, nx)), dtype=dtype)
    make = make_wb_node_params if isinstance(ocp, WholeBodyOcp) else make_centroidal_node_params
    params = make(ocp, swing, x_ref)
    u_ref = weight_comp_input(model.robot.total_mass, model.robot.gravity,
                              torch.as_tensor(swing.contact_flags[:-1], dtype=dtype), nu)
    return (torch.zeros(n, dtype=dtype),
            torch.as_tensor(x0 + 0.03 * rng.normal(size=(n, nx)), dtype=dtype),
            u_ref + torch.as_tensor(rng.normal(size=(n, nu)), dtype=dtype),
            type(params)(*(a[:-1] for a in params)),
            torch.as_tensor(0.1 * rng.normal(size=(n, ocp.n_eq)), dtype=dtype), 1.0)


class _Unsplit:
    """An OCP whose state terms are the state itself: `make_node_lq` over it
    linearizes `ocp.fused_node` whole in both passes, the route before the
    split."""

    def __init__(self, ocp):
        self.ocp = ocp

    def __getattr__(self, name):
        return getattr(self.ocp, name)

    def state_terms(self, t, x, p):
        return x

    def fused_node(self, t, x, u, p):
        return self.ocp.fused_node(t, x, u, p)


CASES = [(f, r, d) for f in ("wb", "centroidal") for r in ("toy_biped", "humanoid23")
         for d in DTYPES]


@pytest.mark.parametrize("formulation, robot, dtype", CASES,
                         ids=["-".join(c) for c in CASES])
def test_split_linearization_is_bit_identical(formulation, robot, dtype):
    """All 15 outputs of `make_node_lq(..., "node")` (A_d, B_d, k1, Qxx,
    Quu, Qux, qx, qu, cost, g_max, g, Cx, Du, cost_pure, g_sse) equal the
    unsplit route's bit for bit, and `fused_node` on the state terms equals
    `fused_node` on the state."""
    cfg, ocp = _ocp(robot, formulation)
    tdt = DTYPES[dtype]
    args = _inputs(ocp, cfg, 8, tdt)
    got = _node_lq(ocp, cfg, tdt)(*args)
    ref = _node_lq(_Unsplit(ocp), cfg, tdt)(*args)
    assert len(got) == len(ref) == 15
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == tdt and torch.equal(a, b), f"output {i}"
    t, x, u, p = args[:4]
    terms_s, xdot_s = ocp.fused_node(t, ocp.state_terms(t, x, p), u, p)
    terms_x, xdot_x = ocp.fused_node(t, x, u, p)
    assert torch.equal(xdot_s, xdot_x)
    assert all(torch.equal(a, b) for a, b in zip(terms_s, terms_x))


# aten operations that launch no kernel: a view that aten does not tag as
# one, and forward mode's zero tangents (`prims` operations are their shape
# logic on the meta device)
NO_KERNEL = {"_unsafe_view", "_efficientzerotensor"}


class _KernelCount(TorchDispatchMode):
    """The aten operations that launch a kernel, counted by name."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if func.namespace == "aten" and not func.is_view and name not in NO_KERNEL:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def _count(fn) -> int:
    with _KernelCount() as c:
        fn()
    return sum(c.ops.values())


def _u_pass(ocp, fixed, args):
    """The u-pass of `node_lq_fused` with the state part `fixed` (the state
    terms, or x for the whole node)."""
    t, _, u, p = args[:4]

    def fu(u_):
        terms, xdot = ocp.fused_node(t, fixed, u_, p)
        return terms.r, terms.h_log, terms.h_quad, terms.g, xdot

    return _tangent_jacobians(fu, u, u.shape[-1])


@pytest.mark.parametrize("formulation, n, cut, share", [("wb", 29, 900, 0.40),
                                                        ("centroidal", 60, 450, 0.45)])
def test_split_cuts_the_linearization_kernels(formulation, n, cut, share):
    """The kernels of one linearization of `humanoid23` in f32 at the
    cells' horizons (`wb-walk` N 29, `cen-walk` N 60), split against
    unsplit, as this count reads them (torch 2.13 on the CPU; the card runs
    the same aten operations):

    | formulation | u-pass unsplit | u-pass split | whole call unsplit | split |
    |---|---|---|---|---|
    | whole-body, N 29 | 1,566 | 464 (29.6 %) | 5,519 | 4,417 |
    | centroidal, N 60 | 940 | 391 (41.6 %) | 3,050 | 2,501 |

    (Before the split the code's own call read 5,615 and 3,142: the split
    also computes each foot's tilt error and height feedback once.) The
    u-pass must fall below `share` of its unsplit count, and the whole call
    by at least `cut` kernels. The centroidal node's input part is the
    larger share of its u-pass (its generalized velocity, every twist, the
    momentum rates take u), hence its looser share. The split has no
    switch: this count is the record that it engages."""
    cfg, ocp = _ocp("humanoid23", formulation)
    args = _inputs(ocp, cfg, n, torch.float32)
    t, x, _, p = args[:4]
    split, unsplit = _node_lq(ocp, cfg, torch.float32), _node_lq(_Unsplit(ocp), cfg,
                                                                  torch.float32)
    s = ocp.state_terms(t, x, p)
    u_split = _count(lambda: _u_pass(ocp, s, args))
    u_whole = _count(lambda: _u_pass(ocp, x, args))
    call_split = _count(lambda: split(*args))
    call_whole = _count(lambda: unsplit(*args))
    assert u_split < share * u_whole, (u_split, u_whole)
    assert call_whole - call_split >= cut, (call_split, call_whole)
