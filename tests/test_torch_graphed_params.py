"""PyTorch port, the centroidal node params as a graphed function on the
CPU: `interface.py::build_centroidal_mpc` uploads the params' host inputs
in one packed array and runs `ocp/params.py::centroidal_node_params` on it
through `utils/graphs.py::GraphedFunction`, which on the CPU runs with
capture off (the same buffers, eagerly). Its seven leaves equal
`make_centroidal_node_params` exactly, for a stance and a walking swing
reference, in float64 and float32, tick after tick; `MpcRuntime.advance`
gives the same policies as with the eager params; a gain update keeps
the params' graph. The card's replay is held in `tests/test_torch_cuda.py`."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from wb_humanoid_mpc_tpu_torch import interface
from wb_humanoid_mpc_tpu_torch.interface import ASSETS
from wb_humanoid_mpc_tpu_torch.mpc.gains import GainUpdate
from wb_humanoid_mpc_tpu_torch.ocp.centroidal_ocp import NodeParams
from wb_humanoid_mpc_tpu_torch.ocp.params import (
    SWING_ARRAYS,
    make_centroidal_node_params,
    pack_centroidal_inputs,
    unpack_centroidal_inputs,
)
from wb_humanoid_mpc_tpu_torch.utils.graphs import GraphedFunction

N = 6
DTYPES = {"f64": torch.float64, "f32": torch.float32}
SWINGS = {"stance": interface.stance_reference, "walking": interface.walking_reference}


def _build(robot: str, dtype, n_nodes: int = N):
    return interface.build_centroidal_mpc(*interface.mpc_files(ASSETS / robot, "centroidal"),
                                          n_nodes=n_nodes, device="cpu", dtype=dtype)


@pytest.fixture(scope="module", params=list(DTYPES))
def mpc(request):
    return _build("humanoid23", DTYPES[request.param])


def _x_refs(mpc, n: int) -> list[np.ndarray]:
    """n target-state trajectories [N+1, nx] about the initial state."""
    rng = np.random.default_rng(7)
    x0 = np.asarray(mpc.initial_state, dtype=np.float64)
    return [x0 + 0.05 * rng.normal(size=(mpc.n_nodes + 1, x0.shape[0])) for _ in range(n)]


def _eager(mpc, refs) -> NodeParams:
    """The params as the runtime built them before they were graphed."""
    x_ref = torch.as_tensor(refs.x_ref, dtype=mpc.runtime.dtype)
    return make_centroidal_node_params(mpc.ocp, refs.swing, x_ref)


def _equal(got: NodeParams, ref: NodeParams) -> None:
    assert len(got) == len(ref) == 7
    for name, a, b in zip(NodeParams._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), f"{name}: max |d| {float((a - b).abs().max()):.3e}"


def test_pack_and_unpack_are_inverse():
    swing = interface.walking_reference(N)
    x_ref = np.arange((N + 1) * 35, dtype=np.float64).reshape(N + 1, 35)
    packed = torch.as_tensor(pack_centroidal_inputs(swing, x_ref))
    got = unpack_centroidal_inputs(packed, 35)
    for name, a in zip(SWING_ARRAYS, got):
        assert a.is_contiguous() and np.array_equal(a.numpy(), getattr(swing, name)), name
    assert got[-1].is_contiguous() and np.array_equal(got[-1].numpy(), x_ref)


@pytest.mark.parametrize("swing", list(SWINGS))
def test_graphed_params_equal_the_eager_params(mpc, swing):
    """The runtime's params (the packed upload, then the pure-tensor part
    through a `GraphedFunction` with capture off) equal
    `make_centroidal_node_params` on all seven leaves, to the bit, on three
    ticks with other target states; each tick's leaves differ from the
    last's, and the task-space references are there."""
    make_params = mpc.runtime.make_node_params
    last = None
    for x_ref in _x_refs(mpc, 3):
        refs = types.SimpleNamespace(swing=SWINGS[swing](mpc.n_nodes), x_ref=x_ref)
        got = make_params(refs)
        _equal(got, _eager(mpc, refs))
        assert got.torso_ref.shape[-2] >= 1
        if last is not None:
            assert not torch.equal(got.x_ref, last[0]) and not torch.equal(got.torso_ref, last[1])
        last = (got.x_ref.clone(), got.torso_ref.clone())


def test_params_leaves_are_the_buffers_the_next_tick_overwrites(mpc):
    """The five uploaded leaves are views of the graphed function's one
    input buffer: the next tick's upload overwrites them, as it overwrites a
    graph's static outputs on the card, so a caller reads them within its
    tick."""
    make_params = mpc.runtime.make_node_params
    x1, x2 = _x_refs(mpc, 2)
    swing = interface.walking_reference(mpc.n_nodes)
    first = make_params(types.SimpleNamespace(swing=swing, x_ref=x1))
    kept = first.x_ref.clone()
    make_params(types.SimpleNamespace(swing=swing, x_ref=x2))
    assert not torch.equal(first.x_ref, kept)
    assert torch.equal(first.x_ref, torch.as_tensor(x2, dtype=mpc.runtime.dtype))


def _policies(mpc, n: int) -> list:
    """n solves of a fresh episode, stance then a walk command: each
    solve's policy (xs, us, contact flags)."""
    rt = mpc.runtime
    rt.reset()
    x = np.asarray(mpc.initial_state, dtype=np.float64)
    out = []
    for k in range(n):
        if k == 2:
            mpc.motion_manager.request_gait("walk")
        rt.advance(0.02 * k, x, np.array([0.4, 0.0, 0.0, 0.0]) if k >= 2 else np.zeros(4))
        pol = rt.policy
        out.append((pol.xs.copy(), pol.us.copy(), pol.contact_flags.copy()))
        x = np.asarray(pol.evaluate(0.02 * (k + 1))[0], dtype=np.float64)
    return out


def test_runtime_policies_equal_those_of_the_eager_params():
    """`MpcRuntime.advance` of toy_biped's centroidal MPC (N = 4, float64)
    gives, solve by solve over a stance-then-walk episode, the same policies
    with the graphed params as with the eager params it replaced."""
    mpc = _build("toy_biped", torch.float64, n_nodes=4)
    got = _policies(mpc, 6)
    graphed = mpc.runtime.make_node_params
    mpc.runtime.make_node_params = lambda refs: _eager(mpc, refs)
    try:
        ref = _policies(mpc, 6)
    finally:
        mpc.runtime.make_node_params = graphed
    assert any(not p[2].all() for p in ref), "the episode never left double support"
    for k, (a, b) in enumerate(zip(got, ref)):
        for what, u, v in zip(("xs", "us", "contact_flags"), a, b):
            assert np.array_equal(u, v), f"solve {k} {what}: max |d| {np.abs(u - v).max():.3e}"


def test_a_gain_update_keeps_the_params_graph():
    """The params depend on the robot and the task-space link names, not on
    the gains: a gain update rebuilds the solvers and leaves the params'
    graphed function, which still equals `make_centroidal_node_params`."""
    mpc = _build("toy_biped", torch.float64, n_nodes=4)
    make_params = mpc.runtime.make_node_params
    (graph,) = [c.cell_contents for c in make_params.__closure__
                if isinstance(c.cell_contents, GraphedFunction)]
    refs = types.SimpleNamespace(swing=interface.walking_reference(4), x_ref=_x_refs(mpc, 1)[0])
    make_params(refs)
    entries = dict(graph.entries)
    mpc.gains.apply(GainUpdate(term="Q", values=2.0 * np.asarray(mpc.cfg.Q)))
    assert mpc.runtime.make_node_params is make_params
    _equal(make_params(refs), _eager(mpc, refs))
    assert graph.entries == entries
