"""Shared helpers of the PyTorch port's equivalence tests (tests/test_torch_*.py).

Both packages get the same numpy inputs, made from a seed; the JAX function
and its counterpart in `wb_humanoid_mpc_tpu_torch` run on the CPU and their
outputs are compared at a stated tolerance. tests/conftest.py turns JAX x64
on, so float32 cases hand JAX explicit float32 arrays, and `x64_off()` runs a
JAX reference in pure float32 (as on the TPU) where constants inside the JAX
code would otherwise promote it to float64. Robots come from the port's
committed assets (`wb_humanoid_mpc_tpu_torch/assets/`), loaded by each
package through its own public API; nothing here reads `/root/reference`.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wb_humanoid_mpc_tpu.core.config import load_task_config
from wb_humanoid_mpc_tpu.models.layout import WBLayout
from wb_humanoid_mpc_tpu.models.robot.factory import build_robot_model, mpc_joint_names
from wb_humanoid_mpc_tpu.models.wb_model import WholeBodyModel
from wb_humanoid_mpc_tpu.ocp.wb_ocp import WholeBodyOcp
from wb_humanoid_mpc_tpu_torch import interface as port_interface
from wb_humanoid_mpc_tpu_torch.ocp.wb_ocp import WholeBodyOcp as PortWholeBodyOcp

# the suite runs under pytest-xdist with several workers
torch.set_num_threads(1)

# functorch warns "There is a performance drop because we have not yet
# implemented the batching rule for ..." when an op has no batching rule and
# it falls back to a per-tangent Python loop; the tests turn that into an error
NO_BATCHING_FALLBACK = "error:.*performance drop:UserWarning"

ASSETS = port_interface.ASSETS
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@contextlib.contextmanager
def x64_off():
    """Run JAX in float32 mode (the TPU's), restoring x64 afterwards."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def jax_mode(dtype: str):
    """Context for a JAX reference in `dtype`: x64 as the suite has it for
    f64, pure float32 for f32."""
    return contextlib.nullcontext() if dtype == "f64" else x64_off()


@functools.lru_cache(maxsize=None)
def jax_wb(robot: str):
    """(cfg, model, ocp) of the JAX package for an asset robot."""
    urdf, task = port_interface.asset_files(ASSETS / robot)
    probe = load_task_config(task, "wb", 1, 1)
    layout = WBLayout(n_joints=len(mpc_joint_names(urdf, probe.model_settings.fixed_joint_names)))
    cfg = load_task_config(task, "wb", layout.state_dim, layout.input_dim)
    model = WholeBodyModel(robot=build_robot_model(urdf, cfg), layout=layout,
                           contact_frames=tuple(cfg.model_settings.contact_names))
    return cfg, model, WholeBodyOcp(model=model, cfg=cfg)


@functools.lru_cache(maxsize=None)
def port_wb(robot: str):
    """(cfg, model, ocp) of the PyTorch port for an asset robot."""
    cfg, model = port_interface.load_wb_model(ASSETS / robot)
    return cfg, model, PortWholeBodyOcp(model=model, cfg=cfg)


def to_numpy(tree):
    """Nested tuples/lists/NamedTuples of jax arrays or torch tensors -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (tuple, list)):
        return [to_numpy(t) for t in tree]
    return np.asarray(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def assert_close(got, ref, *, rtol: float, atol: float, what: str = "") -> float:
    """Compare two trees leaf by leaf; returns the largest |got - ref|."""
    g, r = _leaves(to_numpy(got)), _leaves(to_numpy(ref))
    assert len(g) == len(r), f"{what}: {len(g)} outputs vs {len(r)}"
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, r)):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        np.testing.assert_allclose(a, np.broadcast_to(b, a.shape), rtol=rtol, atol=atol,
                                   err_msg=f"{what} output {i}")
        if a.size:
            worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def check_pair(seed: int, make_inputs, jax_fn, port_fn, dtype: str, *, rtol: float,
               atol: float, what: str = ""):
    """Make numpy inputs from `seed`, call the JAX function and its port
    counterpart on them in `dtype` ("f64" | "f32"), compare, return both."""
    inputs = make_inputs(np.random.default_rng(seed))
    jdt, tdt = DTYPES[dtype]
    with jax_mode(dtype):
        ref = to_numpy(jax_fn(*(jnp.asarray(a, dtype=jdt) for a in inputs)))
    got = port_fn(*(torch.as_tensor(a, dtype=tdt) for a in inputs))
    assert_close(got, ref, rtol=rtol, atol=atol, what=what)
    return got, ref
