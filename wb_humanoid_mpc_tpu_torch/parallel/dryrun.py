"""Rank bodies of the sharded layer, run by `multihost.run_ranks`.

`run_ranks` starts every rank with `spawn`, which imports the module of the
function the rank runs, and a rank must import neither JAX nor the JAX
package. So the bodies that `chip_smoke.py`'s `sharded` phase and the CPU
tests (tests/test_torch_{horizon,multihost,sharded_sqp}.py) run on every
rank live here, in the port:

- `run_cases` runs a list of cases in order on one rank, so that every case
  of one world size shares one spawn;
- `sharded_sqp_case` is the port's `dryrun_multichip`
  (`__graft_entry__.py`): the walking problem, batch x horizon sharded,
  through `make_sharded_sqp_solver`;
- `shard_batched_case`, `throughput_case`, `horizon_case`,
  `collectives_case` and `submesh_case` drive `shard_batched_solver`, the
  mesh point of `batched_throughput`, `horizon_sharded_lq_solve`, the mesh's
  collectives and a mesh over some of the ranks.

Each returns numpy arrays and plain numbers (what `run_ranks` can pickle).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem, walking_reference
from wb_humanoid_mpc_tpu_torch.ops import fkvel
from wb_humanoid_mpc_tpu_torch.parallel import collectives
from wb_humanoid_mpc_tpu_torch.parallel.batched import shard_batched_solver
from wb_humanoid_mpc_tpu_torch.parallel.horizon import horizon_sharded_lq_solve
from wb_humanoid_mpc_tpu_torch.parallel.multihost import make_mpc_mesh, mesh_report
from wb_humanoid_mpc_tpu_torch.parallel.scaling import batched_inputs, batched_throughput
from wb_humanoid_mpc_tpu_torch.solver.sharded_sqp import make_sharded_sqp_solver
from wb_humanoid_mpc_tpu_torch.solver.sqp import SqpSolverConfig, model_flow_batch
from wb_humanoid_mpc_tpu_torch.solver.transcription import LQApprox

SPREAD = 0.003   # x0 perturbation of `dryrun_multichip`


def run_cases(cases) -> list:
    """[fn(**kwargs) for (fn, kwargs) in cases], on this rank."""
    return [fn(**kwargs) for fn, kwargs in cases]


def _numpy(sol) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in
            (("xs", sol.traj.xs), ("us", sol.traj.us), ("lam", sol.lam), ("cost", sol.cost),
             ("g_norm", sol.g_norm), ("defect_norm", sol.defect_norm),
             ("step_size", sol.step_size))}


def walking_problem(robot: str, n_nodes: int, batch: int, *, device, dtype, seed: int = 0):
    """(problem, x0s, warm start, params, multipliers) of `dryrun_multichip`:
    the walking schedule, `batch` instances from x0 + SPREAD N(0, 1) (seed),
    all nodes of the warm start at x0."""
    pb = build_wb_problem(ASSETS / robot, n_nodes, device=device, dtype=dtype,
                          swing=walking_reference(n_nodes))
    return (pb, *batched_inputs(pb, batch, seed, spread=SPREAD))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_sqp_case(robot: str, n_nodes: int, batch: int, n_dp: int, n_h: int, backend: str,
                     device: str, dtype: str, iterations: int = 2, timed_solves: int = 0,
                     seed: int = 0, flow_backend: str = "auto") -> dict:
    """One sharded solve of the walking problem on an n_dp x n_h mesh
    (sensitivity "node"; `flow_backend` "plain" for K2's plain twin), with
    the K2 launches, the `flow_batch` calls by rows and the collectives of
    that solve counted on this rank (set to 0 just before it, read just
    after); then `timed_solves` more solves from
    the same inputs, all ranks started together, for the wall time of an
    SQP iteration."""
    mesh = make_mpc_mesh(n_dp, n_h, backend=backend, device=device)
    pb, x0s, traj, params, lam = walking_problem(robot, n_nodes, batch, device=device,
                                                 dtype=getattr(torch, dtype), seed=seed)
    cfg = SqpSolverConfig(n_nodes=n_nodes, dt=pb.cfg.sqp.dt, sqp_iterations=iterations,
                          sensitivity="node", flow_backend=flow_backend)
    base = model_flow_batch(pb.ocp, cfg)
    calls: dict = {}

    def flow_batch(ts, xs, us):
        calls[xs.shape[0]] = calls.get(xs.shape[0], 0) + 1
        return base(ts, xs, us)

    solve = make_sharded_sqp_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, mesh,
                                    device=device, flow_batch=flow_batch)
    dev = mesh.device
    fkvel.reset_launches()
    collectives.reset_counts()
    t0 = time.perf_counter()
    sol = solve(0.0, x0s, traj, params, lam)
    _sync(dev)
    first_s = time.perf_counter() - t0
    out = _numpy(sol)
    out.update(k2_launches=fkvel.LAUNCHES, flow_batch_calls=dict(calls),
               collectives=dict(collectives.COUNTS), first_s=first_s, coords=mesh.coords,
               report=mesh_report(mesh), iterations=iterations, ms_per_iteration=None)
    if timed_solves:
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(timed_solves):
            solve(0.0, x0s, traj, params, lam)
        _sync(dev)
        out["ms_per_iteration"] = (time.perf_counter() - t0) * 1e3 / (timed_solves * iterations)
    return out


def shard_batched_case(robot: str, n_nodes: int, batch: int, n_dp: int, backend: str,
                       device: str, dtype: str, iterations: int = 2, seed: int = 0) -> dict:
    """`shard_batched_solver` on an n_dp x 1 mesh: the walking problem's
    batch split over dp, the whole solution returned."""
    mesh = make_mpc_mesh(n_dp, 1, backend=backend, device=device)
    pb, x0s, traj, params, lam = walking_problem(robot, n_nodes, batch, device=device,
                                                 dtype=getattr(torch, dtype), seed=seed)
    cfg = SqpSolverConfig(n_nodes=n_nodes, dt=pb.cfg.sqp.dt, sqp_iterations=iterations)
    solve, shard = shard_batched_solver(pb.ocp, pb.model.flow_map, pb.bp, cfg, mesh,
                                        device=device)
    return _numpy(solve(0.0, *shard((x0s, traj, params, lam))))


def throughput_case(batch: int, n_nodes: int, n_dp: int, backend: str, device: str) -> dict:
    """The mesh point of `batched_throughput`: the batch over n_dp ranks."""
    mesh = make_mpc_mesh(n_dp, 1, backend=backend, device=device)
    return batched_throughput(batch, n_nodes, n_rounds=1, device=device, dtype=torch.float64,
                              mesh=mesh)


def horizon_case(lq: dict, dx0: np.ndarray, n_h: int, reg: float, backend: str,
                 device: str) -> tuple:
    """`horizon_sharded_lq_solve` of one LQ problem (numpy stage data) on a
    1 x n_h mesh: (dxs, dus)."""
    mesh = make_mpc_mesh(1, n_h, backend=backend, device=device)
    t = {k: torch.as_tensor(v, device=mesh.device) for k, v in lq.items()}
    dxs, dus = horizon_sharded_lq_solve(LQApprox(**t), torch.as_tensor(dx0, device=mesh.device),
                                        mesh, "h", reg, device=device)
    return dxs.cpu().numpy(), dus.cpu().numpy()


def collectives_case(x: np.ndarray, n_dp: int, n_h: int, ranks_per_host: int, backend: str,
                     device: str) -> dict:
    """This rank's entry of x [n_dp, n_h, ...] through the mesh's
    collectives: the sum over h, then its mean over dp (JAX's
    psum-then-pmean test), the gather over h, the next block along h and the
    max over dp."""
    mesh = make_mpc_mesh(n_dp, n_h, ranks_per_host=ranks_per_host, backend=backend,
                         device=device)
    i, j = mesh.coords
    mine = torch.as_tensor(x[i, j], device=mesh.device)
    g_h, g_dp = mesh.group("h"), mesh.group("dp")
    s = collectives.psum(mine, g_h)
    return {"coords": mesh.coords, "report": mesh_report(mesh),
            "axis_index": (collectives.axis_index(g_dp), collectives.axis_index(g_h)),
            "axis_size": (collectives.axis_size(g_dp), collectives.axis_size(g_h)),
            "dp_mean_of_h_sum": (collectives.psum(s, g_dp) / n_dp).cpu().numpy(),
            "h_gather": collectives.all_gather(mine[None], g_h).cpu().numpy(),
            "h_next": collectives.next_block(mine, g_h).cpu().numpy(),
            "dp_max": collectives.pmax(mine, g_dp).cpu().numpy()}


def submesh_case(ranks: list, x: np.ndarray, backend: str, device: str) -> dict:
    """A 1 x len(ranks) mesh over `ranks`, some of the process group's ranks:
    every rank creates every group; a rank of the mesh returns its coordinates
    and the sum over h of x[its h index], a rank outside it coordinates None
    and no group."""
    mesh = make_mpc_mesh(1, len(ranks), ranks, backend=backend, device=device)
    out = {"coords": mesh.coords, "groups": sorted(mesh.groups), "report": mesh_report(mesh)}
    if mesh.coords is not None:
        mine = torch.as_tensor(x[mesh.index("h")], device=mesh.device)
        out["h_sum"] = collectives.psum(mine, mesh.group("h")).cpu().numpy()
    return out
