"""Rank bodies of the sharded layer, run by `multihost.run_ranks`.

`run_ranks` starts every rank with `spawn`, which imports the module of the
function the rank runs, and a rank must import neither JAX nor the JAX
package. So the bodies that the card tier's sharded tests
(tests/test_torch_cuda.py) and the CPU tests
(tests/test_torch_{horizon,multihost,sharded_sqp,graphed_sharded}.py) run
on every rank live here, in the port:

- `run_cases` runs a list of cases in order on one rank, so that every case
  of one world size shares one spawn;
- `sharded_sqp_case` is the port's `dryrun_multichip`
  (`__graft_entry__.py`): the walking problem, batch x horizon sharded,
  through `make_sharded_sqp_solver` (CUDA graphs on the card);
- `sharded_graphs_case` holds the graphed sharded solve's runner
  (`GraphedShardedSolve`) against the eager twin over two calls of
  different t0 and x0s;
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

from wb_humanoid_mpc_tpu_torch.interface import ASSETS, build_wb_problem, walking_reference
from wb_humanoid_mpc_tpu_torch.ops import fkvel
from wb_humanoid_mpc_tpu_torch.parallel import collectives
from wb_humanoid_mpc_tpu_torch.parallel.batched import shard_batched_solver
from wb_humanoid_mpc_tpu_torch.parallel.horizon import horizon_sharded_lq_solve
from wb_humanoid_mpc_tpu_torch.parallel.multihost import make_mpc_mesh, mesh_report
from wb_humanoid_mpc_tpu_torch.parallel.scaling import batched_inputs, batched_throughput
from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedShardedSolve
from wb_humanoid_mpc_tpu_torch.solver.sharded_sqp import ShardedSqp, make_sharded_sqp_solver
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


def _row_counter(base):
    """(flow_batch, calls): `base` counting its calls by rows in `calls`
    ({rows: a 0-d count on the device}): the count is an add on the device
    where the call runs, so a CUDA graph that holds the call counts it at
    every replay."""
    calls: dict = {}

    def flow_batch(ts, xs, us):
        if xs.shape[0] not in calls:   # first seen in an eager run (a graph's warm-up)
            calls[xs.shape[0]] = torch.zeros((), dtype=torch.int64, device=xs.device)
        calls[xs.shape[0]].add_(1)
        return base(ts, xs, us)

    return flow_batch, calls


def sharded_sqp_case(robot: str, n_nodes: int, batch: int, n_dp: int, n_h: int, backend: str,
                     device: str, dtype: str, iterations: int = 2, seed: int = 0,
                     flow_backend: str = "auto") -> dict:
    """One sharded solve of the walking problem on an n_dp x n_h mesh
    (sensitivity "node"; `flow_backend` "plain" for K2's plain twin;
    `make_sharded_sqp_solver`'s default: CUDA graphs on the card), with the
    K2 launches, the `flow_batch` calls by rows and the
    collectives of that solve counted on this rank (set to 0 just before it,
    read just after; replays included)."""
    mesh = make_mpc_mesh(n_dp, n_h, backend=backend, device=device)
    pb, x0s, traj, params, lam = walking_problem(robot, n_nodes, batch, device=device,
                                                 dtype=getattr(torch, dtype), seed=seed)
    cfg = SqpSolverConfig(n_nodes=n_nodes, dt=pb.cfg.sqp.dt, sqp_iterations=iterations,
                          sensitivity="node", flow_backend=flow_backend)
    flow_batch, calls = _row_counter(model_flow_batch(pb.ocp, cfg))
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
    out.update(k2_launches=fkvel.LAUNCHES,
               flow_batch_calls={rows: int(n) for rows, n in calls.items()},
               collectives=collectives.counts(), first_s=first_s, coords=mesh.coords,
               report=mesh_report(mesh), iterations=iterations, graphed=None)
    if isinstance(solve, GraphedShardedSolve):
        (gs,) = solve.sets.values()
        out["graphed"] = gs.report()
    return out


def sharded_graphs_case(robot: str, n_nodes: int, batch: int, n_dp: int, n_h: int,
                        backend: str, device: str, dtype: str, iterations: int = 2,
                        capture: bool | None = None, split: bool | None = None,
                        ocp_cls=None) -> dict:
    """The graphed sharded solve's runner against its eager twin on an
    n_dp x n_h mesh, over two calls: (t0 = 0, x0s) from the warm start, then
    (t0 = 0.35, x0s + SPREAD N(0, 1) of seed 1) from the first call's eager
    solution. The runner is `GraphedShardedSolve` with `capture` (None: on
    a CUDA device) and `split` (None: by the backend); `ocp_cls(model, cfg)`
    replaces the problem's OCP (a variant whose residuals read t, so that a
    time baked into a graph shows). Returns each call's solutions ("eager",
    "graphed"), the collectives and K2 launches of each graphed call, and
    the graph set's report."""
    mesh = make_mpc_mesh(n_dp, n_h, backend=backend, device=device)
    dt = getattr(torch, dtype)
    pb, x0s, traj, params, lam = walking_problem(robot, n_nodes, batch, device=device,
                                                 dtype=dt)
    ocp = pb.ocp if ocp_cls is None else ocp_cls(model=pb.model, cfg=pb.cfg)
    cfg = SqpSolverConfig(n_nodes=n_nodes, dt=pb.cfg.sqp.dt, sqp_iterations=iterations,
                          sensitivity="node")
    sqp = ShardedSqp(ocp, pb.model.flow_map, pb.bp, cfg, mesh, "dp", "h", mesh.device, None)
    graphed = GraphedShardedSolve(sqp, capture=mesh.device.type == "cuda" if capture is None
                                  else capture, split=split)
    noise = np.random.default_rng(1).standard_normal(tuple(x0s.shape)) * SPREAD
    out = {"eager": [], "graphed": [], "collectives": [], "k2_launches": [],
           "coords": mesh.coords}
    for t0, x0 in ((0.0, x0s), (0.35, x0s + torch.as_tensor(noise, dtype=dt, device=mesh.device))):
        ref = sqp.solve(t0, x0, traj, params, lam)
        fkvel.reset_launches()
        collectives.reset_counts()
        got = graphed(t0, x0, traj, params, lam)
        _sync(mesh.device)
        out["collectives"].append(collectives.counts())
        out["k2_launches"].append(fkvel.LAUNCHES)
        out["eager"].append(_numpy(ref))
        out["graphed"].append(_numpy(got))
        traj = ref.traj
    (gs,) = graphed.sets.values()
    out["report"] = gs.report()
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
