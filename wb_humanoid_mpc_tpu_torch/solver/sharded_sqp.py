"""2-D (batch x horizon) sharded SQP: the whole solve on a mesh of ranks.

PyTorch counterpart of `wb_humanoid_mpc_tpu/solver/sharded_sqp.py`. Problem
instances are split over the `dp` axis of an `MpcMesh`
(`parallel/multihost.py`), the horizon over its `h` axis, so that every
phase of an SQP iteration runs on the rank that owns the horizon block:

  - LQ linearization + projection: per local node, no communication; the
    RK4 tails through `flow_batch` over instances x nodes in one call per
    stage (K2 on the card, `models/wb_model.py::flow_map_batch`);
  - backward Riccati: local associative scan + one `all_gather` of the
    per-block summary elements (`parallel/horizon.py`);
  - forward rollout: affine prefix scan, the same pattern;
  - shooting defects: one shift-by-one (the next block's first state);
  - filter line search: all 8 steps at once (K2 over steps x instances x
    nodes), local node-cost sums and one `psum` for the set.

JAX runs the body under one `shard_map`, and `jax.jit` makes the solve one
program. Here each rank runs the body as a program of parts (`ShardedSqp`):
local computations on a dict of named tensors, and after each the
collectives of what it sends (`Exchange`, over the mesh's groups through
`parallel/collectives.py`): 11 per SQP iteration on every rank (6 gathers,
5 reductions), none over `dp`, and 2 gathers at the end that give every
rank the whole solution. `ShardedSqp.solve` runs the program eagerly (the
eager twin, `graphs=False`); `solver/graphs.py::GraphedShardedSolve` runs
the same parts on static buffers as CUDA graphs, the default on the card.
The equality handling is the projection path only, as in JAX. Results
match `make_batched_solver` to float tolerance
(tests/test_torch_sharded_sqp.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams
from wb_humanoid_mpc_tpu_torch.parallel.collectives import (
    all_gather,
    gathered_like,
    next_block,
    pack,
    pmax,
    psum,
    unpack,
)
from wb_humanoid_mpc_tpu_torch.parallel.horizon import (
    _identity_elem,
    feedback_gains,
    first_values,
    next_values,
    rollout_prefix,
    rollout_scan,
    rows_in,
    rows_out,
    value_functions,
    value_scan,
)
from wb_humanoid_mpc_tpu_torch.solver.linesearch import filter_accept
from wb_humanoid_mpc_tpu_torch.solver.priccati import _Elem, stage_leaf
from wb_humanoid_mpc_tpu_torch.solver.projection import project_lq
from wb_humanoid_mpc_tpu_torch.solver.riccati import levenberg_damp
from wb_humanoid_mpc_tpu_torch.solver.sqp import (
    SqpSolution,
    SqpSolverConfig,
    _check_config,
    _first_true,
    model_flow_batch,
)
from wb_humanoid_mpc_tpu_torch.solver.transcription import (
    LQApprox,
    Trajectory,
    _tangent_jacobians,
    batched_rk4_tail,
    flat_flow,
    make_node_lq,
    node_cost_terms,
)
from wb_humanoid_mpc_tpu_torch.utils.device import resolve_device

_STAGE = ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu")


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _nodes_first(a):
    """[B, K, ...] -> [K, B, ...]: the block passes scan over dim 0."""
    return torch.movedim(a, 1, 0)


def _shifted(x, first_next):
    """[..., K, nx] -> entry k+1, the last from the next block's first row."""
    return torch.cat([x[..., 1:, :], first_next[..., None, :]], dim=-2)


class Exchange(NamedTuple):
    """One collective of the program: the tensor the part before it sends
    under `key` goes through `op` over the mesh axis `axis` ("h" or "dp"),
    and the part after it reads the result under the same key."""
    key: str
    op: str     # "gather" (all_gather), "next" (next_block), "sum" (psum), "max" (pmax)
    axis: str


class ShardedSqp:
    """The sharded solve on this rank of `mesh`, as two programs: `iteration`
    (one SQP iteration) and `final` (the gathers of the whole solution).
    A program is a list of (part, exchanges): a part is a method that reads
    and writes a state dict and returns {key: tensor} of what it sends; the
    exchanges run in order after it. `solve` runs them eagerly."""

    def __init__(self, ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, mesh,
                 batch_axis: str, horizon_axis: str, device: torch.device, flow_batch):
        self.ocp, self.bp, self.cfg, self.device = ocp, bp, cfg, device
        self.backend = mesh.backend
        self.N = N = cfg.n_nodes
        H, self.n_dp = mesh.shape[horizon_axis], mesh.shape[batch_axis]
        self.M = N + 1                         # elements incl. terminal
        self.K = K = -(-self.M // H)           # elements per rank (ceil)
        self.ME = K * H
        self.dt = cfg.dt
        self.groups = {"h": mesh.group(horizon_axis), "dp": mesh.group(batch_axis)}
        self.i_h, self.i_dp = mesh.index(horizon_axis), mesh.index(batch_axis)
        self.node_lq = make_node_lq(ocp, flow, cfg.dt, bp, cfg.sensitivity)
        if flow_batch is None:
            flow_batch = model_flow_batch(ocp, cfg) or flow
        self.fb = flat_flow(flow_batch)
        self.rho_lq = min(cfg.rho, 1.0)
        self.node_idx = torch.arange(self.i_h * K, (self.i_h + 1) * K, device=device)
        self.stage_valid = self.node_idx < N           # [K]
        self.is_term = self.node_idx == N
        self.sv_x = self.stage_valid[:, None]           # over [..., K, nx]
        # the step ladder, built once (no host copy inside an iteration)
        self.alphas = {dt: torch.tensor(cfg.alphas, dtype=dt, device=device)
                       for dt in (torch.float32, torch.float64)}
        self.iteration = [
            (self._lq, [Exchange("x_first", "next", "h")]),
            (self._elements, [Exchange("sums", "gather", "h")]),
            (self._values, [Exchange("v_first", "next", "h")]),
            (self._gains, [Exchange("dx0", "sum", "h"), Exchange("sumsF", "gather", "h")]),
            (self._step, [Exchange("base", "sum", "h"), Exchange("cand_first", "next", "h")]),
            (self._candidates, [Exchange("cv", "sum", "h")]),
            (self._accept, [Exchange("new_first", "next", "h"), Exchange("cost", "sum", "h")]),
            (self._residuals, [Exchange("gd", "max", "h")]),
            (self._stats, []),
        ]
        self.final = [(self._blocks, [Exchange("blocks", "gather", "h")]),
                      (self._rows, [Exchange("full", "gather", "dp")])]

    # ---- the collectives ----
    def exchange(self, ex: Exchange, t: torch.Tensor, out: torch.Tensor | None = None):
        """`ex` of the tensor t (into `out` when given: a reduction may
        reduce t itself)."""
        group = self.groups[ex.axis]
        if ex.op == "gather":
            return all_gather(t, group, out)
        if ex.op == "next":
            return next_block(t, group, out)
        return (psum if ex.op == "sum" else pmax)(t, group, out)

    def exchange_out(self, ex: Exchange, t: torch.Tensor) -> torch.Tensor:
        """A tensor for the result of `ex` of t: t itself for a reduction."""
        if ex.op in ("sum", "max"):
            return t
        return gathered_like(t if ex.op == "gather" else t[None], self.groups[ex.axis])

    def run_eager(self, program, s: dict) -> None:
        for part, exchanges in program:
            sends = part(s)
            for ex in exchanges:
                s[ex.key] = self.exchange(ex, sends[ex.key])

    # ---- the parts of an iteration: state xs [B, K, nx], us [B, K, nu],
    # params [B, K, ...], lam [B, K, n_eq], x0 [B, nx] (the same on every
    # h-rank), t0 (0-d), alphas ----
    def _merit_head(self, s, xs_, us_):
        """The local part of this block's merit before the shift: node terms,
        node and terminal costs, RK4 successors (candidate dims allowed)."""
        times, t_term, params = s["times"], s["t_term"], s["params"]
        terms, k1 = self.ocp.fused_node(times, xs_, us_, params)
        costs = node_cost_terms(terms, self.bp, torch.zeros_like(terms.g), 1e-12)
        cT = 0.5 * torch.sum(self.ocp.terminal_residual(t_term, xs_, params) ** 2, dim=-1)
        c_loc = (torch.sum(torch.where(self.stage_valid, costs, 0.0), dim=-1)
                 + torch.sum(torch.where(self.is_term, cT, 0.0), dim=-1))
        x_next = batched_rk4_tail(self.fb, self.dt, times, xs_, us_, k1)
        return xs_, terms, c_loc, x_next

    def _merit_tail(self, head, first_next):
        """This block's (cost, SSE of g and defects, max|g|, max|defect|)
        per instance: the parts of the ocs2 PerformanceIndex that the caller
        sums or maxes over h."""
        xs_, terms, c_loc, x_next = head
        sv = self.stage_valid
        d = torch.where(self.sv_x, x_next - _shifted(xs_, first_next), 0.0)
        v_loc = (torch.sum(torch.where(sv, torch.sum(terms.g ** 2, dim=-1), 0.0), dim=-1)
                 + torch.sum(d ** 2, dim=(-2, -1)))
        g_loc = torch.amax(torch.where(sv, torch.amax(torch.abs(terms.g), dim=-1), 0.0), dim=-1)
        return c_loc, v_loc, g_loc, torch.amax(torch.abs(d), dim=(-2, -1))

    def _sel(self, mask, a, b):
        """where over the node axis (dim 1 of [B, K, ...])."""
        return torch.where(mask.reshape((1, self.K) + (1,) * (a.dim() - 2)), a, b)

    def _lq(self, s):
        """LQ per local node (the RK4 tails through `flow_batch`)."""
        xs, us = s["xs"], s["us"]
        Bl, dtype = xs.shape[0], xs.dtype
        s["times"] = times = (s["t0"] + self.dt * self.node_idx.to(dtype)).expand(Bl, self.K)
        s["t_term"] = (s["t0"] + self.dt * self.N).expand(Bl, self.K)
        lq = list(self.node_lq(times, xs, us, s["params"], s["lam"], self.rho_lq))
        if self.cfg.sensitivity == "node":     # the slot held k1
            lq[2] = batched_rk4_tail(self.fb, self.dt, times, xs, us, lq[2])
        s["lq"] = lq
        return {"x_first": xs[:, 0]}

    def _elements(self, s):
        """Defects, projection, damping, the scan elements and the local
        reversed scan."""
        xs, params, t_term = s["xs"], s["params"], s["t_term"]
        nx, dtype, dev = xs.shape[-1], xs.dtype, xs.device
        (A, B, x_next, Qxx, Quu, Qux, qx, qu, _, _, g, Cx, Du, _, _) = s["lq"]
        s["d"] = d = torch.where(self.sv_x, x_next - _shifted(xs, s["x_first"]), 0.0)
        lq = LQApprox(A=A, B=B, d=d, Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, QN=None, qN=None)
        reduced, s["proj"] = project_lq(lq, Cx, Du, g, self.cfg.proj_eps)
        # the damped QP of the unsharded solver (`levenberg_damp`)
        reduced = levenberg_damp(reduced, self.cfg.reg)
        s["stage"] = stage = tuple(getattr(reduced, f) for f in _STAGE)
        leaf = stage_leaf(*stage, self.cfg.reg_num)
        (rT,), (JT,) = _tangent_jacobians(
            lambda x_: (self.ocp.terminal_residual(t_term, x_, params),), xs, nx)
        s["rT"] = rT
        JTt = JT.transpose(-1, -2)
        QN_rows, qN_rows = JTt @ JT, _mv(JTt, rT)
        ident = _identity_elem(nx, (1, self.K), dtype, dev)
        zM = torch.zeros(xs.shape[0], self.K, nx, nx, dtype=dtype, device=dev)
        zv = torch.zeros(xs.shape[0], self.K, nx, dtype=dtype, device=dev)
        sel, sv, it = self._sel, self.stage_valid, self.is_term
        elems = _Elem(
            A=sel(sv, leaf.A, sel(it, zM, ident.A)),
            b=sel(sv, leaf.b, sel(it, zv, ident.b)),
            C=sel(sv, leaf.C, sel(it, zM, ident.C)),
            J=sel(sv, leaf.J, sel(it, QN_rows, ident.J)),
            eta=sel(sv, leaf.eta, sel(it, -qN_rows, ident.eta)))
        s["loc"] = loc = value_scan(_Elem(*map(_nodes_first, elems)))
        return {"sums": rows_out(loc, slice(0, 1))}

    def _values(self, s):
        """The block's value functions from every block's summary."""
        s["P"] = value_functions(s["loc"], rows_in(s["sums"], s["loc"]), self.i_h)
        return {"v_first": first_values(*s["P"])}

    def _gains(self, s):
        """Feedback gains, closed-loop links and their local prefix scan."""
        xs, x0 = s["xs"], s["x0"]
        nx, dtype, dev = xs.shape[-1], xs.dtype, xs.device
        Pn, pn = next_values(*s["P"], s["v_first"])
        A, B, d, _, Quu, Qux, _, qu = map(_nodes_first, s["stage"])
        Kg, kg = feedback_gains(Pn, pn, A, B, d, Quu, Qux, qu, self.cfg.reg_num)
        s["Kg"], s["kg"] = Kg, kg = _nodes_first(Kg), _nodes_first(kg)    # back to [B, K, ...]
        A_r, B_r, d_r = s["stage"][:3]
        F = self._sel(self.stage_valid, A_r + B_r @ Kg, torch.eye(nx, dtype=dtype, device=dev))
        f = self._sel(self.stage_valid, d_r + _mv(B_r, kg), torch.zeros_like(d_r))
        s["locF"] = locF = rollout_scan(_nodes_first(F), _nodes_first(f))
        return {"dx0": x0 - xs[:, 0] if self.i_h == 0 else torch.zeros_like(x0),
                "sumsF": rows_out(locF, slice(-1, None))}

    def _step(self, s):
        """The step (dx, du) and the filter's baseline; the candidates' local
        merit before the shift."""
        xs, us, proj = s["xs"], s["us"], s["proj"]
        dx, _ = rollout_prefix(s["locF"], rows_in(s["sumsF"], s["locF"]), self.i_h, s["dx0"])
        s["dx"] = dx = _nodes_first(dx)
        dzs = _mv(s["Kg"], dx) + s["kg"]
        s["du"] = du = _mv(proj.L, dx) + _mv(proj.Z, dzs) + proj.w
        # baseline (c0, v0) from the LQ pass's node terms
        c_pure_n, g_sse_n = s["lq"][13], s["lq"][14]
        sv, it = self.stage_valid, self.is_term
        base = torch.stack([
            torch.sum(torch.where(sv, c_pure_n, 0.0), dim=-1)
            + torch.sum(torch.where(it, 0.5 * torch.sum(s["rT"] ** 2, dim=-1), 0.0), dim=-1),
            torch.sum(torch.where(sv, g_sse_n, 0.0), dim=-1)
            + torch.sum(s["d"] ** 2, dim=(-2, -1))])
        a = s["alphas"].reshape(-1, 1, 1, 1)
        s["cand"] = cand = self._merit_head(s, xs + a * dx, us + a * du)
        return {"base": base, "cand_first": cand[0][..., 0, :]}

    def _candidates(self, s):
        """Every step's (cost, violation) of this block."""
        c_loc, v_loc, _, _ = self._merit_tail(s["cand"], s["cand_first"])
        return {"cv": torch.stack([c_loc, v_loc])}          # [2, n_alpha, B]

    def _accept(self, s):
        """The filter's step per instance, the new trajectory, its local
        merit before the shift."""
        base, cv = s["base"], s["cv"]
        c0, v0 = base[0], torch.sqrt(base[1])
        ok = filter_accept(c0[None], v0[None], cv[0], torch.sqrt(cv[1]), self.cfg.filter_g_max,
                           self.cfg.filter_g_min)
        s["alpha"] = alpha = _first_true(s["alphas"], ok)    # [B]
        s["next_xs"] = xs = s["xs"] + alpha[:, None, None] * s["dx"]
        s["next_us"] = us = s["us"] + alpha[:, None, None] * s["du"]
        s["new"] = self._merit_head(s, xs, us)
        cost_n = s["lq"][8]
        return {"new_first": xs[:, 0],
                "cost": torch.sum(torch.where(self.stage_valid, cost_n, 0.0), dim=-1)}

    def _residuals(self, s):
        _, _, g_loc, dmax_loc = self._merit_tail(s["new"], s["new_first"])
        return {"gd": torch.stack([g_loc, dmax_loc])}

    def _stats(self, s):
        g_max, d_max = s["gd"]
        s["stats"] = (s["cost"], g_max, d_max, s["alpha"])
        return {}

    # ---- the parts of the final gathers: state xs, us, stats ----
    def _blocks(self, f):
        flat, _ = pack([f["xs"], f["us"]], 2)
        return {"blocks": _nodes_first(flat)}                  # gathered: [ME, B, nx + nu]

    def _rows(self, f):
        Bl = f["xs"].shape[0]
        return {"full": torch.cat([_nodes_first(f["blocks"]).reshape(Bl, -1),
                                   torch.stack(f["stats"], dim=-1)], dim=-1)}

    # ---- a solve ----
    def check(self, x0s, init_traj: Trajectory) -> int:
        """The global batch B of a call's inputs."""
        B = x0s.shape[0]
        if x0s.dim() != 2 or B % self.n_dp:
            raise ValueError(f"sharded solve takes x0s [B, nx] with B a multiple of {self.n_dp}, "
                             f"got shape {tuple(x0s.shape)}")
        if x0s.device != self.device or init_traj.xs.device != self.device:
            raise ValueError(f"solver built for {self.device}, got tensors on {x0s.device}")
        return B

    def local_inputs(self, x0s, init_traj: Trajectory, params, lam) -> dict:
        """This rank's rows of the batch and block of the horizon of each input."""
        Bl = x0s.shape[0] // self.n_dp
        rows = slice(self.i_dp * Bl, (self.i_dp + 1) * Bl)
        nodes = slice(self.i_h * self.K, (self.i_h + 1) * self.K)

        def local(a):
            # pad the node axis (1) to ME rows by repeating the last row, then
            # take this rank's rows and block
            a = a[rows]
            a = torch.cat([a, a[:, -1:].expand(-1, self.ME - a.shape[1], *a.shape[2:])], dim=1)
            return a[:, nodes]

        return dict(x0=x0s[rows], xs=local(init_traj.xs), us=local(init_traj.us),
                    params=type(params)(*map(local, params)), lam=local(lam))

    def solution(self, full, tails, lam) -> SqpSolution:
        """The whole solution from the gathered rows `full` [B, ...]."""
        B = full.shape[0]
        xs, us = unpack(full[:, :-4].reshape(B, self.ME, -1), tails, 2)
        cost, g_norm, d_max, alpha = full[:, -4:].unbind(-1)
        return SqpSolution(traj=Trajectory(xs=xs[:, :self.M], us=us[:, :self.N]), lam=lam,
                           cost=cost, g_norm=g_norm, defect_norm=d_max, step_size=alpha,
                           iterations=self.cfg.sqp_iterations)

    def solve(self, t0, x0s, init_traj: Trajectory, params, lam) -> SqpSolution:
        """The eager solve."""
        self.check(x0s, init_traj)
        s = self.local_inputs(x0s, init_traj, params, lam)
        s["t0"] = torch.full((), float(t0), dtype=x0s.dtype, device=self.device)
        s["alphas"] = self.alphas[x0s.dtype]
        for _ in range(self.cfg.sqp_iterations):
            self.run_eager(self.iteration, s)
            s["xs"], s["us"] = s["next_xs"], s["next_us"]
        f = {"xs": s["xs"], "us": s["us"], "stats": s["stats"]}
        self.run_eager(self.final, f)
        return self.solution(f["full"], [s["xs"].shape[2:], s["us"].shape[2:]], lam)


def make_sharded_sqp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, mesh,
                            batch_axis: str = "dp", horizon_axis: str = "h", *,
                            device="cuda", flow_batch=None,
                            graphs: bool | None = None) -> Callable:
    """Returns solve(t0, x0s [B, nx], init_traj [B, ...], params [B, N+1, ...],
    lam [B, N, n_eq]) -> SqpSolution with a leading B on every field but
    `iterations`.

    Every rank of `mesh` calls `solve` with the same global inputs on
    `device` (JAX's single-controller call) and gets the whole solution
    back; it works on its dp-rows of the batch (B must divide by the dp
    size) and its h-block of the horizon. `flow_batch(ts, xs, us)` runs the
    RK4 tails and the merit rollouts; the default is the model's
    `flow_map_batch` with `cfg.flow_backend` (K2 for CUDA tensors).
    `graphs` as for `make_sqp_solver`: None (the default) as CUDA graphs on
    a CUDA device (`solver/graphs.py::GraphedShardedSolve`: one graph a part
    with the collectives between replays on a `gloo` mesh, one graph an
    iteration with its collectives inside on `nccl`) and eagerly on the
    CPU; True as CUDA graphs (raises on the CPU); False eagerly, the twin."""
    _check_config(cfg)
    if cfg.equality_handling != "projection":
        raise ValueError("sharded solver implements the projection path only")
    dev = resolve_device(device)
    if mesh.device != dev:
        raise ValueError(f"solver on {dev}, mesh on {mesh.device}")
    if graphs is None:
        graphs = dev.type == "cuda"
    sqp = ShardedSqp(ocp, flow, bp, cfg, mesh, batch_axis, horizon_axis, dev, flow_batch)
    if graphs:
        from wb_humanoid_mpc_tpu_torch.solver.graphs import GraphedShardedSolve

        return GraphedShardedSolve(sqp)
    return sqp.solve
