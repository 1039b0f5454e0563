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

JAX runs the body under one `shard_map`; here each rank runs it eagerly and
the collectives are `torch.distributed` calls over the mesh's groups
(`parallel/collectives.py`): 11 per SQP iteration on every rank (6
gathers, 5 reductions), none over `dp`, and 2 gathers at the end that give
every rank the whole solution. The equality handling is the projection
path only, as in JAX. Results match `make_batched_solver` to float
tolerance (tests/test_torch_sharded_sqp.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams
from wb_humanoid_mpc_tpu_torch.parallel.collectives import (
    all_gather,
    next_block,
    pack,
    pmax,
    psum,
    unpack,
)
from wb_humanoid_mpc_tpu_torch.parallel.horizon import (
    _identity_elem,
    block_backward_gains,
    block_forward_rollout,
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


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _nodes_first(a):
    """[B, K, ...] -> [K, B, ...]: the block passes scan over dim 0."""
    return torch.movedim(a, 1, 0)


def make_sharded_sqp_solver(ocp, flow, bp: BarrierParams, cfg: SqpSolverConfig, mesh,
                            batch_axis: str = "dp", horizon_axis: str = "h", *,
                            device="cuda", flow_batch=None) -> Callable:
    """Returns solve(t0, x0s [B, nx], init_traj [B, ...], params [B, N+1, ...],
    lam [B, N, n_eq]) -> SqpSolution with a leading B on every field but
    `iterations`.

    Every rank of `mesh` calls `solve` with the same global inputs on
    `device` (JAX's single-controller call) and gets the whole solution
    back; it works on its dp-rows of the batch (B must divide by the dp
    size) and its h-block of the horizon. `flow_batch(ts, xs, us)` runs the
    RK4 tails and the merit rollouts; the default is the model's
    `flow_map_batch` with `cfg.flow_backend` (K2 on the card)."""
    _check_config(cfg)
    if cfg.equality_handling != "projection":
        raise ValueError("sharded solver implements the projection path only")
    dev = resolve_device(device)
    if mesh.device != dev:
        raise ValueError(f"solver on {dev}, mesh on {mesh.device}")

    N = cfg.n_nodes
    H = mesh.shape[horizon_axis]
    n_dp = mesh.shape[batch_axis]
    M = N + 1                         # elements incl. terminal
    K = -(-M // H)                    # elements per rank (ceil)
    ME = K * H
    dt = cfg.dt
    g_h, g_dp = mesh.group(horizon_axis), mesh.group(batch_axis)
    i_h, i_dp = mesh.index(horizon_axis), mesh.index(batch_axis)
    node_lq = make_node_lq(ocp, flow, dt, bp, cfg.sensitivity)
    if flow_batch is None:
        flow_batch = model_flow_batch(ocp, cfg) or flow
    fb = flat_flow(flow_batch)
    rho_lq = min(cfg.rho, 1.0)
    node_idx = torch.arange(i_h * K, (i_h + 1) * K, device=dev)
    stage_valid = node_idx < N                     # [K]
    is_term = node_idx == N
    sv_x = stage_valid[:, None]                    # over [..., K, nx]

    def shift_left(x):
        """[..., K, nx] -> entry k+1 (the next block's first row fills the last)."""
        return torch.cat([x[..., 1:, :], next_block(x[..., 0, :], g_h)[..., None, :]], dim=-2)

    def sel(mask, a, b):
        """where over the node axis (dim 1 of [B, K, ...])."""
        return torch.where(mask.reshape((1, K) + (1,) * (a.dim() - 2)), a, b)

    def body(t0, x0, xs, us, params, lam):
        # local shapes: xs [B, K, nx], us [B, K, nu], params [B, K, ...],
        # lam [B, K, n_eq], x0 [B, nx] (the same on every h-rank)
        Bl, nx = xs.shape[0], xs.shape[-1]
        dtype = xs.dtype
        times = (t0 + dt * node_idx.to(dtype)).expand(Bl, K)
        t_term = torch.full_like(times, t0 + dt * N)
        alphas = torch.tensor(cfg.alphas, dtype=dtype, device=dev)

        def merit_local(xs_, us_):
            """This block's (cost, SSE of g and defects, max|g|, max|defect|)
            per instance, with any leading candidate dims: the parts of the
            ocs2 PerformanceIndex that the caller sums or maxes over h."""
            terms, k1 = ocp.fused_node(times, xs_, us_, params)
            costs = node_cost_terms(terms, bp, torch.zeros_like(terms.g), 1e-12)
            cT = 0.5 * torch.sum(ocp.terminal_residual(t_term, xs_, params) ** 2, dim=-1)
            c_loc = (torch.sum(torch.where(stage_valid, costs, 0.0), dim=-1)
                     + torch.sum(torch.where(is_term, cT, 0.0), dim=-1))
            x_next = batched_rk4_tail(fb, dt, times, xs_, us_, k1)
            d = torch.where(sv_x, x_next - shift_left(xs_), 0.0)
            v_loc = (torch.sum(torch.where(stage_valid, torch.sum(terms.g ** 2, dim=-1), 0.0),
                               dim=-1)
                     + torch.sum(d ** 2, dim=(-2, -1)))
            g_loc = torch.amax(torch.where(stage_valid, torch.amax(torch.abs(terms.g), dim=-1),
                                           0.0), dim=-1)
            return c_loc, v_loc, g_loc, torch.amax(torch.abs(d), dim=(-2, -1))

        stats = None
        for _ in range(cfg.sqp_iterations):
            # ---- LQ + projection per local node ----
            (A, B, x_next, Qxx, Quu, Qux, qx, qu, cost_n, _, g, Cx, Du, c_pure_n,
             g_sse_n) = node_lq(times, xs, us, params, lam, rho_lq)
            if cfg.sensitivity == "node":     # the slot held k1
                x_next = batched_rk4_tail(fb, dt, times, xs, us, x_next)
            d = torch.where(sv_x, x_next - shift_left(xs), 0.0)
            lq = LQApprox(A=A, B=B, d=d, Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, QN=None,
                          qN=None)
            reduced, proj = project_lq(lq, Cx, Du, g, cfg.proj_eps)
            # the damped QP of the unsharded solver (`levenberg_damp`)
            reduced = levenberg_damp(reduced, cfg.reg)
            stage = tuple(getattr(reduced, f) for f in
                          ("A", "B", "d", "Qxx", "Quu", "Qux", "qx", "qu"))

            # ---- scan elements: stage leaf / terminal / identity ----
            leaf = stage_leaf(*stage, cfg.reg_num)
            (rT,), (JT,) = _tangent_jacobians(
                lambda x_: (ocp.terminal_residual(t_term, x_, params),), xs, nx)
            JTt = JT.transpose(-1, -2)
            QN_rows, qN_rows = JTt @ JT, _mv(JTt, rT)
            ident = _identity_elem(nx, (1, K), dtype, dev)
            zM = torch.zeros(Bl, K, nx, nx, dtype=dtype, device=dev)
            zv = torch.zeros(Bl, K, nx, dtype=dtype, device=dev)
            elems = _Elem(
                A=sel(stage_valid, leaf.A, sel(is_term, zM, ident.A)),
                b=sel(stage_valid, leaf.b, sel(is_term, zv, ident.b)),
                C=sel(stage_valid, leaf.C, sel(is_term, zM, ident.C)),
                J=sel(stage_valid, leaf.J, sel(is_term, QN_rows, ident.J)),
                eta=sel(stage_valid, leaf.eta, sel(is_term, -qN_rows, ident.eta)))

            # ---- distributed backward + forward ----
            Kg, kg = block_backward_gains(_Elem(*map(_nodes_first, elems)),
                                          *map(_nodes_first, stage), g_h, cfg.reg_num)
            Kg, kg = _nodes_first(Kg), _nodes_first(kg)    # back to [B, K, ...]
            A_r, B_r, d_r = stage[:3]
            F = sel(stage_valid, A_r + B_r @ Kg, torch.eye(nx, dtype=dtype, device=dev))
            f = sel(stage_valid, d_r + _mv(B_r, kg), torch.zeros_like(d_r))
            dx0 = psum(x0 - xs[:, 0] if i_h == 0 else torch.zeros_like(x0), g_h)
            dx_here, _ = block_forward_rollout(_nodes_first(F), _nodes_first(f), dx0, g_h)
            dx_here = _nodes_first(dx_here)
            dzs = _mv(Kg, dx_here) + kg
            dus = _mv(proj.L, dx_here) + _mv(proj.Z, dzs) + proj.w

            # ---- filter line search, all steps at once (per instance) ----
            # baseline (c0, v0) from the LQ pass's node terms
            base = psum(torch.stack([
                torch.sum(torch.where(stage_valid, c_pure_n, 0.0), dim=-1)
                + torch.sum(torch.where(is_term, 0.5 * torch.sum(rT ** 2, dim=-1), 0.0), dim=-1),
                torch.sum(torch.where(stage_valid, g_sse_n, 0.0), dim=-1)
                + torch.sum(d ** 2, dim=(-2, -1))]), g_h)
            c0, v0 = base[0], torch.sqrt(base[1])
            a = alphas.reshape(-1, 1, 1, 1)
            c_loc, v_loc, _, _ = merit_local(xs + a * dx_here, us + a * dus)
            cv = psum(torch.stack([c_loc, v_loc]), g_h)            # [2, n_alpha, B]
            ok = filter_accept(c0[None], v0[None], cv[0], torch.sqrt(cv[1]), cfg.filter_g_max,
                               cfg.filter_g_min)
            alpha = _first_true(alphas, ok)                        # [B]
            xs = xs + alpha[:, None, None] * dx_here
            us = us + alpha[:, None, None] * dus

            _, _, g_loc, dmax_loc = merit_local(xs, us)
            cost_tot = psum(torch.sum(torch.where(stage_valid, cost_n, 0.0), dim=-1), g_h)
            g_max, d_max = pmax(torch.stack([g_loc, dmax_loc]), g_h)
            stats = (cost_tot, g_max, d_max, alpha)
        return xs, us, stats

    def solve(t0, x0s, init_traj: Trajectory, params, lam) -> SqpSolution:
        B = x0s.shape[0]
        if x0s.dim() != 2 or B % n_dp:
            raise ValueError(f"sharded solve takes x0s [B, nx] with B a multiple of {n_dp}, "
                             f"got shape {tuple(x0s.shape)}")
        if x0s.device != dev or init_traj.xs.device != dev:
            raise ValueError(f"solver built for {dev}, got tensors on {x0s.device}")
        Bl = B // n_dp
        rows = slice(i_dp * Bl, (i_dp + 1) * Bl)
        nodes = slice(i_h * K, (i_h + 1) * K)

        def local(a):
            # pad the node axis (1) to ME rows by repeating the last row, then
            # take this rank's rows and block
            a = a[rows]
            a = torch.cat([a, a[:, -1:].expand(-1, ME - a.shape[1], *a.shape[2:])], dim=1)
            return a[:, nodes]

        xs, us, (cost, g_norm, d_max, alpha) = body(
            float(t0), x0s[rows], local(init_traj.xs), local(init_traj.us),
            type(params)(*map(local, params)), local(lam))

        # the whole solution on every rank: the blocks over h, then the rows over dp
        flat, tails = pack([xs, us], 2)
        blocks = all_gather(_nodes_first(flat), g_h)                # [ME, Bl, nx + nu]
        mine = torch.cat([_nodes_first(blocks).reshape(Bl, -1),
                          torch.stack([cost, g_norm, d_max, alpha], dim=-1)], dim=-1)
        full = all_gather(mine, g_dp)                               # [B, ...]
        xs_o, us_o = unpack(full[:, :-4].reshape(B, ME, -1), tails, 2)
        cost, g_norm, d_max, alpha = full[:, -4:].unbind(-1)
        return SqpSolution(traj=Trajectory(xs=xs_o[:, :M], us=us_o[:, :N]), lam=lam, cost=cost,
                           g_norm=g_norm, defect_norm=d_max, step_size=alpha,
                           iterations=cfg.sqp_iterations)

    return solve
