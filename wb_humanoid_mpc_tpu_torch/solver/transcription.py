"""Multiple-shooting transcription + LQ approximation.

PyTorch counterpart of `wb_humanoid_mpc_tpu/solver/transcription.py`, with
its three sensitivity modes. In the production mode, `sensitivity="node"`
(the RK4 tail finished at the batched level, JAX's `external_tail=True`), the
continuous dynamics and the cost/constraint terms (`ocp.fused_node`) are
linearized once at the node:

    x-pass: torch.func.vmap over the nx identity tangents of torch.func.jvp
            (JAX: jax.vmap(jvp_x)(eye_x) after jax.linearize)
    u-pass: the same over the nu identity tangents

and the linearization is discretized with the RK4 matrix polynomial
Phi = I + hA + (hA)^2/2 + (hA)^3/6 + (hA)^4/24,
Gamma = h (I + hA/2 + (hA)^2/6 + (hA)^3/24) B. The primal step is exact RK4:
k1 comes with the linearization, k2..k4 from `flow_batch` over all nodes at
once (the CUDA FK kernel on the card, `models/wb_model.py::flow_map_batch`).

"midpoint" relinearizes the per-sample flow at the RK4 midpoint
x + h/2 k1 for A and B; "exact" differentiates the whole RK4 step and the
node terms over z = (x, u) (jacfwd: one jvp per identity tangent of z). Both
finish RK4 inside the node function with the differentiable per-sample
`flow`, as JAX does with `external_tail=False`.

Where JAX `vmap`s the node function over nodes, the port passes [N, ...]
tensors to the batched `fused_node`; the tangent batch is the only `vmap`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from wb_humanoid_mpc_tpu_torch.ocp.base import BarrierParams
from wb_humanoid_mpc_tpu_torch.ocp.penalties import (
    quadratic_barrier,
    quadratic_barrier_d1,
    quadratic_barrier_d2,
    relaxed_log_barrier,
    relaxed_log_barrier_d1,
    relaxed_log_barrier_d2,
)


def rk4_step(flow, t, x, u, dt):
    """Classic RK4 with zero-order-hold input."""
    k1 = flow(t, x, u)
    k2 = flow(t + 0.5 * dt, x + 0.5 * dt * k1, u)
    k3 = flow(t + 0.5 * dt, x + 0.5 * dt * k2, u)
    k4 = flow(t + dt, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


class LQApprox(NamedTuple):
    """Batched LQ data over N nodes (+ terminal)."""

    A: torch.Tensor      # [N, nx, nx]
    B: torch.Tensor      # [N, nx, nu]
    d: torch.Tensor      # [N, nx] defects: F(x_k,u_k) - x_{k+1}
    Qxx: torch.Tensor    # [N, nx, nx]
    Quu: torch.Tensor    # [N, nu, nu]
    Qux: torch.Tensor    # [N, nu, nx]
    qx: torch.Tensor     # [N, nx]
    qu: torch.Tensor     # [N, nu]
    QN: torch.Tensor     # [nx, nx]
    qN: torch.Tensor     # [nx]
    cost: torch.Tensor = None         # scalar: total nonlinear cost (incl. AL terms)
    g_norm: torch.Tensor = None       # scalar: max |g| over nodes
    defect_norm: torch.Tensor = None  # scalar: max |d|
    Cx: torch.Tensor = None           # [N, nc, nx] equality state Jacobians
    Du: torch.Tensor = None           # [N, nc, nu] equality input Jacobians
    g_res: torch.Tensor = None        # [N, nc] equality residuals
    cost_pure: torch.Tensor = None    # scalar: cost without AL terms (+ terminal)
    viol: torch.Tensor = None         # scalar: sqrt(SSE(g) + SSE(defects))


class Trajectory(NamedTuple):
    xs: torch.Tensor   # [N+1, nx]
    us: torch.Tensor   # [N, nu]


class _Terms(NamedTuple):
    r: torch.Tensor
    h_log: torch.Tensor
    h_log_mask: torch.Tensor
    h_quad: torch.Tensor
    g: torch.Tensor


def node_cost_terms(terms, bp: BarrierParams, lam, rho):
    """Per-node scalar cost of NodeTerms with leading dims (AL included)."""
    c = 0.5 * torch.sum(terms.r ** 2, dim=-1)
    c = c + torch.sum(terms.h_log_mask
                      * relaxed_log_barrier(terms.h_log, bp.log_mu, bp.log_delta), dim=-1)
    c = c + torch.sum(quadratic_barrier(terms.h_quad, bp.quad_mu, bp.quad_delta), dim=-1)
    return c + 0.5 * rho * torch.sum((terms.g + lam / rho) ** 2, dim=-1)


def _gn_assemble(bp, r, h_log, h_quad, g, hmask, Jr, Jhl, Jhq, Jg, lam, rho):
    """Gauss-Newton gradient [..., nz] and Hessian [..., nz, nz] over stacked
    z = (x, u) Jacobians J* [..., rows, nz]."""
    pl1 = hmask * relaxed_log_barrier_d1(h_log, bp.log_mu, bp.log_delta)
    pl2 = hmask * relaxed_log_barrier_d2(h_log, bp.log_mu, bp.log_delta)
    pq1 = quadratic_barrier_d1(h_quad, bp.quad_mu, bp.quad_delta)
    pq2 = quadratic_barrier_d2(h_quad, bp.quad_mu, bp.quad_delta)
    g_al = rho * g + lam

    def JTv(J, vec):
        return (J.transpose(-1, -2) @ vec[..., None])[..., 0]

    grad = JTv(Jr, r) + JTv(Jhl, pl1) + JTv(Jhq, pq1) + JTv(Jg, g_al)
    JrT, JhlT, JhqT, JgT = (J.transpose(-1, -2) for J in (Jr, Jhl, Jhq, Jg))
    Hess = (JrT @ Jr + (JhlT * pl2[..., None, :]) @ Jhl
            + (JhqT * pq2[..., None, :]) @ Jhq + rho * (JgT @ Jg))
    return grad, Hess


def _tangent_jacobians(f, primal, n):
    """Jacobians of every output of f at `primal` ([..., n]) by forward mode:
    one jvp per identity tangent, batched by torch.func.vmap. Returns
    (outputs, [..., out, n] Jacobians of each output)."""
    eye = torch.eye(n, dtype=primal.dtype, device=primal.device)
    tangents = eye.reshape(n, *([1] * (primal.dim() - 1)), n).expand(n, *primal.shape)

    def jvp_one(tangent):
        return torch.func.jvp(f, (primal,), (tangent,))

    outs, jac = torch.func.vmap(jvp_one, out_dims=(None, 0))(tangents)
    return outs, tuple(torch.movedim(j, 0, -1) for j in jac)


def make_node_lq(ocp, flow, dt: float, bp: BarrierParams,
                 sensitivity: str = "exact") -> Callable:
    """Batched node LQ builder: (t [N], x [N,nx], u [N,nu], params [N,...], lam
    [N,nc], rho) -> the 15-tuple of JAX's `make_node_lq`, each with a leading N:
    (A_d, B_d, x_next, Qxx, Quu, Qux, qx, qu, cost, g_max, g, Cx, Du, cost_pure,
    g_sse).

    sensitivity (see JAX's `make_node_lq`): "exact" differentiates the full
    RK4 step; "node" freezes A, B at the node; "midpoint" at the RK4
    midpoint. With "node", k1 fills the x_next slot and the caller finishes
    RK4 with a batched flow (JAX's `external_tail=True`)."""
    if sensitivity not in ("exact", "node", "midpoint"):
        raise ValueError(f"unknown sensitivity mode {sensitivity!r}")
    if not hasattr(ocp, "fused_node"):
        raise NotImplementedError("the port linearizes through ocp.fused_node only")

    def rk4_tail(t, x, u, k1, k2=None):
        """x_next from k1 (and k2, where the caller has it) with the per-sample flow."""
        if k2 is None:
            k2 = flow(t + 0.5 * dt, x + 0.5 * dt * k1, u)
        k3 = flow(t + 0.5 * dt, x + 0.5 * dt * k2, u)
        k4 = flow(t + dt, x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def finish(x_next, A_d, B_d, r, h_log, h_quad, g, hmask, Jr, Jhl, Jhq, Jg, lam, rho, nx):
        grad, Hess = _gn_assemble(bp, r, h_log, h_quad, g, hmask, Jr, Jhl, Jhq, Jg, lam, rho)
        terms = _Terms(r, h_log, hmask, h_quad, g)
        cost = node_cost_terms(terms, bp, lam, rho)
        c_pure = node_cost_terms(terms, bp, torch.zeros_like(g), 1e-12)
        return (A_d, B_d, x_next,
                Hess[..., :nx, :nx], Hess[..., nx:, nx:], Hess[..., nx:, :nx],
                grad[..., :nx], grad[..., nx:], cost, torch.amax(torch.abs(g), dim=-1),
                g, Jg[..., :nx], Jg[..., nx:], c_pure, torch.sum(g ** 2, dim=-1))

    def node_lq_exact(t, x, u, p, lam, rho):
        nx, nu = x.shape[-1], u.shape[-1]

        def fz(z_):
            x_, u_ = z_[..., :nx], z_[..., nx:]
            # the node terms and k1 share one rigid-body pass (JAX evaluates
            # `node_terms` and `rk4_step(flow, ..)` apart: the same values)
            terms, k1 = ocp.fused_node(t, x_, u_, p)
            return (terms.r, terms.h_log, terms.h_quad, terms.g, rk4_tail(t, x_, u_, k1),
                    terms.h_log_mask)

        (r, h_log, h_quad, g, x_next, hmask), (Jr, Jhl, Jhq, Jg, Jf, _) = _tangent_jacobians(
            fz, torch.cat([x, u], dim=-1), nx + nu)
        return finish(x_next, Jf[..., :nx], Jf[..., nx:], r, h_log, h_quad, g, hmask,
                      Jr, Jhl, Jhq, Jg, lam, rho, nx)

    def node_lq_fused(t, x, u, p, lam, rho):
        nx, nu = x.shape[-1], u.shape[-1]

        def fx(x_):
            terms, xdot = ocp.fused_node(t, x_, u, p)
            return terms.r, terms.h_log, terms.h_quad, terms.g, xdot, terms.h_log_mask

        def fu(u_):
            terms, xdot = ocp.fused_node(t, x, u_, p)
            return terms.r, terms.h_log, terms.h_quad, terms.g, xdot

        # one heavy linearization over x (the full rigid-body graph) ...
        (r, h_log, h_quad, g, k1, hmask), Jx = _tangent_jacobians(fx, x, nx)
        Jr_x, Jhl_x, Jhq_x, Jg_x, Ac = Jx[:5]
        # ... and one over u
        _, Ju = _tangent_jacobians(fu, u, nu)
        Jr_u, Jhl_u, Jhq_u, Jg_u, Bc = Ju

        if sensitivity == "node":
            x_next = k1      # the caller completes the RK4 step with a batched flow
        else:
            # "midpoint": relinearize the flow at the RK4 midpoint (x-pass + u-pass)
            x_mid, t_mid = x + 0.5 * dt * k1, t + 0.5 * dt
            (k2,), (Ac,) = _tangent_jacobians(lambda x_: (flow(t_mid, x_, u),), x_mid, nx)
            _, (Bc,) = _tangent_jacobians(lambda u_: (flow(t_mid, x_mid, u_),), u, nu)
            x_next = rk4_tail(t, x, u, k1, k2)

        eye = torch.eye(nx, dtype=x.dtype, device=x.device)
        hA = dt * Ac
        S = eye + (hA / 2.0) @ (eye + (hA / 3.0) @ (eye + hA / 4.0))
        A_d = eye + hA @ S
        B_d = dt * (S @ Bc)
        Jr = torch.cat([Jr_x, Jr_u], dim=-1)
        Jhl = torch.cat([Jhl_x, Jhl_u], dim=-1)
        Jhq = torch.cat([Jhq_x, Jhq_u], dim=-1)
        Jg = torch.cat([Jg_x, Jg_u], dim=-1)
        return finish(x_next, A_d, B_d, r, h_log, h_quad, g, hmask, Jr, Jhl, Jhq, Jg, lam, rho,
                      nx)

    return node_lq_exact if sensitivity == "exact" else node_lq_fused


def _stage(params, nb: int):
    """The N stage nodes of per-node params [*batch, N+1, ...] (nb batch dims)."""
    return type(params)(*(a[(slice(None),) * nb + (slice(None, -1),)] for a in params))


def _last(params, nb: int):
    """The terminal node of per-node params [*batch, N+1, ...]."""
    return type(params)(*(a[(slice(None),) * nb + (-1,)] for a in params))


def flat_flow(flow_batch) -> Callable:
    """flow_batch(ts [B], xs [B, nx], us [B, nu]) over xs/us with any leading
    dims, flattened into one batch (one call, e.g. one K2 launch)."""
    def fb(ts, xs, us):
        shape = xs.shape
        out = flow_batch(ts.expand(shape[:-1]).reshape(-1), xs.reshape(-1, shape[-1]),
                         us.reshape(-1, us.shape[-1]))
        return out.reshape(shape)

    return fb


def batched_rk4_tail(fb, dt: float, times, xs, us, k1):
    """Finish RK4 from k1 at the batched level (3 calls of `fb`)."""
    k2 = fb(times + 0.5 * dt, xs + 0.5 * dt * k1, us)
    k3 = fb(times + 0.5 * dt, xs + 0.5 * dt * k2, us)
    k4 = fb(times + dt, xs + dt * k3, us)
    return xs + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


class LQFunctions(NamedTuple):
    """The closures of `make_lq_functions`, in JAX's order."""
    lq_approximation: Callable
    total_cost: Callable
    defects: Callable
    eq_residuals: Callable
    cost_and_violation: Callable
    candidate_perf: Callable


def make_lq_functions(ocp, flow, dt: float, N: int, bp: BarrierParams,
                      sensitivity: str = "exact", flow_batch=None) -> LQFunctions:
    """The six closures of JAX's `make_lq_functions` over full [N(+1), ...]
    trajectories (see `make_node_lq` for the per-node contract and the
    sensitivity modes). `total_cost`, `defects`, `eq_residuals`,
    `cost_and_violation` and `candidate_perf` also take trajectories with
    leading candidate dims and return one value per candidate.

    A leading batch of problem instances takes the place of JAX's `vmap`:
    `times` [*batch, N+1] carries the batch shape, and the trajectory, the
    params [*batch, N+1, ...] and the multipliers [*batch, N, nc] have it
    before their node axis (candidate dims go before the batch dims). Every
    reduction over nodes is per instance: the LQ's costs and norms have the
    batch shape, the stage data [*batch, N, ...].

    flow_batch(ts [B], xs [B,nx], us [B,nu]) -> xdots [B,nx] runs the pure RK4
    stages and rollouts outside the linearization (the CUDA FK kernel on the
    card, `models/wb_model.py::flow_map_batch`), over every candidate,
    instance and node in one call; the default is the batched `flow`, which
    is mathematically identical.
    """
    fb = flat_flow(flow if flow_batch is None else flow_batch)
    node_lq = make_node_lq(ocp, flow, dt, bp, sensitivity)

    def rk4_tail(times_s, xs_s, us, k1):
        return batched_rk4_tail(fb, dt, times_s, xs_s, us, k1)

    def terminal(traj, times, params):
        nb = times.dim() - 1
        return ocp.terminal_residual(times[..., -1], traj.xs[..., -1, :], _last(params, nb))

    def stage_terms(traj, times, params):
        return ocp.node_terms(times[..., :-1], traj.xs[..., :-1, :], traj.us,
                              _stage(params, times.dim() - 1))

    def lq_approximation(traj: Trajectory, times, params, lam, rho) -> LQApprox:
        xs, us = traj.xs, traj.us
        nb = times.dim() - 1
        (A, B, x_next, Qxx, Quu, Qux, qx, qu, costs, gmax,
         g_res, Cx, Du, c_pure, g_sse) = node_lq(times[..., :-1], xs[..., :-1, :], us,
                                                 _stage(params, nb), lam, rho)
        if sensitivity == "node":
            x_next = rk4_tail(times[..., :-1], xs[..., :-1, :], us, x_next)  # the slot held k1
        d = x_next - xs[..., 1:, :]

        # terminal quadratic (the residual is linear in x: its Jacobian is
        # taken by the same forward-mode rule)
        pT = _last(params, nb)
        tT = times[..., -1]

        def term_res(x):
            return (ocp.terminal_residual(tT, x, pT),)

        (rT,), (JT,) = _tangent_jacobians(term_res, xs[..., -1, :], xs.shape[-1])
        JTt = JT.transpose(-1, -2)
        QN = JTt @ JT
        qN = (JTt @ rT[..., None])[..., 0]
        term = 0.5 * torch.sum(rT ** 2, dim=-1)
        return LQApprox(A=A, B=B, d=d, Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu,
                        QN=QN, qN=qN, cost=torch.sum(costs, dim=-1) + term,
                        g_norm=torch.amax(gmax, dim=-1),
                        defect_norm=torch.amax(torch.abs(d), dim=(-2, -1)),
                        Cx=Cx, Du=Du, g_res=g_res,
                        cost_pure=torch.sum(c_pure, dim=-1) + term,
                        viol=torch.sqrt(torch.sum(g_sse, dim=-1)
                                        + torch.sum(d ** 2, dim=(-2, -1))))

    def total_cost(traj: Trajectory, times, params, lam, rho):
        """(nonlinear cost + AL terms, max |g|): the line-search merit's cost."""
        terms = stage_terms(traj, times, params)
        costs = node_cost_terms(terms, bp, lam, rho)
        rT = terminal(traj, times, params)
        return (torch.sum(costs, dim=-1) + 0.5 * torch.sum(rT ** 2, dim=-1),
                torch.amax(torch.abs(terms.g), dim=(-2, -1)))

    def cost_and_violation(traj: Trajectory, times, params):
        """(pure cost incl. barriers, SSE of equality residuals, max |g|): the
        ocs2 PerformanceIndex pieces of the filter line search."""
        terms = stage_terms(traj, times, params)
        costs = node_cost_terms(terms, bp, torch.zeros_like(terms.g), 1e-12)
        rT = terminal(traj, times, params)
        return (torch.sum(costs, dim=-1) + 0.5 * torch.sum(rT ** 2, dim=-1),
                torch.sum(terms.g ** 2, dim=(-2, -1)),
                torch.amax(torch.abs(terms.g), dim=(-2, -1)))

    def defects(traj: Trajectory, times):
        xs, us = traj.xs[..., :-1, :], traj.us
        k1 = fb(times[..., :-1], xs, us)
        return rk4_tail(times[..., :-1], xs, us, k1) - traj.xs[..., 1:, :]

    def eq_residuals(traj: Trajectory, times, params):
        return stage_terms(traj, times, params).g

    def candidate_perf(traj: Trajectory, times, params):
        """(pure cost, total violation) of line-search candidates: traj.xs
        [..., N+1, nx], traj.us [..., N, nu] with any leading candidate dims.
        One fused node sweep gives the terms and the RK4 k1; k2..k4 run
        batched through `flow_batch` over candidates x nodes."""
        xs, us = traj.xs, traj.us
        terms, k1 = ocp.fused_node(times[..., :-1], xs[..., :-1, :], us,
                                   _stage(params, times.dim() - 1))
        cs = node_cost_terms(terms, bp, torch.zeros_like(terms.g), 1e-12)
        g_sse = torch.sum(terms.g ** 2, dim=-1)
        x_next = rk4_tail(times[..., :-1], xs[..., :-1, :], us, k1)
        d = x_next - xs[..., 1:, :]
        rT = terminal(traj, times, params)
        return (torch.sum(cs, dim=-1) + 0.5 * torch.sum(rT ** 2, dim=-1),
                torch.sqrt(torch.sum(g_sse, dim=-1) + torch.sum(d ** 2, dim=(-2, -1))))

    return LQFunctions(lq_approximation, total_cost, defects, eq_residuals, cost_and_violation,
                       candidate_perf)
