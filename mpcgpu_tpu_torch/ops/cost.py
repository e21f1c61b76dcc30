"""Tracking cost, gradient and Hessian (counterpart of mpcgpu_tpu/ops/cost.py).

  J_k = 0.5 ||ee_xyz(q_k) - goal_k||^2 + 0.5 qd_cost ||qd_k||^2
        + 0.5 r_cost ||u_k||^2            (no u term at k = N-1)

or the joint-space variant with weight q_cost on the position error.
Everything is batched over the knot axis.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.models import dynamics as dyn
from mpcgpu_tpu_torch.models.robot import RobotModel


def _use_control(X, U):
    """U padded with a zero last row, and the k < N-1 mask."""
    n = X.shape[-2]
    Upad = torch.cat([U, torch.zeros_like(U[..., :1, :])], dim=-2)
    m = (torch.arange(n, device=X.device) < n - 1).to(X.dtype)
    return Upad, m


def knot_costs(model: RobotModel, qd_cost, r_cost, X, U, goals):
    """Per-knot eepos tracking costs (..., N)."""
    nq = X.shape[-1] // 2
    Upad, m = _use_control(X, U)
    q, qd = X[..., :nq], X[..., nq:]
    err = dyn.ee_pos(model, q)[..., :3] - goals[..., :3]
    cost = 0.5 * (err * err).sum(-1) + 0.5 * qd_cost * (qd * qd).sum(-1)
    return cost + m * 0.5 * r_cost * (Upad * Upad).sum(-1)


def joint_knot_costs(q_cost, qd_cost, r_cost, X, U, X_ref):
    """Per-knot joint-space tracking costs (..., N)."""
    nq = X.shape[-1] // 2
    Upad, m = _use_control(X, U)
    dq = X[..., :nq] - X_ref[..., :nq]
    dqd = X[..., nq:] - X_ref[..., nq:]
    cost = 0.5 * q_cost * (dq * dq).sum(-1) + 0.5 * qd_cost * (dqd * dqd).sum(-1)
    return cost + m * 0.5 * r_cost * (Upad * Upad).sum(-1)


def trajectory_cost(model, qd_cost, r_cost, X, U, goals):
    return knot_costs(model, qd_cost, r_cost, X, U, goals).sum(-1)


def trajectory_cost_joint(q_cost, qd_cost, r_cost, X, U, X_ref):
    return joint_knot_costs(q_cost, qd_cost, r_cost, X, U, X_ref).sum(-1)


def cost_gradient_and_hessian(model: RobotModel, qd_cost, r_cost, X, U, goals,
                              hessian: str = "reference"):
    """Per-knot (Q, q_grad, R, r_grad) for the eepos cost; X (N, nx),
    U (N, nu) with U already padded at the last knot.

    hessian="reference": the rank-1 g_q g_q' position block of the
    reference (iiwa_eepos_plant.cuh:363); "gauss_newton": J'J."""
    nq = X.shape[-1] // 2
    nx = X.shape[-1]
    q, qd = X[..., :nq], X[..., nq:]
    ee, J = dyn.ee_pos_and_jac(model, q)          # J: (..., 3, nq)
    err = ee[..., :3] - goals[..., :3]
    g_q = (J.transpose(-1, -2) @ err.unsqueeze(-1)).squeeze(-1)
    g = torch.cat([g_q, qd_cost * qd], dim=-1)
    if hessian == "reference":
        Q_pos = g_q.unsqueeze(-1) * g_q.unsqueeze(-2)
    elif hessian == "gauss_newton":
        Q_pos = J.transpose(-1, -2) @ J
    else:
        raise ValueError(f"unknown hessian mode {hessian!r}")
    return _assemble(Q_pos, qd_cost, r_cost, X, U, g)


def joint_space_gradient_and_hessian(q_cost, qd_cost, r_cost, X, U, X_ref):
    """Exact (diagonal) derivatives of the joint-space tracking cost."""
    nq = X.shape[-1] // 2
    g = torch.cat([q_cost * (X[..., :nq] - X_ref[..., :nq]),
                   qd_cost * (X[..., nq:] - X_ref[..., nq:])], dim=-1)
    eye = torch.eye(nq, dtype=X.dtype, device=X.device)
    Q_pos = (q_cost * eye).expand(X.shape[:-1] + (nq, nq))
    return _assemble(Q_pos, qd_cost, r_cost, X, U, g)


def _assemble(Q_pos, qd_cost, r_cost, X, U, g):
    nq = X.shape[-1] // 2
    nx, nu = X.shape[-1], U.shape[-1]
    Q = (qd_cost * torch.eye(nx, dtype=X.dtype, device=X.device)).repeat(
        X.shape[:-1] + (1, 1))
    Q = torch.cat([torch.cat([Q_pos, Q[..., :nq, nq:]], -1), Q[..., nq:, :]], -2)
    R = (r_cost * torch.eye(nu, dtype=X.dtype, device=X.device)).expand(
        U.shape[:-1] + (nu, nu))
    return Q, g, R, r_cost * U
