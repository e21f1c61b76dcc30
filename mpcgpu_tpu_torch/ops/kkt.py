"""KKT linearization over the horizon (counterpart of mpcgpu_tpu/ops/kkt.py).

Sign convention: A, B are kept positive (the reference stores C = [-A -B]).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops import cost as cost_ops
from mpcgpu_tpu_torch.ops import integrator as integ


class KKTData(NamedTuple):
    """Per-knot KKT blocks for N knots.

    Q (N, nx, nx), q (N, nx), R (N-1, nu, nu), r (N-1, nu),
    A (N-1, nx, nx), B (N-1, nx, nu),
    c (N, nx): c[0] = x0 - xs, c[k+1] = x_{k+1} - f(x_k, u_k).
    """

    Q: torch.Tensor
    q: torch.Tensor
    R: torch.Tensor
    r: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor


def form_kkt(model: RobotModel, X, U, goals, xs, dt, qd_cost, r_cost,
             integrator_type: int = 0, gravity: float = 0.0,
             hessian: str = "reference", angle_wrap: bool = False,
             tracking: str = "eepos", q_cost: float = 1.0) -> KKTData:
    """Linearize dynamics and cost around (X (N, nx), U (N-1, nu))."""
    A, B, err = integ.integrator_and_gradient(
        model, X[:-1], U, X[1:], dt, integrator_type, gravity, angle_wrap)
    Upad = torch.cat([U, torch.zeros_like(U[:1])], dim=0)
    if tracking == "joint":
        Q, q, R, r = cost_ops.joint_space_gradient_and_hessian(
            q_cost, qd_cost, r_cost, X, Upad, goals)
    else:
        Q, q, R, r = cost_ops.cost_gradient_and_hessian(
            model, qd_cost, r_cost, X, Upad, goals, hessian)
    c = torch.cat([(X[0] - xs)[None], err], dim=0)
    return KKTData(Q=Q, q=q, R=R[:-1], r=r[:-1], A=A, B=B, c=c)
