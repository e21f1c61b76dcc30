"""L1 merit function for the SQP line search (counterpart of mpcgpu_tpu/ops/merit.py).

merit(X, U) = sum_k J_k + mu * ( sum_{k<N-1} ||x_{k+1} - f(x_k, u_k)||_1
                                 + ||x_0 - xs||_1 )

The candidates of the line search are one batch dimension, ahead of any
leading dimensions of X (an arm axis).
"""
from __future__ import annotations

from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops import cost as cost_ops
from mpcgpu_tpu_torch.ops import integrator as integ


def merit(model: RobotModel, X, U, goals, xs, dt, mu, qd_cost, r_cost,
          integrator_type: int = 0, gravity: float = 0.0,
          angle_wrap: bool = False, tracking: str = "eepos",
          q_cost: float = 1.0):
    """Merit of X (..., N, nx), U (..., N-1, nu); leading dims batch."""
    if tracking == "joint":
        J = cost_ops.trajectory_cost_joint(q_cost, qd_cost, r_cost, X, U, goals)
    else:
        J = cost_ops.trajectory_cost(model, qd_cost, r_cost, X, U, goals)
    defects = integ.defect_l1(model, X[..., :-1, :], U, X[..., 1:, :], dt,
                              integrator_type, gravity, angle_wrap)
    c0 = (X[..., 0, :] - xs).abs().sum(-1)
    return J + mu * (defects.sum(-1) + c0)


def line_search_merits(model: RobotModel, X, U, dX, dU, alphas, goals, xs,
                       dt, mu, qd_cost, r_cost, integrator_type: int = 0,
                       gravity: float = 0.0, angle_wrap: bool = False,
                       tracking: str = "eepos", q_cost: float = 1.0):
    """Merit of (X + a dX, U + a dU) for every candidate step size a:
    (len(alphas),) + X.shape[:-2]."""
    a = alphas.view((-1,) + (1,) * X.dim())
    return merit(model, X + a * dX, U + a * dU, goals, xs, dt, mu, qd_cost,
                 r_cost, integrator_type, gravity, angle_wrap, tracking,
                 q_cost)
