"""Explicit / semi-implicit Euler and its gradient (counterpart of
mpcgpu_tpu/ops/integrator.py), batched over leading knot dimensions."""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.models import dynamics as dyn
from mpcgpu_tpu_torch.models.robot import RobotModel


def angle_wrap(q):
    """Reflect joint angles that leave (-pi, pi) back into range, with the
    reference's truncated pi and reflection (integrator.cuh:13-19)."""
    pi = 3.14159
    q = torch.where(q > pi, -(q - pi), q)
    return torch.where(q < -pi, -(q + pi), q)


def integrate(model: RobotModel, x, u, dt, integrator_type: int = 0,
              gravity: float = 0.0, wrap: bool = False):
    """x_{k+1} = f(x_k, u_k): one explicit (0) or semi-implicit (1) Euler step."""
    nq = x.shape[-1] // 2
    q, qd = x[..., :nq], x[..., nq:]
    qdd = dyn.forward_dynamics(model, q, qd, u, gravity)
    if integrator_type == 0:
        q_new = q + dt * qd
        qd_new = qd + dt * qdd
    elif integrator_type == 1:
        qd_new = qd + dt * qdd
        q_new = q + dt * qd_new
    else:
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if wrap:
        q_new = angle_wrap(q_new)
    return torch.cat([q_new, qd_new], dim=-1)


def integrator_and_gradient(model: RobotModel, x, u, x_next, dt,
                            integrator_type: int = 0, gravity: float = 0.0,
                            wrap: bool = False):
    """(A, B, err) per knot: A = df/dx, B = df/du, err = x_next - f(x, u).

    As in the reference, ANGLE_WRAP changes only the defect, never the
    gradient."""
    nq = x.shape[-1] // 2
    nu = u.shape[-1]
    q, qd = x[..., :nq], x[..., nq:]
    qdd, dq, dqd, Minv = dyn.fd_and_gradient(model, q, qd, u, gravity)
    Iq = torch.eye(nq, dtype=x.dtype, device=x.device).expand(dq.shape)
    if integrator_type == 0:
        A = torch.cat([torch.cat([Iq, dt * Iq], -1),
                       torch.cat([dt * dq, Iq + dt * dqd], -1)], -2)
        B = torch.cat([torch.zeros_like(Minv[..., :, :nu]), dt * Minv], -2)
        q_new = q + dt * qd
        qd_new = qd + dt * qdd
    elif integrator_type == 1:
        A = torch.cat([torch.cat([Iq + dt * dt * dq, dt * Iq + dt * dt * dqd], -1),
                       torch.cat([dt * dq, Iq + dt * dqd], -1)], -2)
        B = torch.cat([dt * dt * Minv, dt * Minv], -2)
        qd_new = qd + dt * qdd
        q_new = q + dt * qd_new
    else:
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if wrap:
        q_new = angle_wrap(q_new)
    err = x_next - torch.cat([q_new, qd_new], dim=-1)
    return A, B, err


def defect_l1(model: RobotModel, x, u, x_next, dt, integrator_type: int = 0,
              gravity: float = 0.0, wrap: bool = False):
    """||x_next - f(x, u)||_1 per knot: the merit's constraint term."""
    return (x_next - integrate(model, x, u, dt, integrator_type, gravity,
                               wrap)).abs().sum(-1)
