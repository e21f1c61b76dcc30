"""Rigid-body dynamics in PyTorch (counterpart of mpcgpu_tpu/models/dynamics.py).

Featherstone's algorithms over the RobotModel tables.  Every function
takes configurations with arbitrary leading batch dimensions: q, qd, u
are (..., nj), so the knot axis is simply a batch dimension (the JAX
package vmaps single-configuration functions instead).  Spatial vectors
are [angular(3); linear(3)]; joints are revolute about local z.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.models.robot import RobotModel

_EZ = 2  # S = e_z in the angular slot


# ---------------------------------------------------------------------------
# spatial-algebra helpers
# ---------------------------------------------------------------------------

def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def _ez(like):
    e = torch.zeros(6, dtype=like.dtype, device=like.device)
    e[_EZ] = 1.0
    return e


def crm(v, m):
    """Motion cross product (v x) m."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([torch.linalg.cross(w, mw),
                      torch.linalg.cross(w, ml) + torch.linalg.cross(vl, mw)],
                     dim=-1)


def crf(v, f):
    """Force cross product (v x*) f = -crm(v)' f."""
    w, vl = v[..., :3], v[..., 3:]
    fw, fl = f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(w, fw) + torch.linalg.cross(vl, fl),
                      torch.linalg.cross(w, fl)], dim=-1)


def joint_transforms(model: RobotModel, q):
    """X_i(q_i): (..., nj, 6, 6) spatial motion transforms child <- parent."""
    s = torch.sin(q)[..., None, None]
    c = torch.cos(q)[..., None, None]
    return model.Xc + s * model.Xs + c * model.Xk


def hom_transforms(model: RobotModel, q):
    """(H_i, dH_i/dq_i), each (..., nj, 4, 4)."""
    s = torch.sin(q)[..., None, None]
    c = torch.cos(q)[..., None, None]
    return (model.Hc + s * model.Hs + c * model.Hk,
            model.dHc + s * model.dHs + c * model.dHk)


def _grav_accel(gravity, like):
    a = torch.zeros(like.shape[:-1] + (6,), dtype=like.dtype, device=like.device)
    return a + gravity * torch.eye(6, dtype=like.dtype, device=like.device)[5]


# ---------------------------------------------------------------------------
# end-effector kinematics
# ---------------------------------------------------------------------------

def _rpy(T):
    roll = torch.atan2(T[..., 2, 1], T[..., 2, 2])
    pitch = -torch.atan2(T[..., 2, 0],
                         torch.sqrt(T[..., 2, 1] ** 2 + T[..., 2, 2] ** 2))
    yaw = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def ee_transform(model: RobotModel, q):
    H, _ = hom_transforms(model, q)
    T = H[..., 0, :, :]
    for i in range(1, model.num_joints):
        T = T @ H[..., i, :, :]
    return T


def ee_pos(model: RobotModel, q):
    """(..., 6): [x, y, z, roll, pitch, yaw] of the end effector."""
    T = ee_transform(model, q)
    return torch.cat([T[..., :3, 3], _rpy(T)], dim=-1)


def ee_pos_and_jac(model: RobotModel, q):
    """EE pose (..., 6) and the xyz position Jacobian (..., 3, nj), from
    prefix/suffix products with the dH tables."""
    nj = model.num_joints
    H, dH = hom_transforms(model, q)
    eye = torch.eye(4, dtype=q.dtype, device=q.device).expand(H.shape[:-3] + (4, 4))
    prefix = [eye]
    for i in range(nj):
        prefix.append(prefix[-1] @ H[..., i, :, :])
    suffix = [eye]
    for i in range(nj - 1, -1, -1):
        suffix.append(H[..., i, :, :] @ suffix[-1])
    suffix = suffix[::-1]  # suffix[i] = H_i .. H_{nj-1}
    T = prefix[nj]
    dpos = torch.stack(
        [(prefix[j] @ dH[..., j, :, :] @ suffix[j + 1])[..., :3, 3]
         for j in range(nj)], dim=-1)
    return torch.cat([T[..., :3, 3], _rpy(T)], dim=-1), dpos


# ---------------------------------------------------------------------------
# inverse dynamics (RNEA) and the mass matrix
# ---------------------------------------------------------------------------

def rnea(model: RobotModel, q, qd, qdd, gravity: float = 0.0):
    """Recursive Newton-Euler: joint torques (..., nj) for (q, qd, qdd)."""
    nj = model.num_joints
    X = joint_transforms(model, q)
    ez = _ez(q)
    a_prev = _grav_accel(gravity, q)
    v_prev = torch.zeros_like(a_prev)
    fs = []
    for i in range(nj):
        Xi = X[..., i, :, :]
        Sqd = ez * qd[..., i, None]
        vi = _mv(Xi, v_prev) + Sqd
        ai = _mv(Xi, a_prev) + ez * qdd[..., i, None]
        ai = ai + crm(vi, Sqd)
        fs.append(_mv(model.I[i], ai) + crf(vi, _mv(model.I[i], vi)))
        v_prev, a_prev = vi, ai
    tau = [None] * nj
    f = fs[nj - 1]
    for i in range(nj - 1, -1, -1):
        tau[i] = f[..., _EZ]
        if i > 0:
            f = fs[i - 1] + _mtv(X[..., i, :, :], f)
    return torch.stack(tau, dim=-1)


def bias_force(model: RobotModel, q, qd, gravity: float = 0.0):
    """c(q, qd) = RNEA(q, qd, 0)."""
    return rnea(model, q, qd, torch.zeros_like(q), gravity)


def mass_matrix(model: RobotModel, q):
    """Composite-rigid-body algorithm: M(q), (..., nj, nj) symmetric PD."""
    nj = model.num_joints
    X = joint_transforms(model, q)
    Ic = [model.I[i].expand(X.shape[:-3] + (6, 6)) for i in range(nj)]
    for i in range(nj - 1, 0, -1):
        Xi = X[..., i, :, :]
        Ic[i - 1] = Ic[i - 1] + Xi.transpose(-1, -2) @ Ic[i] @ Xi
    F = [Ic[i][..., :, _EZ] for i in range(nj)]  # row i: Ic_i S
    M = [[None] * nj for _ in range(nj)]
    for i in range(nj):
        M[i][i] = F[i][..., _EZ]
    for j in range(nj - 1, 0, -1):
        for i in range(j, nj):
            F[i] = _mtv(X[..., j, :, :], F[i])
            M[i][j - 1] = M[j - 1][i] = F[i][..., _EZ]
    return torch.stack([torch.stack(row, dim=-1) for row in M], dim=-2)


def minv(model: RobotModel, q):
    """M(q)^{-1} via the block-recursive SPD inverse (ops/smallinv)."""
    from mpcgpu_tpu_torch.ops.smallinv import spd_inverse

    return spd_inverse(mass_matrix(model, q))


# ---------------------------------------------------------------------------
# forward dynamics and its gradient
# ---------------------------------------------------------------------------

def forward_dynamics(model: RobotModel, q, qd, u, gravity: float = 0.0):
    """Articulated-body algorithm: qdd = M^{-1}(u - c), no factorization."""
    nj = model.num_joints
    X = joint_transforms(model, q)
    ez = _ez(q)
    batch = X.shape[:-3]

    # pass 1 (outward): velocities, velocity-product accels, bias forces
    v_prev = torch.zeros(batch + (6,), dtype=q.dtype, device=q.device)
    cvel, pA = [], []
    for i in range(nj):
        Sqd = ez * qd[..., i, None]
        vi = _mv(X[..., i, :, :], v_prev) + Sqd
        cvel.append(crm(vi, Sqd))
        pA.append(crf(vi, _mv(model.I[i], vi)))
        v_prev = vi

    # pass 2 (inward): articulated inertias
    IA = [model.I[i].expand(batch + (6, 6)) for i in range(nj)]
    Uc, dc, uc = [None] * nj, [None] * nj, [None] * nj
    for i in range(nj - 1, -1, -1):
        Ui = IA[i][..., :, _EZ]
        di = Ui[..., _EZ]
        ui = u[..., i] - pA[i][..., _EZ]
        Uc[i], dc[i], uc[i] = Ui, di, ui
        if i > 0:
            Xi = X[..., i, :, :]
            Ia = IA[i] - Ui.unsqueeze(-1) * Ui.unsqueeze(-2) / di[..., None, None]
            pa = pA[i] + _mv(Ia, cvel[i]) + Ui * (ui / di)[..., None]
            IA[i - 1] = IA[i - 1] + Xi.transpose(-1, -2) @ Ia @ Xi
            pA[i - 1] = pA[i - 1] + _mtv(Xi, pa)

    # pass 3 (outward): accelerations
    a_prev = _grav_accel(gravity, v_prev)
    qdd = []
    for i in range(nj):
        ai = _mv(X[..., i, :, :], a_prev) + cvel[i]
        qdd_i = (uc[i] - (Uc[i] * ai).sum(-1)) / dc[i]
        qdd.append(qdd_i)
        a_prev = ai + ez * qdd_i[..., None]
    return torch.stack(qdd, dim=-1)


def fd_and_gradient(model: RobotModel, q, qd, u, gravity: float = 0.0):
    """(qdd, dqdd_dq, dqdd_dqd, Minv), batched over leading dims.

        qdd          = Minv (u - c(q, qd))
        dqdd/d(q,qd) = -Minv dID(q, qd; qdd)/d(q,qd)

    with the inverse-dynamics Jacobian by forward-mode AD
    (torch.func.jacfwd) through the RNEA recursion.
    """
    nj = model.num_joints
    Mi = minv(model, q)
    c = bias_force(model, q, qd, gravity)
    qdd = _mv(Mi, u - c)

    def id_tau(x, acc):
        return rnea(model, x[:nj], x[nj:], acc, gravity)

    jac = torch.func.jacfwd(id_tau, argnums=0)
    x = torch.cat([q, qd], dim=-1)
    batch = x.shape[:-1]
    dtau = torch.func.vmap(jac)(x.reshape(-1, 2 * nj), qdd.reshape(-1, nj))
    dtau = dtau.reshape(batch + (nj, 2 * nj))
    dqdd = -(Mi @ dtau)
    return qdd, dqdd[..., :nj], dqdd[..., nj:], Mi
