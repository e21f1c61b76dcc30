"""Schur condensation and the symmetric-stair preconditioner (counterpart of
mpcgpu_tpu/ops/schur.py, which documents the math).

    theta_0 = Qr_0^-1,  theta_k = A Qr^-1 A' + B Rr^-1 B' (of k-1) + Qr_k^-1
    Phi_k   = -A_{k-1} Qr_{k-1}^-1                       (S[k, k-1])
    gamma_0 = Qr_0^-1 q_0   (c_0 omitted, as in the reference)
    gamma_k = Qr_k^-1 q_k - A_{k-1} Qr_{k-1}^-1 q_{k-1}
              - B_{k-1} Rr_{k-1}^-1 r_{k-1} - c_k
    Pinv: diag theta_k^-1, lower -theta_k^-1 Phi_k theta_{k-1}^-1,
          upper -theta_k^-1 Phi_{k+1}' theta_{k+1}^-1
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.kkt import KKTData
from mpcgpu_tpu_torch.ops.smallinv import spd_inverse


class SchurData(NamedTuple):
    S: BlockTri            # PD Schur complement, block tridiagonal
    Pinv: BlockTri         # symmetric-stair preconditioner
    gamma: torch.Tensor    # (N, nx)
    Qinv: torch.Tensor     # (N, nx, nx) regularized cost-block inverses
    Rinv: torch.Tensor     # (N-1, nu, nu)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def form_schur(kkt: KKTData, rho, preconditioned: bool = True) -> SchurData:
    n, nx = kkt.Q.shape[0], kkt.Q.shape[-1]
    nu = kkt.R.shape[-1]
    dev, dt = kkt.Q.device, kkt.Q.dtype
    eye_x = torch.eye(nx, dtype=dt, device=dev)
    eye_u = torch.eye(nu, dtype=dt, device=dev)

    Qinv = spd_inverse(kkt.Q + rho * eye_x)
    Rinv = spd_inverse(kkt.R + rho * eye_u)

    AQi = kkt.A @ Qinv[:-1]
    BRi = kkt.B @ Rinv
    theta_rest = (AQi @ kkt.A.transpose(-1, -2)
                  + BRi @ kkt.B.transpose(-1, -2) + Qinv[1:])
    theta = torch.cat([Qinv[:1], theta_rest], dim=0)

    phi = -AQi
    zero_blk = torch.zeros((1, nx, nx), dtype=dt, device=dev)
    S = BlockTri(lower=torch.cat([zero_blk, phi], dim=0), diag=theta,
                 upper=torch.cat([phi.transpose(-1, -2), zero_blk], dim=0))

    Qiq = _mv(Qinv, kkt.q)
    gamma_rest = Qiq[1:] - _mv(AQi, kkt.q[:-1]) - _mv(BRi, kkt.r) - kkt.c[1:]
    gamma = torch.cat([Qiq[:1], gamma_rest], dim=0)

    if preconditioned:
        ti = spd_inverse(theta)
        pl = -(ti[1:] @ phi @ ti[:-1])
        pu = -(ti[:-1] @ phi.transpose(-1, -2) @ ti[1:])
        Pinv = BlockTri(lower=torch.cat([zero_blk, pl], dim=0), diag=ti,
                        upper=torch.cat([pu, zero_blk], dim=0))
    else:
        # ENABLE_PRECONDITIONING=0 ablation: identity preconditioner
        zeros = torch.zeros((n, nx, nx), dtype=dt, device=dev)
        Pinv = BlockTri(lower=zeros, diag=eye_x.expand(n, nx, nx).clone(),
                        upper=zeros.clone())
    return SchurData(S=S, Pinv=Pinv, gamma=gamma, Qinv=Qinv, Rinv=Rinv)
