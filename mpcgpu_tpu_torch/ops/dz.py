"""Primal step recovery from the dual solution (counterpart of mpcgpu_tpu/ops/dz.py).

``lam`` solves S lam = gamma; the true KKT multiplier is -lam, so the
descent step applied with positive alphas is

    dx_k = -Qr_k^-1 (q_k - lam_k + A_k' lam_{k+1})   (no A term at k=N-1)
    du_k = -Rr_k^-1 (r_k + B_k' lam_{k+1})

(the reference's negated dz with negative alphas, dz.cuh:5-121).
Leading dimensions (an arm axis) batch.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.kkt import KKTData
from mpcgpu_tpu_torch.ops.schur import SchurData


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def compute_dz(kkt: KKTData, schur: SchurData, lam: torch.Tensor):
    """Returns (dX (..., N, nx), dU (..., N-1, nu))."""
    lam_next = lam[..., 1:, :]
    At_lam = _mtv(kkt.A, lam_next)
    rhs_x = kkt.q - lam + torch.cat([At_lam, torch.zeros_like(lam[..., :1, :])],
                                    dim=-2)
    dX = -(schur.Qinv @ rhs_x.unsqueeze(-1)).squeeze(-1)
    rhs_u = kkt.r + _mtv(kkt.B, lam_next)
    dU = -(schur.Rinv @ rhs_u.unsqueeze(-1)).squeeze(-1)
    return dX, dU
