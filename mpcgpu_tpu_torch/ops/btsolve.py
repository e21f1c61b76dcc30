"""Exact block-tridiagonal solve by block cyclic reduction (counterpart of
mpcgpu_tpu/ops/btsolve.py), and the "bcr" and "bcr_pcg" linsys backends.

Each level eliminates the odd-indexed blocks of the active set (strided
slices over the knot axis), halving it; after log2(N) levels one block
is left, and back substitution rebuilds the eliminated rows level by
level.  Elimination of an SPD matrix under the odd-even permutation is
Cholesky-stable, so no pivoting.  N must be a power of 2.

``bcr_pcg`` is warm-started CG with the unrefined BCR solve as its
preconditioner.  Like ops/pcg.py, the loop runs ``max_iter`` steps with
every step after the exit masked out, so it equals the JAX while-loop
(same iteration count, same hit flag) and reads nothing on the host.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv
from mpcgpu_tpu_torch.ops.smallinv import spd_inverse


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def bcr_solve(S: BlockTri, gamma: torch.Tensor, refine: int = 1):
    """Solve S lam = gamma (gamma (N, s)); N must be a power of 2.

    refine: iterative-refinement passes (residual re-solves); float32
    cyclic reduction compounds rounding through log2(N) levels."""
    lam = _bcr_once(S, gamma)
    for _ in range(refine):
        lam = lam + _bcr_once(S, gamma - spmv(S, lam))
    return lam


def _bcr_once(S: BlockTri, gamma: torch.Tensor) -> torch.Tensor:
    n = gamma.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"bcr_solve needs a power-of-2 block count, got {n}")
    D, L, U, g = S.diag, S.lower, S.upper, gamma

    frozen = []  # per level: (Do, Lo, Uo, go, Dinv_o) of the odd rows
    while D.shape[0] > 1:
        m = D.shape[0] // 2
        De, Do = D[0::2], D[1::2]
        Le, Lo = L[0::2], L[1::2]
        Ue, Uo = U[0::2], U[1::2]
        ge, go = g[0::2], g[1::2]
        Dinv_o = spd_inverse(Do)
        # even row j has odd neighbours j-1 (j > 0) and j+1 (always: the
        # level size is even)
        LDm = Le[1:] @ Dinv_o[:m - 1]
        UDp = Ue @ Dinv_o

        D_new = De - UDp @ Lo
        D_new = torch.cat([D_new[:1], D_new[1:] - LDm @ Uo[:m - 1]])
        g_new = ge - _mv(UDp, go)
        g_new = torch.cat([g_new[:1], g_new[1:] - _mv(LDm, go[:m - 1])])
        L_new = torch.cat([torch.zeros_like(De[:1]), -(LDm @ Lo[:m - 1])])
        U_new = -(UDp @ Uo)
        U_new = torch.cat([U_new[:-1], torch.zeros_like(U_new[:1])])

        frozen.append((Lo, Uo, go, Dinv_o))
        D, L, U, g = D_new, L_new, U_new, g_new

    lam = _mv(spd_inverse(D), g)  # (1, s)
    for Lo, Uo, go, Dinv_o in reversed(frozen):
        lam_right = torch.cat([lam[1:], torch.zeros_like(lam[:1])])
        lam_odd = _mv(Dinv_o, go - _mv(Lo, lam) - _mv(Uo, lam_right))
        lam = torch.stack([lam, lam_odd], dim=1).reshape(-1, lam.shape[-1])
    return lam


def _solve_linsys_bcr(cfg, schur, lam, pcg_exit_tol):
    """Exact solve: iteration count 0, hit flag False."""
    dev = schur.gamma.device
    return (bcr_solve(schur.S, schur.gamma),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


def bcr_pcg(S: BlockTri, gamma, lam0, max_iter: int, exit_tol):
    """Warm-started CG on S lam = gamma with z = BCR(r) (unrefined) as the
    preconditioner; returns (lam, iters int32, hit_max bool)."""
    tol = torch.as_tensor(exit_tol, dtype=gamma.dtype, device=gamma.device)
    r = gamma - spmv(S, lam0)
    p = bcr_solve(S, r, refine=0)
    eta = (r * p).sum()
    lam = lam0
    iters = torch.zeros((), dtype=torch.int32, device=gamma.device)
    for _ in range(int(max_iter)):
        active = eta.abs() > tol
        up = spmv(S, p)
        alpha = eta / (p * up).sum()
        lam_n = lam + alpha * p
        r_n = r - alpha * up
        z = bcr_solve(S, r_n, refine=0)
        eta_n = (r_n * z).sum()
        p_n = z + (eta_n / eta) * p
        lam = torch.where(active, lam_n, lam)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        eta = torch.where(active, eta_n, eta)
        iters = iters + active.to(torch.int32)
    return lam, iters, eta.abs() > tol


def _solve_linsys_bcr_pcg(cfg, schur, lam, pcg_exit_tol):
    return bcr_pcg(schur.S, schur.gamma, lam, cfg.pcg.max_iter, pcg_exit_tol)
