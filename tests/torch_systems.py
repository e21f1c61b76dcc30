"""Seeded test systems for the port's kernels, shared by the CPU tests,
the card tests and chip_smoke.py (which loads this file by path).

Imports no JAX and no pytest, so it serves on a machine without either.
"""
import numpy as np
import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import (
    KnotSchur, compute_dz_knots, form_kkt_schur_reference)
from mpcgpu_tpu_torch.ops.cuda.merit_kernel import (
    alphas_for, line_search_merits_reference)
from mpcgpu_tpu_torch.ops.kkt import KKTData
from mpcgpu_tpu_torch.ops.schur import form_schur


def random_system(n, seed=11, rho=1e-3, precond=False):
    """The JAX BCR tests' random KKT system (tests/test_schur_pcg.py
    random_kkt), condensed by the port's form_schur (without the stair
    preconditioner unless precond); numpy arrays in the KnotSchur
    layout."""
    nx, nu = 14, 7
    rng = np.random.default_rng(seed)
    f = np.float32
    M = rng.normal(size=(n, nx, nx)).astype(f)
    Q = 0.1 * np.einsum("kij,klj->kil", M, M) + np.eye(nx, dtype=f)
    Rm = rng.normal(size=(n - 1, nu, nu)).astype(f)
    R = 0.1 * np.einsum("kij,klj->kil", Rm, Rm) + np.eye(nu, dtype=f)
    A = 0.3 * rng.normal(size=(n - 1, nx, nx)).astype(f)
    B = 0.3 * rng.normal(size=(n - 1, nx, nu)).astype(f)
    q = rng.normal(size=(n, nx)).astype(f)
    r = rng.normal(size=(n - 1, nu)).astype(f)
    c = rng.normal(size=(n, nx)).astype(f)
    c[0] = 0.0
    kkt = KKTData(*(torch.as_tensor(v) for v in (Q, q, R, r, A, B, c)))
    sd = form_schur(kkt, rho, preconditioned=precond)
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:1])]).numpy()
    return dict(SL=sd.S.lower.numpy(), SD=sd.S.diag.numpy(),
                SU=sd.S.upper.numpy(), PL=sd.Pinv.lower.numpy(),
                PD=sd.Pinv.diag.numpy(), PU=sd.Pinv.upper.numpy(),
                gamma=sd.gamma.numpy(), Qinv=sd.Qinv.numpy(),
                Rinv=pad(sd.Rinv), A=pad(kkt.A), B=pad(kkt.B),
                q=kkt.q.numpy(), r=pad(kkt.r))


def random_knot_schur(n, seed=11, device="cpu"):
    """random_system as a KnotSchur of tensors on device."""
    return KnotSchur(**{f: torch.as_tensor(v, device=device)
                        for f, v in random_system(n, seed).items()})


def relative_residual(ks: KnotSchur, lam) -> float:
    """||S lam - gamma|| / ||gamma|| (2-norms over every entry)."""
    r = spmv(BlockTri(ks.SL, ks.SD, ks.SU), lam) - ks.gamma
    return float(r.norm() / ks.gamma.norm())


def bcr_iteration_given_lam(model, X, U, goals, xs, rho, drho, merit, lam,
                            dt, qd_cost, r_cost, gravity, mu, num_alphas,
                            rho_factor, rho_min, rho_max, rho_reset):
    """K9b's plain iteration (sqp.sqp_step over the plain K3 without the
    stair, dz and K2) with its dual solve replaced by lam, the kernel's
    own: what the kernel's stages after the solve must reproduce.  Two
    float32 exact solves of fixture 0_0's systems (condition ~1e7) part
    by ~1e-3 of |lam|, and dz carries that through Q^-1 (entries up to
    1/rho), so the solve is judged by residual and the rest against this.
    Returns (the iteration's IterResult, the system at X)."""
    from mpcgpu_tpu_torch.sqp import staged_step

    ks = form_kkt_schur_reference(model, X, U, goals, xs, rho, dt, qd_cost,
                                  r_cost, gravity, False)

    def linearize_and_solve(Xc, Uc, lamc, rhoc):
        dX, dU = compute_dz_knots(ks, lam)
        zero = torch.zeros((), dtype=torch.int32, device=X.device)
        return lam, zero, zero.bool(), dX, dU

    def eval_merits(Xc, Uc, dX, dU):
        return line_search_merits_reference(
            model, Xc, Uc, dX, dU, num_alphas, goals, xs, dt, mu, qd_cost,
            r_cost, gravity)[:num_alphas]

    f32 = dict(dtype=X.dtype, device=X.device)
    step = staged_step(linearize_and_solve, eval_merits,
                       alphas_for(num_alphas, X), rho_factor, rho_min,
                       rho_max, rho_reset)
    return step(X, U, lam, torch.as_tensor(rho, **f32),
                torch.as_tensor(drho, **f32),
                torch.as_tensor(merit, **f32)), ks


def packed_arms(xu, ee, n, b, seed, device="cpu"):
    """b arms as chip_smoke.py's K10 check makes them: fixture 0_0's first n
    states, arm a's perturbed by 0.02 N(0, 1) from seed + a with knot 0
    kept, the recorded controls, the shared end-effector goals and start
    expanded over the arms: (X (b, n, 14), U (b, n-1, 7), goals (b, n, 6),
    xs (b, 14))."""
    perts = []
    for a in range(b):
        pert = 0.02 * np.random.default_rng(seed + a).normal(size=(n, 14))
        pert[0] = 0.0
        perts.append(xu[:n, :14] + pert)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (t(np.stack(perts)), t(np.stack([xu[:n - 1, 14:]] * b)),
            t(ee[:n]).expand(b, n, 6), t(xu[0, :14]).expand(b, 14).contiguous())


def with_resting_arm(X, U, goals, xs):
    """The arms given, and one more at rest: every knot at q = 0, qd = 0,
    u = 0, its start there, its goal (0, 0, 1) above the base.  With no
    gravity the arm's defects are exactly zero (no bias force moves it),
    so are its cost gradients (its end effector is on the base's axis,
    where every joint moves it sideways only: the x and y errors and the
    height's derivatives are exact zeros) and so its Schur right-hand side
    gamma: from cold duals its CG residual is exactly zero, and the packed
    CG's 0/0 -> 0 keeps it there.  Goals come out per arm (contiguous)."""
    b, n = X.shape[:2]
    z = lambda t: torch.zeros((1,) + t.shape[1:], dtype=t.dtype,
                              device=t.device)
    g = z(goals)
    g[0, :, 2] = 1.0
    return (torch.cat([X, z(X)]), torch.cat([U, z(U)]),
            torch.cat([goals, g]).contiguous(), torch.cat([xs, z(xs)]))
