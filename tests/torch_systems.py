"""Seeded test systems for the port's kernels, shared by the CPU tests,
the card tests and chip_smoke.py (which loads this file by path).

Imports no JAX and no pytest, so it serves on a machine without either.
"""
import numpy as np
import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv
from mpcgpu_tpu_torch.ops.cuda._lib import DEFAULT_KNOBS, Knobs
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
                            rho_factor, rho_min, rho_max, rho_reset,
                            knobs: Knobs = DEFAULT_KNOBS):
    """K9b's plain iteration (sqp.sqp_step over the plain K3 without the
    stair, dz and K2) with its dual solve replaced by lam, the kernel's
    own: what the kernel's stages after the solve must reproduce.  Two
    float32 exact solves of fixture 0_0's systems (condition ~1e7) part
    by ~1e-3 of |lam|, and dz carries that through Q^-1 (entries up to
    1/rho), so the solve is judged by residual and the rest against this.
    Returns (the iteration's IterResult, the system at X), under the
    knobs."""
    from mpcgpu_tpu_torch.sqp import staged_step

    ks = form_kkt_schur_reference(model, X, U, goals, xs, rho, dt, qd_cost,
                                  r_cost, gravity, False, knobs)

    def linearize_and_solve(Xc, Uc, lamc, rhoc):
        dX, dU = compute_dz_knots(ks, lam)
        zero = torch.zeros((), dtype=torch.int32, device=X.device)
        return lam, zero, zero.bool(), dX, dU

    def eval_merits(Xc, Uc, dX, dU):
        return line_search_merits_reference(
            model, Xc, Uc, dX, dU, num_alphas, goals, xs, dt, mu, qd_cost,
            r_cost, gravity, knobs)[:num_alphas]

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


# The solver knobs' cases of the tests and chip_smoke.py's "solver knobs"
# phase: each knob alone, and two combinations (joint tracking with
# semi-implicit Euler and the wrap; eepos with the Gauss-Newton Hessian,
# semi-implicit Euler and the wrap).
KNOB_CASES = {
    "joint": Knobs(tracking="joint", q_cost=2.0),
    "gauss_newton": Knobs(hessian="gauss_newton"),
    "semi_implicit": Knobs(integrator_type=1),
    "angle_wrap": Knobs(angle_wrap=True),
    "joint_semi_wrap": Knobs(tracking="joint", integrator_type=1,
                             angle_wrap=True, q_cost=2.0),
    "gn_semi_wrap": Knobs(hessian="gauss_newton", integrator_type=1,
                          angle_wrap=True),
}
WRAP_PI = 3.14159  # the reference's truncated pi (ops/integrator.py)


def knob_inputs(xu, ee, X, knobs: Knobs):
    """(X, goals) of a knob case, numpy float32, from fixture rows xu, ee
    and a start X (..., n, 14) near xu's first n states.  Under the angle
    wrap joints 0 and 3 are moved (X and the reference alike) so their
    means sit 0.03 inside +3.14159 and -3.14159: the predicted positions of
    some knots then cross the wrap (wrap_changes_defects checks it).
    goals: the (moved) state rows (n, 14) under joint tracking, else the
    end-effector rows (n, 6)."""
    n = X.shape[-2]
    ref = xu[:n, :14].astype(np.float32)
    if knobs.angle_wrap:
        shift = np.zeros(14, np.float32)
        shift[0] = WRAP_PI - 0.03 - ref[:, 0].mean()
        shift[3] = -WRAP_PI + 0.03 - ref[:, 3].mean()
        X, ref = X + shift, ref + shift
    goals = ref if knobs.tracking == "joint" else ee[:n]
    return (np.asarray(X, np.float32),
            np.ascontiguousarray(goals, np.float32))


def knob_start(xu, ee, n: int, knob=None, seed: int = 5, move: bool = True):
    """(X, U, goals, xs) numpy float32 of knob case `knob` (a KNOB_CASES
    name; None: the defaults): the fixture's first n states (its rows
    repeated past the last) moved by a 0.02 N(0, 1) draw from seed, knot 0
    kept, then as knob_inputs makes them (move=False: the wrap cases'
    joints left where the fixture has them)."""
    rows = np.resize(np.arange(xu.shape[0]), n)
    xu_n = xu[rows]
    pert = 0.02 * np.random.default_rng(seed).normal(size=(n, 14))
    pert[0] = 0.0
    kn = KNOB_CASES[knob] if knob else Knobs()
    X, goals = knob_inputs(xu_n, ee[rows], xu_n[:, :14] + pert,
                           kn if move else kn._replace(angle_wrap=False))
    U = np.ascontiguousarray(xu_n[:-1, 14:], np.float32)
    return X, U, goals, X[0].copy()


def wrap_changes_defects(model, X, U, dt, integrator_type: int = 0) -> bool:
    """Whether the angle wrap changes any knot's L1 defect at (X, U)."""
    from mpcgpu_tpu_torch.ops.integrator import defect_l1

    d = [defect_l1(model, X[..., :-1, :], U, X[..., 1:, :], dt,
                   integrator_type, wrap=w) for w in (False, True)]
    return not torch.equal(*d)


def as_float64(args):
    """args with every floating tensor in float64."""
    return tuple(a.double() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


# the default checks' (rtol, atol) of each yardstick field: the solves'
# (tests/test_megakernel.py:115-125) and K3's (tests/test_kkt_schur_pallas.py:33)
SOLVE_TOLS = {"X": (1e-3, 1e-5), "U": (1e-3, 1e-5), "lam": (1e-3, 1e-4)}
K3_TOLS = {f: (3e-3, 3e-3) for f in KnotSchur._fields}


# the default checks' (rtol, atol) of each yardstick field: the solves'
# (tests/test_megakernel.py:115-125) and K3's (tests/test_kkt_schur_pallas.py:33)
SOLVE_TOLS = {"X": (1e-3, 1e-5), "U": (1e-3, 1e-5), "lam": (1e-3, 1e-4)}
K3_TOLS = {f: (3e-3, 3e-3) for f in KnotSchur._fields}


def within_twice_plain(got, want, want64, tols, per_row: bool = False):
    """The knob cases where two float32 forms part by more than rounding
    (K3's near-singular position block, the solves of K5, K9p, K9b and
    K10; the host build or the card), held to the plain version run in
    float64: at each entry the kernel's distance to it is at most twice
    the float32 plain version's largest distance -- over the field, or
    (per_row) over the entry's row, the last axis -- plus the default
    check's rtol times the float64 entry and its atol (tols: {field:
    (rtol, atol)}, SOLVE_TOLS or K3_TOLS).  Where the float32 plain
    version agrees with float64 this is the default check, held to
    float64.  K3 is held per row: its near-singular entries sit in a few
    knots' position blocks (1e-2 to 0.16 of 3.4e4-sized bands on the H100
    at N = 64), and a field-wide scale would excuse every small entry.  A
    solve's float32 error spreads over every knot through the dual solve,
    so its scale is the field's: two float32 solves (kernel and plain) of
    the Gauss-Newton Q_pos + rho I, near singular at rho 1e-3, or of the
    wrapped defects (about pi), which keep the CG at its cap, part by up
    to 1e-2 there, each about as far from the float64 solve as the other,
    in patterns that differ row by row (K10 under the wrap, N = 8 and 64:
    2.2x the plain version's distance within a row, 0.6x over the field
    on the H100; PERF.md §6).  A solve under the wrap
    steers its iterates to the wrap's discontinuity, where one rounding
    decides a jump of pi (from the second iteration on, the float64 solve
    of the Gauss-Newton, semi-implicit and wrap case takes other steps
    than either float32 one), so the knob cases of the whole-solve
    kernels run one SQP iteration, as K9p and K9b do.  Returns {field:
    {"float64_err": the kernel's largest distance to float64,
    "plain_float64_err": the plain version's, "use": the largest share of
    an entry's allowance used}}."""
    report = {}
    for f, (rtol, atol) in tols.items():
        g, w, w64 = (getattr(r, f).double() for r in (got, want, want64))
        d_kernel, d_plain = (g - w64).abs(), (w - w64).abs()
        scale = (d_plain.amax(-1, keepdim=True) if per_row and d_plain.dim()
                 else d_plain.max())
        use = d_kernel / (2 * scale + rtol * w64.abs() + atol)
        report[f] = {"float64_err": float(d_kernel.max()),
                     "plain_float64_err": float(d_plain.max()),
                     "use": float(use.max())}
        assert report[f]["use"] <= 1.0, (f, report[f])
    return report


def residual_near_float64(ks: KnotSchur, lam, lam_plain, lam64) -> dict:
    """An exact dual solve of the float32 system ks judged by relative
    residual (relative_residual): at most three times that of the float64
    plain solve rounded to float32 -- the float32 system's own floor, what
    the exact duals of the float64 form of the same inputs leave in it.
    On the H100 K9b's residual over that floor spans 0.58-2.28 at N = 8
    (rho 1e-3, each knob case) and 1.18-1.53 at N = 64 (rho 0.1), and two
    float32 solves spread as widely: the plain solve's over the floor
    0.13-2.05 where it is stable.  The float32 plain solve's is returned
    beside it, not compared: under the Gauss-Newton Hessian at rho 1e-3 it
    reaches 0.16 (H100, N = 8) and 0.85 (host build), no yardstick.
    Returns the three residuals."""
    r = {"kernel": relative_residual(ks, lam),
         "plain": relative_residual(ks, lam_plain),
         "float64_rounded": relative_residual(ks, lam64.to(lam.dtype))}
    assert r["kernel"] <= 3 * r["float64_rounded"], r
    return r
