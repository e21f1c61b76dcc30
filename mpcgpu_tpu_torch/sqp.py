"""The SQP trajectory optimizer (counterpart of mpcgpu_tpu/sqp.py).

Each iteration: KKT linearization and Schur condensation, the dual solve
S lam = gamma (warm-started), primal step recovery, an 8-candidate line
search on the L1 merit (alpha = 1/2^i), and the Levenberg rho schedule
of the reference (pcg/sqp.cuh:373-408):

  * accept the best candidate iff its merit beats the incumbent;
  * on reject: drho = max(drho*f, f), rho = max(rho*drho, rho_min), and
    bail out when rho > rho_max, resetting rho to rho_reset;
  * on accept: drho = min(drho/f, 1/f), rho = max(rho*drho, rho_min).

The solve always runs ``sqp_max_iter`` iterations: once a rho bail
happens, every later iteration is masked and leaves the state frozen, as
the JAX package's whole-solve megakernel does.  So nothing in a solve
reads a device value on the host.

The plain path also takes B arms at once, written out as a leading arm
axis (X (B, N, nx), rho (B,)) rather than through ``torch.func.vmap``:
every stage batches over leading dimensions already, and ``iterate``
keeps the accept test, rho, drho, merit and bail per arm.

``cfg.fused_stages`` selects the hand-written kernels.  With
``megakernel`` and ``megakernel_solve`` on the "pcg" backend, K2 computes
the starting merit and ONE K5 launch runs every iteration of the solve;
otherwise each iteration runs K3 (KKT + Schur, with the stair
preconditioner for "pcg"), then K4 (stair-PCG + dz) or, for "bcr_pcg", K6
(BCR-preconditioned CG + dz), then K2 (line-search merits).  Off, the
plain PyTorch modules run on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops import merit as merit_ops
from mpcgpu_tpu_torch.ops.btsolve import (_solve_linsys_bcr,
                                          _solve_linsys_bcr_pcg)
from mpcgpu_tpu_torch.ops.cuda.bcr_kernel import bcr_pcg_dz
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import form_kkt_schur
from mpcgpu_tpu_torch.ops.cuda.merit_kernel import line_search_merits
from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import pcg_dz
from mpcgpu_tpu_torch.ops.cuda.sqp_megakernel import sqp_solve_mega_pcg
from mpcgpu_tpu_torch.ops.dz import compute_dz
from mpcgpu_tpu_torch.ops.kkt import form_kkt
from mpcgpu_tpu_torch.ops.pcg import pcg
from mpcgpu_tpu_torch.ops.schur import form_schur


class SQPStats(NamedTuple):
    """Per-solve statistics (the reference's 10-tuple, pcg/sqp.cuh:463-474)."""

    pcg_iters: torch.Tensor    # (sqp_max_iter,) int32, -1 where not run
    pcg_hit_max: torch.Tensor  # (sqp_max_iter,) bool
    accepted: torch.Tensor     # (sqp_max_iter,) bool
    sqp_iters: torch.Tensor    # int32 count of iterations executed
    rho_bailed: torch.Tensor   # bool: aborted because rho > rho_max
    final_merit: torch.Tensor


class SQPResult(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    lam: torch.Tensor
    rho: torch.Tensor
    stats: SQPStats


def _solve_linsys_pcg(cfg: SolverConfig, schur, lam, pcg_exit_tol):
    # per-arm freeze on an arm axis: jax.vmap of the single-arm loop
    res = pcg(schur.S, schur.Pinv, schur.gamma, lam,
              max_iter=cfg.pcg.max_iter, exit_tol=pcg_exit_tol)
    return res.lam, res.iters, res.hit_max


_LINSYS_BACKENDS = {"pcg": _solve_linsys_pcg, "bcr": _solve_linsys_bcr,
                    "bcr_pcg": _solve_linsys_bcr_pcg}


def register_linsys_backend(name: str, fn) -> None:
    """The pluggable linear-system-solver seam: fn(cfg, schur, lam, tol)
    -> (lam, iters, hit_max)."""
    _LINSYS_BACKENDS[name] = fn


def get_linsys_backend(name: str):
    try:
        return _LINSYS_BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown linsys backend {name!r}; available: "
                       f"{sorted(_LINSYS_BACKENDS)}") from None


def megakernel_engages(cfg: SolverConfig, linsys: str) -> bool:
    """Whether sqp_solve runs the SQP iteration as one kernel.  The port
    has none of the TPU's envelope gates: the kernels' own fit checks
    raise past the horizons they serve."""
    return bool(cfg.fused_stages and cfg.megakernel and linsys == "pcg")


def check_fused_config(cfg: SolverConfig, linsys: str) -> None:
    """Raise unless the CUDA kernels serve this configuration; name the
    kernel where the configuration needs one not ported yet."""
    if linsys == "bcr":
        raise ValueError(
            "fused_stages=True with linsys='bcr' runs the refined BCR solve "
            "kernel K7 (bcr_dz_pallas_lanes), which is not ported yet")
    if megakernel_engages(cfg, linsys) and not cfg.megakernel_solve:
        raise ValueError(
            "megakernel=True without megakernel_solve runs the "
            "per-iteration megakernel K9 (sqp_iter_mega_pcg), which is not "
            "ported yet")
    unsupported = []
    if linsys not in ("pcg", "bcr_pcg"):
        unsupported.append(f"linsys={linsys!r}")
    if cfg.cost.tracking != "eepos":
        unsupported.append(f"tracking={cfg.cost.tracking!r}")
    if cfg.cost.hessian != "reference":
        unsupported.append(f"hessian={cfg.cost.hessian!r}")
    if cfg.integrator_type != 0:
        unsupported.append(f"integrator_type={cfg.integrator_type}")
    if cfg.angle_wrap:
        unsupported.append("angle_wrap=True")
    if cfg.dtype != "float32":
        unsupported.append(f"dtype={cfg.dtype!r}")
    if (cfg.state_size, cfg.control_size) != (14, 7):
        unsupported.append(f"nx, nu = {cfg.state_size}, {cfg.control_size}")
    if unsupported:
        raise ValueError("fused_stages=True: the CUDA stage kernels do not "
                         f"serve {', '.join(unsupported)}")


def sqp_solve(model: RobotModel, cfg: SolverConfig, X, U, lam, goals, xs,
              rho, pcg_exit_tol: float, linsys: str = "pcg") -> SQPResult:
    """Run cfg.sqp_max_iter SQP iterations from (X (N, nx), U (N-1, nu))
    with warm duals lam (N, nx), goals (N, 6), measured state xs (nx,).

    rho: Levenberg regularizer carried across solves (tensor or number).
    pcg_exit_tol: host number, the CG exit threshold on |r' Pinv r|.

    With fused_stages off and linsys="pcg", B arms solve at once: X, U,
    lam, xs and rho with a leading arm axis (goals shared (N, 6) or per
    arm), stats per arm (module doc).
    """
    n_iter = cfg.sqp_max_iter
    dev, dt = X.device, X.dtype
    alphas = 0.5 ** torch.arange(cfg.num_alphas, dtype=dt, device=dev)
    cc = cfg.cost
    rho = torch.as_tensor(rho, dtype=dt, device=dev)
    if X.dim() > 2 and (cfg.fused_stages or linsys != "pcg"):
        raise ValueError("an arm axis runs the plain modules with linsys="
                         "'pcg' (the arm-packed kernel path is "
                         "ops.cuda.sqp_megakernel.sqp_solve_mega_pcg_packed)")

    if cfg.fused_stages:
        check_fused_config(cfg, linsys)

        def merits_with_base(Xc, Uc, dX, dU):
            return line_search_merits(
                model, Xc, Uc, dX, dU, cfg.num_alphas, goals, xs,
                cfg.timestep, cfg.merit_mu, cc.qd_cost, cc.r_cost,
                cfg.gravity)

        def eval_merits(Xc, Uc, dX, dU):
            return merits_with_base(Xc, Uc, dX, dU)[:cfg.num_alphas]

        def merit_of(Xc, Uc):
            return merits_with_base(Xc, Uc, torch.zeros_like(Xc),
                                    torch.zeros_like(Uc))[cfg.num_alphas]

        if megakernel_engages(cfg, linsys):
            r = sqp_solve_mega_pcg(
                model, X, U, goals, xs, lam, rho, 1.0, merit_of(X, U),
                cfg.pcg.max_iter, pcg_exit_tol, n_iter, cfg.timestep,
                cc.qd_cost, cc.r_cost, cfg.gravity, cfg.merit_mu,
                cfg.num_alphas, cfg.rho_factor, cfg.rho_min, cfg.rho_max,
                cfg.rho_reset)
            stats = SQPStats(pcg_iters=r.pcg_iters, pcg_hit_max=r.hit_max,
                             accepted=r.accepted, sqp_iters=r.sqp_iters,
                             rho_bailed=r.bailed, final_merit=r.merit)
            return SQPResult(X=r.X, U=r.U, lam=r.lam, rho=r.rho, stats=stats)

        bcr = linsys == "bcr_pcg"
        dual_solve = bcr_pcg_dz if bcr else pcg_dz

        def linearize_and_solve(Xc, Uc, lamc, rhoc):
            ks = form_kkt_schur(model, Xc, Uc, goals, xs, rhoc, cfg.timestep,
                                cc.qd_cost, cc.r_cost, cfg.gravity,
                                cfg.pcg.preconditioned and not bcr)
            lam_new, dX, dU, it, hit = dual_solve(ks, lamc, cfg.pcg.max_iter,
                                                  pcg_exit_tol)
            return lam_new, it, hit, dX, dU
    else:
        solve_fn = get_linsys_backend(linsys)
        mkw = dict(integrator_type=cfg.integrator_type, gravity=cfg.gravity,
                   angle_wrap=cfg.angle_wrap, tracking=cc.tracking,
                   q_cost=cc.q_cost)

        def eval_merits(Xc, Uc, dX, dU):
            return merit_ops.line_search_merits(
                model, Xc, Uc, dX, dU, alphas, goals, xs, cfg.timestep,
                cfg.merit_mu, cc.qd_cost, cc.r_cost, **mkw)

        def merit_of(Xc, Uc):
            return merit_ops.merit(model, Xc, Uc, goals, xs, cfg.timestep,
                                   cfg.merit_mu, cc.qd_cost, cc.r_cost, **mkw)

        def linearize_and_solve(Xc, Uc, lamc, rhoc):
            kkt = form_kkt(model, Xc, Uc, goals, xs, cfg.timestep, cc.qd_cost,
                           cc.r_cost, cfg.integrator_type, cfg.gravity,
                           cc.hessian, cfg.angle_wrap, cc.tracking,
                           cc.q_cost)
            schur = form_schur(kkt, rhoc, preconditioned=cfg.pcg.preconditioned)
            lam_new, it, hit = solve_fn(cfg, schur, lamc, pcg_exit_tol)
            dX, dU = compute_dz(kkt, schur, lam_new)
            return lam_new, it, hit, dX, dU

    (X, U, lam, rho, _drho, merit, iters, done, pcg_iters, hits,
     accepts) = iterate(X, U, lam, rho, torch.ones_like(rho),
                        merit_of(X, U), n_iter, linearize_and_solve,
                        eval_merits, alphas, cfg.rho_factor, cfg.rho_min,
                        cfg.rho_max, cfg.rho_reset)
    stats = SQPStats(pcg_iters=pcg_iters, pcg_hit_max=hits, accepted=accepts,
                     sqp_iters=iters, rho_bailed=done, final_merit=merit)
    return SQPResult(X=X, U=U, lam=lam, rho=rho, stats=stats)


def iterate(X, U, lam, rho, drho, merit, n_iter: int, linearize_and_solve,
            eval_merits, alphas, rho_factor, rho_min, rho_max, rho_reset):
    """The staged SQP loop: n_iter iterations from incumbent merit
    `merit`, each linearize_and_solve(X, U, lam, rho) -> (lam', pcg iters,
    hit, dX, dU), eval_merits(X, U, dX, dU) -> merits of the alphas
    (candidates first), the first minimum, the accept test and the rho
    schedule; after a bail every iteration is masked.  rho, drho and
    merit may carry an arm axis (B,), with X (B, N, nx): every decision
    is then per arm, and a bailed arm is frozen while the others go on.
    Returns (X, U, lam, rho, drho, merit, sqp_iters, bailed, pcg_iters,
    hit_max, accepted), the last three stacked over iterations first."""
    dev = X.device
    done = torch.zeros(rho.shape, dtype=torch.bool, device=dev)
    iters = torch.zeros(rho.shape, dtype=torch.int32, device=dev)
    f = rho_factor
    pcg_iters, hits, accepts = [], [], []
    for _ in range(n_iter):
        active = ~done
        lam_new, pcg_it, hit, dX, dU = linearize_and_solve(X, U, lam, rho)

        merits = eval_merits(X, U, dX, dU)
        # gather, not merits[best]: a 0-d index tensor would be read on
        # the host, a sync per iteration
        best = torch.argmin(merits, dim=0, keepdim=True)
        best_merit = merits.gather(0, best)[0]
        accept = best_merit < merit
        alpha = alphas.gather(0, best.view(-1)).view(best.shape[1:])

        drho_rej = torch.clamp(drho * f, min=f)
        rho_rej = torch.clamp(rho * drho_rej, min=rho_min)
        drho_acc = torch.clamp(drho / f, max=1.0 / f)
        rho_acc = torch.clamp(rho * drho_acc, min=rho_min)
        drho_n = torch.where(accept, drho_acc, drho_rej)
        rho_n = torch.where(accept, rho_acc, rho_rej)
        bail = ~accept & (rho_n > rho_max)
        rho_n = torch.where(bail, torch.full_like(rho_n, rho_reset), rho_n)

        acc2, alpha2 = accept[..., None, None], alpha[..., None, None]
        X_n = torch.where(acc2, X + alpha2 * dX, X)
        U_n = torch.where(acc2, U + alpha2 * dU, U)
        merit_n = torch.where(accept, best_merit, merit)

        # a bail freezes the state for the rest of the solve
        act2 = active[..., None, None]
        X = torch.where(act2, X_n, X)
        U = torch.where(act2, U_n, U)
        lam = torch.where(act2, lam_new, lam)
        rho = torch.where(active, rho_n, rho)
        drho = torch.where(active, drho_n, drho)
        merit = torch.where(active, merit_n, merit)
        pcg_iters.append(torch.where(active, pcg_it.to(torch.int32),
                                     torch.full_like(iters, -1)))
        hits.append(active & hit)
        accepts.append(active & accept)
        iters = iters + active.to(torch.int32)
        done = done | (active & bail)

    if n_iter:
        stack = lambda xs_: torch.stack(xs_)
    else:
        stack = lambda xs_: torch.zeros((0,) + rho.shape, dtype=torch.int32,
                                        device=dev)
    return (X, U, lam, rho, drho, merit, iters, done, stack(pcg_iters),
            stack(hits).bool(), stack(accepts).bool())
