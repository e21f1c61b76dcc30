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

Backends (``linsys``): "pcg" (stair-PCG), "pcg_pallas" (the same CG as
the kernel K4b), "bcr" (exact block cyclic reduction), "bcr_pcg"
(BCR-preconditioned CG), "dense" (Cholesky of the dense S) and "qdldl"
(the host sparse LDL' oracle, linsys/qdldl_host.py).

``cfg.fused_stages`` selects the hand-written kernels.  With
``megakernel`` on "pcg" or "bcr" (``megakernel_engages``), K2 computes
the starting merit and then either ONE K5 launch runs every iteration of
the solve ("pcg" with ``megakernel_solve``), or each iteration is one
launch of K9p ("pcg") or K9b ("bcr"), which take drho and the merit from
device memory, in the same masked loop as the staged path.  Otherwise
each iteration runs K3 (KKT + Schur, with the stair preconditioner for
"pcg" and "pcg_pallas"), then K4 (stair-PCG + dz; "pcg_pallas" too, as
the JAX package runs it), K6 (BCR-preconditioned CG + dz, "bcr_pcg") or
K7 (refined BCR + dz, "bcr"), then K2 (line-search merits).  Fused
"dense" and "qdldl" raise: the JAX package runs its stair-PCG kernel
under those names there (its sqp_solve never calls the named backend
with pallas_stages), and the port does not copy that.  Off, the plain
PyTorch modules run on any device, and "pcg_pallas" solves with K4b.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.linsys.qdldl_host import solve_linsys_qdldl
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops import merit as merit_ops
from mpcgpu_tpu_torch.ops.btridiag import BlockTri, to_dense
from mpcgpu_tpu_torch.ops.btsolve import (_solve_linsys_bcr,
                                          _solve_linsys_bcr_pcg)
from mpcgpu_tpu_torch.ops.cuda.bcr_kernel import bcr_dz, bcr_pcg_dz
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import form_kkt_schur
from mpcgpu_tpu_torch.ops.cuda.merit_kernel import line_search_merits
from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import pcg_dz, pcg_solve
from mpcgpu_tpu_torch.ops.cuda.sqp_megakernel import (IterResult,
                                                      sqp_iter_mega,
                                                      sqp_iter_mega_pcg,
                                                      sqp_solve_mega_pcg)
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


def _solve_linsys_pcg_pallas(cfg: SolverConfig, schur, lam, pcg_exit_tol):
    """The stair-PCG as one kernel launch (K4b) on the plain stages'
    system."""
    S, P = (BlockTri(*(t.contiguous() for t in bands))
            for bands in (schur.S, schur.Pinv))
    return pcg_solve(S, P, schur.gamma.contiguous(), lam.contiguous(),
                     cfg.pcg.max_iter, pcg_exit_tol)


def _solve_linsys_dense(cfg: SolverConfig, schur, lam, pcg_exit_tol):
    """Exact solve of the dense S (the oracle backend): Cholesky and two
    triangular solves, as the JAX package's jax.scipy.linalg.solve(
    assume_a="pos") outside any kernel; NaNs where S is not positive
    definite, with no host read.  Iterations 0, hit False."""
    n, s = schur.gamma.shape
    L, info = torch.linalg.cholesky_ex(to_dense(schur.S))
    sol = torch.cholesky_solve(schur.gamma.reshape(-1, 1), L).reshape(n, s)
    sol = torch.where(info == 0, sol, torch.full_like(sol, float("nan")))
    dev = sol.device
    return (sol, torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


_LINSYS_BACKENDS = {"pcg": _solve_linsys_pcg,
                    "pcg_pallas": _solve_linsys_pcg_pallas,
                    "bcr": _solve_linsys_bcr,
                    "bcr_pcg": _solve_linsys_bcr_pcg,
                    "dense": _solve_linsys_dense,
                    "qdldl": solve_linsys_qdldl}


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
    """Whether sqp_solve runs the SQP iteration as one kernel (K5, or K9p /
    K9b per iteration).  The port has none of the TPU's envelope gates:
    the kernels' own fit checks raise past the horizons they serve."""
    return bool(cfg.fused_stages and cfg.megakernel
                and linsys in ("pcg", "bcr"))


def check_fused_config(cfg: SolverConfig, linsys: str) -> None:
    """Raise unless the CUDA kernels serve this configuration, saying
    why."""
    if linsys in ("dense", "qdldl"):
        raise ValueError(
            f"fused_stages=True with linsys={linsys!r}: the JAX package "
            f"runs its stair-PCG kernel under that name there (its "
            f"sqp_solve never calls the {linsys!r} backend with "
            f"pallas_stages); the port does not copy that -- run "
            f"{linsys!r} with fused_stages=False, or 'pcg' fused")
    n = cfg.knot_points
    if linsys in ("bcr", "bcr_pcg") and (n < 1 or n & (n - 1)):
        raise ValueError(f"fused_stages=True with linsys={linsys!r}: the BCR "
                         f"kernels need a power-of-2 horizon, got N = {n}")
    unsupported = []
    if linsys not in ("pcg", "pcg_pallas", "bcr", "bcr_pcg"):
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
    schedule = dict(rho_factor=cfg.rho_factor, rho_min=cfg.rho_min,
                    rho_max=cfg.rho_max, rho_reset=cfg.rho_reset)

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

        kw = dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
                  gravity=cfg.gravity, mu=cfg.merit_mu,
                  num_alphas=cfg.num_alphas, **schedule)
        if megakernel_engages(cfg, linsys) and linsys == "pcg" \
                and cfg.megakernel_solve:
            r = sqp_solve_mega_pcg(
                model, X, U, goals, xs, lam, rho, 1.0, merit_of(X, U),
                cfg.pcg.max_iter, pcg_exit_tol, n_iter, **kw)
            stats = SQPStats(pcg_iters=r.pcg_iters, pcg_hit_max=r.hit_max,
                             accepted=r.accepted, sqp_iters=r.sqp_iters,
                             rho_bailed=r.bailed, final_merit=r.merit)
            return SQPResult(X=r.X, U=r.U, lam=r.lam, rho=r.rho, stats=stats)

        if megakernel_engages(cfg, linsys):
            # one K9p / K9b launch per iteration, drho and the merit on
            # the device
            def step(Xc, Uc, lamc, rhoc, drhoc, meritc):
                if linsys == "pcg":
                    return sqp_iter_mega_pcg(
                        model, Xc, Uc, goals, xs, lamc, rhoc, drhoc, meritc,
                        cfg.pcg.max_iter, pcg_exit_tol, **kw)
                return sqp_iter_mega(model, Xc, Uc, goals, xs, rhoc, drhoc,
                                     meritc, **kw)
        else:
            precond = cfg.pcg.preconditioned and linsys in ("pcg",
                                                           "pcg_pallas")

            def linearize_and_solve(Xc, Uc, lamc, rhoc):
                ks = form_kkt_schur(model, Xc, Uc, goals, xs, rhoc,
                                    cfg.timestep, cc.qd_cost, cc.r_cost,
                                    cfg.gravity, precond)
                if linsys == "bcr":   # exact: no warm start, no tolerance
                    out = bcr_dz(ks)
                elif linsys == "bcr_pcg":
                    out = bcr_pcg_dz(ks, lamc, cfg.pcg.max_iter,
                                     pcg_exit_tol)
                else:
                    out = pcg_dz(ks, lamc, cfg.pcg.max_iter, pcg_exit_tol)
                lam_new, dX, dU, it, hit = out
                return lam_new, it, hit, dX, dU

            step = staged_step(linearize_and_solve, eval_merits, alphas,
                               **schedule)
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

        step = staged_step(linearize_and_solve, eval_merits, alphas,
                           **schedule)

    (X, U, lam, rho, _drho, merit, iters, done, pcg_iters, hits,
     accepts) = iterate(X, U, lam, rho, torch.ones_like(rho),
                        merit_of(X, U), n_iter, step)
    stats = SQPStats(pcg_iters=pcg_iters, pcg_hit_max=hits, accepted=accepts,
                     sqp_iters=iters, rho_bailed=done, final_merit=merit)
    return SQPResult(X=X, U=U, lam=lam, rho=rho, stats=stats)


def sqp_step(X, U, lam, rho, drho, merit, linearize_and_solve, eval_merits,
             alphas, rho_factor, rho_min, rho_max, rho_reset) -> IterResult:
    """One staged SQP iteration from incumbent merit `merit`:
    linearize_and_solve(X, U, lam, rho) -> (lam', pcg iters, hit, dX, dU),
    eval_merits(X, U, dX, dU) -> merits of the alphas (candidates first),
    the first minimum, the accept test and the rho schedule.  rho, drho
    and merit may carry an arm axis (B,), with X (B, N, nx): every
    decision is then per arm."""
    lam_new, pcg_it, hit, dX, dU = linearize_and_solve(X, U, lam, rho)

    merits = eval_merits(X, U, dX, dU)
    # gather, not merits[best]: a 0-d index tensor would be read on the
    # host, a sync per iteration
    best = torch.argmin(merits, dim=0, keepdim=True)
    best_merit = merits.gather(0, best)[0]
    accept = best_merit < merit
    alpha = alphas.gather(0, best.view(-1)).view(best.shape[1:])

    f = rho_factor
    drho_rej = torch.clamp(drho * f, min=f)
    rho_rej = torch.clamp(rho * drho_rej, min=rho_min)
    drho_acc = torch.clamp(drho / f, max=1.0 / f)
    rho_acc = torch.clamp(rho * drho_acc, min=rho_min)
    drho_n = torch.where(accept, drho_acc, drho_rej)
    rho_n = torch.where(accept, rho_acc, rho_rej)
    bail = ~accept & (rho_n > rho_max)
    rho_n = torch.where(bail, torch.full_like(rho_n, rho_reset), rho_n)

    acc2, alpha2 = accept[..., None, None], alpha[..., None, None]
    return IterResult(
        X=torch.where(acc2, X + alpha2 * dX, X),
        U=torch.where(acc2, U + alpha2 * dU, U),
        lam=lam_new, rho=rho_n, drho=drho_n,
        merit=torch.where(accept, best_merit, merit), accept=accept,
        bail=bail, pcg_iters=pcg_it, hit_max=hit)


def staged_step(linearize_and_solve, eval_merits, alphas, rho_factor,
                rho_min, rho_max, rho_reset):
    """sqp_step bound to its stages: step(X, U, lam, rho, drho, merit) ->
    IterResult."""
    return partial(sqp_step, linearize_and_solve=linearize_and_solve,
                   eval_merits=eval_merits, alphas=alphas,
                   rho_factor=rho_factor, rho_min=rho_min, rho_max=rho_max,
                   rho_reset=rho_reset)


def iterate(X, U, lam, rho, drho, merit, n_iter: int, step):
    """The SQP loop: n_iter iterations of step(X, U, lam, rho, drho,
    merit) -> IterResult (staged_step, or one K9 launch); after a bail
    every iteration is masked, so the state and stats end as the JAX
    package's stopped while_loop leaves them.  rho, drho and merit may
    carry an arm axis (B,), with X (B, N, nx): a bailed arm is then frozen
    while the others go on.  Returns (X, U, lam, rho, drho, merit,
    sqp_iters, bailed, pcg_iters, hit_max, accepted), the last three
    stacked over iterations first (pcg_iters -1 where an iteration did not
    run)."""
    dev = X.device
    done = torch.zeros(rho.shape, dtype=torch.bool, device=dev)
    iters = torch.zeros(rho.shape, dtype=torch.int32, device=dev)
    pcg_iters, hits, accepts = [], [], []
    for _ in range(n_iter):
        active = ~done
        r = step(X, U, lam, rho, drho, merit)
        # a bail freezes the state for the rest of the solve
        act2 = active[..., None, None]
        X = torch.where(act2, r.X, X)
        U = torch.where(act2, r.U, U)
        lam = torch.where(act2, r.lam, lam)
        rho = torch.where(active, r.rho, rho)
        drho = torch.where(active, r.drho, drho)
        merit = torch.where(active, r.merit, merit)
        pcg_iters.append(torch.where(active, r.pcg_iters.to(torch.int32),
                                     torch.full_like(iters, -1)))
        hits.append(active & r.hit_max)
        accepts.append(active & r.accept)
        iters = iters + active.to(torch.int32)
        done = done | (active & r.bail)

    if n_iter:
        stack = lambda xs_: torch.stack(xs_)
    else:
        stack = lambda xs_: torch.zeros((0,) + rho.shape, dtype=torch.int32,
                                        device=dev)
    return (X, U, lam, rho, drho, merit, iters, done, stack(pcg_iters),
            stack(hits).bool(), stack(accepts).bool())
