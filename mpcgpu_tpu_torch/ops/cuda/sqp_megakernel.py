"""The SQP megakernels: K5, the whole SQP solve in one cooperative launch,
and K9p / K9b, one SQP iteration per launch with the stair-PCG / the
refined BCR dual solve, with K5g and K9pg, K5 and K9p over the grid-wide
CG (csrc/sqp_mega.cu); K10, K5 for B arms at once
(csrc/sqp_mega_packed.cu).

Counterpart of mpcgpu_tpu/ops/pallas/sqp_megakernel.py
(sqp_solve_mega_pcg, sqp_iter_mega_pcg, sqp_iter_mega,
sqp_solve_mega_pcg_packed).  A CPU tensor runs the plain version: the
port's staged iteration (sqp.sqp_step) over the plain K3 and K2 versions
with K4's (K5, K9p) or K7's (K9b) -- one step for K9, the fixed
``n_sqp_iter`` of sqp.iterate with the bail freeze for K5 -- and for K10
the arm-batched plain modules with the CG's shared exit; a CUDA tensor
launches the kernel or raises.

K9p and K9b take drho and the incumbent merit as device scalars and
return the iteration's accept and bail, so a caller's loop of single
iterations (sqp.sqp_solve with ``megakernel`` and without
``megakernel_solve``) reads nothing on the host.

The kernel is one persistent cooperative launch with grid barriers
between its stages; K5's and K9p's CG stage runs in one block that holds S
in shared memory, and every block asks for that memory (N <= 84 on the
H100).  K5g and K9pg run the CG over the whole grid with S in global
memory and ask for no N-sized shared memory.  ``sqp_solve_mega_pcg`` and
``sqp_iter_mega_pcg`` launch the one-block kind where it fits and the grid
kind past it (``pcg_kind``: a function of N and the device alone);
``sqp_solve_mega_pcg_grid`` and ``sqp_iter_mega_pcg_grid`` launch the grid
kind at any N.  ``check_mega_fit`` raises past the largest N a kind
serves, and before a grid that could not be co-resident (the counterpart
of the reference's checkPcgOccupancy and of the TPU's
check_pcg_vmem_fit): an oversubscribed cooperative launch is never made.
``check_mega_packed_fit`` does the same for K10, and raises too when the
grid cannot give every arm a CG block of its own.

K10's public layout is knot-major with a leading arm axis: X (B, N, nx),
U (B, N-1, nu), lam0 (B, N, nx), goals (B, N, >=3) (or one (N, >=3)
expanded over the arms), xs (B, nx), rho and drho (B,).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.ops import merit as merit_ops
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda.bcr_kernel import bcr_dz_reference
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import (
    form_kkt_schur_reference)
from mpcgpu_tpu_torch.ops.cuda.merit_kernel import (
    alphas_for, line_search_merits_reference)
from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import pcg_dz_reference
from mpcgpu_tpu_torch.ops.dz import compute_dz
from mpcgpu_tpu_torch.ops.kkt import form_kkt
from mpcgpu_tpu_torch.ops.pcg import pcg
from mpcgpu_tpu_torch.ops.schur import form_schur


class MegaResult(NamedTuple):
    X: torch.Tensor           # (N, nx)
    U: torch.Tensor           # (N-1, nu)
    lam: torch.Tensor         # (N, nx)
    rho: torch.Tensor         # 0-d
    drho: torch.Tensor
    merit: torch.Tensor
    sqp_iters: torch.Tensor   # int32 iterations run
    bailed: torch.Tensor      # bool
    pcg_iters: torch.Tensor   # (n_sqp_iter,) int32, -1 where not run
    hit_max: torch.Tensor     # (n_sqp_iter,) bool
    accepted: torch.Tensor    # (n_sqp_iter,) bool


class IterResult(NamedTuple):
    """One SQP iteration (K9p, K9b, sqp.sqp_step): the iterate after the
    accepted step, the dual solution, the rho schedule's state, and the
    iteration's decisions and CG counts (0 and False for the BCR solve)."""

    X: torch.Tensor           # (N, nx)
    U: torch.Tensor           # (N-1, nu)
    lam: torch.Tensor         # (N, nx)
    rho: torch.Tensor         # 0-d
    drho: torch.Tensor
    merit: torch.Tensor
    accept: torch.Tensor      # bool
    bail: torch.Tensor        # bool
    pcg_iters: torch.Tensor   # int32
    hit_max: torch.Tensor     # bool


def _plain_step(model, goals, xs, solve, precond: bool, dt, qd_cost, r_cost,
                gravity, mu, num_alphas: int, rho_factor, rho_min, rho_max,
                rho_reset):
    """sqp.sqp_step over the plain K3 and K2 versions, with
    solve(ks, lam) -> (lam', dX, dU, iters, hit) as the dual solve."""
    from mpcgpu_tpu_torch.sqp import staged_step

    def linearize_and_solve(Xc, Uc, lamc, rhoc):
        ks = form_kkt_schur_reference(model, Xc, Uc, goals, xs, rhoc, dt,
                                      qd_cost, r_cost, gravity, precond)
        lam_new, dX, dU, it, hit = solve(ks, lamc)
        return lam_new, it, hit, dX, dU

    def eval_merits(Xc, Uc, dX, dU):
        return line_search_merits_reference(
            model, Xc, Uc, dX, dU, num_alphas, goals, xs, dt, mu, qd_cost,
            r_cost, gravity)[:num_alphas]

    return staged_step(linearize_and_solve, eval_merits,
                       alphas_for(num_alphas, goals), rho_factor, rho_min,
                       rho_max, rho_reset)


def _pcg_solve(max_iter, exit_tol):
    return lambda ks, lam: pcg_dz_reference(ks, lam, max_iter, exit_tol)


def _scalars(X, rho, drho, merit):
    f32 = dict(dtype=X.dtype, device=X.device)
    return (torch.as_tensor(rho, **f32), torch.as_tensor(drho, **f32),
            torch.as_tensor(merit, **f32))


def sqp_solve_mega_pcg_reference(model, X, U, goals, xs, lam0, rho, drho,
                                 merit0, max_iter: int, exit_tol,
                                 n_sqp_iter: int, dt, qd_cost, r_cost,
                                 gravity, mu, num_alphas: int, rho_factor,
                                 rho_min, rho_max, rho_reset) -> MegaResult:
    from mpcgpu_tpu_torch.sqp import iterate

    step = _plain_step(model, goals, xs, _pcg_solve(max_iter, exit_tol), True,
                       dt, qd_cost, r_cost, gravity, mu, num_alphas,
                       rho_factor, rho_min, rho_max, rho_reset)
    st = iterate(X, U, lam0, *_scalars(X, rho, drho, merit0), n_sqp_iter,
                 step)
    return MegaResult(*st)


_grids: dict = {}


# the kernels of csrc/sqp_mega.cu (its Kind)
SOLVE_PCG, ITER_PCG, ITER_BCR, SOLVE_PCG_GRID, ITER_PCG_GRID = 0, 1, 2, 3, 4
_KIND_NAMES = {SOLVE_PCG: "the whole-solve kernel",
               ITER_PCG: "the per-iteration PCG kernel",
               ITER_BCR: "the per-iteration BCR kernel",
               SOLVE_PCG_GRID: "the grid-CG whole-solve kernel",
               ITER_PCG_GRID: "the grid-CG per-iteration kernel"}
_GRID_KIND = {SOLVE_PCG: SOLVE_PCG_GRID, ITER_PCG: ITER_PCG_GRID}


def pcg_kind(knot_points: int, lib=None, kind: int = SOLVE_PCG) -> int:
    """The kind that serves the PCG megakernel `kind` (SOLVE_PCG or
    ITER_PCG) at this horizon: itself where every block's shared memory
    holds its one-block CG, else its grid-CG form."""
    lib = lib or _lib.library()
    if knot_points <= lib.mpc_mega_max_knots(kind):
        return kind
    return _GRID_KIND[kind]


def check_mega_fit(knot_points: int, lib=None, kind: int = SOLVE_PCG) -> int:
    """Raise unless every block's shared memory fits kernel `kind` (K5,
    K9p, K9b) at this horizon and at least one block can be resident;
    return the grid a launch uses, min(N, co-resident blocks)."""
    lib = lib or _lib.library()
    key = (id(lib), knot_points, kind, _current_device())
    if key in _grids:
        return _grids[key]
    name = _KIND_NAMES[kind]
    n_max = lib.mpc_mega_max_knots(kind)
    if knot_points > n_max:
        where = ("keeps its scratch in global memory" if kind in
                 (SOLVE_PCG_GRID, ITER_PCG_GRID) else
                 "holds its dual solve in one block's shared memory")
        raise ValueError(
            f"{name} {where} and serves N <= {n_max} on this device; got "
            f"N = {knot_points}")
    grid = lib.mpc_mega_grid(knot_points, kind)
    if grid < 1:
        raise ValueError(
            f"{name} cannot make a cooperative launch of N = {knot_points} "
            f"on this device: no block of it can be resident, or the device "
            f"has no cooperative launch")
    _grids[key] = grid
    return grid


def _current_device():
    return torch.cuda.current_device() if torch.cuda.is_available() else -1


def _expect_iterate(tab, X, U, goals, xs, rho, merit, num_alphas: int) -> int:
    """Raise unless the single-arm inputs are what the kernels take;
    return N."""
    dev = X.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    if X.dim() != 2 or X.shape[1] != nx or X.shape[0] < 2:
        raise ValueError(f"X must be (N >= 2, {nx}), got {tuple(X.shape)}")
    n = X.shape[0]
    _lib.expect(X, "X", (n, nx), dev)
    _lib.expect(U, "U", (n - 1, nu), dev)
    if goals.dim() != 2 or goals.shape[0] != n or goals.shape[1] < 3:
        raise ValueError(f"goals must be ({n}, >=3), got {tuple(goals.shape)}")
    _lib.expect(goals, "goals", tuple(goals.shape), dev)
    _lib.expect(xs, "xs", (nx,), dev)
    _lib.expect(rho, "rho", (), dev)
    _lib.expect(merit, "merit", (), dev)
    _lib.expect(tab, "tables", (_lib.TAB_SIZE,), dev)
    if not 1 <= num_alphas <= 16:
        raise ValueError(f"the kernel serves 1..16 step sizes, got "
                         f"{num_alphas}")
    return n


def _launch(lib, tab, X, U, goals, xs, lam0, rho, drho, merit0,
            max_iter: int, exit_tol, n_sqp_iter: int, dt, qd_cost, r_cost,
            gravity, mu, num_alphas: int, rho_factor, rho_min, rho_max,
            rho_reset, grid: int, stream,
            kind: int = SOLVE_PCG) -> MegaResult:
    """One K5 (kind SOLVE_PCG) or K5g (SOLVE_PCG_GRID) launch."""
    dev = X.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    n = _expect_iterate(tab, X, U, goals, xs, rho, merit0, num_alphas)
    _lib.expect(lam0, "lam0", (n, nx), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    Xo = torch.empty((n, nx), **f32)
    Uo = torch.empty((n - 1, nu), **f32)
    lam = torch.empty((n, nx), **f32)
    scal = torch.empty(3, **f32)
    ints = torch.empty(2, dtype=torch.int32, device=dev)
    stats = torch.empty((3, n_sqp_iter), dtype=torch.int32, device=dev)
    scratch = torch.empty(
        lib.mpc_sqp_mega_scratch_floats(n, num_alphas, kind), **f32)
    iscratch = torch.empty(2, dtype=torch.int32, device=dev)
    rc = lib.mpc_sqp_mega(
        tab.data_ptr(), n, X.data_ptr(), U.data_ptr(), goals.data_ptr(),
        goals.shape[1], xs.data_ptr(), lam0.data_ptr(), rho.data_ptr(),
        merit0.data_ptr(), float(drho), int(max_iter), float(exit_tol),
        int(n_sqp_iter), float(dt), float(qd_cost), float(r_cost),
        float(gravity), float(mu), int(num_alphas), float(rho_factor),
        float(rho_min), float(rho_max), float(rho_reset), Xo.data_ptr(),
        Uo.data_ptr(), lam.data_ptr(), scal.data_ptr(), ints.data_ptr(),
        stats.data_ptr(), scratch.data_ptr(), iscratch.data_ptr(), int(kind),
        int(grid), stream)
    _lib.check(rc, "mpc_sqp_mega")
    return MegaResult(
        X=Xo, U=Uo, lam=lam, rho=scal[0], drho=scal[1], merit=scal[2],
        sqp_iters=ints[0], bailed=ints[1] != 0, pcg_iters=stats[0],
        hit_max=stats[1] != 0, accepted=stats[2] != 0)


def _solve_on(lib, kind: int, model, X, U, goals, xs, lam0, rho, drho,
              merit0, *rest):
    """One K5 or K5g launch (kind) through library lib; counts it."""
    grid = check_mega_fit(X.shape[0], lib, kind)
    rho = torch.as_tensor(rho, dtype=torch.float32, device=X.device)
    out = _launch(lib, _lib.model_tables(model), X, U, goals, xs, lam0, rho,
                  drho, merit0, *rest, grid, _lib.stream_of(X), kind)
    wrapper = (sqp_solve_mega_pcg if kind == SOLVE_PCG
               else sqp_solve_mega_pcg_grid)
    wrapper.launches += 1
    return out


def _card_library(X):
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    return _lib.library()


def sqp_solve_mega_pcg(model, X, U, goals, xs, lam0, rho, drho, merit0,
                       max_iter: int, exit_tol, n_sqp_iter: int, dt,
                       qd_cost, r_cost, gravity, mu, num_alphas: int,
                       rho_factor, rho_min, rho_max,
                       rho_reset) -> MegaResult:
    """Run n_sqp_iter SQP iterations (stair-PCG dual solve, 8-alpha line
    search, rho schedule, bail freeze) from X (N, nx), U (N-1, nu), warm
    duals lam0 (N, nx), goals (N, >=3), xs (nx,); rho and merit0 are 0-d
    tensors (merit0 the merit of (X, U), from K2), drho, max_iter and
    exit_tol host numbers.  K5 where its one-block CG fits, else K5g."""
    args = (model, X, U, goals, xs, lam0, rho, drho, merit0, max_iter,
            exit_tol, n_sqp_iter, dt, qd_cost, r_cost, gravity, mu,
            num_alphas, rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type == "cpu":
        return sqp_solve_mega_pcg_reference(*args)
    return _solve_pcg_on(_card_library(X), *args)


def _solve_pcg_on(lib, model, X, *rest):
    """K5 where its one-block CG fits, else K5g, through library lib."""
    return _solve_on(lib, pcg_kind(X.shape[0], lib, SOLVE_PCG), model, X,
                     *rest)


sqp_solve_mega_pcg.launches = 0


def sqp_solve_mega_pcg_grid(model, X, U, goals, xs, lam0, rho, drho, merit0,
                            max_iter: int, exit_tol, n_sqp_iter: int, dt,
                            qd_cost, r_cost, gravity, mu, num_alphas: int,
                            rho_factor, rho_min, rho_max,
                            rho_reset) -> MegaResult:
    """K5g: sqp_solve_mega_pcg's solve with the grid-wide CG, at any N."""
    args = (model, X, U, goals, xs, lam0, rho, drho, merit0, max_iter,
            exit_tol, n_sqp_iter, dt, qd_cost, r_cost, gravity, mu,
            num_alphas, rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type == "cpu":
        return sqp_solve_mega_pcg_reference(*args)
    return _solve_on(_card_library(X), SOLVE_PCG_GRID, *args)


sqp_solve_mega_pcg_grid.launches = 0


def sqp_iter_mega_pcg_reference(model, X, U, goals, xs, lam0, rho, drho,
                                merit, max_iter: int, exit_tol, dt, qd_cost,
                                r_cost, gravity, mu, num_alphas: int,
                                rho_factor, rho_min, rho_max,
                                rho_reset) -> IterResult:
    step = _plain_step(model, goals, xs, _pcg_solve(max_iter, exit_tol), True,
                       dt, qd_cost, r_cost, gravity, mu, num_alphas,
                       rho_factor, rho_min, rho_max, rho_reset)
    return step(X, U, lam0, *_scalars(X, rho, drho, merit))


def sqp_iter_mega_reference(model, X, U, goals, xs, rho, drho, merit, dt,
                            qd_cost, r_cost, gravity, mu, num_alphas: int,
                            rho_factor, rho_min, rho_max,
                            rho_reset) -> IterResult:
    step = _plain_step(model, goals, xs, lambda ks, lam: bcr_dz_reference(ks),
                       False, dt, qd_cost, r_cost, gravity, mu, num_alphas,
                       rho_factor, rho_min, rho_max, rho_reset)
    return step(X, U, torch.zeros_like(X), *_scalars(X, rho, drho, merit))


def _launch_iter(lib, kind: int, tab, X, U, goals, xs, lam0, rho, drho, merit,
                 max_iter: int, exit_tol, dt, qd_cost, r_cost, gravity, mu,
                 num_alphas: int, rho_factor, rho_min, rho_max, rho_reset,
                 grid: int, stream) -> IterResult:
    """One launch of K9p or K9pg (kind ITER_PCG or ITER_PCG_GRID, lam0 the
    warm start) or K9b (ITER_BCR, lam0 None)."""
    dev = X.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    n = _expect_iterate(tab, X, U, goals, xs, rho, merit, num_alphas)
    _lib.expect(drho, "drho", (), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    Xo = torch.empty((n, nx), **f32)
    Uo = torch.empty((n - 1, nu), **f32)
    lam = torch.empty((n, nx), **f32)
    scal = torch.empty(3, **f32)
    ints = torch.empty(2, dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    scratch = torch.empty(
        lib.mpc_sqp_mega_scratch_floats(n, num_alphas, kind), **f32)
    iscratch = torch.empty(2, dtype=torch.int32, device=dev)
    head = (tab.data_ptr(), n, X.data_ptr(), U.data_ptr(), goals.data_ptr(),
            goals.shape[1], xs.data_ptr())
    schedule = (float(dt), float(qd_cost), float(r_cost), float(gravity),
                float(mu), int(num_alphas), float(rho_factor),
                float(rho_min), float(rho_max), float(rho_reset))
    tail = (Xo.data_ptr(), Uo.data_ptr(), lam.data_ptr(), scal.data_ptr(),
            ints.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
            iscratch.data_ptr(), int(grid), stream)
    if kind in (ITER_PCG, ITER_PCG_GRID):
        _lib.expect(lam0, "lam0", (n, nx), dev)
        rc = lib.mpc_sqp_iter_mega_pcg(
            *head, lam0.data_ptr(), rho.data_ptr(), drho.data_ptr(),
            merit.data_ptr(), int(max_iter), float(exit_tol), *schedule,
            *tail[:-2], int(kind), *tail[-2:])
        _lib.check(rc, "mpc_sqp_iter_mega_pcg")
    else:
        if n & (n - 1):
            raise ValueError(f"the per-iteration BCR kernel needs a "
                             f"power-of-2 horizon, got N = {n}")
        rc = lib.mpc_sqp_iter_mega(*head, rho.data_ptr(), drho.data_ptr(),
                                   merit.data_ptr(), *schedule, *tail)
        _lib.check(rc, "mpc_sqp_iter_mega")
    return IterResult(X=Xo, U=Uo, lam=lam, rho=scal[0], drho=scal[1],
                      merit=scal[2], accept=stats[2] != 0, bail=ints[1] != 0,
                      pcg_iters=stats[0], hit_max=stats[1] != 0)


def _iter_on(lib, kind: int, model, X, U, goals, xs, lam0, rho, drho, merit,
             *rest):
    """One K9p, K9pg or K9b launch (kind) through library lib; counts it."""
    grid = check_mega_fit(X.shape[0], lib, kind)
    rho, drho, merit = _scalars(X, rho, drho, merit)
    out = _launch_iter(lib, kind, _lib.model_tables(model), X, U, goals, xs,
                       lam0, rho, drho, merit, *rest, grid, _lib.stream_of(X))
    {ITER_PCG: sqp_iter_mega_pcg, ITER_PCG_GRID: sqp_iter_mega_pcg_grid,
     ITER_BCR: sqp_iter_mega}[kind].launches += 1
    return out


def sqp_iter_mega_pcg(model, X, U, goals, xs, lam0, rho, drho, merit,
                      max_iter: int, exit_tol, dt, qd_cost, r_cost, gravity,
                      mu, num_alphas: int, rho_factor, rho_min, rho_max,
                      rho_reset) -> IterResult:
    """K9p (K9pg past its one-block fit): one SQP iteration (K3's stages
    with the stair, the warm-started stair-PCG from lam0 and dz, the
    8-alpha line search, the accept test and rho schedule) from X (N, nx),
    U (N-1, nu), goals (N, >=3), xs (nx,); rho, drho and merit (the
    incumbent's) are 0-d tensors (or numbers), max_iter and exit_tol host
    numbers."""
    args = (model, X, U, goals, xs, lam0, rho, drho, merit, max_iter,
            exit_tol, dt, qd_cost, r_cost, gravity, mu, num_alphas,
            rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type == "cpu":
        return sqp_iter_mega_pcg_reference(*args)
    return _iter_pcg_on(_card_library(X), *args)


def _iter_pcg_on(lib, model, X, *rest):
    """K9p where its one-block CG fits, else K9pg, through library lib."""
    return _iter_on(lib, pcg_kind(X.shape[0], lib, ITER_PCG), model, X,
                    *rest)


sqp_iter_mega_pcg.launches = 0


def sqp_iter_mega_pcg_grid(model, X, U, goals, xs, lam0, rho, drho, merit,
                           max_iter: int, exit_tol, dt, qd_cost, r_cost,
                           gravity, mu, num_alphas: int, rho_factor, rho_min,
                           rho_max, rho_reset) -> IterResult:
    """K9pg: sqp_iter_mega_pcg's iteration with the grid-wide CG, at any
    N."""
    args = (model, X, U, goals, xs, lam0, rho, drho, merit, max_iter,
            exit_tol, dt, qd_cost, r_cost, gravity, mu, num_alphas,
            rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type == "cpu":
        return sqp_iter_mega_pcg_reference(*args)
    return _iter_on(_card_library(X), ITER_PCG_GRID, *args)


sqp_iter_mega_pcg_grid.launches = 0


def sqp_iter_mega(model, X, U, goals, xs, rho, drho, merit, dt, qd_cost,
                  r_cost, gravity, mu, num_alphas: int, rho_factor, rho_min,
                  rho_max, rho_reset) -> IterResult:
    """K9b: one SQP iteration with the refined BCR dual solve (no stair, no
    warm start; pcg_iters 0, hit_max False); N a power of 2.  Arguments as
    sqp_iter_mega_pcg's, less lam0, max_iter and exit_tol."""
    if X.device.type == "cpu":
        return sqp_iter_mega_reference(
            model, X, U, goals, xs, rho, drho, merit, dt, qd_cost, r_cost,
            gravity, mu, num_alphas, rho_factor, rho_min, rho_max, rho_reset)
    return _iter_on(_card_library(X), ITER_BCR, model, X, U, goals, xs, None,
                    rho, drho, merit, 0, 0.0, dt, qd_cost, r_cost, gravity,
                    mu, num_alphas, rho_factor, rho_min, rho_max, rho_reset)


sqp_iter_mega.launches = 0


class PackedResult(NamedTuple):
    X: torch.Tensor                # (B, N, nx)
    U: torch.Tensor                # (B, N-1, nu)
    lam: torch.Tensor              # (B, N, nx)
    rho: torch.Tensor              # (B,)
    merit: torch.Tensor            # (B,)
    sqp_iters: torch.Tensor        # (B,) int32 live iterations per arm
    bailed: torch.Tensor           # (B,) bool
    pcg_iters_total: torch.Tensor  # int32, the shared CG count summed


def sqp_solve_mega_pcg_packed_reference(model, X, U, goals, xs, lam0, rho,
                                        drho, max_iter: int, exit_tol,
                                        n_sqp_iter: int, dt, qd_cost, r_cost,
                                        gravity, mu, num_alphas: int,
                                        rho_factor, rho_min, rho_max,
                                        rho_reset) -> PackedResult:
    """The plain version of K10: sqp.iterate over the arm-batched plain
    modules (KKT, Schur with the stair preconditioner, the CG with its
    shared exit, dz, the candidate merits), the incumbent merit computed
    first, on the tensors' device."""
    from mpcgpu_tpu_torch.sqp import iterate, staged_step

    def linearize_and_solve(Xc, Uc, lamc, rhoc):
        kkt = form_kkt(model, Xc, Uc, goals, xs, dt, qd_cost, r_cost, 0,
                       gravity)
        sd = form_schur(kkt, rhoc)
        res = pcg(sd.S, sd.Pinv, sd.gamma, lamc, max_iter, exit_tol,
                  shared_exit=True)
        dX, dU = compute_dz(kkt, sd, res.lam)
        return res.lam, res.iters, res.hit_max, dX, dU

    def eval_merits(Xc, Uc, dX, dU):
        return merit_ops.line_search_merits(
            model, Xc, Uc, dX, dU, alphas_for(num_alphas, Xc), goals, xs, dt,
            mu, qd_cost, r_cost, 0, gravity)

    f32 = dict(dtype=X.dtype, device=X.device)
    b = X.shape[0]
    merit0 = merit_ops.merit(model, X, U, goals, xs, dt, mu, qd_cost, r_cost,
                             0, gravity)
    (Xo, Uo, lam, rho_o, _drho, merit, iters, done, pcg_iters, _hit,
     _acc) = iterate(X, U, lam0, torch.as_tensor(rho, **f32).expand(b),
                     torch.as_tensor(drho, **f32).expand(b), merit0,
                     n_sqp_iter,
                     staged_step(linearize_and_solve, eval_merits,
                                 alphas_for(num_alphas, X), rho_factor,
                                 rho_min, rho_max, rho_reset))
    # an iteration's CG count where some arm was live, else -1
    pcg_tot = pcg_iters.amax(-1).clamp(min=0).sum().to(torch.int32)
    return PackedResult(X=Xo, U=Uo, lam=lam, rho=rho_o, merit=merit,
                        sqp_iters=iters, bailed=done, pcg_iters_total=pcg_tot)


def check_mega_packed_fit(knot_points: int, arms: int, num_alphas: int = 8,
                          lib=None) -> int:
    """Raise unless a block's shared memory fits B = arms at this horizon
    and the co-resident grid gives every arm a CG block; return the grid a
    launch uses, min(B N, co-resident blocks) (1 in the host build)."""
    lib = lib or _lib.library()
    key = (id(lib), knot_points, arms, num_alphas, _current_device())
    if key in _grids:
        return _grids[key]
    n_max = lib.mpc_mega_packed_max_knots(arms, num_alphas)
    if knot_points > n_max:
        raise ValueError(
            f"the arm-packed whole-solve kernel holds an arm's S in one "
            f"block's shared memory and serves N <= {n_max} on this device; "
            f"got N = {knot_points}")
    grid = lib.mpc_mega_packed_grid(knot_points, arms, num_alphas)
    if grid < 1:
        raise ValueError(
            f"the arm-packed whole-solve kernel cannot make a cooperative "
            f"launch of {arms} arms at N = {knot_points} on this device: "
            f"fewer blocks can be resident than there are arms, or the "
            f"device has no cooperative launch")
    _grids[key] = grid
    return grid


def _launch_packed(lib, tab, X, U, goals, xs, lam0, rho, drho,
                   max_iter: int, exit_tol, n_sqp_iter: int, dt, qd_cost,
                   r_cost, gravity, mu, num_alphas: int, rho_factor, rho_min,
                   rho_max, rho_reset, grid: int, stream) -> PackedResult:
    dev = X.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    if X.dim() != 3 or X.shape[2] != nx or X.shape[1] < 2:
        raise ValueError(f"X must be (B, N >= 2, {nx}), got "
                         f"{tuple(X.shape)}")
    b, n = X.shape[:2]
    f32 = dict(dtype=torch.float32, device=dev)
    rho = torch.as_tensor(rho, **f32).expand(b).contiguous()
    drho = torch.as_tensor(drho, **f32).expand(b).contiguous()
    _lib.expect(X, "X", (b, n, nx), dev)
    _lib.expect(U, "U", (b, n - 1, nu), dev)
    _lib.expect(lam0, "lam0", (b, n, nx), dev)
    _lib.expect(xs, "xs", (b, nx), dev)
    _lib.expect(rho, "rho", (b,), dev)
    _lib.expect(drho, "drho", (b,), dev)
    if goals.dim() != 3 or goals.shape[:2] != (b, n) or goals.shape[2] < 3:
        raise ValueError(f"goals must be ({b}, {n}, >=3), got "
                         f"{tuple(goals.shape)}")
    garm = 0 if goals.stride(0) == 0 else n * goals.shape[2]
    base = goals[0] if garm == 0 else goals
    _lib.expect(base, "goals", tuple(base.shape), dev)
    _lib.expect(tab, "tables", (_lib.TAB_SIZE,), dev)
    if not 1 <= num_alphas <= 16:
        raise ValueError(f"the kernel serves 1..16 step sizes, got "
                         f"{num_alphas}")
    Xo = torch.empty((b, n, nx), **f32)
    Uo = torch.empty((b, n - 1, nu), **f32)
    lam = torch.empty((b, n, nx), **f32)
    rho_o = torch.empty(b, **f32)
    merit = torch.empty(b, **f32)
    ints = torch.empty(2 * b + 1, dtype=torch.int32, device=dev)
    scratch = torch.empty(
        lib.mpc_sqp_mega_packed_scratch_floats(n, b, num_alphas), **f32)
    rc = lib.mpc_sqp_mega_packed(
        tab.data_ptr(), b, n, X.data_ptr(), U.data_ptr(), base.data_ptr(),
        goals.shape[2], garm, xs.data_ptr(), lam0.data_ptr(), rho.data_ptr(),
        drho.data_ptr(), int(max_iter), float(exit_tol), int(n_sqp_iter),
        float(dt), float(qd_cost), float(r_cost), float(gravity), float(mu),
        int(num_alphas), float(rho_factor), float(rho_min), float(rho_max),
        float(rho_reset), Xo.data_ptr(), Uo.data_ptr(), lam.data_ptr(),
        rho_o.data_ptr(), merit.data_ptr(), ints.data_ptr(),
        scratch.data_ptr(), int(grid), stream)
    _lib.check(rc, "mpc_sqp_mega_packed")
    return PackedResult(X=Xo, U=Uo, lam=lam, rho=rho_o, merit=merit,
                        sqp_iters=ints[:b], bailed=ints[b:2 * b] != 0,
                        pcg_iters_total=ints[2 * b])


def sqp_solve_mega_pcg_packed(model, X, U, goals, xs, lam0, rho, drho,
                              max_iter: int, exit_tol, n_sqp_iter: int, dt,
                              qd_cost, r_cost, gravity, mu, num_alphas: int,
                              rho_factor, rho_min, rho_max,
                              rho_reset) -> PackedResult:
    """Run n_sqp_iter SQP iterations for each of B arms (module doc for the
    layout): per-arm rho, drho, merit (computed first, in-kernel), accept
    and bail freeze, one CG per arm with the shared exit; rho and drho are
    (B,) tensors or numbers, max_iter and exit_tol host numbers."""
    if X.device.type == "cpu":
        return sqp_solve_mega_pcg_packed_reference(
            model, X, U, goals, xs, lam0, rho, drho, max_iter, exit_tol,
            n_sqp_iter, dt, qd_cost, r_cost, gravity, mu, num_alphas,
            rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    lib = _lib.library()
    grid = check_mega_packed_fit(X.shape[1], X.shape[0], num_alphas, lib)
    out = _launch_packed(lib, _lib.model_tables(model), X, U, goals, xs,
                         lam0, rho, drho, max_iter, exit_tol, n_sqp_iter, dt,
                         qd_cost, r_cost, gravity, mu, num_alphas,
                         rho_factor, rho_min, rho_max, rho_reset, grid,
                         _lib.stream_of(X))
    sqp_solve_mega_pcg_packed.launches += 1
    return out


sqp_solve_mega_pcg_packed.launches = 0
