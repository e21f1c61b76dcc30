"""K5: the whole SQP solve in one cooperative launch (csrc/sqp_mega.cu).

Counterpart of mpcgpu_tpu/ops/pallas/sqp_megakernel.py, the whole-solve
part (sqp_solve_mega_pcg).  A CPU tensor runs the plain version, the
port's staged iteration loop (sqp.iterate) over the plain K3, K4 and K2
versions for the same fixed ``n_sqp_iter`` with the bail freeze; a CUDA
tensor launches the kernel or raises.

The kernel is one persistent cooperative launch with grid barriers
between its stages; its CG stage runs in one block that holds S in shared
memory, and every block asks for that memory.  ``check_mega_fit`` raises
past the largest N that fits, and before a grid that could not be
co-resident (the counterpart of the reference's checkPcgOccupancy and of
the TPU's check_pcg_vmem_fit): an oversubscribed cooperative launch is
never made.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import (
    form_kkt_schur_reference)
from mpcgpu_tpu_torch.ops.cuda.merit_kernel import (
    alphas_for, line_search_merits_reference)
from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import pcg_dz_reference


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


def sqp_solve_mega_pcg_reference(model, X, U, goals, xs, lam0, rho, drho,
                                 merit0, max_iter: int, exit_tol,
                                 n_sqp_iter: int, dt, qd_cost, r_cost,
                                 gravity, mu, num_alphas: int, rho_factor,
                                 rho_min, rho_max, rho_reset) -> MegaResult:
    from mpcgpu_tpu_torch.sqp import iterate

    def linearize_and_solve(Xc, Uc, lamc, rhoc):
        ks = form_kkt_schur_reference(model, Xc, Uc, goals, xs, rhoc, dt,
                                      qd_cost, r_cost, gravity, True)
        lam_new, dX, dU, it, hit = pcg_dz_reference(ks, lamc, max_iter,
                                                    exit_tol)
        return lam_new, it, hit, dX, dU

    def eval_merits(Xc, Uc, dX, dU):
        return line_search_merits_reference(
            model, Xc, Uc, dX, dU, num_alphas, goals, xs, dt, mu, qd_cost,
            r_cost, gravity)[:num_alphas]

    f32 = dict(dtype=X.dtype, device=X.device)
    st = iterate(X, U, lam0, torch.as_tensor(rho, **f32),
                 torch.as_tensor(drho, **f32), torch.as_tensor(merit0, **f32),
                 n_sqp_iter, linearize_and_solve, eval_merits,
                 alphas_for(num_alphas, X), rho_factor, rho_min, rho_max,
                 rho_reset)
    return MegaResult(*st)


_grids: dict = {}


def check_mega_fit(knot_points: int, lib=None) -> int:
    """Raise unless every block's shared memory fits at this horizon and
    at least one block can be resident; return the grid a launch uses,
    min(N, co-resident blocks)."""
    lib = lib or _lib.library()
    key = (id(lib), knot_points, _current_device())
    if key in _grids:
        return _grids[key]
    n_max = lib.mpc_mega_max_knots()
    if knot_points > n_max:
        raise ValueError(
            f"the whole-solve kernel holds S in one block's shared memory "
            f"and serves N <= {n_max} on this device; got N = {knot_points}")
    grid = lib.mpc_mega_grid(knot_points)
    if grid < 1:
        raise ValueError(
            f"the whole-solve kernel cannot make a cooperative launch of "
            f"N = {knot_points} on this device: no block of it can be "
            f"resident, or the device has no cooperative launch")
    _grids[key] = grid
    return grid


def _current_device():
    return torch.cuda.current_device() if torch.cuda.is_available() else -1


def _launch(lib, tab, X, U, goals, xs, lam0, rho, drho, merit0,
            max_iter: int, exit_tol, n_sqp_iter: int, dt, qd_cost, r_cost,
            gravity, mu, num_alphas: int, rho_factor, rho_min, rho_max,
            rho_reset, grid: int, stream) -> MegaResult:
    dev = X.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    if X.dim() != 2 or X.shape[1] != nx or X.shape[0] < 2:
        raise ValueError(f"X must be (N >= 2, {nx}), got {tuple(X.shape)}")
    n = X.shape[0]
    _lib.expect(X, "X", (n, nx), dev)
    _lib.expect(U, "U", (n - 1, nu), dev)
    _lib.expect(lam0, "lam0", (n, nx), dev)
    if goals.dim() != 2 or goals.shape[0] != n or goals.shape[1] < 3:
        raise ValueError(f"goals must be ({n}, >=3), got {tuple(goals.shape)}")
    _lib.expect(goals, "goals", tuple(goals.shape), dev)
    _lib.expect(xs, "xs", (nx,), dev)
    _lib.expect(rho, "rho", (), dev)
    _lib.expect(merit0, "merit0", (), dev)
    _lib.expect(tab, "tables", (_lib.TAB_SIZE,), dev)
    if not 1 <= num_alphas <= 16:
        raise ValueError(f"the kernel serves 1..16 step sizes, got "
                         f"{num_alphas}")
    f32 = dict(dtype=torch.float32, device=dev)
    Xo = torch.empty((n, nx), **f32)
    Uo = torch.empty((n - 1, nu), **f32)
    lam = torch.empty((n, nx), **f32)
    scal = torch.empty(3, **f32)
    ints = torch.empty(2, dtype=torch.int32, device=dev)
    stats = torch.empty((3, n_sqp_iter), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.mpc_sqp_mega_scratch_floats(n, num_alphas),
                          **f32)
    iscratch = torch.empty(2, dtype=torch.int32, device=dev)
    rc = lib.mpc_sqp_mega(
        tab.data_ptr(), n, X.data_ptr(), U.data_ptr(), goals.data_ptr(),
        goals.shape[1], xs.data_ptr(), lam0.data_ptr(), rho.data_ptr(),
        merit0.data_ptr(), float(drho), int(max_iter), float(exit_tol),
        int(n_sqp_iter), float(dt), float(qd_cost), float(r_cost),
        float(gravity), float(mu), int(num_alphas), float(rho_factor),
        float(rho_min), float(rho_max), float(rho_reset), Xo.data_ptr(),
        Uo.data_ptr(), lam.data_ptr(), scal.data_ptr(), ints.data_ptr(),
        stats.data_ptr(), scratch.data_ptr(), iscratch.data_ptr(),
        int(grid), stream)
    _lib.check(rc, "mpc_sqp_mega")
    return MegaResult(
        X=Xo, U=Uo, lam=lam, rho=scal[0], drho=scal[1], merit=scal[2],
        sqp_iters=ints[0], bailed=ints[1] != 0, pcg_iters=stats[0],
        hit_max=stats[1] != 0, accepted=stats[2] != 0)


def sqp_solve_mega_pcg(model, X, U, goals, xs, lam0, rho, drho, merit0,
                       max_iter: int, exit_tol, n_sqp_iter: int, dt,
                       qd_cost, r_cost, gravity, mu, num_alphas: int,
                       rho_factor, rho_min, rho_max,
                       rho_reset) -> MegaResult:
    """Run n_sqp_iter SQP iterations (stair-PCG dual solve, 8-alpha line
    search, rho schedule, bail freeze) from X (N, nx), U (N-1, nu), warm
    duals lam0 (N, nx), goals (N, >=3), xs (nx,); rho and merit0 are 0-d
    tensors (merit0 the merit of (X, U), from K2), drho, max_iter and
    exit_tol host numbers."""
    if X.device.type == "cpu":
        return sqp_solve_mega_pcg_reference(
            model, X, U, goals, xs, lam0, rho, drho, merit0, max_iter,
            exit_tol, n_sqp_iter, dt, qd_cost, r_cost, gravity, mu,
            num_alphas, rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    lib = _lib.library()
    grid = check_mega_fit(X.shape[0], lib)
    rho = torch.as_tensor(rho, dtype=torch.float32, device=X.device)
    out = _launch(lib, _lib.model_tables(model), X, U, goals, xs, lam0, rho,
                  drho, merit0, max_iter, exit_tol, n_sqp_iter, dt, qd_cost,
                  r_cost, gravity, mu, num_alphas, rho_factor, rho_min,
                  rho_max, rho_reset, grid, _lib.stream_of(X))
    sqp_solve_mega_pcg.launches += 1
    return out


sqp_solve_mega_pcg.launches = 0
