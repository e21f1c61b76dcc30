"""The SQP megakernels: K5, the whole SQP solve in one cooperative launch,
and K9p / K9b, one SQP iteration per launch with the stair-PCG / the
refined BCR dual solve, with K5g and K9pg, K5 and K9p past the cluster
CG's fit, their CG joined across every cluster of the launch
(csrc/sqp_mega.cu); K10, K5 for B arms at once (csrc/sqp_mega_packed.cu).

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
between its stages.  K5's and K9p's CG stage, and K9b's refined BCR
solve, run across the first thread-block cluster of the launch (16 blocks
where the card schedules them, else 8), each block holding its knots' S
bands in shared memory, and every block asks for that memory (N <= about
670 on the H100 for K5 and K9p).  K5g and
K9pg run one CG across all G clusters of C blocks of the launch
(``grid_plan``: C = 16 where the card schedules it unless a smaller C
gives the stages fewer passes over the knots, G the co-resident clusters;
each block holds about N / (G C) knots' bands and vector rows,
on chip where they fit, else in L2), the clusters joined by tagged words
in global memory, with no grid barrier in the CG; K9pg launches K5g's
plan.  ``sqp_solve_mega_pcg`` and ``sqp_iter_mega_pcg`` launch the
cluster kind where it fits and the joined kind past it (``pcg_kind``: a
function of N and the device alone); ``sqp_solve_mega_pcg_grid`` and
``sqp_iter_mega_pcg_grid`` launch the joined kind at any N.
``check_mega_fit`` raises past the largest N a kind
serves, and before a grid that could not be co-resident (the counterpart
of the reference's checkPcgOccupancy and of the TPU's
check_pcg_vmem_fit): an oversubscribed cooperative launch is never made.
``packed_plan`` does the same for K10 and chooses its form from the
occupancy API before the launch: the cluster form runs each arm's CG on a
thread-block cluster of its own (16, 8, 4 or 2 blocks: the largest at
which the B clusters are co-resident), the one-block form (an arm's whole
S in one block's shared memory) serves packs past that; the wrapper
launches the planned form or raises, and counts each form's launches in
``sqp_solve_mega_pcg_packed.form_launches`` beside ``launches``.  After
each K5, K9p, K9b, K5g or K9pg launch, the ``cluster_size`` of its
wrapper (``sqp_solve_mega_pcg``, ``sqp_iter_mega_pcg``, ``sqp_iter_mega``,
``sqp_solve_mega_pcg_grid``, ``sqp_iter_mega_pcg_grid``) holds the cluster
size the kernel read (a device int32), and after each K10 launch
``sqp_solve_mega_pcg_packed.cluster_size`` (0 for the one-block form).

K10's public layout is knot-major with a leading arm axis: X (B, N, nx),
U (B, N-1, nu), lam0 (B, N, nx), goals (B, N, >=3) (or one (N, >=3)
expanded over the arms), xs (B, nx), rho and drho (B,).

Every wrapper and plain version takes the solver's knobs as ``knobs``
(``_lib.Knobs``: eepos or joint tracking, the reference or Gauss-Newton
Hessian, explicit or semi-implicit Euler, the angle wrap; one set for
every arm of K10), the kernels' stages K3's and K2's bodies under them;
under joint tracking goals are the (N, nx) joint states ((B, N, nx) for
K10).
"""
from __future__ import annotations

import ctypes
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
                rho_reset, knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    """sqp.sqp_step over the plain K3 and K2 versions under the knobs,
    with solve(ks, lam) -> (lam', dX, dU, iters, hit) as the dual solve."""
    from mpcgpu_tpu_torch.sqp import staged_step

    def linearize_and_solve(Xc, Uc, lamc, rhoc):
        ks = form_kkt_schur_reference(model, Xc, Uc, goals, xs, rhoc, dt,
                                      qd_cost, r_cost, gravity, precond,
                                      knobs)
        lam_new, dX, dU, it, hit = solve(ks, lamc)
        return lam_new, it, hit, dX, dU

    def eval_merits(Xc, Uc, dX, dU):
        return line_search_merits_reference(
            model, Xc, Uc, dX, dU, num_alphas, goals, xs, dt, mu, qd_cost,
            r_cost, gravity, knobs)[:num_alphas]

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
                                 rho_min, rho_max, rho_reset,
                                 knobs: _lib.Knobs = _lib.DEFAULT_KNOBS
                                 ) -> MegaResult:
    from mpcgpu_tpu_torch.sqp import iterate

    step = _plain_step(model, goals, xs, _pcg_solve(max_iter, exit_tol), True,
                       dt, qd_cost, r_cost, gravity, mu, num_alphas,
                       rho_factor, rho_min, rho_max, rho_reset, knobs)
    st = iterate(X, U, lam0, *_scalars(X, rho, drho, merit0), n_sqp_iter,
                 step)
    return MegaResult(*st)


_grids: dict = {}


# the kernels of csrc/sqp_mega.cu (its Kind)
SOLVE_PCG, ITER_PCG, ITER_BCR, SOLVE_PCG_GRID, ITER_PCG_GRID = 0, 1, 2, 3, 4
_KIND_NAMES = {SOLVE_PCG: "the cluster whole-solve kernel",
               ITER_PCG: "the cluster per-iteration PCG kernel",
               ITER_BCR: "the per-iteration BCR kernel",
               SOLVE_PCG_GRID: "the joined-CG whole-solve kernel",
               ITER_PCG_GRID: "the joined-CG per-iteration kernel"}
_GRID_KIND = {SOLVE_PCG: SOLVE_PCG_GRID, ITER_PCG: ITER_PCG_GRID}


def pcg_kind(knot_points: int, lib=None, kind: int = SOLVE_PCG) -> int:
    """The kind that serves the PCG megakernel `kind` (SOLVE_PCG or
    ITER_PCG) at this horizon: itself where a cluster's shared memory
    holds its CG, else its joined form (K5g, K9pg)."""
    lib = lib or _lib.library()
    if knot_points <= lib.mpc_mega_max_knots(kind):
        return kind
    return _GRID_KIND[kind]


def check_mega_fit(knot_points: int, lib=None, kind: int = SOLVE_PCG,
                   stair: int = -1, cluster: int = 0) -> int:
    """Raise unless kernel `kind` (K5, K9p, K9b, K5g, K9pg) serves this
    horizon on this device and at least one cluster can be resident; return
    the grid a launch uses: C x min(co-resident clusters, ceil(N / C)) for
    K5, K9p and K9b, C x G for K5g and K9pg (grid_plan's).  cluster (K5,
    K9p, K9b) and stair (K5, K9p) ask for a cluster size (8 or 16; 0 the
    plan's choice) and place the stair bands (1 on chip, 0 in L2, -1 the
    plan's choice) as mpc_mega_cluster_plan's arguments."""
    lib = lib or _lib.library()
    key = (id(lib), knot_points, kind, stair, cluster, _current_device())
    if key in _grids:
        return _grids[key]
    name = _KIND_NAMES[kind]
    n_max = lib.mpc_mega_max_knots(kind)
    if knot_points > n_max:
        where = ("keeps its scratch in global memory"
                 if kind in (SOLVE_PCG_GRID, ITER_PCG_GRID) else
                 "holds its dual solve in one cluster's shared memory")
        raise ValueError(
            f"{name} {where} and serves N <= {n_max} on this device; got "
            f"N = {knot_points}")
    if kind in (SOLVE_PCG, ITER_PCG, ITER_BCR):
        plan = (ctypes.c_int * 3)()
        lib.mpc_mega_cluster_plan(knot_points, kind, cluster, stair, plan)
        grid = plan[2]
    else:
        grid = lib.mpc_mega_grid(knot_points, kind)
    if grid < 1:
        raise ValueError(
            f"{name} cannot make a cooperative launch of N = {knot_points} "
            f"on this device: no cluster of it can be resident")
    _grids[key] = grid
    return grid


def _current_device():
    return torch.cuda.current_device() if torch.cuda.is_available() else -1


class GridPlan(NamedTuple):
    cluster: int   # C, blocks a cluster
    clusters: int  # G, clusters in the joined CG
    place: int     # the CG's area: 3 S's and the stair's bands and the
                   # vectors on chip, 2 S's bands and the vectors, 1 the
                   # vectors, 0 none (in L2)
    grid: int      # C x G blocks


def grid_plan(knot_points: int, lib=None, cluster: int = 0,
              place: int = -1) -> GridPlan:
    """K5g's and K9pg's launch at this horizon (mpc_mega_grid_plan, from the
    occupancy API; a function of N and the device alone): cluster 0 the
    plan's choice (16, or a smaller size whose co-resident clusters give
    the stages fewer passes over the knots), else that size; place -1 the
    plan's choice, else that placement.  grid is 0 where no such launch
    fits.  The host build plans one block unless a size is asked, and then
    N / C clusters of it for its block emulation."""
    lib = lib or _lib.library()
    out = (ctypes.c_int * 4)()
    lib.mpc_mega_grid_plan(knot_points, cluster, place, out)
    return GridPlan(*out)


def _expect_iterate(lib, tab, X, U, goals, xs, rho, merit,
                    num_alphas: int, knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    """Raise unless the single-arm inputs are what the kernels of lib
    take under the knobs; return (N, nx, nu)."""
    dev = X.device
    _, nx, nu = _lib.sizes(tab, lib)
    if X.dim() != 2 or X.shape[1] != nx or X.shape[0] < 2:
        raise ValueError(f"X must be (N >= 2, {nx}), got {tuple(X.shape)}")
    n = X.shape[0]
    _lib.expect(X, "X", (n, nx), dev)
    _lib.expect(U, "U", (n - 1, nu), dev)
    _lib.expect_goals(goals, n, nx, knobs)
    _lib.expect(goals, "goals", tuple(goals.shape), dev)
    _lib.expect(xs, "xs", (nx,), dev)
    _lib.expect(rho, "rho", (), dev)
    _lib.expect(merit, "merit", (), dev)
    _lib.expect(tab, "tables", (tab.numel(),), dev)
    if not 1 <= num_alphas <= 16:
        raise ValueError(f"the kernel serves 1..16 step sizes, got "
                         f"{num_alphas}")
    return n, nx, nu


def _launch(lib, tab, X, U, goals, xs, lam0, rho, drho, merit0,
            max_iter: int, exit_tol, n_sqp_iter: int, dt, qd_cost, r_cost,
            gravity, mu, num_alphas: int, rho_factor, rho_min, rho_max,
            rho_reset, grid: int, stream,
            kind: int = SOLVE_PCG, stair: int = -1,
            cluster: int = 0,
            knobs: _lib.Knobs = _lib.DEFAULT_KNOBS) -> MegaResult:
    """One K5 (kind SOLVE_PCG) or K5g (SOLVE_PCG_GRID) launch; stair and
    cluster as check_mega_fit's (K5), as grid_plan's place and cluster
    (K5g, on grid / C clusters)."""
    dev = X.device
    n, nx, nu = _expect_iterate(lib, tab, X, U, goals, xs, rho, merit0,
                                num_alphas, knobs)
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
    iscratch = torch.empty(3, dtype=torch.int32, device=dev)
    rc = lib.mpc_sqp_mega(
        tab.data_ptr(), n, X.data_ptr(), U.data_ptr(), goals.data_ptr(),
        goals.shape[1], xs.data_ptr(), lam0.data_ptr(), rho.data_ptr(),
        merit0.data_ptr(), float(drho), int(max_iter), float(exit_tol),
        int(n_sqp_iter), float(dt), float(qd_cost), float(r_cost),
        float(gravity), float(mu), int(num_alphas), float(rho_factor),
        float(rho_min), float(rho_max), float(rho_reset), Xo.data_ptr(),
        Uo.data_ptr(), lam.data_ptr(), scal.data_ptr(), ints.data_ptr(),
        stats.data_ptr(), scratch.data_ptr(), iscratch.data_ptr(), int(kind),
        int(grid), int(cluster), int(stair), *_lib.knob_args(knobs), stream)
    _lib.check(rc, "mpc_sqp_mega")
    (sqp_solve_mega_pcg if kind == SOLVE_PCG
     else sqp_solve_mega_pcg_grid).cluster_size = iscratch[2]
    return MegaResult(
        X=Xo, U=Uo, lam=lam, rho=scal[0], drho=scal[1], merit=scal[2],
        sqp_iters=ints[0], bailed=ints[1] != 0, pcg_iters=stats[0],
        hit_max=stats[1] != 0, accepted=stats[2] != 0)


def _solve_on(lib, kind: int, model, X, U, goals, xs, lam0, rho, drho,
              merit0, *rest, knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    """One K5 or K5g launch (kind) through library lib; counts it."""
    grid = check_mega_fit(X.shape[0], lib, kind)
    rho = torch.as_tensor(rho, dtype=torch.float32, device=X.device)
    out = _launch(lib, _lib.model_tables(model), X, U, goals, xs, lam0, rho,
                  drho, merit0, *rest, grid, _lib.stream_of(X), kind,
                  knobs=knobs)
    wrapper = (sqp_solve_mega_pcg if kind == SOLVE_PCG
               else sqp_solve_mega_pcg_grid)
    wrapper.launches += 1
    return out


def _card_library(X, model, iiwa_only: str = ""):
    """The library of the model's joint count; raise unless the count is
    the IIWA's where the kernel iiwa_only (a name) serves only it."""
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    nj = _lib.check_nj(model.num_joints)
    if iiwa_only:
        _lib.require_iiwa(nj, iiwa_only)
    return _lib.library(nj)


def sqp_solve_mega_pcg(model, X, U, goals, xs, lam0, rho, drho, merit0,
                       max_iter: int, exit_tol, n_sqp_iter: int, dt,
                       qd_cost, r_cost, gravity, mu, num_alphas: int,
                       rho_factor, rho_min, rho_max, rho_reset,
                       knobs: _lib.Knobs = _lib.DEFAULT_KNOBS) -> MegaResult:
    """Run n_sqp_iter SQP iterations (stair-PCG dual solve, 8-alpha line
    search, rho schedule, bail freeze) from X (N, nx), U (N-1, nu), warm
    duals lam0 (N, nx), goals (N, >=3; (N, nx) under joint tracking), xs
    (nx,); rho and merit0 are 0-d tensors (merit0 the merit of (X, U),
    from K2), drho, max_iter and exit_tol host numbers.  K5 where its
    cluster CG fits, else K5g."""
    args = (model, X, U, goals, xs, lam0, rho, drho, merit0, max_iter,
            exit_tol, n_sqp_iter, dt, qd_cost, r_cost, gravity, mu,
            num_alphas, rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type == "cpu":
        return sqp_solve_mega_pcg_reference(*args, knobs=knobs)
    return _solve_pcg_on(_card_library(X, model), *args, knobs=knobs)


def _solve_pcg_on(lib, model, X, *rest,
                  knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    """K5 where its cluster CG fits, else K5g, through library lib."""
    return _solve_on(lib, pcg_kind(X.shape[0], lib, SOLVE_PCG), model, X,
                     *rest, knobs=knobs)


sqp_solve_mega_pcg.launches = 0
sqp_solve_mega_pcg.cluster_size = None


def sqp_solve_mega_pcg_grid(model, X, U, goals, xs, lam0, rho, drho, merit0,
                            max_iter: int, exit_tol, n_sqp_iter: int, dt,
                            qd_cost, r_cost, gravity, mu, num_alphas: int,
                            rho_factor, rho_min, rho_max, rho_reset,
                            knobs: _lib.Knobs = _lib.DEFAULT_KNOBS
                            ) -> MegaResult:
    """K5g: sqp_solve_mega_pcg's solve with its CG joined across the
    launch's clusters (grid_plan), at any N."""
    args = (model, X, U, goals, xs, lam0, rho, drho, merit0, max_iter,
            exit_tol, n_sqp_iter, dt, qd_cost, r_cost, gravity, mu,
            num_alphas, rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type == "cpu":
        return sqp_solve_mega_pcg_reference(*args, knobs=knobs)
    return _solve_on(_card_library(X, model), SOLVE_PCG_GRID, *args,
                     knobs=knobs)


sqp_solve_mega_pcg_grid.launches = 0
sqp_solve_mega_pcg_grid.cluster_size = None


def sqp_iter_mega_pcg_reference(model, X, U, goals, xs, lam0, rho, drho,
                                merit, max_iter: int, exit_tol, dt, qd_cost,
                                r_cost, gravity, mu, num_alphas: int,
                                rho_factor, rho_min, rho_max, rho_reset,
                                knobs: _lib.Knobs = _lib.DEFAULT_KNOBS
                                ) -> IterResult:
    step = _plain_step(model, goals, xs, _pcg_solve(max_iter, exit_tol), True,
                       dt, qd_cost, r_cost, gravity, mu, num_alphas,
                       rho_factor, rho_min, rho_max, rho_reset, knobs)
    return step(X, U, lam0, *_scalars(X, rho, drho, merit))


def sqp_iter_mega_reference(model, X, U, goals, xs, rho, drho, merit, dt,
                            qd_cost, r_cost, gravity, mu, num_alphas: int,
                            rho_factor, rho_min, rho_max, rho_reset,
                            knobs: _lib.Knobs = _lib.DEFAULT_KNOBS
                            ) -> IterResult:
    step = _plain_step(model, goals, xs, lambda ks, lam: bcr_dz_reference(ks),
                       False, dt, qd_cost, r_cost, gravity, mu, num_alphas,
                       rho_factor, rho_min, rho_max, rho_reset, knobs)
    return step(X, U, torch.zeros_like(X), *_scalars(X, rho, drho, merit))


def _launch_iter(lib, kind: int, tab, X, U, goals, xs, lam0, rho, drho, merit,
                 max_iter: int, exit_tol, dt, qd_cost, r_cost, gravity, mu,
                 num_alphas: int, rho_factor, rho_min, rho_max, rho_reset,
                 grid: int, stream, stair: int = -1,
                 cluster: int = 0,
                 knobs: _lib.Knobs = _lib.DEFAULT_KNOBS) -> IterResult:
    """One launch of K9p or K9pg (kind ITER_PCG or ITER_PCG_GRID, lam0 the
    warm start; stair and cluster as _launch's) or K9b (ITER_BCR, lam0
    None; cluster as check_mega_fit's, and on the host build a size of
    1-16 that its block emulation runs on grid / C clusters)."""
    dev = X.device
    n, nx, nu = _expect_iterate(lib, tab, X, U, goals, xs, rho, merit,
                                num_alphas, knobs)
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
    iscratch = torch.empty(3, dtype=torch.int32, device=dev)
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
            *tail[:-2], int(kind), tail[-2], int(cluster), int(stair),
            *_lib.knob_args(knobs), tail[-1])
        _lib.check(rc, "mpc_sqp_iter_mega_pcg")
        (sqp_iter_mega_pcg if kind == ITER_PCG
         else sqp_iter_mega_pcg_grid).cluster_size = iscratch[2]
    else:
        if n & (n - 1):
            raise ValueError(f"the per-iteration BCR kernel needs a "
                             f"power-of-2 horizon, got N = {n}")
        rc = lib.mpc_sqp_iter_mega(*head, rho.data_ptr(), drho.data_ptr(),
                                   merit.data_ptr(), *schedule, *tail[:-1],
                                   int(cluster), *_lib.knob_args(knobs),
                                   tail[-1])
        _lib.check(rc, "mpc_sqp_iter_mega")
        sqp_iter_mega.cluster_size = iscratch[2]
    return IterResult(X=Xo, U=Uo, lam=lam, rho=scal[0], drho=scal[1],
                      merit=scal[2], accept=stats[2] != 0, bail=ints[1] != 0,
                      pcg_iters=stats[0], hit_max=stats[1] != 0)


def _iter_on(lib, kind: int, model, X, U, goals, xs, lam0, rho, drho, merit,
             *rest, knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    """One K9p, K9pg or K9b launch (kind) through library lib; counts it."""
    grid = check_mega_fit(X.shape[0], lib, kind)
    rho, drho, merit = _scalars(X, rho, drho, merit)
    out = _launch_iter(lib, kind, _lib.model_tables(model), X, U, goals, xs,
                       lam0, rho, drho, merit, *rest, grid, _lib.stream_of(X),
                       knobs=knobs)
    {ITER_PCG: sqp_iter_mega_pcg, ITER_PCG_GRID: sqp_iter_mega_pcg_grid,
     ITER_BCR: sqp_iter_mega}[kind].launches += 1
    return out


def sqp_iter_mega_pcg(model, X, U, goals, xs, lam0, rho, drho, merit,
                      max_iter: int, exit_tol, dt, qd_cost, r_cost, gravity,
                      mu, num_alphas: int, rho_factor, rho_min, rho_max,
                      rho_reset,
                      knobs: _lib.Knobs = _lib.DEFAULT_KNOBS) -> IterResult:
    """K9p (K9pg past its cluster fit): one SQP iteration (K3's stages
    with the stair, the warm-started stair-PCG from lam0 and dz, the
    8-alpha line search, the accept test and rho schedule) from X (N, nx),
    U (N-1, nu), goals (N, >=3; (N, nx) under joint tracking), xs (nx,);
    rho, drho and merit (the incumbent's) are 0-d tensors (or numbers),
    max_iter and exit_tol host numbers."""
    args = (model, X, U, goals, xs, lam0, rho, drho, merit, max_iter,
            exit_tol, dt, qd_cost, r_cost, gravity, mu, num_alphas,
            rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type == "cpu":
        return sqp_iter_mega_pcg_reference(*args, knobs=knobs)
    return _iter_pcg_on(_card_library(X, model, "K9p (sqp_iter_mega_pcg)"),
                        *args, knobs=knobs)


def _iter_pcg_on(lib, model, X, *rest,
                 knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    """K9p where its cluster CG fits, else K9pg, through library lib."""
    return _iter_on(lib, pcg_kind(X.shape[0], lib, ITER_PCG), model, X,
                    *rest, knobs=knobs)


sqp_iter_mega_pcg.launches = 0
sqp_iter_mega_pcg.cluster_size = None


def sqp_iter_mega_pcg_grid(model, X, U, goals, xs, lam0, rho, drho, merit,
                           max_iter: int, exit_tol, dt, qd_cost, r_cost,
                           gravity, mu, num_alphas: int, rho_factor, rho_min,
                           rho_max, rho_reset,
                           knobs: _lib.Knobs = _lib.DEFAULT_KNOBS
                           ) -> IterResult:
    """K9pg: sqp_iter_mega_pcg's iteration with its CG joined across the
    launch's clusters (K5g's plan), at any N."""
    args = (model, X, U, goals, xs, lam0, rho, drho, merit, max_iter,
            exit_tol, dt, qd_cost, r_cost, gravity, mu, num_alphas,
            rho_factor, rho_min, rho_max, rho_reset)
    if X.device.type == "cpu":
        return sqp_iter_mega_pcg_reference(*args, knobs=knobs)
    return _iter_on(_card_library(X, model, "K9pg (sqp_iter_mega_pcg_grid)"),
                    ITER_PCG_GRID, *args, knobs=knobs)


sqp_iter_mega_pcg_grid.launches = 0
sqp_iter_mega_pcg_grid.cluster_size = None


def sqp_iter_mega(model, X, U, goals, xs, rho, drho, merit, dt, qd_cost,
                  r_cost, gravity, mu, num_alphas: int, rho_factor, rho_min,
                  rho_max, rho_reset,
                  knobs: _lib.Knobs = _lib.DEFAULT_KNOBS) -> IterResult:
    """K9b: one SQP iteration with the refined BCR dual solve (no stair, no
    warm start; pcg_iters 0, hit_max False); N a power of 2.  Arguments as
    sqp_iter_mega_pcg's, less lam0, max_iter and exit_tol."""
    if X.device.type == "cpu":
        return sqp_iter_mega_reference(
            model, X, U, goals, xs, rho, drho, merit, dt, qd_cost, r_cost,
            gravity, mu, num_alphas, rho_factor, rho_min, rho_max, rho_reset,
            knobs)
    return _iter_on(_card_library(X, model, "K9b (sqp_iter_mega)"), ITER_BCR,
                    model, X, U, goals, xs, None,
                    rho, drho, merit, 0, 0.0, dt, qd_cost, r_cost, gravity,
                    mu, num_alphas, rho_factor, rho_min, rho_max, rho_reset,
                    knobs=knobs)


sqp_iter_mega.launches = 0
sqp_iter_mega.cluster_size = None


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
                                        rho_reset,
                                        knobs: _lib.Knobs = _lib.DEFAULT_KNOBS
                                        ) -> PackedResult:
    """The plain version of K10: sqp.iterate over the arm-batched plain
    modules (KKT, Schur with the stair preconditioner, the CG with its
    shared exit, dz, the candidate merits), the incumbent merit computed
    first, on the tensors' device.  The knobs reach the plain modules as
    the JAX packed kernel's do; with tracking="joint" goals are the
    (B, N, nx) joint rows."""
    from mpcgpu_tpu_torch.sqp import iterate, staged_step

    mkw = dict(gravity=gravity, **knobs.merit_kw())

    def linearize_and_solve(Xc, Uc, lamc, rhoc):
        kkt = form_kkt(model, Xc, Uc, goals, xs, dt, qd_cost, r_cost,
                       gravity=gravity, **knobs.kkt_kw())
        sd = form_schur(kkt, rhoc)
        res = pcg(sd.S, sd.Pinv, sd.gamma, lamc, max_iter, exit_tol,
                  shared_exit=True)
        dX, dU = compute_dz(kkt, sd, res.lam)
        return res.lam, res.iters, res.hit_max, dX, dU

    def eval_merits(Xc, Uc, dX, dU):
        return merit_ops.line_search_merits(
            model, Xc, Uc, dX, dU, alphas_for(num_alphas, Xc), goals, xs, dt,
            mu, qd_cost, r_cost, **mkw)

    f32 = dict(dtype=X.dtype, device=X.device)
    b = X.shape[0]
    merit0 = merit_ops.merit(model, X, U, goals, xs, dt, mu, qd_cost, r_cost,
                             **mkw)
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


class PackedPlan(NamedTuple):
    cluster: int   # blocks a cluster of the cluster form; 0 the one-block form
    stair: int     # the cluster form: 1 the stair bands on chip, 0 in L2
    grid: int      # blocks of the launch


def packed_plan(knot_points: int, arms: int, num_alphas: int = 8, lib=None,
                cluster: int = 0, stair: int = -1) -> PackedPlan:
    """K10's launch for B = arms at this horizon, from the occupancy API:
    cluster 0 the plan's choice (the cluster form at the largest C of 16,
    8, 4, 2 whose B clusters are co-resident, else the one-block form), 2,
    4, 8 or 16 that cluster size, -1 the one-block form; stair as
    mpc_mega_packed_plan's.  Raises where that form does not fit (the
    host build plans the one-block form on one block, and a cluster size
    for its block emulation).  The library keeps the plans it made."""
    lib = lib or _lib.library()
    out = (ctypes.c_int * 3)()
    if not lib.mpc_mega_packed_plan(knot_points, arms, num_alphas, cluster,
                                    stair, out):
        form = {0: "any form", -1: "the one-block form"}.get(
            cluster, f"clusters of {cluster}")
        raise ValueError(
            f"the arm-packed whole-solve kernel cannot make a cooperative "
            f"launch of {arms} arms at N = {knot_points} in {form} on this "
            f"device: it serves N <= "
            f"{lib.mpc_mega_packed_max_knots(arms, num_alphas)} for "
            f"{arms} arms (too few clusters or blocks can be resident, an "
            f"arm's share of S does not fit a block, or the device has no "
            f"cooperative launch)")
    return PackedPlan(*out)


def _launch_packed(lib, tab, X, U, goals, xs, lam0, rho, drho,
                   max_iter: int, exit_tol, n_sqp_iter: int, dt, qd_cost,
                   r_cost, gravity, mu, num_alphas: int, rho_factor, rho_min,
                   rho_max, rho_reset, grid: int, stream, cluster: int = 0,
                   stair: int = -1, scratch=None,
                   knobs: _lib.Knobs = _lib.DEFAULT_KNOBS) -> PackedResult:
    """One K10 launch on `grid` blocks: cluster 0 the one-block form, 2-16
    the cluster form (stair as mpc_mega_packed_plan's).  scratch, when
    given, is the launch's float32 scratch (mpc_sqp_mega_packed_scratch_
    floats); its first 4 B floats hold the cluster form's published etas
    (2 x B words: the tag in the high 32 bits, eta's bits in the low)."""
    dev = X.device
    _, nx, nu = _lib.sizes(tab, lib)
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
    _lib.expect_goals(goals, n, nx, knobs, lead=(b,))
    garm = 0 if goals.stride(0) == 0 else n * goals.shape[2]
    base = goals[0] if garm == 0 else goals
    _lib.expect(base, "goals", tuple(base.shape), dev)
    _lib.expect(tab, "tables", (tab.numel(),), dev)
    if not 1 <= num_alphas <= 16:
        raise ValueError(f"the kernel serves 1..16 step sizes, got "
                         f"{num_alphas}")
    Xo = torch.empty((b, n, nx), **f32)
    Uo = torch.empty((b, n - 1, nu), **f32)
    lam = torch.empty((b, n, nx), **f32)
    rho_o = torch.empty(b, **f32)
    merit = torch.empty(b, **f32)
    ints = torch.empty(2 * b + 2, dtype=torch.int32, device=dev)
    floats = lib.mpc_sqp_mega_packed_scratch_floats(n, b, num_alphas)
    if scratch is None:
        scratch = torch.empty(floats, **f32)
    _lib.expect(scratch, "scratch", (floats,), dev)
    rc = lib.mpc_sqp_mega_packed(
        tab.data_ptr(), b, n, X.data_ptr(), U.data_ptr(), base.data_ptr(),
        goals.shape[2], garm, xs.data_ptr(), lam0.data_ptr(), rho.data_ptr(),
        drho.data_ptr(), int(max_iter), float(exit_tol), int(n_sqp_iter),
        float(dt), float(qd_cost), float(r_cost), float(gravity), float(mu),
        int(num_alphas), float(rho_factor), float(rho_min), float(rho_max),
        float(rho_reset), Xo.data_ptr(), Uo.data_ptr(), lam.data_ptr(),
        rho_o.data_ptr(), merit.data_ptr(), ints.data_ptr(),
        scratch.data_ptr(), int(grid), int(cluster), int(stair),
        *_lib.knob_args(knobs), stream)
    _lib.check(rc, "mpc_sqp_mega_packed")
    sqp_solve_mega_pcg_packed.cluster_size = ints[2 * b + 1]
    return PackedResult(X=Xo, U=Uo, lam=lam, rho=rho_o, merit=merit,
                        sqp_iters=ints[:b], bailed=ints[b:2 * b] != 0,
                        pcg_iters_total=ints[2 * b])


def sqp_solve_mega_pcg_packed(model, X, U, goals, xs, lam0, rho, drho,
                              max_iter: int, exit_tol, n_sqp_iter: int, dt,
                              qd_cost, r_cost, gravity, mu, num_alphas: int,
                              rho_factor, rho_min, rho_max, rho_reset,
                              knobs: _lib.Knobs = _lib.DEFAULT_KNOBS
                              ) -> PackedResult:
    """Run n_sqp_iter SQP iterations for each of B arms (module doc for the
    layout): per-arm rho, drho, merit (computed first, in-kernel), accept
    and bail freeze, one CG per arm with the shared exit; rho and drho are
    (B,) tensors or numbers, max_iter and exit_tol host numbers."""
    if X.device.type == "cpu":
        return sqp_solve_mega_pcg_packed_reference(
            model, X, U, goals, xs, lam0, rho, drho, max_iter, exit_tol,
            n_sqp_iter, dt, qd_cost, r_cost, gravity, mu, num_alphas,
            rho_factor, rho_min, rho_max, rho_reset, knobs)
    lib = _card_library(X, model, "K10 (sqp_solve_mega_pcg_packed)")
    plan = packed_plan(X.shape[1], X.shape[0], num_alphas, lib)
    out = _launch_packed(lib, _lib.model_tables(model), X, U, goals, xs,
                         lam0, rho, drho, max_iter, exit_tol, n_sqp_iter, dt,
                         qd_cost, r_cost, gravity, mu, num_alphas,
                         rho_factor, rho_min, rho_max, rho_reset, plan.grid,
                         _lib.stream_of(X), plan.cluster, plan.stair,
                         knobs=knobs)
    sqp_solve_mega_pcg_packed.launches += 1
    sqp_solve_mega_pcg_packed.form_launches[
        "cluster" if plan.cluster else "one_block"] += 1
    return out


sqp_solve_mega_pcg_packed.launches = 0
sqp_solve_mega_pcg_packed.form_launches = {"cluster": 0, "one_block": 0}
sqp_solve_mega_pcg_packed.cluster_size = None
