"""K4: warm-started stair-preconditioned CG + primal step, and K4b: the
same CG without the primal step; K4g and K4bg: their grid-wide forms
(csrc/pcg_dz.cu).

Counterparts of mpcgpu_tpu/ops/pallas/pcg_kernel.py (pcg_dz_pallas_lanes;
pcg_pallas_lanes and pcg_pallas, the "pcg_pallas" backend's solve).  A CPU
tensor runs the plain version (``ops.pcg.pcg``, + ``ops.dz.compute_dz``
for K4); a CUDA tensor launches a kernel or raises.

K4 and K4b run the whole solve in one thread block with S in shared
memory, so one block's shared memory bounds their horizon (N <= 90 on
the H100).  K4g and K4bg run the same CG as one cooperative launch over
the grid, S in global memory, at any N (``check_pcg_grid_fit`` raises
before a grid that cannot be co-resident).  ``pcg_dz`` and ``pcg_solve``
launch the one-block kernel where it fits and the grid form past it: the
choice is ``one_block_fits`` (the counterpart of the reference's
``checkPcgOccupancy`` and of the TPU's ``check_pcg_vmem_fit``), a
function of N and the device alone.  ``pcg_dz_grid`` and
``pcg_solve_grid`` launch the grid form at any N.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import (KnotSchur,
                                                        compute_dz_knots,
                                                        expect_system)
from mpcgpu_tpu_torch.ops.pcg import pcg

_SOLVE_FIELDS = ("SL", "SD", "SU", "PL", "PD", "PU", "gamma")
_DZ_FIELDS = ("A", "B", "q", "r", "Qinv", "Rinv")


def pcg_dz_reference(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    res = pcg(BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU),
              ks.gamma, lam0, max_iter, exit_tol)
    dX, dU = compute_dz_knots(ks, res.lam)
    return res.lam, dX, dU, res.iters, res.hit_max


def one_block_fits(knot_points: int, lib=None) -> bool:
    """Whether K4 and K4b hold this horizon's S in one block's shared
    memory on the current device."""
    return knot_points <= (lib or _lib.library()).mpc_pcg_max_knots()


_grids: dict = {}


def check_pcg_grid_fit(knot_points: int, lib=None, dz: bool = True) -> int:
    """Raise unless a cooperative launch of K4g (dz) or K4bg can be made at
    this horizon on the current device; return its grid, min(N,
    co-resident blocks) (1 in the host build)."""
    lib = lib or _lib.library()
    dev = torch.cuda.current_device() if torch.cuda.is_available() else -1
    key = (id(lib), knot_points, bool(dz), dev)
    if key not in _grids:
        grid = lib.mpc_pcg_grid(knot_points, int(bool(dz)))
        if grid < 1:
            raise ValueError(
                f"the grid-wide PCG kernel cannot make a cooperative launch "
                f"of N = {knot_points} on this device: no block of it can be "
                f"resident, or the device has no cooperative launch")
        _grids[key] = grid
    return _grids[key]


def _launch(lib, ks: KnotSchur, lam0, max_iter: int, exit_tol, stream):
    dev = ks.gamma.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    n = expect_system(ks, lam0, KnotSchur._fields, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lam = torch.empty((n, nx), **f32)
    dX = torch.empty((n, nx), **f32)
    dU = torch.empty((n - 1, nu), **f32)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    hit = torch.empty((), dtype=torch.bool, device=dev)
    rc = lib.mpc_pcg_dz(
        n, *(getattr(ks, f).data_ptr() for f in
             ("SL", "SD", "SU", "PL", "PD", "PU", "gamma")),
        lam0.data_ptr(),
        *(getattr(ks, f).data_ptr() for f in ("A", "B", "q", "r", "Qinv",
                                             "Rinv")),
        int(max_iter), float(exit_tol), lam.data_ptr(), dX.data_ptr(),
        dU.data_ptr(), iters.data_ptr(), hit.data_ptr(), stream)
    _lib.check(rc, "mpc_pcg_dz")
    return lam, dX, dU, iters, hit


def _launch_grid(lib, ks: KnotSchur, lam0, max_iter: int, exit_tol,
                 dz: bool, grid: int, stream):
    """One K4g (dz) or K4bg launch; for K4bg only S, P and gamma of ks are
    read, and (lam, iters, hit) is returned."""
    dev = ks.gamma.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    n = expect_system(ks, lam0, _SOLVE_FIELDS + (_DZ_FIELDS if dz else ()),
                      dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lam = torch.empty((n, nx), **f32)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    hit = torch.empty((), dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.mpc_pcg_grid_scratch_floats(n), **f32)
    if dz:
        dX = torch.empty((n, nx), **f32)
        dU = torch.empty((n - 1, nu), **f32)
        dz_in = [getattr(ks, f).data_ptr() for f in _DZ_FIELDS]
        dz_out = [dX.data_ptr(), dU.data_ptr()]
    else:
        dz_in, dz_out = [None] * len(_DZ_FIELDS), [None, None]
    rc = lib.mpc_pcg_grid_solve(
        int(dz), n, *(getattr(ks, f).data_ptr() for f in _SOLVE_FIELDS),
        lam0.data_ptr(), *dz_in, int(max_iter), float(exit_tol),
        lam.data_ptr(), *dz_out, iters.data_ptr(), hit.data_ptr(),
        scratch.data_ptr(), int(grid), stream)
    _lib.check(rc, "mpc_pcg_grid_solve")
    return (lam, dX, dU, iters, hit) if dz else (lam, iters, hit)


def pcg_solve_reference(S: BlockTri, Pinv: BlockTri, gamma, lam0,
                        max_iter: int, exit_tol):
    res = pcg(S, Pinv, gamma, lam0, max_iter, exit_tol)
    return res.lam, res.iters, res.hit_max


def _launch_solve(lib, S: BlockTri, Pinv: BlockTri, gamma, lam0,
                  max_iter: int, exit_tol, stream):
    dev = gamma.device
    nx = 2 * _lib.NJ
    if gamma.dim() != 2 or gamma.shape[1] != nx:
        raise ValueError(f"gamma must be (N, {nx}), got {tuple(gamma.shape)}")
    n = gamma.shape[0]
    bands = (*S, *Pinv)
    for name, t in zip(("SL", "SD", "SU", "PL", "PD", "PU"), bands):
        _lib.expect(t, name, (n, nx, nx), dev)
    _lib.expect(gamma, "gamma", (n, nx), dev)
    _lib.expect(lam0, "lam0", (n, nx), dev)
    lam = torch.empty((n, nx), dtype=torch.float32, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    hit = torch.empty((), dtype=torch.bool, device=dev)
    rc = lib.mpc_pcg_solve(n, *(t.data_ptr() for t in bands),
                           gamma.data_ptr(), lam0.data_ptr(), int(max_iter),
                           float(exit_tol), lam.data_ptr(), iters.data_ptr(),
                           hit.data_ptr(), stream)
    _lib.check(rc, "mpc_pcg_solve")
    return lam, iters, hit


def _solve_system(S: BlockTri, Pinv: BlockTri, gamma) -> KnotSchur:
    """S, Pinv and gamma as the KnotSchur fields K4bg reads."""
    return KnotSchur(*S, *Pinv, gamma, *(None,) * 6)


def _pcg_solve_grid_on(lib, S, Pinv, gamma, lam0, max_iter, exit_tol,
                       stream):
    ks = _solve_system(S, Pinv, gamma)
    grid = check_pcg_grid_fit(gamma.shape[0], lib, dz=False)
    out = _launch_grid(lib, ks, lam0, max_iter, exit_tol, False, grid, stream)
    pcg_solve_grid.launches += 1
    return out


def _pcg_solve_on(lib, S, Pinv, gamma, lam0, max_iter, exit_tol, stream):
    """K4b where it fits, K4bg past it, through library lib."""
    if not one_block_fits(gamma.shape[0], lib):
        return _pcg_solve_grid_on(lib, S, Pinv, gamma, lam0, max_iter,
                                  exit_tol, stream)
    out = _launch_solve(lib, S, Pinv, gamma, lam0, max_iter, exit_tol, stream)
    pcg_solve.launches += 1
    return out


def _on_card(lam0):
    if lam0.device.type != "cuda":
        raise ValueError(f"unsupported device {lam0.device}")
    return _lib.library(), _lib.stream_of(lam0)


def pcg_solve(S: BlockTri, Pinv: BlockTri, gamma, lam0, max_iter: int,
              exit_tol):
    """K4b (K4bg past the one-block fit): solve S lam = gamma (bands (N,
    nx, nx), gamma (N, nx)) with the stair preconditioner Pinv,
    warm-started at lam0; return (lam (N, nx), iters int32, hit_max bool).
    max_iter and exit_tol are host numbers."""
    if lam0.device.type == "cpu":
        return pcg_solve_reference(S, Pinv, gamma, lam0, max_iter, exit_tol)
    lib, stream = _on_card(lam0)
    return _pcg_solve_on(lib, S, Pinv, gamma, lam0, max_iter, exit_tol,
                         stream)


pcg_solve.launches = 0


def pcg_solve_grid(S: BlockTri, Pinv: BlockTri, gamma, lam0, max_iter: int,
                   exit_tol):
    """K4bg: pcg_solve's CG as the grid-wide kernel, at any N."""
    if lam0.device.type == "cpu":
        return pcg_solve_reference(S, Pinv, gamma, lam0, max_iter, exit_tol)
    lib, stream = _on_card(lam0)
    return _pcg_solve_grid_on(lib, S, Pinv, gamma, lam0, max_iter, exit_tol,
                              stream)


pcg_solve_grid.launches = 0


def _pcg_dz_grid_on(lib, ks, lam0, max_iter, exit_tol, stream):
    grid = check_pcg_grid_fit(ks.gamma.shape[0], lib, dz=True)
    out = _launch_grid(lib, ks, lam0, max_iter, exit_tol, True, grid, stream)
    pcg_dz_grid.launches += 1
    return out


def _pcg_dz_on(lib, ks, lam0, max_iter, exit_tol, stream):
    """K4 where it fits, K4g past it, through library lib."""
    if not one_block_fits(ks.gamma.shape[0], lib):
        return _pcg_dz_grid_on(lib, ks, lam0, max_iter, exit_tol, stream)
    out = _launch(lib, ks, lam0, max_iter, exit_tol, stream)
    pcg_dz.launches += 1
    return out


def pcg_dz(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    """Solve S lam = gamma warm-started at lam0 (N, nx) with K4 (K4g past
    the one-block fit); return (lam (N, nx), dX (N, nx), dU (N-1, nu),
    iters int32, hit_max bool).

    max_iter and exit_tol are host numbers."""
    if lam0.device.type == "cpu":
        return pcg_dz_reference(ks, lam0, max_iter, exit_tol)
    lib, stream = _on_card(lam0)
    return _pcg_dz_on(lib, ks, lam0, max_iter, exit_tol, stream)


pcg_dz.launches = 0


def pcg_dz_grid(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    """K4g: pcg_dz's solve and dz as the grid-wide kernel, at any N."""
    if lam0.device.type == "cpu":
        return pcg_dz_reference(ks, lam0, max_iter, exit_tol)
    lib, stream = _on_card(lam0)
    return _pcg_dz_grid_on(lib, ks, lam0, max_iter, exit_tol, stream)


pcg_dz_grid.launches = 0
