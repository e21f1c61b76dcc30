"""K4: warm-started stair-preconditioned CG + primal step, and K4b: the
same CG without the primal step (csrc/pcg_dz.cu).

Counterparts of mpcgpu_tpu/ops/pallas/pcg_kernel.py (pcg_dz_pallas_lanes;
pcg_pallas_lanes and pcg_pallas, the "pcg_pallas" backend's solve).  A CPU
tensor runs the plain version (``ops.pcg.pcg``, + ``ops.dz.compute_dz``
for K4); a CUDA tensor launches the kernel or raises.

The kernel runs the whole solve in one thread block with S in shared
memory, so the horizon is bounded by one block's shared memory
(``check_pcg_smem_fit``, the counterpart of the reference's
``checkPcgOccupancy`` and of the TPU's ``check_pcg_vmem_fit``).
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import (KnotSchur,
                                                        compute_dz_knots,
                                                        expect_system)
from mpcgpu_tpu_torch.ops.pcg import pcg


def pcg_dz_reference(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    res = pcg(BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU),
              ks.gamma, lam0, max_iter, exit_tol)
    dX, dU = compute_dz_knots(ks, res.lam)
    return res.lam, dX, dU, res.iters, res.hit_max


def check_pcg_smem_fit(knot_points: int) -> int:
    """Raise unless the S bands and CG vectors of K4 and K4b fit one
    block's shared memory at this horizon on the current device; return
    the largest horizon that fits."""
    n_max = _lib.library().mpc_pcg_max_knots()
    if knot_points > n_max:
        raise ValueError(
            f"the one-block PCG kernel holds S in shared memory and serves "
            f"N <= {n_max} on this device; got N = {knot_points}")
    return n_max


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


def pcg_solve(S: BlockTri, Pinv: BlockTri, gamma, lam0, max_iter: int,
              exit_tol):
    """K4b: solve S lam = gamma (bands (N, nx, nx), gamma (N, nx)) with the
    stair preconditioner Pinv, warm-started at lam0; return (lam (N, nx),
    iters int32, hit_max bool).  max_iter and exit_tol are host numbers."""
    if lam0.device.type == "cpu":
        return pcg_solve_reference(S, Pinv, gamma, lam0, max_iter, exit_tol)
    if lam0.device.type != "cuda":
        raise ValueError(f"unsupported device {lam0.device}")
    check_pcg_smem_fit(gamma.shape[0])
    out = _launch_solve(_lib.library(), S, Pinv, gamma, lam0, max_iter,
                        exit_tol, _lib.stream_of(lam0))
    pcg_solve.launches += 1
    return out


pcg_solve.launches = 0


def pcg_dz(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    """Solve S lam = gamma warm-started at lam0 (N, nx); return
    (lam (N, nx), dX (N, nx), dU (N-1, nu), iters int32, hit_max bool).

    max_iter and exit_tol are host numbers."""
    if lam0.device.type == "cpu":
        return pcg_dz_reference(ks, lam0, max_iter, exit_tol)
    if lam0.device.type != "cuda":
        raise ValueError(f"unsupported device {lam0.device}")
    check_pcg_smem_fit(ks.gamma.shape[0])
    out = _launch(_lib.library(), ks, lam0, max_iter, exit_tol,
                  _lib.stream_of(lam0))
    pcg_dz.launches += 1
    return out


pcg_dz.launches = 0
