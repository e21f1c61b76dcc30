"""K4: warm-started stair-preconditioned CG + primal step (csrc/pcg_dz.cu).

Counterpart of mpcgpu_tpu/ops/pallas/pcg_kernel.py (pcg_dz_pallas_lanes).
A CPU tensor runs the plain version (``ops.pcg.pcg`` +
``ops.dz.compute_dz``); a CUDA tensor launches the kernel or raises.

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
    """Raise unless the kernel's S bands and CG vectors fit one block's
    shared memory at this horizon on the current device; return the
    largest horizon that fits."""
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
