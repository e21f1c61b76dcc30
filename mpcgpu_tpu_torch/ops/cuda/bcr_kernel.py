"""K6: warm-started CG preconditioned by an exact block cyclic reduction
solve, then the primal step (csrc/bcr_pcg_dz.cu).

Counterpart of mpcgpu_tpu/ops/pallas/bcr_kernel.py (bcr_pcg_dz_pallas_lanes).
A CPU tensor runs the plain version (``ops.btsolve.bcr_pcg`` +
``ops.dz.compute_dz``); a CUDA tensor launches the kernel or raises.  The
system needs no stair preconditioner (K3 with ``precond=False``); the
kernel reads S, gamma and the dz blocks only.

The kernel factors the cyclic reduction once per solve and keeps S in one
block's shared memory, so it serves power-of-2 N up to the largest that
fits (``check_bcr_fit``).  The JAX package's N > 256 split path is a VMEM
workaround and has no counterpart here.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.btsolve import bcr_pcg
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import (KnotSchur,
                                                        compute_dz_knots,
                                                        expect_system)

_FIELDS = ("SL", "SD", "SU", "gamma", "A", "B", "q", "r", "Qinv", "Rinv")


def bcr_pcg_dz_reference(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    lam, iters, hit = bcr_pcg(BlockTri(ks.SL, ks.SD, ks.SU), ks.gamma, lam0,
                              max_iter, exit_tol)
    dX, dU = compute_dz_knots(ks, lam)
    return lam, dX, dU, iters, hit


def check_bcr_fit(knot_points: int, lib=None) -> int:
    """Raise unless N is a power of 2 whose S bands, CG vectors and
    inverse scratch fit one block's shared memory on the current device;
    return the largest N that fits."""
    n = knot_points
    if n < 1 or n & (n - 1):
        raise ValueError(f"the BCR kernel needs a power-of-2 horizon, got "
                         f"N = {n}")
    n_max = (lib or _lib.library()).mpc_bcr_max_knots()
    if n > n_max:
        raise ValueError(
            f"the one-block BCR-PCG kernel holds S in shared memory and "
            f"serves N <= {n_max} on this device; got N = {n}")
    return n_max


def _launch(lib, ks: KnotSchur, lam0, max_iter: int, exit_tol, stream):
    dev = ks.gamma.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    n = expect_system(ks, lam0, _FIELDS, dev)
    check_bcr_fit(n, lib)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.mpc_bcr_scratch_floats(n), **f32)
    lam = torch.empty((n, nx), **f32)
    dX = torch.empty((n, nx), **f32)
    dU = torch.empty((n - 1, nu), **f32)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    hit = torch.empty((), dtype=torch.bool, device=dev)
    rc = lib.mpc_bcr_pcg_dz(
        n, *(getattr(ks, f).data_ptr() for f in ("SL", "SD", "SU", "gamma")),
        lam0.data_ptr(),
        *(getattr(ks, f).data_ptr() for f in ("A", "B", "q", "r", "Qinv",
                                             "Rinv")),
        int(max_iter), float(exit_tol), scratch.data_ptr(), lam.data_ptr(),
        dX.data_ptr(), dU.data_ptr(), iters.data_ptr(), hit.data_ptr(),
        stream)
    _lib.check(rc, "mpc_bcr_pcg_dz")
    return lam, dX, dU, iters, hit


def bcr_pcg_dz(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    """Solve S lam = gamma warm-started at lam0 (N, nx) with the BCR
    preconditioner; return (lam (N, nx), dX (N, nx), dU (N-1, nu),
    iters int32, hit_max bool).  max_iter and exit_tol are host numbers."""
    if lam0.device.type == "cpu":
        return bcr_pcg_dz_reference(ks, lam0, max_iter, exit_tol)
    if lam0.device.type != "cuda":
        raise ValueError(f"unsupported device {lam0.device}")
    out = _launch(_lib.library(), ks, lam0, max_iter, exit_tol,
                  _lib.stream_of(lam0))
    bcr_pcg_dz.launches += 1
    return out


bcr_pcg_dz.launches = 0
