"""Block cyclic reduction kernels (csrc/bcr_pcg_dz.cu, csrc/bcr_dz.cu):

* K6 ``bcr_pcg_dz``: warm-started CG preconditioned by an exact BCR
  solve, then the primal step (bcr_pcg_dz_pallas_lanes), across one
  thread-block cluster;
* K7 ``bcr_dz``: the exact BCR solve with one refinement pass, then the
  primal step -- the fused "bcr" backend (bcr_dz_pallas_lanes) -- across
  one cluster;
* K7s ``bcr_solve``: one unrefined BCR solve (bcr_solve_pallas_lanes),
  across one cluster.

Counterparts of mpcgpu_tpu/ops/pallas/bcr_kernel.py.  A CPU tensor runs
the plain version (``ops.btsolve`` + ``ops.dz.compute_dz``); a CUDA
tensor launches the kernel or raises.  The system needs no stair
preconditioner (K3 with ``precond=False``); the kernels read S, gamma and
the dz blocks only.  Each factors the cyclic reduction once per launch
(csrc/bcr_common.cuh): K7's refinement applies the same factor again.

Each is one cluster of 16 (else 8) blocks whose shared memory holds S's
bands, so they serve power-of-2 N up to the largest that fits
(``check_bcr_fit``, ``check_bcr_dz_fit``, ``check_bcr_solve_fit``: 1024
on the H100).  Past K7's or K6's fit, or when ``split=True`` forces it,
they take the split path of the JAX package
(bcr_kernel.py:234-264,308-317): K7 becomes K7s, the residual as tensor
glue, K7s again, then the primal step; K6 becomes the CG as tensor glue
(``ops.btsolve.bcr_pcg``: a fixed max_iter steps, those after the exit
masked) with K7s as each preconditioner apply.  On the TPU that split
works around VMEM; here it serves N past the clusters' fit.
``bcr_pcg_dz.cluster_size``, ``bcr_dz.cluster_size`` and
``bcr_solve.cluster_size`` hold, after each K6, K7 or K7s launch, the
cluster size the kernel read (a device int32).
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv
from mpcgpu_tpu_torch.ops.btsolve import bcr_pcg, bcr_solve as _plain_bcr
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import (KnotSchur,
                                                        compute_dz_knots,
                                                        expect_system)

_FIELDS = ("SL", "SD", "SU", "gamma", "A", "B", "q", "r", "Qinv", "Rinv")
_DZ_FIELDS = ("A", "B", "q", "r", "Qinv", "Rinv")


def _zero_stats(dev):
    return (torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


def _bands(ks: KnotSchur) -> BlockTri:
    return BlockTri(ks.SL, ks.SD, ks.SU)


def _check_pow2(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"the BCR kernels need a power-of-2 horizon, got "
                         f"N = {n}")


def _check_fit(n: int, n_max: int, what: str) -> int:
    _check_pow2(n)
    if n > n_max:
        raise ValueError(f"{what} serves N <= {n_max} on this device; got "
                         f"N = {n}")
    return n_max


def check_bcr_fit(knot_points: int, lib=None) -> int:
    """Raise unless N is a power of 2 whose S bands, CG vectors and
    inverse scratch fit the shared memory of one cluster of 16 (else 8)
    blocks on the current device (K6); return the largest N that fits."""
    return _check_fit(knot_points, (lib or _lib.library()).mpc_bcr_max_knots(),
                      "the cluster BCR-PCG kernel holds S in one cluster's "
                      "shared memory and")


def check_bcr_dz_fit(knot_points: int, lib=None) -> int:
    """The same for K7 (one cluster: S's bands, the refined solve's and
    dz's vectors and the inverse scratch)."""
    return _check_fit(knot_points,
                      (lib or _lib.library()).mpc_bcr_dz_max_knots(),
                      "the cluster refined BCR kernel holds S in one "
                      "cluster's shared memory and")


def check_bcr_solve_fit(knot_points: int, lib=None) -> int:
    """The same for K7s (one cluster: S's bands, the apply's vectors and
    the inverse scratch)."""
    return _check_fit(knot_points,
                      (lib or _lib.library()).mpc_bcr_solve_max_knots(),
                      "the cluster BCR solve kernel holds S in one "
                      "cluster's shared memory and")


def _split(n: int, split, n_max_of) -> bool:
    """The split path's choice: forced by split, else taken above the
    kernel's fit."""
    return n > n_max_of() if split is None else bool(split)


def _cuda_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


# ---- K7s: one unrefined solve

def bcr_solve_reference(SL, SD, SU, gamma):
    return _plain_bcr(BlockTri(SL, SD, SU), gamma, refine=0)


_INTS: dict = {}


def _ints(dev, kid: str):
    """The int output of K7 or K7s (kid) on dev (the cluster size the
    kernel read), one buffer a kernel and device that every launch reuses,
    and its view."""
    got = _INTS.get((kid, dev))
    if got is None:
        ints = torch.zeros(1, dtype=torch.int32, device=dev)
        got = _INTS[(kid, dev)] = (ints, ints[0])
    return got


def _launch_solve(lib, SL, SD, SU, gamma, stream, scratch=None,
                  cluster: int = 0):
    """One K7s launch; its factors go to scratch when given (as K6's);
    cluster asks for a cluster size (8 or 16; 0 the kernel's choice,
    mpc_bcr_solve_cluster; the host build runs that many blocks under its
    block emulation)."""
    dev = gamma.device
    nx = 2 * _lib.NJ
    if gamma.dim() != 2 or gamma.shape[1] != nx:
        raise ValueError(f"gamma must be (N, {nx}), got {tuple(gamma.shape)}")
    n = gamma.shape[0]
    for name, t in (("SL", SL), ("SD", SD), ("SU", SU)):
        _lib.expect(t, name, (n, nx, nx), dev)
    _lib.expect(gamma, "gamma", (n, nx), dev)
    check_bcr_solve_fit(n, lib)
    f32 = dict(dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = torch.empty(lib.mpc_bcr_scratch_floats(n), **f32)
    _lib.expect(scratch, "scratch", (lib.mpc_bcr_scratch_floats(n),), dev)
    lam = torch.empty((n, nx), **f32)
    ints, read = _ints(dev, "K7s")
    rc = lib.mpc_bcr_solve(n, SL.data_ptr(), SD.data_ptr(), SU.data_ptr(),
                           gamma.data_ptr(), scratch.data_ptr(),
                           lam.data_ptr(), ints.data_ptr(), int(cluster),
                           stream)
    _lib.check(rc, "mpc_bcr_solve")
    bcr_solve.cluster_size = read
    return lam


def bcr_solve(SL, SD, SU, gamma):
    """K7s: lam (N, nx) = BCR(gamma), unrefined, from the bands (N, nx,
    nx) of S; N a power of 2."""
    if gamma.device.type == "cpu":
        return bcr_solve_reference(SL, SD, SU, gamma)
    _cuda_device(gamma)
    out = _launch_solve(_lib.library(), SL, SD, SU, gamma,
                        _lib.stream_of(gamma))
    bcr_solve.launches += 1
    return out


bcr_solve.launches = 0
bcr_solve.cluster_size = None


def _solver_of(ks: KnotSchur):
    return lambda rhs: bcr_solve(ks.SL, ks.SD, ks.SU, rhs)


# ---- K7: the refined solve and dz

def bcr_dz_reference(ks: KnotSchur):
    lam = _plain_bcr(_bands(ks), ks.gamma, refine=1)
    dX, dU = compute_dz_knots(ks, lam)
    return (lam, dX, dU, *_zero_stats(lam.device))


def bcr_dz_split(ks: KnotSchur, solve):
    """The split path: solve(rhs) -> lam twice, the residual between as
    tensor glue, then the primal step."""
    lam = solve(ks.gamma)
    lam = lam + solve(ks.gamma - spmv(_bands(ks), lam))
    dX, dU = compute_dz_knots(ks, lam)
    return (lam, dX, dU, *_zero_stats(lam.device))


def _launch_dz(lib, ks: KnotSchur, stream, scratch=None, cluster: int = 0):
    """One K7 launch; its factors go to scratch when given (as K6's);
    cluster asks for a cluster size as _launch_solve's (mpc_bcr_dz_cluster
    the kernel's choice)."""
    dev = ks.gamma.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    n = expect_system(ks, ks.gamma, _FIELDS, dev)
    check_bcr_dz_fit(n, lib)
    f32 = dict(dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = torch.empty(lib.mpc_bcr_scratch_floats(n), **f32)
    _lib.expect(scratch, "scratch", (lib.mpc_bcr_scratch_floats(n),), dev)
    lam = torch.empty((n, nx), **f32)
    dX = torch.empty((n, nx), **f32)
    dU = torch.empty((n - 1, nu), **f32)
    ints, read = _ints(dev, "K7")
    rc = lib.mpc_bcr_dz(
        n, *(getattr(ks, f).data_ptr() for f in _FIELDS), scratch.data_ptr(),
        lam.data_ptr(), dX.data_ptr(), dU.data_ptr(), ints.data_ptr(),
        int(cluster), stream)
    _lib.check(rc, "mpc_bcr_dz")
    bcr_dz.cluster_size = read
    return (lam, dX, dU, *_zero_stats(dev))


def _bcr_dz_on(lib, ks: KnotSchur, split, stream):
    """K7 where it fits, the split path past its fit (or as split forces),
    through library lib."""
    n = ks.gamma.shape[0]
    _check_pow2(n)
    if _split(n, split, lib.mpc_bcr_dz_max_knots):
        return bcr_dz_split(ks, _solver_of(ks))
    out = _launch_dz(lib, ks, stream)
    bcr_dz.launches += 1
    return out


def bcr_dz(ks: KnotSchur, split=None):
    """Solve S lam = gamma exactly (one refinement pass); return (lam (N,
    nx), dX (N, nx), dU (N-1, nu), iters 0, hit_max False), the "bcr"
    backend's counts.  split: None takes the split path above K7's fit,
    True / False force it (module doc)."""
    if ks.gamma.device.type == "cpu":
        return bcr_dz_reference(ks)
    _cuda_device(ks.gamma)
    return _bcr_dz_on(_lib.library(), ks, split, _lib.stream_of(ks.gamma))


bcr_dz.launches = 0
bcr_dz.cluster_size = None


# ---- K6: the BCR-preconditioned CG and dz

def bcr_pcg_dz_reference(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    lam, iters, hit = bcr_pcg(_bands(ks), ks.gamma, lam0, max_iter, exit_tol)
    dX, dU = compute_dz_knots(ks, lam)
    return lam, dX, dU, iters, hit


def bcr_pcg_dz_split(ks: KnotSchur, lam0, max_iter: int, exit_tol, solve):
    """The split path: the CG as tensor glue with solve(r) -> z as each
    preconditioner apply, then the primal step."""
    lam, iters, hit = bcr_pcg(_bands(ks), ks.gamma, lam0, max_iter, exit_tol,
                              precond=solve)
    dX, dU = compute_dz_knots(ks, lam)
    return lam, dX, dU, iters, hit


def _launch(lib, ks: KnotSchur, lam0, max_iter: int, exit_tol, stream,
            scratch=None, cluster: int = 0):
    """One K6 launch; its factors go to scratch (mpc_bcr_scratch_floats(N)
    floats) when given, else to a scratch of its own; cluster asks for a
    cluster size (8 or 16; 0 the kernel's choice, mpc_bcr_cluster)."""
    dev = ks.gamma.device
    nx, nu = 2 * _lib.NJ, _lib.NJ
    n = expect_system(ks, lam0, _FIELDS, dev)
    check_bcr_fit(n, lib)
    f32 = dict(dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = torch.empty(lib.mpc_bcr_scratch_floats(n), **f32)
    _lib.expect(scratch, "scratch", (lib.mpc_bcr_scratch_floats(n),), dev)
    lam = torch.empty((n, nx), **f32)
    dX = torch.empty((n, nx), **f32)
    dU = torch.empty((n - 1, nu), **f32)
    ints = torch.empty(2, dtype=torch.int32, device=dev)
    hit = torch.empty((), dtype=torch.bool, device=dev)
    rc = lib.mpc_bcr_pcg_dz(
        n, *(getattr(ks, f).data_ptr() for f in ("SL", "SD", "SU", "gamma")),
        lam0.data_ptr(), *(getattr(ks, f).data_ptr() for f in _DZ_FIELDS),
        int(max_iter), float(exit_tol), scratch.data_ptr(), lam.data_ptr(),
        dX.data_ptr(), dU.data_ptr(), ints.data_ptr(), hit.data_ptr(),
        int(cluster), stream)
    _lib.check(rc, "mpc_bcr_pcg_dz")
    bcr_pcg_dz.cluster_size = ints[1]
    return lam, dX, dU, ints[0], hit


def _bcr_pcg_dz_on(lib, ks, lam0, max_iter, exit_tol, split, stream):
    """K6 where it fits, the split path past its fit (or as split forces),
    through library lib."""
    n = ks.gamma.shape[0]
    _check_pow2(n)
    if _split(n, split, lib.mpc_bcr_max_knots):
        return bcr_pcg_dz_split(ks, lam0, max_iter, exit_tol, _solver_of(ks))
    out = _launch(lib, ks, lam0, max_iter, exit_tol, stream)
    bcr_pcg_dz.launches += 1
    return out


def bcr_pcg_dz(ks: KnotSchur, lam0, max_iter: int, exit_tol, split=None):
    """Solve S lam = gamma warm-started at lam0 (N, nx) with the BCR
    preconditioner; return (lam (N, nx), dX (N, nx), dU (N-1, nu),
    iters int32, hit_max bool).  max_iter and exit_tol are host numbers.
    split: None launches K6 where it fits and takes the split path above
    its fit; True forces the split path, False K6."""
    if lam0.device.type == "cpu":
        return bcr_pcg_dz_reference(ks, lam0, max_iter, exit_tol)
    _cuda_device(lam0)
    return _bcr_pcg_dz_on(_lib.library(), ks, lam0, max_iter, exit_tol,
                          split, _lib.stream_of(lam0))


bcr_pcg_dz.launches = 0
bcr_pcg_dz.cluster_size = None
