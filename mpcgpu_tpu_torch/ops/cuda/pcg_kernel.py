"""K4: warm-started stair-preconditioned CG + primal step, and K4b: the
same CG without the primal step; K4g and K4bg: both in the joined form
(csrc/pcg_dz.cu).

Counterparts of mpcgpu_tpu/ops/pallas/pcg_kernel.py (pcg_dz_pallas_lanes;
pcg_pallas_lanes and pcg_pallas, the "pcg_pallas" backend's solve).  A CPU
tensor runs the plain version (``ops.pcg.pcg``, + ``ops.dz.compute_dz``
for K4); a CUDA tensor launches a kernel or raises.

The kernels are K5's dual solve as a launch of their own, in two forms.
The cluster form (K4, K4b) runs the CG across one thread-block cluster,
each block holding its knots' S bands (and the stair's where they fit)
in shared memory; the joined form (K4g, K4bg) runs one CG across G such
clusters of a cooperative launch, joined by tagged words in global
memory.  ``pcg_plan`` chooses the form, the cluster size C, G and where
the CG's area lies from N and the device alone: the cluster form while a
block of it owns at most 24 knots, the joined form past that (the cut
measured on the H100, PERF.md).  ``pcg_dz`` and ``pcg_solve`` launch the
plan's form; ``pcg_dz_grid`` and ``pcg_solve_grid`` the joined form at
any N.  Each raises where the plan finds no launch the card holds, before
any launch.  After a launch the wrapper's ``cluster_size`` holds the
cluster size the kernel read (a device int32).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import (KnotSchur,
                                                        compute_dz_knots,
                                                        expect_system)
from mpcgpu_tpu_torch.ops.pcg import pcg

_SOLVE_FIELDS = ("SL", "SD", "SU", "PL", "PD", "PU", "gamma")
_DZ_FIELDS = ("A", "B", "q", "r", "Qinv", "Rinv")

# the forms of csrc/pcg_dz.cu (its Form)
CLUSTER, JOINED = 1, 2


def pcg_dz_reference(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    res = pcg(BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU),
              ks.gamma, lam0, max_iter, exit_tol)
    dX, dU = compute_dz_knots(ks, res.lam)
    return res.lam, dX, dU, res.iters, res.hit_max


def pcg_solve_reference(S: BlockTri, Pinv: BlockTri, gamma, lam0,
                        max_iter: int, exit_tol):
    res = pcg(S, Pinv, gamma, lam0, max_iter, exit_tol)
    return res.lam, res.iters, res.hit_max


class PcgPlan(NamedTuple):
    form: int      # CLUSTER (K4, K4b) or JOINED (K4g, K4bg); 0 none
    cluster: int   # C, blocks a cluster
    clusters: int  # G, clusters in the CG (1 in the cluster form)
    place: int     # the CG's area: 3 S's and the stair's bands and the
                   # vectors on chip, 2 S's bands and the vectors, 1 the
                   # vectors, 0 none (in L2)
    grid: int      # C x G blocks


_plans: dict = {}


def pcg_plan(knot_points: int, lib=None, dz: bool = True, form: int = 0,
             cluster: int = 0, place: int = -1) -> PcgPlan:
    """The launch of K4 (dz) or K4b at this horizon (mpc_pcg_plan, from the
    occupancy API; a function of N and the device alone): form 0 the
    plan's choice, CLUSTER or JOINED that form; cluster 0 the plan's size,
    else that power of 2; place -1 the plan's, else that placement.  form
    is 0 where no such launch fits.  The host build plans one block unless
    a size is asked (its block emulation runs them), the joined form then
    on N / C clusters."""
    lib = lib or _lib.library()
    dev = torch.cuda.current_device() if torch.cuda.is_available() else -1
    key = (id(lib), knot_points, bool(dz), form, cluster, place, dev)
    if key not in _plans:
        out = (ctypes.c_int * 5)()
        lib.mpc_pcg_plan(knot_points, int(bool(dz)), form, cluster, place,
                         out)
        _plans[key] = PcgPlan(*out)
    return _plans[key]


def _checked_plan(knot_points: int, lib, dz: bool, form: int) -> PcgPlan:
    plan = pcg_plan(knot_points, lib, dz, form)
    if plan.form == 0:
        what = {0: "either form", CLUSTER: "the cluster form",
                JOINED: "the joined form"}[form]
        raise ValueError(
            f"the stair-PCG kernel cannot make a cooperative launch of "
            f"N = {knot_points} in {what} on this device: no cluster of it "
            f"can be resident")
    return plan


def _launch(lib, ks: KnotSchur, lam0, max_iter: int, exit_tol, stream,
            plan: PcgPlan, dz: bool = True):
    """One K4 (dz) or K4b launch in the plan's form, C, G and place; for
    K4b only S, P and gamma of ks are read, and (lam, iters, hit) is
    returned, else (lam, dX, dU, iters, hit)."""
    dev = ks.gamma.device
    n = expect_system(ks, lam0, _SOLVE_FIELDS + (_DZ_FIELDS if dz else ()),
                      dev)
    nx = ks.gamma.shape[1]
    nu = _lib.width_joints(nx, lib)
    f32 = dict(dtype=torch.float32, device=dev)
    lam = torch.empty((n, nx), **f32)
    ints = torch.empty(2, dtype=torch.int32, device=dev)
    hit = torch.empty((), dtype=torch.bool, device=dev)
    scratch = torch.empty(max(1, lib.mpc_pcg_scratch_floats(
        plan.form, n, plan.cluster, plan.clusters, plan.place)), **f32)
    if dz:
        dX = torch.empty((n, nx), **f32)
        dU = torch.empty((n - 1, nu), **f32)
        dz_in = [getattr(ks, f).data_ptr() for f in _DZ_FIELDS]
        dz_out = [dX.data_ptr(), dU.data_ptr()]
    else:
        dz_in, dz_out = [None] * len(_DZ_FIELDS), [None, None]
    rc = lib.mpc_pcg(
        int(dz), n, *(getattr(ks, f).data_ptr() for f in _SOLVE_FIELDS),
        lam0.data_ptr(), *dz_in, int(max_iter), float(exit_tol),
        lam.data_ptr(), *dz_out, ints.data_ptr(), hit.data_ptr(),
        scratch.data_ptr(), plan.form, plan.cluster, plan.clusters,
        plan.place, stream)
    _lib.check(rc, "mpc_pcg")
    _wrapper(dz, plan.form).cluster_size = ints[1]
    iters = ints[0]
    return (lam, dX, dU, iters, hit) if dz else (lam, iters, hit)


def _wrapper(dz: bool, form: int):
    if form == JOINED:
        return pcg_dz_grid if dz else pcg_solve_grid
    return pcg_dz if dz else pcg_solve


def _solve_system(S: BlockTri, Pinv: BlockTri, gamma) -> KnotSchur:
    """S, Pinv and gamma as the KnotSchur fields K4b reads."""
    return KnotSchur(*S, *Pinv, gamma, *(None,) * 6)


def _pcg_on(lib, ks, lam0, max_iter, exit_tol, stream, dz: bool,
            form: int = 0):
    """One launch of the plan's form (form 0) or of `form` through library
    lib; counts it under its own kernel."""
    plan = _checked_plan(ks.gamma.shape[0], lib, dz, form)
    out = _launch(lib, ks, lam0, max_iter, exit_tol, stream, plan, dz)
    _wrapper(dz, plan.form).launches += 1
    return out


def _pcg_dz_on(lib, ks, lam0, max_iter, exit_tol, stream, form: int = 0):
    """K4 (K4g past the cut, or where form asks)."""
    return _pcg_on(lib, ks, lam0, max_iter, exit_tol, stream, True, form)


def _pcg_solve_on(lib, S, Pinv, gamma, lam0, max_iter, exit_tol, stream,
                  form: int = 0):
    """K4b (K4bg past the cut, or where form asks)."""
    return _pcg_on(lib, _solve_system(S, Pinv, gamma), lam0, max_iter,
                   exit_tol, stream, False, form)


_K4B = "K4b (pcg_solve, the 'pcg_pallas' backend's CG)"


def _on_card(lam0, iiwa_only: str = ""):
    """The library of lam0's joint count and its stream; raise unless the
    count is the IIWA's where the kernel iiwa_only (a name) serves only
    it."""
    if lam0.device.type != "cuda":
        raise ValueError(f"unsupported device {lam0.device}")
    nj = _lib.width_joints(lam0.shape[-1])
    if iiwa_only:
        _lib.require_iiwa(nj, iiwa_only)
    return _lib.library(nj), _lib.stream_of(lam0)


def pcg_solve(S: BlockTri, Pinv: BlockTri, gamma, lam0, max_iter: int,
              exit_tol):
    """K4b (K4bg past the plan's cut): solve S lam = gamma (bands (N, nx,
    nx), gamma (N, nx)) with the stair preconditioner Pinv, warm-started
    at lam0; return (lam (N, nx), iters int32, hit_max bool).  max_iter and
    exit_tol are host numbers."""
    if lam0.device.type == "cpu":
        return pcg_solve_reference(S, Pinv, gamma, lam0, max_iter, exit_tol)
    lib, stream = _on_card(lam0, _K4B)
    return _pcg_solve_on(lib, S, Pinv, gamma, lam0, max_iter, exit_tol,
                         stream)


pcg_solve.launches = 0


def pcg_solve_grid(S: BlockTri, Pinv: BlockTri, gamma, lam0, max_iter: int,
                   exit_tol):
    """K4bg: pcg_solve's CG in the joined form, at any N."""
    if lam0.device.type == "cpu":
        return pcg_solve_reference(S, Pinv, gamma, lam0, max_iter, exit_tol)
    lib, stream = _on_card(lam0, "K4bg (pcg_solve_grid)")
    return _pcg_solve_on(lib, S, Pinv, gamma, lam0, max_iter, exit_tol,
                         stream, JOINED)


pcg_solve_grid.launches = 0


def pcg_dz(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    """Solve S lam = gamma warm-started at lam0 (N, nx) with K4 (K4g past
    the plan's cut); return (lam (N, nx), dX (N, nx), dU (N-1, nu), iters
    int32, hit_max bool).

    max_iter and exit_tol are host numbers."""
    if lam0.device.type == "cpu":
        return pcg_dz_reference(ks, lam0, max_iter, exit_tol)
    lib, stream = _on_card(lam0)
    return _pcg_dz_on(lib, ks, lam0, max_iter, exit_tol, stream)


pcg_dz.launches = 0


def pcg_dz_grid(ks: KnotSchur, lam0, max_iter: int, exit_tol):
    """K4g: pcg_dz's solve and dz in the joined form, at any N."""
    if lam0.device.type == "cpu":
        return pcg_dz_reference(ks, lam0, max_iter, exit_tol)
    lib, stream = _on_card(lam0)
    return _pcg_dz_on(lib, ks, lam0, max_iter, exit_tol, stream, JOINED)


pcg_dz_grid.launches = 0
