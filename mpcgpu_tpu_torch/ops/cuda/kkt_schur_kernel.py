"""K3: KKT linearization + Schur condensation + stair preconditioner
(csrc/kkt_schur.cu).

Counterpart of mpcgpu_tpu/ops/pallas/kkt_schur_kernel.py, in the
knot-major layout: bands (N, nx, nx) as in ops/btridiag.BlockTri.  A CPU
tensor runs the plain version (``ops.kkt.form_kkt`` +
``ops.schur.form_schur``); a CUDA tensor launches the kernel or raises.
Both take the solver's knobs (``_lib.Knobs``: eepos or joint tracking,
the reference or Gauss-Newton Hessian, explicit or semi-implicit Euler,
the angle wrap), as the TPU kernel does.

It replaces both TPU forms of that module: ``form_kkt_schur_pallas``
(N <= 128) and ``form_kkt_schur_tiled`` (K8: the same ``LaneSchur`` over
128-knot tiles for N % 128 == 0, three pallas_calls for the per-knot
stage, theta^-1 and the stair bands).  The tile exists only to get round
a Mosaic layout limit; the CUDA kernel's three launches of one block per
knot have no tile and no N limit, so one kernel serves every horizon
(checked up to N = 1024).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.dz import compute_dz
from mpcgpu_tpu_torch.ops.kkt import KKTData, form_kkt
from mpcgpu_tpu_torch.ops.schur import SchurData, form_schur


class KnotSchur(NamedTuple):
    """The Schur system and the blocks primal recovery needs, knot-major.

    A, B, Rinv and r have a row for every knot; the last one (no control)
    is zero."""

    SL: torch.Tensor     # (N, nx, nx) lower band (row k, column k-1)
    SD: torch.Tensor     # diagonal band
    SU: torch.Tensor     # upper band
    PL: torch.Tensor     # stair preconditioner bands
    PD: torch.Tensor
    PU: torch.Tensor
    gamma: torch.Tensor  # (N, nx)
    Qinv: torch.Tensor   # (N, nx, nx)
    Rinv: torch.Tensor   # (N, nu, nu)
    A: torch.Tensor      # (N, nx, nx)
    B: torch.Tensor      # (N, nx, nu)
    q: torch.Tensor      # (N, nx) cost gradient
    r: torch.Tensor      # (N, nu) control gradient


def compute_dz_knots(ks: KnotSchur, lam):
    """The primal step (ops.dz.compute_dz) from a KnotSchur system and the
    dual solution lam (N, nx): (dX (N, nx), dU (N-1, nu))."""
    kkt = KKTData(Q=None, q=ks.q, R=None, r=ks.r[:-1], A=ks.A[:-1],
                  B=ks.B[:-1], c=None)
    sd = SchurData(S=BlockTri(ks.SL, ks.SD, ks.SU),
                   Pinv=BlockTri(ks.PL, ks.PD, ks.PU), gamma=ks.gamma,
                   Qinv=ks.Qinv, Rinv=ks.Rinv[:-1])
    return compute_dz(kkt, sd, lam)


def expect_system(ks: KnotSchur, lam0, fields, device) -> int:
    """Raise unless lam0 and the named KnotSchur fields are contiguous
    float32 knot-major tensors on device; return N."""
    if ks.gamma.dim() != 2:
        raise ValueError(f"gamma must be (N, nx), got "
                         f"{tuple(ks.gamma.shape)}")
    n, nx = ks.gamma.shape
    nu = _lib.width_joints(nx)
    shapes = dict(SL=(n, nx, nx), SD=(n, nx, nx), SU=(n, nx, nx),
                  PL=(n, nx, nx), PD=(n, nx, nx), PU=(n, nx, nx),
                  gamma=(n, nx), Qinv=(n, nx, nx), Rinv=(n, nu, nu),
                  A=(n, nx, nx), B=(n, nx, nu), q=(n, nx), r=(n, nu))
    for name in fields:
        _lib.expect(getattr(ks, name), name, shapes[name], device)
    _lib.expect(lam0, "lam0", (n, nx), device)
    return n


def _pad_last(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, torch.zeros_like(t[:1])], dim=0)


def form_kkt_schur_reference(model, X, U, goals, xs, rho, dt, qd_cost, r_cost,
                             gravity: float = 0.0, precond: bool = True,
                             knobs: _lib.Knobs = _lib.DEFAULT_KNOBS
                             ) -> KnotSchur:
    kkt = form_kkt(model, X, U, goals, xs, dt, qd_cost, r_cost,
                   gravity=gravity, **knobs.kkt_kw())
    sd = form_schur(kkt, rho, preconditioned=precond)
    return KnotSchur(
        SL=sd.S.lower, SD=sd.S.diag, SU=sd.S.upper,
        PL=sd.Pinv.lower, PD=sd.Pinv.diag, PU=sd.Pinv.upper,
        gamma=sd.gamma, Qinv=sd.Qinv, Rinv=_pad_last(sd.Rinv),
        A=_pad_last(kkt.A), B=_pad_last(kkt.B), q=kkt.q, r=_pad_last(kkt.r))


def _launch(lib, tab, X, U, goals, rho, dt, qd_cost, r_cost, gravity,
            precond: bool, stream,
            knobs: _lib.Knobs = _lib.DEFAULT_KNOBS) -> KnotSchur:
    dev = X.device
    _, nx, nu = _lib.sizes(tab, lib)
    if X.dim() != 2 or X.shape[1] != nx or X.shape[0] < 2:
        raise ValueError(f"X must be (N >= 2, {nx}), got {tuple(X.shape)}")
    n = X.shape[0]
    _lib.expect(X, "X", (n, nx), dev)
    _lib.expect(U, "U", (n - 1, nu), dev)
    _lib.expect_goals(goals, n, nx, knobs)
    _lib.expect(goals, "goals", tuple(goals.shape), dev)
    _lib.expect(rho, "rho", (), dev)
    _lib.expect(tab, "tables", (tab.numel(),), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    band = lambda: torch.empty((n, nx, nx), **f32)
    out = KnotSchur(
        SL=band(), SD=band(), SU=band(), PL=band(), PD=band(), PU=band(),
        gamma=torch.empty((n, nx), **f32), Qinv=band(),
        Rinv=torch.empty((n, nu, nu), **f32), A=band(),
        B=torch.empty((n, nx, nu), **f32), q=torch.empty((n, nx), **f32),
        r=torch.empty((n, nu), **f32))
    scratch = (band(), band(), torch.empty((n, nx), **f32),
               torch.empty((n, nx), **f32), torch.empty((n, nx), **f32))
    rc = lib.mpc_kkt_schur(
        tab.data_ptr(), n, X.data_ptr(), U.data_ptr(), goals.data_ptr(),
        goals.shape[1], rho.data_ptr(), float(dt), float(qd_cost),
        float(r_cost), float(gravity), int(bool(precond)),
        *(t.data_ptr() for t in out), *(t.data_ptr() for t in scratch),
        *_lib.knob_args(knobs), stream)
    _lib.check(rc, "mpc_kkt_schur")
    return out


def form_kkt_schur(model, X, U, goals, xs, rho, dt, qd_cost, r_cost,
                   gravity: float = 0.0, precond: bool = True,
                   knobs: _lib.Knobs = _lib.DEFAULT_KNOBS) -> KnotSchur:
    """Linearize at (X (N, nx), U (N-1, nu)) and condense under the
    knobs; goals (N, >=3) for eepos tracking, (N, nx) joint states for
    joint tracking.  rho is a 0-d tensor on X's device (or a number); xs
    is unused by the kernel, since c_0 is left out of gamma as in the
    reference."""
    if X.device.type == "cpu":
        return form_kkt_schur_reference(model, X, U, goals, xs, rho, dt,
                                        qd_cost, r_cost, gravity, precond,
                                        knobs)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    rho = torch.as_tensor(rho, dtype=torch.float32, device=X.device)
    out = _launch(_lib.library(model.num_joints), _lib.model_tables(model),
                  X, U, goals, rho,
                  dt, qd_cost, r_cost, gravity, precond, _lib.stream_of(X),
                  knobs)
    form_kkt_schur.launches += 1
    return out


form_kkt_schur.launches = 0
