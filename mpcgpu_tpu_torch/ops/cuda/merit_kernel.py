"""K2: merits of every line-search candidate plus the base point (csrc/merit.cu).

Counterpart of mpcgpu_tpu/ops/pallas/merit_kernel.py.  A CPU tensor runs
the plain version (``ops.merit.line_search_merits`` + ``ops.merit.merit``);
a CUDA tensor launches the kernel or raises.  Both take the solver's
knobs (``_lib.Knobs``: eepos or joint tracking, explicit or semi-implicit
Euler, the angle wrap; the Hessian plays no part in a merit).
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops import merit as merit_ops
from mpcgpu_tpu_torch.ops.cuda import _lib


def alphas_for(num_alphas: int, like: torch.Tensor) -> torch.Tensor:
    """alpha_i = 1/2^i, i < num_alphas."""
    return 0.5 ** torch.arange(num_alphas, dtype=like.dtype, device=like.device)


def line_search_merits_reference(model, X, U, dX, dU, num_alphas: int, goals,
                                 xs, dt, mu, qd_cost, r_cost,
                                 gravity: float = 0.0,
                                 knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    kw = dict(gravity=gravity, **knobs.merit_kw())
    cand = merit_ops.line_search_merits(
        model, X, U, dX, dU, alphas_for(num_alphas, X), goals, xs, dt, mu,
        qd_cost, r_cost, **kw)
    base = merit_ops.merit(model, X, U, goals, xs, dt, mu, qd_cost, r_cost,
                           **kw)
    return torch.cat([cand, base[None]])


# One launch count per (device, stream): the kernel's last block counts the
# blocks done on it and sets it back to zero, so launches on one stream
# (which run one after another) share it.
_done_counts: dict = {}


def _done_count(dev, stream) -> torch.Tensor:
    key = (str(dev), stream)
    if key not in _done_counts:
        _done_counts[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _done_counts[key]


def _launch(lib, tab, X, U, dX, dU, num_alphas: int, goals, xs, dt, mu,
            qd_cost, r_cost, gravity, stream, group: int = 0,
            knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    """One launch; group: the lanes of a pair's group (8, 16, 32; 0 the
    kernel's choice)."""
    dev = X.device
    _, nx, nu = _lib.sizes(tab, lib)
    if X.dim() != 2 or X.shape[1] != nx or X.shape[0] < 2:
        raise ValueError(f"X must be (N >= 2, {nx}), got {tuple(X.shape)}")
    n = X.shape[0]
    if n > 1024:
        raise ValueError(f"merit kernel serves N <= 1024 knots, got {n}")
    _lib.expect(X, "X", (n, nx), dev)
    _lib.expect(dX, "dX", (n, nx), dev)
    _lib.expect(U, "U", (n - 1, nu), dev)
    _lib.expect(dU, "dU", (n - 1, nu), dev)
    _lib.expect_goals(goals, n, nx, knobs)
    _lib.expect(goals, "goals", tuple(goals.shape), dev)
    _lib.expect(xs, "xs", (nx,), dev)
    _lib.expect(tab, "tables", (tab.numel(),), dev)
    if group not in (0, 8, 16, 32):
        raise ValueError(f"group must be 0, 8, 16 or 32, got {group}")
    out = torch.empty(num_alphas + 1, dtype=torch.float32, device=dev)
    contrib = torch.empty((num_alphas + 1) * n, dtype=torch.float32,
                          device=dev)
    rc = lib.mpc_merits(
        tab.data_ptr(), X.data_ptr(), U.data_ptr(), dX.data_ptr(), dU.data_ptr(),
        goals.data_ptr(), goals.shape[1], xs.data_ptr(), n, int(num_alphas),
        float(dt), float(mu), float(qd_cost), float(r_cost), float(gravity),
        contrib.data_ptr(), _done_count(dev, stream).data_ptr(), int(group),
        out.data_ptr(), *_lib.knob_args(knobs), stream)
    _lib.check(rc, "mpc_merits")
    return out


def line_search_merits(model, X, U, dX, dU, num_alphas: int, goals, xs, dt,
                       mu, qd_cost, r_cost, gravity: float = 0.0,
                       knobs: _lib.Knobs = _lib.DEFAULT_KNOBS):
    """(num_alphas + 1,): merits of (X + a dX, U + a dU) for a = 1/2^i,
    then the merit of (X, U), under the knobs (goals as form_kkt_schur's)."""
    if X.device.type == "cpu":
        return line_search_merits_reference(model, X, U, dX, dU, num_alphas,
                                            goals, xs, dt, mu, qd_cost,
                                            r_cost, gravity, knobs)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    out = _launch(_lib.library(model.num_joints), _lib.model_tables(model),
                  X, U, dX, dU,
                  num_alphas, goals, xs, dt, mu, qd_cost, r_cost, gravity,
                  _lib.stream_of(X), knobs=knobs)
    line_search_merits.launches += 1
    return out


line_search_merits.launches = 0
