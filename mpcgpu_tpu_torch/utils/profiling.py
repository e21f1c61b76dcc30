"""Per-phase latency profiling (counterpart of
mpcgpu_tpu/utils/profiling.py).

The reference's tiered timers (settings.cuh:109-118: TIME_LINSYS around
the linear solve, FINE_GRAINED_TIMING around the KKT / Schur / dz /
line-search phases, pcg/sqp.cuh:207-352) read the host clock between
launches.  Here each phase is timed on its own at one operating point:
CUDA events on the card, the host clock on the CPU.
"""
from __future__ import annotations

from typing import Dict

import torch

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.sqp import (_phase_dz, _phase_kkt, _phase_line_search,
                                  _phase_linsys, _phase_schur, _timer)


def stage_latencies(model: RobotModel, cfg: SolverConfig, X, U, goals, xs,
                    rho: float = 1e-3, pcg_exit_tol: float = 1e-9,
                    reps: int = 30) -> Dict[str, float]:
    """Microseconds per solver phase at the given operating point (X, U,
    goals, xs on one device), lam = 0: sqp_solve_fine_grained's plain
    phases (kkt, schur, the linear solve by the plain CG,
    "pcg_while_loop_us", and by K4b on the card, "pcg_pallas_us", its
    plain version on the CPU; dz; the 8-candidate line search), each the
    mean of reps calls after one warm call, with the plain CG's iteration
    count."""
    lam = torch.zeros((cfg.knot_points, cfg.state_size), dtype=X.dtype,
                      device=X.device)
    kkt = _phase_kkt(model, cfg, X, U, goals, xs)
    sd = _phase_schur(cfg, kkt, rho)
    lam1, iters, _ = _phase_linsys(cfg, sd, lam, pcg_exit_tol)
    dX, dU = _phase_dz(kkt, sd, lam1)
    calls = {
        "kkt_us": lambda: _phase_kkt(model, cfg, X, U, goals, xs),
        "schur_us": lambda: _phase_schur(cfg, kkt, rho),
        "pcg_while_loop_us": lambda: _phase_linsys(cfg, sd, lam,
                                                   pcg_exit_tol),
        "pcg_pallas_us": lambda: _phase_linsys(cfg, sd, lam, pcg_exit_tol,
                                               "pcg_pallas"),
        "dz_us": lambda: _phase_dz(kkt, sd, lam1),
        "line_search_us": lambda: _phase_line_search(model, cfg, X, U, dX,
                                                     dU, goals, xs),
    }
    timed = _timer(X.device)
    out = {}
    for key, fn in calls.items():
        fn()
        out[key] = timed(lambda: [fn() for _ in range(reps)])[1] / reps
    out["pcg_iters"] = int(iters)
    return out
