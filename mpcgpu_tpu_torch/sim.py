"""Closed-loop MPC simulation (counterpart of mpcgpu_tpu/sim.py).

Each control update: an SQP solve, the plant integrated forward one
control period with the previous plan (simple_simulate,
integrator.cuh:296-325), the L1 end-effector tracking error, the horizon
shift with tail refill when the trajectory clock crosses a timestep
(mpcsim.cuh:343-387), and re-injection of the measured state x_0 <- xs
(mpcsim.cuh:394).

``simulate_mpc`` is the reference's real-time host loop: each update's
solve is timed on the host clock around a device sync, the plant can run
for exactly that time (``const_update_freq=False``), and the statistics
are read on the host every update into an ``MPCRecord``.
``simulate_mpc_scan`` is the device-resident loop at the constant
period: the shift schedule is computed on the host once, and no update
of a fixed backend reads a device value on the host, so the host only
enqueues work.

``linsys="auto"`` solves with "pcg" and latches over to "bcr_pcg" once
the EMAs of the rho-bail rate and of the tracking error both pass their
thresholds (SolverConfig.failover_*).  JAX picks the branch on the device
with lax.cond; eager PyTorch cannot branch on a device bool without
reading it, and running both branches to select one would double the
work.  So the port reads the latch on the host once per chunk of
``failover_check_every`` updates (once per update when the chunk does
not divide n_updates): the EMAs and the trip test run on the device
every update, and a trip inside a chunk switches the backend at the next
chunk boundary, as the JAX chunked latch does.  Each read waits for the
device to finish the chunk before the next one is enqueued.

Multi-arm: B arms track the same trajectory from their own starts
(``arm_starts``), sharing the shift schedule, the goals and the tail
refill, while xs, X, U, lam and rho evolve per arm (a leading arm axis).
``simulate_mpc_scan_packed`` solves all arms of an update in ONE launch
of the arm-packed whole-solve kernel (K10) and rolls the plants out in
one arm-batched K1 launch; ``simulate_mpc_scan_batched`` is the JAX
package's portable throughput mode, the plain modules over the arm axis.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional

import numpy as np
import torch

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models import dynamics as dyn
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops.btridiag import spmv
from mpcgpu_tpu_torch.ops.cuda._lib import knobs_of
from mpcgpu_tpu_torch.ops.cuda.rollout_kernel import plant_rollout
from mpcgpu_tpu_torch.ops.cuda.sqp_megakernel import (
    sqp_solve_mega_pcg_packed, sqp_solve_mega_pcg_packed_reference)
from mpcgpu_tpu_torch.ops.kkt import form_kkt
from mpcgpu_tpu_torch.ops.schur import form_schur
from mpcgpu_tpu_torch.sqp import (_sync, check_fused_config, sqp_solve,
                                  sqp_solve_fine_grained)


@dataclasses.dataclass
class MPCRecord:
    """Per-run statistics of simulate_mpc (the reference's .result dumps,
    mpcsim.cuh:59-138); the JAX package's fields and summary keys."""

    tracking_errors: List[float] = dataclasses.field(default_factory=list)
    tracking_path: List[np.ndarray] = dataclasses.field(default_factory=list)
    sqp_iters: List[int] = dataclasses.field(default_factory=list)
    sqp_times_us: List[float] = dataclasses.field(default_factory=list)
    sqp_exits: List[bool] = dataclasses.field(default_factory=list)
    pcg_iters: List[int] = dataclasses.field(default_factory=list)
    pcg_exits: List[bool] = dataclasses.field(default_factory=list)
    # per-update phase times in fine_grained_timing mode (the reference's
    # FINE_GRAINED_TIMING dumps, mpcsim.cuh:108-113)
    kkt_times_us: List[float] = dataclasses.field(default_factory=list)
    schur_times_us: List[float] = dataclasses.field(default_factory=list)
    linsys_times_us: List[float] = dataclasses.field(default_factory=list)
    dz_times_us: List[float] = dataclasses.field(default_factory=list)
    line_search_times_us: List[float] = dataclasses.field(default_factory=list)
    # per update with linsys="auto": True where the bcr_pcg failover
    # backend ran
    failed_over: List[bool] = dataclasses.field(default_factory=list)
    # per update with record_dual_residual: the backward-error dual
    # residual at the returned iterate (_dual_residual)
    dual_residuals: List[float] = dataclasses.field(default_factory=list)
    final_tracking_error: float = float("nan")
    control_updates: int = 0
    timesteps: int = 0

    def summary(self) -> dict:
        te = np.asarray(self.tracking_errors, np.float64)
        st = np.asarray(self.sqp_times_us, np.float64)
        pi = np.asarray(self.pcg_iters, np.float64)
        nan = float("nan")
        return {
            "avg_tracking_error": float(te.mean()) if te.size else nan,
            "max_tracking_error": float(te.max()) if te.size else nan,
            "final_tracking_error": self.final_tracking_error,
            "avg_sqp_time_us": float(st.mean()) if st.size else nan,
            "p50_sqp_time_us": float(np.median(st)) if st.size else nan,
            "p95_sqp_time_us": (float(np.percentile(st, 95)) if st.size
                                else nan),
            "avg_pcg_iters": float(pi.mean()) if pi.size else nan,
            "pcg_max_exit_rate": (
                float(np.mean(self.pcg_exits)) if self.pcg_exits
                else float("nan")),
            "control_updates": self.control_updates,
            "timesteps": self.timesteps,
            **({"dual_residual_p50": float(np.median(self.dual_residuals)),
                "dual_residual_p90": float(np.percentile(
                    self.dual_residuals, 90)),
                "dual_residual_max": float(np.max(self.dual_residuals))}
               if self.dual_residuals else {}),
        }


def _plant_rollout(model: RobotModel, cfg: SolverConfig, x, U_prev,
                   offset_us, sim_time_us, max_substeps: int):
    """Integrate the measured plant for sim_time_us microseconds: fixed
    sim_step_time explicit-Euler substeps with the control active at the
    simulation clock in the previous plan (zero-dt substeps past the end
    of the period), then the fmod remainder substep.  x (..., nx) and
    U_prev (..., N-1, nu): leading dimensions (an arm axis) batch."""
    f32 = dict(dtype=x.dtype, device=x.device)
    sub = torch.tensor(cfg.sim_step_time, **f32)
    t0 = torch.as_tensor(offset_us, **f32) * 1e-6
    total = torch.as_tensor(sim_time_us, **f32) * 1e-6
    n_steps = torch.floor(total / sub).to(torch.int32)
    n_ctrl = U_prev.shape[-2]
    nq = x.shape[-1] // 2

    def control(t):
        idx = torch.clamp((t / cfg.timestep).to(torch.int64), 0, n_ctrl - 1)
        return U_prev.index_select(-2, idx.view(1)).squeeze(-2)

    def dxdt(x, u):
        qdd = dyn.forward_dynamics(model, x[..., :nq], x[..., nq:], u,
                                   cfg.gravity)
        return torch.cat([x[..., nq:], qdd], dim=-1)

    for s in range(max_substeps):
        active = (s < n_steps).to(x.dtype)
        x = x + active * sub * dxdt(x, control(t0 + s * sub))

    rem = torch.fmod(total, sub)
    t_last = t0 + torch.clamp(n_steps - 1, min=0).to(x.dtype) * sub
    return x + rem * dxdt(x, control(t_last))


def _tracking_error(model: RobotModel, xs, goal0):
    nq = xs.shape[-1] // 2
    return (dyn.ee_pos(model, xs[..., :nq])[..., :3]
            - goal0[:3]).abs().sum(-1)


def _rollout_and_error(model: RobotModel, cfg: SolverConfig, xs, U_prev,
                       goals, offset_us, sim_time_us, max_substeps: int):
    """Plant rollout + tracking-error probe: the K1 kernel under
    fused_stages, the plain PyTorch version otherwise."""
    if cfg.fused_stages:
        return plant_rollout(model, cfg, xs, U_prev, goals[0], offset_us,
                             sim_time_us, max_substeps)
    xs = _plant_rollout(model, cfg, xs, U_prev, offset_us, sim_time_us,
                        max_substeps)
    return xs, _tracking_error(model, xs, goals[0])


def _shift_horizon(X, U, goals, lam, xu_traj, ee_traj, traj_offset: int,
                   traj_steps: int | None = None):
    """One horizon shift with tail refill (mpcsim.cuh:343-387).

    traj_offset is the already incremented trajectory index (a host int).
    Within the trajectory the tail is refilled from the reference's source
    index (nx+nu)*traj_offset - nu, i.e. [u_{off-1}, x_{off}]
    (mpcsim.cuh:362); past it, with the goal pose at zero velocity and
    zero control (mpcsim.cuh:364-369).

    X, U and lam may carry leading arm dimensions; goals (N, 6) are
    shared by the arms."""
    n, nx = X.shape[-2:]
    if traj_steps is None:
        traj_steps = xu_traj.shape[0]
    within = traj_offset + n < traj_steps
    if within:
        src = min(max(traj_offset, 1), traj_steps - 1)
        x_fill = xu_traj[src, :nx]
        u_fill = xu_traj[src - 1, nx:]
    else:
        x_goal = xu_traj[traj_steps - 1, :nx]
        x_fill = torch.cat([x_goal[:nx // 2], torch.zeros_like(x_goal[nx // 2:])])
        u_fill = torch.zeros_like(xu_traj[0, nx:])
    X = torch.cat([X[..., 1:, :], x_fill.expand(X[..., :1, :].shape)], dim=-2)
    U = torch.cat([U[..., 1:, :], u_fill.expand(U[..., :1, :].shape)], dim=-2)
    gsrc = min(max(traj_offset + n - 1, 0), traj_steps - 1)
    goals = torch.cat([goals[1:], ee_traj[gsrc][None]])
    # last entry duplicated (mpcsim.cuh:383)
    lam = torch.cat([lam[..., 1:, :], lam[..., -1:, :]], dim=-2)
    return X, U, goals, lam


def make_shift_schedule(cfg: SolverConfig, n_updates: int):
    """The constant-period shift pattern of the reference's host clock
    (mpcsim.cuh:340-393): (do_shift bool (n_updates,), traj_offset int32
    (n_updates,)) with the already incremented trajectory index."""
    do_shift = np.zeros(n_updates, bool)
    offsets = np.zeros(n_updates, np.int32)
    t_since, shifted, off = 0.0, False, 0
    thresh = cfg.shift_threshold_fraction * cfg.timestep
    for i in range(n_updates):
        step = cfg.simulation_period_us * 1e-6
        if not shifted and t_since + step > thresh:
            off += 1
            do_shift[i] = True
            shifted = True
        t_since += step
        if t_since > cfg.timestep:
            shifted = False
            t_since = float(np.fmod(t_since, cfg.timestep))
        offsets[i] = off
    return do_shift, offsets


def max_substeps_for(cfg: SolverConfig) -> int:
    return max(1, int(np.ceil(cfg.simulation_period_us * 1e-6
                              / cfg.sim_step_time)) + 1)


def _update_events(X, n_updates: int):
    """n_updates + 1 CUDA events, the first one recorded (timing=True)."""
    if X.device.type != "cuda":
        raise ValueError("timing=True measures with CUDA events and needs "
                         "the solver on a CUDA device")
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(n_updates + 1)]
    events[0].record()
    return events


def _update_ms(events) -> list:
    """Each update's time between consecutive events, read once."""
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def _dual_residual(model: RobotModel, cfg: SolverConfig, X, U, lam, goals,
                   xs, rho):
    """Backward-error dual residual at the returned iterate,
    ``||gamma - S lam|| / (||S||_F ||lam|| + ||gamma||)`` with (S, gamma)
    formed again at (X, U, rho) without the preconditioner: how well the
    carried duals satisfy the new linearization, the warm start the next
    solve inherits.  The counterweight to the CG's cap-exit rate (the
    reference warns past 50%, mpcsim.cuh:436-441).  A diagnostic outside
    the timed region: the plain modules on the tensors' device, a 0-d
    tensor."""
    cc = cfg.cost
    kkt = form_kkt(model, X, U, goals, xs, cfg.timestep, cc.qd_cost,
                   cc.r_cost, cfg.integrator_type, cfg.gravity, cc.hessian,
                   cfg.angle_wrap, cc.tracking, cc.q_cost)
    sch = form_schur(kkt, rho, preconditioned=False)
    r = sch.gamma - spmv(sch.S, lam)
    s_f = torch.sqrt((sch.S.lower ** 2).sum() + (sch.S.diag ** 2).sum()
                     + (sch.S.upper ** 2).sum())
    denom = s_f * torch.linalg.norm(lam) + torch.linalg.norm(sch.gamma)
    return torch.linalg.norm(r) / torch.clamp(denom, min=1e-30)


def _mpc_update(model: RobotModel, cfg: SolverConfig, xs, X, U, goals, lam,
                U_prev, xu_traj, ee_traj, traj_offset: int, offset_us: float,
                sim_time_us: float, do_shift: bool, max_substeps: int):
    """Everything between two solves of the host loop: the plant rollout
    and tracking-error probe (K1 under fused_stages), the horizon shift
    when do_shift (a host bool), and the measured-state re-injection."""
    xs, err = _rollout_and_error(model, cfg, xs, U_prev, goals, offset_us,
                                 sim_time_us, max_substeps)
    if do_shift:
        X, U, goals, lam = _shift_horizon(X, U, goals, lam, xu_traj, ee_traj,
                                          traj_offset)
    X = torch.cat([xs[None], X[1:]])  # measured-state re-injection
    return xs, X, U, goals, lam, err


def simulate_mpc(
    model: RobotModel,
    cfg: SolverConfig,
    xu_traj: np.ndarray,
    ee_traj: np.ndarray,
    *,
    pcg_exit_tol: float,
    linsys: str = "pcg",
    max_control_updates: int = 100000,
    max_timesteps: Optional[int] = None,
    warmup_iters: int = 100,
    const_update_freq: bool = True,
    fine_grained_timing: bool = False,
    record_dual_residual: bool = False,
    verbose: bool = False,
) -> MPCRecord:
    """Track a recorded trajectory with the SQP solver in the loop, one
    control update after another from the host: the reference's
    simulateMPC (mpcsim.cuh:170-498).  Runs on the model's device.

    Each update times the solve on the host clock (the module's
    time.perf_counter) around a device sync, so the time is the wall time
    the controller took, launches included.  const_update_freq=False runs
    the plant for exactly that time (the reference's real-time mode); the
    rollout integrates at most max_substeps_for(cfg) substeps (11 x 0.2 ms
    at the 2 ms period) plus the remainder, as the JAX package and K1 do.
    True runs it for cfg.simulation_period_us.

    Warm-up (REMOVE_JITTERS, mpcsim.cuh:259-279): warmup_iters solves at
    tol 1e-11 with a CG cap of 10000, the iterate reset each time while
    lam and rho carry, then rho reset and one solve of the measured
    configuration, whose result is dropped.

    linsys="auto" solves with "pcg" until the EMAs of the rho-bail rate
    and of the tracking error both pass their thresholds, then with
    "bcr_pcg"; the latch is read on the host every update.
    fine_grained_timing runs sqp_solve_fine_grained and records each
    phase's time per update; record_dual_residual adds _dual_residual
    after each solve, outside the timed region.
    """
    dev = model.Xc.device
    n = cfg.knot_points
    nx = cfg.state_size
    traj_steps = xu_traj.shape[0] if max_timesteps is None else min(
        xu_traj.shape[0], max_timesteps)
    dt = getattr(torch, cfg.dtype)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                  device=dev)

    xu_t, ee_t = t(xu_traj), t(ee_traj)
    X, U, goals = t(xu_traj[:n, :nx]), t(xu_traj[:n - 1, nx:]), t(ee_traj[:n])
    xs = X[0]
    lam = torch.zeros((n, nx), dtype=dt, device=dev)
    rho = torch.tensor(cfg.rho_init, dtype=dt, device=dev)

    auto = linsys == "auto"
    cur_linsys = "pcg" if auto else linsys
    bail_ema, err_ema, failed = 0.0, 0.0, False

    if warmup_iters > 0:
        warm_cfg = dataclasses.replace(
            cfg, pcg=dataclasses.replace(cfg.pcg, max_iter=10000))
        for _ in range(warmup_iters):
            res = sqp_solve(model, warm_cfg, X, U, lam, goals, xs, rho,
                            1e-11, cur_linsys)
            lam, rho = res.lam, res.rho   # the iterate stays at the start
        rho = torch.tensor(cfg.rho_init, dtype=dt, device=dev)
        # the measured configuration's kernels, warmed before the first
        # timed update
        sqp_solve(model, cfg, X, U, lam, goals, xs, rho, pcg_exit_tol,
                  cur_linsys)
        if fine_grained_timing:
            sqp_solve_fine_grained(model, cfg, X, U, lam, goals, xs, rho,
                                   pcg_exit_tol, cur_linsys)
        _sync(dev)

    max_substeps = max_substeps_for(cfg)
    rec = MPCRecord()
    rec.tracking_path.append(xs.cpu().numpy())

    time_since_timestep = 0.0
    shifted = False
    traj_offset = 0
    prev_sim_time = 0.0
    U_prev = U  # the previous plan's controls (xu_old)

    for update in range(max_control_updates):
        if traj_offset >= traj_steps:
            break

        t0 = time.perf_counter()
        if fine_grained_timing:
            res, phase_times = sqp_solve_fine_grained(
                model, cfg, X, U, lam, goals, xs, rho, pcg_exit_tol,
                cur_linsys)
        else:
            res = sqp_solve(model, cfg, X, U, lam, goals, xs, rho,
                            pcg_exit_tol, cur_linsys)
        _sync(dev)
        solve_us = (time.perf_counter() - t0) * 1e6
        if fine_grained_timing:
            rec.kkt_times_us.append(sum(phase_times["kkt"]))
            rec.schur_times_us.append(sum(phase_times["schur"]))
            rec.linsys_times_us.append(sum(phase_times["linsys"]))
            rec.dz_times_us.append(sum(phase_times["dz"]))
            rec.line_search_times_us.append(sum(phase_times["line_search"]))
        X, U, lam, rho = res.X, res.U, res.lam, res.rho
        if record_dual_residual:
            # at the returned iterate, with the goals and xs the solve saw
            rec.dual_residuals.append(float(_dual_residual(
                model, cfg, X, U, lam, goals, xs, rho)))

        sim_time = cfg.simulation_period_us if const_update_freq else solve_us

        do_shift = not shifted and (
            time_since_timestep + sim_time * 1e-6
            > cfg.shift_threshold_fraction * cfg.timestep)
        time_since_timestep += sim_time * 1e-6
        if do_shift:
            traj_offset += 1
            shifted = True
        if time_since_timestep > cfg.timestep:
            shifted = False
            time_since_timestep = float(np.fmod(time_since_timestep,
                                                cfg.timestep))

        U_post_solve = U  # xu_old is taken before the shift (mpcsim.cuh:337)
        xs, X, U, goals, lam, err = _mpc_update(
            model, cfg, xs, X, U, goals, lam, U_prev, xu_t, ee_t, traj_offset,
            prev_sim_time, sim_time, do_shift, max_substeps)
        U_prev = U_post_solve
        err = float(err)
        if do_shift:
            rec.tracking_errors.append(err)
        prev_sim_time = sim_time

        st = res.stats
        iters = st.pcg_iters.cpu().numpy()
        ran = iters >= 0
        rec.pcg_iters.extend(int(i) for i in iters[ran])
        rec.pcg_exits.extend(
            bool(b) for b in st.pcg_hit_max.cpu().numpy()[ran])
        rec.sqp_iters.append(int(st.sqp_iters))
        rec.sqp_times_us.append(solve_us)
        bailed = bool(st.rho_bailed)
        rec.sqp_exits.append(bailed)
        rec.tracking_path.append(xs.cpu().numpy())
        if auto:
            rec.failed_over.append(failed)
            if not failed:
                d = cfg.failover_ema_decay
                bail_ema = d * bail_ema + (1.0 - d) * float(bailed)
                err_ema = d * err_ema + (1.0 - d) * err
                if (bail_ema > cfg.failover_bail_rate
                        and err_ema > cfg.failover_err_threshold_m):
                    failed = True
                    cur_linsys = "bcr_pcg"
                    if verbose:
                        print(f"update {update}: rho-bail EMA "
                              f"{bail_ema:.3f} > {cfg.failover_bail_rate} "
                              f"and err EMA {err_ema:.3f} > "
                              f"{cfg.failover_err_threshold_m} "
                              f"-- failing over to bcr_pcg")

        if verbose and update % 200 == 0:
            last = rec.tracking_errors[-1] if rec.tracking_errors else float(
                "nan")
            print(f"update {update}: traj_offset {traj_offset}/{traj_steps} "
                  f"solve {solve_us:.0f}us sqp_iters {rec.sqp_iters[-1]} "
                  f"err {last:.4f}")

    rec.final_tracking_error = float(_tracking_error(model, xs, goals[0]))
    rec.control_updates = len(rec.sqp_times_us)
    rec.timesteps = traj_offset

    # the CG cap-exit self-diagnostic (reference mpcsim.cuh:436-441)
    if rec.pcg_exits:
        exit_rate = float(np.mean(rec.pcg_exits))
        if exit_rate > 0.5:
            print(f"WARNING: PCG hit its max-iteration cap in "
                  f"{100.0 * exit_rate:.1f}% of solves "
                  f"(exit tol {pcg_exit_tol:g}, max_iter {cfg.pcg.max_iter}); "
                  f"results may be unreliable")
    return rec


def simulate_mpc_scan(model: RobotModel, cfg: SolverConfig, xu_traj, ee_traj,
                      X, U, lam, rho, pcg_exit_tol: float, n_updates: int,
                      linsys: str = "pcg", timing: bool = False) -> dict:
    """Closed-loop tracking for n_updates control updates (constant update
    period), with per-update statistics stacked in the result.

    xu_traj (T, nx+nu) and ee_traj (T, 6) are tensors on the solver's
    device.  linsys="auto" runs the failover latch (module doc) and adds
    "failed_over" (n_updates,) bool, True where "bcr_pcg" ran.
    timing=True (CUDA only) also returns "update_ms": each update's time
    from CUDA events, read once after the loop.

    X, U, lam and rho may carry a leading arm axis for the plain modules
    with linsys="pcg" (simulate_mpc_scan_batched); the per-update
    statistics then have the arm axis last.
    """
    if X.dim() > 2 and linsys != "pcg":
        raise ValueError("an arm axis runs linsys='pcg' only")
    n = cfg.knot_points
    do_shift, offsets = make_shift_schedule(cfg, n_updates)
    goals = ee_traj[:n].contiguous()
    xs = X[..., 0, :]
    U_prev = U
    period = cfg.simulation_period_us
    max_substeps = max_substeps_for(cfg)
    if timing:
        events = _update_events(X, n_updates)

    auto = linsys == "auto"
    if auto:
        chunk = cfg.failover_check_every
        if chunk <= 1 or n_updates % chunk:
            chunk = 1
        zero = torch.zeros((), dtype=X.dtype, device=X.device)
        ema, err_ema = zero, zero
        tripped = torch.zeros((), dtype=torch.bool, device=X.device)
        failed = False

    outs = {k: [] for k in ("tracking_errors", "sqp_iters", "pcg_iters_total",
                            "pcg_hit_max_total", "rho_bailed",
                            "tracking_path")}
    failed_over = []
    for i in range(n_updates):
        backend = linsys
        if auto:
            if i and i % chunk == 0 and not failed:
                failed = bool(tripped)  # the latch read: once per chunk
            backend = "bcr_pcg" if failed else "pcg"
            failed_over.append(failed)
        res = sqp_solve(model, cfg, X, U, lam, goals, xs, rho, pcg_exit_tol,
                        backend)
        X, U, lam, rho = res.X, res.U, res.lam, res.rho

        offset_us = 0.0 if i == 0 else period
        xs, err = _rollout_and_error(model, cfg, xs, U_prev, goals, offset_us,
                                     period, max_substeps)
        U_prev = U  # pre-shift plan snapshot (mpcsim.cuh:337)
        if do_shift[i]:
            X, U, goals, lam = _shift_horizon(X, U, goals, lam, xu_traj,
                                              ee_traj, int(offsets[i]))
        # measured-state re-injection
        X = torch.cat([xs[..., None, :], X[..., 1:, :]], dim=-2)

        st = res.stats
        if auto:
            d = cfg.failover_ema_decay
            ema = d * ema + (1.0 - d) * st.rho_bailed.to(ema.dtype)
            err_ema = d * err_ema + (1.0 - d) * err.to(err_ema.dtype)
            tripped = tripped | ((ema > cfg.failover_bail_rate)
                                 & (err_ema > cfg.failover_err_threshold_m))
        outs["tracking_errors"].append(err)
        outs["sqp_iters"].append(st.sqp_iters)
        outs["pcg_iters_total"].append(
            torch.where(st.pcg_iters >= 0, st.pcg_iters, 0).sum(0))
        outs["pcg_hit_max_total"].append(st.pcg_hit_max.sum(0))
        outs["rho_bailed"].append(st.rho_bailed)
        outs["tracking_path"].append(xs)
        if timing:
            events[i + 1].record()

    result = {k: torch.stack(v) for k, v in outs.items()}
    result["shifted"] = torch.as_tensor(do_shift)
    result["final_xs"] = xs
    if auto:
        result["failed_over"] = torch.as_tensor(failed_over)
    if timing:
        result["update_ms"] = _update_ms(events)
    return result


def arm_starts(X, U, lam, dq):
    """The starts of B arms: X (N, nx), U (N-1, nu) and lam (N, nx) given
    a leading arm axis, each arm's joint positions at knot 0 moved by its
    row of dq (B, nq).  The JAX package draws dq = 0.02 *
    jax.random.normal(PRNGKey(seed), (B, nq)) inside its multi-arm loops;
    here the caller makes it (torch.Generator, numpy), since the two
    generators give different numbers from one seed."""
    b, nq = dq.shape
    Xb = X.expand((b,) + X.shape).clone()
    Xb[:, 0, :nq] += dq.to(X)
    return (Xb, U.expand((b,) + U.shape).contiguous(),
            lam.expand((b,) + lam.shape).contiguous())


def simulate_mpc_scan_batched(model: RobotModel, cfg: SolverConfig, xu_traj,
                              ee_traj, X, U, lam, rho, pcg_exit_tol: float,
                              n_updates: int, linsys: str = "pcg",
                              timing: bool = False) -> dict:
    """The JAX package's portable throughput mode: B independent arms
    (X (B, N, nx), U (B, N-1, nu), lam (B, N, nx) from arm_starts; rho a
    number or (B,)), each as jax.vmap of the single-arm loop runs it.

    It runs the plain PyTorch modules on the tensors' device, fused_stages
    off, as the JAX function turns pallas_stages off: that is the JAX
    mode's semantics (per-arm rho, per-arm CG exits, and with
    linsys="auto" a latch per arm), not a fallback, and no kernel runs
    here.  linsys="pcg" runs the arms together over an arm axis; every
    other linsys runs the single-arm loop once per arm.  Returns the
    single-arm loop's dict with a leading arm axis: (B, n_updates)
    statistics (and "failed_over" for "auto"), tracking_path (B,
    n_updates, nx), final_xs (B, nx), shifted (B, n_updates); timing=True
    adds "update_ms" as simulate_mpc_scan does (per update, the sum over
    the arms' loops where they run one after another).
    """
    if cfg.fused_stages:
        cfg = dataclasses.replace(cfg, fused_stages=False)
    b = X.shape[0]
    rho = torch.as_tensor(rho, dtype=X.dtype, device=X.device).expand(b)
    if linsys != "pcg":
        outs = [simulate_mpc_scan(model, cfg, xu_traj, ee_traj, X[a], U[a],
                                  lam[a], rho[a], pcg_exit_tol, n_updates,
                                  linsys, timing) for a in range(b)]
        out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]
               if k != "update_ms"}
        if timing:
            out["update_ms"] = [sum(ms) for ms in
                                zip(*(o["update_ms"] for o in outs))]
        return out
    out = simulate_mpc_scan(model, cfg, xu_traj, ee_traj, X, U, lam, rho,
                            pcg_exit_tol, n_updates, linsys, timing)
    for k in ("tracking_errors", "sqp_iters", "pcg_iters_total",
              "pcg_hit_max_total", "rho_bailed"):
        out[k] = out[k].T
    out["tracking_path"] = out["tracking_path"].transpose(0, 1)
    out["shifted"] = out["shifted"].expand(b, n_updates)
    return out


def simulate_mpc_scan_packed(model: RobotModel, cfg: SolverConfig, xu_traj,
                             ee_traj, X, U, lam, rho, pcg_exit_tol: float,
                             n_updates: int, timing: bool = False) -> dict:
    """Real-time multi-arm: B arms (X (B, N, nx), U (B, N-1, nu), lam (B,
    N, nx) from arm_starts; rho a number or (B,)) solved together by the
    arm-packed whole-solve kernel, one launch per control update, and
    rolled out by one arm-batched K1 launch.

    With cfg.fused_stages the solve and the rollout go through the kernel
    wrappers (a CUDA tensor launches K10 and K1 or raises; a CPU tensor
    runs their plain versions), and the configuration must be one the
    kernels serve (check_fused_config); without, the plain versions run on
    the tensors' device.  Both take the configuration's integrator,
    Hessian, angle wrap and tracking (joint tracking: the goals are
    ee_traj's rows, the joint reference), as the JAX packed loop does.
    Each solve runs cfg.sqp_max_iter iterations with drho reset to 1, per-arm rho
    carried across updates, and the CG's shared exit of the JAX packed
    kernel.  Returns tracking_errors,
    sqp_iters and rho_bailed (B, n_updates), pcg_iters_total (n_updates,)
    (the shared CG count summed over each solve's live iterations),
    tracking_path (B, n_updates, nx), final_xs (B, nx), shifted
    (n_updates,), and with timing=True "update_ms".
    """
    if cfg.fused_stages:
        check_fused_config(cfg, "pcg")
    b, n = X.shape[0], cfg.knot_points
    do_shift, offsets = make_shift_schedule(cfg, n_updates)
    goals = ee_traj[:n].contiguous()
    xs = X[:, 0].contiguous()
    rho = torch.as_tensor(rho, dtype=X.dtype, device=X.device).expand(b)
    drho = torch.ones_like(rho)
    U_prev = U
    period = cfg.simulation_period_us
    max_substeps = max_substeps_for(cfg)
    cc = cfg.cost
    solve = functools.partial(
        sqp_solve_mega_pcg_packed if cfg.fused_stages
        else sqp_solve_mega_pcg_packed_reference, knobs=knobs_of(cfg))
    if timing:
        events = _update_events(X, n_updates)

    outs = {k: [] for k in ("tracking_errors", "sqp_iters", "pcg_iters_total",
                            "rho_bailed", "tracking_path")}
    for i in range(n_updates):
        res = solve(model, X, U, goals.expand((b,) + goals.shape), xs, lam,
                    rho, drho, cfg.pcg.max_iter, pcg_exit_tol,
                    cfg.sqp_max_iter, cfg.timestep, cc.qd_cost, cc.r_cost,
                    cfg.gravity, cfg.merit_mu, cfg.num_alphas,
                    cfg.rho_factor, cfg.rho_min, cfg.rho_max, cfg.rho_reset)
        X, U, lam, rho = res.X, res.U, res.lam, res.rho

        offset_us = 0.0 if i == 0 else period
        xs, err = _rollout_and_error(model, cfg, xs, U_prev, goals, offset_us,
                                     period, max_substeps)
        U_prev = U
        if do_shift[i]:
            X, U, goals, lam = _shift_horizon(X, U, goals, lam, xu_traj,
                                              ee_traj, int(offsets[i]))
        X = torch.cat([xs[:, None], X[:, 1:]], dim=1)

        outs["tracking_errors"].append(err)
        outs["sqp_iters"].append(res.sqp_iters)
        outs["pcg_iters_total"].append(res.pcg_iters_total)
        outs["rho_bailed"].append(res.bailed)
        outs["tracking_path"].append(xs)
        if timing:
            events[i + 1].record()

    result = {k: torch.stack(v, dim=0 if k == "pcg_iters_total" else 1)
              for k, v in outs.items()}
    result["shifted"] = torch.as_tensor(do_shift)
    result["final_xs"] = xs
    if timing:
        result["update_ms"] = _update_ms(events)
    return result
