"""Closed-loop MPC simulation (counterpart of mpcgpu_tpu/sim.py).

Each control update: an SQP solve, the plant integrated forward one
control period with the previous plan (simple_simulate,
integrator.cuh:296-325), the L1 end-effector tracking error, the horizon
shift with tail refill when the trajectory clock crosses a timestep
(mpcsim.cuh:343-387), and re-injection of the measured state x_0 <- xs
(mpcsim.cuh:394).

``simulate_mpc_scan`` is the device-resident loop: the shift schedule is
computed on the host once, and no update of a fixed backend reads a
device value on the host, so the host only enqueues work.

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

import numpy as np
import torch

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models import dynamics as dyn
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.ops.cuda.rollout_kernel import plant_rollout
from mpcgpu_tpu_torch.ops.cuda.sqp_megakernel import (
    sqp_solve_mega_pcg_packed, sqp_solve_mega_pcg_packed_reference)
from mpcgpu_tpu_torch.sqp import check_fused_config, sqp_solve


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
    the tensors' device, with the configuration's integrator, Hessian,
    angle wrap and tracking (joint tracking: the goals are ee_traj's rows,
    the joint reference), as the JAX packed loop runs them.  Each solve
    runs cfg.sqp_max_iter iterations with drho reset to 1, per-arm rho
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
    if cfg.fused_stages:
        solve = sqp_solve_mega_pcg_packed
    else:
        solve = functools.partial(
            sqp_solve_mega_pcg_packed_reference,
            integrator_type=cfg.integrator_type, hessian=cc.hessian,
            angle_wrap=cfg.angle_wrap, tracking=cc.tracking,
            q_cost=cc.q_cost)
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
