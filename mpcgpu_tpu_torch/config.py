"""Typed runtime configuration (counterpart of mpcgpu_tpu/config.py).

Fields keep the JAX package's names and defaults.  ``fused_stages``
selects the hand-written CUDA stage kernels (the counterpart of
``pallas_stages``); off, every stage runs the plain PyTorch modules on
whatever device the tensors live on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """Tracking-cost weights (reference include/common/settings.cuh:90-100)."""

    qd_cost: float = 1e-4
    r_cost: float = 1e-4   # reference uses 1e-3 when KNOT_POINTS == 64
    hessian: str = "reference"  # or "gauss_newton" (see ops/cost.py)
    tracking: str = "eepos"     # or "joint"
    q_cost: float = 1.0

    @staticmethod
    def for_knots(knot_points: int) -> "CostConfig":
        return CostConfig(r_cost=1e-3 if knot_points == 64 else 1e-4)


@dataclasses.dataclass(frozen=True)
class PCGConfig:
    """PCG solver knobs (reference struct pcg_config, include/mpcsim.cuh:250-253)."""

    max_iter: int = 173
    exit_tol: float = 1e-5          # threshold on eta = r' Pinv r
    preconditioned: bool = True     # ENABLE_PRECONDITIONING ablation flag

    @staticmethod
    def tuned_max_iter(knot_points: int) -> int:
        # reference settings.cuh:135-156 (empirical per-N caps)
        return {32: 173, 64: 167, 128: 167, 256: 118, 512: 67}.get(knot_points, 200)

    @staticmethod
    def tpu_tuned_max_iter(knot_points: int) -> int:
        """Per-N caps chosen for tracking quality in the JAX package's
        closed-loop sweeps (at N=64 cap 40 tracks fixture 0_0 about 7x
        closer than near-exact duals).  The name is kept for parity."""
        return {32: 40, 64: 40, 128: 24, 256: 24, 512: 16, 1024: 16}.get(
            knot_points, 40)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Full SQP/MPC configuration (reference include/common/settings.cuh)."""

    knot_points: int = 64
    state_size: int = 14
    control_size: int = 7
    timestep: float = 0.015625          # 1/64 s
    integrator_type: int = 0            # 0: Euler, 1: semi-implicit Euler
    angle_wrap: bool = False
    dtype: str = "float32"

    sqp_max_iter: int = 40
    merit_mu: float = 10.0
    num_alphas: int = 8                 # alpha_i = 1/2^i

    rho_init: float = 1e-3
    rho_min: float = 1e-3
    rho_factor: float = 1.2
    rho_max: float = 10.0
    rho_reset: float = 1e-3

    pcg: PCGConfig = dataclasses.field(default_factory=PCGConfig)
    cost: CostConfig = dataclasses.field(default_factory=CostConfig)

    simulation_period_us: float = 2000.0  # 500 Hz control
    sim_step_time: float = 2e-4
    shift_threshold_fraction: float = 1.0

    gravity: float = 0.0

    # Run the SQP stages (K3 KKT+Schur; K4 PCG+dz, K6 BCR-PCG+dz or K7
    # refined BCR+dz; K2 merits) and the plant rollout (K1) through the
    # CUDA kernels of ops/cuda.  The stage kernels take the knobs above
    # (tracking and q_cost, hessian, integrator_type, angle_wrap), in
    # float32; K1, the plant, takes none (as the JAX package's).
    fused_stages: bool = False
    # With fused_stages and linsys "pcg" or "bcr": the SQP iteration as
    # one kernel (ops/cuda/sqp_megakernel.py).  For "pcg",
    # megakernel_solve=True runs every SQP iteration of a solve in ONE
    # launch (K5); without it each iteration is one launch of K9p.  "bcr"
    # runs one K9b launch per iteration either way, as the JAX package
    # has no whole-solve BCR kernel.
    megakernel: bool = False
    megakernel_solve: bool = False

    # linsys="auto" (sim.simulate_mpc_scan): run "pcg" and latch over to
    # "bcr_pcg" once BOTH the EMA of the per-update rho-bail rate and the
    # EMA of the tracking error exceed their thresholds (the JAX package's
    # config.py documents the rule).  EMA update: ema <- d ema + (1-d) x.
    failover_bail_rate: float = 0.10
    failover_err_threshold_m: float = 0.20
    failover_ema_decay: float = 0.90
    # The latch is read on the host once per chunk of this many updates
    # (when it divides n_updates; else once per update); a trip inside a
    # chunk switches the backend at the next chunk boundary.
    failover_check_every: int = 8

    @staticmethod
    def for_knots(knot_points: int, **kw) -> "SolverConfig":
        """Config with the reference's per-N tuned defaults."""
        kw.setdefault("cost", CostConfig.for_knots(knot_points))
        kw.setdefault("pcg",
                      PCGConfig(max_iter=PCGConfig.tuned_max_iter(knot_points)))
        return SolverConfig(knot_points=knot_points, **kw)


def default_pcg_exit_tols(knot_points: int) -> list:
    """Per-N sweep of exit tolerances (reference examples/track_iiwa_pcg.cu:46-68)."""
    if knot_points == 32:
        return [5e-6, 7.5e-6, 5e-6, 2.5e-6, 1e-6]
    if knot_points == 64:
        return [5e-5, 7.5e-5, 5e-5, 2.5e-5, 1e-5]
    return [1e-5, 5e-5, 1e-4, 5e-4, 1e-3]
