"""Port parity of the host-driven SQP modes against the JAX package on
the CPU at N = 8: the fine-grained per-phase mode, sqp_iteration on
each route, the wall-clock time box (with calibrated_iteration_budget)
and stage_latencies.  Tolerances (tests/test_torch_closed_loop.py): X,
U and lam at atol 5e-3; iteration counts, accepts and bails equal; CG
counts within 2.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import PCGConfig as JaxPCGConfig
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.sqp import sqp_iteration as jax_sqp_iteration
from mpcgpu_tpu.sqp import sqp_solve_fine_grained as jax_fine_grained
from mpcgpu_tpu.sqp import sqp_solve_timeboxed as jax_timeboxed
from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.sqp import (calibrated_iteration_budget, sqp_iteration,
                                  sqp_solve_fine_grained, sqp_solve_timeboxed)
from mpcgpu_tpu_torch.utils.profiling import stage_latencies

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 8
TOL = 5e-5
T = torch.as_tensor
# sqp_max_iter 4, CG cap 40: one configuration for every JAX call
JAX_CFG = JaxSolverConfig.for_knots(N, sqp_max_iter=4,
                                    pcg=JaxPCGConfig(max_iter=40))
CFG = SolverConfig.for_knots(N, sqp_max_iter=4, pcg=PCGConfig(max_iter=40))


def _start(traj_0_0, seed=1):
    xu, ee = traj_0_0
    X = xu[:N, :14].copy()
    rng = np.random.default_rng(seed)
    Xp = (X + 0.02 * rng.normal(size=X.shape)).astype(np.float32)
    Xp[0] = X[0]
    return (Xp, xu[:N - 1, 14:].copy(), np.zeros((N, 14), np.float32),
            ee[:N].copy(), X[0].copy())


def test_fine_grained_matches_jax(iiwa, traj_0_0):
    """The five plain phases per iteration: the same keys, one time per
    iteration, the same iteration and bail counts and accept pattern, X
    and U at atol 5e-3 (times not compared)."""
    X, U, lam, goals, xs = _start(traj_0_0)
    jres, jt = jax_fine_grained(iiwa, JAX_CFG, X, U, lam, goals, xs, 1e-3,
                                TOL)
    res, t = sqp_solve_fine_grained(iiwa14(device="cpu"), CFG, T(X), T(U),
                                    T(lam), T(goals), T(xs), 1e-3, TOL)
    assert t.keys() == jt.keys()
    assert int(res.stats.sqp_iters) == int(jres.stats.sqp_iters) == 4
    assert all(len(v) == 4 and min(v) > 0 for v in t.values())
    assert bool(res.stats.rho_bailed) == bool(jres.stats.rho_bailed)
    np.testing.assert_array_equal(res.stats.accepted.numpy(),
                                  np.asarray(jres.stats.accepted))
    np.testing.assert_allclose(res.X.numpy(), np.asarray(jres.X), atol=5e-3)
    np.testing.assert_allclose(res.U.numpy(), np.asarray(jres.U), atol=5e-3)


@pytest.mark.parametrize("route", ["plain", "staged", "megakernel"])
def test_sqp_iteration_matches_jax(iiwa, traj_0_0, route):
    """One iteration on each route (on CPU tensors the kernels' plain
    versions) against the JAX iteration: the JAX tuple's ten entries,
    X, U and lam at atol 5e-3, accept and bail equal, CG counts within
    2."""
    X, U, lam, goals, xs = _start(traj_0_0)
    # float32 scalars, as sqp_solve_timeboxed passes them: one JAX compile
    f32 = np.float32
    args = (X, U, lam, goals, xs, f32(1e-3), f32(1.0), f32(np.inf), TOL)
    want = jax_sqp_iteration(iiwa, JAX_CFG, *args)
    cfg = dataclasses.replace(CFG, fused_stages=route != "plain",
                              megakernel=route == "megakernel")
    got = sqp_iteration(iiwa14(device="cpu"), cfg,
                        *(T(a) for a in args[:5]), *map(float, args[5:8]),
                        TOL)
    assert len(got) == len(want) == 10
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-3)
    assert bool(got[6]) == bool(want[6]) and bool(got[7]) == bool(want[7])
    assert float(got[3]) == pytest.approx(float(want[3]))
    assert abs(int(got[8]) - int(want[8])) <= 2


def test_timeboxed_counts_equal_jax_and_the_calibrated_budget(iiwa,
                                                              traj_0_0):
    """Under a clock that advances 250 us a read (the t0 read and one
    before each iteration: tests/test_sqp.py's FakeClock), the box runs
    the iterations the JAX box runs and calibrated_iteration_budget
    gives; X at atol 5e-3 against the JAX box."""
    X, U, lam, goals, xs = _start(traj_0_0)
    model = iiwa14(device="cpu")
    per_iter_us = 250.0

    class FakeClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            t, self.t = self.t, self.t + per_iter_us * 1e-6
            return t

    for budget_us in (0.0, 400.0, 900.0, 1e6):
        want = jax_timeboxed(iiwa, JAX_CFG, X, U, lam, goals, xs, 1e-3, TOL,
                             max_time_us=budget_us, _clock=FakeClock())
        got = sqp_solve_timeboxed(model, CFG,
                                  T(X), T(U), T(lam), T(goals), T(xs), 1e-3,
                                  TOL, max_time_us=budget_us,
                                  _clock=FakeClock())
        n = calibrated_iteration_budget(budget_us, per_iter_us, cap=4)
        assert not bool(got.stats.rho_bailed)
        assert int(got.stats.sqp_iters) == int(want.stats.sqp_iters) == n
        np.testing.assert_array_equal(got.stats.accepted.numpy(),
                                      np.asarray(want.stats.accepted))
        np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X),
                                   atol=5e-3)


def test_stage_latencies_keys(traj_0_0):
    """The JAX function's keys (mpcgpu_tpu/utils/profiling.py:74-81), each
    time positive, and the CG's count."""
    X, U, _, goals, xs = _start(traj_0_0)
    out = stage_latencies(iiwa14(device="cpu"), SolverConfig.for_knots(N),
                          T(X), T(U), T(goals), T(xs), reps=2)
    assert list(out) == ["kkt_us", "schur_us", "pcg_while_loop_us",
                         "pcg_pallas_us", "dz_us", "line_search_us",
                         "pcg_iters"]
    assert all(v > 0 for k, v in out.items() if k.endswith("_us"))
    assert isinstance(out["pcg_iters"], int) and out["pcg_iters"] > 0
