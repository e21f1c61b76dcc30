"""Port parity of the second robot: the URDF seam, the planar 2R arm and
its synthesized fixture, the solve and the closed loop at nq = 2, against
the JAX package on the CPU (tests/test_second_robot.py's configuration:
q0 = [0.4, 0.6], amplitude 0.35, dt 0.05, N = 16, qd_cost 1e-3, r_cost
1e-4, 3 SQP iterations, CG cap 30, 6 updates).  Each JAX result comes
from one call in a module fixture, on the JAX portable path.

Tolerances: the tables at 1e-6; the dynamics at tests/test_torch_
dynamics.py's rtol 1e-4 (atol 1e-4 of the largest entry); the fixture's
rows at 1e-5; the solve's X within 1e-2 of the largest entry
(scripts/tpu_kernel_regression.py's staged-against-portable bound); the
loop at tests/test_second_robot.py's (path rtol 5e-3, atol 1e-3; errors
atol 2e-3), with mean error under 0.10 m.  fused_stages on CPU tensors
runs the kernel wrappers' plain versions, so both settings are checked
here; the kernels themselves at nq = 2 are held to those plain versions
in tests/test_torch_csrc_host_nj2.py and on the card by chip_smoke.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JaxCostConfig
from mpcgpu_tpu.config import PCGConfig as JaxPCGConfig
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.models import dynamics as jdyn
from mpcgpu_tpu.models.planar2r import planar2r as jax_planar2r
from mpcgpu_tpu.models.urdf import model_from_urdf as jax_model_from_urdf
from mpcgpu_tpu.sim import simulate_mpc_scan as jax_simulate_mpc_scan
from mpcgpu_tpu.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu.utils.synth import (
    synthesize_tracking_fixture as jax_synthesize)
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models import dynamics as dyn
from mpcgpu_tpu_torch.models.planar2r import PLANAR_2R_URDF, planar2r
from mpcgpu_tpu_torch.models.robot import FIELDS
from mpcgpu_tpu_torch.models.urdf import model_from_urdf
from mpcgpu_tpu_torch.sim import simulate_mpc_scan
from mpcgpu_tpu_torch.sqp import check_fused_config, sqp_iteration, sqp_solve
from mpcgpu_tpu_torch.utils.synth import synthesize_tracking_fixture
from mpcgpu_tpu_torch.utils.trajfiles import horizon_slices

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.as_tensor
N, N_UPDATES, DT = 16, 6, 0.05
FIXTURE = dict(q0=[0.4, 0.6], amplitude=0.35, n_steps=64, dt=DT)
# tests/test_urdf.py's tilted-axis arm: the first joint about local y
TILTED = PLANAR_2R_URDF.replace('<axis xyz="0 0 1"/>', '<axis xyz="0 1 0"/>',
                                1)


def _cfg(cls, pcg, cost, **kw):
    return cls(knot_points=N, state_size=4, control_size=2, timestep=DT,
               sqp_max_iter=3, pcg=pcg(max_iter=30),
               cost=cost(qd_cost=1e-3, r_cost=1e-4), **kw)


def _port_cfg(**kw):
    return _cfg(SolverConfig, PCGConfig, CostConfig, **kw)


@pytest.fixture(scope="module")
def robots():
    return jax_planar2r(), planar2r(device="cpu")


@pytest.fixture(scope="module")
def fixtures(robots):
    jm, tm = robots
    return jax_synthesize(jm, **FIXTURE), synthesize_tracking_fixture(
        tm, **FIXTURE)


@pytest.fixture(scope="module")
def jax_solve(robots, fixtures):
    (xu, ee), _ = fixtures
    X, U, goals, xs = horizon_slices(xu, ee, N, nx=4)
    cfg = _cfg(JaxSolverConfig, JaxPCGConfig, JaxCostConfig)
    return jax_sqp_solve(robots[0], cfg, jnp.asarray(X), jnp.asarray(U),
                         jnp.zeros((N, 4), jnp.float32), jnp.asarray(goals),
                         jnp.asarray(xs), jnp.asarray(1e-3, jnp.float32),
                         jnp.asarray(1e-6, jnp.float32), "pcg")


@pytest.fixture(scope="module")
def jax_loop(robots, fixtures):
    (xu, ee), _ = fixtures
    X, U, _, _ = horizon_slices(xu, ee, N, nx=4)
    cfg = _cfg(JaxSolverConfig, JaxPCGConfig, JaxCostConfig)
    out = jax_simulate_mpc_scan(
        robots[0], cfg, jnp.asarray(xu), jnp.asarray(ee), jnp.asarray(X),
        jnp.asarray(U), jnp.zeros((N, 4), jnp.float32),
        jnp.asarray(1e-3, jnp.float32), 1e-6, N_UPDATES, "pcg")
    return {k: np.asarray(out[k])
            for k in ("tracking_path", "tracking_errors", "sqp_iters")}


@pytest.mark.parametrize("urdf", [PLANAR_2R_URDF, TILTED],
                         ids=["planar", "tilted"])
def test_urdf_tables_match_jax(urdf):
    jm = jax_model_from_urdf(urdf)
    tm = model_from_urdf(urdf, device="cpu")
    assert tm.num_joints == 2 and tm.Xc.device.type == "cpu"
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=0,
                                   atol=1e-6, err_msg=f)


def _dyn_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_two_joint_dynamics_match_jax(robots):
    """Mass matrix, end-effector pose, RNEA and ABA at seeded states."""
    jm, tm = robots
    rng = np.random.default_rng(0)
    for _ in range(4):
        q, qd = (rng.uniform(-2, 2, 2).astype(np.float32) for _ in range(2))
        u, qdd = (rng.uniform(-5, 5, 2).astype(np.float32) for _ in range(2))
        jq, jqd, ju, jqdd = map(jnp.asarray, (q, qd, u, qdd))
        _dyn_close(dyn.mass_matrix(tm, T(q)), jdyn.mass_matrix(jm, jq))
        _dyn_close(dyn.ee_pos(tm, T(q)), jdyn.ee_pos(jm, jq))
        _dyn_close(dyn.rnea(tm, T(q), T(qd), T(qdd), -9.81),
                   jdyn.rnea(jm, jq, jqd, jqdd, -9.81))
        _dyn_close(dyn.forward_dynamics(tm, T(q), T(qd), T(u), -9.81),
                   jdyn.forward_dynamics(jm, jq, jqd, ju, -9.81))


def test_synthesized_fixture_matches_jax(fixtures):
    (jxu, jee), (xu, ee) = fixtures
    assert xu.shape == (64, 6) and ee.shape == (64, 6)
    assert xu.dtype == ee.dtype == np.float32
    np.testing.assert_allclose(xu, jxu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ee, jee, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_sqp_solve_at_two_joints_matches_jax(robots, fixtures, jax_solve,
                                             fused):
    """Plain (and, on CPU tensors, the fused route's plain versions: K3,
    K4, K2 staged) against the JAX portable solve, from the same rows."""
    (xu, ee), _ = fixtures
    X, U, goals, xs = (T(a) for a in horizon_slices(xu, ee, N, nx=4))
    got = sqp_solve(robots[1], _port_cfg(fused_stages=fused), X, U,
                    torch.zeros(N, 4), goals, xs, 1e-3, 1e-6)
    want = np.asarray(jax_solve.X)
    err = np.abs(got.X.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-2, err
    assert int(got.stats.sqp_iters) == int(jax_solve.stats.sqp_iters)
    np.testing.assert_array_equal(got.stats.accepted.numpy(),
                                  np.asarray(jax_solve.stats.accepted))


@pytest.mark.parametrize("route", ["plain", "whole_solve"])
def test_closed_loop_at_two_joints_matches_jax(robots, fixtures, jax_loop,
                                               route):
    """simulate_mpc_scan over 6 updates: the plain modules, and the route
    of the fused whole solve (K5 and K1; their plain versions on CPU
    tensors) against JAX's portable loop, on the same trajectory (the
    loop at rho 1e-3 carries a 1e-5 change of its rows to 2.6e-3 in the
    path, and float64 parts from float32 by 5e-3 in six updates)."""
    (xu, ee), _ = fixtures
    X, U, _, _ = horizon_slices(xu, ee, N, nx=4)
    kw = ({} if route == "plain" else
          dict(fused_stages=True, megakernel=True, megakernel_solve=True))
    out = simulate_mpc_scan(robots[1], _port_cfg(**kw), T(xu), T(ee), T(X),
                            T(U), torch.zeros(N, 4), 1e-3, 1e-6, N_UPDATES)
    np.testing.assert_allclose(out["tracking_path"].numpy(),
                               jax_loop["tracking_path"], rtol=5e-3,
                               atol=1e-3)
    errs = out["tracking_errors"].numpy()
    np.testing.assert_allclose(errs, jax_loop["tracking_errors"], atol=2e-3)
    assert np.isfinite(errs).all() and errs.mean() < 0.10, errs
    np.testing.assert_array_equal(out["sqp_iters"].numpy(),
                                  jax_loop["sqp_iters"])


@pytest.mark.parametrize("linsys,kw,kernel", [
    ("pcg_pallas", {}, "K4b"),
    ("bcr_pcg", {}, "K6"),
    ("bcr", {}, "K7"),
    ("bcr", dict(megakernel=True), "K9b"),
    ("pcg", dict(megakernel=True), "K9p"),
])
def test_fused_config_names_the_iiwa_only_kernels_at_two_joints(
        linsys, kw, kernel):
    cfg = _port_cfg(fused_stages=True, **kw)
    with pytest.raises(ValueError, match=kernel):
        check_fused_config(cfg, linsys)
    iiwa = dataclasses.replace(cfg, state_size=14, control_size=7)
    check_fused_config(iiwa, linsys)


def test_fused_config_serves_the_slice_routes_at_two_joints(robots):
    """Staged pcg (K3, K4, K2) and the whole solve (K5) pass at nq = 2;
    one iteration of the whole-solve configuration is K9p's and raises;
    widths outside 2-7 joints raise."""
    check_fused_config(_port_cfg(fused_stages=True), "pcg")
    mega = _port_cfg(fused_stages=True, megakernel=True,
                     megakernel_solve=True)
    check_fused_config(mega, "pcg", whole_solve=True)
    with pytest.raises(ValueError, match="K9p"):
        check_fused_config(mega, "pcg")
    z = torch.zeros(N, 4)
    with pytest.raises(ValueError, match="K9p"):
        sqp_iteration(robots[1], mega, z, z[:-1, :2], z, z[:, :3].clone(),
                      z[0], 1e-3, 1.0, 1.0, 1e-6)
    for nx, nu in ((16, 8), (2, 1), (4, 3)):
        with pytest.raises(ValueError, match="nx, nu"):
            check_fused_config(dataclasses.replace(
                mega, state_size=nx, control_size=nu), "pcg", True)
