"""Port parity of the multi-arm paths on the CPU: the arm-packed solve
(K10's plain version) against the JAX arm-packed Pallas kernel in
interpret mode, with end-effector and with joint tracking, the packed
closed loop against the JAX portable single-arm loop per arm, and the
batched closed loop against the JAX batched loop (linsys "pcg", "auto"
and "bcr"), at N = 4 with few updates and SQP iterations.

Tolerances are the JAX package's own: tests/test_megakernel.py:225-234
for the solve (X, U at rtol 1e-3, atol 1e-5; lam at rtol 1e-3, atol
1e-4), tests/test_sim.py:123-174 for the packed loop (rtol 2e-2, atol
2e-3), and the port's closed-loop test (tests/test_torch_closed_loop.py:
tracking errors at atol 1e-3, the final state at atol 5e-3) for the
batched loop.  Integer decisions (sqp_iters, bails, the shared CG count)
must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JaxCostConfig
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.ops.pallas.sqp_megakernel import (
    sqp_solve_mega_pcg_packed as jax_solve_packed)
from mpcgpu_tpu.sim import simulate_mpc_scan as jax_simulate_mpc_scan
from mpcgpu_tpu.sim import (
    simulate_mpc_scan_batched as jax_simulate_mpc_scan_batched)
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.cuda._lib import knobs_of
from mpcgpu_tpu_torch.ops.cuda.sqp_megakernel import (
    sqp_solve_mega_pcg_packed, sqp_solve_mega_pcg_packed_reference)
from mpcgpu_tpu_torch.sim import (arm_starts, simulate_mpc_scan_batched,
                                  simulate_mpc_scan_packed)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.as_tensor
N = 4


def _packed_inputs(traj_0_0, b, rhos):
    """b arms from seeded perturbations of the fixture start (seed 7, as
    tests/test_megakernel.py:159-240 makes them), knot-major numpy."""
    xu, ee = traj_0_0
    rng = np.random.default_rng(7)
    X = np.stack([xu[:N, :14] + 0.02 * rng.normal(size=(N, 14))
                  for _ in range(b)]).astype(np.float32)
    U = np.stack([xu[:N - 1, 14:]] * b).astype(np.float32)
    return X, U, ee[:N].astype(np.float32), np.asarray(rhos, np.float32)


def _solve_kw(cfg):
    cc = cfg.cost
    return dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
                gravity=cfg.gravity, mu=cfg.merit_mu,
                num_alphas=cfg.num_alphas, rho_factor=cfg.rho_factor,
                rho_min=cfg.rho_min, rho_max=cfg.rho_max,
                rho_reset=cfg.rho_reset)


# rhos and tol at which the three arms, each solved alone, leave the CG
# after 10, 6 and 9 iterations in all: the pack's shared exit decides
RHOS, TOL, K_SQP, CAP = (0.02, 0.1, 0.3), 1e-4, 2, 8


@pytest.fixture(scope="module")
def packed_case(iiwa, traj_0_0):
    """The JAX arm-packed kernel (interpret mode), called once, at B = 3."""
    b = len(RHOS)
    X, U, goals, rhos = _packed_inputs(traj_0_0, b, RHOS)
    cfg = JaxSolverConfig.for_knots(N, sqp_max_iter=K_SQP)
    cc = cfg.cost
    pack = lambda A: jnp.reshape(jnp.transpose(jnp.asarray(A), (2, 0, 1)),
                                 (-1, b * N))
    unpack = lambda Al: np.transpose(
        np.reshape(np.asarray(Al), (Al.shape[0], b, N)), (1, 2, 0))
    Ul = pack(np.concatenate([U, np.zeros((b, 1, 7), np.float32)], axis=1))
    out = jax_solve_packed(
        iiwa, pack(X), Ul, jnp.tile(jnp.asarray(goals[:, :3]).T, (1, b)),
        jnp.repeat(jnp.asarray(X[:, 0]).T, N, axis=1),
        jnp.zeros((14, b * N), jnp.float32),
        jnp.asarray(np.repeat(rhos, N)[None]),
        jnp.ones((1, b * N), jnp.float32), CAP, jnp.asarray(TOL, jnp.float32),
        b, K_SQP, cfg.timestep, cc.qd_cost, cc.r_cost, cfg.integrator_type,
        cfg.gravity, cc.hessian, cfg.merit_mu, cfg.num_alphas,
        cfg.rho_factor, cfg.rho_min, cfg.rho_max, cfg.rho_reset)
    Xl, Uo, laml, rhol, meritl, itc, bailed, tot = out
    ref = dict(X=unpack(Xl), U=unpack(Uo)[:, :-1], lam=unpack(laml),
               rho=np.asarray(rhol)[0, ::N], merit=np.asarray(meritl)[0, ::N],
               sqp_iters=np.asarray(itc)[0, ::N],
               bailed=np.asarray(bailed)[0, ::N], pcg_tot=int(tot))
    tcfg = SolverConfig.for_knots(N, sqp_max_iter=K_SQP)
    args = (T(X), T(U), T(goals).expand(b, N, 6), T(X[:, 0]),
            torch.zeros(b, N, 14), T(rhos), torch.ones(b), CAP, TOL, K_SQP)
    return ref, args, _solve_kw(tcfg)


@pytest.mark.parametrize("wrapper", ["reference", "wrapper"])
def test_packed_solve_matches_jax(packed_case, wrapper):
    """The plain version, called directly and through the wrapper (a CPU
    tensor runs it), against the JAX kernel: per-arm sqp_iters and bails
    and the shared CG count equal, X, U, lam, rho and merit close."""
    ref, args, kw = packed_case
    fn = (sqp_solve_mega_pcg_packed_reference if wrapper == "reference"
          else sqp_solve_mega_pcg_packed)
    got = fn(iiwa14(device="cpu"), *args, **kw)
    np.testing.assert_allclose(got.X.numpy(), ref["X"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.U.numpy(), ref["U"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.lam.numpy(), ref["lam"], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.rho.numpy(), ref["rho"], rtol=1e-5)
    np.testing.assert_allclose(got.merit.numpy(), ref["merit"], rtol=1e-4)
    np.testing.assert_array_equal(got.sqp_iters.numpy(), ref["sqp_iters"])
    np.testing.assert_array_equal(got.bailed.numpy(), ref["bailed"])
    assert int(got.pcg_iters_total) == ref["pcg_tot"]


def test_packed_solve_shared_exit_decides(packed_case):
    """Solved alone, the arms leave the CG at different counts, each below
    the pack's: the pack's count is the shared exit's, not any arm's."""
    ref, args, kw = packed_case
    model = iiwa14(device="cpu")
    alone = []
    for a in range(len(RHOS)):
        one = [x[a:a + 1] if isinstance(x, torch.Tensor) and x.dim() else x
               for x in args]
        alone.append(int(sqp_solve_mega_pcg_packed_reference(
            model, *one, **kw).pcg_iters_total))
    assert len(set(alone)) == len(alone), alone
    assert max(alone) < ref["pcg_tot"], (alone, ref["pcg_tot"])


@pytest.fixture(scope="module")
def joint_case(iiwa, traj_0_0):
    """The JAX arm-packed kernel (interpret mode) with joint tracking, called
    once, at B = 2: the goals are the fixture's state rows (g_arm =
    goals.T, mpcgpu_tpu/sim.py:770), the arms start from seeded
    perturbations of them."""
    b, rhos = 2, (0.02, 0.1)
    X, U, _, rhos = _packed_inputs(traj_0_0, b, rhos)
    goals = traj_0_0[0][:N, :14].astype(np.float32)
    cost = JaxCostConfig(tracking="joint", q_cost=1.0, r_cost=1e-4)
    cfg = JaxSolverConfig.for_knots(N, sqp_max_iter=K_SQP, cost=cost)
    pack = lambda A: jnp.reshape(jnp.transpose(jnp.asarray(A), (2, 0, 1)),
                                 (-1, b * N))
    unpack = lambda Al: np.transpose(
        np.reshape(np.asarray(Al), (Al.shape[0], b, N)), (1, 2, 0))
    Ul = pack(np.concatenate([U, np.zeros((b, 1, 7), np.float32)], axis=1))
    out = jax_solve_packed(
        iiwa, pack(X), Ul, jnp.tile(jnp.asarray(goals).T, (1, b)),
        jnp.repeat(jnp.asarray(X[:, 0]).T, N, axis=1),
        jnp.zeros((14, b * N), jnp.float32),
        jnp.asarray(np.repeat(rhos, N)[None]),
        jnp.ones((1, b * N), jnp.float32), CAP, jnp.asarray(TOL, jnp.float32),
        b, K_SQP, cfg.timestep, cost.qd_cost, cost.r_cost,
        cfg.integrator_type, cfg.gravity, cost.hessian, cfg.merit_mu,
        cfg.num_alphas, cfg.rho_factor, cfg.rho_min, cfg.rho_max,
        cfg.rho_reset, tracking="joint", q_cost=cost.q_cost)
    Xl, Uo, laml, rhol, meritl, itc, bailed, tot = out
    ref = dict(X=unpack(Xl), U=unpack(Uo)[:, :-1], lam=unpack(laml),
               rho=np.asarray(rhol)[0, ::N], merit=np.asarray(meritl)[0, ::N],
               sqp_iters=np.asarray(itc)[0, ::N],
               bailed=np.asarray(bailed)[0, ::N], pcg_tot=int(tot))
    tcfg = SolverConfig.for_knots(
        N, sqp_max_iter=K_SQP,
        cost=CostConfig(tracking="joint", q_cost=1.0, r_cost=1e-4))
    args = (T(X), T(U), T(goals).expand(b, N, 14), T(X[:, 0]),
            torch.zeros(b, N, 14), T(rhos), torch.ones(b), CAP, TOL, K_SQP)
    kw = dict(_solve_kw(tcfg), knobs=knobs_of(tcfg))
    return ref, args, kw


def test_packed_solve_joint_tracking_matches_jax(joint_case):
    """The plain packed solve with tracking="joint" (the knobs the JAX packed
    loop passes, mpcgpu_tpu/sim.py:769-785) against the JAX kernel, at the
    end-effector case's tolerances: per-arm sqp_iters and bails and the
    shared CG count equal."""
    ref, args, kw = joint_case
    got = sqp_solve_mega_pcg_packed_reference(iiwa14(device="cpu"), *args,
                                              **kw)
    np.testing.assert_allclose(got.X.numpy(), ref["X"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.U.numpy(), ref["U"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.lam.numpy(), ref["lam"], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.rho.numpy(), ref["rho"], rtol=1e-5)
    np.testing.assert_allclose(got.merit.numpy(), ref["merit"], rtol=1e-4)
    np.testing.assert_array_equal(got.sqp_iters.numpy(), ref["sqp_iters"])
    np.testing.assert_array_equal(got.bailed.numpy(), ref["bailed"])
    assert int(got.pcg_iters_total) == ref["pcg_tot"]


def _loop_cfgs(cap, sqp_iters=2):
    jcfg = JaxSolverConfig.for_knots(N, sqp_max_iter=sqp_iters)
    jcfg = dataclasses.replace(jcfg, pcg=dataclasses.replace(jcfg.pcg,
                                                             max_iter=cap))
    tcfg = SolverConfig.for_knots(N, sqp_max_iter=sqp_iters,
                                  pcg=PCGConfig(max_iter=cap))
    return jcfg, tcfg


def _dq(b, nq=7, seed=0):
    """The JAX multi-arm loops' start perturbation (sim.py:689-697)."""
    return np.array(0.02 * jax.random.normal(jax.random.PRNGKey(seed),
                                             (b, nq), jnp.float32))


@pytest.fixture(scope="module")
def packed_loop_ref(iiwa, traj_0_0):
    """The JAX portable single-arm loop per arm, cap-bound CG (tol 1e-9),
    2 updates from the perturbed starts."""
    xu, ee = traj_0_0
    jcfg, _ = _loop_cfgs(cap=4)
    dq = _dq(2)
    X = jnp.asarray(xu[:N, :14])
    outs = []
    for a in range(2):
        outs.append(jax_simulate_mpc_scan(
            iiwa, jcfg, jnp.asarray(xu), jnp.asarray(ee),
            X.at[0, :7].add(dq[a]), jnp.asarray(xu[:N - 1, 14:]),
            jnp.zeros((N, 14), jnp.float32), jnp.asarray(1e-3, jnp.float32),
            1e-9, 2))
    return outs, dq


@pytest.mark.parametrize("fused", [False, True])
def test_packed_loop_matches_single_arm_loops(traj_0_0, packed_loop_ref,
                                              fused):
    """simulate_mpc_scan_packed against the JAX single-arm loop run per
    arm (cap-bound CG, so the lockstep CG counts equal the lone ones), as
    tests/test_sim.py:123-174 holds the JAX packed loop; fused_stages on
    CPU tensors runs the wrappers' plain versions."""
    xu, ee = traj_0_0
    refs, dq = packed_loop_ref
    _, cfg = _loop_cfgs(cap=4)
    cfg = dataclasses.replace(cfg, fused_stages=fused)
    X, U, lam = arm_starts(T(xu[:N, :14]), T(xu[:N - 1, 14:].copy()),
                           torch.zeros(N, 14), T(dq))
    got = simulate_mpc_scan_packed(iiwa14(device="cpu"), cfg, T(xu), T(ee),
                                   X, U, lam, 1e-3, 1e-9, 2)
    assert tuple(got["tracking_errors"].shape) == (2, 2)
    assert tuple(got["tracking_path"].shape) == (2, 2, 14)
    for a, ref in enumerate(refs):
        np.testing.assert_allclose(got["tracking_errors"][a].numpy(),
                                   np.asarray(ref["tracking_errors"]),
                                   rtol=2e-2, atol=2e-3)
        np.testing.assert_allclose(got["final_xs"][a].numpy(),
                                   np.asarray(ref["final_xs"]),
                                   rtol=2e-2, atol=2e-3)
        np.testing.assert_array_equal(got["sqp_iters"][a].numpy(),
                                      np.asarray(ref["sqp_iters"]))
        np.testing.assert_array_equal(got["rho_bailed"][a].numpy(),
                                      np.asarray(ref["rho_bailed"]))
    np.testing.assert_array_equal(got["shifted"].numpy(),
                                  np.asarray(refs[0]["shifted"]))


@pytest.fixture(scope="module")
def jax_batched(iiwa, traj_0_0):
    """The JAX batched loop (vmap of the portable single-arm loop), B = 2,
    2 updates, cap 40, tol 5e-5, from its own seed-0 perturbation: one
    call per linsys for the module, made at first use."""
    xu, ee = traj_0_0
    jcfg, _ = _loop_cfgs(cap=40)
    refs = {}

    def ref(linsys):
        if linsys not in refs:
            refs[linsys] = jax_simulate_mpc_scan_batched(
                iiwa, jcfg, jnp.asarray(xu), jnp.asarray(ee),
                jnp.asarray(xu[:N, :14]), jnp.asarray(xu[:N - 1, 14:]),
                jnp.zeros((N, 14), jnp.float32),
                jnp.asarray(1e-3, jnp.float32), 5e-5, 2, linsys, batch=2,
                seed=0)
        return refs[linsys]
    return ref


def _port_batched(traj_0_0, linsys):
    """simulate_mpc_scan_batched on jax_batched's problem, started from the
    JAX loop's own perturbation, handed to the port."""
    xu, ee = traj_0_0
    _, cfg = _loop_cfgs(cap=40)
    X, U, lam = arm_starts(T(xu[:N, :14]), T(xu[:N - 1, 14:].copy()),
                           torch.zeros(N, 14), T(_dq(2)))
    return simulate_mpc_scan_batched(iiwa14(device="cpu"), cfg, T(xu), T(ee),
                                     X, U, lam, 1e-3, 5e-5, 2, linsys)


def _batched_close(got, ref, keys):
    for k in keys:
        assert tuple(got[k].shape) == np.asarray(ref[k]).shape, k
    np.testing.assert_allclose(got["tracking_errors"].numpy(),
                               np.asarray(ref["tracking_errors"]), atol=1e-3)
    np.testing.assert_allclose(got["final_xs"].numpy(),
                               np.asarray(ref["final_xs"]), atol=5e-3)
    for k in keys[1:]:
        if k != "pcg_iters_total":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_batched_loop_matches_jax(traj_0_0, jax_batched):
    """simulate_mpc_scan_batched against the JAX batched loop (vmap of the
    portable loop), B = 2, 2 updates, cap 40, tol 5e-5, started from the
    JAX loop's own perturbation, handed to the port."""
    _batched_close(_port_batched(traj_0_0, "pcg"), jax_batched("pcg"),
                   ["tracking_errors", "sqp_iters", "pcg_iters_total",
                    "rho_bailed", "shifted"])


@pytest.mark.parametrize("linsys", ["auto", "bcr"])
def test_batched_loop_matches_jax_per_backend(traj_0_0, jax_batched,
                                              linsys):
    """simulate_mpc_scan_batched with a linsys other than "pcg" (the
    single-arm plain loop once per arm) against the JAX batched loop with
    the same linsys (vmap of the single-arm loop: a latch per arm for
    "auto"), at test_batched_loop_matches_jax's problem and tolerances;
    "auto" also its per-update backend."""
    keys = ["tracking_errors", "sqp_iters", "pcg_iters_total", "rho_bailed",
            "shifted"] + (["failed_over"] if linsys == "auto" else [])
    _batched_close(_port_batched(traj_0_0, linsys), jax_batched(linsys), keys)
