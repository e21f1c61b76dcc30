"""Port parity at long horizons (N = 256), on CPU.

K8 -- the JAX package's 128-knot-tile form of the KKT + Schur stage,
``form_kkt_schur_tiled`` (interpret mode) -- against the port's
``form_kkt_schur``, whose CUDA kernel (K3, one block per knot) serves every
horizon; here its plain version runs.  Fixture 0_0, a seeded 0.02
perturbation, rho 1e-3, r_cost 1e-4, the stair preconditioner on.  S's
bands are held per band: max |got - want| <= 1e-5 max |want| (their
entries reach 4.5e4, where float32 noise alone is 2.5e-2; the measured
worst is 1.4e-6 of the band's largest entry); the other blocks at rtol =
atol = 3e-3, the JAX kernel test's tolerance
(tests/test_kkt_schur_pallas.py:33).

The long-horizon solve: the port's ``sqp_solve`` with fused_stages --
with megakernel and megakernel_solve (K2, then K5g on the card), staged
(K3, K4g, K2) and per iteration (K2, K9pg); on CPU tensors their plain
versions -- against one JAX ``sqp_solve`` on its portable stages
(which the JAX tests hold equal to its fused path), 2 SQP iterations,
PCG cap 24, exit tol 1e-5: X, U at atol 5e-3
(tests/test_torch_closed_loop.py), sqp_iters, accepted and rho_bailed
identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import PCGConfig as JaxPCGConfig
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.ops.pallas.kkt_schur_kernel import form_kkt_schur_tiled
from mpcgpu_tpu.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import form_kkt_schur
from mpcgpu_tpu_torch.sqp import sqp_solve
from tests.test_torch_kkt_schur import DT, QD_COST, RHO, problem

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 256
R_COST = 1e-4          # CostConfig.for_knots(N) at N != 64
CAP, TOL = 24, 1e-5    # PCGConfig.tpu_tuned_max_iter(256), the N's exit tol
T = torch.as_tensor


def _lanes(b):
    """A JAX lane-layout band (a, b, N) as the port's (N, a, b)."""
    return np.moveaxis(np.asarray(b), -1, 0)


def test_k8_tiled_jax_matches_the_port_at_256(iiwa, traj_0_0):
    X, U, goals, xs = problem(traj_0_0, n=N)
    ls = form_kkt_schur_tiled(iiwa, jnp.asarray(X), jnp.asarray(U),
                              jnp.asarray(goals), jnp.asarray(xs), RHO, DT,
                              QD_COST, R_COST, interpret=True)
    ks = form_kkt_schur(iiwa14(device="cpu"), T(X), T(U), T(goals), T(xs),
                        RHO, DT, QD_COST, R_COST)
    for f in ("SL", "SD", "SU"):
        got, want = getattr(ks, f).numpy(), _lanes(getattr(ls, f))
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale, f
    tol = dict(rtol=3e-3, atol=3e-3)
    for f in ("PL", "PD", "PU", "Qinv"):
        np.testing.assert_allclose(getattr(ks, f).numpy(),
                                   _lanes(getattr(ls, f)), err_msg=f, **tol)
    for f in ("Rinv", "A", "B"):   # the last knot has no control
        np.testing.assert_allclose(getattr(ks, f).numpy()[:-1],
                                   _lanes(getattr(ls, f))[:-1], err_msg=f,
                                   **tol)
    np.testing.assert_allclose(ks.gamma.numpy(), np.asarray(ls.gamma).T,
                               **tol)
    np.testing.assert_allclose(ks.q.numpy(), np.asarray(ls.q).T, **tol)
    np.testing.assert_allclose(ks.r.numpy()[:-1], np.asarray(ls.r).T[:-1],
                               **tol)


def _start(traj_0_0):
    """Fixture 0_0's first N knots, seeded 0.02 perturbation, knot 0
    kept."""
    xu, ee = traj_0_0
    pert = 0.02 * np.random.default_rng(5).normal(size=(N, 14))
    pert[0] = 0.0
    X = (xu[:N, :14] + pert).astype(np.float32)
    return X, xu[:N - 1, 14:].copy(), ee[:N].copy(), xu[0, :14].copy()


@pytest.fixture(scope="module")
def jax_solve(iiwa, traj_0_0):
    X, U, goals, xs = _start(traj_0_0)
    cfg = JaxSolverConfig.for_knots(N, sqp_max_iter=2,
                                    pcg=JaxPCGConfig(max_iter=CAP))
    return jax_sqp_solve(iiwa, cfg, X, U, np.zeros((N, 14), np.float32),
                         goals, xs, 1e-3, TOL)


@pytest.mark.parametrize("mode", [
    dict(megakernel=True, megakernel_solve=True),   # the bench default: K5g
    dict(),                                         # staged: K3, K4g, K2
    dict(megakernel=True),                          # per iteration: K9pg
])
def test_long_horizon_solve_matches_jax(traj_0_0, jax_solve, mode):
    X, U, goals, xs = _start(traj_0_0)
    cfg = SolverConfig.for_knots(N, sqp_max_iter=2,
                                 pcg=PCGConfig(max_iter=CAP),
                                 fused_stages=True, **mode)
    got = sqp_solve(iiwa14(device="cpu"), cfg, T(X), T(U),
                    torch.zeros(N, 14), T(goals), T(xs), 1e-3, TOL)
    ref = jax_solve
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), atol=5e-3)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), atol=5e-3)
    st, rst = got.stats, ref.stats
    assert int(st.sqp_iters) == int(rst.sqp_iters)
    assert bool(st.rho_bailed) == bool(rst.rho_bailed)
    np.testing.assert_array_equal(st.accepted.numpy(),
                                  np.asarray(rst.accepted))
