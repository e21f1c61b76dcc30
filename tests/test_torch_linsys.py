"""Port parity for the oracle backends: "qdldl" (the host sparse LDL' of
mpcgpu_tpu_torch/linsys/qdldl_host.py) and "dense" (Cholesky of the dense
S), and btridiag.to_dense, against the JAX package's.

Tolerances of tests/test_qdldl.py: the LDL' solve of the JAX Schur test
system within rtol 3e-3, atol 3e-3 of JAX's (:39-46); sqp_solve at N = 12
from fixture 0_0, final merit at rtol 5e-3 and X at rtol 1e-2, atol 1e-3
(:49-67), both port backends against the JAX sqp_solve with its dense
oracle, as that test holds JAX's qdldl against it (one JAX compile, not
two).  The CSC assembly and to_dense are exact copies: equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpcgpu_tpu.linsys.qdldl_host as jax_qh
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.ops import btridiag as jax_btridiag
from mpcgpu_tpu.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.linsys import qdldl_host as qh
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.btridiag import BlockTri, to_dense
from mpcgpu_tpu_torch.ops.schur import SchurData
from mpcgpu_tpu_torch.sqp import get_linsys_backend, sqp_solve
from tests.torch_systems import random_system

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.as_tensor


def _bands(ks):
    return tuple(ks[f] for f in ("SL", "SD", "SU"))


def test_to_dense_and_csc_equal_the_jax_package():
    ks = random_system(5, seed=3)
    want = np.asarray(jax_btridiag.to_dense(jax_btridiag.BlockTri(
        *map(jnp.asarray, _bands(ks)))))
    np.testing.assert_array_equal(
        to_dense(BlockTri(*map(T, _bands(ks)))).numpy(), want)
    for got, ref in zip(qh._btd_upper_csc(*_bands(ks)),
                        jax_qh._btd_upper_csc(*_bands(ks))):
        np.testing.assert_array_equal(got, ref)


def test_ldl_solver_matches_jax():
    """The JAX Schur tests' random system (random_kkt, rho 1e-3, N = 8)."""
    ks = random_system(8, seed=7)
    got = qh.LDLSolver(8, 14).solve(*_bands(ks), ks["gamma"])
    want = jax_qh.LDLSolver(8, 14).solve(*_bands(ks), ks["gamma"])
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=3e-3)
    dense = np.asarray(jax_btridiag.to_dense(jax_btridiag.BlockTri(
        *map(jnp.asarray, _bands(ks)))), np.float64)
    x_ref = np.linalg.solve(dense, ks["gamma"].astype(np.float64).reshape(-1))
    np.testing.assert_allclose(got.reshape(-1), x_ref, rtol=3e-3, atol=3e-3)
    Ap, Ai, Ax = qh._btd_upper_csc(*_bands(ks))
    np.testing.assert_array_equal(
        qh.LDLSolver(8, 14).solve_csc(Ap, Ai, Ax, ks["gamma"]), got)


@pytest.mark.parametrize("linsys", ["qdldl", "dense"])
def test_oracle_backends_return_nan_on_an_indefinite_system(linsys):
    ks = random_system(4, seed=3)
    sd = SchurData(S=BlockTri(*(-T(b) for b in _bands(ks))), Pinv=None,
                   gamma=T(ks["gamma"]), Qinv=None, Rinv=None)
    lam, it, hit = get_linsys_backend(linsys)(None, sd, None, 0.0)
    assert lam.shape == (4, 14) and torch.isnan(lam).all()
    assert int(it) == 0 and not bool(hit)


def test_ldl_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails leaves no library and raises."""
    monkeypatch.setattr(qh, "_LIB", tmp_path / "libldl.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="LDL' library"):
        qh.build()
    assert not list(tmp_path.iterdir())


N12 = 12


@pytest.fixture(scope="module")
def n12_problem(traj_0_0):
    xu, ee = traj_0_0
    return (xu[:N12, :14], xu[:N12 - 1, 14:].copy(), ee[:N12],
            np.zeros((N12, 14), np.float32))


@pytest.fixture(scope="module")
def jax_dense_solve(iiwa, n12_problem):
    X, U, goals, lam = n12_problem
    return jax_sqp_solve(iiwa, JaxSolverConfig.for_knots(N12, sqp_max_iter=3),
                         jnp.asarray(X), jnp.asarray(U), jnp.asarray(lam),
                         jnp.asarray(goals), jnp.asarray(X[0]), 1e-3, 1e-11,
                         linsys="dense")


@pytest.mark.parametrize("linsys", ["qdldl", "dense"])
def test_oracle_backends_match_jax(n12_problem, jax_dense_solve, linsys):
    X, U, goals, lam = n12_problem
    ref = jax_dense_solve
    got = sqp_solve(iiwa14(device="cpu"), SolverConfig.for_knots(
        N12, sqp_max_iter=3), T(X), T(U), T(lam), T(goals), T(X[0]), 1e-3,
        1e-11, linsys)
    np.testing.assert_allclose(float(got.stats.final_merit),
                               float(ref.stats.final_merit), rtol=5e-3)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), rtol=1e-2,
                               atol=1e-3)
    assert (got.stats.pcg_iters.numpy() == 0).all()
    np.testing.assert_array_equal(got.stats.accepted.numpy(),
                                  np.asarray(ref.stats.accepted))
