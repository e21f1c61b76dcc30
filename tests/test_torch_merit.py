"""Port parity for K2's plain version: mpcgpu_tpu_torch's line_search_merits
(CPU tensors -> ops.merit) vs the JAX line_search_merits + merit, and vs
the JAX Pallas kernel line_search_merits_pallas in interpret mode.

N = 8 from fixture 0_0 with seeded steps.  Tolerance rtol 2e-4, atol
2e-4 (tests/test_merit_pallas.py:30-31).
"""
import jax.numpy as jnp
import numpy as np
import torch

from mpcgpu_tpu.ops import merit as jmerit
from mpcgpu_tpu.ops.pallas.merit_kernel import line_search_merits_pallas
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.cuda.merit_kernel import line_search_merits
from tests.test_torch_kkt_schur import problem

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DT, MU, QD_COST, R_COST = 0.015625, 10.0, 1e-4, 1e-3
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(traj_0_0):
    X, U, goals, xs = problem(traj_0_0)
    rng = np.random.default_rng(5)
    dX = (0.05 * rng.normal(size=X.shape)).astype(np.float32)
    dU = (0.05 * rng.normal(size=U.shape)).astype(np.float32)
    return X, U, dX, dU, goals, xs + 0.01


def _port(inputs):
    X, U, dX, dU, goals, xs = (torch.as_tensor(a) for a in inputs)
    return line_search_merits(iiwa14(device="cpu"), X, U, dX, dU, 8, goals,
                              xs, DT, MU, QD_COST, R_COST).numpy()


def test_k2_plain_matches_jax_portable(iiwa, traj_0_0):
    inputs = _inputs(traj_0_0)
    X, U, dX, dU, goals, xs = inputs
    alphas = (1.0 / 2 ** jnp.arange(8)).astype(jnp.float32)
    want = np.append(
        np.asarray(jmerit.line_search_merits(iiwa, X, U, dX, dU, alphas,
                                             goals, xs, DT, MU, QD_COST,
                                             R_COST)),
        float(jmerit.merit(iiwa, X, U, goals, xs, DT, MU, QD_COST, R_COST)))
    np.testing.assert_allclose(_port(inputs), want, **TOL)


def test_k2_plain_matches_pallas_interpret(iiwa, traj_0_0):
    inputs = _inputs(traj_0_0)
    X, U, dX, dU, goals, xs = (jnp.asarray(a) for a in inputs)
    want = line_search_merits_pallas(iiwa, X, U, dX, dU, 8, goals, xs, DT, MU,
                                     QD_COST, R_COST, interpret=True)
    np.testing.assert_allclose(_port(inputs), np.asarray(want), **TOL)
