"""Port parity for K3's plain version: mpcgpu_tpu_torch's form_kkt_schur
(CPU tensors -> form_kkt + form_schur) vs the JAX form_kkt + form_schur.

N = 8 knots from fixture 0_0 with a seeded perturbation.  Tolerance rtol
3e-3, atol 3e-3, as the JAX package's own KKT+Schur kernel test
(tests/test_kkt_schur_pallas.py:33).
"""
import numpy as np
import pytest
import torch

from mpcgpu_tpu.ops.kkt import form_kkt
from mpcgpu_tpu.ops.schur import form_schur
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import form_kkt_schur

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 8
RHO = 1e-3
DT, QD_COST, R_COST = 0.015625, 1e-4, 1e-3
TOL = dict(rtol=3e-3, atol=3e-3)


def problem(traj_0_0, n=N, seed=0):
    """(X, U, goals, xs) float32 numpy arrays near the recorded trajectory."""
    xu, ee = traj_0_0
    rng = np.random.default_rng(seed)
    X = (xu[:n, :14] + 0.02 * rng.normal(size=(n, 14))).astype(np.float32)
    U = xu[:n - 1, 14:].copy()
    return X, U, ee[:n].copy(), xu[0, :14].copy()


def knot_schur(X, U, goals, xs, precond=True):
    t = torch.as_tensor
    return form_kkt_schur(iiwa14(device="cpu"), t(X), t(U), t(goals), t(xs),
                          RHO, DT, QD_COST, R_COST, precond=precond)


@pytest.mark.parametrize("precond", [True, False])
def test_k3_plain_matches_jax(iiwa, traj_0_0, precond):
    X, U, goals, xs = problem(traj_0_0)
    kkt = form_kkt(iiwa, X, U, goals, xs, DT, QD_COST, R_COST)
    sd = form_schur(kkt, RHO, preconditioned=precond)
    ks = knot_schur(X, U, goals, xs, precond)
    pairs = [(ks.SL, sd.S.lower), (ks.SD, sd.S.diag), (ks.SU, sd.S.upper),
             (ks.PL, sd.Pinv.lower), (ks.PD, sd.Pinv.diag),
             (ks.PU, sd.Pinv.upper), (ks.gamma, sd.gamma),
             (ks.Qinv, sd.Qinv), (ks.Rinv[:-1], sd.Rinv),
             (ks.A[:-1], kkt.A), (ks.B[:-1], kkt.B), (ks.q, kkt.q),
             (ks.r[:-1], kkt.r)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the last knot has no control: its A, B, Rinv and r rows are zero
    for t in (ks.A, ks.B, ks.Rinv, ks.r):
        assert not t[-1].any()
