"""Port parity for the whole-solve megakernel path: mpcgpu_tpu_torch's
sqp_solve with fused_stages, megakernel and megakernel_solve (on CPU
tensors: K2's plain merit0, then K5's plain version) vs the JAX sqp_solve
with pallas_stages, megakernel and megakernel_solve (the Pallas
whole-solve kernel in interpret mode), as tests/test_megakernel.py:88-125
runs it: N = 4, a perturbed start so the CG iterates, tol 1e-6.

Tolerances: those of tests/test_megakernel.py:115-125 -- X, U at rtol
1e-3, atol 1e-5; lam at rtol 1e-3, atol 1e-4; accepted, sqp_iters and
rho_bailed identical.  CG iteration counts agree within 2 per SQP
iteration (two float32 CG loops, as the port's other CG tests allow).
The final merit, mu times the L1 defects of iterates held at rtol 1e-3,
is held at rtol 1e-3.  Also: the configurations whose kernels are not
ported yet raise, naming the kernel.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.sqp import megakernel_engages, sqp_solve

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 4
T = torch.as_tensor
MEGA = dict(megakernel=True, megakernel_solve=True)


def _start(traj_0_0):
    xu, ee = traj_0_0
    rng = np.random.default_rng(5)
    X = (xu[:N, :14] + 0.02 * rng.normal(size=(N, 14))).astype(np.float32)
    return X, xu[:N - 1, 14:].copy(), ee[:N].copy(), X[0].copy()


def test_megakernel_solve_matches_jax(iiwa, traj_0_0):
    X, U, goals, xs = _start(traj_0_0)
    lam = np.zeros((N, 14), np.float32)
    jcfg = dataclasses.replace(JaxSolverConfig.for_knots(N, sqp_max_iter=3),
                               pallas_stages=True, **MEGA)
    ref = jax_sqp_solve(iiwa, jcfg, jnp.asarray(X), jnp.asarray(U),
                        jnp.asarray(lam), jnp.asarray(goals), jnp.asarray(xs),
                        jnp.asarray(1e-3, jnp.float32), 1e-6, "pcg")
    cfg = SolverConfig.for_knots(N, sqp_max_iter=3, fused_stages=True, **MEGA)
    assert megakernel_engages(cfg, "pcg")
    got = sqp_solve(iiwa14(device="cpu"), cfg, T(X), T(U), T(lam), T(goals),
                    T(xs), 1e-3, 1e-6)

    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               rtol=1e-3, atol=1e-4)
    st, rst = got.stats, ref.stats
    assert int(st.sqp_iters) == int(rst.sqp_iters)
    assert bool(st.rho_bailed) == bool(rst.rho_bailed)
    np.testing.assert_array_equal(st.accepted.numpy(),
                                  np.asarray(rst.accepted))
    its, ref_its = st.pcg_iters.numpy(), np.asarray(rst.pcg_iters)
    assert (its >= 0).all() and (its > 0).any()
    assert np.abs(its - ref_its).max() <= 2, (its, ref_its)
    np.testing.assert_allclose(float(st.final_merit),
                               float(rst.final_merit), rtol=1e-3)


@pytest.mark.parametrize("rho_max", [10.0, 1e-3])
def test_megakernel_path_equals_the_staged_path_on_cpu(traj_0_0, rho_max):
    """K5's plain version is the staged loop over the plain K3, K4 and K2:
    on CPU tensors the two fused paths give the same numbers, bail freeze
    included (rho_max = rho_min bails at the first rejected step)."""
    X, U, goals, xs = (T(a) for a in _start(traj_0_0))
    lam = torch.zeros(N, 14)
    staged = SolverConfig.for_knots(N, sqp_max_iter=6, fused_stages=True,
                                    rho_max=rho_max)
    mega = dataclasses.replace(staged, **MEGA)
    model = iiwa14(device="cpu")
    a = sqp_solve(model, staged, X, U, lam, goals, xs, 1e-3, 1e-6)
    b = sqp_solve(model, mega, X, U, lam, goals, xs, 1e-3, 1e-6)
    for x, y in zip(a[:4], b[:4]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for x, y in zip(a.stats, b.stats):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    if rho_max == 1e-3:
        assert bool(b.stats.rho_bailed) and int(b.stats.sqp_iters) < 6


def test_unported_kernels_raise(traj_0_0):
    X, U, goals, xs = (T(a) for a in _start(traj_0_0))
    args = (X, U, torch.zeros(N, 14), goals, xs, 1e-3, 1e-6)
    model = iiwa14(device="cpu")
    k9 = SolverConfig.for_knots(N, sqp_max_iter=1, fused_stages=True,
                                megakernel=True)
    with pytest.raises(ValueError, match="K9"):
        sqp_solve(model, k9, *args)
    fused = SolverConfig.for_knots(N, sqp_max_iter=1, fused_stages=True)
    for cfg in (fused, dataclasses.replace(fused, **MEGA)):
        with pytest.raises(ValueError, match="K7"):
            sqp_solve(model, cfg, *args, linsys="bcr")
