"""Port parity for the megakernel paths of mpcgpu_tpu_torch's sqp_solve
(fused_stages and megakernel; on CPU tensors K2's plain merit0, then the
kernels' plain versions).

The whole solve (megakernel_solve, K5) against the JAX sqp_solve with
pallas_stages, megakernel and megakernel_solve (the Pallas whole-solve
kernel in interpret mode), as tests/test_megakernel.py:88-125 runs it:
N = 4, a perturbed start so the CG iterates, tol 1e-6.  Tolerances: those
of tests/test_megakernel.py:115-125 -- X, U at rtol 1e-3, atol 1e-5; lam
at rtol 1e-3, atol 1e-4; accepted, sqp_iters and rho_bailed identical.
CG iteration counts agree within 2 per SQP iteration (two float32 CG
loops, as the port's other CG tests allow).  The final merit, mu times
the L1 defects of iterates held at rtol 1e-3, is held at rtol 1e-3.

The per-iteration loop (no megakernel_solve: K9p for "pcg", K9b for
"bcr") against the port's staged fused path bit for bit, and K9p's
against the JAX sqp_solve at N = 4 from the same start, with the stats
arrays equal and the whole-solve test's tolerances above (K9b's staged
twin, fused "bcr", is held against the JAX "bcr" loop in
tests/test_torch_closed_loop.py; a JAX "bcr" compile here would cost
another 25 s); the "pcg_pallas" backend
(the plain stages, K4b's plain version) against the same JAX "pcg" solve
at the tolerances of the port's closed-loop tests (X, U at atol 5e-3,
tests/test_merit_pallas.py:60-61; decisions equal; CG counts within 2):
JAX's pcg_pallas is its pcg in one kernel (tests/test_pcg_pallas.py), and
one JAX compile serves both tests.  The JAX side runs its
portable stages: its staged fused path (pallas_stages, no megakernel)
costs 62 s of interpret-mode compiles at N = 4, and JAX's own tests
hold the two equal.  The tolerances of
tests/test_megakernel.py:37-45,72-85 (X, U at rtol 1e-5, atol 1e-6) hold
one arithmetic against itself; two implementations part by float32
rounding (measured 1.4e-5 in X here), as for K5.
Also: the configurations the port refuses raise, saying why.
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


@pytest.mark.parametrize("linsys", ["pcg", "bcr"])
@pytest.mark.parametrize("rho_max", [10.0, 1e-3])
def test_per_iteration_megakernel_equals_the_staged_path_on_cpu(
        traj_0_0, linsys, rho_max):
    """K9p's and K9b's plain versions are one iteration of the staged
    loop over the plain K3, K4 / K7 and K2: on CPU tensors the
    per-iteration loop gives the staged fused path's numbers, bail
    freeze included (rho_max = rho_min bails at the first rejected
    step)."""
    X, U, goals, xs = (T(a) for a in _start(traj_0_0))
    lam = torch.zeros(N, 14)
    staged = SolverConfig.for_knots(N, sqp_max_iter=6, fused_stages=True,
                                    rho_max=rho_max)
    model = iiwa14(device="cpu")
    a = sqp_solve(model, staged, X, U, lam, goals, xs, 1e-3, 1e-6, linsys)
    for mk in (dict(megakernel=True), MEGA):
        cfg = dataclasses.replace(staged, **mk)
        if linsys == "pcg" and cfg.megakernel_solve:
            continue   # K5, above
        assert megakernel_engages(cfg, linsys)
        b = sqp_solve(model, cfg, X, U, lam, goals, xs, 1e-3, 1e-6, linsys)
        for x, y in zip(list(a[:4]) + list(a.stats),
                        list(b[:4]) + list(b.stats)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    its = b.stats.pcg_iters
    ran = its >= 0
    assert (its[ran] == 0).all() if linsys == "bcr" else (its[ran] > 0).any()
    if rho_max == 1e-3 and linsys == "pcg":   # bcr rejects no step here
        assert bool(b.stats.rho_bailed) and int(b.stats.sqp_iters) < 6
        assert (its[int(b.stats.sqp_iters):] == -1).all()


@pytest.fixture(scope="module")
def jax_pcg_solve(iiwa, traj_0_0):
    """The JAX sqp_solve with "pcg" at N = 4, 2 SQP iterations, tol 1e-6,
    from _start: compiled and run once for the two tests below."""
    X, U, goals, xs = (jnp.asarray(a) for a in _start(traj_0_0))
    return jax_sqp_solve(iiwa, JaxSolverConfig.for_knots(N, sqp_max_iter=2),
                         X, U, jnp.zeros((N, 14), jnp.float32), goals, xs,
                         jnp.asarray(1e-3, jnp.float32), 1e-6, "pcg")


def test_per_iteration_megakernel_matches_jax(traj_0_0, jax_pcg_solve):
    X, U, goals, xs = _start(traj_0_0)
    lam = np.zeros((N, 14), np.float32)
    ref = jax_pcg_solve
    cfg = SolverConfig.for_knots(N, sqp_max_iter=2, fused_stages=True,
                                 megakernel=True)
    got = sqp_solve(iiwa14(device="cpu"), cfg, T(X), T(U), T(lam), T(goals),
                    T(xs), 1e-3, 1e-6, "pcg")
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               rtol=1e-3, atol=1e-4)
    st, rst = got.stats, ref.stats
    for f in ("pcg_iters", "pcg_hit_max", "accepted", "sqp_iters",
              "rho_bailed"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(rst, f)), err_msg=f)
    np.testing.assert_allclose(float(st.final_merit), float(rst.final_merit),
                               rtol=1e-3)


def test_pcg_pallas_backend_matches_jax(traj_0_0, jax_pcg_solve):
    X, U, goals, xs = (T(a) for a in _start(traj_0_0))
    ref = jax_pcg_solve
    cfg = SolverConfig.for_knots(N, sqp_max_iter=2)
    model = iiwa14(device="cpu")
    got = sqp_solve(model, cfg, X, U, torch.zeros(N, 14), goals, xs, 1e-3,
                    1e-6, "pcg_pallas")
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), atol=5e-3)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), atol=5e-3)
    np.testing.assert_array_equal(got.stats.accepted.numpy(),
                                  np.asarray(ref.stats.accepted))
    assert int(got.stats.sqp_iters) == int(ref.stats.sqp_iters)
    its, ref_its = got.stats.pcg_iters.numpy(), np.asarray(ref.stats.pcg_iters)
    assert (its > 0).any() and np.abs(its - ref_its).max() <= 2
    # fused, the configuration runs K4 under this name, as the JAX package
    fused = dataclasses.replace(cfg, fused_stages=True)
    via_k4 = sqp_solve(model, fused, X, U, torch.zeros(N, 14), goals, xs,
                       1e-3, 1e-6, "pcg_pallas")
    np.testing.assert_array_equal(via_k4.stats.pcg_iters.numpy(), its)


def test_unserved_configurations_raise(traj_0_0):
    """What the port refuses, each with its reason: fused dense and qdldl
    (the JAX package runs its PCG kernel under those names), the BCR
    kernels at a non-power-of-2 horizon, and an arm axis with a backend
    other than pcg."""
    X, U, goals, xs = (T(a) for a in _start(traj_0_0))
    args = (X, U, torch.zeros(N, 14), goals, xs, 1e-3, 1e-6)
    model = iiwa14(device="cpu")
    fused = SolverConfig.for_knots(N, sqp_max_iter=1, fused_stages=True)
    for linsys in ("dense", "qdldl"):
        for cfg in (fused, dataclasses.replace(fused, **MEGA)):
            with pytest.raises(ValueError, match="PCG kernel under that name"):
                sqp_solve(model, cfg, *args, linsys=linsys)
    n = 6
    X6, U6, goals6 = (torch.cat([t, t[-2:]])[:n] for t in (X, U, goals))
    args6 = (X6, U6[:n - 1], torch.zeros(n, 14), goals6, xs, 1e-3, 1e-6)
    fused6 = SolverConfig.for_knots(n, sqp_max_iter=1, fused_stages=True)
    for cfg in (fused6, dataclasses.replace(fused6, megakernel=True)):
        for linsys in ("bcr", "bcr_pcg"):
            with pytest.raises(ValueError, match="power-of-2"):
                sqp_solve(model, cfg, *args6, linsys=linsys)
    with pytest.raises(ValueError, match="power-of-2"):
        sqp_solve(model, dataclasses.replace(fused6, fused_stages=False),
                  *args6, linsys="bcr")
    arms = (X.expand(2, N, 14), U.expand(2, N - 1, 7),
            torch.zeros(2, N, 14), goals, xs.expand(2, 14), 1e-3, 1e-6)
    plain = dataclasses.replace(fused, fused_stages=False)
    for linsys in ("bcr", "dense", "qdldl", "pcg_pallas"):
        with pytest.raises(ValueError, match="arm axis"):
            sqp_solve(model, plain, *arms, linsys=linsys)
