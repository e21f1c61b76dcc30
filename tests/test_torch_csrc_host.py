"""The CUDA kernels' arithmetic, checked without a GPU.

csrc/*.cu also builds with the host C++ compiler (ops/cuda/_lib.host_library):
every block then runs in turn on the calling thread, on CPU memory.  These
tests drive each kernel's ctypes launch path (the same argument packing as
on the card) through that build and hold the result against the kernel's
plain PyTorch version, at N = 8 from fixture 0_0, with the tolerances of
the JAX package's own kernel tests.  They check the kernels' math and
argument layout, not the CUDA-only parts (warp shuffles, launch limits);
chip_smoke.py checks those on the card.
"""
import shutil

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k6
from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k10
from tests.torch_systems import random_system
from tests.test_torch_kkt_schur import DT, QD_COST, R_COST, RHO, problem

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.as_tensor


@pytest.fixture(scope="module")
def host():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no host C++ compiler")
    model = iiwa14(device="cpu")
    return _lib.host_library(), model, _lib.model_tables(model)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("precond", [True, False])
def test_k3_host_build_matches_plain(host, traj_0_0, precond):
    lib, model, tab = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0))
    want = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                       QD_COST, R_COST, precond=precond)
    got = k3._launch(lib, tab, X, U, goals, torch.tensor(RHO), DT, QD_COST,
                     R_COST, 0.0, precond, None)
    for f in k3.KnotSchur._fields:
        _close(getattr(got, f), getattr(want, f), 3e-3, 3e-3)


@pytest.mark.parametrize("cap,tol", [(300, 1e-9), (40, 5e-5), (3, 1e-12)])
def test_k4_host_build_matches_plain(host, traj_0_0, cap, tol):
    lib, model, _ = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0))
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT, QD_COST,
                                     R_COST)
    lam0 = torch.zeros(X.shape[0], 14)
    want = k4.pcg_dz_reference(ks, lam0, cap, tol)
    got = k4._launch(lib, ks, lam0, cap, tol, None)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 5e-3, 5e-3)
    assert abs(int(got[3]) - int(want[3])) <= 2 or int(got[3]) == int(want[3]) == cap
    assert bool(got[4]) == bool(want[4])


def test_k2_host_build_matches_plain(host, traj_0_0):
    lib, model, tab = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0))
    rng = np.random.default_rng(5)
    dX = T((0.05 * rng.normal(size=tuple(X.shape))).astype(np.float32))
    dU = T((0.05 * rng.normal(size=tuple(U.shape))).astype(np.float32))
    xs = xs + 0.01
    want = k2.line_search_merits_reference(model, X, U, dX, dU, 8, goals, xs,
                                           DT, 10.0, QD_COST, R_COST)
    got = k2._launch(lib, tab, X, U, dX, dU, 8, goals, xs, DT, 10.0, QD_COST,
                     R_COST, 0.0, None)
    _close(got, want, 2e-4, 2e-4)


@pytest.mark.parametrize("offset_us,sim_time_us",
                         [(0.0, 2000.0), (2000.0, 2000.0), (1500.0, 700.0)])
def test_k1_host_build_matches_plain(host, traj_0_0, offset_us, sim_time_us):
    lib, model, tab = host
    xu, ee = traj_0_0
    cfg = SolverConfig.for_knots(16)
    xs, U_prev, goal0 = T(xu[0, :14]), T(xu[:15, 14:].copy()), T(ee[0])
    want = k1.plant_rollout_reference(model, cfg, xs, U_prev, goal0, offset_us,
                                      sim_time_us, 11)
    got = k1._launch(lib, tab, cfg, xs, U_prev, goal0, offset_us, sim_time_us,
                     11, None)
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-5)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("cap,tol", [(40, 5e-5), (20, 1e-10)])
def test_k6_host_build_matches_plain(host, n, cap, tol):
    """On the JAX BCR tests' well-conditioned random system: lam scaled by
    its largest entry at atol 2e-5, dX and dU at atol 2e-4, rtol 1e-3
    (tests/test_bcr.py:62-74), CG iterations within 1."""
    lib = host[0]
    ks = k3.KnotSchur(**{f: T(v) for f, v in random_system(n).items()})
    lam0 = T(np.random.default_rng(3).normal(size=(n, 14)).astype(np.float32))
    want = k6.bcr_pcg_dz_reference(ks, lam0, cap, tol)
    got = k6._launch(lib, ks, lam0, cap, tol, None)
    scale = want[0].abs().max()
    _close(got[0] / scale, want[0] / scale, 0, 2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        _close(g, w, 1e-3, 2e-4)
    assert abs(int(got[3]) - int(want[3])) <= 1
    assert bool(got[4]) == bool(want[4])


def test_k6_host_build_residual_on_the_fixture_system(host, traj_0_0):
    """On fixture 0_0's rho = 1e-3 system (condition ~1e7) the two float32
    solves differ by up to ~1e-3 of lam's largest entry, as the plain one
    differs from a float64 solve; both are judged by residual: each
    within 1e-3 of |gamma|, and the CG iterations within 1."""
    lib, model, _ = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0, n=16))
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                     QD_COST, R_COST, precond=False)
    lam0 = torch.zeros(16, 14)
    want = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
    got = k6._launch(lib, ks, lam0, 40, 5e-5, None)
    S = BlockTri(ks.SL, ks.SD, ks.SU)
    for lam in (got[0], want[0]):
        res = (spmv(S, lam) - ks.gamma).abs().max() / ks.gamma.abs().max()
        assert float(res) < 1e-3
    assert abs(int(got[3]) - int(want[3])) <= 1


@pytest.mark.parametrize("n,tol,rho_max", [(4, 1e-6, 10.0), (8, 5e-5, 10.0),
                                           (8, 5e-5, 1e-3)])
def test_k5_host_build_matches_plain(host, traj_0_0, n, tol, rho_max):
    """The whole solve through the host build (one block walks every
    knot, the grid barriers are no-ops) against the staged plain loop,
    perturbed start, 5 SQP iterations; rho_max = rho_min bails at the
    first rejected step.  Tolerances of tests/test_megakernel.py:115-125:
    X, U at rtol 1e-3, atol 1e-5; lam at rtol 1e-3, atol 1e-4; decisions
    identical; CG iterations within 2 per SQP iteration.  Tight exit
    tolerances only at N = 4: where both CG loops stop at the cap
    unconverged, their float32 sums in different orders part by more."""
    lib, model, tab = host
    xu, ee = traj_0_0
    rng = np.random.default_rng(5)
    X = T((xu[:n, :14] + 0.02 * rng.normal(size=(n, 14))).astype(np.float32))
    U, goals = T(xu[:n - 1, 14:].copy()), T(ee[:n].copy())
    xs, lam0, rho = X[0].clone(), torch.zeros(n, 14), torch.tensor(1e-3)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=rho_max,
              rho_reset=1e-3)
    merit0 = k2.line_search_merits_reference(
        model, X, U, torch.zeros_like(X), torch.zeros_like(U), 8, goals, xs,
        DT, 10.0, QD_COST, R_COST)[8]
    args = (X, U, goals, xs, lam0, rho, 1.0, merit0, 40, tol, 5)
    want = k5.sqp_solve_mega_pcg_reference(model, *args, **kw)
    assert k5.check_mega_fit(n, lib) == 1
    got = k5._launch(lib, tab, *args, grid=1, stream=None, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    for f in ("rho", "drho"):
        _close(getattr(got, f), getattr(want, f), 1e-6, 0)
    for f in ("sqp_iters", "bailed", "hit_max", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    its, want_its = got.pcg_iters, want.pcg_iters
    assert torch.equal(its < 0, want_its < 0)
    assert int((its - want_its).abs().max()) <= 2
    if rho_max == 1e-3:
        assert bool(got.bailed) and int(got.sqp_iters) < 5


@pytest.mark.parametrize("rho", [0.1, 0.3])
def test_k5_host_build_exits_the_cg_early_like_plain(host, traj_0_0, rho):
    """The slice's N = 64 start (fixture 0_0, knot 0 kept, the rest
    perturbed), cap 40, tol 5e-5, 4 SQP iterations, at a rho the schedule
    reaches after rejected steps, where CGs exit before the cap: decisions
    identical, CG iterations within 2, at least one early exit; X, U at
    rtol 1e-3, atol 1e-5, lam at rtol 1e-3, atol 1e-4
    (tests/test_megakernel.py:115-125)."""
    lib, model, tab = host
    xu, ee = traj_0_0
    n = 64
    pert = 0.02 * np.random.default_rng(5).normal(size=(n, 14))
    pert[0] = 0.0
    X = T((xu[:n, :14] + pert).astype(np.float32))
    U, goals, xs = T(xu[:n - 1, 14:].copy()), T(ee[:n].copy()), T(xu[0, :14])
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)
    merit0 = k2.line_search_merits_reference(
        model, X, U, torch.zeros_like(X), torch.zeros_like(U), 8, goals, xs,
        DT, 10.0, QD_COST, R_COST)[8]
    args = (X, U, goals, xs, torch.zeros(n, 14), torch.tensor(rho), 1.0,
            merit0, 40, 5e-5, 4)
    want = k5.sqp_solve_mega_pcg_reference(model, *args, **kw)
    got = k5._launch(lib, tab, *args, grid=1, stream=None, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    for f in ("sqp_iters", "bailed", "hit_max", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    its, want_its = got.pcg_iters, want.pcg_iters
    assert int((its - want_its).abs().max()) <= 2
    assert bool(((want_its >= 0) & (want_its < 40)).any())


def _arms(traj_0_0, n, b, seed):
    """b arms from seeded perturbations of fixture 0_0's first n knots."""
    xu, ee = traj_0_0
    rng = np.random.default_rng(seed)
    X = T(np.stack([xu[:n, :14] + 0.02 * rng.normal(size=(n, 14))
                    for _ in range(b)]).astype(np.float32))
    U = T(np.stack([xu[:n - 1, 14:]] * b).astype(np.float32))
    return X, U, T(ee[:n].copy()).expand(b, n, 6), X[:, 0].clone()


@pytest.mark.parametrize("n,rhos,tol,rho_max,seed", [
    # arms 0 and 1 from rho 1e-3 and 0.1, CGs at the cap and before it
    (8, (1e-3, 0.1), 5e-5, 10.0, 5),
    # three arms whose lone CGs stop at different counts (the shared exit)
    (4, (0.02, 0.1, 0.3), 1e-4, 10.0, 7),
    # arm 1 starts above rho_max = 0.05 and bails at its first rejected
    # step (iteration 2) while arm 0 stays live through all 5
    (4, (1e-3, 0.1), 1e-4, 0.05, 6),
])
def test_k10_host_build_matches_plain(host, traj_0_0, n, rhos, tol, rho_max,
                                      seed):
    """The arm-packed whole solve through the host build (one block owns
    every arm's CG and walks every (arm, knot) pair; the grid barriers,
    the shared exit's among them, are no-ops) against its plain version,
    5 SQP iterations.  Tolerances of tests/test_megakernel.py:225-240: X,
    U at rtol 1e-3, atol 1e-5; lam at rtol 1e-3, atol 1e-4; rho at rtol
    1e-6; merit at rtol 1e-3 (the port's megakernel test); sqp_iters,
    bails and the shared CG count equal."""
    lib, model, tab = host
    b = len(rhos)
    X, U, goals, xs = _arms(traj_0_0, n, b, seed)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=rho_max,
              rho_reset=1e-3)
    args = (X, U, goals, xs, torch.zeros(b, n, 14), torch.tensor(rhos),
            torch.ones(b), 40, tol, 5)
    want = k10.sqp_solve_mega_pcg_packed_reference(model, *args, **kw)
    assert k10.check_mega_packed_fit(n, b, 8, lib) == 1
    got = k10._launch_packed(lib, tab, *args, grid=1, stream=None, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    _close(got.rho, want.rho, 1e-6, 0)
    _close(got.merit, want.merit, 1e-3, 0)
    for f in ("sqp_iters", "bailed", "pcg_iters_total"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if rho_max == 0.05:
        assert got.bailed.tolist() == [False, True]
        assert got.sqp_iters.tolist() == [5, 2]


def test_k10_host_build_takes_shared_goals(host, traj_0_0):
    """Goals expanded over the arms (arm stride 0) and a copy per arm give
    the same solve."""
    lib, model, tab = host
    X, U, goals, xs = _arms(traj_0_0, 4, 2, 3)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)
    rest = (xs, torch.zeros(2, 4, 14), torch.tensor([1e-3, 0.1]),
            torch.ones(2), 40, 1e-4, 3)
    a = k10._launch_packed(lib, tab, X, U, goals, *rest, grid=1, stream=None,
                           **kw)
    b = k10._launch_packed(lib, tab, X, U, goals.contiguous(), *rest, grid=1,
                           stream=None, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b", [2, 3])
def test_k1_arm_batched_host_build_equals_single_launches(host, traj_0_0, b):
    """One arm-batched K1 launch (a block per arm) against B single K1
    launches: bit-equal, the same per-arm arithmetic in the same order;
    and within K1's tolerance of the plain version over the arm axis."""
    lib, model, tab = host
    cfg = SolverConfig.for_knots(16)
    X, U, goals, xs = _arms(traj_0_0, 16, b, 4)
    goal0 = goals[0, 0].contiguous()
    got = k1._launch(lib, tab, cfg, xs, U, goal0, 2000.0, 2000.0, 11, None)
    for a in range(b):
        one = k1._launch(lib, tab, cfg, xs[a].contiguous(), U[a].contiguous(),
                         goal0, 2000.0, 2000.0, 11, None)
        assert torch.equal(got[0][a], one[0]) and torch.equal(got[1][a], one[1])
    want = k1.plant_rollout_reference(model, cfg, xs, U, goal0, 2000.0,
                                      2000.0, 11)
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-5)


def test_packed_loop_through_the_host_build(host, traj_0_0, monkeypatch):
    """simulate_mpc_scan_packed with fused_stages, its K10 and arm-batched
    K1 calls sent through the host build's launch paths (the card's
    argument packing, shapes and contiguity checks), against the same loop
    on the plain versions: sqp_iters, bails and the shared CG counts
    equal, tracking errors and final states within 1e-4."""
    import dataclasses

    from mpcgpu_tpu_torch import sim

    lib, model, tab = host
    xu, ee = traj_0_0
    n = 4
    cfg = SolverConfig.for_knots(n, sqp_max_iter=3)
    dq = T(np.random.default_rng(11).normal(size=(2, 7)).astype(np.float32))
    X, U, lam = sim.arm_starts(T(xu[:n, :14]), T(xu[:n - 1, 14:].copy()),
                               torch.zeros(n, 14), 0.02 * dq)
    args = (model, None, T(xu), T(ee), X, U, lam, 1e-3, 1e-4, 3)
    want = sim.simulate_mpc_scan_packed(*args[:1], cfg, *args[2:])
    monkeypatch.setattr(
        sim, "sqp_solve_mega_pcg_packed",
        lambda model, *a, **kw: k10._launch_packed(lib, tab, *a, grid=1,
                                                   stream=None, **kw))
    monkeypatch.setattr(
        sim, "plant_rollout",
        lambda model, cfg, *a: k1._launch(lib, tab, cfg, *a, None))
    fused = dataclasses.replace(cfg, fused_stages=True)
    got = sim.simulate_mpc_scan_packed(*args[:1], fused, *args[2:])
    for k in ("sqp_iters", "rho_bailed", "pcg_iters_total", "shifted"):
        assert torch.equal(got[k], want[k]), k
    for k in ("tracking_errors", "final_xs"):
        _close(got[k], want[k], 0, 1e-4)
