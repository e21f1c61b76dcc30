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
from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k7
from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k9
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k10
from tests.torch_systems import (bcr_iteration_given_lam, random_knot_schur,
                                 random_system, relative_residual)
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


@pytest.mark.parametrize("n", [16, 256])
def test_k6l_host_build_matches_plain(host, n):
    """K6l (S read from global memory) on the random system at K6's
    tolerances (tests/test_bcr.py:62-74), and at N = 16 against K6 on the
    same inputs: the same body, bit for bit."""
    lib = host[0]
    ks = random_knot_schur(n, seed=7)
    lam0 = T(np.random.default_rng(3).normal(size=(n, 14)).astype(np.float32))
    want = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
    got = k6._launch(lib, ks, lam0, 40, 5e-5, None, l2=True)
    scale = want[0].abs().max()
    _close(got[0] / scale, want[0] / scale, 0, 2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        _close(g, w, 1e-3, 2e-4)
    assert abs(int(got[3]) - int(want[3])) <= 1
    assert bool(got[4]) == bool(want[4])
    if n <= lib.mpc_bcr_max_knots():
        for g, w in zip(got, k6._launch(lib, ks, lam0, 40, 5e-5, None)):
            assert torch.equal(g, w)


def test_k6l_host_build_residual_on_the_long_fixture_system(host, traj_0_0):
    """N = 256, fixture 0_0's system without the stair at rho 1e-3 and the
    long horizons' r_cost, cap 24, tol 1e-5 (the forced failover's solve
    at that horizon): judged by residual as K6 on the fixture system, each
    solve within 1e-3 of |gamma|; CG iterations within 1."""
    lib, model, _ = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0, n=256))
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                     QD_COST, LONG_R_COST, precond=False)
    lam0 = torch.zeros(256, 14)
    want = k6.bcr_pcg_dz_reference(ks, lam0, 24, 1e-5)
    got = k6._launch(lib, ks, lam0, 24, 1e-5, None, l2=True)
    S = BlockTri(ks.SL, ks.SD, ks.SU)
    for lam in (got[0], want[0]):
        res = (spmv(S, lam) - ks.gamma).abs().max() / ks.gamma.abs().max()
        assert float(res) < 1e-3
    assert abs(int(got[3]) - int(want[3])) <= 1


def test_bcr_pcg_dz_takes_k6_then_k6l_then_the_split_path(host):
    """bcr_pcg_dz's dispatch through the host build (fits: K6 N <= 64, K6l
    N <= 512, the card's arithmetic at 227 KB): K6 at N = 64, K6l at
    N = 128, and past K6l's fit (a library reporting it as 64) the split
    path, which launches neither."""
    from mpcgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    lib = host[0]
    assert (lib.mpc_bcr_max_knots(), lib.mpc_bcr_l2_max_knots()) == (64, 512)

    class SmallL2:
        def mpc_bcr_max_knots(self):
            return 64

        def mpc_bcr_l2_max_knots(self):
            return 64

    for n, use, want in ((64, lib, "K6"), (128, lib, "K6l"),
                         (128, SmallL2(), None)):
        ks = random_knot_schur(n, seed=7)
        lam0 = torch.zeros(n, 14)
        reset_launch_counts()
        got = k6._bcr_pcg_dz_on(use, ks, lam0, 40, 5e-5, None, None)
        counts = {k: c for k, c in launch_counts().items() if c}
        assert counts == ({want: 1} if want else {}), n
        ref = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
        scale = ref[0].abs().max()
        _close(got[0] / scale, ref[0] / scale, 0, 2e-5)


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


@pytest.mark.parametrize("cap,tol", [(300, 1e-9), (40, 5e-5), (3, 1e-12)])
def test_k4b_host_build_matches_plain(host, traj_0_0, cap, tol):
    """K4's tolerances: lam at rtol 5e-3, atol 5e-3; CG counts within 2 or
    both at the cap; the same hit flag."""
    lib, model, _ = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0))
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT, QD_COST,
                                     R_COST)
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    lam0 = torch.zeros(X.shape[0], 14)
    want = k4.pcg_solve_reference(S, P, ks.gamma, lam0, cap, tol)
    got = k4._launch_solve(lib, S, P, ks.gamma, lam0, cap, tol, None)
    _close(got[0], want[0], 5e-3, 5e-3)
    assert abs(int(got[1]) - int(want[1])) <= 2 or int(got[1]) == int(want[1]) == cap
    assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("n", [8, 16])
def test_k7_and_k7s_host_build_match_plain(host, n):
    """On the JAX BCR tests' random system: lam scaled by its largest
    entry at atol 2e-5, dX and dU at rtol 1e-3, atol 2e-4
    (tests/test_bcr.py:62-74); K7 reports 0 iterations and no hit."""
    lib = host[0]
    ks = random_knot_schur(n)
    want = k7.bcr_dz_reference(ks)
    got = k7._launch_dz(lib, ks, None)
    scale = want[0].abs().max()
    _close(got[0] / scale, want[0] / scale, 0, 2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        _close(g, w, 1e-3, 2e-4)
    assert int(got[3]) == 0 and not bool(got[4])
    want_s = k7.bcr_solve_reference(ks.SL, ks.SD, ks.SU, ks.gamma)
    got_s = k7._launch_solve(lib, ks.SL, ks.SD, ks.SU, ks.gamma, None)
    _close(got_s / want_s.abs().max(), want_s / want_s.abs().max(), 0, 2e-5)


def test_k7_host_build_residual_on_the_fixture_system(host, traj_0_0):
    """Fixture 0_0's rho = 1e-3 system without the stair (condition ~1e7):
    K7's relative residual within 1e-5 (the plain refined solve's is
    about 1e-6 there)."""
    lib, model, _ = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0, n=16))
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                     QD_COST, R_COST, precond=False)
    assert relative_residual(ks, k7._launch_dz(lib, ks, None)[0]) < 1e-5
    assert relative_residual(ks, k7.bcr_dz_reference(ks)[0]) < 1e-5


def test_split_paths_through_the_host_build_match_the_one_block_kernels(host):
    """N = 16, forced split: K7s twice with the residual between against
    K7, and the CG glue with K7s applies against K6, both through the
    host build: lam scaled at atol 2e-5, dz at rtol 1e-3, atol 2e-4, CG
    counts within 1."""
    lib = host[0]
    ks = random_knot_schur(16, seed=7)
    solve = lambda rhs: k7._launch_solve(lib, ks.SL, ks.SD, ks.SU, rhs, None)
    lam0 = T(np.random.default_rng(3).normal(size=(16, 14)).astype(np.float32))
    pairs = ((k7.bcr_dz_split(ks, solve), k7._launch_dz(lib, ks, None)),
             (k7.bcr_pcg_dz_split(ks, lam0, 40, 5e-5, solve),
              k6._launch(lib, ks, lam0, 40, 5e-5, None)))
    for got, want in pairs:
        scale = want[0].abs().max()
        _close(got[0] / scale, want[0] / scale, 0, 2e-5)
        for g, w in zip(got[1:3], want[1:3]):
            _close(g, w, 1e-3, 2e-4)
        assert abs(int(got[3]) - int(want[3])) <= 1
        assert bool(got[4]) == bool(want[4])


def _k9_start(traj_0_0, n, rho):
    xu, ee = traj_0_0
    pert = 0.02 * np.random.default_rng(5).normal(size=(n, 14))
    pert[0] = 0.0
    X = T((xu[:n, :14] + pert).astype(np.float32))
    return X, T(xu[:n - 1, 14:].copy()), T(ee[:n].copy()), T(xu[0, :14])


@pytest.mark.parametrize("rho,rho_max", [(1e-3, 10.0), (0.1, 10.0),
                                         (0.3, 0.3)])
def test_k9p_host_build_matches_plain(host, traj_0_0, rho, rho_max):
    """One K9p launch against one staged plain iteration, N = 8, cold
    duals, drho 1.3 and the incumbent merit from device memory: X, U at
    rtol 1e-3, atol 1e-5 and lam at rtol 1e-3, atol 1e-4
    (tests/test_megakernel.py:115-125); rho, drho at rtol 1e-6; accept,
    bail and hit equal; CG counts within 2.  rho_max = rho bails on a
    rejected step."""
    lib, model, tab = host
    n = 8
    X, U, goals, xs = _k9_start(traj_0_0, n, rho)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=rho_max,
              rho_reset=1e-3)
    merit = k2.line_search_merits_reference(
        model, X, U, torch.zeros_like(X), torch.zeros_like(U), 8, goals, xs,
        DT, 10.0, QD_COST, R_COST)[8]
    args = (X, U, goals, xs, torch.zeros(n, 14), torch.tensor(rho),
            torch.tensor(1.3), merit * (0.5 if rho_max == rho else 1.0))
    want = k9.sqp_iter_mega_pcg_reference(model, *args, 40, 5e-5, **kw)
    assert k9.check_mega_fit(n, lib, k9.ITER_PCG) == 1
    got = k9._launch_iter(lib, k9.ITER_PCG, tab, *args, 40, 5e-5, **kw,
                          grid=1, stream=None)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    for f in ("rho", "drho", "merit"):
        _close(getattr(got, f), getattr(want, f), 1e-6 if f != "merit"
               else 1e-3, 0)
    for f in ("accept", "bail", "hit_max"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert abs(int(got.pcg_iters) - int(want.pcg_iters)) <= 2
    if rho_max == rho:
        assert not bool(got.accept) and bool(got.bail)
        assert torch.equal(got.X, X) and float(got.rho) == pytest.approx(1e-3)


@pytest.mark.parametrize("rho", [1e-3, 0.1])
def test_k9b_host_build_matches_plain(host, traj_0_0, rho):
    """One K9b launch, N = 8: against the independent plain iteration,
    accept and bail equal, X and U at rtol 1e-3, atol 1e-5, CG count 0;
    lam by relative residual on S(X), within 1e-5; and against the plain
    iteration given the kernel's own lam (tests/torch_systems.py), X, U
    and merit at rtol 1e-3, atol 1e-5."""
    lib, model, tab = host
    n = 8
    X, U, goals, xs = _k9_start(traj_0_0, n, rho)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)
    merit = k2.line_search_merits_reference(
        model, X, U, torch.zeros_like(X), torch.zeros_like(U), 8, goals, xs,
        DT, 10.0, QD_COST, R_COST)[8]
    args = (X, U, goals, xs, torch.tensor(rho), torch.tensor(1.0), merit)
    want = k9.sqp_iter_mega_reference(model, *args, **kw)
    assert k9.check_mega_fit(n, lib, k9.ITER_BCR) == 1
    got = k9._launch_iter(lib, k9.ITER_BCR, tab, *args[:4], None, *args[4:],
                          0, 0.0, **kw, grid=1, stream=None)
    for f in ("accept", "bail", "hit_max", "pcg_iters"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    given, ks = bcr_iteration_given_lam(model, *args, got.lam, **kw)
    assert relative_residual(ks, got.lam) < 1e-5
    for f in ("X", "U", "merit", "rho", "drho"):
        _close(getattr(got, f), getattr(given, f), 1e-3, 1e-5)


def test_k9b_rejects_non_power_of_two(host, traj_0_0):
    lib, model, tab = host
    X, U, goals, xs = _k9_start(traj_0_0, 6, 1e-3)
    one = torch.tensor(1.0)
    with pytest.raises(ValueError, match="power-of-2"):
        k9._launch_iter(lib, k9.ITER_BCR, tab, X, U, goals, xs, None, one,
                        one, one, 0, 0.0, DT, QD_COST, R_COST, 0.0, 10.0, 8,
                        1.2, 1e-3, 10.0, 1e-3, grid=1, stream=None)


@pytest.mark.parametrize("linsys", ["pcg", "bcr"])
def test_per_iteration_loop_through_the_host_build(host, traj_0_0, linsys,
                                                   monkeypatch):
    """sqp_solve with megakernel and without megakernel_solve, its K9p /
    K9b launches sent through the host build (the card's argument
    packing, the device scalars of drho and the merit, the bail mask),
    against the same solve on the plain versions at N = 8, 4 SQP
    iterations, a bailing rho_max: sqp_iters, accepted, bailed and the CG
    counts (within 2 each) as the plain solve's, X and U at rtol 1e-3,
    atol 1e-5 for pcg; for bcr, whose exact solves part by float32
    rounding on this system, X and U within 1e-3."""
    import dataclasses

    from mpcgpu_tpu_torch import sqp

    lib, model, tab = host
    n = 8
    X, U, goals, xs = _k9_start(traj_0_0, n, 1e-3)
    cfg = SolverConfig.for_knots(n, sqp_max_iter=4, fused_stages=True,
                                 megakernel=True, rho_max=2e-3)
    cfg = dataclasses.replace(cfg, pcg=dataclasses.replace(cfg.pcg,
                                                           max_iter=40))
    args = (model, cfg, X, U, torch.zeros(n, 14), goals, xs, 1e-3, 5e-5,
            linsys)
    want = sqp.sqp_solve(*args)
    kinds = {"pcg": k9.ITER_PCG, "bcr": k9.ITER_BCR}

    def launch(model, X, U, goals, xs, *a, **kw):
        if linsys == "bcr":
            a = (None,) + a[:3] + (0, 0.0) + a[3:]
        return k9._launch_iter(lib, kinds[linsys], tab, X, U, goals, xs, *a,
                               grid=1, stream=None, **kw)

    monkeypatch.setattr(sqp, {"pcg": "sqp_iter_mega_pcg",
                              "bcr": "sqp_iter_mega"}[linsys], launch)
    got = sqp.sqp_solve(*args)
    for f in ("sqp_iters", "accepted", "rho_bailed", "pcg_hit_max"):
        assert torch.equal(getattr(got.stats, f), getattr(want.stats, f)), f
    its, want_its = got.stats.pcg_iters, want.stats.pcg_iters
    assert torch.equal(its < 0, want_its < 0)
    assert int((its - want_its).abs().max()) <= 2
    tol = (1e-3, 1e-5) if linsys == "pcg" else (0, 1e-3)
    _close(got.X, want.X, *tol)
    _close(got.U, want.U, *tol)


# ---- the grid-wide CG forms (K4g, K4bg, K5g, K9pg) at long horizons: the
# host build runs one block over every knot (a cooperative grid of one),
# so the per-knot dot slots and their sums are checked, not the barriers
LONG_R_COST = 1e-4   # CostConfig.for_knots(N) at N != 64


def _long_system(model, traj_0_0, n, system):
    if system == "random":
        return random_knot_schur(n)
    X, U, goals, xs = (T(a) for a in problem(traj_0_0, n=n))
    return k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                       QD_COST, LONG_R_COST)


@pytest.mark.parametrize("n,system,cap,tol", [
    # fixture 0_0's system at the long horizons' cap and exit tol: every CG
    # at the cap
    (128, "fixture", 24, 1e-5), (256, "fixture", 24, 1e-5),
    # the seeded well-conditioned system: the CGs exit before the cap
    (128, "random", 300, 1e-9), (256, "random", 300, 1e-9)])
def test_k4g_and_k4bg_host_build_match_plain(host, traj_0_0, n, system, cap,
                                             tol):
    """K4's tolerances: lam, dX, dU at rtol 5e-3, atol 5e-3; CG counts
    within 2 or both at the cap; the same hit flag."""
    lib, model, _ = host
    ks = _long_system(model, traj_0_0, n, system)
    lam0 = torch.zeros(n, 14)
    want = k4.pcg_dz_reference(ks, lam0, cap, tol)
    assert k4.check_pcg_grid_fit(n, lib) == 1
    got = k4._launch_grid(lib, ks, lam0, cap, tol, True, 1, None)
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    want_b = k4.pcg_solve_reference(S, P, ks.gamma, lam0, cap, tol)
    got_b = k4._launch_grid(lib, ks, lam0, cap, tol, False, 1, None)
    pairs = ((got[:3], want[:3], got[3:], want[3:]),
             (got_b[:1], want_b[:1], got_b[1:], want_b[1:]))
    for vals, want_vals, (it, hit), (it_ref, hit_ref) in pairs:
        for g, w in zip(vals, want_vals):
            _close(g, w, 5e-3, 5e-3)
        assert abs(int(it) - int(it_ref)) <= 2 or int(it) == int(it_ref) == cap
        assert bool(hit) == bool(hit_ref)
    if system == "random":
        assert int(want[3]) < cap


def _long_kw(rho_max=10.0):
    return dict(dt=DT, qd_cost=QD_COST, r_cost=LONG_R_COST, gravity=0.0,
                mu=10.0, num_alphas=8, rho_factor=1.2, rho_min=1e-3,
                rho_max=rho_max, rho_reset=1e-3)


def _merit0(model, X, U, goals, xs):
    return k2.line_search_merits_reference(
        model, X, U, torch.zeros_like(X), torch.zeros_like(U), 8, goals, xs,
        DT, 10.0, QD_COST, LONG_R_COST)[8]


@pytest.mark.parametrize("rho", [1e-3, 0.3])
def test_k5g_host_build_matches_plain(host, traj_0_0, rho):
    """K5g at N = 128 (the slice's start, knot 0 kept, the rest perturbed),
    cap 24, tol 1e-5, 4 SQP iterations, against its plain version at the
    tolerances of tests/test_torch_megakernel.py:77-82: X, U at rtol 1e-3,
    atol 1e-5; lam at rtol 1e-3, atol 1e-4; decisions identical; CG
    counts within 2.  At rho 0.3 a CG exits before the cap."""
    lib, model, tab = host
    n = 128
    X, U, goals, xs = _k9_start(traj_0_0, n, None)
    kw = _long_kw()
    args = (X, U, goals, xs, torch.zeros(n, 14), torch.tensor(rho), 1.0,
            _merit0(model, X, U, goals, xs), 24, 1e-5, 4)
    want = k5.sqp_solve_mega_pcg_reference(model, *args, **kw)
    assert k5.check_mega_fit(n, lib, k5.SOLVE_PCG_GRID) == 1
    got = k5._launch(lib, tab, *args, grid=1, stream=None,
                     kind=k5.SOLVE_PCG_GRID, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    for f in ("sqp_iters", "bailed", "hit_max", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int((got.pcg_iters - want.pcg_iters).abs().max()) <= 2
    if rho == 0.3:
        assert bool(((want.pcg_iters >= 0) & (want.pcg_iters < 24)).any())


def test_four_k9pg_launches_equal_one_k5g_launch(host, traj_0_0):
    """sqp.iterate over four K9pg launches against one K5g launch, N = 128,
    through the host build: the same body, bit for bit."""
    from mpcgpu_tpu_torch.sqp import iterate

    lib, model, tab = host
    n = 128
    X, U, goals, xs = _k9_start(traj_0_0, n, None)
    kw = _long_kw()
    merit0, lam0, rho = (_merit0(model, X, U, goals, xs), torch.zeros(n, 14),
                         torch.tensor(1e-3))
    k5g = k5._launch(lib, tab, X, U, goals, xs, lam0, rho, 1.0, merit0, 24,
                     1e-5, 4, grid=1, stream=None, kind=k5.SOLVE_PCG_GRID,
                     **kw)

    def step(Xc, Uc, lamc, rhoc, drhoc, meritc):
        return k9._launch_iter(lib, k9.ITER_PCG_GRID, tab, Xc, Uc, goals, xs,
                               lamc, rhoc, drhoc, meritc, 24, 1e-5, **kw,
                               grid=1, stream=None)

    (Xi, Ui, lami, rhoi, _, meriti, itsi, bailedi, pcgi, hiti,
     acci) = iterate(X, U, lam0, rho, torch.tensor(1.0), merit0, 4, step)
    for got, want in ((Xi, k5g.X), (Ui, k5g.U), (lami, k5g.lam),
                      (rhoi, k5g.rho), (meriti, k5g.merit),
                      (itsi, k5g.sqp_iters), (bailedi, k5g.bailed),
                      (pcgi, k5g.pcg_iters), (hiti, k5g.hit_max),
                      (acci, k5g.accepted)):
        assert torch.equal(got, want)


def test_wrappers_take_the_one_block_form_at_64_and_the_grid_form_at_128(
        host, traj_0_0):
    """The CUDA wrappers' dispatch (pcg_dz, pcg_solve, sqp_solve_mega_pcg,
    sqp_iter_mega_pcg), driven through the host build, whose fits are the
    card's arithmetic at 227 KB of shared memory (N <= 90): the one-block
    kernel at N = 64 and its grid form at N = 128, each launch counted
    once under its own kernel."""
    from mpcgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    lib, model, _ = host
    for n, one_block in ((64, True), (128, False)):
        assert k4.one_block_fits(n, lib) is one_block
        ks = _long_system(model, traj_0_0, n, "fixture")
        S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
        X, U, goals, xs = _k9_start(traj_0_0, n, None)
        lam0, rho = torch.zeros(n, 14), torch.tensor(1e-3)
        merit0 = _merit0(model, X, U, goals, xs)
        reset_launch_counts()
        k4._pcg_dz_on(lib, ks, lam0, 3, 1e-5, None)
        k4._pcg_solve_on(lib, S, P, ks.gamma, lam0, 3, 1e-5, None)
        k5._solve_pcg_on(lib, model, X, U, goals, xs, lam0, rho, 1.0, merit0,
                         3, 1e-5, 1, *_long_kw().values())
        k9._iter_pcg_on(lib, model, X, U, goals, xs, lam0, rho, 1.0, merit0,
                        3, 1e-5, *_long_kw().values())
        counts = launch_counts()
        one = dict(K4=1, K4b=1, K5=1, K9p=1)
        grid = dict(K4g=1, K4bg=1, K5g=1, K9pg=1)
        want = dict.fromkeys(counts, 0)
        want.update(one if one_block else grid)
        assert counts == want, n


def test_a_grid_that_cannot_be_co_resident_raises():
    """No launch is made, and nothing falls back, where the occupancy API
    finds no co-resident grid."""

    class NoGrid:
        def mpc_pcg_grid(self, n, dz):
            return 0

        def mpc_mega_max_knots(self, kind):
            return 1 << 16

        def mpc_mega_grid(self, n, kind):
            return 0

    lib = NoGrid()
    with pytest.raises(ValueError, match="cooperative launch"):
        k4.check_pcg_grid_fit(256, lib)
    with pytest.raises(ValueError, match="cooperative launch"):
        k5.check_mega_fit(256, lib, k5.SOLVE_PCG_GRID)
