"""The CUDA kernels' arithmetic, checked without a GPU.

csrc/*.cu also builds with the host C++ compiler (ops/cuda/_lib.host_library):
every block then runs in turn on the calling thread, on CPU memory.  These
tests drive each kernel's ctypes launch path (the same argument packing as
on the card) through that build and hold the result against the kernel's
plain PyTorch version, at N = 8 from fixture 0_0, with the tolerances of
the JAX package's own kernel tests.  They check the kernels' math and
argument layout, not the CUDA-only parts (warp shuffles, launch limits);
chip_smoke.py checks those on the card.  The warp-cooperative routines of
lanedyn.cuh, K1 and K3 also run with the block's threads emulated, 32
lanes a warp, which one thread taking every lane cannot check.
"""
import contextlib
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
from tests.torch_systems import (bcr_iteration_given_lam, packed_arms,
                                 random_knot_schur, random_system,
                                 relative_residual, with_resting_arm)
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


# ---- the device library's warp-cooperative routines (lanedyn.cuh), each
# launched alone through the host build: at one lane (one thread takes
# every lane) and with the block's threads emulated, 32 lanes a warp --
# which must give the same bits, since every output entry belongs to one
# lane and keeps one term order -- against the plain PyTorch dynamics at
# the JAX lane-dynamics tests' tolerances (tests/test_lanedyn.py), on
# seeded states drawn as there.
LANES = [1, 32]
GRAV = -9.81


@contextlib.contextmanager
def _lanes(lib, lanes):
    """Run the block inside with its threads emulated when lanes == 32;
    fail if an emulated barrier timed out (a lane that never arrived)."""
    lib.mpc_emu_threads_host(0)
    lib.mpc_emu_threads_host(int(lanes > 1))
    try:
        yield
    finally:
        assert lib.mpc_emu_threads_host(0) == 0, "an emulated barrier hung"


def _states(seed, count=4):
    """(q, qd, u, qdd) draws: q in [-2, 2], qd in [-1, 1], u in [-10, 10],
    qdd in [-2, 2]."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: T(rng.uniform(lo, hi, 7).astype(np.float32))
    return [(f(-2, 2), f(-1, 1), f(-10, 10), f(-2, 2)) for _ in range(count)]


def _both_lanes(lib, lanes, run):
    """run() at `lanes`; at 32 lanes also held bit-equal to one lane."""
    with _lanes(lib, lanes):
        got = run()
    if lanes > 1:
        with _lanes(lib, 1):
            one = run()
        for g, o in zip(got, one):
            assert torch.equal(g, o), "32 lanes differ from one lane"
    return got


def _ptr(t):
    return t.data_ptr()


@pytest.mark.parametrize("lanes", LANES)
def test_warp_aba_matches_plain(host, lanes):
    from mpcgpu_tpu_torch.models.dynamics import forward_dynamics

    lib, model, tab = host
    for q, qd, u, _ in _states(0):
        def run():
            qdd = torch.zeros(7)
            lib.mpc_ld_aba_host(_ptr(tab), _ptr(q), _ptr(qd), _ptr(u), GRAV,
                                _ptr(qdd))
            return (qdd,)
        (qdd,) = _both_lanes(lib, lanes, run)
        _close(qdd, forward_dynamics(model, q, qd, u, GRAV), 2e-3, 2e-3)


@pytest.mark.parametrize("lanes", LANES)
def test_warp_crba_matches_plain(host, lanes):
    from mpcgpu_tpu_torch.models.dynamics import mass_matrix

    lib, model, tab = host
    for q, *_ in _states(1):
        def run():
            M = torch.zeros(7, 7)
            lib.mpc_ld_crba_host(_ptr(tab), _ptr(q), _ptr(M))
            return (M,)
        (M,) = _both_lanes(lib, lanes, run)
        _close(M, mass_matrix(model, q), 1e-4, 1e-5)


def _rnea_primal_plain(model, q, qd, qdd):
    """The chain rnea keeps for the tangents, in RneaPrimal's field order
    (v_in, a_in, v, Iv, facc: (7, 6) each), from the plain transforms."""
    from mpcgpu_tpu_torch.models.dynamics import crf, crm, joint_transforms

    X = joint_transforms(model, q)
    ez = torch.zeros(6)
    ez[2] = 1.0
    v, a = torch.zeros(6), torch.tensor([0, 0, 0, 0, 0, GRAV])
    v_in, a_in, vs, Iv, fs = [], [], [], [], []
    for j in range(7):
        v_in.append(v)
        a_in.append(a)
        vn = X[j] @ v + ez * qd[j]
        a = X[j] @ a + ez * qdd[j] + crm(vn, ez * qd[j])
        v = vn
        vs.append(v)
        Iv.append(model.I[j] @ v)
        fs.append(model.I[j] @ a + crf(v, Iv[-1]))
    facc = [None] * 7
    f = fs[6]
    for j in range(6, -1, -1):
        facc[j] = f
        if j > 0:
            f = fs[j - 1] + X[j].T @ f
    return torch.stack([torch.stack(x) for x in (v_in, a_in, vs, Iv, facc)])


@pytest.mark.parametrize("lanes", LANES)
def test_warp_rnea_and_its_primal_chain_match_plain(host, lanes):
    """tau at qdd = 0 (the bias, as K3's RNEA) and at a drawn qdd, and the
    primal chain the tangents read."""
    from mpcgpu_tpu_torch.models.dynamics import rnea

    lib, model, tab = host
    for q, qd, _, qdd in _states(2):
        for acc in (torch.zeros(7), qdd):
            def run():
                tau, prim = torch.zeros(7), torch.zeros(5, 7, 6)
                lib.mpc_ld_rnea_host(_ptr(tab), _ptr(q), _ptr(qd), _ptr(acc),
                                     GRAV, _ptr(tau), _ptr(prim))
                return tau, prim
            tau, prim = _both_lanes(lib, lanes, run)
            _close(tau, rnea(model, q, qd, acc, GRAV), 1e-4, 1e-4)
            _close(prim, _rnea_primal_plain(model, q, qd, acc), 1e-4, 1e-4)


@pytest.mark.parametrize("lanes", LANES)
def test_warp_fk_and_jacobian_match_plain(host, lanes):
    from mpcgpu_tpu_torch.models.dynamics import ee_pos_and_jac

    lib, model, tab = host
    for q, *_ in _states(3):
        def run():
            ee, J = torch.zeros(3), torch.zeros(3, 7)
            lib.mpc_ld_fk_host(_ptr(tab), _ptr(q), _ptr(ee), _ptr(J))
            return ee, J
        ee, J = _both_lanes(lib, lanes, run)
        pose, J_ref = ee_pos_and_jac(model, q)
        _close(ee, pose[:3], 1e-4, 1e-5)
        _close(J, J_ref, 1e-4, 1e-5)


@pytest.mark.parametrize("lanes", LANES)
def test_rnea_tangent_directions_match_plain(host, lanes):
    """The 14 tangent directions on 8 lanes each, as K3's stage 1 runs
    them (16 groups of a 128-thread block when emulated), against the
    forward-mode Jacobian of the plain RNEA at fixed qdd, at
    tests/test_lanedyn.py:56's tolerances."""
    from mpcgpu_tpu_torch.models.dynamics import rnea

    lib, model, tab = host
    for q, qd, _, qdd in _states(4):
        def run():
            dtau = torch.zeros(7, 14)
            lib.mpc_ld_dtau_host(_ptr(tab), _ptr(q), _ptr(qd), _ptr(qdd),
                                 GRAV, _ptr(dtau))
            return (dtau,)
        (dtau,) = _both_lanes(lib, lanes, run)
        want = torch.func.jacfwd(lambda x: rnea(model, x[:7], x[7:], qdd,
                                                GRAV))(torch.cat([q, qd]))
        _close(dtau, want, 2e-3, 2e-3)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n", [7, 14])
def test_register_spd_inverse_equals_the_shared_memory_form(host, n, lanes):
    """The register inverse (a row a lane, the pivot row through shared memory)
    against warp_spd_inverse, K6's and K7's shared-memory Gauss-Jordan,
    bit for bit, and against the float64 inverse to 1e-5 of its largest
    entry, on seeded SPD matrices B B' + n I."""
    lib = host[0]
    rng = np.random.default_rng(n)
    for _ in range(3):
        B = rng.normal(size=(n, n))
        A = T((B @ B.T + n * np.eye(n)).astype(np.float32))

        def run():
            reg, smem = A.clone(), A.clone()
            lib.mpc_ld_spd_inverse_host(n, 1, _ptr(reg))
            lib.mpc_ld_spd_inverse_host(n, 0, _ptr(smem))
            return reg, smem
        reg, smem = _both_lanes(lib, lanes, run)
        assert torch.equal(reg, smem)
        want = torch.linalg.inv(A.double())
        _close(reg.double() / want.abs().max(), want / want.abs().max(), 0,
               1e-5)


def test_k3_and_k1_with_their_threads_emulated_equal_one_thread(host,
                                                                traj_0_0):
    """K3's three launches (128 threads a block: the recursions on three
    warps, the tangents on 8-lane groups) and K1 (a warp an arm) with
    every thread emulated give the one-thread host build's bits."""
    lib, model, tab = host
    X, U, goals, _ = (T(a) for a in problem(traj_0_0))
    cfg = SolverConfig.for_knots(16)
    xu, ee = traj_0_0
    xs, U_prev, goal0 = T(xu[0, :14]), T(xu[:15, 14:].copy()), T(ee[0])

    def run():
        ks = k3._launch(lib, tab, X, U, goals, torch.tensor(RHO), DT,
                        QD_COST, R_COST, 0.0, True, None)
        r = k1._launch(lib, tab, cfg, xs, U_prev, goal0, 1500.0, 700.0, 11,
                       None)
        return (*ks, *r)
    _both_lanes(lib, 32, run)


@pytest.mark.parametrize("cap,tol", [(300, 1e-9), (40, 5e-5), (3, 1e-12)])
def test_k4_host_build_matches_plain(host, traj_0_0, cap, tol):
    """K4's cluster form on C = 2 and 4 emulated blocks: lam, dX, dU at
    rtol 5e-3, atol 5e-3; CG counts within 2 or both at the cap; the same
    hit flag; the kernel read C."""
    lib, model, _ = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0))
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT, QD_COST,
                                     R_COST)
    lam0 = torch.zeros(X.shape[0], 14)
    want = k4.pcg_dz_reference(ks, lam0, cap, tol)
    for c in (2, 4):
        with _no_hang(lib):
            got = k4._launch(lib, ks, lam0, cap, tol, None, _k4_plan(
                lib, X.shape[0], k4.CLUSTER, c))
        assert int(k4.pcg_dz.cluster_size) == c
        for g, w in zip(got[:3], want[:3]):
            _close(g, w, 5e-3, 5e-3)
        assert (abs(int(got[3]) - int(want[3])) <= 2
                or int(got[3]) == int(want[3]) == cap)
        assert bool(got[4]) == bool(want[4])


def _k4_plan(lib, n, form, cluster, place=-1, dz=True):
    """The plan of K4 (dz) or K4b in `form` at `cluster` blocks a cluster
    (the joined form on N / C clusters in the host build)."""
    plan = k4.pcg_plan(n, lib, dz, form, cluster, place)
    assert plan.form == form and plan.cluster == cluster
    return plan


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


def _k2_inputs(traj_0_0):
    X, U, goals, xs = (T(a) for a in problem(traj_0_0))
    rng = np.random.default_rng(5)
    dX = T((0.05 * rng.normal(size=tuple(X.shape))).astype(np.float32))
    dU = T((0.05 * rng.normal(size=tuple(U.shape))).astype(np.float32))
    return X, U, dX, dU, goals, xs + 0.01


def test_k2_host_build_with_its_threads_emulated(host, traj_0_0):
    """K2 with its blocks' 128 threads emulated, at its own choice (32
    lanes at N = 8) and at 8 lanes (16: the pair test below):
    the plain merits at K2's tolerances, and the same bits as one thread
    walking the block (the host build forms no multiply-adds, so no group
    size pairs them otherwise)."""
    lib, model, tab = host
    X, U, dX, dU, goals, xs = _k2_inputs(traj_0_0)
    want = k2.line_search_merits_reference(model, X, U, dX, dU, 8, goals, xs,
                                           DT, 10.0, QD_COST, R_COST)
    args = (lib, tab, X, U, dX, dU, 8, goals, xs, DT, 10.0, QD_COST, R_COST,
            0.0, None)
    with _lanes(lib, 1):
        one = k2._launch(*args)
    for group in (0, 8):
        with _lanes(lib, 32):
            got = k2._launch(*args, group=group)
        _close(got, want, 2e-4, 2e-4)
        assert torch.equal(got, one), f"groups of {group} lanes"


def _plain_contribution(model, X, U, goals, xs, k, mu):
    """The plain ops' merit contribution of knot k: J_k + mu (the knot's L1
    defect + ||x_0 - xs||_1 at k = 0)."""
    from mpcgpu_tpu_torch.ops import cost as cost_ops
    from mpcgpu_tpu_torch.ops import integrator as integ

    J = cost_ops.knot_costs(model, QD_COST, R_COST, X, U, goals)[k]
    defect = (integ.defect_l1(model, X[:-1], U, X[1:], DT)[k]
              if k < X.shape[0] - 1 else 0.0)
    c0 = (X[0] - xs).abs().sum() if k == 0 else 0.0
    return J + mu * (defect + c0)


@pytest.mark.parametrize("group", [8, 16, 32])
@pytest.mark.parametrize("lanes", LANES)
def test_group_merit_contribution_matches_plain(host, traj_0_0, group, lanes):
    """merit_contrib on groups of 8, 16 and 32 lanes, one pair each: the
    first knot, a middle one, the last (no control, no defect) and an
    unstepped candidate, against the plain contribution; every group of the
    warp gives the same bits, at 32 emulated lanes as at one lane."""
    lib, model, tab = host
    X, U, dX, dU, goals, xs = _k2_inputs(traj_0_0)
    n, mu = X.shape[0], 10.0
    for k, alpha in ((0, 1.0), (3, 0.25), (n - 1, 0.5), (2, None)):
        step = alpha is not None
        Xc, Uc = (X + alpha * dX, U + alpha * dU) if step else (X, U)
        want = _plain_contribution(model, Xc, Uc, goals, xs, k, mu)

        def run():
            out = torch.zeros(4)
            lib.mpc_k2_contrib_host(
                _ptr(tab), _ptr(X), _ptr(U), _ptr(dX) if step else None,
                _ptr(dU) if step else None, _ptr(goals), goals.shape[1],
                _ptr(xs), n, k, alpha if step else 0.0, DT, mu, QD_COST,
                R_COST, 0.0, group, _ptr(out))
            return out

        with _lanes(lib, lanes):
            got = run()
        if lanes > 1:
            groups = 32 // group
            assert torch.equal(got[:groups], got[:1].expand(groups))
            with _lanes(lib, 1):
                assert torch.equal(run()[:1], got[:1]), "32 lanes vs one"
        _close(got[:1], want.reshape(1), 2e-4, 2e-4)


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
    """The cluster K6 at N = 16 and at 256, a horizon the former K6l (K6
    with S read from global memory) served, on the random system at K6's
    tolerances (tests/test_bcr.py:62-74), CG iterations within 1; and a
    second launch gives the same bits."""
    lib = host[0]
    ks = random_knot_schur(n, seed=7)
    lam0 = T(np.random.default_rng(3).normal(size=(n, 14)).astype(np.float32))
    want = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
    got = k6._launch(lib, ks, lam0, 40, 5e-5, None)
    scale = want[0].abs().max()
    _close(got[0] / scale, want[0] / scale, 0, 2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        _close(g, w, 1e-3, 2e-4)
    assert abs(int(got[3]) - int(want[3])) <= 1
    assert bool(got[4]) == bool(want[4])
    for g, w in zip(got, k6._launch(lib, ks, lam0, 40, 5e-5, None)):
        assert torch.equal(g, w)


def test_k6l_host_build_residual_on_the_long_fixture_system(host, traj_0_0):
    """N = 256, fixture 0_0's system without the stair at rho 1e-3 and the
    long horizons' r_cost, cap 24, tol 1e-5 (the forced failover's solve
    at that horizon, once the former K6l's, now the cluster K6's): judged
    by residual as K6 on the fixture system, each solve within 1e-3 of
    |gamma|; CG iterations within 1."""
    lib, model, _ = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0, n=256))
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                     QD_COST, LONG_R_COST, precond=False)
    lam0 = torch.zeros(256, 14)
    want = k6.bcr_pcg_dz_reference(ks, lam0, 24, 1e-5)
    got = k6._launch(lib, ks, lam0, 24, 1e-5, None)
    S = BlockTri(ks.SL, ks.SD, ks.SU)
    for lam in (got[0], want[0]):
        res = (spmv(S, lam) - ks.gamma).abs().max() / ks.gamma.abs().max()
        assert float(res) < 1e-3
    assert abs(int(got[3]) - int(want[3])) <= 1


def test_bcr_pcg_dz_takes_k6_then_k6l_then_the_split_path(host):
    """bcr_pcg_dz's dispatch through the host build, whose fit is the
    card's arithmetic at 227 KB for a cluster of 16 (power-of-2 N <= 1024):
    the cluster K6 at N = 64 and at N = 128 (the former K6l's horizons),
    and past K6's fit (a library reporting it as 64) the split path, which
    launches no kernel."""
    from mpcgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    lib = host[0]
    assert lib.mpc_bcr_max_knots() == 1024
    assert [lib.mpc_bcr_cluster(n, 0) for n in (2, 512, 1024, 2048)] == [1, 1, 1, 0]

    class SmallFit:
        def mpc_bcr_max_knots(self):
            return 64

    for n, use, want in ((64, lib, "K6"), (128, lib, "K6"),
                         (128, SmallFit(), None)):
        ks = random_knot_schur(n, seed=7)
        lam0 = torch.zeros(n, 14)
        reset_launch_counts()
        got = k6._bcr_pcg_dz_on(use, ks, lam0, 40, 5e-5, None, None)
        counts = {k: c for k, c in launch_counts().items() if c}
        assert counts == ({want: 1} if want else {}), n
        ref = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
        scale = ref[0].abs().max()
        _close(got[0] / scale, ref[0] / scale, 0, 2e-5)


def _one_block_solve(lib, ks, fac=None):
    """bcr_factor, then one BcrPre apply, in one block (K7s's body before
    its cluster form): lam, and the factors in fac when given."""
    n = ks.gamma.shape[0]
    if fac is None:
        fac = torch.zeros(lib.mpc_bcr_scratch_floats(n))
    lam = torch.full((n, 14), float("nan"))
    assert lib.mpc_bcr_one_block_solve_host(
        n, ks.SL.data_ptr(), ks.SD.data_ptr(), ks.SU.data_ptr(),
        ks.gamma.data_ptr(), fac.data_ptr(), lam.data_ptr()) == 0
    return lam


@contextlib.contextmanager
def _no_hang(lib):
    """Fail where the block emulation found a wait no block could end."""
    lib.mpc_emu_threads_host(0)
    try:
        yield
    finally:
        assert lib.mpc_emu_threads_host(0) == 0, "an emulated wait hung"


@pytest.mark.parametrize("n", [8, 64, 256, 512, 1024])
@pytest.mark.parametrize("clusters", [1, 2, 16])
def test_k6_cluster_factor_equals_the_one_block_factor(host, n, clusters):
    """The cluster factor against bcr_factor (one block, as K7 runs it),
    bit for bit over the whole factor scratch (both zeroed first): at C = 1
    as the K6 launch runs it, and at C = 2 and 16 through the host build's
    emulation of the cluster's schedule (each level's ranks one after
    another between the barriers), which spreads the warps' knots over the
    ranks as the card does.  Past K7's fit (N = 64) no kernel on the card
    runs the one-block factor: N = 256-1024 are checked here alone."""
    lib = host[0]
    ks = random_knot_schur(n, seed=7)
    size = lib.mpc_bcr_scratch_floats(n)
    one_block, cluster = torch.zeros(size), torch.zeros(size)
    _one_block_solve(lib, ks, one_block)
    if clusters == 1:
        k6._launch(lib, ks, torch.zeros(n, 14), 3, 1e-9, None,
                   scratch=cluster)
    else:
        assert lib.mpc_bcr_cluster_factor_host(
            n, clusters, ks.SL.data_ptr(), ks.SD.data_ptr(),
            ks.SU.data_ptr(), cluster.data_ptr()) == 0
    assert torch.equal(cluster, one_block)
    assert bool(one_block.abs().sum() > 0)


@pytest.mark.parametrize("n", [8, 64, 256, 512, 1024])
@pytest.mark.parametrize("clusters", [2, 3, 16])
def test_k6_cluster_apply_equals_the_one_block_apply(host, n, clusters):
    """K6's preconditioner apply z = BCR(r) over C emulated blocks (each
    block's knots and shared memory its own, the rows of other blocks read
    through the emulated DSMEM map, the phases between cluster barriers
    run rank after rank; C = 3 leaves the last block fewer knots, C = 16
    at N = 8 some none) against the one-block apply (BcrPre) of the same
    factors, bit for bit."""
    lib = host[0]
    ks = random_knot_schur(n, seed=7)
    fac = torch.zeros(lib.mpc_bcr_scratch_floats(n))
    want = _one_block_solve(lib, ks, fac)
    got = torch.full_like(want, float("nan"))
    assert lib.mpc_bcr_cluster_apply_host(n, clusters, fac.data_ptr(),
                                          ks.gamma.data_ptr(),
                                          got.data_ptr()) == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [8, 64, 256, 512, 1024])
@pytest.mark.parametrize("clusters", [2, 3, 16])
def test_k7s_cluster_kernel_equals_the_one_block_solve(host, n, clusters):
    """K7s's kernel on C blocks under the block emulation (each block on a
    host thread of its own, one after another between the cluster
    barriers; C = 3 leaves the last block fewer knots, C = 16 at N = 8
    some none) against bcr_factor and one BcrPre apply in one block: lam
    and the whole factor scratch bit for bit; no wait hangs; the kernel
    read C."""
    lib = host[0]
    ks = random_knot_schur(n, seed=7)
    size = lib.mpc_bcr_scratch_floats(n)
    one_block, cluster = torch.zeros(size), torch.zeros(size)
    want = _one_block_solve(lib, ks, one_block)
    with _no_hang(lib):
        got = k7._launch_solve(lib, ks.SL, ks.SD, ks.SU, ks.gamma, None,
                               scratch=cluster, cluster=clusters)
    assert int(k7.bcr_solve.cluster_size) == clusters
    assert torch.equal(got, want)
    assert torch.equal(cluster, one_block)


def _one_block_dz(lib, ks, fac):
    """bcr_dz_body in one block (K7's body before its cluster form): lam,
    dX and dU, and the factors in fac."""
    n = ks.gamma.shape[0]
    lam, dX = torch.full((2, n, 14), float("nan"))
    dU = torch.full((n - 1, 7), float("nan"))
    assert lib.mpc_bcr_dz_one_block_host(
        n, *(getattr(ks, f).data_ptr() for f in k7._FIELDS), fac.data_ptr(),
        lam.data_ptr(), dX.data_ptr(), dU.data_ptr()) == 0
    return lam, dX, dU


@pytest.mark.parametrize("kernel,n,clusters", [
    ("K9b", 8, 2), ("K9b", 8, 4), ("K9b", 64, 2), ("K9b", 64, 4),
    ("K9b", 64, 3), ("K9b", 8, 16),
    *(("K7", n, c) for n in (2, 4, 16, 64, 256) for c in (1, 2, 4))])
def test_k9b_cluster_stage_equals_the_one_block_body(host, kernel, n,
                                                     clusters):
    """The refined solve and dz across a cluster (bcr_common.cuh
    cluster_bcr_dz: the cluster factor, two cluster applies with the
    residual between, its halo rows read through the emulated DSMEM map,
    and the owners' dz) on C emulated blocks -- as K9b's stage 4 alone, and
    as the whole K7 launch (C = 1 one block; at N = 2 and 4 with C = 4 some
    blocks own no knot) -- against the one-block refined solve and dz
    (bcr_dz_body, K7's body before its cluster form) on the same system:
    lam, dX, dU and the factors bit for bit; no wait hangs; K7 read C."""
    lib = host[0]
    ks = random_knot_schur(n, seed=7)
    size = lib.mpc_bcr_scratch_floats(n)
    fac_one, fac = torch.zeros(size), torch.zeros(size)
    want = _one_block_dz(lib, ks, fac_one)
    if kernel == "K7":
        with _no_hang(lib):
            lam, dX, dU = k7._launch_dz(lib, ks, None, scratch=fac,
                                        cluster=clusters)[:3]
        assert int(k7.bcr_dz.cluster_size) == clusters
    else:
        lam, dX = torch.full((2, n, 14), float("nan"))
        dU = torch.full((n - 1, 7), float("nan"))
        assert lib.mpc_bcr_cluster_dz_host(
            n, clusters, *(getattr(ks, f).data_ptr() for f in k7._FIELDS),
            fac.data_ptr(), lam.data_ptr(), dX.data_ptr(),
            dU.data_ptr()) == 0
    for got, w in zip((lam, dX, dU, fac), (*want, fac_one)):
        assert torch.equal(got, w)
    assert bool(fac_one.abs().sum() > 0)


@pytest.mark.parametrize("n,clusters,grid", [(8, 2, 8), (8, 4, 8),
                                             (4, 4, 4)])
def test_k9b_cluster_form_equals_its_one_block_launch(host, traj_0_0, n,
                                                      clusters, grid):
    """A whole K9b launch on grid / C clusters of C blocks under the block
    emulation (the stages over every block, stage 4 across the first
    cluster while the others wait at the grid barrier, the decision state
    in each block's own head) against the host build's one-block launch:
    every output bit for bit; no wait hangs; the kernel read C."""
    lib, model, tab = host
    X, U, goals, xs = _k9_start(traj_0_0, n, 1e-3)
    merit = k2.line_search_merits_reference(
        model, X, U, torch.zeros_like(X), torch.zeros_like(U), 8, goals, xs,
        DT, 10.0, QD_COST, R_COST)[8]
    args = (X, U, goals, xs, None, torch.tensor(1e-3), torch.tensor(1.0),
            merit, 0, 0.0)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)
    want = k9._launch_iter(lib, k9.ITER_BCR, tab, *args, **kw, grid=1,
                           stream=None)
    with _no_hang(lib):
        got = k9._launch_iter(lib, k9.ITER_BCR, tab, *args, **kw, grid=grid,
                              stream=None, cluster=clusters)
    assert int(k9.sqp_iter_mega.cluster_size) == clusters
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,clusters", [(8, 3), (64, 16), (2, 16)])
def test_cluster_dot_sums_the_partials_in_rank_order(host, n, clusters):
    """The cluster CG's dot product over C emulated blocks (C = 3 leaves
    the last block fewer knots, C = 16 at N = 2 most blocks none): every
    block's rank-ordered sum of the C partials has the same bits, equal
    to the partials summed in rank order, each partial its own knots'
    sum."""
    lib = host[0]
    values = T(np.random.default_rng(n).normal(size=(n, 14)).astype(np.float32))
    partials, sums = torch.empty(clusters), torch.empty(clusters)
    assert lib.mpc_cluster_dot_host(n, clusters, values.data_ptr(),
                                    partials.data_ptr(), sums.data_ptr()) == 0
    nk = -(-n // clusters)
    want = np.float32(0.0)
    for q in range(clusters):
        own = values.reshape(-1)[14 * q * nk:14 * min(n, (q + 1) * nk)].numpy()
        part = np.float32(0.0)
        for v in own:
            part = np.float32(part + v)
        assert partials[q].item() == part
        want = np.float32(want + part)
    assert torch.equal(sums, torch.full((clusters,), float(want)))


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
    assert k10.packed_plan(n, b, 8, lib).grid == 1
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


# ---- K10's cluster form under the block emulation (lanedyn.cuh's
# ld_emu_blocks): B clusters of C blocks and the clusters past the arms,
# each block on a host thread of its own, one after another between the
# grid and cluster barriers, the shared exit's tagged words read across
# the clusters; a barrier some block never reaches fails the test.
K10_KW = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)


def _k10_form(lib, tab, args, kw, cluster, stair=-1, grid=None):
    """One K10 launch through the host build: cluster 0 the one-block form
    (one block owns every arm), else the cluster form on the plan's grid
    (or `grid`) under the block emulation, which must not hang."""
    b, n = args[0].shape[:2]
    if cluster == 0:
        return k10._launch_packed(lib, tab, *args, grid=1, stream=None, **kw)
    plan = k10.packed_plan(n, b, 8, lib, cluster=cluster, stair=stair)
    assert plan.cluster == cluster and plan.grid % cluster == 0
    lib.mpc_emu_threads_host(0)
    try:
        got = k10._launch_packed(lib, tab, *args, grid=grid or plan.grid,
                                 stream=None, cluster=cluster,
                                 stair=plan.stair, **kw)
    finally:
        assert lib.mpc_emu_threads_host(0) == 0, "an emulated barrier hung"
    assert int(k10.sqp_solve_mega_pcg_packed.cluster_size) == cluster
    return got


def _k10_close(got, want):
    """test_k10_host_build_matches_plain's tolerances."""
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    _close(got.rho, want.rho, 1e-6, 0)
    _close(got.merit, want.merit, 1e-3, 0)
    for f in ("sqp_iters", "bailed", "pcg_iters_total"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.fixture(scope="module")
def k10_plain():
    """The plain solves of the cluster-form cases, one per (N, B)."""
    return {}


@pytest.mark.parametrize("n,b,cluster,stair", [
    (8, 2, 2, 1), (8, 2, 4, 0), (8, 3, 2, 0), (8, 3, 4, 1),
    (16, 2, 2, 0), (16, 2, 4, 1), (16, 3, 2, 1), (16, 3, 4, 0)])
def test_k10_cluster_form_host_build_matches_plain(host, traj_0_0, k10_plain,
                                                   n, b, cluster, stair):
    """The cluster form at C = 2 and 4 (the stair bands in each block's
    shared memory, 1, or read from global memory, 0), B arms as
    chip_smoke.py's K10 check makes them, at its rhos where the CGs exit
    before the cap (0.1, 0.3, then 1.0), 4 SQP iterations, cap 40, tol
    5e-5, against the plain version at the one-block form's tolerances
    (the JAX megakernel test's).  At rho 1e-3 the CGs run on a system of
    condition ~1e7, where at N = 16 the one-block form too parts from the
    plain version by more than these tolerances: chip_smoke.py holds lam
    at atol 1e-3 there."""
    lib, model, tab = host
    X, U, goals, xs = packed_arms(*traj_0_0, n, b, 5)
    args = (X, U, goals, xs, torch.zeros(b, n, 14),
            torch.tensor((0.1, 0.3, 1.0)[:b]), torch.ones(b), 40, 5e-5, 4)
    if (n, b) not in k10_plain:
        k10_plain[n, b] = k10.sqp_solve_mega_pcg_packed_reference(
            model, *args, **K10_KW)
    got = _k10_form(lib, tab, args, K10_KW, cluster, stair)
    _k10_close(got, k10_plain[n, b])


def test_k10_cluster_form_host_build_freezes_a_bailed_arm(host, traj_0_0):
    """test_k10_host_build_matches_plain's bail case on the cluster form at
    C = 2, on the least grid (one cluster an arm, every block striding
    over the (arm, knot) pairs): arm 1 bails at iteration 2 and stays
    frozen while arm 0 iterates."""
    lib, model, tab = host
    X, U, goals, xs = _arms(traj_0_0, 4, 2, 6)
    kw = dict(K10_KW, rho_max=0.05)
    args = (X, U, goals, xs, torch.zeros(2, 4, 14), torch.tensor([1e-3, 0.1]),
            torch.ones(2), 40, 1e-4, 5)
    want = k10.sqp_solve_mega_pcg_packed_reference(model, *args, **kw)
    got = _k10_form(lib, tab, args, kw, 2, grid=4)
    _k10_close(got, want)
    assert got.bailed.tolist() == [False, True]
    assert got.sqp_iters.tolist() == [5, 2]


@pytest.mark.parametrize("cluster", [0, 2])
def test_k10_host_build_arm_with_zero_residual(host, traj_0_0, cluster):
    """A third arm at rest (torch_systems.with_resting_arm): its CG
    residual is exactly zero, so alpha and beta are 0/0, which the packed
    CG takes as 0.  Its duals stay exactly zero, nothing turns NaN, and
    the two other arms come out as they do packed alone -- the same shared
    CG count, the same bits (no sum of an arm reads another arm) -- in
    the one-block form (0) and the cluster form (2), and in the plain
    version."""
    lib, model, tab = host
    X, U, goals, xs = packed_arms(*traj_0_0, 8, 2, 5)
    rest = (40, 5e-5, 5)
    two = (X, U, goals.contiguous(), xs, torch.zeros(2, 8, 14),
           torch.tensor([1e-3, 0.1]), torch.ones(2)) + rest
    three = with_resting_arm(X, U, goals, xs) + (
        torch.zeros(3, 8, 14), torch.tensor([1e-3, 0.1, 1e-3]),
        torch.ones(3)) + rest
    got2 = _k10_form(lib, tab, two, K10_KW, cluster)
    got3 = _k10_form(lib, tab, three, K10_KW, cluster)
    plain2 = k10.sqp_solve_mega_pcg_packed_reference(model, *two, **K10_KW)
    plain3 = k10.sqp_solve_mega_pcg_packed_reference(model, *three, **K10_KW)
    for g3, g2 in ((got3, got2), (plain3, plain2)):
        assert all(bool(torch.isfinite(t).all()) for t in g3[:5])
        assert not bool(g3.lam[2].any())
        assert int(g3.pcg_iters_total) == int(g2.pcg_iters_total)
        for f in ("X", "U", "lam", "rho", "merit", "sqp_iters", "bailed"):
            assert torch.equal(getattr(g3, f)[:2], getattr(g2, f)), f
    _k10_close(got3, plain3)


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
    """K4b's cluster form on C = 2 and 4 emulated blocks, at K4's
    tolerances: lam at rtol 5e-3, atol 5e-3; CG counts within 2 or both at
    the cap; the same hit flag; the kernel read C."""
    lib, model, _ = host
    X, U, goals, xs = (T(a) for a in problem(traj_0_0))
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT, QD_COST,
                                     R_COST)
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    lam0 = torch.zeros(X.shape[0], 14)
    want = k4.pcg_solve_reference(S, P, ks.gamma, lam0, cap, tol)
    for c in (2, 4):
        with _no_hang(lib):
            got = k4._launch(lib, k4._solve_system(S, P, ks.gamma), lam0, cap,
                             tol, None, _k4_plan(lib, X.shape[0], k4.CLUSTER,
                                                 c, dz=False), dz=False)
        assert int(k4.pcg_solve.cluster_size) == c
        _close(got[0], want[0], 5e-3, 5e-3)
        assert (abs(int(got[1]) - int(want[1])) <= 2
                or int(got[1]) == int(want[1]) == cap)
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


def test_bcr_dz_takes_k7_up_to_its_fit_then_the_split_path(host):
    """bcr_dz's dispatch through the host build, whose fit is the card's
    arithmetic at 227 KB for a cluster of 16 (power-of-2 N <= 1024): K7,
    one launch, at N = 128 (the split path's horizon before K7's cluster
    form), within K7's tolerances (lam scaled by its largest entry at atol
    2e-5, dX and dU at rtol 1e-3, atol 2e-4) of the plain refined solve and
    of the split path with the host build's K7s as its solves; split=True
    takes the split path, which on CPU tensors launches no kernel."""
    from mpcgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    lib = host[0]
    assert lib.mpc_bcr_dz_max_knots() == 1024
    assert ([lib.mpc_bcr_dz_cluster(n, 0) for n in (2, 512, 1024, 2048)]
            == [1, 1, 1, 0])
    ks = random_knot_schur(128, seed=7)
    solve = lambda rhs: k7._launch_solve(lib, ks.SL, ks.SD, ks.SU, rhs, None)
    outs = {}
    for split, want in ((None, {"K7": 1}), (True, {})):
        reset_launch_counts()
        outs[split] = k7._bcr_dz_on(lib, ks, split, None)
        assert {k: c for k, c in launch_counts().items() if c} == want
    got = outs[None]
    assert int(got[3]) == 0 and not bool(got[4])
    for want in (k7.bcr_dz_reference(ks), k7.bcr_dz_split(ks, solve),
                 outs[True]):
        scale = want[0].abs().max()
        _close(got[0] / scale, want[0] / scale, 0, 2e-5)
        for g, w in zip(got[1:3], want[1:3]):
            _close(g, w, 1e-3, 2e-4)


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
    _check_k9b(host, traj_0_0, 8, rho)


@pytest.mark.parametrize("n", [2, 4])
def test_k9b_host_build_matches_plain_at_short_horizons(host, traj_0_0, n):
    """test_k9b_host_build_matches_plain's checks at N = 2 and 4 (one and
    two levels of the reduction), rho 1e-3."""
    _check_k9b(host, traj_0_0, n, 1e-3)


def _check_k9b(host, traj_0_0, n, rho):
    lib, model, tab = host
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


# ---- K4 and K4b in the joined form (K4g, K4bg) and K5g, K9pg at long
# horizons: the host build runs the joined form's G clusters of C blocks
# under the block emulation, or one block over every knot (a cooperative
# grid of one)
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
    """K4g and K4bg (the joined form on G = 2 clusters of C = 2 emulated
    blocks), and K4 and K4b in the cluster form on 4 emulated blocks, at
    K4's tolerances: lam, dX, dU at rtol 5e-3, atol 5e-3; CG counts within
    2 or both at the cap; the same hit flag."""
    lib, model, _ = host
    ks = _long_system(model, traj_0_0, n, system)
    lam0 = torch.zeros(n, 14)
    want = k4.pcg_dz_reference(ks, lam0, cap, tol)
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    want_b = k4.pcg_solve_reference(S, P, ks.gamma, lam0, cap, tol)
    joined = _k4_plan(lib, n, k4.JOINED, 2)._replace(clusters=2, grid=4)
    for plan in (joined, _k4_plan(lib, n, k4.CLUSTER, 4)):
        with _no_hang(lib):
            got = k4._launch(lib, ks, lam0, cap, tol, None, plan)
            got_b = k4._launch(lib, ks, lam0, cap, tol, None, plan, dz=False)
        pairs = ((got[:3], want[:3], got[3:], want[3:]),
                 (got_b[:1], want_b[:1], got_b[1:], want_b[1:]))
        for vals, want_vals, (it, hit), (it_ref, hit_ref) in pairs:
            for g, w in zip(vals, want_vals):
                _close(g, w, 5e-3, 5e-3)
            assert (abs(int(it) - int(it_ref)) <= 2
                    or int(it) == int(it_ref) == cap)
            assert bool(hit) == bool(hit_ref)
    if system == "random":
        assert int(want[3]) < cap


def _stage4(lib, ks, lam0, clusters, cluster, place, cap, tol, dz=True):
    """K5's (clusters 0) or K5g's stage 4 alone as those kernels ran it
    before it became a body of its own (mpc_stage4_host): (lam, dX, dU,
    iters), dX and dU NaN without dz."""
    n = ks.gamma.shape[0]
    lam = torch.full((n, 14), float("nan"))
    dX, dU = torch.full((n, 14), float("nan")), torch.full((n - 1, 7),
                                                           float("nan"))
    its = torch.zeros(1, dtype=torch.int32)
    fields = ("SL", "SD", "SU", "PL", "PD", "PU", "gamma")
    assert lib.mpc_stage4_host(
        n, clusters, cluster, place, -1, int(dz),
        *(getattr(ks, f).data_ptr() for f in fields), lam0.data_ptr(),
        *(getattr(ks, f).data_ptr() for f in k4._DZ_FIELDS), cap, tol,
        lam.data_ptr(), dX.data_ptr(), dU.data_ptr(), its.data_ptr()) == 0
    return lam, dX, dU, its[0]


@pytest.mark.parametrize("n", [2, 3, 7, 16])
@pytest.mark.parametrize("cluster", [2, 4])
def test_k4_cluster_form_equals_k5s_dual_solve(host, n, cluster):
    """K4 and K4b in the cluster form on C emulated blocks (C = 4 leaves
    blocks without a knot at N = 2 and 3), the stair's bands on chip and
    in L2, on the seeded well-conditioned system (the CG exits before the
    cap): bit for bit K5's stage 4 on the same S, P, gamma and lam0 (lam,
    dX, dU, the CG count; K4b's lam and count K4's), and the plain version
    at K4's tolerances (rtol 5e-3, atol 5e-3, counts within 2, the same
    hit).  Where C <= N, the joined form (K4g, K4bg) on N / C clusters of
    C blocks the same way against K5g's stage 4."""
    lib = host[0]
    ks = random_knot_schur(n)
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    lam0 = torch.zeros(n, 14)
    want = k4.pcg_dz_reference(ks, lam0, 300, 1e-9)
    plans = [_k4_plan(lib, n, k4.CLUSTER, cluster, place)
             for place in (3, 2)]
    if cluster <= n:
        plans += [_k4_plan(lib, n, k4.JOINED, cluster, place)
                  for place in (3, 0)]
    for plan in plans:
        with _no_hang(lib):
            got = k4._launch(lib, ks, lam0, 300, 1e-9, None, plan)
            got_b = k4._launch(lib, k4._solve_system(S, P, ks.gamma), lam0,
                               300, 1e-9, None, plan, dz=False)
            ref = _stage4(lib, ks, lam0, plan.clusters
                          if plan.form == k4.JOINED else 0, cluster,
                          plan.place, 300, 1e-9)
        for g, r in zip((*got[:4], got_b[0], got_b[1]), (*ref, ref[0], ref[3])):
            assert torch.equal(g, r), plan
        for g, w in zip(got[:3], want[:3]):
            _close(g, w, 5e-3, 5e-3)
        assert abs(int(got[3]) - int(want[3])) <= 2 and int(want[3]) < 300
        assert bool(got[4]) == bool(want[4]) == bool(got_b[2])


@pytest.mark.parametrize("n,clusters", [(13, 2), (13, 3), (37, 2), (37, 3)])
def test_k4g_joined_form_equals_k5gs_dual_solve(host, traj_0_0, n,
                                                clusters):
    """K4g and K4bg on G clusters of 2 emulated blocks at every place of
    the CG's area, on fixture 0_0's system at the long horizons' cap
    (every CG at it): lam and the CG count bit for bit K5g's dual solve
    alone (mpc_joined_cg_host), and K4g's dX and dU K5g's stage 4's
    (mpc_stage4_host with dz)."""
    lib, model, _ = host
    ks = _long_system(model, traj_0_0, n, "fixture")
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    lam0 = torch.zeros(n, 14)
    ptrs = [t.data_ptr() for t in (ks.SL, ks.SD, ks.SU, ks.PL, ks.PD, ks.PU,
                                   ks.gamma, lam0)]
    for place in (3, 2, 1, 0):
        plan = k4.PcgPlan(k4.JOINED, 2, clusters, place, 2 * clusters)
        with _no_hang(lib):
            got = k4._launch(lib, ks, lam0, 24, 1e-5, None, plan)
            got_b = k4._launch(lib, k4._solve_system(S, P, ks.gamma), lam0,
                               24, 1e-5, None, plan, dz=False)
            ref = _stage4(lib, ks, lam0, clusters, 2, place, 24, 1e-5)
        lam = torch.full((n, 14), float("nan"))
        its = torch.zeros(1, dtype=torch.int32)
        assert lib.mpc_joined_cg_host(n, clusters, 2, place, -1, *ptrs, 24,
                                      1e-5, lam.data_ptr(),
                                      its.data_ptr()) == 0
        assert int(k4.pcg_dz_grid.cluster_size) == 2
        for g in (got[0], got_b[0], ref[0]):
            assert torch.equal(g, lam), place
        for g in (got[3], got_b[1], ref[3]):
            assert int(g) == int(its[0]) == 24
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


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


# ---- K5g's and K9pg's joined form under the block emulation (lanedyn.cuh's
# ld_emu_blocks): one CG across G clusters of C blocks, each block on a
# host thread of its own, one after another between the barriers and the
# waits on tagged words (the dots' cluster sums, the rows at the clusters'
# edges); a wait that no block can end fails the test.
def _joined(lib, launch, n, cluster, clusters, place=-1):
    """launch(grid=, cluster=, stair=) of a joined kind on `clusters`
    clusters of `cluster` blocks under the block emulation, which must not
    hang."""
    plan = k5.grid_plan(n, lib, cluster, place)
    assert plan.cluster == cluster and plan.clusters >= clusters
    lib.mpc_emu_threads_host(0)
    try:
        got = launch(grid=cluster * clusters, cluster=cluster,
                     stair=plan.place)
    finally:
        assert lib.mpc_emu_threads_host(0) == 0, "an emulated wait hung"
    return got


@pytest.fixture(scope="module")
def k5g_plain():
    """The plain solves of the joined-form cases, one per (N, rho)."""
    return {}


def _k5g_args(model, traj_0_0, n, rho):
    X, U, goals, xs = _k9_start(traj_0_0, n, None)
    return (X, U, goals, xs, torch.zeros(n, 14), torch.tensor(rho), 1.0,
            _merit0(model, X, U, goals, xs), 24, 1e-5, 4)


@pytest.mark.parametrize("n,cluster,clusters,place,rho", [
    # knot counts the blocks do not split evenly; every place of the CG's
    # area (3: S's and the stair's bands and the vectors on chip ... 0: all
    # in global memory); at rho 0.3 and N = 128 some CG exits early
    (13, 2, 2, 3, 1e-3), (13, 4, 3, 2, 1e-3), (37, 4, 2, 1, 1e-3),
    (37, 2, 3, 0, 1e-3), (128, 4, 3, 3, 0.3), (128, 2, 3, 0, 0.3)])
def test_k5g_joined_form_host_build_matches_plain(host, traj_0_0, k5g_plain,
                                                  n, cluster, clusters, place,
                                                  rho):
    """K5g on G = 2 or 3 clusters of C = 2 or 4 blocks against its plain
    version, at test_k5g_host_build_matches_plain's inputs and tolerances:
    X, U at rtol 1e-3, atol 1e-5; lam at rtol 1e-3, atol 1e-4; decisions
    identical; CG counts within 2; the kernel read C."""
    lib, model, tab = host
    kw = _long_kw()
    args = _k5g_args(model, traj_0_0, n, rho)
    if (n, rho) not in k5g_plain:
        k5g_plain[n, rho] = k5.sqp_solve_mega_pcg_reference(model, *args,
                                                            **kw)
    want = k5g_plain[n, rho]
    got = _joined(lib, lambda **g: k5._launch(
        lib, tab, *args, stream=None, kind=k5.SOLVE_PCG_GRID, **g, **kw),
        n, cluster, clusters, place)
    assert int(k5.sqp_solve_mega_pcg_grid.cluster_size) == cluster
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    for f in ("sqp_iters", "bailed", "hit_max", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int((got.pcg_iters - want.pcg_iters).abs().max()) <= 2
    if n == 128:
        assert bool(((want.pcg_iters >= 0) & (want.pcg_iters < 24)).any())


def test_k5g_joined_form_places_give_the_same_bits(host, traj_0_0):
    """The CG's area on chip or in global memory (every place) gives the
    same bits, at N = 37 over 3 clusters of 2."""
    lib, model, tab = host
    n, kw = 37, _long_kw()
    args = _k5g_args(model, traj_0_0, n, 1e-3)
    runs = [_joined(lib, lambda **g: k5._launch(
        lib, tab, *args, stream=None, kind=k5.SOLVE_PCG_GRID, **g, **kw),
        n, 2, 3, place) for place in (3, 2, 1, 0)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_four_k9pg_launches_equal_one_joined_k5g_launch(host, traj_0_0):
    """sqp.iterate over four K9pg launches against one K5g launch, both on
    3 clusters of 2 blocks at N = 13: the same plan and body, bit for
    bit."""
    from mpcgpu_tpu_torch.sqp import iterate

    lib, model, tab = host
    n, kw = 13, _long_kw()
    X, U, goals, xs, lam0, rho, _, merit0, cap, tol, _ = _k5g_args(
        model, traj_0_0, n, 1e-3)
    once = _joined(lib, lambda **g: k5._launch(
        lib, tab, X, U, goals, xs, lam0, rho, 1.0, merit0, cap, tol, 4,
        stream=None, kind=k5.SOLVE_PCG_GRID, **g, **kw), n, 2, 3)

    def step(Xc, Uc, lamc, rhoc, drhoc, meritc):
        return _joined(lib, lambda **g: k9._launch_iter(
            lib, k9.ITER_PCG_GRID, tab, Xc, Uc, goals, xs, lamc, rhoc,
            drhoc, meritc, cap, tol, **kw, stream=None, **g), n, 2, 3)

    four = iterate(X, U, lam0, rho, torch.tensor(1.0), merit0, 4, step)
    assert int(k9.sqp_iter_mega_pcg_grid.cluster_size) == 2
    for got, want in zip(four, (once.X, once.U, once.lam, once.rho,
                                once.drho, once.merit, once.sqp_iters,
                                once.bailed, once.pcg_iters, once.hit_max,
                                once.accepted)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,cluster,clusters,place", [
    (37, 2, 3, 3), (64, 4, 3, 0), (64, 1, 5, 1)])
def test_joined_cg_matches_plain_and_a_missing_row_fails(host, n, cluster,
                                                         clusters, place):
    """K5g's dual solve alone (mpc_joined_cg_host: cluster_cg_solve with
    the joined exit under the block emulation) on the seeded
    well-conditioned system, where the CG exits before the cap, against
    the plain CG at K4's tolerances (lam at rtol 5e-3, atol 5e-3; counts
    within 2).  Then a copy of the exit whose last block of cluster 0 never
    puts its rows of one kind: the emulation reports the wait no block
    can end (the card would hang) and returns."""
    lib = host[0]
    ks = random_knot_schur(n)
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    lam0 = torch.zeros(n, 14)
    want, want_its = k4.pcg_solve_reference(S, P, ks.gamma, lam0, 300,
                                            1e-9)[:2]
    got = torch.full((n, 14), float("nan"))
    its = torch.zeros(1, dtype=torch.int32)
    ptrs = [t.data_ptr() for t in (ks.SL, ks.SD, ks.SU, ks.PL, ks.PD, ks.PU,
                                   ks.gamma, lam0)]
    assert lib.mpc_joined_cg_host(n, clusters, cluster, place, -1, *ptrs,
                                  300, 1e-9, got.data_ptr(),
                                  its.data_ptr()) == 0
    _close(got, want, 5e-3, 5e-3)
    assert abs(int(its) - int(want_its)) <= 2 and int(want_its) < 300
    for kind in (0, 1):
        assert lib.mpc_joined_cg_host(n, clusters, cluster, place, kind,
                                      *ptrs, 300, 1e-9, got.data_ptr(),
                                      its.data_ptr()) == 1


class _SmallMegaFit:
    """The host build with the cluster kinds' fit cut to 64 knots, so that
    N = 128 lies past it."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def mpc_mega_max_knots(self, kind):
        n = self._lib.mpc_mega_max_knots(kind)
        return min(n, 64) if kind in (k5.SOLVE_PCG, k5.ITER_PCG) else n


@pytest.mark.parametrize("n,fit", [(2, None), (64, None), (128, None),
                                   (512, None), (128, 64)])
def test_wrappers_route_k5_and_k9p_to_the_cluster_form_up_to_its_fit(
        host, traj_0_0, n, fit):
    """The CUDA wrappers' dispatch (pcg_dz, pcg_solve, sqp_solve_mega_pcg,
    sqp_iter_mega_pcg), driven through the host build, whose fits are the
    card's arithmetic at 227 KB of shared memory and clusters of 16 (K5,
    K9p a cluster of 16 holding S's and the stair's bands, N <= 704): K5
    and K9p take the cluster form at N = 2, 64, 128 and 512, the grid form
    past the fit (a library whose fit is cut to 64); K4 and K4b their
    cluster form while a block of 16 owns at most the plan's cut of 24
    knots (N <= 384), the joined form past it (K4g, K4bg); each launch
    counted once under its own kernel."""
    from mpcgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    lib, model, _ = host
    assert lib.mpc_mega_max_knots(k5.SOLVE_PCG) >= 512
    assert lib.mpc_mega_max_knots(k5.SOLVE_PCG) < 1024
    use = lib if fit is None else _SmallMegaFit(lib)
    cluster = n <= use.mpc_mega_max_knots(k5.SOLVE_PCG)
    assert k5.pcg_kind(n, use) == (k5.SOLVE_PCG if cluster
                                   else k5.SOLVE_PCG_GRID)
    ks = _long_system(model, traj_0_0, n, "fixture")
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    X, U, goals, xs = _k9_start(traj_0_0, n, None)
    lam0, rho = torch.zeros(n, 14), torch.tensor(1e-3)
    merit0 = _merit0(model, X, U, goals, xs)
    reset_launch_counts()
    k4._pcg_dz_on(use, ks, lam0, 3, 1e-5, None)
    k4._pcg_solve_on(use, S, P, ks.gamma, lam0, 3, 1e-5, None)
    k5._solve_pcg_on(use, model, X, U, goals, xs, lam0, rho, 1.0, merit0,
                     3, 1e-5, 1, *_long_kw().values())
    k9._iter_pcg_on(use, model, X, U, goals, xs, lam0, rho, 1.0, merit0,
                    3, 1e-5, *_long_kw().values())
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    assert [k4.pcg_plan(m, use).form for m in (n, 384, 385)] == [
        k4.CLUSTER if n <= 384 else k4.JOINED, k4.CLUSTER, k4.JOINED]
    want.update(dict(K4=1, K4b=1) if n <= 384 else dict(K4g=1, K4bg=1))
    want.update(dict(K5=1, K9p=1) if cluster else dict(K5g=1, K9pg=1))
    assert counts == want, n
    if cluster:
        assert int(k5.sqp_solve_mega_pcg.cluster_size) == 1
        assert int(k9.sqp_iter_mega_pcg.cluster_size) == 1


@pytest.mark.parametrize("rho", [1e-3, 0.3])
def test_k5_cluster_form_at_long_horizons_matches_plain(host, traj_0_0, rho):
    """K5's cluster form at N = 128 (the horizons K5g served before),
    K5g's check (test_k5g_host_build_matches_plain) at its tolerances:
    X, U at rtol 1e-3, atol 1e-5; lam at rtol 1e-3, atol 1e-4; decisions
    identical; CG counts within 2; at rho 0.3 a CG exits before the cap.
    The stair bands in L2 and on chip give the same bits."""
    lib, model, tab = host
    n = 128
    X, U, goals, xs = _k9_start(traj_0_0, n, None)
    kw = _long_kw()
    args = (X, U, goals, xs, torch.zeros(n, 14), torch.tensor(rho), 1.0,
            _merit0(model, X, U, goals, xs), 24, 1e-5, 4)
    want = k5.sqp_solve_mega_pcg_reference(model, *args, **kw)
    assert k5.pcg_kind(n, lib) == k5.SOLVE_PCG
    got = k5._launch(lib, tab, *args, grid=k5.check_mega_fit(n, lib),
                     stream=None, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    for f in ("sqp_iters", "bailed", "hit_max", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int((got.pcg_iters - want.pcg_iters).abs().max()) <= 2
    if rho == 0.3:
        assert bool(((want.pcg_iters >= 0) & (want.pcg_iters < 24)).any())
    in_l2 = k5._launch(lib, tab, *args, grid=k5.check_mega_fit(
        n, lib, stair=0), stream=None, stair=0, **kw)
    for a, b in zip(got, in_l2):
        assert torch.equal(a, b)


def test_four_k9p_launches_equal_one_k5_launch(host, traj_0_0):
    """sqp.iterate over four K9p launches against one K5 launch, both the
    cluster form, N = 128, through the host build: the same body, bit for
    bit."""
    from mpcgpu_tpu_torch.sqp import iterate

    lib, model, tab = host
    n = 128
    X, U, goals, xs = _k9_start(traj_0_0, n, None)
    kw = _long_kw()
    merit0, lam0, rho = (_merit0(model, X, U, goals, xs), torch.zeros(n, 14),
                         torch.tensor(1e-3))
    once = k5._launch(lib, tab, X, U, goals, xs, lam0, rho, 1.0, merit0, 24,
                      1e-5, 4, grid=1, stream=None, **kw)

    def step(Xc, Uc, lamc, rhoc, drhoc, meritc):
        return k9._launch_iter(lib, k9.ITER_PCG, tab, Xc, Uc, goals, xs,
                               lamc, rhoc, drhoc, meritc, 24, 1e-5, **kw,
                               grid=1, stream=None)

    four = iterate(X, U, lam0, rho, torch.tensor(1.0), merit0, 4, step)
    for got, want in zip(four, (once.X, once.U, once.lam, once.rho, once.drho,
                                once.merit, once.sqp_iters, once.bailed,
                                once.pcg_iters, once.hit_max, once.accepted)):
        assert torch.equal(got, want)


def test_a_grid_that_cannot_be_co_resident_raises():
    """No launch is made, and nothing falls back, where the occupancy API
    finds no co-resident grid: K4's and K4b's plan (either form, and the
    joined form asked for) and K5g's."""

    class NoGrid:
        def mpc_pcg_plan(self, n, dz, form, cluster, place, out):
            return 0

        def mpc_mega_max_knots(self, kind):
            return 1 << 16

        def mpc_mega_grid(self, n, kind):
            return 0

    lib = NoGrid()
    for dz in (True, False):
        for form in (0, k4.JOINED):
            with pytest.raises(ValueError, match="cooperative launch"):
                k4._checked_plan(256, lib, dz, form)
    with pytest.raises(ValueError, match="cooperative launch"):
        k5.check_mega_fit(256, lib, k5.SOLVE_PCG_GRID)


@pytest.mark.parametrize("nl", [1, 2, 64])
@pytest.mark.parametrize("halos", ["zero", "nonzero"])
def test_k11_host_build_matches_plain(host, nl, halos):
    """K11 through the host build against spmv_halo_reference on seeded
    random bands: within 1e-5 of max|y| (float32 sums of 42 products in
    another order)."""
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11

    lib = host[0]
    rng = np.random.default_rng(nl)
    f32 = lambda *shape: T(rng.normal(size=shape).astype(np.float32))
    L, D, U = f32(nl, 14, 14), f32(nl, 14, 14), f32(nl, 14, 14)
    x = f32(nl, 14)
    xl, xr = ((f32(14), f32(14)) if halos == "nonzero"
              else (torch.zeros(14), torch.zeros(14)))
    got = k11._launch(lib, [(L, D, U)], [x], xl, xr, None)[0]
    want = k11.spmv_halo_reference(L, D, U, x, xl, xr)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shards,nl", [(1, 1), (1, 2), (1, 5), (3, 1),
                                       (3, 2), (3, 5), (8, 1), (8, 2),
                                       (8, 5), (70, 1)])
@pytest.mark.parametrize("halos", ["zero", "nonzero"])
def test_k11_all_shard_launch_equals_per_shard_launches(host, shards, nl,
                                                        halos):
    """K11 over consecutive shards in one launch (70 shards: two, a group
    of 64 and one of 6, the second's outer row the first's last x row),
    given the rows outside them, against one launch per shard with its
    neighbours' edge rows as halos: bit for bit; and within 1e-5 of max|y|
    of the plain version (float32 sums of 42 products in another
    order)."""
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11

    lib = host[0]
    assert lib.mpc_spmv_halo_max_shards() == 64
    rng = np.random.default_rng(100 * shards + nl)
    f32 = lambda *shape: T(rng.normal(size=shape).astype(np.float32))
    bands = [(f32(nl, 14, 14), f32(nl, 14, 14), f32(nl, 14, 14))
             for _ in range(shards)]
    xs = [f32(nl, 14) for _ in range(shards)]
    xl, xr = ((f32(14), f32(14)) if halos == "nonzero"
              else (torch.zeros(14), torch.zeros(14)))
    got = k11._launch(lib, bands, xs, xl, xr, None)
    want = k11.spmv_halo_shards_reference(bands, xs, xl, xr)
    assert len(got) == shards
    for i, (b, x) in enumerate(zip(bands, xs)):
        left = xs[i - 1][-1] if i > 0 else xl
        right = xs[i + 1][0] if i < shards - 1 else xr
        one = k11._launch(lib, [b], [x], left, right, None)[0]
        assert torch.equal(got[i], one), i
        assert (float((got[i] - want[i]).abs().max())
                <= 1e-5 * float(want[i].abs().max())), i


def test_k11_cg_through_the_host_build_matches_plain(host, monkeypatch):
    """pcg_sharded_cuda with every K11 launch through the host build, on
    an in-process mesh of 4 shards (N = 16, the seeded random system with
    the stair), against pcg_sharded: iterations equal, lam within 1e-5 of
    max|lam|; each SpMV is one launch over the 4 shards, 2 + 2 x cap a
    solve."""
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11
    from mpcgpu_tpu_torch.parallel import pcg_sharded_cuda as mod
    from mpcgpu_tpu_torch.parallel.pcg_sharded import pcg_sharded
    from mpcgpu_tpu_torch.parallel.sharded import horizon_mesh

    lib = host[0]
    launches = []

    def through_host(bands, xs, xl, xr):
        launches.append(len(xs))
        return k11._launch(lib, bands, xs, xl, xr, None)

    monkeypatch.setattr(mod, "spmv_halo_shards", through_host)
    ks = random_system(16, seed=11, precond=True)
    S = BlockTri(*(T(ks[f]) for f in ("SL", "SD", "SU")))
    P = BlockTri(*(T(ks[f]) for f in ("PL", "PD", "PU")))
    mesh = horizon_mesh(4, device="cpu")
    args = (S, P, T(ks["gamma"]), torch.zeros(16, 14), 12, 1e-10)
    lam, iters, hit = mod.pcg_sharded_cuda(mesh, *args)
    lam_p, iters_p, hit_p = pcg_sharded(mesh, *args)
    assert int(iters) == int(iters_p) and bool(hit) == bool(hit_p)
    assert float((lam - lam_p).abs().max()) <= 1e-5 * float(lam_p.abs().max())
    assert launches == [4] * (2 + 2 * 12)
