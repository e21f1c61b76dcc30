"""The CUDA kernels' arithmetic at two joints, checked without a GPU.

csrc/*.cu built by the host C++ compiler for NJ = 2
(``_lib.host_library(2)``, ``-DMPC_NJ=2``: the sources of K1-K5) and run
on the planar 2R arm (models/planar2r.py) with its synthesized fixture
(utils/synth.py): lanedyn.cuh's routines, K3 (with and without the
stair), K1, K2, K4 and K5 against their plain PyTorch versions, with one
thread taking every lane and with the block's threads emulated, 32 lanes
a warp, which must give the same bits (as tests/test_torch_csrc_host.py
asks of the 7-joint build).  K3's A is also held column by column: the
tangent direction of the last joint's position is the one a scratch
layout written for 7 joints got wrong.
"""
import contextlib
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models.planar2r import planar2r
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
from mpcgpu_tpu_torch.utils.synth import synthesize_tracking_fixture
from mpcgpu_tpu_torch.utils.trajfiles import horizon_slices

torch.set_num_threads(1)

T = torch.as_tensor
NQ, NX = 2, 4
N = 8
DT, QD_COST, R_COST, RHO, MU = 0.05, 1e-3, 1e-4, 1e-3, 10.0
GRAV = -9.81
LANES = [1, 32]


@pytest.fixture(scope="module")
def host():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no host C++ compiler")
    model = planar2r(device="cpu")
    lib = _lib.host_library(NQ)
    assert lib.joints == NQ
    return lib, model, _lib.model_tables(model)


@pytest.fixture(scope="module")
def fixture(host):
    """The synthesized fixture of the chip smoke's second-robot phase."""
    return synthesize_tracking_fixture(host[1], q0=[0.4, 0.6],
                                       amplitude=0.35, n_steps=64, dt=DT)


def _problem(fixture, n=N, seed=0, scale=0.05):
    """(X, U, goals, xs) near the fixture's first n rows, X perturbed."""
    xu, ee = fixture
    X, U, goals, xs = horizon_slices(xu, ee, n, nx=NX)
    X = X + scale * np.random.default_rng(seed).normal(size=X.shape)
    return T(X.astype(np.float32)), T(U), T(goals), T(xs)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol)


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


def _states(seed, count=3):
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: T(rng.uniform(lo, hi, NQ).astype(np.float32))
    return [(f(-2, 2), f(-1, 1), f(-10, 10), f(-2, 2)) for _ in range(count)]


# ---- lanedyn.cuh's routines at NJ = 2, each launched alone

def _aba(lib, tab, model, q, qd, u, qdd):
    from mpcgpu_tpu_torch.models.dynamics import forward_dynamics
    out = torch.zeros(NQ)
    lib.mpc_ld_aba_host(_ptr(tab), _ptr(q), _ptr(qd), _ptr(u), GRAV,
                        _ptr(out))
    return (out,), (forward_dynamics(model, q, qd, u, GRAV),)


def _crba(lib, tab, model, q, qd, u, qdd):
    from mpcgpu_tpu_torch.models.dynamics import mass_matrix
    M = torch.zeros(NQ, NQ)
    lib.mpc_ld_crba_host(_ptr(tab), _ptr(q), _ptr(M))
    return (M,), (mass_matrix(model, q),)


def _rnea(lib, tab, model, q, qd, u, qdd):
    from mpcgpu_tpu_torch.models.dynamics import rnea
    tau, prim = torch.zeros(NQ), torch.zeros(5, NQ, 6)
    lib.mpc_ld_rnea_host(_ptr(tab), _ptr(q), _ptr(qd), _ptr(qdd), GRAV,
                         _ptr(tau), _ptr(prim))
    # the backward force accumulators the tangents seed from, facc[j]
    # (RneaPrimal's last field): tau is their z entries
    return (tau, prim[4, :, 2]), (rnea(model, q, qd, qdd, GRAV),) * 2


def _fk(lib, tab, model, q, qd, u, qdd):
    from mpcgpu_tpu_torch.models.dynamics import ee_pos_and_jac
    ee, J = torch.zeros(3), torch.zeros(3, NQ)
    lib.mpc_ld_fk_host(_ptr(tab), _ptr(q), _ptr(ee), _ptr(J))
    pose, J_ref = ee_pos_and_jac(model, q)
    return (ee, J), (pose[:3], J_ref)


def _dtau(lib, tab, model, q, qd, u, qdd):
    from mpcgpu_tpu_torch.models.dynamics import rnea
    dtau = torch.zeros(NQ, NX)
    lib.mpc_ld_dtau_host(_ptr(tab), _ptr(q), _ptr(qd), _ptr(qdd), GRAV,
                         _ptr(dtau))
    want = torch.func.jacfwd(lambda x: rnea(model, x[:NQ], x[NQ:], qdd,
                                            GRAV))(torch.cat([q, qd]))
    return (dtau,), (want,)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("routine", [_aba, _crba, _rnea, _fk, _dtau])
def test_two_joint_routines_match_plain(host, routine, lanes):
    """ABA, CRBA, RNEA with the backward pass the tangents seed from, FK
    with its Jacobian, and the 2 NJ = 4 tangent directions (on 8-lane
    groups of a 128-thread block when emulated, 12 of its 16 groups only
    keeping step), at the 7-joint tests' tolerances."""
    lib, model, tab = host
    for i, (q, qd, u, qdd) in enumerate(_states(7)):
        wants = []

        def run():
            got, want = routine(lib, tab, model, q, qd, u, qdd)
            wants[:] = want
            return got
        got = _both_lanes(lib, lanes, run)
        for g, w in zip(got, wants):
            _close(g, w, 2e-3, 2e-4)


# ---- the kernels at NJ = 2

@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("precond", [True, False])
def test_k3_two_joints_matches_plain(host, fixture, precond, lanes):
    """K3 on the planar arm against form_kkt + form_schur: every field at
    the 7-joint test's rtol 3e-3, atol 3e-3; A's dynamics rows column by
    column to 1e-5 of the largest entry, since the error of a wrong
    tangent direction (0.078 in the column of the last joint's position,
    entries up to 1.03, with the primal chain's backward pass of a 7-joint
    scratch layout) sits inside the loose tolerance's reach of S; and at
    32 emulated lanes the bits of one lane."""
    lib, model, tab = host
    X, U, goals, xs = _problem(fixture)
    want = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                       QD_COST, R_COST, precond=precond)
    got = _both_lanes(lib, lanes, lambda: k3._launch(
        lib, tab, X, U, goals, torch.tensor(RHO), DT, QD_COST, R_COST, 0.0,
        precond, None))
    got = k3.KnotSchur(*got)
    for f in k3.KnotSchur._fields:
        _close(getattr(got, f), getattr(want, f), 3e-3, 3e-3)
    scale = float(want.A.abs().max())
    for col in range(NX):
        err = float((got.A[:-1, NQ:, col] - want.A[:-1, NQ:, col]).abs().max())
        assert err <= 1e-5 * scale, f"A column {col}: {err}"


# joint tracking (q_cost 2.0, the fixture's state rows as goals) with
# semi-implicit Euler: the knob case of K3 and K2 at two joints
JOINT_SEMI = _lib.Knobs(tracking="joint", integrator_type=1, q_cost=2.0)


def _joint_problem(fixture):
    X, U, _, xs = _problem(fixture)
    return X, U, T(fixture[0][:N, :NX].copy()), xs


@pytest.mark.parametrize("lanes", LANES)
def test_k3_two_joints_under_joint_tracking_and_semi_implicit_euler(
        host, fixture, lanes):
    """K3 at two joints under JOINT_SEMI against its plain version, at
    test_k3_two_joints_matches_plain's tolerances (A's columns too), and
    at 32 emulated lanes the bits of one lane."""
    lib, model, tab = host
    X, U, goals, xs = _joint_problem(fixture)
    want = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                       QD_COST, R_COST, knobs=JOINT_SEMI)
    got = k3.KnotSchur(*_both_lanes(lib, lanes, lambda: k3._launch(
        lib, tab, X, U, goals, torch.tensor(RHO), DT, QD_COST, R_COST, 0.0,
        True, None, JOINT_SEMI)))
    for f in k3.KnotSchur._fields:
        _close(getattr(got, f), getattr(want, f), 3e-3, 3e-3)
    scale = float(want.A.abs().max())
    for col in range(NX):
        err = float((got.A[:-1, :, col] - want.A[:-1, :, col]).abs().max())
        assert err <= 1e-5 * scale, f"A column {col}: {err}"


def test_k2_two_joints_under_joint_tracking_and_semi_implicit_euler(
        host, fixture):
    """K2 at two joints under JOINT_SEMI: the plain merits at K2's
    tolerances, and with its threads emulated one thread's bits."""
    lib, model, tab = host
    X, U, goals, xs = _joint_problem(fixture)
    rng = np.random.default_rng(5)
    dX = T((0.05 * rng.normal(size=tuple(X.shape))).astype(np.float32))
    dU = T((0.05 * rng.normal(size=tuple(U.shape))).astype(np.float32))
    want = k2.line_search_merits_reference(model, X, U, dX, dU, 8, goals, xs,
                                           DT, MU, QD_COST, R_COST,
                                           knobs=JOINT_SEMI)
    args = (lib, tab, X, U, dX, dU, 8, goals, xs, DT, MU, QD_COST, R_COST,
            0.0, None)
    with _lanes(lib, 1):
        one = k2._launch(*args, knobs=JOINT_SEMI)
    _close(one, want, 2e-4, 2e-4)
    with _lanes(lib, 32):
        assert torch.equal(k2._launch(*args, knobs=JOINT_SEMI), one)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("offset_us,sim_time_us",
                         [(0.0, 2000.0), (2000.0, 2000.0), (1500.0, 700.0)])
def test_k1_two_joints_matches_plain(host, fixture, offset_us, sim_time_us,
                                     lanes):
    lib, model, tab = host
    xu, ee = fixture
    cfg = dataclasses.replace(SolverConfig.for_knots(16), state_size=NX,
                              control_size=NQ, timestep=DT)
    xs, U_prev, goal0 = T(xu[3, :NX]), T(xu[:15, NX:].copy()), T(ee[0])
    want = k1.plant_rollout_reference(model, cfg, xs, U_prev, goal0,
                                      offset_us, sim_time_us, 11)
    got = _both_lanes(lib, lanes, lambda: k1._launch(
        lib, tab, cfg, xs, U_prev, goal0, offset_us, sim_time_us, 11, None))
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-5)


def test_k2_two_joints_matches_plain(host, fixture):
    """K2 at its own group size and at 8 lanes, its blocks' threads
    emulated: the plain merits at K2's tolerances, and one thread's bits."""
    lib, model, tab = host
    X, U, goals, xs = _problem(fixture)
    rng = np.random.default_rng(5)
    dX = T((0.05 * rng.normal(size=tuple(X.shape))).astype(np.float32))
    dU = T((0.05 * rng.normal(size=tuple(U.shape))).astype(np.float32))
    xs = xs + 0.01
    want = k2.line_search_merits_reference(model, X, U, dX, dU, 8, goals, xs,
                                           DT, MU, QD_COST, R_COST)
    args = (lib, tab, X, U, dX, dU, 8, goals, xs, DT, MU, QD_COST, R_COST,
            0.0, None)
    with _lanes(lib, 1):
        one = k2._launch(*args)
    _close(one, want, 2e-4, 2e-4)
    for group in (0, 8):
        with _lanes(lib, 32):
            got = k2._launch(*args, group=group)
        assert torch.equal(got, one), f"groups of {group} lanes"


@pytest.mark.parametrize("cap,tol", [(300, 1e-9), (30, 1e-6)])
def test_k4_two_joints_matches_plain(host, fixture, cap, tol):
    """K4's cluster form on C = 2 and 4 emulated blocks and its joined form
    on 2 clusters of 2, fed the plain K3's system: lam, dX, dU at rtol
    5e-3, atol 5e-3; CG counts within 2 or both at the cap; the same hit
    flag."""
    lib, model, _ = host
    X, U, goals, xs = _problem(fixture)
    ks = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                     QD_COST, R_COST)
    lam0 = torch.zeros(N, NX)
    want = k4.pcg_dz_reference(ks, lam0, cap, tol)
    for form, c in ((k4.CLUSTER, 2), (k4.CLUSTER, 4), (k4.JOINED, 2)):
        plan = k4.pcg_plan(N, lib, True, form, c)
        assert plan.form == form and plan.cluster == c
        lib.mpc_emu_threads_host(0)
        got = k4._launch(lib, ks, lam0, cap, tol, None, plan)
        assert lib.mpc_emu_threads_host(0) == 0, "the block emulation hung"
        for g, w in zip(got[:3], want[:3]):
            _close(g, w, 5e-3, 5e-3)
        assert (abs(int(got[3]) - int(want[3])) <= 2
                or int(got[3]) == int(want[3]) == cap)
        assert bool(got[4]) == bool(want[4])


def _k5_start(fixture, n, rho_max, dtype=torch.float32):
    """K5's inputs from a perturbed start, and its keywords."""
    X, U, goals, xs = (a.to(dtype) for a in _problem(fixture, n, seed=5,
                                                      scale=0.02))
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=MU,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=rho_max,
              rho_reset=1e-3)
    return X, U, goals, xs, kw


def _merit0(model, X, U, goals, xs):
    return k2.line_search_merits_reference(
        model, X, U, torch.zeros_like(X), torch.zeros_like(U), 8, goals, xs,
        DT, MU, QD_COST, R_COST)[8]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n,rho_max", [(8, 10.0), (8, 1e-3)])
def test_k5_two_joints_matches_plain(host, fixture, n, rho_max, lanes):
    """The whole solve (one block walks every knot) against the staged
    plain loop from a perturbed start, 3 SQP iterations, cap 40 and exit
    tolerance 5e-5 as the 7-joint test's at N = 8, at its tolerances: X,
    U at rtol 1e-3, atol 1e-5; lam at rtol 1e-3, atol 1e-4; decisions
    identical; CG counts within 2; rho_max = rho_min bails at the first
    rejected step.  At 32 emulated lanes (the block's 128 threads) the
    bits of one lane."""
    lib, model, tab = host
    X, U, goals, xs, kw = _k5_start(fixture, n, rho_max)
    args = (X, U, goals, xs, torch.zeros(n, NX), torch.tensor(RHO), 1.0,
            _merit0(model, X, U, goals, xs), 40, 5e-5, 3)
    want = k5.sqp_solve_mega_pcg_reference(model, *args, **kw)
    assert k5.check_mega_fit(n, lib) == 1
    got = _both_lanes(lib, lanes, lambda: k5._launch(
        lib, tab, *args, grid=1, stream=None, **kw))
    got = k5.MegaResult(*got)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    for f in ("sqp_iters", "bailed", "hit_max", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    its, want_its = got.pcg_iters, want.pcg_iters
    assert torch.equal(its < 0, want_its < 0)
    assert int((its - want_its).abs().max()) <= 2
    if rho_max == 1e-3:
        assert bool(got.bailed) and int(got.sqp_iters) < 3


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("n", [8, 16])
def test_k5_two_joints_at_the_smoke_settings_against_float64(host, fixture,
                                                             n, lanes):
    """The chip smoke's solve settings (CG cap 30, exit tolerance 1e-6, 3
    SQP iterations, rho 1e-3) at N = 8 and 16: every step is accepted, and
    the float32 solves part by up to 2.4e-3 in X after three of them (N =
    8) -- the plain version's the farther from the float64 plain solve.
    K5 (at 32 emulated lanes with one lane's bits) and the float32 plain
    solve each within 3e-3 of the float64 solve; K5's decisions the
    float64 solve's, its CG counts within 2."""
    lib, model, tab = host
    X, U, goals, xs, kw = _k5_start(fixture, n, 10.0)
    args = (X, U, goals, xs, torch.zeros(n, NX), torch.tensor(RHO), 1.0,
            _merit0(model, X, U, goals, xs), 30, 1e-6, 3)
    got = k5.MegaResult(*_both_lanes(lib, lanes, lambda: k5._launch(
        lib, tab, *args, grid=1, stream=None, **kw)))
    plain = k5.sqp_solve_mega_pcg_reference(model, *args, **kw)
    m64 = planar2r(device="cpu", dtype=torch.float64)
    f64 = lambda a: a.double() if isinstance(a, torch.Tensor) else a
    ref = k5.sqp_solve_mega_pcg_reference(m64, *map(f64, args), **kw)
    assert bool(ref.accepted.all())
    for out in (got, plain):
        _close(out.X.double(), ref.X, 0, 3e-3)
        _close(out.lam.double(), ref.lam, 0, 3e-3)
    for f in ("sqp_iters", "accepted"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert int((got.pcg_iters - ref.pcg_iters).abs().max()) <= 2


def test_two_joint_library_leaves_out_the_iiwa_only_kernels(host):
    """The 2-joint build holds K1-K5's entries and none of K6, K7, K7s,
    K10 and K11's sources; the wrappers of K4b, K6, K7 and K9p raise by
    name for a 2-joint problem before any launch."""
    lib, model, _ = host
    for name in ("mpc_rollout", "mpc_merits", "mpc_kkt_schur", "mpc_pcg",
                 "mpc_sqp_mega"):
        assert hasattr(lib, name), name
    for name in ("mpc_bcr_pcg_dz", "mpc_bcr_dz", "mpc_sqp_mega_packed",
                 "mpc_spmv_halo"):
        assert not hasattr(lib, name), name
    with pytest.raises(ValueError, match="K6"):
        _lib.require_iiwa(_lib.width_joints(NX), "K6 (bcr_pcg_dz)")
    with pytest.raises(ValueError, match="2 joints"):
        _lib.expect_joints(lib, 7)
