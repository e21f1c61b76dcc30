"""The CUDA kernels K1-K7, K7s, K9p, K9b, K10 and K11 (K1-K5 also built for
the planar 2R arm's two joints, whose other wrappers raise), K3 at the long
horizons of the TPU's tiled K8, K4 and K4b in both forms (the cluster
form K4, K4b and the joined form K4g, K4bg, at every cluster size the
card admits, and bit for bit K9p's and K9pg's dual solve), the joined
forms K5g and K9pg (at every cluster size the card admits for them), the
cluster forms of K5, K9p, K6, K7, K7s, K9b and K10 at every cluster size
the card admits (K10 also in its one-block form), and K11 over every
local shard in one launch, against their plain versions, on the card;
and the card twins of tests/test_torch_host_loop.py: the real-time host
loop's launches, the host loop against the scan, the fine-grained mode's
K4b, the time box's K9p and the forward-kinematics fixture trace; and the
solver knobs' cases of tests/test_torch_csrc_host.py (K3 and K2 at N = 64,
K5, K9p, K9b and K10 at N = 8, one SQP iteration, held with the float64
plain version as the yardstick).

Marked ``cuda``: each test needs a CUDA device and skips without one.
The file uses no fixture of tests/conftest.py, which imports JAX, so on a
GPU machine without JAX it runs with

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Inputs are the slice's: fixture 0_0 at N = 64 (K6 and K7 also on the JAX
BCR tests' well-conditioned random system of tests/torch_systems.py; K10
with two arms from seeded perturbations, as chip_smoke.py checks it).
The exact BCR solves (K7, K7s, K9b) are judged by relative residual on
the fixture's systems (condition ~1e7), where two float32 solves part by
~1e-3 of |lam|: the kernel's within 2x of the plain version's.
Tolerances are those of the JAX package's own kernel tests, each stated
beside its check.
"""
from pathlib import Path

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
from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair
# by its bare name (pytest puts tests/ on sys.path): the card machine may
# have another package named "tests"
from torch_systems import (K3_TOLS, KNOB_CASES, SOLVE_TOLS, as_float64,
                           bcr_iteration_given_lam, knob_start, packed_arms,
                           random_knot_schur, relative_residual,
                           residual_near_float64, with_resting_arm,
                           within_twice_plain, wrap_changes_defects)

pytestmark = pytest.mark.cuda

DT, QD_COST, R_COST, RHO = 0.015625, 1e-4, 1e-3, 1e-3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    xu, ee = load_fixture_pair(Path(__file__).resolve().parent / "fixtures")
    n = 64
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return dict(model=iiwa14(device=dev), X=t(xu[:n, :14]), U=t(xu[:n - 1, 14:]),
                goals=t(ee[:n]), xs=t(xu[0, :14]), rho=torch.tensor(RHO, device=dev))


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _k3_args(c):
    return (c["model"], c["X"], c["U"], c["goals"], c["xs"], c["rho"], DT,
            QD_COST, R_COST)


def test_k3_kernel_matches_plain(card):
    got = k3.form_kkt_schur(*_k3_args(card))
    want = k3.form_kkt_schur_reference(*_k3_args(card))
    for g, w in zip(got, want):
        _close(g, w, 3e-3, 3e-3)


def test_k4_kernel_matches_plain(card):
    ks = k3.form_kkt_schur_reference(*_k3_args(card))
    lam0 = torch.zeros_like(card["X"])
    got = k4.pcg_dz(ks, lam0, 40, 5e-5)
    want = k4.pcg_dz_reference(ks, lam0, 40, 5e-5)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 5e-3, 5e-3)
    it, it_ref = int(got[3]), int(want[3])
    assert abs(it - it_ref) <= 2 or it == it_ref == 40


def test_k2_kernel_matches_plain(card):
    c = card
    gen = np.random.default_rng(5)
    dX = torch.as_tensor(0.05 * gen.normal(size=(64, 14)), dtype=torch.float32,
                         device=c["X"].device)
    dU = torch.as_tensor(0.05 * gen.normal(size=(63, 7)), dtype=torch.float32,
                         device=c["X"].device)
    args = (c["model"], c["X"], c["U"], dX, dU, 8, c["goals"], c["xs"], DT,
            10.0, QD_COST, R_COST)
    _close(k2.line_search_merits(*args), k2.line_search_merits_reference(*args),
           2e-4, 2e-4)


def _k2_args_at(card, n):
    """K2's inputs at n knots: fixture 0_0's rows repeated to n, a seeded
    0.05-scale step, gravity on."""
    dev = card["X"].device
    xu, ee = load_fixture_pair(Path(__file__).resolve().parent / "fixtures")
    rows = np.resize(np.arange(xu.shape[0]), n)
    gen = np.random.default_rng(n)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                                  device=dev)
    return (card["model"], t(xu[rows, :14]), t(xu[rows[:-1], 14:]),
            t(0.05 * gen.normal(size=(n, 14))),
            t(0.05 * gen.normal(size=(n - 1, 7))), 8, t(ee[rows]),
            t(xu[0, :14]), DT, 10.0, QD_COST, R_COST, -9.81)


@pytest.mark.parametrize("n", [2, 64, 256, 1024])
def test_k2_kernel_matches_plain_at_every_horizon(card, n):
    """K2 (groups of 32, 16 or 8 lanes by its pair count) at N = 2 to its
    limit of 1024, at K2's tolerances."""
    args = _k2_args_at(card, n)
    _close(k2.line_search_merits(*args), k2.line_search_merits_reference(*args),
           2e-4, 2e-4)


@pytest.mark.parametrize("n", [64, 1024])
def test_k2_kernel_gives_the_same_bits_on_two_launches(card, n):
    """Each candidate's sum runs in knot order in the last block done, so
    two launches agree bit for bit (N = 64: groups of 32 lanes; 1024: of
    8), and every group size stays at K2's tolerances."""
    args = _k2_args_at(card, n)
    first = k2.line_search_merits(*args)
    assert torch.equal(k2.line_search_merits(*args), first)
    model, X, U, dX, dU, na, goals, xs, dt, mu, qd, r, grav = args
    for group in (8, 16, 32):
        got = k2._launch(k2._lib.library(), k2._lib.model_tables(model), X, U,
                         dX, dU, na, goals, xs, dt, mu, qd, r, grav,
                         k2._lib.stream_of(X), group=group)
        _close(got, k2.line_search_merits_reference(*args), 2e-4, 2e-4)


@pytest.mark.parametrize("offset_us,sim_time_us",
                         [(0.0, 2000.0), (2000.0, 2000.0), (1500.0, 700.0)])
def test_k1_kernel_matches_plain(card, offset_us, sim_time_us):
    c = card
    args = (c["model"], SolverConfig.for_knots(64), c["xs"], c["U"],
            c["goals"][0], offset_us, sim_time_us, 11)
    for g, w in zip(k1.plant_rollout(*args), k1.plant_rollout_reference(*args)):
        _close(g, w, 1e-4, 1e-5)


@pytest.mark.parametrize("n", [2, 64, 256, 1024])
def test_k3_kernel_matches_plain_at_every_horizon(card, n):
    """K3 (its warp-cooperative stage bodies) at N = 2 to 1024: fixture
    0_0's rows repeated to n knots, every knot but 0 moved by a seeded
    0.02-scale draw; S's bands within 1e-5 of each band's largest entry,
    the other blocks at rtol 3e-3, atol 3e-3, as test_k8_horizons_run_k3."""
    dev = card["X"].device
    xu, ee = load_fixture_pair(Path(__file__).resolve().parent / "fixtures")
    rows = np.resize(np.arange(xu.shape[0]), n)
    pert = 0.02 * np.random.default_rng(0).normal(size=(n, 14))
    pert[0] = 0.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                                  device=dev)
    args = (card["model"], t(xu[rows, :14] + pert), t(xu[rows[:-1], 14:]),
            t(ee[rows]), t(xu[0, :14]), card["rho"], DT, QD_COST, R_COST)
    got, want = k3.form_kkt_schur(*args), k3.form_kkt_schur_reference(*args)
    for f in k3.KnotSchur._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f in ("SL", "SD", "SU"):
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
        else:
            _close(g, w, 3e-3, 3e-3)


def test_k6_kernel_matches_plain_on_a_random_system(card):
    """The JAX BCR tests' tolerances (tests/test_bcr.py:62-74): lam scaled
    by its largest entry at atol 2e-5, dX and dU at atol 2e-4, rtol 1e-3;
    CG iterations within 1."""
    ks = random_knot_schur(64, device=card["X"].device)
    lam0 = torch.zeros_like(ks.gamma)
    got = k6.bcr_pcg_dz(ks, lam0, 40, 5e-5)
    want = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
    scale = want[0].abs().max()
    _close(got[0] / scale, want[0] / scale, 0, 2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        _close(g, w, 1e-3, 2e-4)
    assert abs(int(got[3]) - int(want[3])) <= 1


def _perturbed_X(c, seed=5):
    """The slice's X with a seeded perturbation (knot 0 kept), so that the
    CG loops iterate."""
    pert = 0.02 * np.random.default_rng(seed).normal(size=(64, 14))
    pert[0] = 0.0
    return c["X"] + torch.as_tensor(pert, dtype=torch.float32,
                                    device=c["X"].device)


def test_k6_kernel_residual_on_the_slice_system(card):
    """K3's preconditioned=False system of the slice at the perturbed start
    (condition ~1e7): judged by residual, each solve within 1e-3 of
    |gamma|; CG iterations within 1."""
    c = card
    ks = k3.form_kkt_schur_reference(c["model"], _perturbed_X(c),
                                     *_k3_args(c)[2:], precond=False)
    lam0 = torch.zeros_like(card["X"])
    got = k6.bcr_pcg_dz(ks, lam0, 40, 5e-5)
    want = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
    S = BlockTri(ks.SL, ks.SD, ks.SU)
    for lam in (got[0], want[0]):
        res = (spmv(S, lam) - ks.gamma).abs().max() / ks.gamma.abs().max()
        assert float(res) < 1e-3
    assert abs(int(got[3]) - int(want[3])) <= 1


def _k5_pair(c, rho):
    """K5 and its plain version: 4 SQP iterations from the perturbed start,
    cold duals, carried rho, cap 40, tol 5e-5."""
    X = _perturbed_X(c)
    zero = torch.zeros_like
    merit0 = k2.line_search_merits_reference(
        c["model"], X, c["U"], zero(X), zero(c["U"]), 8, c["goals"], c["xs"],
        DT, 10.0, QD_COST, R_COST)[8]
    args = (c["model"], X, c["U"], c["goals"], c["xs"], zero(X),
            torch.tensor(rho, device=X.device), 1.0, merit0, 40, 5e-5, 4)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)
    got = k5.sqp_solve_mega_pcg(*args, **kw)
    want = k5.sqp_solve_mega_pcg_reference(*args, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    for f in ("sqp_iters", "bailed", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int((got.pcg_iters - want.pcg_iters).abs().max()) <= 2
    return got, want


def test_k5_kernel_matches_plain(card):
    """At the slice's rho = 1e-3.  X, U at rtol 1e-3, atol 1e-5
    (tests/test_megakernel.py:115-125); accepted, sqp_iters and rho_bailed
    identical; CG iterations within 2 per SQP iteration.  Every CG stops
    at the cap here, on a system of condition ~1e7, where two float32 CG
    loops summing in different orders part by up to 5.4e-4 in lam (on an
    H100): lam at atol 1e-3, rtol 0."""
    got, want = _k5_pair(card, RHO)
    _close(got.lam, want.lam, 0, 1e-3)


@pytest.mark.parametrize("rho", [0.1, 0.3])
def test_k5_kernel_matches_plain_where_the_cg_exits_early(card, rho):
    """At a rho the schedule reaches after rejected steps, where CGs exit
    before the cap (the exit every block must take alike): the checks of
    test_k5_kernel_matches_plain, lam at rtol 1e-3, atol 1e-4
    (tests/test_megakernel.py:115-125), and at least one early exit."""
    got, want = _k5_pair(card, rho)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    assert bool(((want.pcg_iters >= 0) & (want.pcg_iters < 40)).any())


def test_k1_arm_batched_launch_equals_single_launches(card):
    """One arm-batched K1 launch (a block per arm) against one single K1
    launch per arm: bit-equal, the same per-arm arithmetic in the same
    order."""
    c = card
    dev = c["X"].device
    gen = np.random.default_rng(9)
    x = c["xs"] + torch.as_tensor(0.01 * gen.normal(size=(2, 14)),
                                  dtype=torch.float32, device=dev)
    U = c["U"] + torch.as_tensor(0.01 * gen.normal(size=(2, 63, 7)),
                                 dtype=torch.float32, device=dev)
    rest = (c["goals"][0], 2000.0, 2000.0, 11)
    cfg = SolverConfig.for_knots(64)
    got = k1.plant_rollout(c["model"], cfg, x, U, *rest)
    for a in range(2):
        one = k1.plant_rollout(c["model"], cfg, x[a], U[a], *rest)
        assert torch.equal(got[0][a], one[0]) and torch.equal(got[1][a], one[1])


@pytest.mark.parametrize("rhos", [(1e-3, 1e-3), (0.1, 0.3), (0.3, 0.1)])
def test_k10_kernel_matches_plain(card, rhos):
    """Two arms (the perturbed starts of seeds 5 and 6), cold duals, 4 SQP
    iterations, cap 40, tol 5e-5: X, U at rtol 1e-3, atol 1e-5
    (tests/test_megakernel.py:225-234); per-arm sqp_iters and bails and
    the shared CG count equal.  lam at rtol 1e-3, atol 1e-4 where the CGs
    exit before the cap; at rho 1e-3, where every CG stops at the cap on
    a condition ~1e7 system, at atol 1e-3, K5's precedent."""
    c = card
    dev = c["X"].device
    X = torch.stack([_perturbed_X(c, 5), _perturbed_X(c, 6)])
    args = (c["model"], X, c["U"].expand(2, 63, 7).contiguous(),
            c["goals"].expand(2, 64, c["goals"].shape[1]),
            c["xs"].expand(2, 14).contiguous(), torch.zeros_like(X),
            torch.tensor(rhos, device=dev), torch.ones(2, device=dev), 40,
            5e-5, 4)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)
    got = k10.sqp_solve_mega_pcg_packed(*args, **kw)
    want = k10.sqp_solve_mega_pcg_packed_reference(*args, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    if rhos == (1e-3, 1e-3):
        _close(got.lam, want.lam, 0, 1e-3)
    else:
        _close(got.lam, want.lam, 1e-3, 1e-4)
    for f in ("sqp_iters", "bailed", "pcg_iters_total"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_k4b_kernel_matches_plain(card):
    """K4's tolerances: lam at rtol 5e-3, atol 5e-3, CG counts within 2
    or both at the cap."""
    ks = k3.form_kkt_schur_reference(*_k3_args(card))
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    lam0 = torch.zeros_like(card["X"])
    got = k4.pcg_solve(S, P, ks.gamma, lam0, 40, 5e-5)
    want = k4.pcg_solve_reference(S, P, ks.gamma, lam0, 40, 5e-5)
    _close(got[0], want[0], 5e-3, 5e-3)
    it, it_ref = int(got[1]), int(want[1])
    assert abs(it - it_ref) <= 2 or it == it_ref == 40


def test_k7_and_k7s_kernels_match_plain(card):
    """On the random system, tests/test_bcr.py:62-74's tolerances (lam
    scaled at atol 2e-5, dz at rtol 1e-3, atol 2e-4); on the slice's
    system without the stair, by residual; K7s also at N = 128 and 256."""
    dev = card["X"].device
    ks = random_knot_schur(64, device=dev)
    got, want = k7.bcr_dz(ks), k7.bcr_dz_reference(ks)
    scale = want[0].abs().max()
    _close(got[0] / scale, want[0] / scale, 0, 2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        _close(g, w, 1e-3, 2e-4)
    for n in (64, 128, 256):
        ks = random_knot_schur(n, device=dev)
        got_s = k7.bcr_solve(ks.SL, ks.SD, ks.SU, ks.gamma)
        want_s = k7.bcr_solve_reference(ks.SL, ks.SD, ks.SU, ks.gamma)
        scale = want_s.abs().max()
        _close(got_s / scale, want_s / scale, 0, 2e-5)
    c = card
    ks = k3.form_kkt_schur_reference(c["model"], _perturbed_X(c),
                                     *_k3_args(c)[2:], precond=False)
    res = relative_residual(ks, k7.bcr_dz(ks)[0])
    assert res <= 2 * relative_residual(ks, k7.bcr_dz_reference(ks)[0])


def _k9_args(c, rho):
    X = _perturbed_X(c)
    zero = torch.zeros_like
    merit = k2.line_search_merits_reference(
        c["model"], X, c["U"], zero(X), zero(c["U"]), 8, c["goals"], c["xs"],
        DT, 10.0, QD_COST, R_COST)[8]
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)
    return (c["model"], X, c["U"], c["goals"], c["xs"]), (
        torch.tensor(rho, device=X.device), torch.tensor(1.0, device=X.device),
        merit), kw


@pytest.mark.parametrize("rho", [1e-3, 0.1, 0.3])
def test_k9p_kernel_matches_plain(card, rho):
    """One iteration from the perturbed start, cold duals: X, U at rtol
    1e-3, atol 1e-5; accept, bail equal; CG counts within 2; lam at
    atol 1e-3 at rho 1e-3 (K5's precedent, the CG at the cap), else rtol
    1e-3, atol 1e-4."""
    head, scal, kw = _k9_args(card, rho)
    lam0 = torch.zeros_like(head[1])
    got = k9.sqp_iter_mega_pcg(*head, lam0, *scal, 40, 5e-5, **kw)
    want = k9.sqp_iter_mega_pcg_reference(*head, lam0, *scal, 40, 5e-5, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, *((0, 1e-3) if rho == 1e-3 else (1e-3, 1e-4)))
    for f in ("accept", "bail"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert abs(int(got.pcg_iters) - int(want.pcg_iters)) <= 2


def test_k9b_kernel_matches_plain(card):
    """One iteration from the perturbed start at rho 1e-3: accept and bail
    as the plain iteration's; lam by residual (within 2x of the plain
    solve's); X, U and merit at rtol 1e-3, atol 2e-4 (K7's dz tolerance)
    against the plain iteration given the kernel's own lam."""
    head, scal, kw = _k9_args(card, 1e-3)
    got = k9.sqp_iter_mega(*head, *scal, **kw)
    want = k9.sqp_iter_mega_reference(*head, *scal, **kw)
    for f in ("accept", "bail"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    given, ks = bcr_iteration_given_lam(*head, *scal, got.lam, **kw)
    assert relative_residual(ks, got.lam) <= 2 * relative_residual(
        ks, want.lam)
    for f in ("X", "U", "merit"):
        _close(getattr(got, f), getattr(given, f), 1e-3, 2e-4)


# ---- long horizons: K3 at the TPU's tiled K8 horizons, the grid-CG
# forms K4g, K4bg and the joined forms K5g, K9pg (fixture 0_0's first N
# knots, its rows repeated past its last by np.resize, r_cost 1e-4, cap
# 24, exit tol 1e-5: for_knots(N), tpu_tuned_max_iter(N) and
# default_pcg_exit_tols(N)[0] at N = 128 and 256)
LONG_R_COST, LONG_CAP, LONG_TOL = 1e-4, 24, 1e-5


def _long(card, n, seed):
    """The first n knots of fixture 0_0 on the card (its rows repeated
    past its last, np.resize), every knot but 0 moved by a seeded
    0.02-scale normal draw."""
    dev = card["X"].device
    xu, ee = load_fixture_pair(Path(__file__).resolve().parent / "fixtures")
    rows = np.resize(np.arange(xu.shape[0]), n)
    pert = 0.02 * np.random.default_rng(seed).normal(size=(n, 14))
    pert[0] = 0.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                                  device=dev)
    return (t(xu[rows, :14] + pert), t(xu[rows[:-1], 14:]), t(ee[rows]),
            t(xu[0, :14]))


def _long_kw():
    return dict(dt=DT, qd_cost=QD_COST, r_cost=LONG_R_COST, gravity=0.0,
                mu=10.0, num_alphas=8, rho_factor=1.2, rho_min=1e-3,
                rho_max=10.0, rho_reset=1e-3)


def _long_k3_args(card, n):
    return (card["model"], *_long(card, n, 0), card["rho"], DT, QD_COST,
            LONG_R_COST)


@pytest.mark.parametrize("n", [128, 256])
def test_k8_horizons_run_k3_against_plain(card, n):
    """K3 at N % 128 == 0 (the TPU's tiled K8): S's bands within 1e-5 of
    each band's largest entry (entries to 4.5e4, float32 noise 2.5e-2),
    the other blocks at rtol 3e-3, atol 3e-3 (tests/test_kkt_schur_pallas.py:33)."""
    got = k3.form_kkt_schur(*_long_k3_args(card, n))
    want = k3.form_kkt_schur_reference(*_long_k3_args(card, n))
    for f in k3.KnotSchur._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f in ("SL", "SD", "SU"):
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
        else:
            _close(g, w, 3e-3, 3e-3)


K4_KNOTS = (2, 3, 7, 64, 128, 256, 512, 1024)


def _k4_admitted(n, dz):
    """The plans of K4 (dz) or K4b the card admits at n: the cluster form
    (while it fits) and the joined form, each at every cluster size."""
    plans = []
    for form in (k4.CLUSTER, k4.JOINED):
        for c in (16, 8, 4, 2, 1):
            plan = k4.pcg_plan(n, dz=dz, form=form, cluster=c)
            if plan.form and plan not in plans:
                plans.append(plan)
    return plans


@pytest.mark.parametrize("n", K4_KNOTS)
def test_k4g_and_k4bg_kernels_match_plain(card, n):
    """K4 and K4b in both forms -- the cluster form (K4, K4b) where it
    fits and the joined form (K4g, K4bg) -- at every cluster size the card
    admits, on fixture 0_0's system at the long horizons' cap (every CG at
    it), at K4's tolerances: lam, dX, dU at rtol 5e-3, atol 5e-3; CG
    counts within 2 or both at the cap; the same hit; the kernel reads the
    planned cluster size.  The wrappers (pcg_dz and pcg_dz_grid, pcg_solve
    and pcg_solve_grid) launch the plan's forms."""
    ks = k3.form_kkt_schur_reference(*_long_k3_args(card, n))
    lam0 = torch.zeros(n, 14, device=card["X"].device)
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    want = k4.pcg_dz_reference(ks, lam0, LONG_CAP, LONG_TOL)
    want_b = k4.pcg_solve_reference(S, P, ks.gamma, lam0, LONG_CAP, LONG_TOL)
    lib = _lib.library()
    for dz, ref, sys_ in ((True, want, ks),
                          (False, want_b, k4._solve_system(S, P, ks.gamma))):
        nv = 3 if dz else 1
        runs = [k4._launch(lib, sys_, lam0, LONG_CAP, LONG_TOL,
                           _lib.stream_of(lam0), plan, dz)
                for plan in _k4_admitted(n, dz)]
        runs += [k4.pcg_dz(ks, lam0, LONG_CAP, LONG_TOL),
                 k4.pcg_dz_grid(ks, lam0, LONG_CAP, LONG_TOL)] if dz else [
            k4.pcg_solve(S, P, ks.gamma, lam0, LONG_CAP, LONG_TOL),
            k4.pcg_solve_grid(S, P, ks.gamma, lam0, LONG_CAP, LONG_TOL)]
        for got in runs:
            for g, w in zip(got[:nv], ref[:nv]):
                _close(g, w, 5e-3, 5e-3)
            it, it_ref = int(got[nv]), int(ref[nv])
            assert abs(it - it_ref) <= 2 or it == it_ref == LONG_CAP
            assert bool(got[nv + 1]) == bool(ref[nv + 1])
    for dz in (True, False):
        for form in (k4.CLUSTER, k4.JOINED):
            plan = k4.pcg_plan(n, dz=dz, form=form)
            if plan.form:
                k4._launch(lib, ks, lam0, LONG_CAP, LONG_TOL,
                           _lib.stream_of(lam0), plan, dz)
                assert int(k4._wrapper(dz, form).cluster_size) == plan.cluster


@pytest.mark.parametrize("n", [2, 64, 256, 1024])
def test_k4_and_k4g_equal_k9p_and_k9pg_dual_solve(card, n):
    """K3 on the card at K9p's start, then K4 at the plan K9p launches
    (its C and the stair's place) and K4g at K5g's plan (C, G, place):
    lam and the CG count bit for bit those of K9p's and K9pg's dual solve
    (their stage 4 is the body K4 and K4g launch)."""
    from ctypes import c_int

    lib = _lib.library()
    X, U, goals, xs = _long(card, n, 5)
    kw = _long_kw()
    rho, one = card["rho"], torch.tensor(1.0, device=X.device)
    zero = torch.zeros_like
    merit0 = k2.line_search_merits_reference(
        card["model"], X, U, zero(X), zero(U), 8, goals, xs, DT, 10.0,
        QD_COST, LONG_R_COST)[8]
    a9 = (card["model"], X, U, goals, xs, zero(X), rho, one, merit0,
          LONG_CAP, LONG_TOL)
    ks = k3.form_kkt_schur(card["model"], X, U, goals, xs, rho, DT, QD_COST,
                           LONG_R_COST, kw["gravity"])
    cases = []
    if n <= lib.mpc_mega_max_knots(k9.ITER_PCG):
        plan = (c_int * 3)()
        lib.mpc_mega_cluster_plan(n, k9.ITER_PCG, 0, -1, plan)
        cases.append((k9.sqp_iter_mega_pcg(*a9, **kw), k4.PcgPlan(
            k4.CLUSTER, plan[0], 1, 3 if plan[1] else 2, plan[0])))
    gp = k5.grid_plan(n)
    cases.append((k9.sqp_iter_mega_pcg_grid(*a9, **kw), k4.PcgPlan(
        k4.JOINED, gp.cluster, gp.clusters, gp.place, gp.grid)))
    for out, plan in cases:
        got = k4._launch(lib, ks, zero(X), LONG_CAP, LONG_TOL,
                         _lib.stream_of(X), plan)
        assert torch.equal(got[0], out.lam), plan
        assert int(got[3]) == int(out.pcg_iters), plan


@pytest.mark.parametrize("n", [128, 256])
def test_k6l_kernel_matches_plain(card, n):
    """The cluster K6 at the horizons the former K6l (K6 with S in global
    memory) served, the failover's BCR-PCG past N = 64: on the random
    system at K6's tolerances (tests/test_bcr.py:62-74), CG iterations
    within 1; on fixture 0_0's system without the stair (cap 24, tol 1e-5)
    as K6 on the slice's: each solve's residual within 1e-3 of |gamma|, CG
    iterations within 1; bcr_pcg_dz launches it."""
    dev = card["X"].device
    ks = random_knot_schur(n, device=dev)
    lam0 = torch.zeros(n, 14, device=dev)
    got = k6.bcr_pcg_dz(ks, lam0, 40, 5e-5)
    want = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
    scale = want[0].abs().max()
    _close(got[0] / scale, want[0] / scale, 0, 2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        _close(g, w, 1e-3, 2e-4)
    assert abs(int(got[3]) - int(want[3])) <= 1
    ks = k3.form_kkt_schur_reference(*_long_k3_args(card, n), precond=False)
    before = k6.bcr_pcg_dz.launches
    got = k6.bcr_pcg_dz(ks, lam0, LONG_CAP, LONG_TOL)
    assert k6.bcr_pcg_dz.launches == before + 1
    want = k6.bcr_pcg_dz_reference(ks, lam0, LONG_CAP, LONG_TOL)
    S = BlockTri(ks.SL, ks.SD, ks.SU)
    for lam in (got[0], want[0]):
        res = (spmv(S, lam) - ks.gamma).abs().max() / ks.gamma.abs().max()
        assert float(res) < 1e-3
    assert abs(int(got[3]) - int(want[3])) <= 1


def _k5g_args(card, n, rho):
    X, U, goals, xs = _long(card, n, 5)
    zero = torch.zeros_like
    merit0 = k2.line_search_merits_reference(
        card["model"], X, U, zero(X), zero(U), 8, goals, xs, DT, 10.0,
        QD_COST, LONG_R_COST)[8]
    return (card["model"], X, U, goals, xs, zero(X),
            torch.tensor(rho, device=X.device), 1.0, merit0, LONG_CAP,
            LONG_TOL, 4)


@pytest.mark.parametrize("n", [128, 256, 657, 1000, 1024])
@pytest.mark.parametrize("rho", [1e-3, 0.3])
@pytest.mark.parametrize("cluster", [0, 16, 8])
def test_k5g_kernel_matches_plain(card, n, rho, cluster):
    """K5's checks: X, U at rtol 1e-3, atol 1e-5; accepted, sqp_iters and
    rho_bailed identical; CG counts within 2 per SQP iteration; lam at
    atol 1e-3 at rho 1e-3 (every CG at the cap), else rtol 1e-3, atol
    1e-4.  The wrapper (the plan's cluster size, 0), and each cluster
    size the plan admits at this N; the kernel reads that size."""
    args, kw = _k5g_args(card, n, rho), _long_kw()
    if cluster == 0:
        got = k5.sqp_solve_mega_pcg_grid(*args, **kw)
        cluster = k5.grid_plan(n).cluster
    else:
        plan = k5.grid_plan(n, cluster=cluster)
        if plan.grid < 1:
            pytest.skip(f"the card admits no clusters of {cluster} here")
        got = k5._launch(_lib.library(), _lib.model_tables(args[0]),
                         *args[1:], grid=plan.grid,
                         stream=_lib.stream_of(args[1]),
                         kind=k5.SOLVE_PCG_GRID, cluster=cluster, **kw)
    assert int(k5.sqp_solve_mega_pcg_grid.cluster_size) == cluster
    want = k5.sqp_solve_mega_pcg_reference(*args, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, *((0, 1e-3) if rho == 1e-3 else (1e-3, 1e-4)))
    for f in ("sqp_iters", "bailed", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int((got.pcg_iters - want.pcg_iters).abs().max()) <= 2


@pytest.mark.parametrize("n", [128, 256, 1024])
def test_four_k9pg_launches_equal_one_k5g_launch(card, n):
    """One K9pg launch against the plain iteration (K9p's checks), and
    sqp.iterate over four K9pg launches against one K5g launch, bit for
    bit."""
    from mpcgpu_tpu_torch.sqp import iterate

    args, kw = _k5g_args(card, n, 1e-3), _long_kw()
    model, X, U, goals, xs, lam0, rho, _, merit0 = args[:9]
    one = torch.tensor(1.0, device=X.device)
    got = k9.sqp_iter_mega_pcg_grid(model, X, U, goals, xs, lam0, rho, one,
                                    merit0, LONG_CAP, LONG_TOL, **kw)
    want = k9.sqp_iter_mega_pcg_reference(model, X, U, goals, xs, lam0, rho,
                                          one, merit0, LONG_CAP, LONG_TOL,
                                          **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 0, 1e-3)
    for f in ("accept", "bail"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f

    def step(Xc, Uc, lamc, rhoc, drhoc, meritc):
        return k9.sqp_iter_mega_pcg_grid(model, Xc, Uc, goals, xs, lamc, rhoc,
                                         drhoc, meritc, LONG_CAP, LONG_TOL,
                                         **kw)

    once = k5.sqp_solve_mega_pcg_grid(*args, **kw)
    four = iterate(X, U, lam0, rho, one, merit0, 4, step)
    for g, w in zip(four[:3], (once.X, once.U, once.lam)):
        assert torch.equal(g, w)
    assert torch.equal(four[8], once.pcg_iters)
    assert torch.equal(four[10], once.accepted)


@pytest.mark.parametrize("n", [1024, 4096])
def test_k5g_places_give_the_same_bits(card, n):
    """K5g with its CG's area at every place the card admits at this N (3:
    S's and the stair's bands and the vectors on chip, 2 and 1 fewer of
    them, 0: all in global memory), on the plan's cluster size and one
    grid, gives the same bits."""
    args, kw = _k5g_args(card, n, 1e-3), _long_kw()
    lib = _lib.library()
    c = k5.grid_plan(n, lib).cluster
    grids = {place: k5.grid_plan(n, lib, c, place).grid
             for place in (3, 2, 1, 0)}
    grid = min(g for g in grids.values() if g > 0)
    runs = [k5._launch(lib, _lib.model_tables(args[0]), *args[1:], grid=grid,
                       stream=_lib.stream_of(args[1]),
                       kind=k5.SOLVE_PCG_GRID, cluster=c, stair=place, **kw)
            for place, g in grids.items() if g > 0]
    assert len(runs) >= 2
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [16384, 65536])
def test_k5g_serves_the_longest_horizons(card, n):
    """K5g up to GRID_MAX_KNOTS (65536 knots), where the plan moves its
    CG's area to L2, one SQP iteration at a cap of 8, against the plain
    version at K5's rho 1e-3 tolerances (every CG at the cap): decisions
    equal, CG counts within 2, X and U at rtol 1e-3, atol 1e-4, lam at
    atol 1e-3."""
    assert k5.check_mega_fit(n, kind=k5.SOLVE_PCG_GRID) == k5.grid_plan(n).grid
    args, kw = _k5g_args(card, n, 1e-3), _long_kw()
    args = (*args[:9], 8, LONG_TOL, 1)
    got = k5.sqp_solve_mega_pcg_grid(*args, **kw)
    want = k5.sqp_solve_mega_pcg_reference(*args, **kw)
    _close(got.X, want.X, 1e-3, 1e-4)
    _close(got.U, want.U, 1e-3, 1e-4)
    _close(got.lam, want.lam, 0, 1e-3)
    for f in ("sqp_iters", "bailed", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int((got.pcg_iters - want.pcg_iters).abs().max()) <= 2


@pytest.mark.parametrize("nl", [1, 64])
@pytest.mark.parametrize("halos", ["zero", "nonzero"])
def test_k11_kernel_matches_plain(card, nl, halos):
    """K11 against spmv_halo_reference on seeded random bands: within 1e-5
    of max|y| (float32 sums of 42 products in another order)."""
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11

    dev = card["X"].device
    rng = np.random.default_rng(nl)
    f32 = lambda *shape: torch.as_tensor(
        rng.normal(size=shape).astype(np.float32), device=dev)
    L, D, U, x = f32(nl, 14, 14), f32(nl, 14, 14), f32(nl, 14, 14), f32(nl, 14)
    xl, xr = ((f32(14), f32(14)) if halos == "nonzero"
              else (torch.zeros(14, device=dev), torch.zeros(14, device=dev)))
    before = k11.spmv_halo.launches
    got = k11.spmv_halo(L, D, U, x, xl, xr)
    want = k11.spmv_halo_reference(L, D, U, x, xl, xr)
    assert k11.spmv_halo.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shards", [1, 3, 8, 70])
def test_k11_all_shard_launch_equals_per_shard_launches(card, shards):
    """K11 over consecutive shards of nl = 64 (nl = 2 at 70 shards: two
    launches, a group of 64 and one of 6) given nonzero rows outside them:
    one launch per 64 shards, each shard's y bit-equal to one launch over
    that shard with its neighbours' edge rows as halos, and within 1e-5 of
    max|y| of the plain version."""
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11

    dev = card["X"].device
    nl = 64 if shards <= 8 else 2
    rng = np.random.default_rng(shards)
    f32 = lambda *shape: torch.as_tensor(
        rng.normal(size=shape).astype(np.float32), device=dev)
    bands = [(f32(nl, 14, 14), f32(nl, 14, 14), f32(nl, 14, 14))
             for _ in range(shards)]
    xs = [f32(nl, 14) for _ in range(shards)]
    xl, xr = f32(14), f32(14)
    before = k11.spmv_halo.launches
    got = k11.spmv_halo_shards(bands, xs, xl, xr)
    assert k11.spmv_halo.launches == before + -(-shards // 64)
    want = k11.spmv_halo_shards_reference(bands, xs, xl, xr)
    for i, (b, x) in enumerate(zip(bands, xs)):
        one = k11.spmv_halo(*b, x, xs[i - 1][-1] if i > 0 else xl,
                            xs[i + 1][0] if i < shards - 1 else xr)
        assert torch.equal(got[i], one), i
        assert (float((got[i] - want[i]).abs().max())
                <= 1e-5 * float(want[i].abs().max())), i


def test_k11_sharded_cg_matches_plain(card):
    """pcg_sharded_cuda (K11 as every SpMV) on an in-process mesh of 8 shards
    against pcg_sharded (the plain per-shard SpMV) on the card, N = 64,
    the seeded random system with the stair: iterations within 3, lam at
    K4's rtol = atol = 5e-3; one K11 launch over the 8 shards per SpMV,
    two per CG step."""
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11
    from mpcgpu_tpu_torch.parallel.pcg_sharded import pcg_sharded
    from mpcgpu_tpu_torch.parallel.pcg_sharded_cuda import pcg_sharded_cuda
    from mpcgpu_tpu_torch.parallel.sharded import horizon_mesh
    from torch_systems import random_system

    dev = card["X"].device
    ks = {f: torch.as_tensor(v, device=dev)
          for f, v in random_system(64, seed=11, precond=True).items()}
    S = BlockTri(ks["SL"], ks["SD"], ks["SU"])
    P = BlockTri(ks["PL"], ks["PD"], ks["PU"])
    mesh = horizon_mesh(8, device=dev)
    cap = 300
    args = (S, P, ks["gamma"], torch.zeros(64, 14, device=dev), cap, 1e-9)
    before = k11.spmv_halo.launches
    lam, iters, hit = pcg_sharded_cuda(mesh, *args)
    torch.cuda.synchronize()
    assert k11.spmv_halo.launches - before == 2 + 2 * cap
    lam_p, iters_p, hit_p = pcg_sharded(mesh, *args)
    assert abs(int(iters) - int(iters_p)) <= 3 and not bool(hit)
    _close(lam, lam_p, 5e-3, 5e-3)


# ---- the cluster forms (K5, K9p, K6): every horizon of the main path, at
# every cluster size the card admits (16 needs the non-portable size)
CLUSTER_KNOTS = (2, 4, 64, 128, 256, 512)


def _mega_admitted(lib, n, kind):
    """{C: grid} of the cluster sizes the card admits for kind at n."""
    from ctypes import c_int

    out = {}
    for c in (8, 16):
        plan = (c_int * 3)()
        if lib.mpc_mega_cluster_plan(n, kind, c, -1, plan):
            out[c] = plan[2]
    return out


def _k5_case(card, n, rho):
    """The slice's K5 inputs at N = 64 (cap 40, tol 5e-5); elsewhere the
    long horizons' (fixture 0_0's first n knots perturbed, r_cost 1e-4,
    cap 24, tol 1e-5); cold duals, 4 SQP iterations."""
    if n == 64:
        X = _perturbed_X(card)
        U, goals, xs = card["U"], card["goals"], card["xs"]
        r_cost, cap, tol = R_COST, 40, 5e-5
    else:
        X, U, goals, xs = _long(card, n, 5)
        r_cost, cap, tol = LONG_R_COST, LONG_CAP, LONG_TOL
    zero = torch.zeros_like
    merit0 = k2.line_search_merits_reference(
        card["model"], X, U, zero(X), zero(U), 8, goals, xs, DT, 10.0,
        QD_COST, r_cost)[8]
    kw = dict(_long_kw(), r_cost=r_cost)
    return (card["model"], X, U, goals, xs, zero(X),
            torch.tensor(rho, device=X.device), 1.0, merit0, cap, tol,
            4), kw


@pytest.mark.parametrize("n", CLUSTER_KNOTS)
@pytest.mark.parametrize("rho", [1e-3, 0.3])
def test_k5_cluster_form_matches_plain(card, n, rho):
    """K5's cluster form at each admitted cluster size against the plain
    version: X, U at rtol 1e-3, atol 1e-5 (tests/test_megakernel.py:
    115-125), at rho 1e-3 atol 1e-4: there lam's float32 deviation on the
    condition ~1e7 system (atol 1e-3, K5's precedent) passes through Qinv
    (entries to 1/rho) into X, and K5g, the grid form, is 5.6e-5 from the
    plain version at N = 2 on an H100, bit for bit where the cluster form
    is; lam else at rtol 1e-3, atol 1e-4; CG counts, accepts, sqp_iters
    and bails identical; the kernel reads the cluster size it was launched
    with."""
    from mpcgpu_tpu_torch.ops.cuda import _lib

    lib = _lib.library()
    args, kw = _k5_case(card, n, rho)
    want = k5.sqp_solve_mega_pcg_reference(*args, **kw)
    admitted = _mega_admitted(lib, n, k5.SOLVE_PCG)
    assert admitted
    x_atol = 1e-4 if rho == 1e-3 else 1e-5
    for c, grid in admitted.items():
        got = k5._launch(lib, _lib.model_tables(args[0]), *args[1:],
                         grid=grid, stream=_lib.stream_of(args[1]),
                         cluster=c, **kw)
        assert int(k5.sqp_solve_mega_pcg.cluster_size) == c
        _close(got.X, want.X, 1e-3, x_atol)
        _close(got.U, want.U, 1e-3, x_atol)
        _close(got.lam, want.lam, *((0, 1e-3) if rho == 1e-3
                                    else (1e-3, 1e-4)))
        for f in ("pcg_iters", "accepted", "sqp_iters", "bailed"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (c, f)


@pytest.mark.parametrize("n", [64, 256])
def test_four_k9p_launches_equal_one_k5_launch(card, n):
    """sqp.iterate over four K9p launches against one K5 launch, both the
    cluster form: the same body, bit for bit."""
    from mpcgpu_tpu_torch.sqp import iterate

    args, kw = _k5_case(card, n, 1e-3)
    model, X, U, goals, xs, lam0, rho, _, merit0, cap, tol, _ = args
    one = torch.tensor(1.0, device=X.device)

    def step(Xc, Uc, lamc, rhoc, drhoc, meritc):
        return k9.sqp_iter_mega_pcg(model, Xc, Uc, goals, xs, lamc, rhoc,
                                    drhoc, meritc, cap, tol, **kw)

    before = (k5.sqp_solve_mega_pcg.launches, k9.sqp_iter_mega_pcg.launches)
    once = k5.sqp_solve_mega_pcg(*args, **kw)
    four = iterate(X, U, lam0, rho, one, merit0, 4, step)
    assert (k5.sqp_solve_mega_pcg.launches - before[0],
            k9.sqp_iter_mega_pcg.launches - before[1]) == (1, 4)
    for g, w in zip(four, (once.X, once.U, once.lam, once.rho, once.drho,
                           once.merit, once.sqp_iters, once.bailed,
                           once.pcg_iters, once.hit_max, once.accepted)):
        assert torch.equal(g, w)


def _k6_admitted(lib, n):
    return [c for c in (8, 16) if lib.mpc_bcr_cluster(n, c) == c]


@pytest.mark.parametrize("n", CLUSTER_KNOTS)
def test_k6_cluster_form_matches_plain(card, n):
    """K6's cluster form at each admitted cluster size on the random system
    against the plain version, K6's tolerances (tests/test_bcr.py:62-74:
    lam scaled by its largest entry at atol 2e-5, dX, dU at rtol 1e-3,
    atol 2e-4); CG counts and the hit flag identical."""
    from mpcgpu_tpu_torch.ops.cuda import _lib

    lib = _lib.library()
    dev = card["X"].device
    ks = random_knot_schur(n, device=dev)
    lam0 = torch.zeros(n, 14, device=dev)
    want = k6.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
    admitted = _k6_admitted(lib, n)
    assert admitted
    for c in admitted:
        got = k6._launch(lib, ks, lam0, 40, 5e-5, _lib.stream_of(lam0),
                         cluster=c)
        assert int(k6.bcr_pcg_dz.cluster_size) == c
        scale = want[0].abs().max()
        _close(got[0] / scale, want[0] / scale, 0, 2e-5)
        for g, w in zip(got[1:3], want[1:3]):
            _close(g, w, 1e-3, 2e-4)
        assert int(got[3]) == int(want[3]) and bool(got[4]) == bool(want[4])


def _reference_factor(lib, ks, solve=False):
    """The factor scratch of K7's cluster factor, or K7s's with solve."""
    n = ks.gamma.shape[0]
    fac = torch.zeros(lib.mpc_bcr_scratch_floats(n), device=ks.gamma.device)
    if solve:
        k7._launch_solve(lib, ks.SL, ks.SD, ks.SU, ks.gamma,
                         _lib.stream_of(ks.gamma), scratch=fac)
    else:
        k7._launch_dz(lib, ks, _lib.stream_of(ks.gamma), scratch=fac)
    return fac


@pytest.mark.parametrize("n", [2, 64, 256, 512])
def test_k6_cluster_factor_equals_the_one_block_factor(card, n):
    """The cluster factor of K6, at each admitted cluster size, against
    K7's cluster factor on the same bands: the whole factor scratch (both
    zeroed first) bit for bit.  No kernel on the card runs the one-block
    factor (K7 ran it to N = 64 before its cluster form);
    tests/test_torch_csrc_host.py holds the cluster factors to it (N = 8-1024,
    the host build)."""
    from mpcgpu_tpu_torch.ops.cuda import _lib

    lib = _lib.library()
    dev = card["X"].device
    ks = random_knot_schur(n, device=dev)
    size = lib.mpc_bcr_scratch_floats(n)
    one_block = _reference_factor(lib, ks)
    for c in _k6_admitted(lib, n):
        cluster = torch.zeros(size, device=dev)
        k6._launch(lib, ks, torch.zeros(n, 14, device=dev), 3, 1e-9,
                   _lib.stream_of(ks.gamma), scratch=cluster, cluster=c)
        assert torch.equal(cluster, one_block), c


@pytest.mark.parametrize("n", [2, 64, 128, 256, 1024])
def test_k7s_cluster_form_matches_plain(card, n):
    """K7s (one cluster) at each admitted cluster size on the random
    system against the plain solve, tests/test_bcr.py:62-74's tolerance
    (lam scaled by its largest entry at atol 2e-5); the kernel reads the
    cluster size it was launched with; its factor equals K7's cluster
    factor bit for bit (the one-block factor runs on the card no more:
    tests/test_torch_csrc_host.py holds both to it)."""
    lib = _lib.library()
    dev = card["X"].device
    ks = random_knot_schur(n, device=dev)
    want = k7.bcr_solve_reference(ks.SL, ks.SD, ks.SU, ks.gamma)
    admitted = [c for c in (8, 16) if lib.mpc_bcr_solve_cluster(n, c) == c]
    assert admitted
    k7_fac = _reference_factor(lib, ks)
    for c in admitted:
        fac = torch.zeros(lib.mpc_bcr_scratch_floats(n), device=dev)
        got = k7._launch_solve(lib, ks.SL, ks.SD, ks.SU, ks.gamma,
                               _lib.stream_of(ks.gamma), scratch=fac,
                               cluster=c)
        assert int(k7.bcr_solve.cluster_size) == c
        scale = want.abs().max()
        _close(got / scale, want / scale, 0, 2e-5)
        assert torch.equal(fac, k7_fac), c


@pytest.mark.parametrize("n", [2, 4, 64, 128, 256, 512, 1024])
def test_k7_cluster_form_matches_plain(card, n):
    """K7 (one cluster) at each admitted cluster size on the random system
    against the plain refined solve and dz, tests/test_bcr.py:62-74's
    tolerances (lam scaled by its largest entry at atol 2e-5, dX and dU at
    rtol 1e-3, atol 2e-4), no CG iterations reported; the kernel reads the
    cluster size it was launched with; its factor equals K7s's cluster
    factor bit for bit (the one-block factor runs on the card no more:
    tests/test_torch_csrc_host.py holds both to it); bcr_dz launches K7 at
    every N to its fit, and its forced split path (K7s, residual, K7s)
    agrees with it at N = 64 and 128 within the same tolerances."""
    lib = _lib.library()
    dev = card["X"].device
    ks = random_knot_schur(n, device=dev)
    want = k7.bcr_dz_reference(ks)
    admitted = [c for c in (8, 16) if lib.mpc_bcr_dz_cluster(n, c) == c]
    assert admitted and n <= lib.mpc_bcr_dz_max_knots()
    k7s_fac = _reference_factor(lib, ks, solve=True)

    def close(got, ref):
        scale = ref[0].abs().max()
        _close(got[0] / scale, ref[0] / scale, 0, 2e-5)
        for g, w in zip(got[1:3], ref[1:3]):
            _close(g, w, 1e-3, 2e-4)

    for c in admitted:
        fac = torch.zeros(lib.mpc_bcr_scratch_floats(n), device=dev)
        got = k7._launch_dz(lib, ks, _lib.stream_of(ks.gamma), scratch=fac,
                            cluster=c)
        assert int(k7.bcr_dz.cluster_size) == c
        assert int(got[3]) == 0 and not bool(got[4])
        close(got, want)
        assert torch.equal(fac, k7s_fac), c
    before = k7.bcr_dz.launches
    got = k7.bcr_dz(ks)
    assert k7.bcr_dz.launches == before + 1
    close(got, want)
    if n in (64, 128):
        close(k7.bcr_dz(ks, split=True), got)


@pytest.mark.parametrize("n", [2, 4, 64, 256, 512, 1024])
def test_k9b_cluster_form_matches_plain(card, n):
    """K9b (its refined BCR solve and dz across the first cluster) at each
    admitted cluster size, one iteration at rho 1e-3 from _k5_case's start:
    accept and bail as the plain iteration's, no CG; lam by residual
    (within 2x of the plain solve's); X, U and merit at rtol 1e-3, atol
    2e-4 against the plain iteration given the kernel's own lam; the
    kernel reads the cluster size it was launched with."""
    lib = _lib.library()
    args, kw = _k5_case(card, n, 1e-3)
    a9 = (*args[:5], args[6], torch.tensor(1.0, device=args[1].device),
          args[8])
    want = k9.sqp_iter_mega_reference(*a9, **kw)
    admitted = _mega_admitted(lib, n, k9.ITER_BCR)
    assert admitted
    for c, grid in admitted.items():
        got = k9._launch_iter(lib, k9.ITER_BCR, _lib.model_tables(a9[0]),
                              *a9[1:5], None, *a9[5:], 0, 0.0, **kw,
                              grid=grid, stream=_lib.stream_of(a9[1]),
                              cluster=c)
        assert int(k9.sqp_iter_mega.cluster_size) == c
        for f in ("accept", "bail"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (c, f)
        assert int(got.pcg_iters) == 0 and not bool(got.hit_max)
        given, ks = bcr_iteration_given_lam(*a9, got.lam, **kw)
        assert relative_residual(ks, got.lam) <= 2 * relative_residual(
            ks, want.lam)
        for f in ("X", "U", "merit"):
            _close(getattr(got, f), getattr(given, f), 1e-3, 2e-4)


# ---- K10's forms, the cases of tests/test_torch_csrc_host.py's block
# emulation on the card: the cluster form at C = 2 and 4 and the one-block
# form (cluster 0), against the plain version
K10_KW = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)


def _k10_form(model, args, kw, cluster, grid=None):
    """One K10 launch in the cluster form at `cluster` blocks a cluster on
    the plan's grid (or `grid`), or the one-block form (cluster 0)."""
    b, n = args[0].shape[:2]
    lib = _lib.library()
    plan = k10.packed_plan(n, b, kw["num_alphas"], lib,
                           cluster=cluster if cluster else -1)
    out = k10._launch_packed(
        lib, _lib.model_tables(model), *args, grid=grid or plan.grid,
        stream=_lib.stream_of(args[0]), cluster=plan.cluster,
        stair=plan.stair, **kw)
    torch.cuda.synchronize()
    assert int(k10.sqp_solve_mega_pcg_packed.cluster_size) == cluster
    return out


def _k10_close(got, want):
    """The host-build tests' tolerances (tests/test_megakernel.py:225-240)."""
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, 1e-3, 1e-4)
    _close(got.rho, want.rho, 1e-6, 0)
    _close(got.merit, want.merit, 1e-3, 0)
    for f in ("sqp_iters", "bailed", "pcg_iters_total"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _fixture():
    xu, ee = load_fixture_pair(Path(__file__).resolve().parent / "fixtures")
    return xu.astype(np.float32), ee.astype(np.float32)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("cluster", [2, 4])
def test_k10_cluster_form_matches_plain(card, n, b, cluster):
    """As test_k10_cluster_form_host_build_matches_plain: arms as
    chip_smoke.py's K10 check makes them, rhos 0.1, 0.3 (1.0), 4 SQP
    iterations, cap 40, tol 5e-5."""
    dev = card["X"].device
    X, U, goals, xs = packed_arms(*_fixture(), n, b, 5, device=dev)
    args = (X, U, goals, xs, torch.zeros(b, n, 14, device=dev),
            torch.tensor((0.1, 0.3, 1.0)[:b], device=dev),
            torch.ones(b, device=dev), 40, 5e-5, 4)
    want = k10.sqp_solve_mega_pcg_packed_reference(card["model"], *args,
                                                   **K10_KW)
    _k10_close(_k10_form(card["model"], args, K10_KW, cluster), want)


def test_k10_cluster_form_freezes_a_bailed_arm(card):
    """The host build's bail case at C = 2 on the least grid: arm 1 bails
    at iteration 2 and stays frozen while arm 0 iterates."""
    dev = card["X"].device
    xu, ee = _fixture()
    rng = np.random.default_rng(6)
    X = torch.as_tensor(np.stack([xu[:4, :14] + 0.02 * rng.normal(size=(4, 14))
                                  for _ in range(2)]).astype(np.float32),
                        device=dev)
    U = torch.as_tensor(np.stack([xu[:3, 14:]] * 2), device=dev)
    goals = torch.as_tensor(ee[:4], device=dev).expand(2, 4, 6)
    kw = dict(K10_KW, rho_max=0.05)
    args = (X, U, goals, X[:, 0].clone(), torch.zeros(2, 4, 14, device=dev),
            torch.tensor([1e-3, 0.1], device=dev), torch.ones(2, device=dev),
            40, 1e-4, 5)
    want = k10.sqp_solve_mega_pcg_packed_reference(card["model"], *args, **kw)
    got = _k10_form(card["model"], args, kw, 2, grid=4)
    _k10_close(got, want)
    assert got.bailed.tolist() == [False, True]
    assert got.sqp_iters.tolist() == [5, 2]


@pytest.mark.parametrize("cluster", [0, 2])
def test_k10_arm_with_zero_residual(card, cluster):
    """As test_k10_host_build_arm_with_zero_residual: an arm at rest has a
    CG residual of exactly zero (0/0 -> 0 for alpha and beta); its duals
    stay zero, nothing turns NaN, and the two other arms come out as they
    do packed alone, the shared CG count and the bits alike."""
    dev = card["X"].device
    X, U, goals, xs = packed_arms(*_fixture(), 8, 2, 5, device=dev)
    rest = (40, 5e-5, 5)
    z = lambda b: torch.zeros(b, 8, 14, device=dev)
    two = (X, U, goals.contiguous(), xs, z(2),
           torch.tensor([1e-3, 0.1], device=dev), torch.ones(2, device=dev)
           ) + rest
    three = with_resting_arm(X, U, goals, xs) + (
        z(3), torch.tensor([1e-3, 0.1, 1e-3], device=dev),
        torch.ones(3, device=dev)) + rest
    got2 = _k10_form(card["model"], two, K10_KW, cluster)
    got3 = _k10_form(card["model"], three, K10_KW, cluster)
    assert all(bool(torch.isfinite(t).all()) for t in got3[:5])
    assert not bool(got3.lam[2].any())
    assert int(got3.pcg_iters_total) == int(got2.pcg_iters_total)
    for f in ("X", "U", "lam", "rho", "merit", "sqp_iters", "bailed"):
        assert torch.equal(getattr(got3, f)[:2], getattr(got2, f)), f


def test_k10_gives_the_same_bits_on_two_launches(card):
    """The planned launch (the cluster form) twice on the same inputs."""
    dev = card["X"].device
    X, U, goals, xs = packed_arms(*_fixture(), 64, 2, 5, device=dev)
    args = (card["model"], X, U, goals, xs, torch.zeros(2, 64, 14, device=dev),
            torch.tensor([1e-3, 0.1], device=dev), torch.ones(2, device=dev),
            40, 5e-5, 4)
    a = k10.sqp_solve_mega_pcg_packed(*args, **K10_KW)
    b = k10.sqp_solve_mega_pcg_packed(*args, **K10_KW)
    assert int(k10.sqp_solve_mega_pcg_packed.cluster_size) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- the real-time host loop (sim.simulate_mpc) and what hangs off it,
# the card twins of tests/test_torch_host_loop.py


def _host_cfg(n=64, **kw):
    from mpcgpu_tpu_torch.config import PCGConfig

    kw = {"sqp_max_iter": 4, "pcg": PCGConfig(max_iter=40),
          "fused_stages": True, "megakernel": True, "megakernel_solve": True,
          **kw}
    return SolverConfig.for_knots(n, **kw)


def _counted(run):
    from mpcgpu_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts().items() if v}


def test_host_loop_real_time_runs_the_kernels(card):
    """const_update_freq=False: the plant runs for each solve's wall time;
    K2 and K5 a solve (one warm-up and the measured warm solve besides),
    K1 an update; finite tracking at every shift."""
    from mpcgpu_tpu_torch.sim import simulate_mpc

    xu, ee = _fixture()
    rec, counts = _counted(lambda: simulate_mpc(
        card["model"], _host_cfg(), xu, ee, pcg_exit_tol=5e-5,
        warmup_iters=1, max_timesteps=3, const_update_freq=False))
    u = rec.control_updates
    assert rec.timesteps == 3 and u > 3
    assert counts == {"K1": u, "K2": u + 2, "K5": u + 2}
    assert np.isfinite(rec.tracking_errors).all()
    assert all(t > 0 for t in rec.sqp_times_us)


def test_host_loop_equals_the_scan_on_the_card(card):
    """At the constant period the host loop equals simulate_mpc_scan:
    sqp_iters and bails equal, tracking errors within 1e-3 m."""
    from mpcgpu_tpu_torch.sim import simulate_mpc, simulate_mpc_scan

    xu, ee = _fixture()
    cfg = _host_cfg()
    rec = simulate_mpc(card["model"], cfg, xu, ee, pcg_exit_tol=5e-5,
                       warmup_iters=0, max_control_updates=16)
    dev = card["X"].device
    t = lambda a: torch.as_tensor(a, device=dev)
    scan = simulate_mpc_scan(card["model"], cfg, t(xu), t(ee), card["X"],
                             card["U"], torch.zeros_like(card["X"]),
                             1e-3, 5e-5, 16)
    assert rec.sqp_iters == scan["sqp_iters"].tolist()
    assert rec.sqp_exits == scan["rho_bailed"].tolist()
    errs = scan["tracking_errors"][scan["shifted"].to(dev)].cpu().numpy()
    np.testing.assert_allclose(rec.tracking_errors, errs, atol=1e-3)


def test_fine_grained_pcg_pallas_launches_k4b(card):
    """The fine-grained mode runs the plain phases on the card and solves
    pcg_pallas with K4b, one launch an SQP iteration run."""
    from mpcgpu_tpu_torch.sqp import sqp_solve_fine_grained

    c = card
    (res, times), counts = _counted(lambda: sqp_solve_fine_grained(
        c["model"], _host_cfg(), c["X"], c["U"], torch.zeros_like(c["X"]),
        c["goals"], c["xs"], c["rho"], 5e-5, "pcg_pallas"))
    its = int(res.stats.sqp_iters)
    assert counts == {"K4b": its} and its >= 1
    assert all(len(v) == its and min(v) > 0 for v in times.values())


def test_timebox_runs_k9p_and_stops_at_its_budget(card):
    """The box's iterations are K9p launches (one more before the box
    opens) after one K2 merit; a zero budget runs none."""
    from mpcgpu_tpu_torch.sqp import sqp_solve_timeboxed

    c = card
    args = (c["model"], _host_cfg(sqp_max_iter=40), c["X"], c["U"],
            torch.zeros_like(c["X"]), c["goals"], c["xs"], c["rho"], 5e-5)
    res, counts = _counted(lambda: sqp_solve_timeboxed(*args,
                                                       max_time_us=2000.0))
    its = int(res.stats.sqp_iters)
    assert counts == {"K2": 1, "K9p": its + 1} and its >= 1
    res0 = sqp_solve_timeboxed(*args, max_time_us=0.0)
    assert int(res0.stats.sqp_iters) == 0


def test_fixture_pair_trace_by_forward_kinematics_on_the_card(card):
    """Pair 1_0's end-effector trace made on the card equals the CPU's
    within 1e-5."""
    d = Path(__file__).resolve().parent / "fixtures"
    _, ee_card = load_fixture_pair(d, 1, 0, model=card["model"])
    _, ee_cpu = load_fixture_pair(d, 1, 0, model=iiwa14(device="cpu"))
    np.testing.assert_allclose(ee_card, ee_cpu, rtol=0, atol=1e-5)


# ---- the second robot: the planar 2R arm (nq = 2) through the two-joint
# build of K1-K5, at the JAX hardware gate's N = 16 and solver

@pytest.fixture(scope="module")
def arm2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpcgpu_tpu_torch.config import CostConfig, PCGConfig
    from mpcgpu_tpu_torch.models.planar2r import planar2r
    from mpcgpu_tpu_torch.utils.synth import synthesize_tracking_fixture
    from mpcgpu_tpu_torch.utils.trajfiles import horizon_slices

    dev = torch.device("cuda", 0)
    model = planar2r(device=dev)
    n = 16
    xu, ee = synthesize_tracking_fixture(model, q0=[0.4, 0.6],
                                         amplitude=0.35, n_steps=4 * n,
                                         dt=0.05)
    X, U, goals, xs = (torch.as_tensor(a, device=dev)
                       for a in horizon_slices(xu, ee, n, nx=4))
    cfg = SolverConfig(knot_points=n, state_size=4, control_size=2,
                       timestep=0.05, sqp_max_iter=3,
                       pcg=PCGConfig(max_iter=30),
                       cost=CostConfig(qd_cost=1e-3, r_cost=1e-4))
    return dict(model=model, X=X, U=U, goals=goals, xs=xs, cfg=cfg,
                rho=torch.tensor(1e-3, device=dev))


def test_two_joint_kernels_match_plain_on_the_card(arm2):
    """K3 (bands within 1e-4 of their largest entry, gamma 1e-3), K4 (rtol
    5e-3, atol 5e-3), K2 (2e-4), K1 (rtol 1e-4, atol 1e-5) and the whole
    solve (decisions equal, X within 1e-2 of the plain solve's largest
    entry), each launched once."""
    c = arm2
    a3 = (c["model"], c["X"], c["U"], c["goals"], c["xs"], c["rho"], 0.05,
          1e-3, 1e-4)
    ks, ks_ref = k3.form_kkt_schur(*a3), k3.form_kkt_schur_reference(*a3)
    for f in ("SL", "SD", "SU", "PL", "PD", "PU", "gamma"):
        g, w = getattr(ks, f), getattr(ks_ref, f)
        bound = 1e-3 if f == "gamma" else 1e-4
        assert float((g - w).abs().max() / w.abs().max()) < bound, f
    lam0 = torch.zeros_like(c["X"])
    got, want = (k4.pcg_dz(ks_ref, lam0, 30, 1e-6),
                 k4.pcg_dz_reference(ks_ref, lam0, 30, 1e-6))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 5e-3, 5e-3)
    a2 = (c["model"], c["X"], c["U"], want[1], want[2], 8, c["goals"],
          c["xs"], 0.05, 10.0, 1e-3, 1e-4)
    _close(k2.line_search_merits(*a2), k2.line_search_merits_reference(*a2),
           2e-4, 2e-4)
    a1 = (c["model"], c["cfg"], c["xs"], c["U"], c["goals"][0], 2000.0,
          2000.0, 11)
    for g, w in zip(k1.plant_rollout(*a1), k1.plant_rollout_reference(*a1)):
        _close(g, w, 1e-4, 1e-5)
    import dataclasses

    from mpcgpu_tpu_torch.sqp import sqp_solve
    mega = dataclasses.replace(c["cfg"], fused_stages=True, megakernel=True,
                               megakernel_solve=True)
    args = (c["X"], c["U"], lam0, c["goals"], c["xs"], c["rho"], 1e-6)
    res, counts = _counted(lambda: sqp_solve(c["model"], mega, *args))
    plain = sqp_solve(c["model"], c["cfg"], *args)
    assert counts == {"K2": 1, "K5": 1}
    assert torch.equal(res.stats.accepted, plain.stats.accepted)
    assert float((res.X - plain.X).abs().max() / plain.X.abs().max()) < 1e-2


def test_two_joint_wrappers_of_the_iiwa_only_kernels_raise_by_name(arm2):
    """K4b, K6, K7, K7s, K9p, K9b, K10 and K11 raise for a 2-joint problem
    on the card, before any launch."""
    from mpcgpu_tpu_torch.ops.cuda.spmv_halo_kernel import spmv_halo

    c = arm2
    ks = k3.form_kkt_schur_reference(c["model"], c["X"], c["U"], c["goals"],
                                     c["xs"], c["rho"], 0.05, 1e-3, 1e-4)
    lam0 = torch.zeros_like(c["X"])
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    one = torch.ones((), device=lam0.device)
    kw = dict(dt=0.05, qd_cost=1e-3, r_cost=1e-4, gravity=0.0, mu=10.0,
              num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
              rho_reset=1e-3)
    m, X, U, g, xs = (c[k] for k in ("model", "X", "U", "goals", "xs"))
    calls = {
        "K4b": lambda: k4.pcg_solve(S, P, ks.gamma, lam0, 30, 1e-6),
        "K6": lambda: k6.bcr_pcg_dz(ks, lam0, 30, 1e-6),
        "K7": lambda: k7.bcr_dz(ks),
        "K7s": lambda: k7.bcr_solve(ks.SL, ks.SD, ks.SU, ks.gamma),
        "K9p": lambda: k9.sqp_iter_mega_pcg(m, X, U, g, xs, lam0, one, one,
                                            one, 30, 1e-6, **kw),
        "K9b": lambda: k9.sqp_iter_mega(m, X, U, g, xs, one, one, one, **kw),
        "K10": lambda: k10.sqp_solve_mega_pcg_packed(
            m, X[None], U[None], g[None], xs[None], lam0[None], one[None],
            one[None], 30, 1e-6, 3, **kw),
        "K11": lambda: spmv_halo(ks.SL, ks.SD, ks.SU, lam0, lam0[0],
                                 lam0[0])}
    for kid, call in calls.items():
        with pytest.raises(ValueError, match=kid):
            call()


# ---- the solver knobs (torch_systems.KNOB_CASES: each knob alone and the
# two combinations), as tests/test_torch_csrc_host.py holds the host build

def _knob_start(knob, n, dev, seed=5):
    """torch_systems.knob_start on dev."""
    xu, ee = load_fixture_pair(Path(__file__).resolve().parent / "fixtures")
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in knob_start(xu, ee, n, knob, seed))


_KNOB_KW = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=10.0,
                num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
                rho_reset=1e-3)


@pytest.mark.parametrize("knob", list(KNOB_CASES))
def test_k3_and_k2_kernels_under_a_knob_match_plain(card, knob):
    """K3 (rtol, atol 3e-3; where the end-effector position block is near
    singular at rho 1e-3 -- the Gauss-Newton Hessian, and the wrap cases'
    moved joints under eepos tracking -- against the float64 plain
    version, entry by entry, row by row: within_twice_plain at K3's rtol,
    atol) and
    K2 at a seeded 0.05 step (rtol, atol 2e-4) under each knob case at
    N = 64, the wrap cases' defects changed by the wrap."""
    kn, dev = KNOB_CASES[knob], card["X"].device
    X, U, goals, xs = _knob_start(knob, 64, dev)
    if kn.angle_wrap:
        assert wrap_changes_defects(card["model"], X, U, DT,
                                    kn.integrator_type)
    a3 = (card["model"], X, U, goals, xs, card["rho"], DT, QD_COST, R_COST)
    ks, ks_ref = (k3.form_kkt_schur(*a3, knobs=kn),
                  k3.form_kkt_schur_reference(*a3, knobs=kn))
    if kn.hessian == "gauss_newton" or (kn.tracking == "eepos"
                                        and kn.angle_wrap):
        # the position block near singular (chip_smoke.py phase 15): the
        # float64 plain version as the yardstick
        ks64 = k3.form_kkt_schur_reference(
            iiwa14(device=dev, dtype=torch.float64), *as_float64(a3[1:]),
            knobs=kn)
        within_twice_plain(ks, ks_ref, ks64, K3_TOLS, per_row=True)
    else:
        for g, w in zip(ks, ks_ref):
            _close(g, w, 3e-3, 3e-3)
    rng = np.random.default_rng(5)
    step = [torch.as_tensor((0.05 * rng.normal(size=tuple(t.shape))).astype(
        np.float32), device=dev) for t in (X, U)]
    a2 = (card["model"], X, U, *step, 8, goals, xs, DT, 10.0, QD_COST,
          R_COST)
    _close(k2.line_search_merits(*a2, knobs=kn),
           k2.line_search_merits_reference(*a2, knobs=kn), 2e-4, 2e-4)


@pytest.mark.parametrize("knob", list(KNOB_CASES))
@pytest.mark.parametrize("kernel", ["K5", "K9p", "K9b", "K10"])
def test_solve_kernels_under_a_knob_match_plain(card, kernel, knob):
    """One SQP iteration of K5, K9p, K9b and K10 (two arms) under each
    knob case at N = 8, cold duals, rho 1e-3: the decisions and CG counts
    of the plain version, X, U and lam no farther from the float64 plain
    version than twice the float32 one's largest distance, beyond the
    default checks' tolerances (torch_systems.within_twice_plain); K9b's
    duals by relative residual, within three times the float64 plain
    solve's rounded to float32 (torch_systems.residual_near_float64: the
    wrap cases' pi-sized defects on systems of condition ~1e7), and X, U
    and merit at rtol 1e-3, atol 2e-4 against the plain iteration given
    the kernel's duals."""
    kn, dev, model = KNOB_CASES[knob], card["X"].device, card["model"]
    model64 = iiwa14(device=dev, dtype=torch.float64)
    n = 8
    X, U, goals, xs = _knob_start(knob, n, dev)
    lam0, rho = torch.zeros_like(X), torch.tensor(1e-3, device=dev)
    kw = dict(_KNOB_KW, knobs=kn)
    merit = k2.line_search_merits_reference(
        model, X, U, torch.zeros_like(X), torch.zeros_like(U), 8, goals, xs,
        DT, 10.0, QD_COST, R_COST, knobs=kn)[8]
    one = torch.tensor(1.0, device=dev)
    if kernel == "K5":
        args = (X, U, goals, xs, lam0, rho, 1.0, merit, 40, 5e-5, 1)
        run, plain = k5.sqp_solve_mega_pcg, k5.sqp_solve_mega_pcg_reference
        same = ("sqp_iters", "bailed", "accepted", "pcg_iters")
    elif kernel == "K9p":
        args = (X, U, goals, xs, lam0, rho, one, merit, 40, 5e-5)
        run, plain = k9.sqp_iter_mega_pcg, k9.sqp_iter_mega_pcg_reference
        same = ("accept", "bail", "pcg_iters")
    elif kernel == "K9b":
        args = (X, U, goals, xs, rho, one, merit)
        run, plain = k9.sqp_iter_mega, k9.sqp_iter_mega_reference
        same = ("accept", "bail")
    else:
        X2 = _knob_start(knob, n, dev, seed=6)[0]
        Xb = torch.stack([X, X2])
        args = (Xb, U.expand(2, n - 1, 7).contiguous(),
                goals.expand((2,) + goals.shape), Xb[:, 0].contiguous(),
                torch.zeros_like(Xb), torch.tensor([1e-3, 0.1], device=dev),
                torch.ones(2, device=dev), 40, 5e-5, 1)
        run = k10.sqp_solve_mega_pcg_packed
        plain = k10.sqp_solve_mega_pcg_packed_reference
        same = ("sqp_iters", "bailed", "pcg_iters_total")
    got, want = run(model, *args, **kw), plain(model, *args, **kw)
    want64 = plain(model64, *as_float64(args), **kw)
    for f in same:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    within_twice_plain(got, want, want64, {
        f: t for f, t in SOLVE_TOLS.items() if kernel != "K9b" or f != "lam"})
    if kernel == "K9b":
        given, ks = bcr_iteration_given_lam(model, *args, got.lam, **kw)
        residual_near_float64(ks, got.lam, want.lam, want64.lam)
        for f in ("X", "U", "merit"):
            _close(getattr(got, f), getattr(given, f), 1e-3, 2e-4)
