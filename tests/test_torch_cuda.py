"""The CUDA kernels K1-K7, K7s, K9p, K9b and K10, K3 at the long horizons
of the TPU's tiled K8, the grid-CG forms K4g, K4bg, K5g and K9pg, and the
cluster forms of K5, K9p and K6 at every cluster size the card admits,
against their plain versions, on the card.

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
from torch_systems import (bcr_iteration_given_lam, random_knot_schur,
                           relative_residual)

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


# ---- long horizons: K3 at the TPU's tiled K8 horizons, and the grid-CG
# forms K4g, K4bg, K5g, K9pg (fixture 0_0's first N knots, r_cost 1e-4,
# cap 24, exit tol 1e-5: for_knots(N), tpu_tuned_max_iter(N) and
# default_pcg_exit_tols(N)[0] at N = 128 and 256)
LONG_R_COST, LONG_CAP, LONG_TOL = 1e-4, 24, 1e-5


def _long(card, n, seed):
    """The first n knots of fixture 0_0 on the card, every knot but 0
    moved by a seeded 0.02-scale normal draw."""
    dev = card["X"].device
    xu, ee = load_fixture_pair(Path(__file__).resolve().parent / "fixtures")
    pert = 0.02 * np.random.default_rng(seed).normal(size=(n, 14))
    pert[0] = 0.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                                  device=dev)
    return (t(xu[:n, :14] + pert), t(xu[:n - 1, 14:]), t(ee[:n]),
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


@pytest.mark.parametrize("n", [128, 256])
def test_k4g_and_k4bg_kernels_match_plain(card, n):
    """K4's tolerances: lam, dX, dU at rtol 5e-3, atol 5e-3; CG counts
    within 2 or both at the cap."""
    ks = k3.form_kkt_schur_reference(*_long_k3_args(card, n))
    lam0 = torch.zeros(n, 14, device=card["X"].device)
    got = k4.pcg_dz_grid(ks, lam0, LONG_CAP, LONG_TOL)
    want = k4.pcg_dz_reference(ks, lam0, LONG_CAP, LONG_TOL)
    S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
    got_b = k4.pcg_solve_grid(S, P, ks.gamma, lam0, LONG_CAP, LONG_TOL)
    want_b = k4.pcg_solve_reference(S, P, ks.gamma, lam0, LONG_CAP, LONG_TOL)
    for g, w in zip((*got[:3], got_b[0]), (*want[:3], want_b[0])):
        _close(g, w, 5e-3, 5e-3)
    for it, it_ref in ((got[3], want[3]), (got_b[1], want_b[1])):
        it, it_ref = int(it), int(it_ref)
        assert abs(it - it_ref) <= 2 or it == it_ref == LONG_CAP


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


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("rho", [1e-3, 0.3])
def test_k5g_kernel_matches_plain(card, n, rho):
    """K5's checks: X, U at rtol 1e-3, atol 1e-5; accepted, sqp_iters and
    rho_bailed identical; CG counts within 2 per SQP iteration; lam at
    atol 1e-3 at rho 1e-3 (every CG at the cap), else rtol 1e-3, atol
    1e-4."""
    args, kw = _k5g_args(card, n, rho), _long_kw()
    got = k5.sqp_solve_mega_pcg_grid(*args, **kw)
    want = k5.sqp_solve_mega_pcg_reference(*args, **kw)
    _close(got.X, want.X, 1e-3, 1e-5)
    _close(got.U, want.U, 1e-3, 1e-5)
    _close(got.lam, want.lam, *((0, 1e-3) if rho == 1e-3 else (1e-3, 1e-4)))
    for f in ("sqp_iters", "bailed", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int((got.pcg_iters - want.pcg_iters).abs().max()) <= 2


@pytest.mark.parametrize("n", [128, 256])
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


def test_k11_sharded_cg_matches_plain(card):
    """pcg_sharded_cuda (K11 per shard) on an in-process mesh of 8 shards
    against pcg_sharded (the plain per-shard SpMV) on the card, N = 64,
    the seeded random system with the stair: iterations within 3, lam at
    K4's rtol = atol = 5e-3; two K11 launches per shard per CG step."""
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
    assert k11.spmv_halo.launches - before == 8 * (2 + 2 * cap)
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


@pytest.mark.parametrize("n", [2, 64, 256, 512])
def test_k6_cluster_factor_equals_the_one_block_factor(card, n):
    """The cluster factor of K6, at each admitted cluster size, against
    the one-block factor of K7s on the same bands: the whole factor
    scratch (both zeroed first) bit for bit."""
    from mpcgpu_tpu_torch.ops.cuda import _lib

    lib = _lib.library()
    dev = card["X"].device
    ks = random_knot_schur(n, device=dev)
    size = lib.mpc_bcr_scratch_floats(n)
    one_block = torch.zeros(size, device=dev)
    k7._launch_solve(lib, ks.SL, ks.SD, ks.SU, ks.gamma,
                     _lib.stream_of(ks.gamma), scratch=one_block)
    for c in _k6_admitted(lib, n):
        cluster = torch.zeros(size, device=dev)
        k6._launch(lib, ks, torch.zeros(n, 14, device=dev), 3, 1e-9,
                   _lib.stream_of(ks.gamma), scratch=cluster, cluster=c)
        assert torch.equal(cluster, one_block), c
