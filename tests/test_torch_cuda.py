"""The CUDA kernels K1-K6 against their plain versions, on the card.

Marked ``cuda``: each test needs a CUDA device and skips without one.
The file uses no fixture of tests/conftest.py, which imports JAX, so on a
GPU machine without JAX it runs with

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Inputs are the slice's: fixture 0_0 at N = 64 (K6 also on the JAX BCR
tests' well-conditioned random system of tests/torch_systems.py).
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
from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair
# by its bare name (pytest puts tests/ on sys.path): the card machine may
# have another package named "tests"
from torch_systems import random_knot_schur

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


@pytest.mark.parametrize("offset_us", [0.0, 2000.0])
def test_k1_kernel_matches_plain(card, offset_us):
    c = card
    args = (c["model"], SolverConfig.for_knots(64), c["xs"], c["U"],
            c["goals"][0], offset_us, 2000.0, 11)
    for g, w in zip(k1.plant_rollout(*args), k1.plant_rollout_reference(*args)):
        _close(g, w, 1e-4, 1e-5)


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


def _perturbed_X(c):
    """The slice's X with a seeded perturbation (knot 0 kept), so that the
    CG loops iterate."""
    pert = 0.02 * np.random.default_rng(5).normal(size=(64, 14))
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
