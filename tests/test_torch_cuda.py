"""The CUDA kernels K1-K4 against their plain versions, on the card.

Marked ``cuda``: each test needs a CUDA device and skips without one.
The file uses no fixture of tests/conftest.py, which imports JAX, so on a
GPU machine without JAX it runs with

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Inputs are the slice's: fixture 0_0 at N = 64.  Tolerances are those of
the JAX package's own kernel tests.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

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
    return dict(model=iiwa14(dev), X=t(xu[:n, :14]), U=t(xu[:n - 1, 14:]),
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
