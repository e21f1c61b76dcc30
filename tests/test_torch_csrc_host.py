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
from mpcgpu_tpu_torch.ops.cuda import _lib
from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
from tests.test_torch_kkt_schur import DT, QD_COST, R_COST, RHO, problem

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.as_tensor


@pytest.fixture(scope="module")
def host():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no host C++ compiler")
    model = iiwa14()
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
