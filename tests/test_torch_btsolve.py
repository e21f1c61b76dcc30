"""Port parity for block cyclic reduction: mpcgpu_tpu_torch.ops.btsolve
(bcr_solve, the "bcr_pcg" backend) and K6's plain version (the
bcr_pcg_dz wrapper on CPU tensors) vs the JAX package's bcr_solve,
_solve_linsys_bcr_pcg and bcr_pcg_dz_pallas_lanes (interpret mode).

Systems: the JAX BCR tests' seeded random KKT system, and the Schur
system of fixture 0_0 (K3's plain version, no stair preconditioner).
Tolerances: lam scaled by its largest entry at atol 2e-5, dX and dU at
atol 2e-4, rtol 1e-3 (tests/test_bcr.py:62-74); CG iteration counts agree
within 1.  The exact solve is compared on the random system only: on the
fixture's rho = 1e-3 system (condition ~1e7) two float32 eliminations in
different orders differ by up to ~1e-3 of the largest entry, which is its
conditioning, not a fault (judge exact solvers by residual there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import PCGConfig as JaxPCGConfig
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.ops.btridiag import BlockTri as JaxBlockTri
from mpcgpu_tpu.ops.btsolve import _solve_linsys_bcr_pcg as jax_bcr_pcg
from mpcgpu_tpu.ops.btsolve import bcr_solve as jax_bcr_solve
from mpcgpu_tpu.ops.pallas.bcr_kernel import bcr_pcg_dz_pallas_lanes
from mpcgpu_tpu.ops.pallas.kkt_schur_kernel import LaneSchur
from mpcgpu_tpu.ops.schur import SchurData as JaxSchurData
from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv
from mpcgpu_tpu_torch.ops.btsolve import _solve_linsys_bcr_pcg, bcr_solve
from mpcgpu_tpu_torch.ops.cuda.bcr_kernel import bcr_pcg_dz
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import KnotSchur
from mpcgpu_tpu_torch.ops.schur import SchurData
from tests.torch_systems import random_system
from tests.test_torch_kkt_schur import knot_schur, problem

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LAM_ATOL = 2e-5                    # on lam / max |lam|
DZ_TOL = dict(atol=2e-4, rtol=1e-3)


def fixture_system(traj_0_0, n):
    """K3's plain preconditioned=False system at N = n, as numpy arrays."""
    ks = knot_schur(*problem(traj_0_0, n=n), precond=False)
    return {f: v.numpy() for f, v in ks._asdict().items()}


def _lam_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=LAM_ATOL)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("refine", [0, 1])
def test_bcr_solve_matches_jax(n, refine):
    ks = random_system(n, seed=7)
    bands = (ks["SL"], ks["SD"], ks["SU"])
    want = jax_bcr_solve(JaxBlockTri(*bands), ks["gamma"], refine=refine)
    got = bcr_solve(BlockTri(*(torch.as_tensor(b) for b in bands)),
                    torch.as_tensor(ks["gamma"]), refine=refine)
    _lam_close(got.numpy(), want)


def test_bcr_solve_rejects_non_power_of_two():
    ks = random_system(6)
    S = BlockTri(*(torch.as_tensor(ks[f]) for f in ("SL", "SD", "SU")))
    with pytest.raises(ValueError, match="power-of-2"):
        bcr_solve(S, torch.as_tensor(ks["gamma"]))


def test_bcr_solve_residual_on_the_fixture_system(traj_0_0):
    """On the ill-conditioned fixture system the refined solve is judged
    by its residual: |S lam - gamma| within 1e-4 of |gamma| (float32)."""
    ks = knot_schur(*problem(traj_0_0, n=16), precond=False)
    S = BlockTri(ks.SL, ks.SD, ks.SU)
    lam = bcr_solve(S, ks.gamma)
    res = (spmv(S, lam) - ks.gamma).abs().max() / ks.gamma.abs().max()
    assert float(res) < 1e-4


@pytest.mark.parametrize("cap,tol", [(40, 5e-5), (20, 1e-10)])
def test_bcr_pcg_backend_matches_jax(cap, tol):
    ks = random_system(8)
    rng = np.random.default_rng(3)
    lam0 = (0.01 * rng.normal(size=(8, 14))).astype(np.float32)
    bands = (ks["SL"], ks["SD"], ks["SU"])
    want = jax_bcr_pcg(JaxSolverConfig.for_knots(
        8, pcg=JaxPCGConfig(max_iter=cap)), JaxSchurData(
        S=JaxBlockTri(*bands), Pinv=None, gamma=ks["gamma"], Qinv=None,
        Rinv=None), jnp.asarray(lam0), tol)
    got = _solve_linsys_bcr_pcg(SolverConfig.for_knots(
        8, pcg=PCGConfig(max_iter=cap)), SchurData(
        S=BlockTri(*(torch.as_tensor(b) for b in bands)), Pinv=None,
        gamma=torch.as_tensor(ks["gamma"]), Qinv=None, Rinv=None),
        torch.as_tensor(lam0), tol)
    _lam_close(got[0].numpy(), want[0])
    assert abs(int(got[1]) - int(want[1])) <= 1
    assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("system", ["random", "fixture"])
def test_k6_plain_matches_pallas_interpret(traj_0_0, system):
    """The K6 wrapper on CPU tensors (its plain version) vs the JAX
    kernel in interpret mode, N = 8, cold duals, cap 40, tol 5e-5."""
    n, cap, tol = 8, 40, 5e-5
    ks = random_system(n) if system == "random" else fixture_system(
        traj_0_0, n)
    lam0 = np.zeros((n, 14), np.float32)
    lam, dX, dU, it, hit = bcr_pcg_dz(
        KnotSchur(**{f: torch.as_tensor(v) for f, v in ks.items()}),
        torch.as_tensor(lam0), cap, tol)
    lane = lambda a: jnp.asarray(np.moveaxis(a, 0, -1))   # knot axis last
    ls = LaneSchur(*(lane(ks[f]) for f in LaneSchur._fields))
    lam_l, dX_p, dU_p, it_p, hit_p = bcr_pcg_dz_pallas_lanes(
        ls, lane(lam0), cap, tol, interpret=True)
    assert abs(int(it) - int(it_p)) <= 1 and bool(hit) == bool(hit_p)
    _lam_close(lam.numpy(), np.asarray(lam_l).T)
    np.testing.assert_allclose(dX.numpy(), np.asarray(dX_p), **DZ_TOL)
    np.testing.assert_allclose(dU.numpy(), np.asarray(dU_p), **DZ_TOL)
