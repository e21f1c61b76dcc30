"""Port parity for K7's plain version: mpcgpu_tpu_torch's bcr_dz (the
refined BCR solve + dz) on CPU tensors vs the JAX kernel
bcr_dz_pallas_lanes in interpret mode; and the split paths' glue.
K7s's plain version, one unrefined solve (btsolve.bcr_solve with
refine=0), is held against the JAX package's bcr_solve in
tests/test_torch_btsolve.py, which the JAX package's own tests hold equal
to its bcr_solve_pallas_lanes (tests/test_bcr.py): its interpret-mode
compile would cost another 15-25 s here.

System: the JAX BCR tests' seeded random KKT system (random_kkt,
condensed without the stair), at N = 2 (one elimination level, the root,
the back substitution and the refinement): the JAX interpret-mode
compile of the kernel takes 25-40 s there, 25-50 s at N = 4 and 75 s at
N = 16 on the suite's CPU workers.  Longer horizons are
held elsewhere: the same plain solve against the JAX portable one at
N = 8 and 16 (tests/test_torch_btsolve.py), and the kernels' host build
against it at N = 8 and 16 (tests/test_torch_csrc_host.py).
Tolerances of tests/test_bcr.py:37-74:
lam scaled by its largest entry at atol 2e-5, dX and dU at atol 2e-4,
rtol 1e-3; iterations 0 and no hit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.ops.pallas.bcr_kernel import bcr_dz_pallas_lanes
from mpcgpu_tpu.ops.pallas.kkt_schur_kernel import LaneSchur
from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k7
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import KnotSchur
from tests.torch_systems import random_system

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 2
LAM_ATOL = 2e-5                    # on lam / max |lam|
DZ_TOL = dict(atol=2e-4, rtol=1e-3)


def _lam_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=LAM_ATOL)


@pytest.fixture(scope="module")
def system():
    ks = random_system(N)
    lane = lambda a: jnp.asarray(np.moveaxis(a, 0, -1))   # knot axis last
    return (KnotSchur(**{f: torch.as_tensor(v) for f, v in ks.items()}),
            LaneSchur(*(lane(ks[f]) for f in LaneSchur._fields)))


def test_k7_plain_matches_pallas_interpret(system):
    ks, ls = system
    lam, dX, dU, it, hit = k7.bcr_dz(ks)
    lam_l, dX_p, dU_p, it_p, hit_p = bcr_dz_pallas_lanes(ls, interpret=True)
    assert int(it) == int(it_p) == 0 and not bool(hit) and not bool(hit_p)
    _lam_close(lam.numpy(), np.asarray(lam_l).T)
    np.testing.assert_allclose(dX.numpy(), np.asarray(dX_p), **DZ_TOL)
    np.testing.assert_allclose(dU.numpy(), np.asarray(dU_p), **DZ_TOL)


@pytest.mark.parametrize("n", [8, 16])
def test_split_glue_equals_the_refined_plain_solve(n):
    """With the plain K7s as its solve, the split path's glue (solve,
    residual, solve; the CG with K7s applies) is the plain K7 and K6
    arithmetic: equal to their plain versions to float32 rounding."""
    ks = KnotSchur(**{f: torch.as_tensor(v)
                      for f, v in random_system(n, seed=7).items()})
    solve = lambda rhs: k7.bcr_solve_reference(ks.SL, ks.SD, ks.SU, rhs)
    got, want = k7.bcr_dz_split(ks, solve), k7.bcr_dz_reference(ks)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    lam0 = torch.zeros(n, 14)
    got = k7.bcr_pcg_dz_split(ks, lam0, 40, 5e-5, solve)
    want = k7.bcr_pcg_dz_reference(ks, lam0, 40, 5e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_bcr_wrappers_refuse_non_power_of_two_and_other_devices():
    ks = KnotSchur(**{f: torch.as_tensor(v)
                      for f, v in random_system(6).items()})
    with pytest.raises(ValueError, match="power-of-2"):
        k7.bcr_dz(ks)
    meta = KnotSchur(*(torch.empty(t.shape, device="meta") for t in ks))
    with pytest.raises(ValueError, match="unsupported device"):
        k7.bcr_solve(meta.SL, meta.SD, meta.SU, meta.gamma)
