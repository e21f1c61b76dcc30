"""Port parity for K4's plain version: mpcgpu_tpu_torch's pcg_dz (CPU
tensors -> ops.pcg + ops.dz) vs the JAX ops.pcg + compute_dz, and vs the
JAX Pallas kernel pcg_dz_pallas_lanes in interpret mode.

N = 8, the Schur system of fixture 0_0 (K3's plain version), cold and
warm duals.  Tolerance rtol 5e-3, atol 5e-3 (tests/test_pcg_pallas.py);
CG iteration counts agree within 2, or both hit the cap.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.ops.btridiag import BlockTri
from mpcgpu_tpu.ops.dz import compute_dz
from mpcgpu_tpu.ops.kkt import KKTData
from mpcgpu_tpu.ops.pallas.kkt_schur_kernel import LaneSchur
from mpcgpu_tpu.ops.pallas.pcg_kernel import pcg_dz_pallas_lanes
from mpcgpu_tpu.ops.pcg import pcg
from mpcgpu_tpu.ops.schur import SchurData
from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import pcg_dz
from tests.test_torch_kkt_schur import knot_schur, problem

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=5e-3, atol=5e-3)
CASES = [(300, 1e-9, "cold"), (40, 5e-5, "cold"), (5, 1e-12, "warm")]


def _system(traj_0_0, warm):
    X, U, goals, xs = problem(traj_0_0)
    ks = knot_schur(X, U, goals, xs)
    n = X.shape[0]
    rng = np.random.default_rng(3)
    lam0 = (0.01 * rng.normal(size=(n, 14)) if warm
            else np.zeros((n, 14))).astype(np.float32)
    return {f: v.numpy() for f, v in ks._asdict().items()}, lam0


def _iters_agree(a, b, cap, hit_a, hit_b):
    assert abs(int(a) - int(b)) <= 2 or (int(a) == int(b) == cap), (a, b)
    assert bool(hit_a) == bool(hit_b)


@pytest.mark.parametrize("cap,tol,start", CASES)
def test_k4_plain_matches_jax_portable(traj_0_0, cap, tol, start):
    ks, lam0 = _system(traj_0_0, start == "warm")
    lam, dX, dU, it, hit = pcg_dz(_torch_ks(ks), torch.as_tensor(lam0), cap,
                                  tol)
    S = BlockTri(ks["SL"], ks["SD"], ks["SU"])
    P = BlockTri(ks["PL"], ks["PD"], ks["PU"])
    ref = pcg(S, P, ks["gamma"], lam0, cap, tol)
    kkt = KKTData(Q=None, q=ks["q"], R=None, r=ks["r"][:-1], A=ks["A"][:-1],
                  B=ks["B"][:-1], c=None)
    sd = SchurData(S=S, Pinv=P, gamma=ks["gamma"], Qinv=ks["Qinv"],
                   Rinv=ks["Rinv"][:-1])
    dX_ref, dU_ref = compute_dz(kkt, sd, ref.lam)
    _iters_agree(it, ref.iters, cap, hit, ref.hit_max)
    np.testing.assert_allclose(lam.numpy(), np.asarray(ref.lam), **TOL)
    np.testing.assert_allclose(dX.numpy(), np.asarray(dX_ref), **TOL)
    np.testing.assert_allclose(dU.numpy(), np.asarray(dU_ref), **TOL)


@pytest.mark.parametrize("cap,tol,start", CASES[1:])
def test_k4_plain_matches_pallas_interpret(traj_0_0, cap, tol, start):
    ks, lam0 = _system(traj_0_0, start == "warm")
    lam, dX, dU, it, hit = pcg_dz(_torch_ks(ks), torch.as_tensor(lam0), cap,
                                  tol)
    lane = lambda a: jnp.asarray(np.moveaxis(a, 0, -1))   # knot axis last
    ls = LaneSchur(*(lane(ks[f]) for f in LaneSchur._fields))
    lam_l, dX_p, dU_p, it_p, hit_p = pcg_dz_pallas_lanes(
        ls, lane(lam0), cap, tol, interpret=True)
    _iters_agree(it, it_p, cap, hit, hit_p)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_l).T, **TOL)
    np.testing.assert_allclose(dX.numpy(), np.asarray(dX_p), **TOL)
    np.testing.assert_allclose(dU.numpy(), np.asarray(dU_p), **TOL)


def _torch_ks(ks):
    from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import KnotSchur

    return KnotSchur(**{f: torch.as_tensor(v) for f, v in ks.items()})
