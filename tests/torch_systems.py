"""Seeded test systems for the port's kernels, shared by the CPU tests,
the card tests and chip_smoke.py (which loads this file by path).

Imports no JAX and no pytest, so it serves on a machine without either.
"""
import numpy as np
import torch

from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import KnotSchur
from mpcgpu_tpu_torch.ops.kkt import KKTData
from mpcgpu_tpu_torch.ops.schur import form_schur


def random_system(n, seed=11, rho=1e-3):
    """The JAX BCR tests' random KKT system (tests/test_schur_pcg.py
    random_kkt), condensed by the port's form_schur without the stair
    preconditioner; numpy arrays in the KnotSchur layout."""
    nx, nu = 14, 7
    rng = np.random.default_rng(seed)
    f = np.float32
    M = rng.normal(size=(n, nx, nx)).astype(f)
    Q = 0.1 * np.einsum("kij,klj->kil", M, M) + np.eye(nx, dtype=f)
    Rm = rng.normal(size=(n - 1, nu, nu)).astype(f)
    R = 0.1 * np.einsum("kij,klj->kil", Rm, Rm) + np.eye(nu, dtype=f)
    A = 0.3 * rng.normal(size=(n - 1, nx, nx)).astype(f)
    B = 0.3 * rng.normal(size=(n - 1, nx, nu)).astype(f)
    q = rng.normal(size=(n, nx)).astype(f)
    r = rng.normal(size=(n - 1, nu)).astype(f)
    c = rng.normal(size=(n, nx)).astype(f)
    c[0] = 0.0
    kkt = KKTData(*(torch.as_tensor(v) for v in (Q, q, R, r, A, B, c)))
    sd = form_schur(kkt, rho, preconditioned=False)
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:1])]).numpy()
    return dict(SL=sd.S.lower.numpy(), SD=sd.S.diag.numpy(),
                SU=sd.S.upper.numpy(), PL=sd.Pinv.lower.numpy(),
                PD=sd.Pinv.diag.numpy(), PU=sd.Pinv.upper.numpy(),
                gamma=sd.gamma.numpy(), Qinv=sd.Qinv.numpy(),
                Rinv=pad(sd.Rinv), A=pad(kkt.A), B=pad(kkt.B),
                q=kkt.q.numpy(), r=pad(kkt.r))


def random_knot_schur(n, seed=11, device="cpu"):
    """random_system as a KnotSchur of tensors on device."""
    return KnotSchur(**{f: torch.as_tensor(v, device=device)
                        for f, v in random_system(n, seed).items()})
