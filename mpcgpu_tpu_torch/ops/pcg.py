"""Preconditioned CG over the block-tridiagonal system (counterpart of
mpcgpu_tpu/ops/pcg.py).

    r = gamma - S lam;  rt = Pinv r;  p = rt;  eta = r.rt
    while i < max_iter and |eta| > tol:
        ups = S p;  alpha = eta / p.ups
        lam += alpha p;  r -= alpha ups
        rt = Pinv r;  eta' = r.rt
        p = rt + (eta'/eta) p;  eta = eta'

The loop runs max_iter steps with every step after the exit masked out,
so the result equals the early-exit loop and no step reads a device
value on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv


class PCGResult(NamedTuple):
    lam: torch.Tensor       # (N, s)
    iters: torch.Tensor     # int32 iterations taken
    hit_max: torch.Tensor   # bool: |eta| > tol at exit


def pcg(S: BlockTri, Pinv: BlockTri, gamma, lam0, max_iter: int,
        exit_tol) -> PCGResult:
    """Solve S lam = gamma, warm-started at lam0."""
    tol = torch.as_tensor(exit_tol, dtype=gamma.dtype, device=gamma.device)
    r = gamma - spmv(S, lam0)
    rt = spmv(Pinv, r)
    p = rt
    eta = (r * rt).sum()
    lam = lam0
    iters = torch.zeros((), dtype=torch.int32, device=gamma.device)
    for _ in range(int(max_iter)):
        active = eta.abs() > tol
        ups = spmv(S, p)
        alpha = eta / (p * ups).sum()
        lam_n = lam + alpha * p
        r_n = r - alpha * ups
        rt_n = spmv(Pinv, r_n)
        eta_n = (r_n * rt_n).sum()
        p_n = rt_n + (eta_n / eta) * p
        lam = torch.where(active, lam_n, lam)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        eta = torch.where(active, eta_n, eta)
        iters = iters + active.to(torch.int32)
    return PCGResult(lam=lam, iters=iters, hit_max=eta.abs() > tol)
