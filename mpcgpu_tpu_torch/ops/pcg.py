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

Leading dimensions of gamma (an arm axis: gamma (B, N, s)) hold
independent systems, with dots per arm, in one of two exit modes:

* per-arm freeze (``shared_exit=False``, what ``jax.vmap`` of the
  single-system loop gives): each arm stops at its own |eta| <= tol, and
  ``iters`` and ``hit_max`` are per arm;
* shared exit (``shared_exit=True``, the arm-packed megakernel's
  ``_pcg_loop_packed``): the loop runs while the largest |eta| over the
  arms is above tol, and every arm steps while it runs -- an arm that has
  already converged keeps stepping, and only the 0/0 -> 0 of alpha and
  beta freezes an arm whose residual is exactly zero.  ``iters`` is one
  count shared by all arms; ``hit_max`` is per arm.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv


class PCGResult(NamedTuple):
    lam: torch.Tensor       # (..., N, s)
    iters: torch.Tensor     # int32 iterations taken
    hit_max: torch.Tensor   # bool: |eta| > tol at exit


def _dot(a, b):
    return (a * b).sum((-1, -2))


def _safe_div(num, den):
    """num / den with 0 -> 0 where num is 0 (the packed kernel's
    _safe_div: an arm with r = 0 exactly freezes instead of making NaN)."""
    live = num.abs() > 0
    return torch.where(live, num / torch.where(live, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def pcg(S: BlockTri, Pinv: BlockTri, gamma, lam0, max_iter: int,
        exit_tol, shared_exit: bool = False) -> PCGResult:
    """Solve S lam = gamma, warm-started at lam0 (module doc)."""
    tol = torch.as_tensor(exit_tol, dtype=gamma.dtype, device=gamma.device)
    div = _safe_div if shared_exit else torch.div
    r = gamma - spmv(S, lam0)
    rt = spmv(Pinv, r)
    p = rt
    eta = _dot(r, rt)
    lam = lam0
    iters = torch.zeros(() if shared_exit else eta.shape, dtype=torch.int32,
                        device=gamma.device)
    for _ in range(int(max_iter)):
        # shared: jnp.max(|eta|) > tol, so a NaN arm stops every arm
        active = (eta.abs().amax() if shared_exit else eta.abs()) > tol
        ups = spmv(S, p)
        alpha = div(eta, _dot(p, ups))[..., None, None]
        lam_n = lam + alpha * p
        r_n = r - alpha * ups
        rt_n = spmv(Pinv, r_n)
        eta_n = _dot(r_n, rt_n)
        p_n = rt_n + div(eta_n, eta)[..., None, None] * p
        act = active[..., None, None]
        lam = torch.where(act, lam_n, lam)
        r = torch.where(act, r_n, r)
        p = torch.where(act, p_n, p)
        eta = torch.where(active, eta_n, eta)
        iters = iters + active.to(torch.int32)
    return PCGResult(lam=lam, iters=iters, hit_max=eta.abs() > tol)
