"""Horizon-sharded PCG with explicit collectives (counterpart of
mpcgpu_tpu/parallel/pcg_sharded.py).

The knot axis of the block-tridiagonal system is cut into the mesh's
shards and each CG step runs, on every shard,

  * the banded SpMV of its rows, with the k+-1 halo rows from the
    neighbouring shards (``Mesh.halos``, in place of JAX's
    ``_halo_shifted``);
  * the two dot products as per-shard partials summed over the mesh
    (``Mesh.psum``).

The loop is ``ops.pcg.pcg``'s: ``max_iter`` steps with every step after
the exit masked, so it reads nothing on the host.  The shard bodies take
lists of the local shards (``parallel/mesh.py``); ``pcg_sharded_cuda``
runs the same loop with the SpMV as the kernel K11.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.cuda.spmv_halo_kernel import spmv_halo_reference
from mpcgpu_tpu_torch.parallel.mesh import Mesh


def _spmv_local(mesh: Mesh, bands: list, xs: list, spmv=None) -> list:
    """Each shard's rows of T x: bands are per-shard (L, D, U) triples.
    spmv(L, D, U, x, xl, xr) computes one shard (the plain version of K11
    by default)."""
    spmv = spmv or spmv_halo_reference
    left, right = mesh.halos(xs)
    return [spmv(*b, x, lf, rt)
            for b, x, lf, rt in zip(bands, xs, left, right)]


def _pdot(mesh: Mesh, a: list, b: list) -> torch.Tensor:
    return mesh.psum([(x * y).sum() for x, y in zip(a, b)])


def _pcg_shard(mesh: Mesh, max_iter: int, exit_tol, S: list, P: list,
               gamma: list, lam0: list, spmv=None):
    """The CG on the local shards (lists); returns (lam shards, iters,
    hit_max), iters and hit_max the same on every shard."""
    tol = torch.as_tensor(exit_tol, dtype=gamma[0].dtype,
                          device=gamma[0].device)
    apply_S = lambda xs: _spmv_local(mesh, S, xs, spmv)
    apply_P = lambda xs: _spmv_local(mesh, P, xs, spmv)
    axpy = lambda a, xs, ys: [x + a * y for x, y in zip(xs, ys)]
    keep = lambda act, new, old: [torch.where(act, n, o)
                                  for n, o in zip(new, old)]

    r = [g - s for g, s in zip(gamma, apply_S(lam0))]
    rt = apply_P(r)
    p, lam = rt, lam0
    eta = _pdot(mesh, r, rt)
    iters = torch.zeros((), dtype=torch.int32, device=tol.device)
    for _ in range(int(max_iter)):
        active = eta.abs() > tol
        ups = apply_S(p)
        alpha = eta / _pdot(mesh, p, ups)
        lam_n = axpy(alpha, lam, p)
        r_n = axpy(-alpha, r, ups)
        rt_n = apply_P(r_n)
        eta_n = _pdot(mesh, r_n, rt_n)
        p_n = axpy(eta_n / eta, rt_n, p)
        lam, r, p = (keep(active, lam_n, lam), keep(active, r_n, r),
                     keep(active, p_n, p))
        eta = torch.where(active, eta_n, eta)
        iters = iters + active.to(torch.int32)
    return lam, iters, eta.abs() > tol


def shard_system(mesh: Mesh, S: BlockTri, Pinv: BlockTri, gamma, lam0):
    """(S shards, Pinv shards, gamma shards, lam0 shards) on the mesh, each
    shard contiguous."""
    cut = lambda t: mesh.shard(t.contiguous())
    bands = lambda T: list(zip(*(cut(b) for b in T)))
    return bands(S), bands(Pinv), cut(gamma), cut(lam0)


def pcg_sharded(mesh: Mesh, S: BlockTri, Pinv: BlockTri, gamma, lam0,
                max_iter: int, exit_tol):
    """Solve S lam = gamma with the knot axis sharded over the mesh: S and
    Pinv bands (N, s, s), gamma and lam0 (N, s) whole on every rank, N a
    multiple of the mesh's size.  Returns (lam (N, s), iters, hit_max)
    like ops.pcg.pcg, on every rank."""
    lam, iters, hit = _pcg_shard(mesh, max_iter, exit_tol,
                                 *shard_system(mesh, S, Pinv, gamma, lam0))
    return mesh.gather(lam), iters, hit
