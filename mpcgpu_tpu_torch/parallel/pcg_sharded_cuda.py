"""Horizon-sharded PCG with the SpMV as the kernel K11 (counterpart of
mpcgpu_tpu/parallel/pcg_sharded_pallas.py).

``pcg_sharded``'s loop, with both SpMVs of each CG step (S p and Pinv r)
as one launch of K11 each over every local shard
(``ops/cuda/spmv_halo_kernel.py`` ``spmv_halo_shards``): the rows at the
local shards' edges are read where they lie, and only the two rows
outside them come from ``Mesh.outer_halos`` (zeros in-process; the halo
all_reduce over a group); the dots are summed by ``Mesh.psum`` between
the launches.  The TPU's transposes to its lane layout and its
roll-and-mask halos are not needed: the shards are knot-major.  A CG
solve launches K11 2 + 2 x max_iter times, in-process as in each rank.
CPU tensors run K11's plain version, so there this equals
``pcg_sharded``.

Registered as a linear-solver backend by parallel/sharded.py
(``sharded_sqp_solve(fused_pcg=True)``).
"""
from __future__ import annotations

from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.cuda.spmv_halo_kernel import spmv_halo_shards
from mpcgpu_tpu_torch.parallel.mesh import Mesh
from mpcgpu_tpu_torch.parallel.pcg_sharded import _pcg_shard, shard_system


def _pcg_shard_fused(mesh: Mesh, max_iter: int, exit_tol, S: list, P: list,
                     gamma: list, lam0: list):
    """The sharded CG on the local shards with K11 as every SpMV."""
    return _pcg_shard(mesh, max_iter, exit_tol, S, P, gamma, lam0,
                      spmv=spmv_halo_shards)


def pcg_sharded_cuda(mesh: Mesh, S: BlockTri, Pinv: BlockTri, gamma, lam0,
                     max_iter: int, exit_tol):
    """pcg_sharded with K11 as every SpMV: returns (lam (N, s), iters,
    hit_max) on every rank."""
    lam, iters, hit = _pcg_shard_fused(
        mesh, max_iter, exit_tol, *shard_system(mesh, S, Pinv, gamma, lam0))
    return mesh.gather(lam), iters, hit
