"""Horizon and arm sharding over a mesh (counterpart of
mpcgpu_tpu/parallel/sharded.py).

The JAX package lets GSPMD partition the whole solve from the inputs'
shardings; PyTorch has no such partitioner.  Here the horizon-sharded
paths shard the one stage whose collectives matter, the CG over the
block-tridiagonal Schur system: ``sharded_sqp_solve(explicit_pcg=True)``
and ``simulate_mpc_scan_sharded`` reach ``pcg_sharded`` (the plain
per-shard SpMV), ``fused_pcg=True`` reaches ``pcg_sharded_cuda`` (the
per-shard SpMV as the kernel K11), through the linear-solver backend
registry (``sqp.register_linsys_backend``).  The per-knot stages (KKT,
Schur condensation, line search) and the closed loop's carry run on the
whole horizon, replicated on every rank of a ``torch.distributed`` mesh;
sharding them across ranks is left for later.

A mesh (``horizon_mesh``, ``arms_mesh``) holds its shards in this process
on one device, or one per rank of a process group that the caller has
initialized (NCCL with one GPU per rank, for example under ``torchrun``;
gloo on the CPU).  ``parallel/mesh.py`` describes both.

The arm-parallel loops run independent arms per mesh group with no
collective but the gather of their statistics.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.parallel.mesh import Mesh
from mpcgpu_tpu_torch.sim import simulate_mpc_scan, simulate_mpc_scan_packed
from mpcgpu_tpu_torch.sqp import register_linsys_backend, sqp_solve

KNOT_AXIS = "knots"
ARM_AXIS = "arms"


def _mesh(axis: str, shards, device, group) -> Mesh:
    if shards is None:
        return Mesh.distributed(axis, device, group)
    if group is not None:
        raise ValueError("give shards (an in-process mesh) or group (one "
                         "shard per rank), not both")
    return Mesh.in_process(shards, device, axis)


def horizon_mesh(shards: int | None = None, device="cuda",
                 group=None) -> Mesh:
    """1-D mesh over the axis "knots": ``shards`` shards in this process on
    device, or, with shards None, one shard per rank of group (the
    default group if None), which the caller has initialized; device is
    then this rank's (the current CUDA device for "cuda")."""
    return _mesh(KNOT_AXIS, shards, device, group)


def arms_mesh(shards: int | None = None, device="cuda", group=None) -> Mesh:
    """horizon_mesh over the axis "arms"."""
    return _mesh(ARM_AXIS, shards, device, group)


def shard_horizon(mesh: Mesh, *arrays):
    """Each array's local shards of its leading axis, on the mesh's device:
    a tuple of lists."""
    return tuple(mesh.shard(a.to(mesh.device).contiguous()) for a in arrays)


def replicate(mesh: Mesh, *arrays):
    """The arrays whole on the mesh's device (on every rank)."""
    return tuple(a.to(mesh.device) for a in arrays)


def _mesh_key(mesh: Mesh) -> tuple:
    """The mesh's identity in a backend name (axis, size, form, device), so
    that a name registered for one mesh never runs another mesh's
    shards."""
    form = "in-process" if mesh.group is None else (
        f"ranks:{dist.get_backend(mesh.group)}:{id(mesh.group)}")
    return (mesh.axis, mesh.size, form, str(mesh.device))


def register_sharded_pcg(mesh: Mesh, fused: bool = False) -> str:
    """Register the horizon-sharded CG on mesh as a linear-solver backend
    (``pcg_sharded``, or ``pcg_sharded_cuda`` with fused) and return its
    name, for sqp_solve's ``linsys``."""
    if fused:
        from mpcgpu_tpu_torch.parallel.pcg_sharded_cuda import (
            pcg_sharded_cuda as pcg_fn)
    else:
        from mpcgpu_tpu_torch.parallel.pcg_sharded import (
            pcg_sharded as pcg_fn)

    def solve(cfg_, schur, lam_, tol):
        return pcg_fn(mesh, schur.S, schur.Pinv, schur.gamma, lam_,
                      cfg_.pcg.max_iter, tol)

    name = f"{pcg_fn.__name__}{_mesh_key(mesh)!r}"
    register_linsys_backend(name, solve)
    return name


def _plain_stages(cfg: SolverConfig) -> SolverConfig:
    """The sharded CG is reached through the plain stages' backend seam."""
    return dataclasses.replace(cfg, fused_stages=False, megakernel=False,
                               megakernel_solve=False)


def sharded_sqp_solve(model, cfg: SolverConfig, mesh: Mesh, X, U, lam, goals,
                      xs, rho, pcg_exit_tol, linsys: str = "pcg",
                      explicit_pcg: bool = False, fused_pcg: bool = False):
    """One SQP solve with the CG's knot axis sharded over the mesh.

    explicit_pcg=True solves the Schur system with pcg_sharded (the plain
    per-shard SpMV, mesh collectives between the CG stages); fused_pcg=True
    with pcg_sharded_cuda (the per-shard SpMV as K11).  Either runs the
    plain stages (cfg's fused_stages off), as the JAX package reaches its
    sharded backends only on its portable path.  With neither, this is
    sqp_solve(linsys) on the whole horizon, as the JAX package's GSPMD
    path computes the single-device solve.  Returns sqp_solve's result on
    every rank."""
    if explicit_pcg and fused_pcg:
        raise ValueError("choose one of explicit_pcg / fused_pcg")
    if explicit_pcg or fused_pcg:
        linsys = register_sharded_pcg(mesh, fused=fused_pcg)
        cfg = _plain_stages(cfg)
    X, U, lam, goals, xs = replicate(mesh, X, U, lam, goals, xs)
    return sqp_solve(model, cfg, X, U, lam, goals, xs, rho, pcg_exit_tol,
                     linsys)


def simulate_mpc_scan_sharded(model, cfg: SolverConfig, mesh: Mesh, xu_traj,
                              ee_traj, X, U, lam, rho, pcg_exit_tol,
                              n_updates: int, linsys: str = "pcg") -> dict:
    """The closed loop (sim.simulate_mpc_scan) with its CG sharded over
    the mesh: linsys "pcg" runs pcg_sharded, a name from
    register_sharded_pcg (``fused=True`` for K11) runs that backend, and
    any other name runs unsharded on the whole horizon.  The stages are
    the plain ones (cfg's fused_stages off), as in the JAX package; the
    loop's carry is replicated on every rank."""
    cfg = _plain_stages(cfg)
    if linsys == "pcg":
        linsys = register_sharded_pcg(mesh)
    xu_traj, ee_traj, X, U, lam = replicate(mesh, xu_traj, ee_traj, X, U,
                                            lam)
    return simulate_mpc_scan(model, cfg, xu_traj, ee_traj, X, U, lam, rho,
                             pcg_exit_tol, n_updates, linsys)


def _gather_groups(mesh: Mesh, outs: list) -> dict:
    """Per-group statistics dicts, every leaf with a leading arm axis, to
    one dict of the whole arm axis on the mesh's device (on every rank)."""
    return {k: mesh.gather([torch.as_tensor(o[k]).to(mesh.device)
                            for o in outs]) for k in outs[0]}


def simulate_mpc_scan_arms_sharded(model, cfg: SolverConfig, mesh: Mesh,
                                   xu_traj, ee_traj, Xb, Ub, lamb, rho,
                                   pcg_exit_tol, n_updates: int,
                                   linsys: str = "pcg") -> dict:
    """B independent arms (Xb (B, N, nx), Ub (B, N-1, nu), lamb (B, N,
    nx), from sim.arm_starts), B a multiple of the mesh's size: each group
    runs sim.simulate_mpc_scan per local arm, one after another (the JAX
    package's lax.map), and the statistics are gathered.  Returns the
    single-arm loop's dict with a leading arm axis on every leaf (B, ...),
    as the JAX package's shard_map over the batch axis does."""
    xu_traj, ee_traj = replicate(mesh, xu_traj, ee_traj)
    outs = []
    for Xl, Ul, ll in zip(*shard_horizon(mesh, Xb, Ub, lamb)):
        arms = [simulate_mpc_scan(model, cfg, xu_traj, ee_traj, X1, U1, l1,
                                  rho, pcg_exit_tol, n_updates, linsys)
                for X1, U1, l1 in zip(Xl, Ul, ll)]
        outs.append({k: torch.stack([torch.as_tensor(a[k]) for a in arms])
                     for k in arms[0]})
    return _gather_groups(mesh, outs)


# leaves of the packed loop that are one per group: broadcast over its arms
_PER_GROUP = ("pcg_iters_total", "shifted")


def simulate_mpc_scan_packed_arms_sharded(model, cfg: SolverConfig,
                                          mesh: Mesh, xu_traj, ee_traj, Xb,
                                          Ub, lamb, rho, pcg_exit_tol,
                                          n_updates: int) -> dict:
    """Fleet mode: each group runs one arm-packed closed loop
    (sim.simulate_mpc_scan_packed: K10 and the arm-batched K1 per update
    through the kernels with cfg.fused_stages) over its B / size arms of
    Xb, Ub, lamb (from sim.arm_starts: the caller draws the starts, where
    the JAX package draws them from per-device seeds).  Returns the
    packed loop's statistics with every leaf on a leading arm axis of B
    (the per-group shift schedule and CG totals broadcast over the
    group's arms)."""
    xu_traj, ee_traj = replicate(mesh, xu_traj, ee_traj)
    outs = []
    for Xl, Ul, ll in zip(*shard_horizon(mesh, Xb, Ub, lamb)):
        b = Xl.shape[0]
        out = simulate_mpc_scan_packed(model, cfg, xu_traj, ee_traj, Xl, Ul,
                                       ll, rho, pcg_exit_tol, n_updates)
        for k in _PER_GROUP:
            v = torch.as_tensor(out[k])
            out[k] = v.expand((b,) + v.shape)
        outs.append(out)
    return _gather_groups(mesh, outs)
