"""Port parity of the sharded paths (mpcgpu_tpu_torch/parallel) against the
JAX package's (mpcgpu_tpu/parallel) on the CPU, the JAX side on the
virtual 8-device CPU mesh of tests/conftest.py and its Pallas kernel in
interpret mode, at N <= 16:

* K11's plain version against JAX's _spmv_halo_pallas on each of 8 shards
  of a random N = 16 system, within 1e-5 of max|y|;
* pcg_sharded and pcg_sharded_cuda on the in-process 8-shard mesh against
  JAX's pcg_sharded and pcg_sharded_pallas (random_kkt, N = 16): the
  tolerances of tests/test_parallel.py:23-39 (rtol = atol = 5e-3 against
  the dense solve, no hit), iterations within 3;
* sharded_sqp_solve in its three modes against JAX's (fixture 0_0,
  N = 16, 2 SQP iterations; X, U at rtol 2e-4, atol 2e-5);
* simulate_mpc_scan_sharded, with pcg_sharded and with K11's CG, against
  JAX's (N = 16, 3 updates; tests/test_parallel.py:311-316: the final
  state at rtol 2e-4, atol 2e-5, the tracking errors at rtol 2e-3,
  atol 2e-4);
* simulate_mpc_scan_arms_sharded over 8 groups against JAX's
  simulate_mpc_scan_batched (N = 8, B = 8, 2 updates) with the tolerances
  of the JAX package's own arms test (rtol 1e-5, atol 1e-6);
* simulate_mpc_scan_packed_arms_sharded against the unsharded packed loop
  per group (the same code: bit-equal);
* the torch.distributed form, 2 and 4 gloo ranks on the CPU
  (tests/torch_ranks.py), bit-equal to the in-process mesh of as many
  shards.

The dots sum in another order than JAX's psum, so the port is held to
JAX by tolerance and its two mesh forms to each other bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import PCGConfig as JaxPCGConfig
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.ops import btridiag as jax_btridiag
from mpcgpu_tpu.ops.pcg import pcg as jax_pcg
from mpcgpu_tpu.ops.schur import form_schur as jax_form_schur
from mpcgpu_tpu.parallel import sharded as jax_sharded
from mpcgpu_tpu.parallel.pcg_sharded import pcg_sharded as jax_pcg_sharded
from mpcgpu_tpu.parallel.pcg_sharded_pallas import (
    _spmv_halo_pallas, pcg_sharded_pallas as jax_pcg_sharded_pallas)
from mpcgpu_tpu.sim import (
    simulate_mpc_scan_batched as jax_simulate_mpc_scan_batched)
from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.btridiag import BlockTri
from mpcgpu_tpu_torch.ops.cuda.spmv_halo_kernel import spmv_halo_reference
from mpcgpu_tpu_torch.parallel.mesh import Mesh
from mpcgpu_tpu_torch.parallel.pcg_sharded import pcg_sharded
from mpcgpu_tpu_torch.parallel.pcg_sharded_cuda import pcg_sharded_cuda
from mpcgpu_tpu_torch.parallel.sharded import (
    arms_mesh, horizon_mesh, register_sharded_pcg, sharded_sqp_solve,
    simulate_mpc_scan_arms_sharded, simulate_mpc_scan_packed_arms_sharded,
    simulate_mpc_scan_sharded)
from mpcgpu_tpu_torch.sim import arm_starts, simulate_mpc_scan_packed
from tests.test_schur_pcg import NX, RHO, random_kkt
from tests.torch_ranks import run_ranks
from tests.torch_systems import random_system

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.as_tensor
N_SHARD, SHARDS = 16, 8


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == SHARDS
    return jax_sharded.horizon_mesh()


def _mesh():
    return horizon_mesh(SHARDS, device="cpu")


@pytest.mark.parametrize("shard", range(SHARDS))
def test_k11_plain_matches_jax_spmv_halo_pallas(shard):
    """One shard of a random N = 16 system over 8 shards: its rows of the
    product, the halos the neighbours' edge rows (zero at the ends)."""
    rng = np.random.default_rng(5)
    f = np.float32
    L, D, U = (rng.normal(size=(N_SHARD, NX, NX)).astype(f) for _ in range(3))
    x = rng.normal(size=(N_SHARD, NX)).astype(f)
    nl = N_SHARD // SHARDS
    rows = slice(shard * nl, (shard + 1) * nl)
    zero = np.zeros(NX, f)
    xl = x[shard * nl - 1] if shard > 0 else zero
    xr = x[(shard + 1) * nl] if shard < SHARDS - 1 else zero
    y = spmv_halo_reference(T(L[rows]), T(D[rows]), T(U[rows]), T(x[rows]),
                            T(xl), T(xr)).numpy()
    lane = lambda b: jnp.asarray(np.transpose(b[rows], (2, 1, 0)))
    y_jax = np.asarray(_spmv_halo_pallas(
        lane(L), lane(D), lane(U), jnp.asarray(x[rows].T),
        jnp.asarray(xl[:, None]), jnp.asarray(xr[:, None]), True)).T
    assert np.abs(y - y_jax).max() <= 1e-5 * np.abs(y_jax).max()


@pytest.fixture(scope="module")
def schur16():
    """The JAX parallel tests' system (random_kkt seed 21, N = 16)."""
    return jax_form_schur(random_kkt(seed=21, n=N_SHARD), RHO)


@pytest.mark.parametrize("cap,tol", [(400, 1e-10), (10, 1e-10)])
@pytest.mark.parametrize("port_fn,jax_name", [
    (pcg_sharded, "pcg_sharded"), (pcg_sharded_cuda, "pcg_sharded_pallas")])
def test_sharded_pcg_matches_jax(jax_mesh, schur16, port_fn, jax_name, cap,
                                 tol):
    jax_fn = {"pcg_sharded": jax_pcg_sharded,
              "pcg_sharded_pallas": jax_pcg_sharded_pallas}[jax_name]
    sd = schur16
    lam0 = np.zeros((N_SHARD, NX), np.float32)
    ref = jax_fn(jax_mesh, sd.S, sd.Pinv, sd.gamma, jnp.asarray(lam0), cap,
                 tol)
    tb = lambda b: BlockTri(*(T(np.array(t)) for t in b))
    lam, iters, hit = port_fn(_mesh(), tb(sd.S), tb(sd.Pinv),
                              T(np.array(sd.gamma)), T(lam0), cap, tol)
    assert abs(int(iters) - int(ref[1])) <= 3, (int(iters), int(ref[1]))
    assert bool(hit) == bool(ref[2])
    np.testing.assert_allclose(lam.numpy(), np.asarray(ref[0]), rtol=5e-3,
                               atol=5e-3)
    if cap == 400:
        dense = np.asarray(jax_btridiag.to_dense(sd.S), np.float64)
        x_ref = np.linalg.solve(dense,
                                np.asarray(sd.gamma, np.float64).reshape(-1))
        np.testing.assert_allclose(lam.numpy().reshape(-1), x_ref,
                                   rtol=5e-3, atol=5e-3)
        single = jax_pcg(sd.S, sd.Pinv, sd.gamma, lam0, max_iter=400,
                         exit_tol=1e-10)
        assert not bool(hit)
        assert abs(int(iters) - int(single.iters)) <= 3


def _sqp_inputs(traj_0_0, n=N_SHARD):
    xu, ee = traj_0_0
    X, U, goals = xu[:n, :14], xu[:n - 1, 14:], ee[:n]
    return X, U, np.zeros((n, 14), np.float32), goals, X[0]


MODES = {"whole": {}, "explicit": dict(explicit_pcg=True),
         "fused": dict(fused_pcg=True)}


@pytest.fixture(scope="module")
def jax_sqp(jax_mesh, iiwa, traj_0_0):
    """JAX's sharded_sqp_solve per mode, each run once."""
    cfg = JaxSolverConfig.for_knots(N_SHARD, sqp_max_iter=2)
    args = tuple(jnp.asarray(a) for a in _sqp_inputs(traj_0_0))
    return {mode: jax_sharded.sharded_sqp_solve(
        iiwa, cfg, jax_mesh, *args, jnp.float32(1e-3), jnp.float32(1e-6),
        **kw) for mode, kw in MODES.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_sqp_solve_matches_jax(jax_sqp, traj_0_0, mode):
    cfg = SolverConfig.for_knots(N_SHARD, sqp_max_iter=2)
    got = sharded_sqp_solve(iiwa14(device="cpu"), cfg, _mesh(),
                            *(T(a) for a in _sqp_inputs(traj_0_0)), 1e-3,
                            1e-6, **MODES[mode])
    ref = jax_sqp[mode]
    assert np.isfinite(got.X.numpy()).all()
    for f in ("X", "U"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=2e-4,
                                   atol=2e-5)
    assert int(got.stats.sqp_iters) == int(ref.stats.sqp_iters)


def test_sharded_modes_reach_their_backends(traj_0_0, monkeypatch):
    """explicit_pcg runs pcg_sharded (the plain per-shard SpMV), fused_pcg
    K11's CG, each on the mesh's 8 shards; with neither, no sharded CG
    runs.  Counts the sharded SpMVs of one SQP iteration."""
    from mpcgpu_tpu_torch.ops.cuda.spmv_halo_kernel import spmv_halo
    from mpcgpu_tpu_torch.parallel import pcg_sharded as mod

    calls = []
    real = mod._spmv_local

    def counting(mesh, bands, xs, spmv=None):
        calls.append((len(xs), spmv))
        return real(mesh, bands, xs, spmv)

    monkeypatch.setattr(mod, "_spmv_local", counting)
    cfg = SolverConfig.for_knots(N_SHARD, sqp_max_iter=1,
                                 pcg=PCGConfig(max_iter=3))
    inputs = tuple(T(a) for a in _sqp_inputs(traj_0_0))
    for mode, spmv in (("explicit", None), ("fused", spmv_halo),
                       ("whole", None)):
        calls.clear()
        sharded_sqp_solve(iiwa14(device="cpu"), cfg, _mesh(), *inputs, 1e-3,
                          1e-12, **MODES[mode])
        if mode == "whole":
            assert not calls
            continue
        # S lam0 and P r0, then S p and P r per CG step
        assert calls == [(SHARDS, spmv)] * (2 + 2 * 3)


def _loop_cfg(n, jax=False):
    cls, pcg_cls = ((JaxSolverConfig, JaxPCGConfig) if jax
                    else (SolverConfig, PCGConfig))
    return dataclasses.replace(cls.for_knots(n, sqp_max_iter=2),
                               pcg=pcg_cls(max_iter=10))


@pytest.fixture(scope="module")
def jax_loop(jax_mesh, iiwa, traj_0_0):
    xu, ee = traj_0_0
    n = N_SHARD
    return jax_sharded.simulate_mpc_scan_sharded(
        iiwa, _loop_cfg(n, jax=True), jax_mesh, jnp.asarray(xu),
        jnp.asarray(ee), jnp.asarray(xu[:n, :14]),
        jnp.asarray(xu[:n - 1, 14:]), jnp.zeros((n, 14), jnp.float32),
        jnp.float32(1e-3), 1e-5, 3)


@pytest.mark.parametrize("fused", [False, True])
def test_knot_sharded_closed_loop_matches_jax(jax_loop, traj_0_0, fused):
    xu, ee = traj_0_0
    n, mesh = N_SHARD, _mesh()
    linsys = register_sharded_pcg(mesh, fused=True) if fused else "pcg"
    out = simulate_mpc_scan_sharded(
        iiwa14(device="cpu"), _loop_cfg(n), mesh, T(xu), T(ee),
        T(xu[:n, :14]), T(xu[:n - 1, 14:]), torch.zeros(n, 14), 1e-3, 1e-5,
        3, linsys)
    np.testing.assert_allclose(out["final_xs"].numpy(),
                               np.asarray(jax_loop["final_xs"]), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(out["tracking_errors"].numpy(),
                               np.asarray(jax_loop["tracking_errors"]),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(out["sqp_iters"].numpy(),
                                  np.asarray(jax_loop["sqp_iters"]))


def test_arms_sharded_matches_jax_batched(iiwa, traj_0_0):
    """8 arms over 8 in-process groups against JAX's batched loop, the
    arms' starts from JAX's own draw (PRNGKey(0))."""
    xu, ee = traj_0_0
    n, b, n_updates = 8, 8, 2
    X, U = xu[:n, :14], xu[:n - 1, 14:]
    ref = jax_simulate_mpc_scan_batched(
        iiwa, _loop_cfg(n, jax=True), jnp.asarray(xu), jnp.asarray(ee),
        jnp.asarray(X), jnp.asarray(U), jnp.zeros((n, 14), jnp.float32),
        jnp.float32(1e-3), 1e-5, n_updates, "pcg", batch=b)
    dq = np.asarray(0.02 * jax.random.normal(jax.random.PRNGKey(0), (b, 7),
                                             jnp.float32))
    Xb, Ub, lamb = arm_starts(T(X), T(U), torch.zeros(n, 14), T(dq))
    out = simulate_mpc_scan_arms_sharded(
        iiwa14(device="cpu"), _loop_cfg(n), arms_mesh(b, device="cpu"),
        T(xu), T(ee), Xb, Ub, lamb, 1e-3, 1e-5, n_updates)
    assert tuple(out["tracking_errors"].shape) == (b, n_updates)
    assert tuple(out["tracking_path"].shape) == (b, n_updates, 14)
    for k in ("tracking_errors", "final_xs"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["sqp_iters"].numpy(),
                                  np.asarray(ref["sqp_iters"]))


def test_packed_arms_sharded_equals_the_unsharded_packed_groups(traj_0_0):
    """2 groups of 2 packed arms (K10's and K1's plain versions on the CPU)
    against simulate_mpc_scan_packed on each group's starts."""
    xu, ee = traj_0_0
    n, groups, b, n_updates = 4, 2, 2, 2
    cfg = dataclasses.replace(SolverConfig.for_knots(n, sqp_max_iter=1),
                              fused_stages=True, pcg=PCGConfig(max_iter=4))
    dq = T(0.02 * np.random.default_rng(3).normal(size=(groups * b, 7)),
           dtype=torch.float32)
    Xb, Ub, lamb = arm_starts(T(xu[:n, :14]), T(xu[:n - 1, 14:]),
                              torch.zeros(n, 14), dq)
    model = iiwa14(device="cpu")
    out = simulate_mpc_scan_packed_arms_sharded(
        model, cfg, arms_mesh(groups, device="cpu"), T(xu), T(ee), Xb, Ub,
        lamb, 1e-3, 1e-9, n_updates)
    assert tuple(out["pcg_iters_total"].shape) == (groups * b, n_updates)
    for g in range(groups):
        arms = slice(g * b, (g + 1) * b)
        ref = simulate_mpc_scan_packed(model, cfg, T(xu), T(ee),
                                       Xb[arms].contiguous(),
                                       Ub[arms].contiguous(),
                                       lamb[arms].contiguous(), 1e-3, 1e-9,
                                       n_updates)
        for k, v in ref.items():
            got = out[k][arms]
            assert torch.equal(got, torch.as_tensor(v).expand_as(got)), k


def test_mesh_collectives_in_process():
    """halos: the neighbours' edge rows, zero at the global edges; psum:
    one sum of the shards' partials; shard and gather invert each other."""
    mesh = Mesh.in_process(4, "cpu", "knots")
    x = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    xs = mesh.shard(x)
    left, right = mesh.halos(xs)
    assert torch.equal(left[0], torch.zeros(3))
    assert torch.equal(right[3], torch.zeros(3))
    for i in range(1, 4):
        assert torch.equal(left[i], x[2 * i - 1])
        assert torch.equal(right[i - 1], x[2 * i])
    assert float(mesh.psum([t.sum() for t in xs])) == float(x.sum())
    assert torch.equal(mesh.gather(xs), x)
    with pytest.raises(ValueError):
        mesh.shard(torch.zeros(6, 3))


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_equal_the_in_process_mesh(traj_0_0, tmp_path, world):
    """world gloo ranks on the CPU, one shard each, against an in-process
    mesh of world shards: the two sharded CGs (N = 16, seeded random
    system with the stair) and sharded_sqp_solve(fused_pcg=True)
    (fixture 0_0, N = 16) give the same bits on every rank."""
    ks = random_system(N_SHARD, seed=11, precond=True)
    X, U, lam, goals, xs = (T(a) for a in _sqp_inputs(traj_0_0))
    case = {"device": "cpu",
            "pcg": {"S": tuple(T(ks[f]) for f in ("SL", "SD", "SU")),
                    "P": tuple(T(ks[f]) for f in ("PL", "PD", "PU")),
                    "gamma": T(ks["gamma"]),
                    "lam0": torch.zeros(N_SHARD, NX), "max_iter": 400,
                    "tol": 1e-10},
            "sqp": {"X": X, "U": U, "lam": lam, "goals": goals, "xs": xs,
                    "rho": 1e-3, "tol": 1e-6, "sqp_max_iter": 2, "cap": 40}}
    outs = run_ranks(case, world, tmp_path, timeout=300)
    for rank, out in enumerate(outs):
        for key in ("pcg_sharded", "pcg_sharded_cuda", "sqp_fused"):
            a, b = out[key]["ranks"], out[key]["in_process"]
            pairs = (zip(a, b) if isinstance(a, tuple)
                     else ((a[f], b[f]) for f in a))
            for x, y in pairs:
                assert torch.equal(x, y), (rank, key)
            first = outs[0][key]["ranks"]
            same = (zip(a, first) if isinstance(a, tuple)
                    else ((a[f], first[f]) for f in a))
            assert all(torch.equal(x, y) for x, y in same), (rank, key)
        assert int(out["pcg_sharded"]["ranks"][1]) < 400
