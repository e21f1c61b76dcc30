"""Port parity of the slice end to end: mpcgpu_tpu_torch.sqp.sqp_solve and
sim.simulate_mpc_scan vs the JAX ones, on CPU at N = 8; and the port's
boundary: no import of JAX or mpcgpu_tpu, no file path into mpcgpu_tpu,
its own copy of the IIWA-14 tables, models built on the card by
default.

fused_stages=True on CPU tensors runs each kernel wrapper's plain
version, so both settings are checked against the JAX portable path.
Tolerances: X, U at atol 5e-3 (tests/test_merit_pallas.py:60-61); the
per-update tracking errors at atol 1e-3.
"""
import ast
import dataclasses
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.sim import _shift_horizon as jax_shift_horizon
from mpcgpu_tpu.sim import make_shift_schedule as jax_make_shift_schedule
from mpcgpu_tpu.sim import simulate_mpc_scan as jax_simulate_mpc_scan
from mpcgpu_tpu.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models.robot import FIELDS, iiwa14, robot_from_numpy
from mpcgpu_tpu_torch.sim import _shift_horizon, make_shift_schedule
from mpcgpu_tpu_torch.sim import simulate_mpc_scan
from mpcgpu_tpu_torch.sqp import sqp_solve

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 8
T = torch.as_tensor


def _start(traj_0_0, seed=1):
    xu, ee = traj_0_0
    X = xu[:N, :14].copy()
    rng = np.random.default_rng(seed)
    Xp = (X + 0.02 * rng.normal(size=X.shape)).astype(np.float32)
    Xp[0] = X[0]
    return Xp, xu[:N - 1, 14:].copy(), ee[:N].copy(), X[0].copy()


@pytest.mark.parametrize("fused", [False, True])
def test_sqp_solve_matches_jax(iiwa, traj_0_0, fused):
    X, U, goals, xs = _start(traj_0_0)
    lam = np.zeros((N, 14), np.float32)
    ref = jax_sqp_solve(iiwa, JaxSolverConfig.for_knots(N, sqp_max_iter=2),
                        X, U, lam, goals, xs, 1e-3, 1e-8)
    cfg = SolverConfig.for_knots(N, sqp_max_iter=2, fused_stages=fused)
    got = sqp_solve(iiwa14(device="cpu"), cfg, T(X), T(U), T(lam), T(goals),
                    T(xs), 1e-3, 1e-8)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), atol=5e-3)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), atol=5e-3)
    np.testing.assert_array_equal(got.stats.accepted.numpy(),
                                  np.asarray(ref.stats.accepted))
    assert int(got.stats.sqp_iters) == int(ref.stats.sqp_iters)


def test_rho_bail_freezes_the_state_as_jax_stops(iiwa, traj_0_0):
    """With rho_max = rho_min the first rejected step bails (seed 0
    rejects at iteration 4): the JAX while_loop stops there, and the
    port's masked iterations after it leave state and stats as they were."""
    X, U, goals, xs = _start(traj_0_0, seed=0)
    lam = np.zeros((N, 14), np.float32)
    ref = jax_sqp_solve(iiwa, JaxSolverConfig.for_knots(
        N, sqp_max_iter=6, rho_max=1e-3), X, U, lam, goals, xs, 1e-3, 1e-8)
    cfg = SolverConfig.for_knots(N, sqp_max_iter=6, rho_max=1e-3)
    got = sqp_solve(iiwa14(device="cpu"), cfg, T(X), T(U), T(lam), T(goals),
                    T(xs), 1e-3, 1e-8)
    assert bool(ref.stats.rho_bailed) and bool(got.stats.rho_bailed)
    n_run = int(ref.stats.sqp_iters)
    assert n_run < 6 and int(got.stats.sqp_iters) == n_run
    np.testing.assert_array_equal(got.stats.accepted.numpy(),
                                  np.asarray(ref.stats.accepted))
    its, ref_its = got.stats.pcg_iters.numpy(), np.asarray(ref.stats.pcg_iters)
    assert (its[n_run:] == -1).all() and (ref_its[n_run:] == -1).all()
    assert np.abs(its[:n_run] - ref_its[:n_run]).max() <= 2
    assert float(got.rho) == pytest.approx(float(ref.rho))
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), atol=5e-3)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               atol=5e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_simulate_mpc_scan_matches_jax(iiwa, traj_0_0, fused):
    xu, ee = traj_0_0
    X, U, _, _ = _start(traj_0_0, seed=4)
    lam = np.zeros((N, 14), np.float32)
    jcfg = JaxSolverConfig.for_knots(N, sqp_max_iter=2)
    jcfg = dataclasses.replace(jcfg, pcg=dataclasses.replace(jcfg.pcg,
                                                             max_iter=40))
    ref = jax_simulate_mpc_scan(iiwa, jcfg, jnp.asarray(xu), jnp.asarray(ee),
                                jnp.asarray(X), jnp.asarray(U),
                                jnp.asarray(lam), jnp.asarray(1e-3, jnp.float32),
                                5e-5, 4)
    cfg = SolverConfig.for_knots(N, sqp_max_iter=2, fused_stages=fused)
    cfg = dataclasses.replace(cfg, pcg=dataclasses.replace(cfg.pcg,
                                                           max_iter=40))
    got = simulate_mpc_scan(iiwa14(device="cpu"), cfg, T(xu), T(ee), T(X),
                            T(U), T(lam), 1e-3, 5e-5, 4)
    errs = got["tracking_errors"].numpy()
    assert errs.shape == (4,) and np.isfinite(errs).all()
    np.testing.assert_allclose(errs, np.asarray(ref["tracking_errors"]),
                               atol=1e-3)
    np.testing.assert_array_equal(got["shifted"].numpy(),
                                  np.asarray(ref["shifted"]))
    np.testing.assert_allclose(got["final_xs"].numpy(),
                               np.asarray(ref["final_xs"]), atol=5e-3)


@pytest.mark.parametrize("traj_offset", [1, 5, 240])
def test_shift_horizon_matches_jax(traj_0_0, traj_offset):
    xu, ee = traj_0_0
    rng = np.random.default_rng(6)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((N, 14), (N - 1, 7), (N, 6), (N, 14))]
    want = jax_shift_horizon(*arrs, xu, ee, traj_offset)
    got = _shift_horizon(*(T(a) for a in arrs), T(xu), T(ee), traj_offset)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_shift_schedule_matches_jax():
    do_shift, offsets = make_shift_schedule(SolverConfig.for_knots(64), 40)
    j_shift, j_off = jax_make_shift_schedule(JaxSolverConfig.for_knots(64), 40)
    np.testing.assert_array_equal(do_shift, np.asarray(j_shift))
    np.testing.assert_array_equal(offsets, np.asarray(j_off))


def test_fused_path_rejects_configs_the_kernels_do_not_serve(traj_0_0):
    X, U, goals, xs = _start(traj_0_0)
    cfg = SolverConfig.for_knots(N, sqp_max_iter=1, fused_stages=True,
                                 integrator_type=1)
    with pytest.raises(ValueError, match="integrator_type"):
        sqp_solve(iiwa14(device="cpu"), cfg, T(X), T(U), torch.zeros(N, 14),
                  T(goals), T(xs), 1e-3, 1e-8)


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device launches the kernel (CUDA) or raises -- never a fallback."""
    from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import pcg_dz

    meta = torch.empty((N, 14), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pcg_dz(None, meta, 10, 1e-5)


def _docstrings(tree):
    """ids of the docstring constants of a module, class or function."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                out.add(id(first.value))
    return out


def _jax_package_refs(tree):
    """Imports of jax / mpcgpu_tpu, and string constants (docstrings
    aside) that name a path into the JAX package: a path component
    "mpcgpu_tpu", alone (as in Path(...) / "mpcgpu_tpu" / ...) or
    followed by a module file."""
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs):
            parts = node.value.replace("\\", "/").split("/")
            if "mpcgpu_tpu" in parts:
                yield f"the path {node.value!r}"
            continue
        else:
            continue
        for name in names:
            if name.split(".")[0] in ("jax", "jaxlib", "mpcgpu_tpu"):
                yield f"an import of {name}"


def test_port_imports_no_jax():
    pkg = Path(__file__).resolve().parents[1] / "mpcgpu_tpu_torch"
    files = sorted(pkg.rglob("*.py"))
    assert files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        refs = list(_jax_package_refs(tree))
        assert not refs, f"{path.relative_to(pkg.parent)} has {refs}"


def test_jax_package_guard_catches_a_file_path_load():
    """The guard flags loading a JAX-package module by file path, the way
    the port once read the IIWA-14 tables."""
    src = ('from pathlib import Path\n'
           'p = Path(__file__).parents[2] / "mpcgpu_tpu" / "models" / "x.py"\n'
           'q = "mpcgpu_tpu/models/iiwa14_params.py"\n')
    assert len(list(_jax_package_refs(ast.parse(src)))) == 2


def test_iiwa14_tables_equal_the_jax_package_tables():
    from mpcgpu_tpu.models import iiwa14_params as jax_params
    from mpcgpu_tpu_torch.models import iiwa14_params

    assert iiwa14_params.NUM_JOINTS == jax_params.NUM_JOINTS
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(iiwa14_params, f),
                                      getattr(jax_params, f))


def test_models_are_built_on_the_card_unless_asked():
    for fn in (iiwa14, robot_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
