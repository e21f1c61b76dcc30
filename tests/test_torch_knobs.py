"""Port parity of the solver knobs: mpcgpu_tpu_torch's plain sqp_solve,
sqp_solve_timeboxed and the kernels' plain versions against the JAX
package's portable path (pallas_stages off) on the CPU, under joint-space
tracking, the Gauss-Newton Hessian, semi-implicit Euler and the angle wrap,
and in float64.

Inputs: fixture 0_0, N = 8, the states perturbed by 0.02 N(0, 1) from numpy
seed 0 (knot 0 kept), the recorded controls, cold duals, rho 1e-3, 3 SQP
iterations, CG cap 40 and exit tolerance 1e-5; the knob cases' goals and
moved joints as tests/torch_systems.knob_inputs makes them (the state rows
under joint tracking, with q_cost 2.0; joints 0 and 3 within 0.03 of
+-3.14159 under the wrap).  One JAX call per module and case, shared
through module caches: one sqp_solve per knob, and one linearization
(form_kkt, form_schur) and merit evaluation per knob for the kernels'
plain versions.

Tolerances (rtol and atol alike) on X, U and lam, per knob, at or above
the largest differences measured at these inputs on a CPU: joint
tracking 2.1e-6 (X parts by 1.5e-6), Gauss-Newton 7.7e-5 (1.7e-5),
semi-implicit Euler 2.4e-4 (4.3e-6), the angle wrap 6e-4 (X parts by
5.1e-4 at an entry near 0.77: where the wrap fires the defects jump by
about pi, the duals reach 15 and two of the three CGs stop at their cap,
and the same start without the wrap parts by 1.6e-3, so the wrap is not
what parts the two float32 solves); iterations, bails, accepts and CG
counts equal.  float64 at rtol 1e-9.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JaxCostConfig
from mpcgpu_tpu.config import PCGConfig as JaxPCGConfig
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.ops import merit as jmerit
from mpcgpu_tpu.ops.kkt import form_kkt as jax_form_kkt
from mpcgpu_tpu.ops.schur import form_schur as jax_form_schur
from mpcgpu_tpu.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv
from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import compute_dz_knots
from mpcgpu_tpu_torch.ops.cuda._lib import Knobs
from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import pcg_dz_reference
from mpcgpu_tpu_torch.sqp import sqp_solve, sqp_solve_timeboxed, staged_step
from tests.torch_systems import KNOB_CASES, knob_start, wrap_changes_defects

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, ITERS, CAP, EXIT_TOL, RHO = 8, 3, 40, 1e-5, 1e-3
DT, MU, QD_COST, R_COST = 0.015625, 10.0, 1e-4, 1e-4
SCHEDULE = dict(rho_factor=1.2, rho_min=1e-3, rho_max=10.0, rho_reset=1e-3)
KNOBS = ("joint", "gauss_newton", "semi_implicit", "angle_wrap")
TOL = {"joint": 2.1e-6, "gauss_newton": 7.7e-5, "semi_implicit": 2.4e-4,
       "angle_wrap": 6e-4}
T = torch.as_tensor


def _fixture():
    from pathlib import Path

    d = Path(__file__).resolve().parent / "fixtures"
    load = lambda f: np.loadtxt(d / f, delimiter=",").astype(np.float32)
    return load("0_0_traj.csv"), load("0_0_eepos.traj")


@functools.lru_cache(maxsize=None)
def _inputs(name=None):
    """(X, U, goals, xs) numpy float32 of a knob case (None: the
    defaults)."""
    return knob_start(*_fixture(), N, name, seed=0)


def _knob_fields(knobs: Knobs) -> tuple:
    """(CostConfig fields, SolverConfig fields) of the knobs."""
    return (dict(tracking=knobs.tracking, hessian=knobs.hessian,
                 q_cost=knobs.q_cost),
            dict(integrator_type=knobs.integrator_type,
                 angle_wrap=knobs.angle_wrap))


def _configs(knobs: Knobs, dtype="float32"):
    cost, top = _knob_fields(knobs)
    jcfg = JaxSolverConfig(
        knot_points=N, sqp_max_iter=ITERS, pcg=JaxPCGConfig(max_iter=CAP),
        cost=JaxCostConfig(qd_cost=QD_COST, r_cost=R_COST, **cost),
        dtype=dtype, **top)
    tcfg = SolverConfig(
        knot_points=N, sqp_max_iter=ITERS, pcg=PCGConfig(max_iter=CAP),
        cost=CostConfig(qd_cost=QD_COST, r_cost=R_COST, **cost),
        dtype=dtype, **top)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_solve(name):
    """The JAX portable sqp_solve of a knob case, as numpy."""
    from mpcgpu_tpu.models.robot import iiwa14 as jax_iiwa14

    X, U, goals, xs = _inputs(name)
    jcfg, _ = _configs(KNOB_CASES[name])
    r = jax_sqp_solve(jax_iiwa14(), jcfg, X, U, np.zeros((N, 14), np.float32),
                      goals, xs, RHO, EXIT_TOL)
    st = r.stats
    return dict(X=np.asarray(r.X), U=np.asarray(r.U), lam=np.asarray(r.lam),
                rho=float(r.rho), merit=float(st.final_merit),
                sqp_iters=int(st.sqp_iters), bailed=bool(st.rho_bailed),
                pcg_iters=np.asarray(st.pcg_iters).tolist(),
                accepted=np.asarray(st.accepted).tolist())


@functools.partial(jax.jit, static_argnames=("knobs",))
def _jax_systems(model, X, U, goals, xs, knobs):
    """The JAX form_kkt, then form_schur with and without the stair."""
    kkt = jax_form_kkt(model, X, U, goals, xs, DT, QD_COST, R_COST,
                       **knobs.kkt_kw())
    return kkt, [jax_form_schur(kkt, RHO, preconditioned=p)
                 for p in (False, True)]


@functools.lru_cache(maxsize=None)
def _jax_system(name, precond):
    """The JAX form_kkt + form_schur of a knob case at its start and rho
    1e-3, in the KnotSchur layout (torch)."""
    from mpcgpu_tpu.models.robot import iiwa14 as jax_iiwa14

    kkt, sds = _jax_systems(jax_iiwa14(), *_inputs(name), KNOB_CASES[name])
    sd = sds[precond]
    t = lambda a: T(np.asarray(a))
    pad = lambda a: torch.cat([t(a), torch.zeros_like(t(a)[:1])])
    return k3.KnotSchur(
        SL=t(sd.S.lower), SD=t(sd.S.diag), SU=t(sd.S.upper),
        PL=t(sd.Pinv.lower), PD=t(sd.Pinv.diag), PU=t(sd.Pinv.upper),
        gamma=t(sd.gamma), Qinv=t(sd.Qinv), Rinv=pad(sd.Rinv),
        A=pad(kkt.A), B=pad(kkt.B), q=t(kkt.q), r=pad(kkt.r))


@functools.partial(jax.jit, static_argnames=("knobs",))
def _jax_merit_fn(model, X, U, dX, dU, goals, xs, knobs):
    kw = knobs.merit_kw()
    a = (1.0 / 2 ** jnp.arange(8)).astype(jnp.float32)
    cand = jmerit.line_search_merits(model, X, U, dX, dU, a, goals, xs, DT,
                                     MU, QD_COST, R_COST, **kw)
    base = jmerit.merit(model, X, U, goals, xs, DT, MU, QD_COST, R_COST,
                        **kw)
    return jnp.append(cand, base)


def _jax_merits(name, X, U, dX, dU):
    """The JAX line_search_merits (8 step sizes) and merit of (X, U)."""
    from mpcgpu_tpu.models.robot import iiwa14 as jax_iiwa14

    _, _, goals, xs = _inputs(name)
    n = lambda v: np.asarray(v, np.float32)
    return np.asarray(_jax_merit_fn(jax_iiwa14(), n(X), n(U), n(dX), n(dU),
                                    goals, xs, KNOB_CASES[name]))


def _port_inputs(name):
    return tuple(T(a) for a in _inputs(name))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _check_solve(got, want, tol):
    """An SQPResult (or a MegaResult's fields) against _jax_solve's."""
    for f in ("X", "U", "lam"):
        _close(getattr(got, f), want[f], tol)
    st = got.stats
    assert int(st.sqp_iters) == want["sqp_iters"]
    assert bool(st.rho_bailed) == want["bailed"]
    assert st.pcg_iters.tolist() == want["pcg_iters"]
    assert st.accepted.tolist() == want["accepted"]


@pytest.mark.parametrize("name", KNOBS)
def test_sqp_solve_under_a_knob_matches_jax(name):
    """The plain sqp_solve under each knob alone against the JAX one; the
    angle-wrap case's start is one where the wrap changes the defects."""
    X, U, goals, xs = _port_inputs(name)
    model = iiwa14(device="cpu")
    if KNOB_CASES[name].angle_wrap:
        assert wrap_changes_defects(model, X, U, DT)
    _, cfg = _configs(KNOB_CASES[name])
    got = sqp_solve(model, cfg, X, U, torch.zeros(N, 14), goals, xs, RHO,
                    EXIT_TOL)
    _check_solve(got, _jax_solve(name), TOL[name])


def test_sqp_solve_in_float64_matches_jax():
    """cfg.dtype = "float64" (the reference's USE_DOUBLES), the JAX side
    under jax.enable_x64 (tests/test_parity_knobs.py:122-139): X, U and lam
    at rtol 1e-9 (atol 1e-12), the same decisions and CG counts."""
    from mpcgpu_tpu.models.robot import iiwa14 as jax_iiwa14

    X, U, goals, xs = (a.astype(np.float64) for a in _inputs())
    jcfg, cfg = _configs(Knobs(), dtype="float64")
    lam = np.zeros((N, 14))
    with jax.enable_x64(True):
        r = jax_sqp_solve(jax_iiwa14(dtype=jnp.float64), jcfg,
                          *(jnp.asarray(a, jnp.float64)
                            for a in (X, U, lam, goals, xs)),
                          jnp.asarray(RHO, jnp.float64),
                          jnp.asarray(EXIT_TOL, jnp.float64))
        want = dict(X=np.asarray(r.X), U=np.asarray(r.U),
                    lam=np.asarray(r.lam),
                    sqp_iters=int(r.stats.sqp_iters),
                    bailed=bool(r.stats.rho_bailed),
                    pcg_iters=np.asarray(r.stats.pcg_iters).tolist(),
                    accepted=np.asarray(r.stats.accepted).tolist())
    assert want["X"].dtype == np.float64
    got = sqp_solve(iiwa14(device="cpu", dtype=torch.float64), cfg,
                    *(T(a) for a in (X, U, lam, goals, xs)), RHO, EXIT_TOL)
    assert got.X.dtype == torch.float64
    for f in ("X", "U", "lam"):
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                   rtol=1e-9, atol=1e-12)
    st = got.stats
    assert int(st.sqp_iters) == want["sqp_iters"]
    assert bool(st.rho_bailed) == want["bailed"]
    assert st.pcg_iters.tolist() == want["pcg_iters"]
    assert st.accepted.tolist() == want["accepted"]


def test_timeboxed_solve_under_joint_tracking():
    """The time-boxed solve under joint tracking (the JAX package's
    regression, tests/test_parity_knobs.py:87-119: its sqp_iteration once
    dropped tracking): with a clock that never runs out it takes the JAX
    sqp_solve's iterations, at least one step is accepted, and the
    positions move toward the reference states."""
    X, U, goals, xs = _port_inputs("joint")
    _, cfg = _configs(KNOB_CASES["joint"])
    got = sqp_solve_timeboxed(iiwa14(device="cpu"), cfg, X, U,
                              torch.zeros(N, 14), goals, xs, RHO, EXIT_TOL,
                              max_time_us=1.0, _clock=lambda: 0.0)
    _check_solve(got, _jax_solve("joint"), TOL["joint"])
    assert bool(got.stats.accepted.any())
    d0 = float((X[1:, :7] - goals[1:, :7]).abs().mean())
    d1 = float((got.X[1:, :7] - goals[1:, :7]).abs().mean())
    assert d1 < d0, (d1, d0)


def _jax_staged_step(name, precond, solve):
    """One SQP iteration (sqp.sqp_step) whose linearization and merits are
    the JAX package's (form_kkt, form_schur, line_search_merits) and whose
    dual solve is `solve` (the plain K4's or K7's)."""
    def linearize_and_solve(Xc, Uc, lamc, rhoc):
        assert float(rhoc) == float(np.float32(RHO))
        lam, dX, dU, it, hit = solve(_jax_system(name, precond), lamc)
        return lam, it, hit, dX, dU

    def eval_merits(Xc, Uc, dX, dU):
        return T(_jax_merits(name, Xc, Uc, dX, dU)[:8])

    return staged_step(linearize_and_solve, eval_merits,
                       k2.alphas_for(8, torch.zeros(1)), **SCHEDULE)


def _backward_error(ks, lam) -> float:
    """||S lam - gamma|| / (||S||_F ||lam|| + ||gamma||) on a KnotSchur."""
    S = BlockTri(ks.SL, ks.SD, ks.SU)
    s_f = torch.sqrt(sum((b * b).sum() for b in S))
    r = spmv(S, lam) - ks.gamma
    return float(r.norm() / (s_f * lam.norm() + ks.gamma.norm()))


def _iter_check(got, want, tol):
    """One iteration: X, U, lam at the knob's tolerance, rho and drho at
    rtol 1e-6, the merit at rtol 1e-3 (the host K9p test's), the decisions
    and CG count equal."""
    for f in ("X", "U", "lam"):
        _close(getattr(got, f), getattr(want, f), tol)
    for f, rtol in (("rho", 1e-6), ("drho", 1e-6), ("merit", 1e-3)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), rtol=rtol)
    for f in ("accept", "bail", "pcg_iters", "hit_max"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("name", KNOBS)
@pytest.mark.parametrize("module", ["K3", "K2", "K5", "K9p", "K9b", "K10"])
def test_kernel_plain_version_under_a_knob_matches_jax(module, name):
    """Each kernel's plain version under each knob: K3's (form_kkt_schur_
    reference, with and without the stair) against the JAX form_kkt +
    form_schur at the start, each field's largest difference within 2e-3
    of its largest entry (Qinv's entries reach 1/rho and the Gauss-Newton
    Q_pos + rho I is near singular: its gamma parts by 8.8e-4, the other
    knobs' fields by at most 5.6e-6; a knob dropped parts a field by
    9.5e-3 or more); K2's
    against the JAX line_search_merits and merit at a seeded 0.05 step
    (rtol and atol 2e-4, tests/test_merit_pallas.py:30-31); one K9p
    iteration against the same iteration over the JAX linearization and
    merits with the plain K4's dual solve; one K9b iteration likewise
    with its own duals, which solve the JAX system to a normwise backward
    error below 1e-3 (exact float32 solves of these systems part by up to
    1e-2 of |lam|, as tests/torch_systems.py notes; the Gauss-Newton
    system parts from JAX's by 3.8e-4 in that measure, the others by 2e-8
    or less); K5's and K10's (one arm) whole solve against the JAX
    sqp_solve, at the knob's tolerance."""
    knobs = KNOB_CASES[name]
    model = iiwa14(device="cpu")
    X, U, goals, xs = _port_inputs(name)
    lam0, rho = torch.zeros(N, 14), torch.tensor(RHO)
    kw = dict(dt=DT, qd_cost=QD_COST, r_cost=R_COST, gravity=0.0, mu=MU,
              num_alphas=8, **SCHEDULE)
    zero_step = (torch.zeros_like(X), torch.zeros_like(U))
    merit0 = k2.line_search_merits_reference(model, X, U, *zero_step, 8,
                                             goals, xs, DT, MU, QD_COST,
                                             R_COST, knobs=knobs)[8]
    if module == "K3":
        for precond in (True, False):
            got = k3.form_kkt_schur_reference(model, X, U, goals, xs, RHO, DT,
                                              QD_COST, R_COST, 0.0, precond,
                                              knobs)
            want = _jax_system(name, precond)
            for f in k3.KnotSchur._fields:
                g, w = getattr(got, f), getattr(want, f)
                scale = max(float(w.abs().max()), 1e-30)
                assert float((g - w).abs().max()) <= 2e-3 * scale, f
    elif module == "K2":
        rng = np.random.default_rng(5)
        dX = T((0.05 * rng.normal(size=(N, 14))).astype(np.float32))
        dU = T((0.05 * rng.normal(size=(N - 1, 7))).astype(np.float32))
        got = k2.line_search_merits_reference(model, X, U, dX, dU, 8, goals,
                                              xs, DT, MU, QD_COST, R_COST,
                                              knobs=knobs)
        _close(got, _jax_merits(name, X, U, dX, dU), 2e-4)
    elif module in ("K9p", "K9b"):
        scal = (rho, torch.tensor(1.0), merit0)
        if module == "K9p":
            got = k5.sqp_iter_mega_pcg_reference(
                model, X, U, goals, xs, lam0, *scal, CAP, EXIT_TOL, **kw,
                knobs=knobs)
            step = _jax_staged_step(name, True, lambda ks, lam:
                                    pcg_dz_reference(ks, lam, CAP, EXIT_TOL))
        else:
            got = k5.sqp_iter_mega_reference(model, X, U, goals, xs, *scal,
                                             **kw, knobs=knobs)
            ks = _jax_system(name, False)
            assert _backward_error(ks, got.lam) < 1e-3
            given = (got.lam, *compute_dz_knots(ks, got.lam),
                     torch.zeros((), dtype=torch.int32),
                     torch.zeros((), dtype=torch.bool))
            step = _jax_staged_step(name, False, lambda ks, lam: given)
        _iter_check(got, step(X, U, lam0, *scal), TOL[name])
    elif module == "K5":
        r = k5.sqp_solve_mega_pcg_reference(
            model, X, U, goals, xs, lam0, rho, 1.0, merit0, CAP, EXIT_TOL,
            ITERS, **kw, knobs=knobs)
        want = _jax_solve(name)
        for f in ("X", "U", "lam"):
            _close(getattr(r, f), want[f], TOL[name])
        assert int(r.sqp_iters) == want["sqp_iters"]
        assert bool(r.bailed) == want["bailed"]
        assert r.pcg_iters.tolist() == want["pcg_iters"]
        assert r.accepted.tolist() == want["accepted"]
    else:
        r = k5.sqp_solve_mega_pcg_packed_reference(
            model, X[None], U[None], goals[None], xs[None], lam0[None], rho,
            1.0, CAP, EXIT_TOL, ITERS, **kw, knobs=knobs)
        want = _jax_solve(name)
        for f in ("X", "U", "lam"):
            _close(getattr(r, f)[0], want[f], TOL[name])
        assert r.sqp_iters.tolist() == [want["sqp_iters"]]
        assert r.bailed.tolist() == [want["bailed"]]
        assert int(r.pcg_iters_total) == sum(i for i in want["pcg_iters"]
                                             if i >= 0)
