"""Port parity of the real-time host loop and what hangs off it, against
the JAX package on the CPU at N = 8: utils/stats, utils/results, the
forward-kinematics path of load_fixture_pair (all 21 fixture pairs),
sim.simulate_mpc (constant period with the dual residual, real time
under a fake clock, the forced auto failover; the warm-up's calls) and
the port's flagship driver.  The host-driven SQP modes are in
tests/test_torch_sqp_modes.py.

One JAX simulate_mpc call per mode, all on one configuration (one
compile), shared through module-scoped fixtures; the port's run of the
constant-period mode is the driver's.  Tolerances
(tests/test_torch_closed_loop.py): per-update tracking errors at atol
1e-3; X, U and the tracking path at atol 5e-3; sqp_iters, rho bails and
failed_over equal.
"""
import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import mpcgpu_tpu.sim as jax_sim
import mpcgpu_tpu_torch.sim as sim
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.sim import MPCRecord as JaxMPCRecord
from mpcgpu_tpu.utils import results as jax_results
from mpcgpu_tpu.utils import stats as jax_stats
from mpcgpu_tpu.utils.trajfiles import load_fixture_pair as jax_load_pair
from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.sim import MPCRecord
from mpcgpu_tpu_torch.utils import results, stats
from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 8
TOL = 5e-5
T = torch.as_tensor
REPO = Path(__file__).resolve().parents[1]
PAIRS = [(s, g) for g in range(5) for s in range(5) if not (s == g and s)]
# the fake clock's solve times (us), cycled: each side of the rollout's
# 2.2 ms window (11 substeps of 0.2 ms at the 2 ms period)
SOLVE_US = (1500.0, 3100.0, 2600.0, 900.0, 4000.0)


class FakeTime:
    """Stands in for the time module of both sim modules: each update
    reads perf_counter twice around its solve, and the second read is
    the first plus the next of SOLVE_US."""

    def __init__(self):
        self.t, self.reads = 0.0, 0

    def perf_counter(self):
        if self.reads % 2:
            self.t += SOLVE_US[(self.reads // 2) % len(SOLVE_US)] * 1e-6
        self.reads += 1
        return self.t




def _cfgs():
    """(JAX config, port config) at N = 8 with the same fields."""
    return (JaxSolverConfig.for_knots(N, **CFG_KW),
            SolverConfig.for_knots(N, **CFG_KW))


# One configuration for every mode, so the JAX solves of all three share
# one compile: both failover thresholds at -1, which only "auto" reads
# (its latch trips after update 0, tests/test_auto_failover.py:159)
CFG_KW = dict(sqp_max_iter=2, failover_bail_rate=-1.0,
              failover_err_threshold_m=-1.0)
MODES = {
    # constant period, the dual residual recorded: the driver test's run
    "constant": dict(max_timesteps=2, warmup_iters=0,
                     record_dual_residual=True),
    "real_time": dict(max_timesteps=3, warmup_iters=0,
                      const_update_freq=False),
    "auto": dict(max_timesteps=2, warmup_iters=0, max_control_updates=5,
                 linsys="auto"),
}


def _spy_updates(mp, module):
    """Record (X, U) after every update of module's simulate_mpc."""
    seen = []
    inner = module._mpc_update

    def spy(*args, **kw):
        out = inner(*args, **kw)
        seen.append((np.asarray(out[1]), np.asarray(out[2])))
        return out

    mp.setattr(module, "_mpc_update", spy)
    return seen


@pytest.fixture(scope="module")
def jax_runs(iiwa, traj_0_0):
    """{mode: (JAX MPCRecord, [(X, U) per update])}, one JAX call each."""
    xu, ee = traj_0_0
    out = {}
    for mode, m in MODES.items():
        with pytest.MonkeyPatch.context() as mp:
            seen = _spy_updates(mp, jax_sim)
            if mode == "real_time":
                mp.setattr(jax_sim, "time", FakeTime())
            out[mode] = (jax_sim.simulate_mpc(iiwa, _cfgs()[0], xu, ee,
                                              pcg_exit_tol=TOL, **m), seen)
    return out


@pytest.fixture(scope="module")
def driver_run(tmp_path_factory):
    """The port driver's main with --cpu, the "constant" mode's run (pcg,
    no warm-up, 2 timesteps), its simulate_mpc also recording the dual
    residual as that mode does: (MPCRecord, [(X, U) per update], the
    printed output, the output directory)."""
    out_dir = tmp_path_factory.mktemp("port")
    recs = []
    with pytest.MonkeyPatch.context() as mp:
        seen = _spy_updates(mp, sim)
        inner = sim.simulate_mpc

        def run(*args, **kw):
            recs.append(inner(*args, record_dual_residual=True, **kw))
            return recs[-1]

        mp.setattr(sim, "simulate_mpc", run)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            _driver().main(["--cpu", "--knots", str(N), "--max-timesteps",
                            "2", "--sqp-max-iter", "2", "--warmup-iters",
                            "0", "--tols", str(TOL), "--output-dir",
                            str(out_dir)])
    assert len(recs) == 1
    return recs[0], seen, printed.getvalue(), out_dir


@pytest.mark.parametrize("mode", list(MODES))
def test_simulate_mpc_matches_jax(traj_0_0, jax_runs, driver_run,
                                  monkeypatch, mode):
    """The host loop in each mode against the JAX loop ("constant": the
    port driver's run, driver_run).  The real-time
    mode's plant runs for each fake solve time (1.5-4.0 ms: below and
    past the 2.2 ms the rollout integrates, plus its remainder) and
    shifts on that clock.  The dual residual, a backward error of about
    1e-5 to 1e-3 formed from iterates that agree to ~1e-4, is held at
    rtol 0.05: the port's and JAX's float32 iterates part in the last
    digits, and S lam nearly cancels gamma in the residual's numerator,
    which multiplies those parts by the ratio |gamma| / |r|."""
    xu, ee = traj_0_0
    want, want_xu = jax_runs[mode]
    if mode == "constant":      # the port driver's run of this mode
        got, seen = driver_run[:2]
    else:
        seen = _spy_updates(monkeypatch, sim)
        if mode == "real_time":
            monkeypatch.setattr(sim, "time", FakeTime())
        got = sim.simulate_mpc(iiwa14(device="cpu"), _cfgs()[1], xu, ee,
                               pcg_exit_tol=TOL, **MODES[mode])

    assert got.control_updates == want.control_updates >= 5
    assert got.timesteps == want.timesteps
    assert got.sqp_iters == want.sqp_iters
    assert got.sqp_exits == want.sqp_exits
    assert got.failed_over == want.failed_over
    assert len(got.pcg_iters) == len(want.pcg_iters)
    np.testing.assert_allclose(got.tracking_errors, want.tracking_errors,
                               atol=1e-3)
    np.testing.assert_allclose(got.final_tracking_error,
                               want.final_tracking_error, atol=1e-3)
    np.testing.assert_allclose(np.stack(got.tracking_path),
                               np.stack(want.tracking_path), atol=5e-3)
    assert len(seen) == len(want_xu)
    for (X, U), (wX, wU) in zip(seen, want_xu):
        np.testing.assert_allclose(X, wX, atol=5e-3)
        np.testing.assert_allclose(U, wU, atol=5e-3)
    if mode == "real_time":
        assert got.sqp_times_us == want.sqp_times_us
        assert max(got.sqp_times_us) > 2200.0 > min(got.sqp_times_us)
    if mode == "auto":
        assert got.failed_over == [False] + [True] * (got.control_updates - 1)
    if mode == "constant":
        assert len(got.dual_residuals) == got.control_updates
        np.testing.assert_allclose(got.dual_residuals, want.dual_residuals,
                                   rtol=0.05)
    assert got.summary().keys() == want.summary().keys()


def test_stats_and_results_equal_jax(tmp_path, capsys):
    """describe, stats_csv_row, print_stats' lines, dump_matrix and the
    .result files of dump_tracking_data, byte for byte on the same
    values; MPCRecord.summary() equal."""
    rng = np.random.default_rng(3)
    vals = list(rng.normal(size=37))
    col = np.asarray(vals, np.float32)[:, None]
    assert stats.describe(vals) == jax_stats.describe(vals)
    assert stats.describe([]).keys() == jax_stats.describe([]).keys()
    assert stats.stats_csv_row(vals) == jax_stats.stats_csv_row(vals)
    assert stats.print_stats(vals, "x") == jax_stats.print_stats(vals, "x")
    printed = capsys.readouterr().out.splitlines()
    assert printed[:len(printed) // 2] == printed[len(printed) // 2:]
    stats.dump_matrix(tmp_path / "a.txt", T(col))
    jax_stats.dump_matrix(tmp_path / "b.txt", col)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()

    fields = dict(
        tracking_errors=[0.1, 0.25], sqp_iters=[2, 1, 2],
        tracking_path=[np.arange(14, dtype=np.float32) * 0.5] * 3,
        sqp_times_us=[1234.5, 2.0, 3e3], sqp_exits=[False, True, False],
        pcg_iters=[4, 5, 6], pcg_exits=[True, False, True],
        kkt_times_us=[1.0], schur_times_us=[2.0], linsys_times_us=[3.0],
        dz_times_us=[4.0], line_search_times_us=[5.0],
        dual_residuals=[1e-4, 2e-4], final_tracking_error=0.3,
        control_updates=3, timesteps=2)
    rec, jrec = MPCRecord(**fields), JaxMPCRecord(**fields)
    assert rec.summary() == jrec.summary()
    results.dump_tracking_data(rec, "p", 0, tmp_path / "port")
    jax_results.dump_tracking_data(jrec, "p", 0, tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 13
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


@pytest.fixture(scope="module")
def jax_traces(iiwa, fixtures_dir):
    """{pair: (xu, ee)} from the JAX loader's forward kinematics, the
    loader's own jitted map run once over every pair's rows (one compile
    where a call a pair compiles a shape each); pair 1_0 by the JAX
    loader itself, which the one call must equal bit for bit."""
    import jax

    from mpcgpu_tpu.models import dynamics as jax_dyn
    from mpcgpu_tpu.utils.trajfiles import load_traj

    xus = [load_traj(fixtures_dir / f"{s}_{g}_traj.csv") for s, g in PAIRS]
    fk = jax.jit(jax.vmap(lambda q: jax_dyn.ee_pos(iiwa, q)))
    ee = np.asarray(fk(np.concatenate([xu[:, :7] for xu in xus])),
                    np.float32)
    cuts = np.cumsum([len(xu) for xu in xus])[:-1]
    out = dict(zip(PAIRS, zip(xus, np.split(ee, cuts))))
    out[0, 0] = jax_load_pair(fixtures_dir, 0, 0)
    jxu, jee = jax_load_pair(fixtures_dir, 1, 0, model=iiwa)
    np.testing.assert_array_equal(out[1, 0][0], jxu)
    np.testing.assert_array_equal(out[1, 0][1], np.asarray(jee))
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{s}_{g}" for s, g in PAIRS])
def test_load_fixture_pair_matches_jax(fixtures_dir, jax_traces, pair):
    """The end-effector trace by forward kinematics (every pair but 0_0,
    whose recorded trace both read) against the JAX loader's, atol
    1e-5."""
    xu, ee = load_fixture_pair(fixtures_dir, *pair, model=iiwa14(device="cpu"))
    jxu, jee = jax_traces[pair]
    np.testing.assert_array_equal(xu, jxu)
    assert ee.dtype == np.float32 and ee.shape == (len(xu), 6)
    np.testing.assert_allclose(ee, jee, rtol=0, atol=1e-5)


def test_load_fixture_pair_without_a_model(fixtures_dir):
    xu, ee = load_fixture_pair(fixtures_dir)
    assert xu.shape[1] == 21 and ee.shape == (len(xu), 6)
    with pytest.raises(FileNotFoundError, match="forward kinematics"):
        load_fixture_pair(fixtures_dir, 1, 0)


def _driver():
    spec = importlib.util.spec_from_file_location(
        "track_iiwa_pcg_torch", REPO / "examples" / "track_iiwa_pcg_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numbers(path):
    return [float(x) for line in path.read_text().splitlines()
            for x in line.rstrip(",").split(",") if x]


def test_driver_cpu_results_match_jax_record(jax_runs, driver_run,
                                            tmp_path):
    """The port driver's main with --cpu (driver_run): each .result file
    against dump_tracking_data of the JAX record of that run -- the same
    files; counts, exits and stats equal, CG counts within 2, tracking
    errors at atol 1e-3, the path at atol 5e-3, one solve time per
    update."""
    want, _ = jax_runs["constant"]
    _, _, out, port = driver_run
    assert "Route: plain stages on cpu" in out
    assert "Average final tracking err" in out
    prefix = f"{N}_PCG_{TOL}"
    jax_results.dump_tracking_data(want, prefix, 0, tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in port.iterdir()
                           if p.suffix == ".result")
    assert (port / f"{prefix}_overall_stats.csv").exists()
    for name in names:
        kind = name[len(prefix) + 3:-len(".result")]
        if kind == "stats":
            assert ((port / name).read_text()
                    == (tmp_path / "jax" / name).read_text())
            continue
        got, ref = _numbers(port / name), _numbers(tmp_path / "jax" / name)
        assert len(got) == len(ref), name
        if kind in ("sqp_iters", "sqp_exits", "pcg_exits"):
            assert got == ref, name
        elif kind == "pcg_iters":
            assert np.abs(np.subtract(got, ref)).max() <= 2
        elif kind == "tracking_errors":
            np.testing.assert_allclose(got, ref, atol=1e-3)
        elif kind == "tracking_path":
            np.testing.assert_allclose(got, ref, atol=5e-3)
        else:
            assert kind == "sqp_times" and min(got) > 0


def test_drivers_refuse_to_run_without_a_card_or_cpu(monkeypatch):
    """Without a card and without --cpu the driver raises, and the qdldl
    driver passes its backend and tolerance slot on."""
    mod = _driver()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        mod.main(["--knots", str(N)])
    args = mod.parse_args(["--cpu"])
    assert (args.knots, args.sqp_max_iter, args.warmup_iters,
            args.linsys) == (32, 40, 100, "pcg")


@pytest.mark.parametrize("linsys,hessian,want", [
    ("pcg", "reference", "pcg: K2, K5"),
    ("auto", "reference", "bcr_pcg: K3, K6, K2"),
    ("bcr", "reference", "bcr: K2, K9b"),
    ("pcg_pallas", "reference", "pcg_pallas: K3, K4, K2"),
    ("qdldl", "reference", "no kernel serves 'qdldl'"),
    ("pcg", "gauss_newton", "pcg: K2, K5")])
def test_driver_route_on_the_card(linsys, hessian, want):
    """The driver's configuration on a CUDA device (no launch): the
    kernels' route, the plain stages for dense and qdldl, and the
    Gauss-Newton Hessian on the kernels' route (a knob they take), with
    the knob in the configuration the route runs."""
    mod = _driver()
    args = mod.parse_args(["--linsys", linsys, "--hessian", hessian])
    cuda = torch.device("cuda", 0)
    cfg = mod.solver_config(args, cuda)
    assert cfg.cost.hessian == hessian
    assert want in mod.route(cfg, linsys, cuda)
    args = mod.parse_args(["--linsys", "pcg", "--no-precond"])
    cfg = mod.solver_config(args, cuda)
    assert not cfg.megakernel and "pcg: K3, K4, K2" in mod.route(cfg, "pcg",
                                                                 cuda)
    # --fine-grained: the timed solves run the plain phases (K4b for
    # pcg_pallas), the warm-up the kernels
    args = mod.parse_args(["--linsys", "pcg_pallas", "--fine-grained"])
    cfg = mod.solver_config(args, cuda)
    got = mod.route(cfg, "pcg_pallas", cuda, fine_grained=True)
    assert got.startswith("fine-grained: plain phases on cuda:0, K4b, K1")
    assert "warm-up on the kernels on cuda:0 (pcg_pallas: K3, K4, K2" in got


def test_warm_up_carries_lam_and_rho_and_resets_the_iterate(traj_0_0,
                                                            monkeypatch):
    """The warm-up (REMOVE_JITTERS, mpcgpu_tpu/sim.py:308-331): each of
    warmup_iters solves at tol 1e-11 with the CG capped at 10000, from the
    trajectory's start with the previous solve's lam and rho; then rho
    back to rho_init and one solve of the measured configuration, whose
    result is dropped; the timed loop starts from the warm lam.  The
    warm-up's solves are stood in for (lam + 1, rho x 2): only the calls
    are checked here."""
    xu, ee = traj_0_0
    calls = []
    real = sim.sqp_solve

    def spy(model, cfg, X, U, lam, goals, xs, rho, tol, linsys):
        out = real(model, cfg if cfg.pcg.max_iter < 10000 else small, X, U,
                   lam, goals, xs, rho, tol, linsys)
        if cfg.pcg.max_iter == 10000:
            out = out._replace(lam=lam + 1.0, rho=rho * 2.0)
        calls.append((cfg.pcg.max_iter, tol, X.clone(), lam.clone(),
                      float(rho)))
        return out

    cfg = SolverConfig.for_knots(N, sqp_max_iter=1, pcg=PCGConfig(max_iter=8))
    small = SolverConfig.for_knots(N, sqp_max_iter=1,
                                   pcg=PCGConfig(max_iter=1))
    monkeypatch.setattr(sim, "sqp_solve", spy)
    sim.simulate_mpc(iiwa14(device="cpu"), cfg, xu, ee, pcg_exit_tol=TOL,
                     warmup_iters=2, max_control_updates=2)
    assert [c[:2] for c in calls] == [(10000, 1e-11), (10000, 1e-11),
                                      (8, TOL), (8, TOL), (8, TOL)]
    X0, r0 = T(xu[:N, :14]), cfg.rho_init
    for i, (lam, rho) in enumerate([(0.0, r0), (1.0, 2 * r0), (2.0, r0),
                                    (2.0, r0)]):
        torch.testing.assert_close(calls[i][2], X0, rtol=0, atol=0)
        assert (calls[i][3] == lam).all(), i
        assert calls[i][4] == pytest.approx(rho, rel=1e-6), i
