#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpcgpu_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit:

1. prints the card's name and power limit (nvidia-smi) and the versions;
2. builds the hand-written kernels (csrc/*.cu, one nvcc per source, all at
   once, sm_90a) and prints the build time and ptxas' register / spill
   report;
3. checks each kernel K1-K7, K7s, K9p, K9b and K10 against its plain
   PyTorch version on the card at the slice's N = 64 inputs from fixture
   0_0 (K6 and K7 also on a seeded well-conditioned system, K7s also at
   N = 128 and 256, K5, K9p and K10 also at larger carried rhos where
   their CGs exit before the cap, K10 with two arms from seeded
   perturbations and its shared CG exit shown to decide, four K9p
   launches against one K5 launch, the split BCR paths against K7 and
   K6), and the arm-batched K1 launch against single K1 launches
   (bit-equal), with the tolerances of the JAX package's own kernel tests
   (the exact BCR solves by relative residual on the slice's systems), and
   times both (CUDA events, median after warm-up);
4. runs three closed loops -- fixture pair 0_0, N = 64,
   SolverConfig.for_knots(64, sqp_max_iter=4), PCG cap 40, exit tol
   5e-5, lam warm-started by 5 solves at tol 1e-11, simulate_mpc_scan for
   16 control updates -- each once through the kernels and once through
   the plain modules:
   - the staged pcg loop (K3, K4, K2, K1 per update);
   - the bench's default, linsys="auto" with megakernel and
     megakernel_solve (K2, K5, K1 per update), timed: CUDA-event update
     median, host clock per update, device time by kernel
     (torch.profiler);
   - the same with the failover forced (both thresholds -1, the latch
     read every 8 updates): K5 for 8 updates, then K3, K6, K2 per SQP
     iteration, timed as the default;
   and checks tracking errors, their agreement, SQP iterations, rho
   bails, failed_over and each run's kernel launch counts (set to 0 just
   before the run, read just after);
5. runs the multi-arm loops from the same warm duals, two arms from
   seeded start perturbations: simulate_mpc_scan_packed for 16 updates
   through the kernels (K10 and the arm-batched K1, one launch each per
   update) and through the plain modules, checked and timed as the auto
   loop; simulate_mpc_scan_batched (plain modules, no kernel) for 8
   updates; and the packed loop's arm-updates/s over B = 1, 2, 4, 8, 16
   arms with K10's device time per call;
6. runs the remaining sqp_solve configurations' loops, 8 updates each,
   through the kernels and the plain modules: the staged bcr loop (K3,
   K7, K2; K1) at N = 64 and at N = 128 (K7s, the split path), the
   per-iteration megakernel loops (K2, then K9p or K9b per SQP
   iteration; K1), the pcg_pallas backend (plain stages and K4b), and the
   dense and qdldl oracles against each other;
7. prints the linear-solve comparison (the reference's TIME_LINSYS) on
   the slice's warm system: each backend's time per solve, CG iterations
   and relative residual;
8. prints one JSON line of the kernels, then the result line.

Any failed build, launch or check ends the run with a non-zero exit code
before the result line.  Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_KNOTS = 64
N_UPDATES = 16
SQP_ITERS = 4
WARM_SOLVES = 5
REPS = 20
ARMS = 2                        # the packed loop's pack (bench.py --batch 2)
BATCHED_UPDATES = 8
SWEEP_ARMS = (1, 2, 4, 8, 16)
NEW_UPDATES = 8                 # the loops of this file's phase 6
LONG_KNOTS = 128                # the staged bcr loop above K7's fit

# The least time the card could take for a kernel's work: the
# larger of the bytes a function must move (inputs read once, outputs
# written once) over the H100's 3.35 TB/s and its operations over the
# 67 TFLOP/s float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4
TAB = 1680          # model-table floats (lanedyn.cuh TAB_SIZE)
NX, NU = 14, 7
# Operations of the device library's routines per call, counted by hand
# from csrc/lanedyn.cuh (a multiply-add counts 2; sin, cos and a division
# 1): ABA forward dynamics, end-effector FK, one knot of one merit
# candidate (FK + ABA + cost and defect), one knot of K3's three stages
# (CRBA, RNEA, FK + Jacobian, 14 RNEA tangents, 7x7 and 14x14 inverses,
# the Schur products, theta^-1, the stair products), one 14x14
# Gauss-Jordan inverse, one 14x14 product and one 14x14 matrix-vector.
OPS_ABA, OPS_FK, OPS_MERIT_KNOT = 11_900, 1_220, 13_300
OPS_K3_KNOT, OPS_GJ14, OPS_MM14, OPS_MV14 = 120_000, 5_490, 5_488, 392


def _spmv_ops(n):
    return OPS_MV14 * (3 * n - 2)


def _dz_ops(n):
    return 2 * (n * NX * 2 * NX + (n - 1) * NU * (NX + NU))


def _cg_ops(n, its, apply_ops):
    """CG from a warm start: the first residual and apply, then per
    iteration one S product, one preconditioner apply, two dots and
    three axpys."""
    return (_spmv_ops(n) + apply_ops) * (1 + its) + its * 10 * NX * n


def _merits_ops(n, cands):
    return cands * ((n - 1) * OPS_MERIT_KNOT + OPS_FK + 50)


def _bcr_factor_ops(n):
    levels = n.bit_length() - 1
    return sum((n >> (l + 1)) * (OPS_GJ14 + 7 * OPS_MM14)
               for l in range(levels)) + OPS_GJ14


def _bcr_apply_ops(n):
    return (n - 1) * 5 * OPS_MV14 + OPS_MV14


def _k3_no_stair_ops(n):
    """K3's stages without theta^-1 and the four stair products."""
    return n * (OPS_K3_KNOT - OPS_GJ14 - 4 * OPS_MM14)


def _knot_schur_floats(n):
    """K3's outputs: SL SD SU PL PD PU Qinv A, Rinv, B, gamma, q, r."""
    return n * (8 * NX * NX + NU * NU + NX * NU + 2 * NX + NU)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _event_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of one call of fn, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_err(pairs) -> float:
    return max(float((g.double() - w.double()).abs().max()) for g, w in pairs)


def _assert_close(name, pairs, rtol, atol):
    import torch

    for i, (g, w) in enumerate(pairs):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: output {i} is not finite")
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name} output {i}: {m}")


_TAGS = {"K10": "sqp_mega_packed_kernel", "K5": "sqp_mega_kernel",
         "K9p": "sqp_iter_mega_pcg_kernel", "K9b": "sqp_iter_mega_bcr_kernel",
         "K6": "bcr_pcg_dz_kernel", "K7": "bcr_dz_kernel",
         "K7s": "bcr_solve_kernel", "K3": "k3_", "K4": "pcg_dz_kernel",
         "K4b": "pcg_solve_kernel", "K2": "merit_kernel",
         "K1": "rollout_kernel"}


def _device_events(run):
    """(start us, end us, name) of every device kernel of one call of run
    (torch.profiler, CUPTI), sorted by start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def _by_kernel(evs) -> dict:
    """{kernel id or "torch glue": (device us, device kernels)}."""
    groups: dict = {}
    for s, e, name in evs:
        key = next((k for k, t in _TAGS.items() if t in name), "torch glue")
        t, n = groups.get(key, (0.0, 0))
        groups[key] = (t + e - s, n + 1)
    return groups


def _device_breakdown(run, n_updates: int) -> dict:
    """Print where the device time of one call of run goes: busy span and
    idle share, and device time by kernel; return _by_kernel's groups."""
    evs = _device_events(run)
    if not evs:
        print("profile: the profiler recorded no device events")
        return {}
    busy, (cs, ce) = 0.0, evs[0][:2]
    for s, e, _ in evs[1:]:
        if s > ce:
            busy, cs, ce = busy + ce - cs, s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    span = evs[-1][1] - evs[0][0]
    print(f"profile: {len(evs)} device events, span {span / 1e3:.3f} ms, busy "
          f"{busy / 1e3:.3f} ms ({busy / 1e3 / n_updates:.4f} ms/update), "
          f"idle share {1 - busy / span:.3f}")
    groups = _by_kernel(evs)
    for key, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {key:10s} {t / 1e3:8.3f} ms  {100 * t / busy:5.1f}%  "
              f"{n:5d} device kernels  {t / n:8.2f} us each")
    return groups


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from mpcgpu_tpu_torch.config import (PCGConfig, SolverConfig,
                                         default_pcg_exit_tols)
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.linsys.qdldl_host import (_btd_upper_csc,
                                                    _cached_solver)
    from mpcgpu_tpu_torch.ops.btridiag import BlockTri, spmv, to_dense
    from mpcgpu_tpu_torch.ops.cuda import _lib, launch_counts
    from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k6
    from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k7
    from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
    from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
    from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
    from mpcgpu_tpu_torch.ops.cuda import reset_launch_counts
    from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k9
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k10
    from mpcgpu_tpu_torch.ops.schur import SchurData
    from mpcgpu_tpu_torch.sim import (arm_starts, max_substeps_for,
                                      simulate_mpc_scan,
                                      simulate_mpc_scan_batched,
                                      simulate_mpc_scan_packed)
    from mpcgpu_tpu_torch.sqp import get_linsys_backend, iterate, sqp_solve
    from mpcgpu_tpu_torch.utils.trajfiles import horizon_slices, load_fixture_pair
    # the tests' seeded well-conditioned K6 system, loaded by path: the
    # machine may have another package named "tests"
    spec = importlib.util.spec_from_file_location(
        "_torch_systems", repo / "tests" / "torch_systems.py")
    systems = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(systems)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = _lib.build(force=True)
    lib = _lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 3. each kernel against its plain version, slice inputs
    model = iiwa14(device=dev)
    xu, ee = load_fixture_pair(repo / "tests" / "fixtures", 0, 0)
    X, U, goals, xs = (torch.as_tensor(a, device=dev)
                       for a in horizon_slices(xu, ee, N_KNOTS))
    n = N_KNOTS
    cap = PCGConfig.tpu_tuned_max_iter(N_KNOTS)
    tol = default_pcg_exit_tols(N_KNOTS)[0]
    cfg = SolverConfig.for_knots(N_KNOTS, sqp_max_iter=SQP_ITERS,
                                 pcg=PCGConfig(max_iter=cap),
                                 fused_stages=True)
    cc = cfg.cost
    rho = torch.tensor(cfg.rho_init, device=dev)
    print(f"slice: N={N_KNOTS} sqp_max_iter={SQP_ITERS} pcg cap={cap} "
          f"tol={tol:g} r_cost={cc.r_cost:g} updates={N_UPDATES}")
    print(f"fit: K4 serves N <= {k4.check_pcg_smem_fit(n)}, K6 power-of-2 "
          f"N <= {k6.check_bcr_fit(n)}, K5 N <= "
          f"{lib.mpc_mega_max_knots(k5.SOLVE_PCG)} (grid "
          f"{k5.check_mega_fit(n)} blocks at N = {n})")
    print(f"fit: K7 power-of-2 N <= {k7.check_bcr_dz_fit(n)}, K7s power-of-2 "
          f"N <= {k7.check_bcr_solve_fit(n)}, K9p N <= "
          f"{lib.mpc_mega_max_knots(k9.ITER_PCG)} (grid "
          f"{k9.check_mega_fit(n, kind=k9.ITER_PCG)}), K9b N <= "
          f"{lib.mpc_mega_max_knots(k9.ITER_BCR)} (grid "
          f"{k9.check_mega_fit(n, kind=k9.ITER_BCR)})")

    kernels = []

    def record(kid, name, source, replaces, err, run, plain, ops, nbytes,
               **extra):
        ms, plain_ms = _event_ms(run), _event_ms(plain)
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"{kid} {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound_ms:.6f} ms "
              f"({bound_by}: {nbytes} B, {ops} operations)")
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None, **extra})

    def checked(name, pairs, rtol, atol):
        _assert_close(name, pairs, rtol, atol)
        return _max_err(pairs)

    k3_args = (model, X, U, goals, xs, rho, cfg.timestep, cc.qd_cost,
               cc.r_cost, cfg.gravity)
    ks = k3.form_kkt_schur(*k3_args)
    ks_ref = k3.form_kkt_schur_reference(*k3_args)
    sync()
    record("K3", "form_kkt_schur", "mpcgpu_tpu_torch/csrc/kkt_schur.cu",
           "mpcgpu_tpu/ops/pallas/kkt_schur_kernel.py:379",
           checked("K3", list(zip(ks, ks_ref)), 3e-3, 3e-3),
           lambda: k3.form_kkt_schur(*k3_args),
           lambda: k3.form_kkt_schur_reference(*k3_args),
           n * OPS_K3_KNOT,
           F32 * (n * NX + (n - 1) * NU + n * 6 + 1 + TAB
                  + _knot_schur_floats(n)))

    lam0 = torch.zeros_like(X)
    k4_out = k4.pcg_dz(ks_ref, lam0, cap, tol)
    k4_ref = k4.pcg_dz_reference(ks_ref, lam0, cap, tol)
    sync()
    it, it_ref = int(k4_out[3]), int(k4_ref[3])
    print(f"K4 CG iterations: kernel {it} (hit {bool(k4_out[4])}), plain "
          f"{it_ref} (hit {bool(k4_ref[4])})")
    if not (abs(it - it_ref) <= 2 or it == it_ref == cap):
        raise AssertionError(f"K4 iteration counts disagree: {it} vs {it_ref}")
    record("K4", "pcg_dz", "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
           "mpcgpu_tpu/ops/pallas/pcg_kernel.py:318",
           checked("K4", list(zip(k4_out[:3], k4_ref[:3])), 5e-3, 5e-3),
           lambda: k4.pcg_dz(ks_ref, lam0, cap, tol),
           lambda: k4.pcg_dz_reference(ks_ref, lam0, cap, tol),
           _cg_ops(n, it, _spmv_ops(n)) + _dz_ops(n),
           F32 * (_knot_schur_floats(n) + n * NX + 2 * n * NX
                  + (n - 1) * NU) + 5)

    dX, dU = k4_ref[1], k4_ref[2]
    k2_args = (model, X, U, dX, dU, cfg.num_alphas, goals, xs, cfg.timestep,
               cfg.merit_mu, cc.qd_cost, cc.r_cost, cfg.gravity)
    m = k2.line_search_merits(*k2_args)
    m_ref = k2.line_search_merits_reference(*k2_args)
    sync()
    record("K2", "line_search_merits", "mpcgpu_tpu_torch/csrc/merit.cu",
           "mpcgpu_tpu/ops/pallas/merit_kernel.py:145",
           checked("K2", [(m, m_ref)], 2e-4, 2e-4),
           lambda: k2.line_search_merits(*k2_args),
           lambda: k2.line_search_merits_reference(*k2_args),
           _merits_ops(n, cfg.num_alphas + 1),
           F32 * (2 * (n * NX + (n - 1) * NU) + n * 6 + NX + TAB
                  + cfg.num_alphas + 1))

    period = cfg.simulation_period_us
    k1_args = (model, cfg, xs, U, goals[0], period, period,
               max_substeps_for(cfg))
    r = k1.plant_rollout(*k1_args)
    r_ref = k1.plant_rollout_reference(*k1_args)
    # the arm-batched launch (one block per arm) against one single launch
    # per arm: bit-equal, the same per-arm arithmetic in the same order
    gen = np.random.default_rng(9)
    x_arms = xs + torch.as_tensor(0.01 * gen.normal(size=(ARMS, NX)),
                                  dtype=torch.float32, device=dev)
    U_arms = U + torch.as_tensor(0.01 * gen.normal(size=(ARMS, n - 1, NU)),
                                 dtype=torch.float32, device=dev)
    k1_arm_args = (model, cfg, x_arms, U_arms, goals[0], period, period,
                   max_substeps_for(cfg))
    r_arms = k1.plant_rollout(*k1_arm_args)
    r_one = [k1.plant_rollout(model, cfg, x_arms[a], U_arms[a], *k1_args[4:])
             for a in range(ARMS)]
    sync()
    for a, (x1, e1) in enumerate(r_one):
        if not (torch.equal(r_arms[0][a], x1) and torch.equal(r_arms[1][a], e1)):
            raise AssertionError(f"K1 arm-batched launch, arm {a}: not "
                                 f"bit-equal to a single launch")
    k1_arms_ms = _event_ms(lambda: k1.plant_rollout(*k1_arm_args))
    print(f"K1 arm-batched ({ARMS} arms, one launch): bit-equal to {ARMS} "
          f"single launches; {k1_arms_ms:.4f} ms per call")
    steps = int(period * 1e-6 / cfg.sim_step_time + 1e-9) + 1  # + remainder
    record("K1", "plant_rollout", "mpcgpu_tpu_torch/csrc/rollout.cu",
           "mpcgpu_tpu/ops/pallas/rollout_kernel.py:92",
           checked("K1", list(zip(r, r_ref)), 1e-4, 1e-5),
           lambda: k1.plant_rollout(*k1_args),
           lambda: k1.plant_rollout_reference(*k1_args),
           steps * (OPS_ABA + 60) + OPS_FK,
           F32 * (NX + (n - 1) * NU + 6 + TAB + NX + 1),
           arm_batched_ms=k1_arms_ms, arm_batched_arms=ARMS)

    def perturbed(seed):
        """X with a seeded perturbation (knot 0 kept), so that the CG
        loops iterate."""
        pert = torch.as_tensor(0.02 * np.random.default_rng(seed).normal(
            size=(n, NX)), dtype=torch.float32, device=dev)
        pert[0] = 0.0
        return X + pert

    Xp = perturbed(5)
    # K6 on a well-conditioned system (the JAX BCR tests' tolerances), and
    # on the slice's K3 system at the perturbed start without the stair
    # preconditioner, which is judged by residual: its condition (~1e7)
    # puts any two float32 solves ~1e-3 of |lam| apart.
    ks_rand = systems.random_knot_schur(n, device=dev)
    k6_out = k6.bcr_pcg_dz(ks_rand, lam0, cap, tol)
    k6_ref = k6.bcr_pcg_dz_reference(ks_rand, lam0, cap, tol)
    sync()
    scale = k6_ref[0].abs().max()
    checked("K6 lam/max|lam|", [(k6_out[0] / scale, k6_ref[0] / scale)], 0,
            2e-5)
    err6 = checked("K6 dz", list(zip(k6_out[1:3], k6_ref[1:3])), 1e-3, 2e-4)
    err6 = max(err6, _max_err([(k6_out[0], k6_ref[0])]))
    if abs(int(k6_out[3]) - int(k6_ref[3])) > 1:
        raise AssertionError(f"K6 iteration counts disagree: "
                             f"{int(k6_out[3])} vs {int(k6_ref[3])}")
    ks_np = k3.form_kkt_schur_reference(model, Xp, *k3_args[2:],
                                        precond=False)
    k6_slice = k6.bcr_pcg_dz(ks_np, lam0, cap, tol)
    k6_slice_ref = k6.bcr_pcg_dz_reference(ks_np, lam0, cap, tol)
    sync()
    S = BlockTri(ks_np.SL, ks_np.SD, ks_np.SU)
    res = [float((spmv(S, o[0]) - ks_np.gamma).abs().max()
                 / ks_np.gamma.abs().max()) for o in (k6_slice, k6_slice_ref)]
    its6 = int(k6_slice[3]), int(k6_slice_ref[3])
    print(f"K6 random system: CG {int(k6_out[3])} vs {int(k6_ref[3])} "
          f"iterations; slice system: CG {its6[0]} vs {its6[1]}, relative "
          f"residual kernel {res[0]:.3e} plain {res[1]:.3e}")
    if max(res) >= 1e-3 or abs(its6[0] - its6[1]) > 1:
        raise AssertionError(f"K6 on the slice system: residuals {res}, "
                             f"iterations {its6}")
    err6_slice = _max_err(list(zip(k6_slice[:3], k6_slice_ref[:3])))
    record("K6", "bcr_pcg_dz", "mpcgpu_tpu_torch/csrc/bcr_pcg_dz.cu",
           "mpcgpu_tpu/ops/pallas/bcr_kernel.py:267", err6,
           lambda: k6.bcr_pcg_dz(ks_np, lam0, cap, tol),
           lambda: k6.bcr_pcg_dz_reference(ks_np, lam0, cap, tol),
           _bcr_factor_ops(n) + _cg_ops(n, its6[0], _bcr_apply_ops(n))
           + _dz_ops(n),
           F32 * (n * (5 * NX * NX + NX * NU + NU * NU + 3 * NX + NU)
                  + 2 * n * NX + (n - 1) * NU) + 5,
           max_abs_err_slice=err6_slice)

    # K5: 4 SQP iterations from the perturbed start, cold duals
    merit0 = k2.line_search_merits_reference(
        model, Xp, U, torch.zeros_like(Xp), torch.zeros_like(U),
        cfg.num_alphas, goals, xs, cfg.timestep, cfg.merit_mu, cc.qd_cost,
        cc.r_cost, cfg.gravity)[cfg.num_alphas]
    k5_kw = dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
                 gravity=cfg.gravity, mu=cfg.merit_mu,
                 num_alphas=cfg.num_alphas, rho_factor=cfg.rho_factor,
                 rho_min=cfg.rho_min, rho_max=cfg.rho_max,
                 rho_reset=cfg.rho_reset)

    def k5_pair(rho0, lam_rtol, lam_atol):
        """K5 and its plain version from the perturbed start at carried
        rho0: X, U at the JAX megakernel test's rtol 1e-3, atol 1e-5,
        decisions identical, CG iterations within 2 per SQP iteration."""
        args = (model, Xp, U, goals, xs, lam0,
                torch.tensor(rho0, device=dev), 1.0, merit0, cap, tol,
                SQP_ITERS)
        out = k5.sqp_solve_mega_pcg(*args, **k5_kw)
        ref = k5.sqp_solve_mega_pcg_reference(*args, **k5_kw)
        sync()
        print(f"K5 at rho {rho0:g}: pcg iters {out.pcg_iters.tolist()} vs "
              f"{ref.pcg_iters.tolist()}, accepted {out.accepted.tolist()} "
              f"vs {ref.accepted.tolist()}, sqp_iters {int(out.sqp_iters)} "
              f"vs {int(ref.sqp_iters)}, bailed {bool(out.bailed)} vs "
              f"{bool(ref.bailed)}, lam err "
              f"{_max_err([(out.lam, ref.lam)]):.3e}")
        for f in ("accepted", "sqp_iters", "bailed"):
            if not torch.equal(getattr(out, f), getattr(ref, f)):
                raise AssertionError(f"K5 at rho {rho0:g}: {f} differs from "
                                     f"the plain version")
        if int((out.pcg_iters - ref.pcg_iters).abs().max()) > 2:
            raise AssertionError(f"K5 at rho {rho0:g}: CG iteration counts "
                                 f"differ by more than 2")
        err = max(checked(f"K5 X, U at rho {rho0:g}",
                          [(out.X, ref.X), (out.U, ref.U)], 1e-3, 1e-5),
                  checked(f"K5 lam at rho {rho0:g}", [(out.lam, ref.lam)],
                          lam_rtol, lam_atol))
        return args, out, ref, err

    # at the slice's rho every CG stops at the cap, on a system of
    # condition ~1e7 where two float32 CG loops summing in different orders
    # part by up to 5.4e-4 in lam: lam at atol 1e-3
    k5_args, k5_out, _, err5 = k5_pair(cfg.rho_init, 0, 1e-3)
    # at rhos the schedule reaches after rejected steps the CGs exit before
    # the cap, the exit every block must take alike: lam at the JAX
    # megakernel test's rtol 1e-3, atol 1e-4
    for rho_early in (0.1, 0.3):
        _, _, ref, err = k5_pair(rho_early, 1e-3, 1e-4)
        its = ref.pcg_iters
        if not bool(((its >= 0) & (its < cap)).any()):
            raise AssertionError(f"K5 at rho {rho_early:g}: no CG exited "
                                 f"before the cap")
        err5 = max(err5, err)
    run_its = [int(i) for i in k5_out.pcg_iters.tolist() if i >= 0]
    record("K5", "sqp_solve_mega_pcg", "mpcgpu_tpu_torch/csrc/sqp_mega.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:1027", err5,
           lambda: k5.sqp_solve_mega_pcg(*k5_args, **k5_kw),
           lambda: k5.sqp_solve_mega_pcg_reference(*k5_args, **k5_kw),
           sum(n * OPS_K3_KNOT + _cg_ops(n, i, _spmv_ops(n)) + _dz_ops(n)
               + _merits_ops(n, cfg.num_alphas) for i in run_its),
           F32 * (2 * (2 * n * NX + (n - 1) * NU) + n * 6 + NX + TAB + 2
                  + 3) + 4 * (2 + 3 * SQP_ITERS))

    # K10: two arms, K5's perturbed start and a second seeded one, cold
    # duals, each held against the plain version and, for the shared CG
    # exit, each arm solved alone by K5's plain version
    b = ARMS
    Xb = torch.stack([Xp, perturbed(6)])
    Ub = U.expand(b, n - 1, NU).contiguous()
    goals_b = goals.expand((b,) + goals.shape)
    xs_b = xs.expand(b, NX).contiguous()
    lam0_b = torch.zeros(b, n, NX, device=dev)
    merit0_b = [k2.line_search_merits_reference(
        model, Xb[a], U, torch.zeros_like(Xp), torch.zeros_like(U),
        cfg.num_alphas, goals, xs, cfg.timestep, cfg.merit_mu, cc.qd_cost,
        cc.r_cost, cfg.gravity)[cfg.num_alphas] for a in range(b)]

    def k10_pair(rhos, lam_rtol, lam_atol):
        """K10 and its plain version at per-arm rhos: X, U at rtol 1e-3,
        atol 1e-5, sqp_iters, bails and the shared CG count equal; returns
        the lone arms' CG totals too."""
        args = (model, Xb, Ub, goals_b, xs_b, lam0_b,
                torch.tensor(rhos, device=dev), torch.ones(b, device=dev),
                cap, tol, SQP_ITERS)
        out = k10.sqp_solve_mega_pcg_packed(*args, **k5_kw)
        ref = k10.sqp_solve_mega_pcg_packed_reference(*args, **k5_kw)
        alone = [k5.sqp_solve_mega_pcg_reference(
            model, Xb[a], U, goals, xs, lam0, torch.tensor(rhos[a], device=dev),
            1.0, merit0_b[a], cap, tol, SQP_ITERS, **k5_kw).pcg_iters
            for a in range(b)]
        sync()
        alone = [int(i.clamp(min=0).sum()) for i in alone]
        print(f"K10 at rhos {rhos}: sqp_iters {out.sqp_iters.tolist()} vs "
              f"{ref.sqp_iters.tolist()}, bailed {out.bailed.tolist()} vs "
              f"{ref.bailed.tolist()}, shared CG total "
              f"{int(out.pcg_iters_total)} vs {int(ref.pcg_iters_total)} "
              f"(each arm alone: {alone}), lam err "
              f"{_max_err([(out.lam, ref.lam)]):.3e}")
        for f in ("sqp_iters", "bailed", "pcg_iters_total"):
            if not torch.equal(getattr(out, f), getattr(ref, f)):
                raise AssertionError(f"K10 at rhos {rhos}: {f} differs from "
                                     f"the plain version")
        err = max(checked(f"K10 X, U at rhos {rhos}",
                          [(out.X, ref.X), (out.U, ref.U)], 1e-3, 1e-5),
                  checked(f"K10 lam at rhos {rhos}", [(out.lam, ref.lam)],
                          lam_rtol, lam_atol))
        return args, out, alone, err

    # the cold start of K5's check, every CG at the cap: lam at atol 1e-3
    k10_args, k10_out, _, err10 = k10_pair((cfg.rho_init,) * b, 0, 1e-3)
    # rhos where the CGs exit before the cap: lam at rtol 1e-3, atol 1e-4
    shared_decided = False
    for rhos in ((0.1, 0.3), (0.3, 0.1)):
        _, out, alone, err = k10_pair(rhos, 1e-3, 1e-4)
        err10 = max(err10, err)
        shared_decided |= min(alone) < int(out.pcg_iters_total)
    if not shared_decided:
        raise AssertionError("K10: no arm alone left the CG before the pack: "
                             "the shared exit was never exercised")
    # the shared exit's cost: K10 with one arm on K5's cold start runs K5's
    # CG iterations, with a grid barrier after each
    b1_args = (model, Xp[None], U[None], goals[None], xs[None], lam0[None],
               torch.tensor([cfg.rho_init], device=dev),
               torch.ones(1, device=dev), cap, tol, SQP_ITERS)
    b1 = k10.sqp_solve_mega_pcg_packed(*b1_args, **k5_kw)
    b1_ms = _event_ms(lambda: k10.sqp_solve_mega_pcg_packed(*b1_args,
                                                            **k5_kw))
    k5_ms = next(k["ms"] for k in kernels if k["name"].startswith("K5 "))
    b1_its = int(b1.pcg_iters_total)
    barrier_us = 1e3 * (b1_ms - k5_ms) / b1_its
    print(f"K10 with one arm on K5's start: {b1_ms:.4f} ms per call, "
          f"{b1_its} CG iterations, against K5's {k5_ms:.4f} ms, "
          f"{sum(run_its)}: {barrier_us:.2f} us more per CG iteration")
    # operations: per arm K5's at the shared CG count (every arm steps it),
    # over SQP_ITERS solves of the CG, plus the incumbent merit
    tot10 = int(k10_out.pcg_iters_total)
    cg10 = _cg_ops(n, tot10, _spmv_ops(n)) + (SQP_ITERS - 1) * 2 * _spmv_ops(n)
    record("K10", "sqp_solve_mega_pcg_packed",
           "mpcgpu_tpu_torch/csrc/sqp_mega_packed.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:843", err10,
           lambda: k10.sqp_solve_mega_pcg_packed(*k10_args, **k5_kw),
           lambda: k10.sqp_solve_mega_pcg_packed_reference(*k10_args, **k5_kw),
           b * (SQP_ITERS * (n * OPS_K3_KNOT + _dz_ops(n)
                             + _merits_ops(n, cfg.num_alphas))
                + cg10 + _merits_ops(n, 1)),
           F32 * (2 * b * (2 * n * NX + (n - 1) * NU) + n * 6 + b * NX + TAB
                  + 4 * b) + 4 * (2 * b + 1),
           arms=b, grid=k10.check_mega_packed_fit(n, b, cfg.num_alphas),
           one_arm_ms=b1_ms, us_per_cg_iter_over_k5=barrier_us)

    # ---- the kernels of the remaining sqp_solve configurations
    def residual_pair(label, ks_sys, got_lam, plain_lam):
        """The exact solvers on the slice's systems (condition ~1e7) are
        held by relative residual: the kernel's within 2x of the plain
        solve's."""
        res = (systems.relative_residual(ks_sys, got_lam),
               systems.relative_residual(ks_sys, plain_lam))
        print(f"{label}: relative residual kernel {res[0]:.3e} plain "
              f"{res[1]:.3e}")
        if not res[0] <= 2 * res[1]:
            raise AssertionError(f"{label}: the kernel's relative residual "
                                 f"{res[0]:.3e} is over twice the plain "
                                 f"solve's {res[1]:.3e}")
        return res

    def tight_bcr(label, got, want):
        """tests/test_bcr.py:62-74 on a well-conditioned system: lam scaled
        by its largest entry at atol 2e-5, dz at rtol 1e-3, atol 2e-4."""
        whole = isinstance(got, tuple)   # (lam, dX, dU, ...) or lam
        lam_g, lam_w = (got[0], want[0]) if whole else (got, want)
        scale = lam_w.abs().max()
        checked(f"{label} lam/max|lam|", [(lam_g / scale, lam_w / scale)], 0,
                2e-5)
        err = _max_err([(lam_g, lam_w)])
        if whole:
            err = max(err, checked(f"{label} dz", list(zip(got[1:3], want[1:3])),
                                   1e-3, 2e-4))
        return err

    # K4b: K4's CG without the dz, on K3's system (the "pcg_pallas" solve)
    S_ref = BlockTri(ks_ref.SL, ks_ref.SD, ks_ref.SU)
    P_ref = BlockTri(ks_ref.PL, ks_ref.PD, ks_ref.PU)
    k4b_args = (S_ref, P_ref, ks_ref.gamma, lam0, cap, tol)
    k4b_out = k4.pcg_solve(*k4b_args)
    k4b_ref = k4.pcg_solve_reference(*k4b_args)
    sync()
    it, it_ref = int(k4b_out[1]), int(k4b_ref[1])
    print(f"K4b CG iterations: kernel {it} (hit {bool(k4b_out[2])}), plain "
          f"{it_ref} (hit {bool(k4b_ref[2])})")
    if not (abs(it - it_ref) <= 2 or it == it_ref == cap):
        raise AssertionError(f"K4b iteration counts disagree: {it} vs "
                             f"{it_ref}")
    record("K4b", "pcg_solve", "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
           "mpcgpu_tpu/ops/pallas/pcg_kernel.py:187",
           checked("K4b", [(k4b_out[0], k4b_ref[0])], 5e-3, 5e-3),
           lambda: k4.pcg_solve(*k4b_args),
           lambda: k4.pcg_solve_reference(*k4b_args),
           _cg_ops(n, it, _spmv_ops(n)),
           F32 * (6 * n * NX * NX + 3 * n * NX) + 5)

    # K7 and K7s: tight on the seeded random system, by residual on the
    # slice's K3 system without the stair (ks_np, the perturbed start)
    k7_out = k7.bcr_dz(ks_rand)
    k7_ref = k7.bcr_dz_reference(ks_rand)
    sync()
    if int(k7_out[3]) != 0 or bool(k7_out[4]):
        raise AssertionError("K7 reports CG iterations")
    err7 = tight_bcr("K7 random system", k7_out, k7_ref)
    res7 = residual_pair("K7 slice system", ks_np, k7.bcr_dz(ks_np)[0],
                         k7.bcr_dz_reference(ks_np)[0])
    record("K7", "bcr_dz", "mpcgpu_tpu_torch/csrc/bcr_dz.cu",
           "mpcgpu_tpu/ops/pallas/bcr_kernel.py:318", err7,
           lambda: k7.bcr_dz(ks_np), lambda: k7.bcr_dz_reference(ks_np),
           _bcr_factor_ops(n) + 2 * _bcr_apply_ops(n) + _spmv_ops(n)
           + _dz_ops(n),
           F32 * (n * (5 * NX * NX + NX * NU + NU * NU + 2 * NX + NU)
                  + 2 * n * NX + (n - 1) * NU),
           residual=res7[0], residual_plain=res7[1])

    def k7s_pair(ks_sys):
        out = k7.bcr_solve(ks_sys.SL, ks_sys.SD, ks_sys.SU, ks_sys.gamma)
        ref = k7.bcr_solve_reference(ks_sys.SL, ks_sys.SD, ks_sys.SU,
                                     ks_sys.gamma)
        sync()
        return out, ref

    err7s = tight_bcr("K7s random system", *k7s_pair(ks_rand))
    errs7s = {}
    for n_long in (LONG_KNOTS, 2 * LONG_KNOTS):
        errs7s[f"max_abs_err_n{n_long}"] = tight_bcr(
            f"K7s random system, N = {n_long}",
            *k7s_pair(systems.random_knot_schur(n_long, device=dev)))
    res7s = residual_pair("K7s slice system", ks_np, *k7s_pair(ks_np))
    S_np = BlockTri(ks_np.SL, ks_np.SD, ks_np.SU)
    dense_np = to_dense(S_np)
    g_col = ks_np.gamma.reshape(-1, 1)
    chol_ms = _event_ms(lambda: torch.cholesky_solve(
        g_col, torch.linalg.cholesky(dense_np)))
    print(f"K7s library yardstick: torch.linalg.cholesky + cholesky_solve on "
          f"the dense S ({n * NX} x {n * NX}): {chol_ms:.4f} ms")
    record("K7s", "bcr_solve", "mpcgpu_tpu_torch/csrc/bcr_dz.cu",
           "mpcgpu_tpu/ops/pallas/bcr_kernel.py:361", err7s,
           lambda: k7.bcr_solve(*S_np, ks_np.gamma),
           lambda: k7.bcr_solve_reference(*S_np, ks_np.gamma),
           _bcr_factor_ops(n) + _bcr_apply_ops(n),
           F32 * (3 * n * NX * NX + 2 * n * NX),
           library_ms=chol_ms, residual=res7s[0], residual_plain=res7s[1],
           **errs7s)

    # the split paths at N = 64, forced, against K7 and K6 (random system)
    tight_bcr("split bcr_dz (K7s, residual, K7s) vs K7",
              k7.bcr_dz(ks_rand, split=True), k7_out)
    split6 = k6.bcr_pcg_dz(ks_rand, lam0, cap, tol, split=True)
    sync()
    tight_bcr("split bcr_pcg_dz (CG glue, K7s applies) vs K6", split6, k6_out)
    print(f"split bcr_pcg_dz: {int(split6[3])} CG iterations, K6 "
          f"{int(k6_out[3])}")
    if abs(int(split6[3]) - int(k6_out[3])) > 1:
        raise AssertionError("split bcr_pcg_dz: CG counts differ from K6's")

    # K9p: one iteration from K5's perturbed start, cold duals
    one = torch.tensor(1.0, device=dev)

    def k9p_pair(rho0, lam_rtol, lam_atol):
        args = (model, Xp, U, goals, xs, lam0, torch.tensor(rho0, device=dev),
                one, merit0, cap, tol)
        out = k9.sqp_iter_mega_pcg(*args, **k5_kw)
        ref = k9.sqp_iter_mega_pcg_reference(*args, **k5_kw)
        sync()
        print(f"K9p at rho {rho0:g}: CG {int(out.pcg_iters)} vs "
              f"{int(ref.pcg_iters)}, accept {bool(out.accept)} vs "
              f"{bool(ref.accept)}, bail {bool(out.bail)} vs "
              f"{bool(ref.bail)}, lam err {_max_err([(out.lam, ref.lam)]):.3e}")
        for f in ("accept", "bail"):
            if not torch.equal(getattr(out, f), getattr(ref, f)):
                raise AssertionError(f"K9p at rho {rho0:g}: {f} differs")
        if abs(int(out.pcg_iters) - int(ref.pcg_iters)) > 2:
            raise AssertionError(f"K9p at rho {rho0:g}: CG counts differ by "
                                 f"more than 2")
        err = max(checked(f"K9p X, U at rho {rho0:g}",
                          [(out.X, ref.X), (out.U, ref.U)], 1e-3, 1e-5),
                  checked(f"K9p lam at rho {rho0:g}", [(out.lam, ref.lam)],
                          lam_rtol, lam_atol))
        return args, out, err

    k9p_args, k9p_out, err9p = k9p_pair(cfg.rho_init, 0, 1e-3)
    for rho_early in (0.1, 0.3):
        err9p = max(err9p, k9p_pair(rho_early, 1e-3, 1e-4)[2])

    # four K9p launches (sqp.iterate's masked loop) against one K5 launch
    # from the same start: the JAX package finds its whole-solve and
    # per-iteration kernels equal to about 1e-5 with identical decisions
    def k9p_step(Xc, Uc, lamc, rhoc, drhoc, meritc):
        return k9.sqp_iter_mega_pcg(model, Xc, Uc, goals, xs, lamc, rhoc,
                                    drhoc, meritc, cap, tol, **k5_kw)

    (Xi, Ui, lami, _, _, _, itsi, bailedi, pcgi, _, acci) = iterate(
        Xp, U, lam0, torch.tensor(cfg.rho_init, device=dev), one, merit0,
        SQP_ITERS, k9p_step)
    sync()
    print(f"K9p x {SQP_ITERS} vs K5: pcg iters {pcgi.tolist()} vs "
          f"{k5_out.pcg_iters.tolist()}, accepted {acci.tolist()} vs "
          f"{k5_out.accepted.tolist()}, X err {_max_err([(Xi, k5_out.X)]):.3e}")
    if not (torch.equal(acci, k5_out.accepted)
            and torch.equal(itsi, k5_out.sqp_iters)
            and torch.equal(bailedi, k5_out.bailed)):
        raise AssertionError("K9p x 4 and K5 take different decisions")
    if int((pcgi - k5_out.pcg_iters).abs().max()) > 2:
        raise AssertionError("K9p x 4 and K5: CG counts differ by more than 2")
    checked("K9p x 4 vs K5 X, U", [(Xi, k5_out.X), (Ui, k5_out.U)], 1e-3, 1e-5)
    checked("K9p x 4 vs K5 lam", [(lami, k5_out.lam)], 0, 1e-3)
    it9 = int(k9p_out.pcg_iters)
    iter_bytes = F32 * (2 * (2 * n * NX + (n - 1) * NU) + 6 * n + NX + TAB
                        + 6) + 20
    record("K9p", "sqp_iter_mega_pcg", "mpcgpu_tpu_torch/csrc/sqp_mega.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:960", err9p,
           lambda: k9.sqp_iter_mega_pcg(*k9p_args, **k5_kw),
           lambda: k9.sqp_iter_mega_pcg_reference(*k9p_args, **k5_kw),
           n * OPS_K3_KNOT + _cg_ops(n, it9, _spmv_ops(n)) + _dz_ops(n)
           + _merits_ops(n, cfg.num_alphas), iter_bytes,
           grid=k9.check_mega_fit(n, kind=k9.ITER_PCG))

    # K9b: one iteration with the refined BCR; its solve by residual, the
    # stages after it against the plain iteration given the kernel's lam
    k9b_args = (model, Xp, U, goals, xs, torch.tensor(cfg.rho_init,
                                                      device=dev), one, merit0)
    k9b_out = k9.sqp_iter_mega(*k9b_args, **k5_kw)
    k9b_ref = k9.sqp_iter_mega_reference(*k9b_args, **k5_kw)
    sync()
    for f in ("accept", "bail"):
        if not torch.equal(getattr(k9b_out, f), getattr(k9b_ref, f)):
            raise AssertionError(f"K9b: {f} differs from the plain iteration")
    if int(k9b_out.pcg_iters) != 0 or bool(k9b_out.hit_max):
        raise AssertionError("K9b reports CG iterations")
    given, ks_b = systems.bcr_iteration_given_lam(*k9b_args, k9b_out.lam,
                                                  **k5_kw)
    res9b = residual_pair("K9b lam", ks_b, k9b_out.lam, k9b_ref.lam)
    err9b = checked("K9b X, U, merit against the plain iteration given its "
                    "lam", [(k9b_out.X, given.X), (k9b_out.U, given.U),
                            (k9b_out.merit, given.merit)], 1e-3, 2e-4)
    err9b_plain = _max_err([(k9b_out.X, k9b_ref.X), (k9b_out.U, k9b_ref.U)])
    print(f"K9b: accept {bool(k9b_out.accept)}, X, U against the "
          f"independent plain iteration within {err9b_plain:.3e}")
    k5_ms = next(k["ms"] for k in kernels if k["name"].startswith("K5 "))
    record("K9b", "sqp_iter_mega", "mpcgpu_tpu_torch/csrc/sqp_mega.cu",
           "mpcgpu_tpu/ops/pallas/sqp_megakernel.py:901", err9b,
           lambda: k9.sqp_iter_mega(*k9b_args, **k5_kw),
           lambda: k9.sqp_iter_mega_reference(*k9b_args, **k5_kw),
           _k3_no_stair_ops(n) + _bcr_factor_ops(n) + 2 * _bcr_apply_ops(n)
           + _spmv_ops(n) + _dz_ops(n) + _merits_ops(n, cfg.num_alphas),
           iter_bytes - F32 * n * NX,
           grid=k9.check_mega_fit(n, kind=k9.ITER_BCR),
           max_abs_err_vs_plain=err9b_plain, residual=res9b[0],
           residual_plain=res9b[1], k5_ms_per_iteration=k5_ms / SQP_ITERS)
    k9b_ms = kernels[-1]["ms"]
    print(f"K9b {k9b_ms:.4f} ms per launch against K5's {k5_ms:.4f} ms for "
          f"{SQP_ITERS} iterations ({k5_ms / SQP_ITERS:.4f} ms each)")

    # ---- 4. the closed loops, through the kernels and the plain modules
    xu_d = torch.as_tensor(xu, device=dev)
    ee_d = torch.as_tensor(ee, device=dev)

    def warm_lam(run_cfg, start):
        Xs, Us, goals_s, xs_s = start
        lam = torch.zeros_like(Xs)
        r0 = torch.tensor(cfg.rho_init, device=dev)
        for _ in range(WARM_SOLVES):      # warm-start lam (bench.py:161-176)
            res = sqp_solve(model, run_cfg, Xs, Us, lam, goals_s, xs_s, r0,
                            1e-11)
            lam, r0 = res.lam, res.rho
        return lam

    def counted(label, run, want):
        """Run once with every launch count set to 0 just before; check
        and return the counts read just after."""
        sync()
        reset_launch_counts()
        out = run()
        sync()
        counts = launch_counts()
        print(f"{label}: launches {counts}")
        if want is not None and counts != want:
            raise AssertionError(f"{label}: launch counts {counts}, expected "
                                 f"{want}")
        return out, counts

    def host_and_device(label, again, n_updates, profile=True):
        """The host clock per update, then (profile) the device breakdown,
        returned as _by_kernel's groups."""
        sync()
        t0 = time.perf_counter()
        again()
        t_enqueue = time.perf_counter() - t0
        sync()
        t_wall = time.perf_counter() - t0
        print(f"{label} host clock: enqueue "
              f"{1e3 * t_enqueue / n_updates:.3f} ms/update, to the end "
              f"of the device work {1e3 * t_wall / n_updates:.3f} "
              f"ms/update")
        return _device_breakdown(again, n_updates) if profile else {}

    start64 = (X, U, goals, xs)

    def run_loop(label, run_cfg, linsys, want=None, detail=False,
                 n_updates=N_UPDATES, start=start64, warm=True):
        """One closed loop from start (X, U, goals, xs), lam warm-started
        or zero: launch counts, the host clock and device breakdown when
        detail (detail="host": the host clock only), and a summary."""
        Xs, Us = start[:2]
        lam = warm_lam(run_cfg, start) if warm else torch.zeros_like(Xs)
        simulate_mpc_scan(model, run_cfg, xu_d, ee_d, Xs, Us, lam, rho, tol, 2,
                          linsys)
        out, counts = counted(label, lambda: simulate_mpc_scan(
            model, run_cfg, xu_d, ee_d, Xs, Us, lam, rho, tol, n_updates,
            linsys, timing=True), want)

        def again():
            return simulate_mpc_scan(model, run_cfg, xu_d, ee_d, Xs, Us, lam,
                                     rho, tol, n_updates, linsys)

        groups = host_and_device(label, again, n_updates,
                                 detail != "host") if detail else {}
        errs = out["tracking_errors"]
        if tuple(errs.shape) != (n_updates,) or not torch.isfinite(errs).all():
            raise AssertionError(f"{label}: tracking errors not finite: {errs}")
        if not torch.isfinite(out["final_xs"]).all():
            raise AssertionError(f"{label}: final state not finite")
        shifted = out["shifted"].to(dev)
        summary = {
            "mean_err_m": float(errs.mean()),
            "mean_err_at_shifts_m": float(errs[shifted].mean()),
            "n_shifts": int(shifted.sum()),
            "update_ms_median": statistics.median(out["update_ms"]),
            "sqp_iters": out["sqp_iters"].tolist(),
            "pcg_iters_total": out["pcg_iters_total"].tolist(),
            "rho_bailed": int(out["rho_bailed"].sum()),
        }
        if "failed_over" in out:
            summary["failed_over"] = out["failed_over"].tolist()
        if groups:
            summary["device_ms_per_update"] = {
                k: t / 1e3 / n_updates for k, (t, _) in groups.items()}
        print(f"{label}: {json.dumps(summary)}")
        return summary, counts

    def compare(label, fused, plain, bound=True):
        # sqp_iters and rho bails must match; the CG totals are printed,
        # not compared: on fixture 0_0's condition ~1e7 systems the float32
        # trajectories part after some updates (PERF.md).  The exact-dual
        # backends track worse by design (about 0.32 m on 0_0 over a long
        # run in the JAX package), so they are held to their pair only.
        for key in ("sqp_iters", "rho_bailed"):
            if fused[key] != plain[key]:
                raise AssertionError(f"{label} {key}: fused {fused[key]} vs "
                                     f"plain {plain[key]}")
        for key in ("mean_err_m", "mean_err_at_shifts_m"):
            a, b = fused[key], plain[key]
            if bound and not (a < 0.1 and b < 0.1):
                raise AssertionError(f"{label} {key} not under 0.1 m: fused "
                                     f"{a}, plain {b}")
            if abs(a - b) > 5e-3:
                raise AssertionError(f"{label} {key}: fused {a} vs plain {b} "
                                     f"differ by more than 5e-3 m")

    plain_cfg = dataclasses.replace(cfg, fused_stages=False)
    u, s = N_UPDATES, SQP_ITERS
    none = dict.fromkeys(launch_counts(), 0)
    staged, staged_counts = run_loop(
        "staged pcg, fused", cfg, "pcg", detail=True,
        want={**none, "K1": u, "K2": u + u * s, "K3": u * s, "K4": u * s})
    compare("staged pcg", staged, run_loop("staged pcg, plain", plain_cfg,
                                           "pcg")[0])

    mega_cfg = dataclasses.replace(cfg, megakernel=True,
                                   megakernel_solve=True)
    auto, auto_counts = run_loop(
        "auto, fused", mega_cfg, "auto", detail=True,
        want={**none, "K1": u, "K2": u, "K5": u})
    auto_plain = run_loop("auto, plain", plain_cfg, "auto")[0]
    compare("auto", auto, auto_plain)
    for label, sm in (("fused", auto), ("plain", auto_plain)):
        if any(sm["failed_over"]):
            raise AssertionError(f"auto, {label}: the latch tripped on 0_0")

    trip = dict(failover_bail_rate=-1.0, failover_err_threshold_m=-1.0,
                failover_check_every=8)
    half = u // 2
    fo, fo_counts = run_loop(
        "forced failover, fused", dataclasses.replace(mega_cfg, **trip),
        "auto", detail=True,
        want={**none, "K1": u, "K2": half + half * (1 + s), "K3": half * s,
              "K5": half, "K6": half * s})
    fo_plain = run_loop("forced failover, plain",
                        dataclasses.replace(plain_cfg, **trip), "auto")[0]
    compare("forced failover", fo, fo_plain)
    for label, sm in (("fused", fo), ("plain", fo_plain)):
        if sm["failed_over"] != [False] * half + [True] * half:
            raise AssertionError(f"forced failover, {label}: failed_over "
                                 f"{sm['failed_over']}")

    # ---- 5. the multi-arm loops: the arms start from seeded perturbations
    # of the fixture start's joint positions, with the warm duals
    lam_w = warm_lam(mega_cfg, start64)
    dq = torch.as_tensor(0.02 * np.random.default_rng(11).normal(
        size=(max(SWEEP_ARMS), NX // 2)), dtype=torch.float32, device=dev)

    def run_packed(label, run_cfg, arms, n_updates, want=None,
                   detail=False):
        Xs, Us, lams = arm_starts(X, U, lam_w, dq[:arms])

        def again(n_up=n_updates, timing=False):
            return simulate_mpc_scan_packed(model, run_cfg, xu_d, ee_d, Xs,
                                            Us, lams, cfg.rho_init, tol, n_up,
                                            timing=timing)

        again(2)
        out, counts = counted(label, lambda: again(timing=True), want)
        errs = out["tracking_errors"]
        if (tuple(errs.shape) != (arms, n_updates)
                or not torch.isfinite(errs).all()
                or not torch.isfinite(out["final_xs"]).all()):
            raise AssertionError(f"{label}: tracking errors or final states "
                                 f"not finite: {errs}")
        shifted = out["shifted"].to(dev)
        summary = {
            "mean_err_m": errs.mean(1).tolist(),
            "mean_err_at_shifts_m": errs[:, shifted].mean(1).tolist(),
            "update_ms_median": statistics.median(out["update_ms"]),
            "sqp_iters": out["sqp_iters"].tolist(),
            "pcg_iters_total": out["pcg_iters_total"].tolist(),
            "rho_bailed": out["rho_bailed"].sum(1).tolist(),
        }
        print(f"{label}: {json.dumps(summary)}")
        if detail:
            t, calls = host_and_device(label, again, n_updates).get(
                "K10", (0.0, 0))
            summary["k10_device_ms"] = t / 1e3 / calls if calls else None
        return summary, counts, again

    packed, packed_counts, _ = run_packed(
        f"packed, {ARMS} arms, fused", cfg, ARMS, N_UPDATES,
        want={**none, "K1": u, "K10": u}, detail=True)
    packed_plain = run_packed(f"packed, {ARMS} arms, plain", plain_cfg, ARMS,
                              N_UPDATES, want=none)[0]
    for key in ("sqp_iters", "rho_bailed"):
        if packed[key] != packed_plain[key]:
            raise AssertionError(f"packed {key}: fused {packed[key]} vs "
                                 f"plain {packed_plain[key]}")
    for key in ("mean_err_m", "mean_err_at_shifts_m"):
        for a, (x1, x2) in enumerate(zip(packed[key], packed_plain[key])):
            if not (x1 < 0.1 and x2 < 0.1) or abs(x1 - x2) > 5e-3:
                raise AssertionError(f"packed {key} arm {a}: fused {x1} vs "
                                     f"plain {x2} (each under 0.1 m, within "
                                     f"5e-3 m)")

    Xs, Us, lams = arm_starts(X, U, lam_w, dq[:ARMS])
    simulate_mpc_scan_batched(model, cfg, xu_d, ee_d, Xs, Us, lams,
                              cfg.rho_init, tol, 2)
    batched, _ = counted(
        f"batched, {ARMS} arms (plain modules)",
        lambda: simulate_mpc_scan_batched(
            model, cfg, xu_d, ee_d, Xs, Us, lams, cfg.rho_init, tol,
            BATCHED_UPDATES, timing=True), none)
    errs = batched["tracking_errors"]
    if (tuple(errs.shape) != (ARMS, BATCHED_UPDATES)
            or not torch.isfinite(errs).all()):
        raise AssertionError(f"batched: tracking errors {errs}")
    print(f"batched, {ARMS} arms: update median "
          f"{statistics.median(batched['update_ms']):.3f} ms, mean errors "
          f"{errs.mean(1).tolist()}, sqp_iters "
          f"{batched['sqp_iters'].tolist()}")

    # arm-updates/s of the packed loop over B, and K10's device time
    sweep = []
    for arms in SWEEP_ARMS:
        sm, counts, again = run_packed(
            f"sweep, {arms} arms", cfg, arms, N_UPDATES,
            want={**none, "K1": u, "K10": u})
        # the profiler may drop a record of the cooperative launch (it
        # showed 15 of 16 once); the time per call is over those it kept
        t, calls = _by_kernel(_device_events(again)).get("K10", (0.0, 0))
        if not calls:
            raise AssertionError(f"sweep, {arms} arms: the profile shows no "
                                 f"K10 kernel")
        row = {"metric": f"iiwa_mpc_batched_throughput_n{n}_b{arms}",
               "arms": arms,
               "arm_updates_per_s": arms * 1e3 / sm["update_ms_median"],
               "update_ms_median": sm["update_ms_median"],
               "k10_device_ms": t / 1e3 / calls, "k10_profiled": calls,
               "cg_iters_per_update": statistics.mean(sm["pcg_iters_total"]),
               "grid": k10.check_mega_packed_fit(n, arms, cfg.num_alphas)}
        print(f"sweep: {json.dumps(row)}")
        sweep.append(row)

    # ---- 6. the remaining sqp_solve configurations, 8 updates each
    u8 = NEW_UPDATES
    bcr_fused, bcr_counts = run_loop(
        "staged bcr, fused", cfg, "bcr", detail=True, n_updates=u8,
        want={**none, "K1": u8, "K2": u8 + u8 * s, "K3": u8 * s,
              "K7": u8 * s})
    bcr_plain = run_loop("bcr, plain", plain_cfg, "bcr", n_updates=u8)[0]
    compare("staged bcr", bcr_fused, bcr_plain, bound=False)

    # N = 128, above K7's fit: the split path (K7s, residual, K7s); the
    # exact solve ignores lam, so no warm start
    start_l = tuple(torch.as_tensor(a, device=dev)
                    for a in horizon_slices(xu, ee, LONG_KNOTS))
    cfg_l = SolverConfig.for_knots(
        LONG_KNOTS, sqp_max_iter=SQP_ITERS, fused_stages=True,
        pcg=PCGConfig(max_iter=PCGConfig.tpu_tuned_max_iter(LONG_KNOTS)))
    long_fused, long_counts = run_loop(
        f"staged bcr N={LONG_KNOTS}, fused", cfg_l, "bcr", detail=True,
        n_updates=u8, start=start_l, warm=False,
        want={**none, "K1": u8, "K2": u8 + u8 * s, "K3": u8 * s,
              "K7s": 2 * u8 * s})
    compare(f"staged bcr N={LONG_KNOTS}", long_fused, run_loop(
        f"bcr N={LONG_KNOTS}, plain", dataclasses.replace(
            cfg_l, fused_stages=False), "bcr", n_updates=u8, start=start_l,
        warm=False)[0], bound=False)

    # the per-iteration megakernels: K2, then K9p / K9b per SQP iteration
    iter_cfg = dataclasses.replace(cfg, megakernel=True)
    pcg_plain8 = run_loop("pcg, plain", plain_cfg, "pcg", n_updates=u8)[0]
    k9p_loop, k9p_counts = run_loop(
        "pcg per-iteration megakernel, fused", iter_cfg, "pcg", detail=True,
        n_updates=u8, want={**none, "K1": u8, "K2": u8, "K9p": u8 * s})
    compare("pcg per-iteration megakernel", k9p_loop, pcg_plain8)
    k9b_loop, k9b_counts = run_loop(
        "bcr per-iteration megakernel, fused", iter_cfg, "bcr", detail=True,
        n_updates=u8, want={**none, "K1": u8, "K2": u8, "K9b": u8 * s})
    compare("bcr per-iteration megakernel", k9b_loop, bcr_plain, bound=False)

    # pcg_pallas: the plain stages on the card with K4b as the solve.  The
    # plain-stage loops are host-bound (about 10,000 small glue kernels
    # per update): the host clock only, as profiling them costs minutes
    pp_loop, pp_counts = run_loop(
        "pcg_pallas, plain stages + K4b", plain_cfg, "pcg_pallas",
        detail="host", n_updates=u8, want={**none, "K4b": u8 * s})
    compare("pcg_pallas", pp_loop, pcg_plain8)

    # the oracles: the dense Cholesky and the host LDL', each against the
    # other
    dense_loop = run_loop("dense, plain stages", plain_cfg, "dense",
                          detail="host", n_updates=u8, want=none)[0]
    qdldl_loop = run_loop("qdldl, plain stages", plain_cfg, "qdldl",
                          detail="host", n_updates=u8, want=none)[0]
    compare("dense vs qdldl", dense_loop, qdldl_loop, bound=False)

    # ---- 7. the linear-solve comparison (the reference's TIME_LINSYS,
    # settings.cuh:109-118): every backend on the slice's warm system
    lam_warm = warm_lam(cfg, start64)
    ks_w = k3.form_kkt_schur(*k3_args)
    S_w = BlockTri(ks_w.SL, ks_w.SD, ks_w.SU)
    P_w = BlockTri(ks_w.PL, ks_w.PD, ks_w.PU)
    sd_w = SchurData(S=S_w, Pinv=P_w, gamma=ks_w.gamma, Qinv=None, Rinv=None)
    solvers = {
        "pcg (K4)": lambda: k4.pcg_dz(ks_w, lam_warm, cap, tol),
        "pcg_pallas (K4b)": lambda: k4.pcg_solve(S_w, P_w, ks_w.gamma,
                                                 lam_warm, cap, tol),
        "bcr (K7)": lambda: k7.bcr_dz(ks_w),
        "bcr_pcg (K6)": lambda: k6.bcr_pcg_dz(ks_w, lam_warm, cap, tol),
        "dense (torch.linalg)": lambda: get_linsys_backend("dense")(
            None, sd_w, lam_warm, tol)}
    compare_rows = {}
    for name, solve in solvers.items():
        out = solve()
        it = out[3] if len(out) == 5 else out[1]
        compare_rows[name] = {
            "ms": _event_ms(solve), "cg_iters": int(it),
            "rel_residual": systems.relative_residual(ks_w, out[0])}
    g_norm = float(ks_w.gamma.norm())

    def median_ms(fn):
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    nb = n * NX * NX
    bands = lambda: torch.cat([ks_w.SD.reshape(-1), ks_w.SU.reshape(-1),
                               ks_w.gamma.reshape(-1)]).cpu().numpy()
    host = bands()
    csc = _btd_upper_csc(None, host[:nb].reshape(n, NX, NX),
                         host[nb:2 * nb].reshape(n, NX, NX))
    g_host = host[2 * nb:].reshape(n, NX)
    solver = _cached_solver(n, NX)
    x_host = solver.solve_csc(*csc, g_host)
    lam_q = torch.as_tensor(x_host, device=dev)
    compare_rows["qdldl (host LDL')"] = {
        "ms": median_ms(lambda: solver.solve_csc(*csc, g_host)),
        "cg_iters": 0, "rel_residual": systems.relative_residual(ks_w, lam_q),
        "d2h_ms": median_ms(bands),
        "assembly_ms": median_ms(lambda: _btd_upper_csc(
            None, host[:nb].reshape(n, NX, NX),
            host[nb:2 * nb].reshape(n, NX, NX))),
        "h2d_ms": median_ms(lambda: (torch.as_tensor(x_host, device=dev),
                                     sync()))}
    # relative residuals are against |gamma|, which is small at the
    # slice's start (a point of the reference trajectory); the absolute
    # residual is rel_residual * gamma_norm
    print(json.dumps({"linsys_compare": {
        "n": n, "system": "fixture 0_0 slice start, warm lam, rho 1e-3",
        "cap": cap, "tol": tol, "gamma_norm": g_norm,
        "solvers": compare_rows}}))

    # each kernel's launches: the first run of this slice's paths that
    # launched it (the default auto loop, its failover branch, the staged
    # loop, the packed loop, then this file's phase 6 loops)
    paths = (("auto", auto_counts), ("failover", fo_counts),
             ("staged", staged_counts), ("packed", packed_counts),
             ("staged bcr", bcr_counts),
             (f"staged bcr N={LONG_KNOTS}", long_counts),
             ("pcg per-iteration megakernel", k9p_counts),
             ("bcr per-iteration megakernel", k9b_counts),
             ("pcg_pallas", pp_counts))
    for k in kernels:
        kid = k["name"].split()[0]
        path, count = next(((p, c[kid]) for p, c in paths if c[kid]),
                           ("none", 0))
        if not count:
            raise AssertionError(f"{kid} was launched in no closed loop")
        k["launches"], k["path"] = count, path

    k10_entry = next(k for k in kernels if k["name"].startswith("K10 "))
    k10_entry["device_ms"] = packed["k10_device_ms"]
    k10_entry["sweep"] = sweep
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
