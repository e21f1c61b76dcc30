#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpcgpu_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit:

1. prints the card's name and power limit (nvidia-smi) and the versions;
2. builds the hand-written kernels (csrc/*.cu, nvcc, sm_90a) and prints
   the build time and ptxas' register / spill report;
3. checks each kernel K1-K4 against its plain PyTorch version on the card
   at the slice's N = 64 inputs from fixture 0_0, with the tolerances of
   the JAX package's own kernel tests, and times both (CUDA events,
   median after warm-up);
4. runs the slice -- fixture pair 0_0, N = 64, SolverConfig.for_knots(64,
   sqp_max_iter=4), PCG cap 40, exit tol 5e-5, lam warm-started by 5
   solves at tol 1e-11, simulate_mpc_scan for 16 control updates -- once
   through the kernels (fused_stages=True) and once through the plain
   modules, and checks tracking errors, their agreement, and the kernels'
   launch counts in the fused run; for the fused run it also prints the
   host clock per update and where the device time goes (torch.profiler);
5. prints one JSON line of the kernels, then the result line.

Any failed build, launch or check ends the run with a non-zero exit code
before the result line.  Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
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


def _device_breakdown(run, n_updates: int) -> None:
    """Print where the device time of one call of run goes: busy span and
    idle share, and device time by kernel (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not evs:
        print("profile: the profiler recorded no device events")
        return
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
    tags = {"K3": "k3_", "K4": "pcg_dz_kernel", "K2": "merit_kernel",
            "K1": "rollout_kernel"}
    groups: dict = {}
    for s, e, name in evs:
        key = next((k for k, t in tags.items() if t in name), "torch glue")
        t, n = groups.get(key, (0.0, 0))
        groups[key] = (t + e - s, n + 1)
    for key, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {key:10s} {t / 1e3:8.3f} ms  {100 * t / busy:5.1f}%  "
              f"{n:5d} device kernels  {t / n:8.2f} us each")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from mpcgpu_tpu_torch.config import (PCGConfig, SolverConfig,
                                         default_pcg_exit_tols)
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.cuda import _lib, launch_counts
    from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
    from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
    from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
    from mpcgpu_tpu_torch.ops.cuda import reset_launch_counts
    from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
    from mpcgpu_tpu_torch.sim import max_substeps_for, simulate_mpc_scan
    from mpcgpu_tpu_torch.sqp import sqp_solve
    from mpcgpu_tpu_torch.utils.trajfiles import horizon_slices, load_fixture_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

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
    _lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 3. each kernel against its plain version, slice inputs
    model = iiwa14(dev)
    xu, ee = load_fixture_pair(repo / "tests" / "fixtures", 0, 0)
    X, U, goals, xs = (torch.as_tensor(a, device=dev)
                       for a in horizon_slices(xu, ee, N_KNOTS))
    cap = PCGConfig.tpu_tuned_max_iter(N_KNOTS)
    tol = default_pcg_exit_tols(N_KNOTS)[0]
    cfg = SolverConfig.for_knots(N_KNOTS, sqp_max_iter=SQP_ITERS,
                                 pcg=PCGConfig(max_iter=cap),
                                 fused_stages=True)
    cc = cfg.cost
    rho = torch.tensor(cfg.rho_init, device=dev)
    print(f"slice: N={N_KNOTS} sqp_max_iter={SQP_ITERS} pcg cap={cap} "
          f"tol={tol:g} r_cost={cc.r_cost:g} updates={N_UPDATES}")

    kernels = []

    def record(kid, name, source, replaces, pairs, rtol, atol, run, plain):
        _assert_close(name, pairs, rtol, atol)
        err = _max_err(pairs)
        ms, plain_ms = _event_ms(run), _event_ms(plain)
        print(f"{kid} {name}: max_abs_err {err:.3e} (rtol {rtol:g}, atol "
              f"{atol:g})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms})

    k3_args = (model, X, U, goals, xs, rho, cfg.timestep, cc.qd_cost,
               cc.r_cost, cfg.gravity)
    ks = k3.form_kkt_schur(*k3_args)
    ks_ref = k3.form_kkt_schur_reference(*k3_args)
    torch.cuda.synchronize()
    record("K3", "form_kkt_schur", "mpcgpu_tpu_torch/csrc/kkt_schur.cu",
           "mpcgpu_tpu/ops/pallas/kkt_schur_kernel.py:379",
           list(zip(ks, ks_ref)), 3e-3, 3e-3,
           lambda: k3.form_kkt_schur(*k3_args),
           lambda: k3.form_kkt_schur_reference(*k3_args))

    lam0 = torch.zeros_like(X)
    k4_out = k4.pcg_dz(ks_ref, lam0, cap, tol)
    k4_ref = k4.pcg_dz_reference(ks_ref, lam0, cap, tol)
    torch.cuda.synchronize()
    it, it_ref = int(k4_out[3]), int(k4_ref[3])
    print(f"K4 CG iterations: kernel {it} (hit {bool(k4_out[4])}), plain "
          f"{it_ref} (hit {bool(k4_ref[4])}); one block serves N <= "
          f"{k4.check_pcg_smem_fit(N_KNOTS)} on this card")
    if not (abs(it - it_ref) <= 2 or it == it_ref == cap):
        raise AssertionError(f"K4 iteration counts disagree: {it} vs {it_ref}")
    record("K4", "pcg_dz", "mpcgpu_tpu_torch/csrc/pcg_dz.cu",
           "mpcgpu_tpu/ops/pallas/pcg_kernel.py:318",
           list(zip(k4_out[:3], k4_ref[:3])), 5e-3, 5e-3,
           lambda: k4.pcg_dz(ks_ref, lam0, cap, tol),
           lambda: k4.pcg_dz_reference(ks_ref, lam0, cap, tol))

    dX, dU = k4_ref[1], k4_ref[2]
    k2_args = (model, X, U, dX, dU, cfg.num_alphas, goals, xs, cfg.timestep,
               cfg.merit_mu, cc.qd_cost, cc.r_cost, cfg.gravity)
    m = k2.line_search_merits(*k2_args)
    m_ref = k2.line_search_merits_reference(*k2_args)
    torch.cuda.synchronize()
    record("K2", "line_search_merits", "mpcgpu_tpu_torch/csrc/merit.cu",
           "mpcgpu_tpu/ops/pallas/merit_kernel.py:145", [(m, m_ref)],
           2e-4, 2e-4, lambda: k2.line_search_merits(*k2_args),
           lambda: k2.line_search_merits_reference(*k2_args))

    period = cfg.simulation_period_us
    k1_args = (model, cfg, xs, U, goals[0], period, period,
               max_substeps_for(cfg))
    r = k1.plant_rollout(*k1_args)
    r_ref = k1.plant_rollout_reference(*k1_args)
    torch.cuda.synchronize()
    record("K1", "plant_rollout", "mpcgpu_tpu_torch/csrc/rollout.cu",
           "mpcgpu_tpu/ops/pallas/rollout_kernel.py:92",
           list(zip(r, r_ref)), 1e-4, 1e-5,
           lambda: k1.plant_rollout(*k1_args),
           lambda: k1.plant_rollout_reference(*k1_args))

    # ---- 4. the slice, through the kernels and through the plain modules
    xu_d = torch.as_tensor(xu, device=dev)
    ee_d = torch.as_tensor(ee, device=dev)

    def run_slice(run_cfg, count_launches: bool):
        lam = torch.zeros_like(X)
        r0 = torch.tensor(cfg.rho_init, device=dev)
        for _ in range(WARM_SOLVES):      # warm-start lam (bench.py:161-176)
            res = sqp_solve(model, run_cfg, X, U, lam, goals, xs, r0, 1e-11)
            lam, r0 = res.lam, res.rho
        simulate_mpc_scan(model, run_cfg, xu_d, ee_d, X, U, lam, rho, tol, 2)
        torch.cuda.synchronize()
        if count_launches:
            reset_launch_counts()
        out = simulate_mpc_scan(model, run_cfg, xu_d, ee_d, X, U, lam, rho,
                                tol, N_UPDATES, timing=True)
        counts = launch_counts() if count_launches else None
        if count_launches:
            def again():
                return simulate_mpc_scan(model, run_cfg, xu_d, ee_d, X, U,
                                         lam, rho, tol, N_UPDATES)

            t0 = time.perf_counter()
            again()
            t_enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t0
            print(f"fused slice host clock: enqueue {1e3 * t_enqueue / N_UPDATES:.3f}"
                  f" ms/update, to the end of the device work "
                  f"{1e3 * t_wall / N_UPDATES:.3f} ms/update")
            _device_breakdown(again, N_UPDATES)
        errs = out["tracking_errors"]
        if tuple(errs.shape) != (N_UPDATES,) or not torch.isfinite(errs).all():
            raise AssertionError(f"tracking errors not finite: {errs}")
        if not torch.isfinite(out["final_xs"]).all():
            raise AssertionError("final state not finite")
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
        return summary, counts

    fused, counts = run_slice(cfg, True)
    plain, _ = run_slice(dataclasses.replace(cfg, fused_stages=False), False)
    for label, s in (("fused", fused), ("plain", plain)):
        print(f"slice {label}: {json.dumps(s)}")
    print(f"launches in the fused run: {counts}")

    n_sqp = N_UPDATES * SQP_ITERS
    want = {"K1": N_UPDATES, "K2": N_UPDATES + n_sqp, "K3": n_sqp,
            "K4": n_sqp}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    for k in kernels:
        k["launches"] = counts[k["name"].split()[0]]
    for key in ("mean_err_m", "mean_err_at_shifts_m"):
        a, b = fused[key], plain[key]
        if not (a < 0.1 and b < 0.1):
            raise AssertionError(f"{key} not under 0.1 m: fused {a}, plain {b}")
        if abs(a - b) > 5e-3:
            raise AssertionError(f"{key}: fused {a} vs plain {b} differ by "
                                 f"more than 5e-3 m")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
