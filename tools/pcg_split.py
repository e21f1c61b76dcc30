"""Time K4, K4b, K4g and K4bg of two checkouts of this repository on the
card, split each into its CG steps and the rest, and hold their outputs
against each other.

    python3 tools/pcg_split.py OTHER_CHECKOUT [--knots 64 128 256 512 656
        1024] [--sweep] [--loops UPDATES] [--out DIR]

At each N: K3's system (the card's K3) at chip_smoke.py's long-horizon
start (fixture 0_0's rows repeated by np.resize, knots 1.. moved by a
seeded 0.02-scale draw, rho 1e-3, SolverConfig.for_knots(N)), cold duals,
the PCG cap of PCGConfig.tpu_tuned_max_iter(N) and exit tol
default_pcg_exit_tols(N)[0] (at N = 64 the slice's cap 40, tol 5e-5),
where every CG stops at the cap.  Through each tree's wrappers pcg_dz
(K4), pcg_solve (K4b), pcg_dz_grid (K4g) and pcg_solve_grid (K4bg), each
labelled by the kernel it launched: one call at the cap and one with the
CG capped at 0 (the band loads, the first residual and apply, and dz),
each timed by the profiler's device time (the mean of the launches a
profile of 5 calls kept, after a warm-up step) and by CUDA events (median
of 20 calls); a CG step is the difference over the steps run.  The trees
run in turns (other, this, this, other), each turn a process of its own
that builds its tree's library in its package directory; then the
largest difference of every output between the trees, and whether this
tree's two turns gave the same bits.

With --sweep, a tree that has the plan (pcg_kernel.pcg_plan) also times
a CG step of K4 in the cluster form at every cluster size and place the
card admits and in the joined form at C = 16 and 8 on 1, 2, 3, 4, 6, 8,
12, 16, 21, 24, 32 and 45 clusters (where admitted): the measurement behind the
plan's cut between the forms and its number of clusters.

With --loops U (default 16; 0 skips them), each turn also runs the loops
that launch K4 and K4b as chip_smoke.py's phase 6 and 8 run them (fixture
0_0, 4 SQP iterations, warm duals): staged pcg (K3, K4 or K4g, K2 per SQP
iteration) and pcg_pallas (the plain stages with K4b or K4bg) at N = 64
and 256 (pcg_pallas over U / 2 updates).  For each: the median of the
updates' CUDA-event times (simulate_mpc_scan's update_ms), the host clock
per update of a second run (enqueue, and to the end of the device work),
and for staged pcg the device time per update of the K4 family's kernels
and of all kernels (a profile of the second run).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 20
# every K4-family kernel of either tree: a call launches one of them
NAMES = ("pcg_dz_kernel", "pcg_solve_kernel", "pcg_dz_grid_kernel",
         "pcg_solve_grid_kernel", "pcg_dz_cluster_kernel",
         "pcg_solve_cluster_kernel", "pcg_dz_joined_kernel",
         "pcg_solve_joined_kernel")


def _event_ms(fn, reps=REPS, warmup=3):
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


def _profile(fn, steps=2):
    """Device events of the last of `steps` profiler steps of fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=steps - 1, active=1,
                                   repeat=1)) as prof:
        for _ in range(steps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "Profiler" not in e.name]


def _device_us(fn, calls=5, tries=3):
    """The profiler's mean device time (us) of the K4-family launches of a
    profile of `calls` calls of fn, or None."""
    for _ in range(tries):
        ts = [t for name, t in _profile(lambda: [fn() for _ in range(calls)])
              if any(n in name for n in NAMES)]
        if ts:
            return sum(ts) / len(ts)
    return None


def _counts(wrappers):
    return {kid: fn.launches for kid, fn in wrappers.items()}


def run_loops(tree: Path, n_updates: int, model, dev) -> dict:
    """The staged pcg and pcg_pallas loops at N = 64 and 256."""
    import dataclasses
    import time

    import torch

    from mpcgpu_tpu_torch.config import (PCGConfig, SolverConfig,
                                         default_pcg_exit_tols)
    from mpcgpu_tpu_torch.sim import simulate_mpc_scan
    from mpcgpu_tpu_torch.sqp import sqp_solve
    from mpcgpu_tpu_torch.utils.trajfiles import (horizon_slices,
                                                  load_fixture_pair)

    xu, ee = load_fixture_pair(tree / "tests" / "fixtures", 0, 0)
    traj = (torch.as_tensor(xu, device=dev), torch.as_tensor(ee, device=dev))
    rows = {}
    for label, n, linsys, fused, updates in (
            ("staged pcg N=64", 64, "pcg", True, n_updates),
            ("staged pcg N=256", 256, "pcg", True, n_updates),
            ("pcg_pallas N=64", 64, "pcg_pallas", False, n_updates // 2),
            ("pcg_pallas N=256", 256, "pcg_pallas", False, n_updates // 2)):
        X, U, goals, xs = (torch.as_tensor(a, device=dev)
                           for a in horizon_slices(xu, ee, n))
        cap = 40 if n == 64 else PCGConfig.tpu_tuned_max_iter(n)
        cfg = SolverConfig.for_knots(n, sqp_max_iter=4, fused_stages=fused,
                                     pcg=PCGConfig(max_iter=cap))
        cfg = dataclasses.replace(cfg, megakernel=False)
        tol = 5e-5 if n == 64 else default_pcg_exit_tols(n)[0]
        rho = torch.tensor(cfg.rho_init, device=dev)
        lam, r0 = torch.zeros_like(X), rho
        for _ in range(5):      # warm duals, as chip_smoke.py's warm_lam
            res = sqp_solve(model, cfg, X, U, lam, goals, xs, r0, 1e-11)
            lam, r0 = res.lam, res.rho

        def go(timing=False):
            return simulate_mpc_scan(model, cfg, *traj, X, U, lam, rho, tol,
                                     updates, linsys, timing=timing)

        simulate_mpc_scan(model, cfg, *traj, X, U, lam, rho, tol, 2, linsys)
        out = go(timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        go()
        t_enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_end = time.perf_counter() - t0
        row = {"update_ms_median": statistics.median(out["update_ms"]),
               "enqueue_ms": 1e3 * t_enq / updates,
               "to_end_ms": 1e3 * t_end / updates}
        if linsys == "pcg":
            evs = _profile(go)
            k4 = [t for name, t in evs if any(m in name for m in NAMES)]
            row.update({
                "device_ms_per_update": 1e-3 * sum(t for _, t in evs) / updates,
                "k4_family_ms_per_update": 1e-3 * sum(k4) / updates,
                "k4_family_us_per_call": sum(k4) / len(k4) if k4 else None})
        rows[label] = row
    return rows


def run_tree(tree: Path, knots, sweep: bool, loops: int, out: Path) -> None:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from mpcgpu_tpu_torch.config import (PCGConfig, SolverConfig,
                                         default_pcg_exit_tols)
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.btridiag import BlockTri
    from mpcgpu_tpu_torch.ops.cuda import _lib
    from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
    from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
    from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

    assert Path(k4.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = iiwa14(device=dev)
    lib = _lib.library()
    wrappers = {"K4": k4.pcg_dz, "K4b": k4.pcg_solve, "K4g": k4.pcg_dz_grid,
                "K4bg": k4.pcg_solve_grid}
    xu, ee = load_fixture_pair(tree / "tests" / "fixtures", 0, 0)
    res, rows = {}, {}
    for n in knots:
        rows_i = np.resize(np.arange(xu.shape[0]), n)
        pert = 0.02 * np.random.default_rng(5).normal(size=(n, 14))
        pert[0] = 0.0
        card = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        X = card((xu[rows_i, :14] + pert).astype(np.float32))
        U, goals = card(xu[rows_i[:-1], 14:]), card(ee[rows_i])
        cfg = SolverConfig.for_knots(n, sqp_max_iter=4)
        cc = cfg.cost
        ks = k3.form_kkt_schur(model, X, U, goals, X[0].clone(),
                               torch.tensor(cfg.rho_init, device=dev),
                               cfg.timestep, cc.qd_cost, cc.r_cost,
                               cfg.gravity)
        S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
        lam0 = torch.zeros_like(X)
        cap = 40 if n == 64 else PCGConfig.tpu_tuned_max_iter(n)
        tol = 5e-5 if n == 64 else default_pcg_exit_tols(n)[0]
        calls = {"K4": lambda c: k4.pcg_dz(ks, lam0, c, tol),
                 "K4b": lambda c: k4.pcg_solve(S, P, ks.gamma, lam0, c, tol),
                 "K4g": lambda c: k4.pcg_dz_grid(ks, lam0, c, tol),
                 "K4bg": lambda c: k4.pcg_solve_grid(S, P, ks.gamma, lam0, c,
                                                     tol)}
        if sweep and hasattr(k4, "pcg_plan"):
            for c in (16, 8):
                for place in (3, 2):
                    plan = k4.pcg_plan(n, lib, True, k4.CLUSTER, c, place)
                    if plan.form:
                        calls[f"K4 cluster {tuple(plan)}"] = (
                            lambda cp, plan=plan: k4._launch(
                                lib, ks, lam0, cp, tol, _lib.stream_of(X),
                                plan))
                for g in (1, 2, 3, 4, 6, 8, 12, 16, 21, 24, 32, 45):
                    # the most on chip of the places the card takes
                    plan = next((k4.PcgPlan(k4.JOINED, c, g, place, c * g)
                                 for place in (3, 2, 1, 0) if c * g <= n
                                 and _takes(lib, ks, lam0, k4.PcgPlan(
                                     k4.JOINED, c, g, place, c * g))), None)
                    if plan is not None:
                        calls[f"K4 joined {tuple(plan)}"] = (
                            lambda cp, plan=plan: k4._launch(
                                lib, ks, lam0, cp, tol, _lib.stream_of(X),
                                plan))
        for kid, go in calls.items():
            before = _counts(wrappers)
            o = go(cap)
            after = _counts(wrappers)
            ran = [k for k in wrappers if after[k] != before[k]]
            label = f"{kid} ({ran[0]})" if ran and ran[0] != kid else kid
            its = int(o[-2])
            full = _device_us(lambda: go(cap))
            base = _device_us(lambda: go(0))
            ms, ms0 = _event_ms(lambda: go(cap)), _event_ms(lambda: go(0))
            rows[f"{label} N={n}"] = {
                "cg_steps": its, "device_us": full, "cap0_device_us": base,
                "cg_step_us": (None if full is None or base is None or not its
                               else (full - base) / its),
                "event_ms": ms, "event_ms_cap0": ms0,
                "cg_step_us_events": 1e3 * (ms - ms0) / its if its else None}
            if " " not in kid:
                for i, t in enumerate(o):
                    res[f"{kid} N={n} out{i}"] = t.cpu()
        if hasattr(k4, "pcg_plan"):
            rows[f"plan N={n}"] = {
                "K4": tuple(k4.pcg_plan(n, lib, True)),
                "K4b": tuple(k4.pcg_plan(n, lib, False)),
                "K4g": tuple(k4.pcg_plan(n, lib, True, k4.JOINED)),
                "K4bg": tuple(k4.pcg_plan(n, lib, False, k4.JOINED))}
    if loops:
        for key, row in run_loops(tree, loops, model, dev).items():
            rows[f"loop {key}"] = row
    torch.save({"res": res, "rows": rows,
                "device": torch.cuda.get_device_name(0)}, out)


def _takes(lib, ks, lam0, plan) -> bool:
    """Whether the card takes a launch at the plan's form, C, G and place:
    a launch with the CG capped at 0 is not refused."""
    from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4

    try:
        k4._launch(lib, ks, lam0, 0, 1.0, None, plan)
    except RuntimeError:
        return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--knots", type=int, nargs="+",
                    default=[64, 128, 256, 512, 656, 1024])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--loops", type=int, default=16)
    ap.add_argument("--out", type=Path, default=Path("build") / "pcg_split")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run is not None:
        run_tree(a.run, a.knots, a.sweep, a.loops, a.save)
        return 0
    import torch

    this = Path(__file__).resolve().parents[1]
    a.out.mkdir(parents=True, exist_ok=True)
    order = [("other", a.other), ("this", this), ("this", this),
             ("other", a.other)]
    if a.other.resolve() == this:
        order = order[:1]
    runs = []
    for i, (label, tree) in enumerate(order):
        save = a.out / f"pcg_{i}_{label}.pt"
        subprocess.run([sys.executable, __file__, str(a.other), "--run",
                        str(tree), "--save", str(save), "--loops",
                        str(a.loops), "--knots", *map(str, a.knots),
                        *(["--sweep"] if a.sweep else [])],
                       check=True)
        r = torch.load(save)
        runs.append(r)
        print(f"turn {i} ({label}, {tree}) on {r['device']}:")
        for key, row in r["rows"].items():
            print(f"  {key}: {row}")
    if len(runs) < 4:
        return 0
    other, mine = runs[0]["res"], runs[1]["res"]
    print("largest |this - other| per output (other's largest |entry|):")
    for key, want in other.items():
        d = float((mine[key].double() - want.double()).abs().max())
        print(f"  {key:22s} {d:.3e}  ({float(want.double().abs().max()):.3e})"
              f"{'  bit-equal' if torch.equal(mine[key], want) else ''}")
    same = all(torch.equal(runs[1]["res"][k], runs[2]["res"][k]) for k in mine)
    print(f"this tree's two turns bit-equal: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
