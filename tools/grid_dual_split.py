"""Time K5g and K9pg of two checkouts of this repository on the card, and
split each into its stages and its CG steps.

    python3 tools/grid_dual_split.py OTHER_CHECKOUT [--knots 1024]
        [--sizes 8 4] [--out DIR]

At each N, chip_smoke.py's long-horizon inputs (fixture 0_0's rows
repeated by np.resize, knots 1.. moved by a seeded 0.02-scale draw, cold
duals, rho 1e-3, SolverConfig.for_knots(N) with the PCG cap of
PCGConfig.tpu_tuned_max_iter(N) and exit tol default_pcg_exit_tols(N)[0],
4 SQP iterations): one K5g launch at the cap and one with the CG capped at
0 (the stages, with the first residual and apply and dz), one K9pg launch
(the first SQP iteration) the same way.  Each is timed by the profiler's
device time (the mean of the launches a profile of 5 calls kept) and by
CUDA events (median of 20 calls); a CG step is the difference over the
steps run.  The trees run in turns (other, this, this, other), each turn a
process of its own that builds its tree's library in its package
directory.  Also prints each tree's grid and, where the tree has one, its
dual-solve plan (grid_plan), and then times K5g the same way at each
cluster size of --sizes that the plan admits.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 20
KERNELS = {"K5g": "sqp_mega_grid_kernel",
           "K9pg": "sqp_iter_mega_pcg_grid_kernel"}


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


def _device_us(fn, name, calls=5, tries=3):
    """The profiler's mean device time (us) of the kernels named `name` over
    a profile of `calls` calls (after a warm-up step), or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ts = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name and "Profiler" not in e.name]
        if ts:
            return sum(ts) / len(ts)
    return None


def run_tree(tree: Path, knots, sizes, out: Path) -> None:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from mpcgpu_tpu_torch.config import (PCGConfig, SolverConfig,
                                         default_pcg_exit_tols)
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.cuda import _lib
    from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
    from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

    assert Path(k5.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = iiwa14(device=dev)
    lib = _lib.library()
    xu, ee = load_fixture_pair(tree / "tests" / "fixtures", 0, 0)
    rows_out = {}
    for n in knots:
        rows = np.resize(np.arange(xu.shape[0]), n)
        pert = 0.02 * np.random.default_rng(5).normal(size=(n, 14))
        pert[0] = 0.0
        card = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        X = card((xu[rows, :14] + pert).astype(np.float32))
        U, goals, xs = card(xu[rows[:-1], 14:]), card(ee[rows]), card(xu[0, :14])
        cfg = SolverConfig.for_knots(
            n, sqp_max_iter=4, fused_stages=True,
            pcg=PCGConfig(max_iter=PCGConfig.tpu_tuned_max_iter(n)))
        cc = cfg.cost
        kw = dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
                  gravity=cfg.gravity, mu=cfg.merit_mu,
                  num_alphas=cfg.num_alphas, rho_factor=cfg.rho_factor,
                  rho_min=cfg.rho_min, rho_max=cfg.rho_max,
                  rho_reset=cfg.rho_reset)
        m0 = k2.line_search_merits_reference(
            model, X, U, torch.zeros_like(X), torch.zeros_like(U),
            cfg.num_alphas, goals, xs, cfg.timestep, cfg.merit_mu, cc.qd_cost,
            cc.r_cost, cfg.gravity)[cfg.num_alphas]
        cap, tol = cfg.pcg.max_iter, default_pcg_exit_tols(n)[0]
        rho, lam0 = torch.tensor(cfg.rho_init, device=dev), torch.zeros_like(X)
        one = torch.tensor(1.0, device=dev)
        row = {"cap": cap, "tol": tol,
               "grid K5g": lib.mpc_mega_grid(n, k5.SOLVE_PCG_GRID),
               "grid K9pg": lib.mpc_mega_grid(n, k5.ITER_PCG_GRID)}
        runs = {}
        for kid in ("K5g", "K9pg"):
            def go(c, kid=kid):
                if kid == "K5g":
                    return k5.sqp_solve_mega_pcg_grid(
                        model, X, U, goals, xs, lam0, rho, 1.0, m0, c, tol, 4,
                        **kw)
                return k5.sqp_iter_mega_pcg_grid(model, X, U, goals, xs, lam0,
                                                 rho, one, m0, c, tol, **kw)
            runs[kid] = go
        if hasattr(lib, "mpc_mega_grid_plan"):
            plan = (ctypes.c_int * 4)()
            lib.mpc_mega_grid_plan(n, 0, -1, plan)
            row["plan (C, G, place, grid)"] = tuple(plan)
            tab = _lib.model_tables(model)
            for size in sizes:
                lib.mpc_mega_grid_plan(n, size, -1, plan)
                if plan[3] < 1:
                    continue

                def go(c, size=size, grid=plan[3]):
                    return k5._launch(lib, tab, X, U, goals, xs, lam0, rho,
                                      1.0, m0, c, tol, 4, **kw, grid=grid,
                                      stream=_lib.stream_of(X),
                                      kind=k5.SOLVE_PCG_GRID, cluster=size)
                runs[f"K5g C = {size}, plan {tuple(plan)}"] = go
        for kid, go in runs.items():
            its = int(go(cap).pcg_iters.clamp(min=0).sum())
            full = _device_us(lambda: go(cap), KERNELS[kid[:4].strip()])
            base = _device_us(lambda: go(0), KERNELS[kid[:4].strip()])
            ms, ms0 = _event_ms(lambda: go(cap)), _event_ms(lambda: go(0))
            row[kid] = {
                "cg_steps": its, "device_us": full, "stages_us": base,
                "cg_step_us": (None if full is None or base is None or not its
                               else (full - base) / its),
                "event_ms": ms, "event_ms_cap0": ms0,
                "cg_step_us_events": 1e3 * (ms - ms0) / its if its else None}
        rows_out[n] = row
    torch.save({"rows": rows_out, "device": torch.cuda.get_device_name(0)},
               out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--knots", type=int, nargs="+", default=[1024])
    ap.add_argument("--sizes", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path, default=Path("build") / "grid_split")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run is not None:
        run_tree(a.run, a.knots, a.sizes, a.save)
        return 0
    import torch

    this = Path(__file__).resolve().parents[1]
    a.out.mkdir(parents=True, exist_ok=True)
    order = [("other", a.other), ("this", this), ("this", this),
             ("other", a.other)]
    if a.other.resolve() == this:
        order = order[:1]
    for i, (label, tree) in enumerate(order):
        save = a.out / f"split_{i}_{label}.pt"
        subprocess.run([sys.executable, __file__, str(a.other), "--run",
                        str(tree), "--save", str(save), "--knots",
                        *map(str, a.knots), "--sizes", *map(str, a.sizes)],
                       check=True)
        r = torch.load(save)
        print(f"turn {i} ({label}, {tree}) on {r['device']}:")
        for n, row in r["rows"].items():
            print(f"  N = {n}: {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
