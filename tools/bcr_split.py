"""Time K7s and K9b of two checkouts of this repository on the card, and
hold their outputs against each other.

    python3 tools/bcr_split.py OTHER_CHECKOUT [--k7s 64 128 256 1024]
        [--k9b 2 4 64 256 512 1024] [--loops UPDATES] [--out DIR]

K7s (one unrefined block-cyclic-reduction solve, ``bcr_solve``) runs at
each N of --k7s on the tests' seeded well-conditioned system
(tests/torch_systems.py ``random_knot_schur``); K9b (one SQP iteration
with the refined BCR dual solve, ``sqp_iter_mega``) at each N of --k9b
from chip_smoke.py's long-horizon start (fixture 0_0's rows repeated by
np.resize, knots 1.. moved by a seeded 0.02-scale draw, rho 1e-3,
SolverConfig.for_knots(N)).  Each is timed by the profiler's device time
(the mean of the launches a profile of 5 calls kept, after a warm-up
step) and by CUDA events (median of 20 calls).  The trees run in turns
(other, this, this, other), each turn a process of its own that builds
its tree's library in its package directory; then the largest difference
of every output between the trees, and whether this tree's two turns
gave the same bits.  Also prints each tree's fits and, where the tree has
one, K7s's cluster size and K9b's cluster plan (C, grid) at each N; an N
past a tree's fit is skipped in that tree's turns.
The factor / apply split of K7s and K9b's stage 4 alone come from
tools/cluster_factor_bench.cu.

With --loops U (default 16; 0 skips them), each turn also runs the three
closed loops that launch K7, K7s and K9b, as chip_smoke.py's phase 6 runs
them (fixture 0_0, 4 SQP iterations, the fused stages): staged bcr at
N = 64 (warm duals) and at N = 128 (the split path: two K7s launches an
SQP iteration; cold duals), and the per-iteration bcr megakernel at
N = 64 (K9b).  For each: the median of U updates' CUDA-event times
(simulate_mpc_scan's update_ms), and the host clock per update of a second
run, enqueue and to the end of the device work -- so that the two trees'
loop times, which the host's enqueue bounds, compare within one call.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 20
KERNELS = {"K7s": "bcr_solve_kernel", "K9b": "sqp_iter_mega_bcr_kernel"}


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


def run_loops(tree: Path, n_updates: int, model, dev) -> dict:
    """The three bcr loops' update median and host clock (ms per update)."""
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
    for label, n, linsys, mega, warm in (
            ("staged bcr N=64", 64, "bcr", False, True),
            ("staged bcr N=128", 128, "bcr", False, False),
            ("per-iteration bcr N=64", 64, "bcr", True, True)):
        X, U, goals, xs = (torch.as_tensor(a, device=dev)
                           for a in horizon_slices(xu, ee, n))
        cfg = SolverConfig.for_knots(
            n, sqp_max_iter=4, fused_stages=True,
            pcg=PCGConfig(max_iter=PCGConfig.tpu_tuned_max_iter(n)))
        cfg = dataclasses.replace(cfg, megakernel=mega)
        tol = default_pcg_exit_tols(n)[0]
        rho = torch.tensor(cfg.rho_init, device=dev)
        lam = torch.zeros_like(X)
        if warm:        # as chip_smoke.py's warm_lam
            r0 = rho
            for _ in range(5):
                res = sqp_solve(model, cfg, X, U, lam, goals, xs, r0, 1e-11)
                lam, r0 = res.lam, res.rho

        def go(timing=False):
            return simulate_mpc_scan(model, cfg, *traj, X, U, lam, rho, tol,
                                     n_updates, linsys, timing=timing)

        simulate_mpc_scan(model, cfg, *traj, X, U, lam, rho, tol, 2, linsys)
        out = go(timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        go()
        t_enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_end = time.perf_counter() - t0
        rows[label] = {
            "update_ms_median": statistics.median(out["update_ms"]),
            "enqueue_ms": 1e3 * t_enq / n_updates,
            "to_end_ms": 1e3 * t_end / n_updates}
    return rows


def run_tree(tree: Path, k7s_knots, k9b_knots, out: Path,
             loops: int = 0) -> None:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from mpcgpu_tpu_torch.config import SolverConfig
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.cuda import _lib
    from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k7
    from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k9
    from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

    assert Path(k9.__file__).resolve().is_relative_to(tree.resolve())
    spec = importlib.util.spec_from_file_location(
        "_torch_systems", tree / "tests" / "torch_systems.py")
    systems = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(systems)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = _lib.library()
    res, rows = {}, {}
    fits = {"K7s N max": lib.mpc_bcr_solve_max_knots(),
            "K9b N max": lib.mpc_mega_max_knots(k9.ITER_BCR)}

    def timed(kid, n, go, extra):
        out = go()
        torch.cuda.synchronize()
        rows[f"{kid} N={n}"] = {
            "device_us": _device_us(go, KERNELS[kid]),
            "event_ms": _event_ms(go), **extra}
        return out

    for n in k7s_knots:
        ks = systems.random_knot_schur(n, device=dev)
        args = (ks.SL, ks.SD, ks.SU, ks.gamma)
        extra = {}
        if hasattr(lib, "mpc_bcr_solve_cluster"):
            extra["cluster"] = lib.mpc_bcr_solve_cluster(n, 0)
        res[f"K7s N={n} lam"] = timed("K7s", n, lambda: k7.bcr_solve(*args),
                                      extra).cpu()

    model = iiwa14(device=dev)
    xu, ee = load_fixture_pair(tree / "tests" / "fixtures", 0, 0)
    for n in k9b_knots:
        if n > fits["K9b N max"]:
            rows[f"K9b N={n}"] = {"skipped": "past this tree's fit"}
            continue
        rows_i = np.resize(np.arange(xu.shape[0]), n)
        pert = 0.02 * np.random.default_rng(5).normal(size=(n, 14))
        pert[0] = 0.0
        card = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        X = card((xu[rows_i, :14] + pert).astype(np.float32))
        U, goals, xs = (card(xu[rows_i[:-1], 14:]), card(ee[rows_i]),
                        card(xu[0, :14]))
        cfg = SolverConfig.for_knots(n, sqp_max_iter=4)
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
        a9 = (model, X, U, goals, xs, torch.tensor(cfg.rho_init, device=dev),
              torch.tensor(1.0, device=dev), m0)
        plan = (ctypes.c_int * 3)()
        extra = {"grid": lib.mpc_mega_grid(n, k9.ITER_BCR)}
        if lib.mpc_mega_cluster_plan(n, k9.ITER_BCR, 0, -1, plan):
            extra["plan (C, -, grid)"] = tuple(plan)
        o = timed("K9b", n, lambda: k9.sqp_iter_mega(*a9, **kw), extra)
        for f in o._fields:
            res[f"K9b N={n} {f}"] = getattr(o, f).cpu()
    if loops:
        for key, row in run_loops(tree, loops, model, dev).items():
            rows[f"loop {key}"] = row
    torch.save({"res": res, "rows": rows, "fits": fits,
                "device": torch.cuda.get_device_name(0)}, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--k7s", type=int, nargs="*", default=[64, 128, 256, 1024])
    ap.add_argument("--k9b", type=int, nargs="*", default=[2, 4, 64, 256, 512, 1024])
    ap.add_argument("--loops", type=int, default=16)
    ap.add_argument("--out", type=Path, default=Path("build") / "bcr_split")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run is not None:
        run_tree(a.run, a.k7s, a.k9b, a.save, a.loops)
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
        save = a.out / f"bcr_{i}_{label}.pt"
        subprocess.run([sys.executable, __file__, str(a.other), "--run",
                        str(tree), "--save", str(save), "--loops",
                        str(a.loops), "--k7s", *map(str, a.k7s), "--k9b",
                        *map(str, a.k9b)],
                       check=True)
        r = torch.load(save)
        runs.append(r)
        print(f"turn {i} ({label}, {tree}) on {r['device']}: fits {r['fits']}")
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
