"""Time the horizon-sharded CG with K11 (pcg_sharded_cuda) and the
knot-sharded closed loop of two checkouts of this repository on the card,
and hold their outputs against each other.

    python3 tools/sharded_split.py OTHER_CHECKOUT [--knots 512]
        [--shards 8] [--caps 16 400] [--updates 3] [--out DIR]

Each turn (other, this, this, other) is a process of its own that builds
its tree's library in its package directory and runs, on an in-process
mesh of --shards shards of one card (chip_smoke.py's phase 9):

* pcg_sharded_cuda at N = --knots on the JAX parallel test's seeded random
  system with the stair (tests/torch_systems.py random_system, seed 7),
  from zero duals at each CG cap of --caps (exit tol 1e-10: 16 runs to
  the cap, 400 to convergence): CUDA-event ms per solve (median of 5 after
  a warm-up), the host's enqueue ms per solve, K11 launches per solve (the
  wrapper's count), and the profiler's K11 device time per launch and per
  solve with the device kernels a solve runs;
* the knot-sharded closed loop (simulate_mpc_scan_sharded with K11's CG,
  fixture 0_0's rows repeated by np.resize, knots 1.. moved by a seeded
  0.02-scale draw, SolverConfig.for_knots(N, sqp_max_iter=2), cap 8,
  --updates updates): host ms per update to the end of the device work
  (a second run after one to warm up) and K11 launches per update.

Then the largest difference of every output between the trees (lam and
the CG counts of each solve, the loop's final state and tracking errors),
and whether this tree's two turns gave the same bits.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path


def run_tree(tree: Path, knots: int, shards: int, caps, updates: int,
             out: Path) -> None:
    sys.path.insert(0, str(tree))
    import importlib.util

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.btridiag import BlockTri
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11
    from mpcgpu_tpu_torch.parallel.pcg_sharded_cuda import pcg_sharded_cuda
    from mpcgpu_tpu_torch.parallel.sharded import (horizon_mesh,
                                                   register_sharded_pcg,
                                                   simulate_mpc_scan_sharded)
    from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

    assert Path(k11.__file__).resolve().is_relative_to(tree.resolve())
    spec = importlib.util.spec_from_file_location(
        "_torch_systems", tree / "tests" / "torch_systems.py")
    systems = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(systems)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    mesh = horizon_mesh(shards, device=dev)
    res, rows = {}, {}

    def profiled(fn):
        """(K11 device us per launch, device us of one call, device
        kernels of one call) from a profile after a warm-up step."""
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                sync()
                prof.step()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
        k = [e.time_range.end - e.time_range.start for e in evs
             if "spmv_halo_kernel" in e.name]
        return (sum(k) / len(k) if k else None,
                sum(e.time_range.end - e.time_range.start for e in evs),
                len(evs))

    sysd = {f: torch.as_tensor(v, device=dev) for f, v in
            systems.random_system(knots, seed=7, precond=True).items()}
    S = BlockTri(sysd["SL"], sysd["SD"], sysd["SU"])
    P = BlockTri(sysd["PL"], sysd["PD"], sysd["PU"])
    lam0 = torch.zeros_like(sysd["gamma"])
    for cap in caps:
        solve = lambda c=cap: pcg_sharded_cuda(mesh, S, P, sysd["gamma"],
                                               lam0, c, 1e-10)
        lam, iters, hit = solve()
        sync()
        k11.spmv_halo.launches = 0
        solve()
        launches = k11.spmv_halo.launches
        times, enq = [], []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            sync()
            t0 = time.perf_counter()
            a.record()
            solve()
            b.record()
            enq.append(1e3 * (time.perf_counter() - t0))
            b.synchronize()
            times.append(a.elapsed_time(b))
        k11_us, dev_us, kernels = profiled(solve)
        rows[f"CG N={knots} cap={cap}"] = {
            "ms_per_solve": statistics.median(times),
            "enqueue_ms": statistics.median(enq), "cg_iters": int(iters),
            "k11_launches": launches, "k11_device_us": k11_us,
            "k11_device_us_per_solve": (None if k11_us is None
                                        else k11_us * launches),
            "device_us_per_solve": dev_us, "device_kernels": kernels}
        res[f"CG cap={cap} lam"] = lam.cpu()
        res[f"CG cap={cap} iters"] = iters.cpu()

    xu, ee = load_fixture_pair(tree / "tests" / "fixtures", 0, 0)
    rows_i = np.resize(np.arange(xu.shape[0]), knots)
    pert = 0.02 * np.random.default_rng(5).normal(size=(knots, 14))
    pert[0] = 0.0
    card = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    X = card((xu[rows_i, :14] + pert).astype(np.float32))
    U = card(xu[rows_i[:-1], 14:])
    cfg = SolverConfig.for_knots(knots, sqp_max_iter=2,
                                 pcg=PCGConfig(max_iter=8))
    name = register_sharded_pcg(mesh, fused=True)
    loop = lambda: simulate_mpc_scan_sharded(
        iiwa14(device=dev), cfg, mesh, card(xu), card(ee), X, U,
        torch.zeros_like(X), cfg.rho_init, 1e-5, updates, name)
    loop()
    sync()
    k11.spmv_halo.launches = 0
    t0 = time.perf_counter()
    o = loop()
    sync()
    rows[f"knot-sharded loop N={knots}"] = {
        "host_ms_per_update": 1e3 * (time.perf_counter() - t0) / updates,
        "k11_launches_per_update": k11.spmv_halo.launches / updates}
    for f in ("final_xs", "tracking_errors", "pcg_iters_total"):
        res[f"loop {f}"] = o[f].cpu()
    torch.save({"res": res, "rows": rows,
                "device": torch.cuda.get_device_name(0)}, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--knots", type=int, default=512)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--caps", type=int, nargs="*", default=[16, 400])
    ap.add_argument("--updates", type=int, default=3)
    ap.add_argument("--out", type=Path, default=Path("build") / "sharded")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run is not None:
        run_tree(a.run, a.knots, a.shards, a.caps, a.updates, a.save)
        return 0
    import torch

    this = Path(__file__).resolve().parents[1]
    a.out.mkdir(parents=True, exist_ok=True)
    order = [("other", a.other), ("this", this), ("this", this),
             ("other", a.other)]
    runs = []
    for i, (label, tree) in enumerate(order):
        save = a.out / f"sharded_{i}_{label}.pt"
        subprocess.run([sys.executable, __file__, str(a.other), "--run",
                        str(tree), "--save", str(save), "--knots",
                        str(a.knots), "--shards", str(a.shards), "--caps",
                        *map(str, a.caps), "--updates", str(a.updates)],
                       check=True)
        r = torch.load(save)
        runs.append(r)
        print(f"turn {i} ({label}, {tree}) on {r['device']}:")
        for key, row in r["rows"].items():
            print(f"  {key}: {row}")
    other, mine = runs[0]["res"], runs[1]["res"]
    print("largest |this - other| per output (other's largest |entry|):")
    for key, want in other.items():
        d = float((mine[key].double() - want.double()).abs().max())
        print(f"  {key:26s} {d:.3e}  ({float(want.double().abs().max()):.3e})"
              f"{'  bit-equal' if torch.equal(mine[key], want) else ''}")
    same = all(torch.equal(runs[1]["res"][k], runs[2]["res"][k]) for k in mine)
    print(f"this tree's two turns bit-equal: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
