"""Hold K1, K2, K3, K5, K9p, K9b, K5g, K9pg, K6, K7, K7s, K10, K4, K4b, K4g,
K4bg and K11 of two checkouts of this repository against each other on the
card: the same seeded inputs through each tree's wrappers, the largest
difference of every output, and each kernel's CUDA-event time in turns
(other, this, this, other), each turn a process of its own.

    python3 tools/compare_trees.py OTHER_CHECKOUT [--changed K4 K4b ...]
        [--out DIR]

Each tree builds its own library in its own package directory.  Inputs:
fixture 0_0's first N knots (N = 64 and 256 for K2, K3 and K5; K1 at 64),
for K2 the step of chip_smoke.py's check (the plain K3 and K4's dX, dU at
cold duals; the step itself is compared too) and a seeded 0.05-scale step,
a seeded 0.02-scale perturbation for K5's start (cold duals, rho 1e-3, cap
40, 4 SQP iterations; K9p, K9b and K9pg one iteration from it, K5g the
whole solve), K6, K7s (and K7 at N = 64) on K3's system without the
stair and K4, K4b, K4g, K4bg on K3's (cold duals, cap 40),
K10 at N = 64 on two arms (K5's start and a second seeded perturbation),
K11 on seeded random bands of 64 rows with nonzero halo rows, and K1 at
the three offsets of the host tests.
Also prints both libraries' fits and grids (K5, K9p, K9b, K10; K5, K5g,
K9pg and K9b's grids at N = 64-1024).  The kernels of --changed (by
default K4, K4b, K4g and K4bg) are reported with their differences and
CG counts in both trees; every other output must be bit-equal, or the
run exits with 1.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 20


def packed_grid(lib, n, b):
    """The grid of K10's planned launch (0 past every fit): the plan's
    where the library has one, else its grid entry (before the cluster
    form)."""
    if not hasattr(lib, "mpc_mega_packed_plan"):
        return lib.mpc_mega_packed_grid(n, b, 8)
    plan = (ctypes.c_int * 3)()
    return plan[2] if lib.mpc_mega_packed_plan(n, b, 8, 0, -1, plan) else 0


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


def run_tree(tree: Path, out: Path) -> None:
    """Run K1, K3 and K5 of the checkout at tree; save outputs and times."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.btridiag import BlockTri
    from mpcgpu_tpu_torch.ops.cuda import bcr_kernel as k6
    from mpcgpu_tpu_torch.ops.cuda import kkt_schur_kernel as k3
    from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
    from mpcgpu_tpu_torch.ops.cuda import pcg_kernel as k4
    from mpcgpu_tpu_torch.ops.cuda import rollout_kernel as k1
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
    from mpcgpu_tpu_torch.sim import max_substeps_for
    from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

    assert Path(k3.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = iiwa14(device=dev)
    xu, ee = load_fixture_pair(tree / "tests" / "fixtures", 0, 0)
    res, times = {}, {}

    for n in (64, 256):
        rows = np.resize(np.arange(xu.shape[0]), n)
        X = torch.as_tensor(np.ascontiguousarray(xu[rows, :14]), device=dev)
        U = torch.as_tensor(np.ascontiguousarray(xu[rows[:-1], 14:]),
                            device=dev)
        goals = torch.as_tensor(np.ascontiguousarray(ee[rows]), device=dev)
        xs = X[0].clone()
        cfg = SolverConfig.for_knots(n, sqp_max_iter=4,
                                     pcg=PCGConfig(max_iter=40))
        cc = cfg.cost
        rho = torch.tensor(cfg.rho_init, device=dev)
        a = (model, X, U, goals, xs, rho, cfg.timestep, cc.qd_cost,
             cc.r_cost, cfg.gravity)
        ks = k3.form_kkt_schur(*a)
        for f, t in zip(k3.KnotSchur._fields, ks):
            res[f"K3 N={n} {f}"] = t.cpu()
        times[f"K3 N={n}"] = _event_ms(lambda: k3.form_kkt_schur(*a))
        # K2 at chip_smoke.py's step and at a seeded one
        step = k4.pcg_dz_reference(k3.form_kkt_schur_reference(*a),
                                   torch.zeros_like(X), 40, 5e-5)[1:3]
        gen = np.random.default_rng(3)
        seeded = tuple(torch.as_tensor(0.05 * gen.normal(size=tuple(t.shape)),
                                       dtype=torch.float32, device=dev)
                       for t in (X, U))
        for name, (dX, dU) in (("check", step), ("seeded", seeded)):
            m_args = (model, X, U, dX, dU, cfg.num_alphas, goals, xs,
                      cfg.timestep, cfg.merit_mu, cc.qd_cost, cc.r_cost,
                      cfg.gravity)
            res[f"K2 N={n} {name} merits"] = k2.line_search_merits(
                *m_args).cpu()
            if name == "check":
                res[f"K2 N={n} check dX"] = dX.cpu()
                times[f"K2 N={n}"] = _event_ms(
                    lambda: k2.line_search_merits(*m_args))
        if n == 64:
            for off, sim in ((0.0, 2000.0), (2000.0, 2000.0),
                             (1500.0, 700.0)):
                r = k1.plant_rollout(model, cfg, xs, U, goals[0], off, sim,
                                     max_substeps_for(cfg))
                (res[f"K1 {off:g}/{sim:g} x"],
                 res[f"K1 {off:g}/{sim:g} err"]) = (t.cpu() for t in r)
            times["K1"] = _event_ms(lambda: k1.plant_rollout(
                model, cfg, xs, U, goals[0], 2000.0, 2000.0,
                max_substeps_for(cfg)))
        pert = torch.as_tensor(0.02 * np.random.default_rng(5).normal(
            size=(n, 14)), dtype=torch.float32, device=dev)
        pert[0] = 0.0
        Xp = X + pert
        merit0 = k2.line_search_merits_reference(
            model, Xp, U, torch.zeros_like(Xp), torch.zeros_like(U),
            cfg.num_alphas, goals, xs, cfg.timestep, cfg.merit_mu,
            cc.qd_cost, cc.r_cost, cfg.gravity)[cfg.num_alphas]
        kw = dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
                  gravity=cfg.gravity, mu=cfg.merit_mu,
                  num_alphas=cfg.num_alphas, rho_factor=cfg.rho_factor,
                  rho_min=cfg.rho_min, rho_max=cfg.rho_max,
                  rho_reset=cfg.rho_reset)
        args = (model, Xp, U, goals, xs, torch.zeros_like(X), rho, 1.0,
                merit0, 40, 5e-5, 4)
        o = k5.sqp_solve_mega_pcg(*args, **kw)
        for f in ("X", "U", "lam", "rho", "merit", "pcg_iters", "accepted",
                  "sqp_iters", "bailed"):
            res[f"K5 N={n} {f}"] = getattr(o, f).cpu()
        times[f"K5 N={n}"] = _event_ms(
            lambda: k5.sqp_solve_mega_pcg(*args, **kw))
        # K9p: the first SQP iteration from K5's start
        one = torch.tensor(1.0, device=dev)
        a9 = (model, Xp, U, goals, xs, torch.zeros_like(X), rho, one, merit0,
              40, 5e-5)
        o = k5.sqp_iter_mega_pcg(*a9, **kw)
        for f in o._fields:
            res[f"K9p N={n} {f}"] = getattr(o, f).cpu()
        times[f"K9p N={n}"] = _event_ms(lambda: k5.sqp_iter_mega_pcg(*a9,
                                                                      **kw))
        # K9b the same iteration with the refined BCR; K5g and K9pg, the
        # joined forms, on K5's and K9p's inputs
        a9b = (*a9[:5], *a9[6:9])
        runs = {"K9b": lambda: k5.sqp_iter_mega(*a9b, **kw),
                "K5g": lambda: k5.sqp_solve_mega_pcg_grid(*args, **kw),
                "K9pg": lambda: k5.sqp_iter_mega_pcg_grid(*a9, **kw)}
        for kid, run in runs.items():
            o = run()
            for f in o._fields:
                res[f"{kid} N={n} {f}"] = getattr(o, f).cpu()
            times[f"{kid} N={n}"] = _event_ms(run)
        # K6 on K3's system without the stair; K4g and K4bg on K3's
        lam0 = torch.zeros_like(X)
        ks6 = k3.form_kkt_schur(*a, precond=False)
        for i, t in enumerate(k6.bcr_pcg_dz(ks6, lam0, 40, 5e-5)):
            res[f"K6 N={n} out{i}"] = t.cpu()
        times[f"K6 N={n}"] = _event_ms(
            lambda: k6.bcr_pcg_dz(ks6, lam0, 40, 5e-5))
        S, P = BlockTri(ks.SL, ks.SD, ks.SU), BlockTri(ks.PL, ks.PD, ks.PU)
        runs = {"K4g": lambda: k4.pcg_dz_grid(ks, lam0, 40, 5e-5),
                "K4bg": lambda: k4.pcg_solve_grid(S, P, ks.gamma, lam0, 40,
                                                  5e-5),
                "K7s": lambda: (k6.bcr_solve(ks6.SL, ks6.SD, ks6.SU,
                                             ks6.gamma),)}
        runs.update({
            "K4": lambda: k4.pcg_dz(ks, lam0, 40, 5e-5),
            "K4b": lambda: k4.pcg_solve(S, P, ks.gamma, lam0, 40, 5e-5)})
        if n == 64:  # K7's horizon
            runs["K7"] = lambda: k6.bcr_dz(ks6)
        for kid, run in runs.items():
            for i, t in enumerate(run()):
                res[f"{kid} N={n} out{i}"] = t.cpu()
            times[f"{kid} N={n}"] = _event_ms(run)
        if n == 64:
            # K10: two arms, K5's start and a second seeded perturbation
            pert2 = torch.as_tensor(0.02 * np.random.default_rng(6).normal(
                size=(n, 14)), dtype=torch.float32, device=dev)
            pert2[0] = 0.0
            a10 = (model, torch.stack([Xp, X + pert2]), torch.stack([U, U]),
                   goals.expand(2, n, goals.shape[1]), torch.stack([xs, xs]),
                   torch.zeros(2, n, 14, device=dev), rho, 1.0, 40, 5e-5, 4)
            o = k5.sqp_solve_mega_pcg_packed(*a10, **kw)
            for f in o._fields:
                res[f"K10 N={n} {f}"] = getattr(o, f).cpu()
            times[f"K10 N={n}"] = _event_ms(
                lambda: k5.sqp_solve_mega_pcg_packed(*a10, **kw))
    # K11 on seeded random bands of 64 rows, nonzero halo rows
    from mpcgpu_tpu_torch.ops.cuda import spmv_halo_kernel as k11
    gen = np.random.default_rng(64)
    bands = [torch.as_tensor(gen.normal(size=shape).astype(np.float32),
                             device=dev)
             for shape in ((64, 14, 14),) * 3 + ((64, 14), (14,), (14,))]
    res["K11 nl=64 y"] = k11.spmv_halo(*bands).cpu()
    times["K11 nl=64"] = _event_ms(lambda: k11.spmv_halo(*bands))
    torch.cuda.synchronize()
    # the fits and grids the library reports (occupancy API, shared memory)
    lib, plan = k5._lib.library(), (ctypes.c_int * 3)()
    fits = {"K5 N max": lib.mpc_mega_max_knots(k5.SOLVE_PCG),
            "K9p N max": lib.mpc_mega_max_knots(k5.ITER_PCG),
            "K9b N max": lib.mpc_mega_max_knots(k5.ITER_BCR),
            "K7s N max": lib.mpc_bcr_solve_max_knots(),
            "K10 N max (B = 2)": lib.mpc_mega_packed_max_knots(2, 8),
            "K10 B max (N = 64)": max(
                b for b in range(1, 1025) if packed_grid(lib, 64, b) >= b)}
    for n in (64, 128, 256, 512, 1024):
        for name, kind in (("K5", k5.SOLVE_PCG), ("K5g", k5.SOLVE_PCG_GRID),
                           ("K9pg", k5.ITER_PCG_GRID),
                           ("K9b", k5.ITER_BCR)):
            fits[f"{name} grid N={n}"] = lib.mpc_mega_grid(n, kind)
        for stair in (0, 1):
            lib.mpc_mega_cluster_plan(n, k5.SOLVE_PCG, 0, stair, plan)
            fits[f"K5 stair {'on chip' if stair else 'in L2'} grid N={n}"] = (
                plan[2])
    torch.save({"res": res, "times": times, "fits": fits,
                "device": torch.cuda.get_device_name(0)}, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--changed", nargs="*", default=["K4", "K4b", "K4g",
                                                     "K4bg"])
    ap.add_argument("--out", type=Path, default=Path("build") / "compare")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run is not None:
        run_tree(a.run, a.save)
        return 0
    import torch

    this = Path(__file__).resolve().parents[1]
    a.out.mkdir(parents=True, exist_ok=True)
    order = [("other", a.other), ("this", this), ("this", this),
             ("other", a.other)]
    runs = []
    for i, (label, tree) in enumerate(order):
        save = a.out / f"compare_{i}_{label}.pt"
        subprocess.run([sys.executable, __file__, str(a.other), "--run",
                        str(tree), "--save", str(save)], check=True)
        runs.append((label, torch.load(save)))
    print(f"device {runs[0][1]['device']}; times in ms (median of {REPS} "
          f"CUDA-event calls), in turns:")
    for kid in runs[0][1]["times"]:
        print(f"  {kid:10s} " + "  ".join(
            f"{label} {r['times'][kid]:.4f}" for label, r in runs))
    other, mine = runs[0][1]["res"], runs[1][1]["res"]
    print("largest |this - other| per output (other's largest |entry|):")
    for key, want in other.items():
        got = mine[key]
        d = float((got.double() - want.double()).abs().max())
        print(f"  {key:22s} {d:.3e}  ({float(want.double().abs().max()):.3e})")
    print("fits and grids, other | this:")
    for key, want in runs[0][1]["fits"].items():
        print(f"  {key:32s} {want:6d} | {runs[1][1]['fits'][key]:6d}")
    same = all(torch.equal(runs[1][1]["res"][k], runs[2][1]["res"][k])
               for k in mine)
    print(f"this tree's two runs bit-equal: {same}")
    changed = [k for k in other if k.split()[0] in a.changed]
    counts = [k for k in changed if other[k].dtype == torch.int32]
    print(f"changed kernels ({' '.join(a.changed)}): CG counts, other | "
          f"this: " + "; ".join(f"{k} {int(other[k])} | {int(mine[k])}"
                                for k in counts))
    unequal = [k for k in other if k not in changed
               and not torch.equal(mine[k], other[k])]
    print(f"every other output bit-equal: {not unequal}"
          + (f" (differ: {unequal})" if unequal else ""))
    return 0 if same and not unequal else 1


if __name__ == "__main__":
    sys.exit(main())
