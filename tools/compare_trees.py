"""Hold K1, K2, K3 and K5 of two checkouts of this repository against each
other on the card: the same seeded inputs through each tree's wrappers, the
largest difference of every output, and each kernel's CUDA-event time in
turns (other, this, this, other), each turn a process of its own.

    python3 tools/compare_trees.py OTHER_CHECKOUT [--out DIR]

Each tree builds its own library in its own package directory.  Inputs:
fixture 0_0's first N knots (N = 64 and 256 for K2, K3 and K5; K1 at 64),
for K2 the step of chip_smoke.py's check (the plain K3 and K4's dX, dU at
cold duals; the step itself is compared too) and a seeded 0.05-scale step,
a seeded 0.02-scale perturbation for K5's start (cold duals, rho 1e-3, cap
40, 4 SQP iterations), and K1 at the three offsets of the host tests.
Also prints both libraries' fits and grids (K5, K9p, K9b, K10; K5, K5g,
K9pg and K9b's grids at N = 64-1024).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 20


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
    torch.cuda.synchronize()
    # the fits and grids the library reports (occupancy API, shared memory)
    lib, plan = k5._lib.library(), (ctypes.c_int * 3)()
    fits = {"K5 N max": lib.mpc_mega_max_knots(k5.SOLVE_PCG),
            "K9p N max": lib.mpc_mega_max_knots(k5.ITER_PCG),
            "K9b N max": lib.mpc_mega_max_knots(k5.ITER_BCR),
            "K10 N max (B = 2)": lib.mpc_mega_packed_max_knots(2, 8),
            "K10 B max (N = 64)": max(
                b for b in range(1, 1025)
                if lib.mpc_mega_packed_grid(64, b, 8) >= b)}
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
