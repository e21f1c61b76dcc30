#!/usr/bin/env python3
"""IIWA figure-eight tracking with the SQP-PCG solver on the PyTorch + CUDA
port (mpcgpu_tpu_torch): the flagship driver.

Counterpart of examples/track_iiwa_pcg.py (reference
examples/track_iiwa_pcg.cu:14-184), with its flags, defaults, output
lines, .result files and overall_stats.csv: loads the recorded
trajectory fixtures, sweeps the per-N PCG exit tolerances, runs the
closed loop (sim.simulate_mpc) --test-iters times per (start, goal) pair,
prints the distributional stats and archives each run.

    python examples/track_iiwa_pcg_torch.py            # on the CUDA card
    python examples/track_iiwa_pcg_torch.py --cpu      # plain modules, CPU

On the card the kernels are the route: fused_stages, and for "pcg" and
"auto" the whole-solve kernel (K2, K5, K1 an update; "auto"'s failover
runs K3, K6 and K2 an SQP iteration), for "bcr" one K9b launch an SQP
iteration, for "pcg_pallas" and "bcr_pcg" the staged kernels (K3 with K4
or K6, then K2).  --no-precond turns the whole-solve kernel off, so the
flag reaches K3's stair preconditioner through the staged route.
"dense" and "qdldl" have no kernel and run the plain stages on the card
(qdldl's LDL' on the host); the header names the route.  --hessian
gauss_newton reaches the kernels as a knob (K3's and K5's stage 1).
Without a card and without --cpu the driver raises.

Like the reference (which stops after the first combination,
track_iiwa_pcg.cu:177), only (start=0, goal=0) runs by default;
--all-pairs sweeps every recorded pair, their end-effector traces made
by forward kinematics.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

LINSYS = ["pcg", "pcg_pallas", "dense", "qdldl", "bcr", "bcr_pcg", "auto"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, default=32)
    ap.add_argument("--test-iters", type=int, default=1)
    ap.add_argument("--max-timesteps", type=int, default=None)
    ap.add_argument("--sqp-max-iter", type=int, default=40)
    ap.add_argument("--tols", type=float, nargs="*", default=None)
    ap.add_argument("--linsys", default="pcg", choices=LINSYS,
                    help="'auto' = pcg with the rho-bail-rate failover to "
                    "bcr_pcg (SolverConfig.failover_*)")
    ap.add_argument("--no-precond", action="store_true",
                    help="ENABLE_PRECONDITIONING=0 ablation")
    ap.add_argument("--hessian", default="reference",
                    choices=["reference", "gauss_newton"])
    ap.add_argument("--trajfile-dir", default=str(REPO / "tests" / "fixtures"))
    ap.add_argument("--output-dir", default=str(REPO / "tmp" / "results"))
    ap.add_argument("--warmup-iters", type=int, default=100)
    ap.add_argument("--fine-grained", action="store_true",
                    help="per-phase KKT/Schur/linsys/dz/line-search timing "
                         "dumps (reference FINE_GRAINED_TIMING)")
    ap.add_argument("--all-pairs", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain modules on the CPU")
    return ap.parse_args(argv)


def solver_config(args, device):
    """The driver's SolverConfig: the reference's per-N defaults, and on
    the card the kernels' route (module doc)."""
    from mpcgpu_tpu_torch.config import SolverConfig

    cfg = SolverConfig.for_knots(args.knots, sqp_max_iter=args.sqp_max_iter)
    cfg = dataclasses.replace(
        cfg,
        pcg=dataclasses.replace(cfg.pcg, preconditioned=not args.no_precond),
        cost=dataclasses.replace(cfg.cost, hessian=args.hessian),
    )
    if device.type != "cuda" or args.linsys in ("dense", "qdldl"):
        return cfg
    mega_solve = args.linsys in ("pcg", "auto") and not args.no_precond
    return dataclasses.replace(
        cfg, fused_stages=True,
        megakernel=mega_solve or args.linsys == "bcr",
        megakernel_solve=mega_solve)


def route(cfg, linsys: str, device, fine_grained: bool = False) -> str:
    """The kernels (or plain stages) an SQP solve runs under (cfg,
    linsys); raises where the kernels refuse the configuration.  With
    fine_grained the timed solves run sqp_solve_fine_grained's plain
    phases (K4b for pcg_pallas on the card), the warm-up the route
    named after them."""
    from mpcgpu_tpu_torch.sqp import check_fused_config, megakernel_engages

    k4b = ", K4b" if linsys == "pcg_pallas" and device.type == "cuda" else ""
    if fine_grained:
        k1 = ", K1 an update" if cfg.fused_stages else ""
        return (f"fine-grained: plain phases on {device}{k4b}{k1}; the "
                f"warm-up on the {route(cfg, linsys, device)}")
    if not cfg.fused_stages:
        host = " with the LDL' on the host" if linsys == "qdldl" else ""
        why = (f", no kernel serves {linsys!r}" if device.type == "cuda"
               else "")
        return f"plain stages on {device}{host}{k4b}{why}"
    backends = ("pcg", "bcr_pcg") if linsys == "auto" else (linsys,)
    parts = []
    for b in backends:
        check_fused_config(cfg, b)
        if megakernel_engages(cfg, b):
            parts.append(f"{b}: K2, K5" if b == "pcg" and cfg.megakernel_solve
                         else f"{b}: K2, K9{'p' if b == 'pcg' else 'b'} an "
                         f"iteration")
        else:
            solve = {"bcr": "K7", "bcr_pcg": "K6"}.get(b, "K4")
            parts.append(f"{b}: K3, {solve}, K2 an iteration")
    return f"kernels on {device} ({'; '.join(parts)}; K1 an update)"


def main(argv=None):
    args = parse_args(argv)

    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        raise SystemExit("track_iiwa_pcg_torch: no CUDA card "
                         "(torch.cuda.is_available() is False); pass --cpu "
                         "to run the plain modules on the CPU")

    from mpcgpu_tpu_torch.config import default_pcg_exit_tols
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.sim import simulate_mpc
    from mpcgpu_tpu_torch.utils.results import dump_tracking_data
    from mpcgpu_tpu_torch.utils.stats import print_stats, stats_csv_row
    from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

    model = iiwa14(device=device)
    cfg = solver_config(args, device)
    tols = args.tols if args.tols else default_pcg_exit_tols(args.knots)

    print(f"Knot points: {cfg.knot_points}")
    print(f"State size: {cfg.state_size}")
    print(f"Solver: {args.linsys.upper()}  precond: {cfg.pcg.preconditioned}")
    print(f"Max sqp iter: {cfg.sqp_max_iter}  Max pcg iter: {cfg.pcg.max_iter}")
    print(f"R cost: {cfg.cost.r_cost}  QD cost: {cfg.cost.qd_cost}")
    print(f"Route: {route(cfg, args.linsys, device, args.fine_grained)}\n")

    recorded_states = 5
    pairs = [
        (s, g)
        for g in range(recorded_states)
        for s in range(recorded_states)
        if not (s == g and s != 0)
    ]
    if not args.all_pairs:
        pairs = [(0, 0)]

    for start, goal in pairs:
        try:
            xu, ee = load_fixture_pair(args.trajfile_dir, start, goal,
                                       model=model)
        except OSError:
            print(f"fixture {start}_{goal} not found, skipping")
            continue
        print(f"start: {start} goal: {goal}")

        for tol in tols:
            prefix = f"{cfg.knot_points}_{args.linsys.upper()}_{tol}"
            tracking_errs, sqp_iters, final_errs = [], [], []
            for it in range(args.test_iters):
                rec = simulate_mpc(
                    model, cfg, xu, ee,
                    pcg_exit_tol=tol, linsys=args.linsys,
                    warmup_iters=args.warmup_iters if it == 0 else 0,
                    max_timesteps=args.max_timesteps,
                    fine_grained_timing=args.fine_grained,
                )
                dump_tracking_data(rec, prefix, it, args.output_dir)
                tracking_errs.extend(rec.tracking_errors)
                sqp_iters.extend(rec.sqp_iters)
                final_errs.append(rec.final_tracking_error)

            print(f"\nRESULTS — exit tol {tol}")
            print_stats(tracking_errs, "trackingerr")
            print_stats(sqp_iters, "sqpiters")
            print(f"Average final tracking err: "
                  f"{sum(final_errs) / len(final_errs):.6g}\n")
            out = Path(args.output_dir)
            out.mkdir(parents=True, exist_ok=True)
            with open(out / f"{prefix}_overall_stats.csv", "w") as f:
                f.write("Average,Std Dev, Min, Max, Median, Q1, Q3\n")
                f.write(stats_csv_row(tracking_errs) + "\n")
                f.write(stats_csv_row(sqp_iters) + "\n")


if __name__ == "__main__":
    main()
