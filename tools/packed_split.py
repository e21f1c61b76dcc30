"""Time K10, the arm-packed whole solve, on the card, and split its time
into the stages and the dual solve: each (N, B) is solved at the CG cap
and again with the cap at 0 (the same stages, no CG step); the
difference over the shared CG count is a CG step's time.  The inputs are
chip_smoke.py's K10 check inputs: fixture 0_0's first N knots, arm a's
states perturbed from seed 5 + a (knot 0 kept), cold duals, rho 1e-3
(every CG runs to the cap), 4 SQP iterations, the cap and exit tolerance
of the horizon (PCGConfig.tpu_tuned_max_iter, default_pcg_exit_tols).
Times are CUDA-event medians of --reps calls after 3 warm-up calls.
--forms names the launches: "plan" (the wrapper's, the occupancy API's
choice), a cluster size 2-16 (the cluster form at that size), "block"
(the one-block form); each one the card cannot hold is skipped.

    python3 tools/packed_split.py [--knots 64 128] [--arms 2] [--reps 20]
                                  [--forms plan block]
"""
import argparse
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpcgpu_tpu_torch.config import (PCGConfig, SolverConfig,  # noqa: E402
                                     default_pcg_exit_tols)
from mpcgpu_tpu_torch.models.robot import iiwa14  # noqa: E402
from mpcgpu_tpu_torch.ops.cuda import _lib  # noqa: E402
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k10  # noqa: E402
from mpcgpu_tpu_torch.utils.trajfiles import (horizon_slices,  # noqa: E402
                                              load_fixture_pair)

SQP_ITERS = 4


def event_ms(fn, reps):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def inputs(model, n, b, dev):
    xu, ee = load_fixture_pair(REPO / "tests" / "fixtures", 0, 0)
    if n > xu.shape[0]:
        xu, ee = np.resize(xu, (n, xu.shape[1])), np.resize(ee, (n, 6))
    X, U, goals, xs = (torch.as_tensor(a, device=dev)
                       for a in horizon_slices(xu, ee, n))
    arms = []
    for a in range(b):
        pert = 0.02 * np.random.default_rng(5 + a).normal(size=(n, 14))
        pert[0] = 0.0
        arms.append(X + torch.as_tensor(pert, dtype=torch.float32,
                                        device=dev))
    cfg = SolverConfig.for_knots(n, sqp_max_iter=SQP_ITERS)
    cc = cfg.cost
    kw = dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
              gravity=cfg.gravity, mu=cfg.merit_mu,
              num_alphas=cfg.num_alphas, rho_factor=cfg.rho_factor,
              rho_min=cfg.rho_min, rho_max=cfg.rho_max,
              rho_reset=cfg.rho_reset)
    args = [model, torch.stack(arms), U.expand(b, n - 1, 7).contiguous(),
            goals.expand((b,) + goals.shape), xs.expand(b, 14).contiguous(),
            torch.zeros(b, n, 14, device=dev),
            torch.full((b,), cfg.rho_init, device=dev),
            torch.ones(b, device=dev)]
    return args, kw, PCGConfig.tpu_tuned_max_iter(n), default_pcg_exit_tols(n)[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--knots", type=int, nargs="+", default=[64])
    ap.add_argument("--arms", type=int, nargs="+", default=[2])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--forms", nargs="+", default=["plan"])
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("packed_split: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    model = iiwa14(device=dev)
    lib = _lib.library()
    tab = _lib.model_tables(model)
    for n in opt.knots:
        for b in opt.arms:
            args, kw, cap, tol = inputs(model, n, b, dev)
            for form in opt.forms:
                ask = {"plan": 0, "block": -1}.get(form)
                ask = int(form) if ask is None else ask
                try:
                    plan = k10.packed_plan(n, b, kw["num_alphas"], lib, ask)
                except ValueError:
                    print(f"K10 N={n} B={b} {form}: does not fit")
                    continue

                def run(c, plan=plan):
                    return k10._launch_packed(
                        lib, tab, *args[1:], c, tol, SQP_ITERS, **kw,
                        grid=plan.grid, stream=_lib.stream_of(args[1]),
                        cluster=plan.cluster, stair=plan.stair)

                its = int(run(cap).pcg_iters_total)
                ms = event_ms(lambda: run(cap), opt.reps)
                ms0 = event_ms(lambda: run(0), opt.reps)
                step = 1e3 * (ms - ms0) / max(its, 1)
                print(f"K10 N={n} B={b} {form}: C={plan.cluster} "
                      f"stair={plan.stair} grid={plan.grid} cap={cap}: "
                      f"{1e3 * ms:.1f} us a call, {1e3 * ms0:.1f} us at cap "
                      f"0 (the stages), {its} shared CG steps, {step:.2f} us "
                      f"a CG step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
