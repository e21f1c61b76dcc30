"""K10's shared CG exit and lam against its plain version, per form, with
the margin of each SQP iteration's exit to the tolerance.

For every case it runs the plain version in float32 and in float64 and
K10 in each form the card plans for the pack (the cluster form at C = 16,
8, 4, 2 and the one-block form, -1), and prints, per SQP iteration, the
shared CG count k and max over the arms of |eta| / tol at the exit step
(eta after k steps: at most 1 unless the cap stopped the CG) and at the
step before (above 1).  The plain version's etas come from a trace of
ops/pcg.py's dots; the cluster form's from the words its shared exit
publishes (the launch's scratch, read after launches of 1, 2, 3 and 4
SQP iterations: each leaves its last CG's last two etas per arm).  The
one-block form prints its counts only.  Then, per form, lam's and X's
largest difference from the plain float32 and float64 versions and the
JAX megakernel test's tolerance ratio max |d| / (atol + rtol |ref|)
(lam: rtol 1e-3, atol 1e-4; X: rtol 1e-3, atol 1e-5): above 1 fails it.

Cases: (1) two arms at N = 64 (fixture 0_0, arm a's states perturbed
from seed 5 + a with knot 0 kept, cold duals, 4 SQP iterations, cap 40,
tol 5e-5) at rhos (0.1, 0.3) and (0.3, 0.1), on two float32 roundings of
the same start (the perturbation added in float32, as chip_smoke.py's
phase 3 makes it, or in float64 and rounded, as its phase 8 does);
(2) chip_smoke.py's phase 11 inputs (its long_start and long_cfg: the
float64 rounding, cap tpu_tuned_max_iter(N), tol default_pcg_exit_tols(N)
[0]) at N = 2, 5, 7 and rhos (0.1, 0.3), and at N = 64, 128, 256 and
rhos (0.3, 0.1) and (0.1, 0.3); at N = 128 and 256, where every CG runs
to the cap at that tol, also rhos (1, 3), and rhos (0.3, 0.1) at tol 5e-5
and 1e-4.

    python3 tools/packed_exit_probe.py [N ...]   # only the cases at N
"""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpcgpu_tpu_torch.config import (PCGConfig, SolverConfig,  # noqa: E402
                                     default_pcg_exit_tols)
from mpcgpu_tpu_torch.models.robot import iiwa14  # noqa: E402
from mpcgpu_tpu_torch.ops import pcg as pcg_mod  # noqa: E402
from mpcgpu_tpu_torch.ops.cuda import _lib  # noqa: E402
from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k10  # noqa: E402
from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair  # noqa: E402

N_SQP = 4


def start(xu, ee, n, rounding, dev):
    """Two arms' float32 states, the controls, goals and start."""
    rows = np.resize(np.arange(xu.shape[0]), n)
    arms = []
    for seed in (5, 6):
        pert = 0.02 * np.random.default_rng(seed).normal(size=(n, 14))
        pert[0] = 0.0
        if rounding == "float32 sum":
            a = (torch.as_tensor(xu[rows, :14], dtype=torch.float32)
                 + torch.as_tensor(pert, dtype=torch.float32))
        else:
            a = torch.as_tensor((xu[rows, :14] + pert).astype(np.float32))
        arms.append(a)
    on = lambda t: torch.as_tensor(t, dtype=torch.float32).to(dev)
    return (on(torch.stack(arms)),
            on(xu[rows[:-1], 14:]).expand(2, n - 1, 7).contiguous(),
            on(ee[rows]).expand(2, n, 6),
            on(xu[0, :14]).expand(2, 14).contiguous())


def plain_trace(model, args, kw):
    """The plain version and, per SQP iteration, (k, exit, before): the
    shared count and max |eta| / tol after k steps and after k - 1."""
    tol, rows, dots = float(args[8]), [], []
    dot, solve = pcg_mod._dot, k10.pcg

    def traced_dot(a, b):
        out = dot(a, b)
        dots.append(out.abs().amax().item())
        return out

    def traced_solve(*a, **k):
        dots.clear()
        res = solve(*a, **k)
        # eta0, then per step p.w and eta' (the loop runs the cap's steps,
        # every one after the exit masked)
        etas = [dots[0]] + dots[2::2]
        it = int(res.iters)
        rows.append((it, etas[it] / tol, etas[it - 1] / tol if it else None))
        return res

    pcg_mod._dot, k10.pcg = traced_dot, traced_solve
    try:
        ref = k10.sqp_solve_mega_pcg_packed_reference(model, *args, **kw)
    finally:
        pcg_mod._dot, k10.pcg = dot, solve
    return ref, rows


def kernel_trace(lib, tab, args, kw, plan):
    """K10 in `plan`'s form and, per SQP iteration, (k, exit, before) as
    plain_trace's (exit and before None for the one-block form)."""
    b, n = args[0].shape[:2]
    tol, rows, total = float(args[8]), [], 0
    scratch = torch.empty(lib.mpc_sqp_mega_packed_scratch_floats(
        n, b, kw["num_alphas"]), device=args[0].device)
    for j in range(1, N_SQP + 1):
        scratch.zero_()
        out = k10._launch_packed(lib, tab, *args[:9], j, grid=plan.grid,
                                 stream=_lib.stream_of(args[0]),
                                 cluster=plan.cluster, stair=plan.stair,
                                 scratch=scratch, **kw)
        k = int(out.pcg_iters_total) - total
        total += k
        if not plan.cluster:
            rows.append((k, None, None))
            continue
        words = scratch[:4 * b].view(2, b, 2)       # (parity, arm, lo/hi)
        eta = words[..., 0].abs().cpu()
        tag = words[..., 1].view(torch.int32).cpu()
        last = tag.argmax(0)                          # per arm, its exit
        ex = eta.gather(0, last[None])[0].max().item()
        be = eta.gather(0, (1 - last)[None])[0].max().item()
        rows.append((k, ex / tol, be / tol if k else None))
    return out, rows


def text(rows):
    f = lambda v: "-" if v is None else f"{v:.6f}"
    return " | ".join(f"{k} ({f(e)}, {f(b)})" for k, e, b in rows)


def ratio(got, want, rtol, atol):
    d = (got.double() - want.double()).abs()
    return d.max().item(), (d / (atol + rtol * want.double().abs())).max().item()


def case(lib, tab, dev, label, X, U, g, xs, rhos, cap, tol, kw):
    print(f"== {label}, rhos {rhos}, cap {cap}, tol {tol:g}", flush=True)
    b, n = X.shape[:2]
    refs = {}
    for dtype in (torch.float32, torch.float64):
        f = dict(dtype=dtype, device=dev)
        args = (X.to(dtype), U.to(dtype), g.to(dtype), xs.to(dtype),
                torch.zeros(b, n, 14, **f), torch.tensor(rhos, **f),
                torch.ones(b, **f), cap, tol, N_SQP)
        ref, rows = plain_trace(iiwa14(device=dev, dtype=dtype), args, kw)
        name = f"plain {str(dtype)[6:]}"
        refs[name] = ref
        print(f"  {name}: total {int(ref.pcg_iters_total)}, sqp "
              f"{ref.sqp_iters.tolist()}, bailed {ref.bailed.tolist()}; per "
              f"SQP iteration k (exit, before): {text(rows)}", flush=True)
    args = (X, U, g, xs, torch.zeros(b, n, 14, device=dev),
            torch.tensor(rhos, device=dev), torch.ones(b, device=dev), cap,
            tol, N_SQP)
    for c in (16, 8, 4, 2, -1):
        try:
            plan = k10.packed_plan(n, b, kw["num_alphas"], lib, cluster=c)
        except ValueError:
            continue
        out, rows = kernel_trace(lib, tab, args, kw, plan)
        errs = []
        for name, ref in refs.items():
            lam_d, lam_r = ratio(out.lam, ref.lam, 1e-3, 1e-4)
            x_d, x_r = ratio(out.X, ref.X, 1e-3, 1e-5)
            errs.append(f"vs {name}: lam {lam_d:.3e} (ratio {lam_r:.3f}), "
                        f"X {x_d:.3e} (ratio {x_r:.3f})")
        print(f"  C {c}: total {int(out.pcg_iters_total)}, sqp "
              f"{out.sqp_iters.tolist()}, bailed {out.bailed.tolist()}; per "
              f"SQP iteration k (exit, before): {text(rows)}; "
              f"{'; '.join(errs)}", flush=True)
    p32, p64 = refs["plain float32"], refs["plain float64"]
    lam_d, lam_r = ratio(p32.lam, p64.lam, 1e-3, 1e-4)
    print(f"  plain float32 vs float64: lam {lam_d:.3e} (ratio {lam_r:.3f})",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("packed_exit_probe: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = _lib.library()
    tab = _lib.model_tables(iiwa14(device=dev))
    xu, ee = load_fixture_pair(REPO / "tests" / "fixtures", 0, 0)

    def kw_of(cfg):
        cc = cfg.cost
        return dict(dt=cfg.timestep, qd_cost=cc.qd_cost, r_cost=cc.r_cost,
                    gravity=cfg.gravity, mu=cfg.merit_mu, num_alphas=8,
                    rho_factor=cfg.rho_factor, rho_min=cfg.rho_min,
                    rho_max=cfg.rho_max, rho_reset=cfg.rho_reset)

    only = {int(a) for a in sys.argv[1:]}
    cases = [(64, "float32 sum", rhos, 40, 5e-5)
             for rhos in ((0.1, 0.3), (0.3, 0.1))]
    cases += [(64, "float64 sum", rhos, 40, 5e-5)
              for rhos in ((0.1, 0.3), (0.3, 0.1))]
    # chip_smoke.py's phase 11 inputs: the horizon's cap and tol, and at
    # N = 128, 256 (where every CG runs to the cap at tol 1e-5) the tols
    # 5e-5 and 1e-4 and the rhos 1, 3
    for n, rhos_list in ((2, [(0.1, 0.3)]), (5, [(0.1, 0.3)]),
                         (7, [(0.1, 0.3)]), (64, [(0.3, 0.1), (0.1, 0.3)]),
                         (128, [(0.3, 0.1), (0.1, 0.3), (1.0, 3.0)]),
                         (256, [(0.3, 0.1), (0.1, 0.3), (1.0, 3.0)])):
        cap = PCGConfig.tpu_tuned_max_iter(n)
        for rhos in rhos_list:
            tols = [default_pcg_exit_tols(n)[0]]
            if n >= 128 and rhos == (0.3, 0.1):
                tols += [5e-5, 1e-4]
            cases += [(n, "phase 11", rhos, cap, t) for t in tols]
    for n, start_of, rhos, cap, tol in cases:
        if only and n not in only:
            continue
        cfg = SolverConfig.for_knots(
            n, sqp_max_iter=N_SQP, pcg=PCGConfig(max_iter=cap))
        rounding = "float64 sum" if start_of == "phase 11" else start_of
        label = (f"N = {n}, chip_smoke.py's phase 11 start"
                 if start_of == "phase 11" else f"N = {n}, start {start_of}")
        case(lib, tab, dev, label, *start(xu, ee, n, rounding, dev), rhos,
             cap, tol, kw_of(cfg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
