"""Readings of the solver-knob solve checks' yardsticks on a CUDA card.

    python3 tools/knob_yardsticks.py

Builds the IIWA library, then for each knob case (tests/torch_systems.py
KNOB_CASES) runs one SQP iteration of K5, K9p, K9b and K10 (two arms) and
the plain version in float32 and float64, at the card tests' inputs (N = 8,
the moved start, rho 1e-3) and at chip_smoke.py phase 15's (N = 64, the
moved start and the fixture's own joints, rho 1e-3), and K9b alone at rho
1e-2 and 0.1.  Each line prints, per field, the share of its allowance
that torch_systems.within_twice_plain uses with the plain version's
distance taken per row and over the field ("row/field"), and for K9b its
relative residual over the float64 solve's rounded to float32 ("k/w"), the
plain solve's over the same ("p/w"), and the largest share of rtol 1e-3,
atol 2e-4 that X, U and merit use against the plain iteration given its
duals ("given").  Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("knob_yardsticks: needs a CUDA card")
    from mpcgpu_tpu_torch.config import default_pcg_exit_tols
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.cuda import _lib
    from mpcgpu_tpu_torch.ops.cuda import merit_kernel as k2
    from mpcgpu_tpu_torch.ops.cuda import sqp_megakernel as k5
    from mpcgpu_tpu_torch.utils.trajfiles import load_fixture_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _lib.build_all(force=True, counts=(7,))
    systems = cs.load_systems(REPO)
    dev = torch.device("cuda", 0)
    model, model64 = iiwa14(device=dev), iiwa14(device=dev,
                                                 dtype=torch.float64)
    xu, ee = load_fixture_pair(REPO / "tests" / "fixtures", 0, 0)
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def uses(got, want, w64, fields):
        out = []
        for f in fields:
            rtol, atol = systems.SOLVE_TOLS[f]
            g, w, f64 = (getattr(r, f).double() for r in (got, want, w64))
            dk, dp = (g - f64).abs(), (w - f64).abs()
            allow = rtol * f64.abs() + atol
            row = float((dk / (2 * dp.amax(-1, keepdim=True) + allow)).max())
            field = float((dk / (2 * dp.max() + allow)).max())
            out.append(f"{f} {row:.2f}/{field:.2f}")
        return " ".join(out)

    def k9b_line(a, got, want, w64, kw):
        given, ks = systems.bcr_iteration_given_lam(model, *a, got.lam, **kw)
        res = [systems.relative_residual(ks, lam) for lam in (
            got.lam, want.lam, w64.lam.float())]
        use = max(float(((getattr(got, f) - getattr(given, f)).abs()
                         / (2e-4 + 1e-3 * getattr(given, f).abs())).max())
                  for f in ("X", "U", "merit"))
        return (f" k/w {res[0] / res[2]:.2f} p/w {res[1] / res[2]:.2f} "
                f"given {use:.2f}")

    def start(n, knob, move, kw, seed=5):
        kn = systems.KNOB_CASES[knob]
        X, U, g, xs = (on(a) for a in systems.knob_start(xu, ee, n, knob,
                                                          seed, move))
        m0 = k2.line_search_merits_reference(
            model, X, U, torch.zeros_like(X), torch.zeros_like(U),
            kw["num_alphas"], g, xs, kw["dt"], kw["mu"], kw["qd_cost"],
            kw["r_cost"], kw["gravity"], knobs=kn)[kw["num_alphas"]]
        return X, U, g, xs, m0

    def solves(label, n, knob, move, kw, cap, tol):
        kw = dict(kw, knobs=systems.KNOB_CASES[knob])
        X, U, g, xs, m0 = start(n, knob, move, kw)
        rho, one = (torch.tensor(v, device=dev) for v in (1e-3, 1.0))
        Xb = torch.stack([X, start(n, knob, move, kw, seed=6)[0]])
        for kid, run, plain, a in (
                ("K5", k5.sqp_solve_mega_pcg, k5.sqp_solve_mega_pcg_reference,
                 (X, U, g, xs, torch.zeros_like(X), rho, 1.0, m0, cap, tol,
                  1)),
                ("K9p", k5.sqp_iter_mega_pcg, k5.sqp_iter_mega_pcg_reference,
                 (X, U, g, xs, torch.zeros_like(X), rho, one, m0, cap, tol)),
                ("K9b", k5.sqp_iter_mega, k5.sqp_iter_mega_reference,
                 (X, U, g, xs, rho, one, m0)),
                ("K10", k5.sqp_solve_mega_pcg_packed,
                 k5.sqp_solve_mega_pcg_packed_reference,
                 (Xb, U.expand(2, n - 1, cs.NU).contiguous(),
                  g.expand((2,) + g.shape), Xb[:, 0].contiguous(),
                  torch.zeros_like(Xb), torch.tensor([1e-3, 0.1], device=dev),
                  torch.ones(2, device=dev), cap, tol, 1))):
            got, want = run(model, *a, **kw), plain(model, *a, **kw)
            w64 = plain(model64, *systems.as_float64(a), **kw)
            line = f"{label} {knob} {kid} {uses(got, want, w64, ('X', 'U', 'lam'))}"
            if kid == "K9b":
                line += k9b_line(a, got, want, w64, kw)
            print(line, flush=True)

    def k9b_at(label, n, knob, move, kw, rho_v):
        kw = dict(kw, knobs=systems.KNOB_CASES[knob])
        X, U, g, xs, m0 = start(n, knob, move, kw)
        a = (X, U, g, xs, torch.tensor(rho_v, device=dev),
             torch.tensor(1.0, device=dev), m0)
        got, want = (k5.sqp_iter_mega(model, *a, **kw),
                     k5.sqp_iter_mega_reference(model, *a, **kw))
        w64 = k5.sqp_iter_mega_reference(model64, *systems.as_float64(a),
                                         **kw)
        print(f"{label} rho={rho_v} {knob} K9b "
              f"{uses(got, want, w64, ('X', 'U', 'lam'))}"
              f"{k9b_line(a, got, want, w64, kw)}", flush=True)

    # the card tests' constants (tests/test_torch_cuda.py) and phase 15's
    kw8 = dict(dt=0.015625, qd_cost=1e-4, r_cost=1e-3, gravity=0.0, mu=10.0,
               num_alphas=8, rho_factor=1.2, rho_min=1e-3, rho_max=10.0,
               rho_reset=1e-3)
    cfg = cs.slice_cfg(cs.N_KNOTS)
    kw64 = dict(dt=cfg.timestep, qd_cost=cfg.cost.qd_cost,
                r_cost=cfg.cost.r_cost, gravity=cfg.gravity, mu=cfg.merit_mu,
                num_alphas=cfg.num_alphas, rho_factor=cfg.rho_factor,
                rho_min=cfg.rho_min, rho_max=cfg.rho_max,
                rho_reset=cfg.rho_reset)
    tol64 = default_pcg_exit_tols(cs.N_KNOTS)[0]
    for knob in systems.KNOB_CASES:
        solves("N=8 moved", 8, knob, True, kw8, 40, 5e-5)
    for move in (True, False):
        for knob in systems.KNOB_CASES:
            solves(f"N={cs.N_KNOTS} {'moved' if move else 'fixture'}",
                   cs.N_KNOTS, knob, move, kw64, cfg.pcg.max_iter, tol64)
    for rho_v in (1e-2, 0.1):
        for knob in systems.KNOB_CASES:
            k9b_at("N=8 moved", 8, knob, True, kw8, rho_v)
            for move in (True, False):
                k9b_at(f"N={cs.N_KNOTS} {'moved' if move else 'fixture'}",
                       cs.N_KNOTS, knob, move, kw64, rho_v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
