"""The torch.distributed form of the port's sharded paths, one process per
rank, against the in-process mesh of as many shards.

``run_ranks(case, world, workdir)`` writes ``case`` (a dict of tensors and
numbers, see ``_run``) to workdir, starts ``world`` processes of this file
as a script, each a rank of a gloo group joined through a FileStore in
workdir, waits for them (killing them all if one fails or the time runs
out), and returns each rank's results.  Each rank runs, on the case's
device (gloo with CPU tensors, or with CUDA tensors on one card),
pcg_sharded and pcg_sharded_cuda on the case's Schur system and, where the
case has one, sharded_sqp_solve(fused_pcg=True): over the group (one shard
per rank) and over an in-process mesh of ``world`` shards, so that the
caller can hold the two forms equal bit for bit.

Used by the CPU tests and by chip_smoke.py (which loads this file by
path).  Imports no JAX and no pytest: it runs on the card machine too.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def _flat(res) -> dict:
    """An SQPResult as a flat dict of tensors."""
    out = {f: getattr(res, f) for f in ("X", "U", "lam", "rho")}
    out.update(res.stats._asdict())
    return out


def _run(case: dict, rank: int, world: int, workdir: Path) -> dict:
    import torch.distributed as dist

    from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
    from mpcgpu_tpu_torch.models.robot import iiwa14
    from mpcgpu_tpu_torch.ops.btridiag import BlockTri
    from mpcgpu_tpu_torch.ops.cuda.spmv_halo_kernel import spmv_halo
    from mpcgpu_tpu_torch.parallel.pcg_sharded import pcg_sharded
    from mpcgpu_tpu_torch.parallel.pcg_sharded_cuda import pcg_sharded_cuda
    from mpcgpu_tpu_torch.parallel.sharded import (horizon_mesh,
                                                   sharded_sqp_solve)

    dev = torch.device(case["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        meshes = {"ranks": horizon_mesh(device=dev),
                  "in_process": horizon_mesh(world, device=dev)}
        on = lambda t: t.to(dev)
        p = case["pcg"]
        S, P = (BlockTri(*map(on, p[k])) for k in ("S", "P"))
        args = (S, P, on(p["gamma"]), on(p["lam0"]), p["max_iter"], p["tol"])
        out = {}
        spmv_halo.launches = 0
        for form, mesh in meshes.items():
            for fn in (pcg_sharded, pcg_sharded_cuda):
                out.setdefault(fn.__name__, {})[form] = fn(mesh, *args)
            if form == "ranks":
                out["k11_launches"] = spmv_halo.launches
        q = case.get("sqp")
        if q is not None:
            cfg = SolverConfig.for_knots(q["X"].shape[0],
                                         sqp_max_iter=q["sqp_max_iter"],
                                         pcg=PCGConfig(max_iter=q["cap"]))
            model = iiwa14(device=dev)
            sq = tuple(on(q[k]) for k in ("X", "U", "lam", "goals", "xs"))
            out["sqp_fused"] = {
                form: _flat(sharded_sqp_solve(model, cfg, mesh, *sq,
                                              q["rho"], q["tol"],
                                              fused_pcg=True))
                for form, mesh in meshes.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    return out


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def run_ranks(case: dict, world: int, workdir, timeout: float = 600.0):
    """Run case on world ranks (module doc); return the ranks' results,
    rank order, on the CPU.  Raises if a rank fails or times out."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(case, workdir / "case.pt")
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(workdir),
             str(r), str(world)], env=env, stdout=log,
            stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
        deadline = time.monotonic() + timeout
        while True:
            rcs = [proc.poll() for proc in procs]
            # every rank done, or one failed (the others would wait for it)
            if None not in rcs or any(rc not in (None, 0) for rc in rcs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s (logs in {workdir})")
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    failed = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
    if failed:
        tail = (workdir / f"rank{failed[0]}.log").read_text()[-4000:]
        raise RuntimeError(f"ranks {failed} of {world} failed (rcs {rcs}); "
                           f"rank {failed[0]}'s log ends:\n{tail}")
    return [torch.load(workdir / f"rank{r}.pt") for r in range(world)]


def main(argv) -> int:
    workdir, rank, world = Path(argv[1]), int(argv[2]), int(argv[3])
    torch.set_num_threads(1)
    case = torch.load(workdir / "case.pt")
    out = _run(case, rank, world, workdir)
    torch.save(_to_cpu(out), workdir / f"rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main(sys.argv))
