"""Per-run result dumps (counterpart of mpcgpu_tpu/utils/results.py).

``dump_tracking_data`` (reference include/mpcsim.cuh:59-139): one
``<prefix>_<iter>_<kind>.result`` file per statistic and a stats summary,
so the reference's post-processing scripts read them unchanged.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def dump_tracking_data(record, prefix: str, test_iter: int, out_dir) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def fname(kind):
        return out / f"{prefix}_{test_iter}_{kind}.result"

    def dump(kind, values):
        with open(fname(kind), "w") as f:
            for v in values:
                f.write(f"{v}\n")

    dump("pcg_iters", record.pcg_iters)
    dump("pcg_exits", [int(b) for b in record.pcg_exits])
    dump("sqp_times", record.sqp_times_us)
    dump("sqp_iters", record.sqp_iters)
    dump("sqp_exits", [int(b) for b in record.sqp_exits])
    dump("tracking_errors", record.tracking_errors)

    # the fine-grained per-phase dumps (reference FINE_GRAINED_TIMING,
    # mpcsim.cuh:108-113), written only when the mode recorded them
    if getattr(record, "linsys_times_us", None):
        dump("kkt_times", record.kkt_times_us)
        dump("schur_times", record.schur_times_us)
        dump("linsys_times", record.linsys_times_us)
        dump("dz_times", record.dz_times_us)
        dump("line_search_times", record.line_search_times_us)

    with open(fname("tracking_path"), "w") as f:
        for row in record.tracking_path:
            f.write(",".join(str(x) for x in np.asarray(row)) + ",\n")

    with open(fname("stats"), "w") as f:
        f.write(f"timesteps: {record.timesteps}\n")
        f.write(f"control_updates: {record.control_updates}\n")
