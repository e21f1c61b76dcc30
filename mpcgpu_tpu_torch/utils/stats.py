"""Distributional statistics helpers (counterpart of
mpcgpu_tpu/utils/stats.py), numpy only.

The reference's stats printers (include/utils/experiment.cuh:17-142:
``printStats`` with a histogram and percentiles, ``getStatsString``'s CSV
row).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def describe(values: Sequence[float]) -> dict:
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return {k: float("nan") for k in
                ("average", "std_dev", "min", "max", "median", "q1", "q3")}
    return {
        "average": float(v.mean()),
        "std_dev": float(v.std()),
        "min": float(v.min()),
        "max": float(v.max()),
        "median": float(np.median(v)),
        "q1": float(np.percentile(v, 25)),
        "q3": float(np.percentile(v, 75)),
    }


def stats_csv_row(values: Sequence[float]) -> str:
    """CSV row "Average,Std Dev,Min,Max,Median,Q1,Q3" (experiment.cuh:89)."""
    d = describe(values)
    return ",".join(
        f"{d[k]:.6g}"
        for k in ("average", "std_dev", "min", "max", "median", "q1", "q3")
    )


def print_stats(values: Sequence[float], name: str = "", bins: int = 10) -> str:
    """Print the summary and an ASCII histogram (experiment.cuh:17-75);
    return the CSV row for archiving."""
    d = describe(values)
    v = np.asarray(values, np.float64)
    print(f"[{name}] n={v.size} avg={d['average']:.6g} std={d['std_dev']:.6g} "
          f"min={d['min']:.6g} max={d['max']:.6g} median={d['median']:.6g} "
          f"Q1={d['q1']:.6g} Q3={d['q3']:.6g}")
    if v.size > 1 and d["max"] > d["min"]:
        hist, edges = np.histogram(v, bins=bins)
        peak = hist.max()
        for h, lo, hi in zip(hist, edges[:-1], edges[1:]):
            bar = "#" * int(round(40 * h / peak))
            print(f"  [{lo:10.4g}, {hi:10.4g}) {h:6d} {bar}")
    return f"{name}," + stats_csv_row(values)


def dump_matrix(path, mat, fmt: str = "%.9g") -> None:
    """Write a matrix to a text file for offline inspection
    (``write_device_matrix_to_file``, include/utils/matrix.cuh:241-266).
    A tensor is copied to the host first."""
    if hasattr(mat, "detach"):
        mat = mat.detach().cpu().numpy()
    np.savetxt(path, np.asarray(mat), fmt=fmt, delimiter=",")
