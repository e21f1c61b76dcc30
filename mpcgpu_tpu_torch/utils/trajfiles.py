"""Trajectory fixture IO (counterpart of mpcgpu_tpu/utils/trajfiles.py), numpy only.

``{start}_{goal}_traj.csv`` rows hold 14 state + 7 control values,
``{start}_{goal}_eepos.traj`` rows 6 end-effector pose values.  Only the
(0, 0) pair ships a recorded end-effector trace.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

NX, NU = 14, 7


def load_traj(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", dtype=np.float32)


def load_fixture_pair(directory, start: int = 0, goal: int = 0):
    """Returns (xu (T, 21), eepos (T, 6)) float32 arrays for a pair with a
    recorded end-effector trace."""
    d = Path(directory)
    xu = load_traj(d / f"{start}_{goal}_traj.csv")
    if xu.shape[1] != NX + NU:
        raise ValueError(f"trajectory rows have {xu.shape[1]} values, "
                         f"expected {NX + NU}")
    ee_path = d / f"{start}_{goal}_eepos.traj"
    if not ee_path.exists():
        raise FileNotFoundError(
            f"{ee_path} missing: only pairs with a recorded end-effector "
            f"trace load here")
    ee = load_traj(ee_path)
    if ee.shape[1] != 6:
        raise ValueError(f"eepos rows have {ee.shape[1]} values, expected 6")
    return xu, ee


def horizon_slices(xu: np.ndarray, ee: np.ndarray, knot_points: int,
                   nx: int = NX):
    """Initial (X, U, goals, xs) for an N-knot horizon at the trajectory start."""
    X = xu[:knot_points, :nx].copy()
    U = xu[:knot_points - 1, nx:].copy()
    goals = ee[:knot_points].copy()
    return X, U, goals, X[0].copy()
