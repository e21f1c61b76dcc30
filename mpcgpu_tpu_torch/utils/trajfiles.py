"""Trajectory fixture IO (counterpart of mpcgpu_tpu/utils/trajfiles.py).

The recorded fixtures are the IIWA's: ``{start}_{goal}_traj.csv`` rows
hold its 14 state + 7 control values (``NX``, ``NU``),
``{start}_{goal}_eepos.traj`` rows 6 end-effector pose values.  Only the
(0, 0) pair ships a recorded end-effector trace; given a model, the
loader makes the others' by forward kinematics.  ``horizon_slices`` takes
any state width: a synthesized fixture of another robot
(utils/synth.py) has rows of nx + nu values.  Numpy only, unless a model
is given.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

NX, NU = 14, 7   # the IIWA fixtures' state and control widths


def load_traj(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", dtype=np.float32)


def load_fixture_pair(directory, start: int = 0, goal: int = 0, model=None):
    """Returns (xu (T, 21), eepos (T, 6)) float32 arrays.

    Where the pair has no recorded end-effector trace (every pair but
    (0, 0), which is why the reference's drivers stop after the first
    combination, examples/track_iiwa_pcg.cu:177), pass a RobotModel: the
    trace is then the forward kinematics of the recorded joint positions,
    batched over the rows on the model's device -- how the recorded trace
    was made."""
    d = Path(directory)
    xu = load_traj(d / f"{start}_{goal}_traj.csv")
    if xu.shape[1] != NX + NU:
        raise ValueError(f"trajectory rows have {xu.shape[1]} values, "
                         f"expected {NX + NU}")
    ee_path = d / f"{start}_{goal}_eepos.traj"
    if ee_path.exists():
        ee = load_traj(ee_path)
        if ee.shape[1] != 6:
            raise ValueError(f"eepos rows have {ee.shape[1]} values, "
                             f"expected 6")
        return xu, ee
    if model is None:
        raise FileNotFoundError(
            f"{ee_path} missing; pass a RobotModel to make it by forward "
            f"kinematics")
    import torch

    from mpcgpu_tpu_torch.models import dynamics as dyn

    q = torch.as_tensor(xu[:, :NX // 2], dtype=model.Xc.dtype,
                        device=model.Xc.device)
    ee = dyn.ee_pos(model, q)
    return xu, ee.cpu().numpy().astype(np.float32)


def horizon_slices(xu: np.ndarray, ee: np.ndarray, knot_points: int,
                   nx: int = NX):
    """Initial (X, U, goals, xs) for an N-knot horizon at the trajectory start."""
    X = xu[:knot_points, :nx].copy()
    U = xu[:knot_points - 1, nx:].copy()
    goals = ee[:knot_points].copy()
    return X, U, goals, X[0].copy()
