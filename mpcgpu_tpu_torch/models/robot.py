"""Robot model container (counterpart of mpcgpu_tpu/models/robot.py).

The joint transforms are the exact affine decomposition in (sin q, cos q)
of the JAX package:

    X_i(q_i) = Xc[i] + sin(q_i) Xs[i] + cos(q_i) Xk[i]   (6x6, child <- parent)
    H_i(q_i) = Hc[i] + sin(q_i) Hs[i] + cos(q_i) Hk[i]   (4x4 homogeneous)
    dH_i     = d H_i / d q_i, same decomposition;  I[i]: 6x6 spatial inertia.

Serial chain, every joint revolute about its local z axis, spatial
vectors ordered [angular; linear].
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Mapping, NamedTuple

import numpy as np
import torch

FIELDS = ("Xc", "Xs", "Xk", "I", "Hc", "Hs", "Hk", "dHc", "dHs", "dHk")


class RobotModel(NamedTuple):
    Xc: torch.Tensor   # (nj, 6, 6)
    Xs: torch.Tensor
    Xk: torch.Tensor
    I: torch.Tensor    # (nj, 6, 6)
    Hc: torch.Tensor   # (nj, 4, 4)
    Hs: torch.Tensor
    Hk: torch.Tensor
    dHc: torch.Tensor  # (nj, 4, 4)
    dHs: torch.Tensor
    dHk: torch.Tensor

    @property
    def num_joints(self) -> int:
        return self.Xc.shape[0]


def robot_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
                     dtype=torch.float32) -> RobotModel:
    """Model from numpy tables keyed by the RobotModel field names."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"robot tables missing {missing}")
    return RobotModel(*(
        torch.tensor(np.asarray(arrays[f]), dtype=dtype, device=device)
        for f in FIELDS))


def _load_iiwa14_params():
    # The parameter file is numpy-only; load it by path so that the JAX
    # package's __init__ (which imports jax) never runs.
    path = (Path(__file__).resolve().parents[2] / "mpcgpu_tpu" / "models"
            / "iiwa14_params.py")
    spec = importlib.util.spec_from_file_location("_iiwa14_params", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def iiwa14(device="cpu", dtype=torch.float32) -> RobotModel:
    """The Kuka IIWA-14 7-DOF arm."""
    p = _load_iiwa14_params()
    return robot_from_numpy({f: getattr(p, f) for f in FIELDS}, device, dtype)
