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

from typing import Mapping, NamedTuple

import numpy as np
import torch

from mpcgpu_tpu_torch.models import iiwa14_params

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


def robot_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda",
                     dtype=torch.float32) -> RobotModel:
    """Model from numpy tables keyed by the RobotModel field names, on the
    card unless the caller names another device."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"robot tables missing {missing}")
    return RobotModel(*(
        torch.tensor(np.asarray(arrays[f]), dtype=dtype, device=device)
        for f in FIELDS))


def iiwa14(device="cuda", dtype=torch.float32) -> RobotModel:
    """The Kuka IIWA-14 7-DOF arm (models/iiwa14_params.py), on the card
    unless the caller names another device."""
    return robot_from_numpy({f: getattr(iiwa14_params, f) for f in FIELDS},
                            device, dtype)
