"""Planar 2R arm: the second robot (counterpart of
mpcgpu_tpu/models/planar2r.py).

A two-revolute-joint planar arm (unit links, textbook inertias) loaded
through the URDF seam (models/urdf.py), so the whole solver -- the plain
modules, the CUDA kernels K1-K5 (built for two joints), the closed MPC
loop -- runs with nq != 7: nq = 2, nx = 4, nu = 2.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.models.urdf import model_from_urdf

PLANAR_2R_URDF = """<?xml version="1.0"?>
<robot name="planar2r">
  <link name="base"/>
  <link name="l1">
    <inertial>
      <origin xyz="0.5 0 0"/>
      <mass value="2.0"/>
      <inertia ixx="0.01" iyy="0.2" izz="0.2" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="l2">
    <inertial>
      <origin xyz="0.4 0 0"/>
      <mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.1" izz="0.1" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="1.0 0 0"/><axis xyz="0 0 1"/>
  </joint>
  <link name="ee"/>
  <joint name="ee_fixed" type="fixed">
    <parent link="l2"/><child link="ee"/>
    <origin xyz="1.0 0 0"/>
  </joint>
</robot>
"""


def planar2r(device="cuda", dtype=torch.float32) -> RobotModel:
    """RobotModel of the planar 2R arm, on the card unless the caller names
    another device."""
    return model_from_urdf(PLANAR_2R_URDF, device, dtype)
