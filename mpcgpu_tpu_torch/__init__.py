"""mpcgpu_tpu_torch: the PyTorch + CUDA port of mpcgpu_tpu.

Real-time nonlinear MPC by SQP with block-tridiagonal Schur condensation
and stair-preconditioned CG, written for an NVIDIA H100.  Module names
mirror the JAX package (``mpcgpu_tpu``), which stays the reference.

Plain PyTorch modules (``models``, ``ops``) hold the math on any device;
``ops/cuda`` holds the hand-written Hopper kernels (sources under
``csrc/``) with a plain version beside each.  A kernel wrapper runs its
plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.
"""

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models.robot import RobotModel, iiwa14, robot_from_numpy

__version__ = "0.1.0"
