"""Port parity for K1's plain version: mpcgpu_tpu_torch's plant_rollout (CPU
tensors -> sim._plant_rollout + sim._tracking_error) vs the JAX ones.

Tolerance rtol 1e-4, atol 1e-5 (tests/test_rollout_pallas.py:26-29).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.sim import _plant_rollout, _tracking_error
from mpcgpu_tpu_torch.config import SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.ops.cuda.rollout_kernel import plant_rollout

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("offset_us,sim_time_us",
                         [(0.0, 2000.0), (2000.0, 2000.0), (1500.0, 700.0),
                          (60000.0, 2000.0)])
def test_k1_plain_matches_jax(iiwa, traj_0_0, offset_us, sim_time_us):
    xu, ee = traj_0_0
    rng = np.random.default_rng(2)
    xs = (xu[0, :14] + 0.05 * rng.normal(size=14)).astype(np.float32)
    U_prev = xu[:15, 14:].copy()
    x_ref = _plant_rollout(iiwa, JaxSolverConfig.for_knots(16),
                           jnp.asarray(xs), jnp.asarray(U_prev),
                           jnp.asarray(offset_us, jnp.float32),
                           jnp.asarray(sim_time_us, jnp.float32), 11)
    e_ref = _tracking_error(iiwa, x_ref, jnp.asarray(ee[0]))
    x, e = plant_rollout(iiwa14(device="cpu"), SolverConfig.for_knots(16),
                         torch.as_tensor(xs), torch.as_tensor(U_prev),
                         torch.as_tensor(ee[0]), offset_us, sim_time_us, 11)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), **TOL)
    np.testing.assert_allclose(float(e), float(e_ref), **TOL)
