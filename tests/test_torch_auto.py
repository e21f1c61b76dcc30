"""Port parity for linsys="auto": mpcgpu_tpu_torch.sim.simulate_mpc_scan
vs the JAX one, N = 8, 8 updates, on CPU, mirroring
tests/test_auto_failover.py: never tripped (equal to pcg), always tripped
with the per-update latch (switch after update 0), and always tripped
with a 2-update chunk (switch at the chunk boundary, update 2).

The port runs plain (fused_stages=False) and fused with the whole-solve
megakernel configuration (on CPU tensors: each kernel's plain version);
the JAX package runs its portable path.  Tolerances: failed_over exact;
per-update tracking errors at atol 1e-3 and the tracking path at atol
5e-3 (tests/test_torch_closed_loop.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import PCGConfig as JaxPCGConfig
from mpcgpu_tpu.config import SolverConfig as JaxSolverConfig
from mpcgpu_tpu.sim import simulate_mpc_scan as jax_simulate_mpc_scan
from mpcgpu_tpu_torch.config import PCGConfig, SolverConfig
from mpcgpu_tpu_torch.models.robot import iiwa14
from mpcgpu_tpu_torch.sim import simulate_mpc_scan

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 8            # power of 2: the bcr_pcg branch needs it
N_UPDATES = 8
TOL = 1e-5
CASES = {
    "never": dict(failover_bail_rate=1.5),
    "per_update": dict(failover_bail_rate=-1.0, failover_err_threshold_m=-1.0,
                       failover_check_every=1),
    "chunk2": dict(failover_bail_rate=-1.0, failover_err_threshold_m=-1.0,
                   failover_check_every=2),
}
SWITCH = {"never": N_UPDATES, "per_update": 1, "chunk2": 2}


def _port(xu, ee, cfg, linsys):
    T = torch.as_tensor
    return simulate_mpc_scan(
        iiwa14(device="cpu"), cfg, T(xu), T(ee), T(xu[:N, :14]),
        T(xu[:N - 1, 14:].copy()), torch.zeros(N, 14), 1e-3, TOL, N_UPDATES,
        linsys)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_auto_matches_jax(iiwa, traj_0_0, case, fused):
    xu, ee = traj_0_0
    kw = dict(sqp_max_iter=3, **CASES[case])
    jcfg = JaxSolverConfig.for_knots(N, pcg=JaxPCGConfig(max_iter=40), **kw)
    ref = jax_simulate_mpc_scan(
        iiwa, jcfg, jnp.asarray(xu), jnp.asarray(ee), jnp.asarray(xu[:N, :14]),
        jnp.asarray(xu[:N - 1, 14:]), jnp.zeros((N, 14), jnp.float32),
        jnp.asarray(1e-3, jnp.float32), TOL, N_UPDATES, linsys="auto")
    cfg = SolverConfig.for_knots(N, pcg=PCGConfig(max_iter=40), **kw)
    if fused:
        cfg = dataclasses.replace(cfg, fused_stages=True, megakernel=True,
                                  megakernel_solve=True)
    got = _port(xu, ee, cfg, "auto")

    fo = got["failed_over"].numpy()
    np.testing.assert_array_equal(fo, np.asarray(ref["failed_over"]))
    assert not fo[:SWITCH[case]].any() and fo[SWITCH[case]:].all(), fo
    np.testing.assert_allclose(got["tracking_errors"].numpy(),
                               np.asarray(ref["tracking_errors"]), atol=1e-3)
    np.testing.assert_allclose(got["tracking_path"].numpy(),
                               np.asarray(ref["tracking_path"]), atol=5e-3)
    if case == "never":
        # an untripped latch is the pcg run, number for number
        pcg = _port(xu, ee, cfg, "pcg")
        for key in ("tracking_path", "tracking_errors", "pcg_iters_total"):
            torch.testing.assert_close(got[key], pcg[key], rtol=0, atol=0)
        assert "failed_over" not in pcg
