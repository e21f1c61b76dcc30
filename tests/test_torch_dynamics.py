"""Port parity: mpcgpu_tpu_torch.models.dynamics vs mpcgpu_tpu.models.dynamics.

Same seeded states (numpy) through both, CPU, float32.  Tolerance: rtol
1e-4 per element plus 1e-4 of the array's largest magnitude (float32
rounding through 7-joint recursions; Minv and dqdd reach ~1e2-1e3).
"""
import jax
import numpy as np
import pytest
import torch

from mpcgpu_tpu.models import dynamics as jdyn
from mpcgpu_tpu.models.robot import RobotModel as JaxRobotModel
from mpcgpu_tpu_torch.models import dynamics as tdyn
from mpcgpu_tpu_torch.models.robot import iiwa14, robot_from_numpy

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_STATES = 8


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                               atol=1e-4 * np.abs(j).max())


@pytest.fixture(scope="module")
def models(iiwa):
    return iiwa, iiwa14(device="cpu")


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(0)
    f = lambda a: a.astype(np.float32)
    return (f(rng.uniform(-2, 2, (N_STATES, 7))), f(rng.normal(size=(N_STATES, 7))),
            f(rng.normal(size=(N_STATES, 7))), f(rng.normal(size=(N_STATES, 7))))


def test_robot_from_numpy_matches_iiwa14(iiwa):
    got = robot_from_numpy({f: np.asarray(getattr(iiwa, f))
                            for f in JaxRobotModel._fields}, device="cpu")
    for a, b in zip(got, iiwa14(device="cpu")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn", ["rnea", "mass_matrix", "minv",
                                "forward_dynamics", "ee_pos"])
def test_dynamics_function_matches_jax(models, states, fn):
    jm, tm = models
    q, qd, qdd, u = states
    args = {"rnea": (q, qd, qdd), "mass_matrix": (q,), "minv": (q,),
            "forward_dynamics": (q, qd, u), "ee_pos": (q,)}[fn]
    want = jax.vmap(lambda *a: getattr(jdyn, fn)(jm, *a))(*args)
    got = getattr(tdyn, fn)(tm, *(torch.as_tensor(a) for a in args))
    _close(got, want)


def test_ee_pos_and_jac_matches_jax(models, states):
    jm, tm = models
    q = states[0]
    ee_j, J_j = jax.vmap(lambda a: jdyn.ee_pos_and_jac(jm, a))(q)
    ee_t, J_t = tdyn.ee_pos_and_jac(tm, torch.as_tensor(q))
    _close(ee_t, ee_j)
    _close(J_t, J_j)


def test_fd_and_gradient_matches_jax(models, states):
    jm, tm = models
    q, qd, _, u = states
    want = jax.vmap(lambda a, b, c: jdyn.fd_and_gradient(jm, a, b, c))(q, qd, u)
    got = tdyn.fd_and_gradient(tm, *(torch.as_tensor(a) for a in (q, qd, u)))
    for g, w in zip(got, want):
        _close(g, w)
