"""Synthesized tracking fixtures for any robot (counterpart of
mpcgpu_tpu/utils/synth.py).

Only the IIWA ships recorded trajectories (tests/fixtures/trajfiles).
Given any RobotModel, this makes a dynamically consistent reference
trajectory in the trajfile format (xu rows = [q, qd, u], ee rows = [x, y,
z, roll, pitch, yaw]), so the closed MPC loop -- plain modules and the
CUDA kernels -- runs on a second robot end to end.

Construction: per-joint sinusoids q(t) = q0 + A sin(w t + phi) give q, qd
and qdd in closed form (float64, then float32); the control is the
inverse-dynamics torque u = RNEA(q, qd, qdd), so (q, qd, u) satisfies the
plant dynamics; the end-effector trace is the forward kinematics of q(t).
RNEA and FK run batched over the rows on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from mpcgpu_tpu_torch.models import dynamics as dyn


def synthesize_tracking_fixture(model, q0, amplitude, n_steps: int,
                                dt: float, periods=1.0, phase=None,
                                gravity: float = 0.0):
    """Return (xu (T, nx+nu), ee (T, 6)) float32 numpy arrays in trajfile
    format.

    Args:
      model:     RobotModel (any joint count).
      q0:        (nq,) center configuration.
      amplitude: scalar or (nq,) sinusoid amplitude per joint [rad].
      n_steps:   trajectory rows T.
      dt:        row spacing [s] (the tracking loop's cfg.timestep).
      periods:   how many full sinusoid periods the T rows span.
      phase:     optional (nq,) per-joint phase offsets [rad]; defaults to
                 an even spread over [0, pi/2] so the joints do not move
                 in lockstep.
      gravity:   passed to the inverse dynamics (the IIWA fixtures are
                 gravity-free).
    """
    q0 = np.asarray(q0, np.float32)
    nq = q0.shape[0]
    amp = np.broadcast_to(np.asarray(amplitude, np.float32), (nq,))
    if phase is None:
        phase = np.linspace(0.0, np.pi / 2, nq, dtype=np.float32)
    else:
        phase = np.asarray(phase, np.float32)

    t = (np.arange(n_steps, dtype=np.float64) * dt)[:, None]      # (T, 1)
    w = 2.0 * np.pi * float(periods) / (n_steps * dt)
    q = q0[None] + amp[None] * np.sin(w * t + phase[None])
    qd = amp[None] * w * np.cos(w * t + phase[None])
    qdd = -amp[None] * w * w * np.sin(w * t + phase[None])
    q, qd, qdd = (a.astype(np.float32) for a in (q, qd, qdd))

    dev, dtype = model.Xc.device, model.Xc.dtype
    qt, qdt, qddt = (torch.tensor(a, dtype=dtype, device=dev)
                     for a in (q, qd, qdd))
    with torch.no_grad():
        u = dyn.rnea(model, qt, qdt, qddt, gravity)
        ee = dyn.ee_pos(model, qt)
    u = u.to(torch.float32).cpu().numpy()
    xu = np.concatenate([q, qd, u], axis=1)
    return xu, ee.to(torch.float32).cpu().numpy()
