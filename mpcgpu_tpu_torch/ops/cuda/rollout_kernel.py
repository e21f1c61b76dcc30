"""K1: plant rollout over one control period (csrc/rollout.cu).

Counterpart of mpcgpu_tpu/ops/pallas/rollout_kernel.py.  A CPU tensor
runs the plain version (``sim._plant_rollout`` + ``sim._tracking_error``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.cuda import _lib


def plant_rollout_reference(model, cfg, x, U_prev, goal0, offset_us,
                            sim_time_us, max_substeps: int):
    from mpcgpu_tpu_torch.sim import _plant_rollout, _tracking_error

    x_new = _plant_rollout(model, cfg, x, U_prev, offset_us, sim_time_us,
                           max_substeps)
    return x_new, _tracking_error(model, x_new, goal0)


def _launch(lib, tab, cfg, x, U_prev, goal0, offset_us, sim_time_us,
            max_substeps: int, stream):
    dev = x.device
    nx = _lib.NJ * 2
    _lib.expect(x, "x", (nx,), dev)
    if U_prev.dim() != 2 or U_prev.shape[1] != _lib.NJ or U_prev.shape[0] < 1:
        raise ValueError(f"U_prev must be (N-1, {_lib.NJ}), got "
                         f"{tuple(U_prev.shape)}")
    _lib.expect(U_prev, "U_prev", tuple(U_prev.shape), dev)
    _lib.expect(goal0, "goal0", tuple(goal0.shape), dev)
    if goal0.numel() < 3:
        raise ValueError("goal0 needs at least 3 entries")
    _lib.expect(tab, "tables", (_lib.TAB_SIZE,), dev)
    x_new = torch.empty_like(x)
    err = torch.empty((), dtype=torch.float32, device=dev)
    rc = lib.mpc_rollout(
        tab.data_ptr(), x.data_ptr(), U_prev.data_ptr(), U_prev.shape[0],
        goal0.data_ptr(), float(offset_us), float(sim_time_us),
        float(cfg.timestep), float(cfg.sim_step_time), int(max_substeps),
        float(cfg.gravity), x_new.data_ptr(), err.data_ptr(), stream)
    _lib.check(rc, "mpc_rollout")
    return x_new, err


def plant_rollout(model, cfg, x, U_prev, goal0, offset_us, sim_time_us,
                  max_substeps: int):
    """Integrate the plant for sim_time_us from x with the previous plan
    U_prev (N-1, nu); return (x_new (nx,), L1 xyz tracking error vs goal0).

    offset_us and sim_time_us are host numbers (the control schedule is
    known on the host)."""
    if x.device.type == "cpu":
        return plant_rollout_reference(model, cfg, x, U_prev, goal0,
                                       offset_us, sim_time_us, max_substeps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(_lib.library(), _lib.model_tables(model), cfg, x, U_prev,
                  goal0, offset_us, sim_time_us, max_substeps,
                  _lib.stream_of(x))
    plant_rollout.launches += 1
    return out


plant_rollout.launches = 0
