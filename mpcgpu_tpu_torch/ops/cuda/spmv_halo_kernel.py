"""K11: the banded SpMV over one knot shard with halo rows
(csrc/spmv_halo.cu).

Counterpart of mpcgpu_tpu/parallel/pcg_sharded_pallas.py
(``_spmv_halo_pallas``), in the port's knot-major layout: bands L, D, U
(nl, s, s), x (nl, s), halos xl and xr (s,), y (nl, s).  A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.cuda import _lib


def spmv_halo_reference(L, D, U, x, xl, xr):
    """y_k = L_k x_{k-1} + D_k x_k + U_k x_{k+1}, with x_{-1} = xl and
    x_{nl} = xr."""
    x_prev = torch.cat([xl[None], x[:-1]])
    x_next = torch.cat([x[1:], xr[None]])
    mv = lambda M, v: (M @ v.unsqueeze(-1)).squeeze(-1)
    return mv(D, x) + mv(L, x_prev) + mv(U, x_next)


def _launch(lib, L, D, U, x, xl, xr, stream):
    dev = x.device
    s = 2 * _lib.NJ
    if x.dim() != 2 or x.shape[1] != s or x.shape[0] < 1:
        raise ValueError(f"x must be (nl >= 1, {s}), got {tuple(x.shape)}")
    nl = x.shape[0]
    for name, t in (("L", L), ("D", D), ("U", U)):
        _lib.expect(t, name, (nl, s, s), dev)
    _lib.expect(x, "x", (nl, s), dev)
    _lib.expect(xl, "xl", (s,), dev)
    _lib.expect(xr, "xr", (s,), dev)
    y = torch.empty((nl, s), dtype=torch.float32, device=dev)
    _lib.check(lib.mpc_spmv_halo(nl, L.data_ptr(), D.data_ptr(), U.data_ptr(),
                                 x.data_ptr(), xl.data_ptr(), xr.data_ptr(),
                                 y.data_ptr(), stream), "mpc_spmv_halo")
    return y


def spmv_halo(L, D, U, x, xl, xr):
    """K11: y (nl, s) = the shard's rows of the block-tridiagonal product,
    the neighbours' edge rows xl, xr (s,) standing in for x_{-1} and
    x_{nl} (zeros at the global edges)."""
    if x.device.type == "cpu":
        return spmv_halo_reference(L, D, U, x, xl, xr)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = _launch(_lib.library(), L, D, U, x, xl, xr, _lib.stream_of(x))
    spmv_halo.launches += 1
    return y


spmv_halo.launches = 0
