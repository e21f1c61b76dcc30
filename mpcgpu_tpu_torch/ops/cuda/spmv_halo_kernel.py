"""K11: the banded SpMV over the knot shards of one process with the halo
rows outside them (csrc/spmv_halo.cu).

Counterpart of mpcgpu_tpu/parallel/pcg_sharded_pallas.py
(``_spmv_halo_pallas``), in the port's knot-major layout: bands L, D, U
(nl, s, s) and x, y (nl, s) per shard, halo rows xl and xr (s,).
``spmv_halo_shards`` takes the consecutive local shards of a mesh and
launches K11 once for all of them (once per ``mpc_spmv_halo_max_shards``
shards, 64): a row at a shard's edge reads the neighbouring shard's x row,
and only the rows outside the shards, xl before the first and xr after
the last, come from the caller.  ``spmv_halo`` is its one-shard case.  A
CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  ``spmv_halo.launches`` counts the launches of both.
"""
from __future__ import annotations

import ctypes

import torch

from mpcgpu_tpu_torch.ops.cuda import _lib


def spmv_halo_reference(L, D, U, x, xl, xr):
    """y_k = L_k x_{k-1} + D_k x_k + U_k x_{k+1}, with x_{-1} = xl and
    x_{nl} = xr."""
    x_prev = torch.cat([xl[None], x[:-1]])
    x_next = torch.cat([x[1:], xr[None]])
    mv = lambda M, v: (M @ v.unsqueeze(-1)).squeeze(-1)
    return mv(D, x) + mv(L, x_prev) + mv(U, x_next)


def spmv_halo_shards_reference(bands, xs, xl, xr):
    """spmv_halo_reference on each consecutive shard: its halo rows are its
    neighbours' edge rows, xl and xr at the ends."""
    last = len(xs) - 1
    return [spmv_halo_reference(*b, x, xs[i - 1][-1] if i > 0 else xl,
                                xs[i + 1][0] if i < last else xr)
            for i, (b, x) in enumerate(zip(bands, xs))]


def _launch(lib, bands, xs, xl, xr, stream) -> list:
    """One K11 call over the shards (a launch per max_shards of them);
    returns the shards' y, views of one (shards, nl, s) tensor."""
    if not xs or len(bands) != len(xs):
        raise ValueError(f"K11 needs one (L, D, U) triple per x shard, got "
                         f"{len(bands)} for {len(xs)}")
    dev = xs[0].device
    s = 2 * _lib.IIWA_NJ
    if xs[0].dim() != 2 or xs[0].shape[1] != s or xs[0].shape[0] < 1:
        raise ValueError(f"x must be (nl >= 1, {s}), got "
                         f"{tuple(xs[0].shape)}")
    nl = xs[0].shape[0]
    for i, ((L, D, U), x) in enumerate(zip(bands, xs)):
        for name, t in (("L", L), ("D", D), ("U", U)):
            _lib.expect(t, f"{name} of shard {i}", (nl, s, s), dev)
        _lib.expect(x, f"x of shard {i}", (nl, s), dev)
    _lib.expect(xl, "xl", (s,), dev)
    _lib.expect(xr, "xr", (s,), dev)
    y = torch.empty((len(xs), nl, s), dtype=torch.float32, device=dev)
    ys = list(y.unbind(0))
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(
        *(t.data_ptr() for t in ts))
    _lib.check(lib.mpc_spmv_halo(
        len(xs), nl, *(ptrs([b[j] for b in bands]) for j in range(3)),
        ptrs(xs), ptrs(ys), xl.data_ptr(), xr.data_ptr(), stream),
        "mpc_spmv_halo")
    return ys


def spmv_halo_shards(bands, xs, xl, xr) -> list:
    """K11 over consecutive shards: bands a list of (L, D, U) triples (nl,
    s, s), xs the shards' x (nl, s), xl x_{-1} of the first shard and xr
    x_{nl} of the last (s,) (zeros at the global edges); returns each
    shard's y (nl, s)."""
    if xs[0].device.type == "cpu":
        return spmv_halo_shards_reference(bands, xs, xl, xr)
    if xs[0].device.type != "cuda":
        raise ValueError(f"unsupported device {xs[0].device}")
    _lib.require_iiwa(_lib.width_joints(xs[0].shape[-1]),
                      "K11 (spmv_halo, the horizon-sharded CG's SpMV)")
    lib = _lib.library()
    ys = _launch(lib, bands, xs, xl, xr, _lib.stream_of(xs[0]))
    spmv_halo.launches += -(-len(xs) // lib.mpc_spmv_halo_max_shards())
    return ys


def spmv_halo(L, D, U, x, xl, xr):
    """K11 over one shard: y (nl, s) = the shard's rows of the
    block-tridiagonal product, the neighbours' edge rows xl, xr (s,)
    standing in for x_{-1} and x_{nl} (zeros at the global edges)."""
    if x.device.type == "cpu":
        return spmv_halo_reference(L, D, U, x, xl, xr)
    return spmv_halo_shards([(L, D, U)], [x], xl, xr)[0]


spmv_halo.launches = 0
