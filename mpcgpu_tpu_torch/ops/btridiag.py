"""Block-tridiagonal storage and SpMV (counterpart of mpcgpu_tpu/ops/btridiag.py).

Three (N, s, s) bands, knot-major: ``lower[k]`` is row k's block in
column k-1 (``lower[0]`` = 0), ``diag[k]`` in column k, ``upper[k]`` in
column k+1 (``upper[N-1]`` = 0).  Leading dimensions (an arm axis) batch:
bands (..., N, s, s), vectors (..., N, s).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BlockTri(NamedTuple):
    lower: torch.Tensor  # (N, s, s)
    diag: torch.Tensor
    upper: torch.Tensor


def spmv(T: BlockTri, x: torch.Tensor) -> torch.Tensor:
    """y = T @ x for x shaped (..., N, s)."""
    z = torch.zeros_like(x[..., :1, :])
    x_prev = torch.cat([z, x[..., :-1, :]], dim=-2)
    x_next = torch.cat([x[..., 1:, :], z], dim=-2)
    mv = lambda M, v: (M @ v.unsqueeze(-1)).squeeze(-1)
    return mv(T.diag, x) + mv(T.lower, x_prev) + mv(T.upper, x_next)


def to_dense(T: BlockTri) -> torch.Tensor:
    """The (N s, N s) dense matrix of T (bands (N, s, s))."""
    n, s = T.diag.shape[0], T.diag.shape[-1]
    out = T.diag.new_zeros((n, s, n, s))
    k = torch.arange(n, device=T.diag.device)
    out[k, :, k, :] = T.diag
    out[k[1:], :, k[:-1], :] = T.lower[1:]
    out[k[:-1], :, k[1:], :] = T.upper[:-1]
    return out.reshape(n * s, n * s)
