"""Block-tridiagonal storage and SpMV (counterpart of mpcgpu_tpu/ops/btridiag.py).

Three (N, s, s) bands, knot-major: ``lower[k]`` is row k's block in
column k-1 (``lower[0]`` = 0), ``diag[k]`` in column k, ``upper[k]`` in
column k+1 (``upper[N-1]`` = 0).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BlockTri(NamedTuple):
    lower: torch.Tensor  # (N, s, s)
    diag: torch.Tensor
    upper: torch.Tensor


def spmv(T: BlockTri, x: torch.Tensor) -> torch.Tensor:
    """y = T @ x for x shaped (N, s)."""
    z = torch.zeros_like(x[:1])
    x_prev = torch.cat([z, x[:-1]], dim=0)
    x_next = torch.cat([x[1:], z], dim=0)
    mv = lambda M, v: (M @ v.unsqueeze(-1)).squeeze(-1)
    return mv(T.diag, x) + mv(T.lower, x_prev) + mv(T.upper, x_next)
