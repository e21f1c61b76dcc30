"""Batched inverses of small SPD matrices (counterpart of mpcgpu_tpu/ops/smallinv.py).

Recursive 2x2 block partitioning with closed-form 1x1..3x3 base cases,

    inv([[P, Q], [Q', S]]) via  Pi = inv(P),  T = S - Q' Pi Q,

the same arithmetic as the JAX package so that the two agree to float
rounding.  Inputs are symmetric positive definite.
"""
from __future__ import annotations

import torch


def _inv2(A):
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def _inv3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of batched SPD matrices (..., n, n)."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    if n == 2:
        return _inv2(A)
    if n == 3:
        return _inv3(A)
    m = n // 2
    P = A[..., :m, :m]
    Q = A[..., :m, m:]
    S = A[..., m:, m:]
    Pi = spd_inverse(P)
    PiQ = Pi @ Q
    T = S - Q.transpose(-1, -2) @ PiQ
    Ti = spd_inverse(T)
    TR = -PiQ @ Ti
    TL = Pi - TR @ PiQ.transpose(-1, -2)
    return torch.cat([torch.cat([TL, TR], dim=-1),
                      torch.cat([TR.transpose(-1, -2), Ti], dim=-1)], dim=-2)
