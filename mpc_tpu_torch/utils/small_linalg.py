"""Unrolled small-matrix inverses and factors over leading batch axes.

Counterpart of ``mpc_tpu/utils/small_linalg.py``: the same unrolled
elimination, term for term, so a float64 result equals the reference's bit
for bit.  Above n = 8 both hand over to the library routine.
"""
from __future__ import annotations

import torch


def inv_spd_small(M):
    """Inverse of a small SPD matrix (…, n, n) by unrolled Gauss–Jordan (no
    pivoting, stable for SPD); ``torch.linalg.inv`` above n = 8."""
    n = M.shape[-1]
    if n > 8:
        return torch.linalg.inv(M)
    A = M
    Inv = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    rows = torch.arange(n, device=M.device)
    for k in range(n):
        piv = A[..., k:k + 1, k:k + 1]
        rA = A[..., k:k + 1, :] / piv
        rI = Inv[..., k:k + 1, :] / piv
        mask = (rows == k)[:, None]
        f = torch.where(mask, torch.zeros_like(A[..., :, k:k + 1]), A[..., :, k:k + 1])
        A = torch.where(mask, rA, A - f * rA)
        Inv = torch.where(mask, rI, Inv - f * rI)
    return Inv


def chol_small(P):
    """Lower Cholesky factor of a small SPD matrix (…, n, n) by unrolled
    Cholesky–Banachiewicz; ``torch.linalg.cholesky`` above n = 8."""
    n = P.shape[-1]
    if n > 8:
        return torch.linalg.cholesky(P)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = P[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(P[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], -1)
                        for i in range(n)], -2)
