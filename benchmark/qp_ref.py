"""A plain exact solver for the reference's QPs.

    min ½ xᵀP x + qᵀx   s.t.   G x ≤ h

over a leading batch axis, by Mehrotra's primal-dual interior-point method
in the caller's dtype (float64 for the reference).  Every problem runs a
fixed number of iterations with no host synchronisation, and the small
Newton systems are solved by an unrolled Cholesky factorization written
in elementwise operations, so that a CUDA graph can capture the whole
solve; a problem whose complementarity gap has fallen below ``tol``
stops moving.  The returned
``kkt`` is each problem's largest scaled KKT residual (stationarity,
primal feasibility and the gap), the certificate that the answer is the
optimum to the printed accuracy.  It shares no code with the port's ADMM
or Goldfarb–Idnani solvers.
"""
from __future__ import annotations

import torch

from .precision import FLOAT64


def _max_step(v, dv):
    """The largest α ≤ 1 with v + α dv ≥ 0, per problem."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return torch.clamp(ratio.amin(-1, keepdim=True), max=1.0)


def cholesky(M):
    """The lower Cholesky factor of each symmetric positive definite (n, n)
    matrix of ``M``, column by column."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        d = torch.sqrt(M[:, j, j] - (L[:, j, :j] ** 2).sum(-1))
        L[:, j, j] = d
        if j + 1 < n:
            L[:, j + 1:, j] = (M[:, j + 1:, j] - (L[:, j + 1:, :j] * L[:, j, None, :j]).sum(-1)
                               ) / d[:, None]
    return L


def cholesky_solve(L, b):
    """x with L Lᵀ x = b, by forward then back substitution."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        y[:, i] = (b[:, i] - (L[:, i, :i] * y[:, :i]).sum(-1)) / L[:, i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[:, i] = (y[:, i] - (L[:, i + 1:, i] * x[:, i + 1:]).sum(-1)) / L[:, i, i]
    return x


def solve(P, q, G, h, iters=25, tol=1e-15, ar=FLOAT64):
    """``(x, kkt)``: the optimum (L, n) and its residual (L,).

    ``P`` (L, n, n) symmetric positive definite, ``q`` (L, n), ``G``
    (L, m, n), ``h`` (L, m); every row is finite.  ``ar`` is the
    arithmetic of the matrix products (``precision.Arith``)."""
    m = G.shape[1]
    GT = G.transpose(1, 2)
    Gx = lambda x: ar.mv(G, x)
    GTv = lambda v: ar.mv(GT, v)
    Pv = lambda x: ar.mv(P, x)
    x = -cholesky_solve(cholesky(P), q)
    s = torch.clamp(h - Gx(x), min=1.0)
    z = torch.ones_like(s)
    scale = 1.0 + q.abs().amax(-1, keepdim=True) + h.abs().amax(-1, keepdim=True)
    for _ in range(iters):
        rd = Pv(x) + q + GTv(z)
        rp = Gx(x) + s - h
        mu = (s * z).sum(-1, keepdim=True) / m
        live = mu > tol * scale
        w = z / s
        chol = cholesky(P + ar.mm(GT, w.unsqueeze(-1) * G))

        def newton(rc):
            rhs = -rd - GTv(w * rp - rc / s)
            dx = cholesky_solve(chol, rhs)
            Gdx = Gx(dx)
            return dx, w * (Gdx + rp) - rc / s, -rp - Gdx

        dx, dz, ds = newton(s * z)
        a = torch.minimum(_max_step(s, ds), _max_step(z, dz))
        mu_aff = ((s + a * ds) * (z + a * dz)).sum(-1, keepdim=True) / m
        sigma = (mu_aff / mu) ** 3
        dx, dz, ds = newton(s * z + ds * dz - sigma * mu)
        a = 0.99 * torch.minimum(_max_step(s, ds), _max_step(z, dz))
        finite = torch.cat([dx, dz, ds, a], -1).isfinite().all(-1, keepdim=True)
        live = live & finite
        x = torch.where(live, x + a * dx, x)
        s = torch.where(live, s + a * ds, s)
        z = torch.where(live, z + a * dz, z)
    rd = (Pv(x) + q + GTv(z)).abs().amax(-1)
    viol = torch.clamp(Gx(x) - h, min=0).amax(-1)
    gap = (s * z).sum(-1) / m
    kkt = torch.maximum(torch.maximum(rd, viol), gap) / scale.squeeze(-1)
    return x, kkt
