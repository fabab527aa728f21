"""Batched Goldfarb–Idnani dual active-set QP solver (torch).

Counterpart of ``mpc_tpu/ops/qp_active.py``: the same problem

    min ½xᵀPx + qᵀx   s.t.   l ≤ Ax ≤ u      (P SPD, ±BIG one-sided rows)

the same warm starts (``y0`` dual seeding, ``state0`` cross-period operator
carry), slot cap (``max_active``) with its one-shot cold restart, traced
``iter_budget`` and infeasibility certificate, written over a leading lane
axis instead of under ``vmap``.

* ``P``/``A`` and the cache's ``gic_Pinv`` are stacked over the fleet's
  DISTINCT controllers; lane ``b`` reads controller ``lane_ctrl[b]``.
  ``q``, ``l``, ``u`` and the warm starts are per lane.
* The whole per-lane solve is ``ops/gi_kernel.py::gi_solve``: the
  hand-written CUDA kernel on the GPU (one block per lane, each lane exits
  on its own), its plain version on the CPU.
* Precision: the violation scan and the ``Aact`` slot table stay in the
  data dtype; x, λ, P⁻¹ and Ginv live in the SLOT dtype.  float64 data has
  float64 slots; float32 data has float64 slots by default (the reference's
  mixed mode under x64) or float32 slots when ``slot_dtype=torch.float32``
  (the reference's pure-f32 session).

P⁻¹ comes from the cache (``cache=build_gi_cache(...)``, what every
``LinMPC`` step uses) or, with ``cache=None``, from an in-solve inverse per
distinct controller: the unrolled Gauss–Jordan of ``utils/small_linalg.py``
in the slot dtype for n ≤ 8, a Cholesky solve in the data dtype cast to the
slot dtype above (the reference's ``qp_active.py:206-219``).  The solve
itself is ``gi_solve`` either way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.lanes import identity_lanes, mv
from ..utils.small_linalg import inv_spd_small
from .gi_kernel import gi_solve, slot_dtype_for
from .qp import QPSolution, _BIG


def build_gi_cache(P, A):
    """The step-invariant part of :func:`solve_qp_active` (host NumPy f64).

    A verbatim copy of ``mpc_tpu.ops.qp_active.build_gi_cache``: the inverse
    of P with one Newton refinement step.  ``A`` is accepted for symmetry
    with ``build_solver_cache`` and unused.
    """
    del A
    P = np.asarray(P, np.float64)
    n = P.shape[0]
    Pinv = np.linalg.inv(P)
    Pinv = Pinv @ (2.0 * np.eye(n) - P @ Pinv)   # Newton: squares residual
    return dict(gic_Pinv=Pinv)


def gi_state_init(n_slots, batch, slot_dtype=torch.float64, device=None):
    """Fresh cross-period GI operator state (empty active set) for ``batch``
    lanes of ``n_slots`` slots.  ``slot_dtype`` is the solver's slot dtype
    (torch has no global x64 switch, so it is explicit)."""
    z = torch.zeros(batch, n_slots, dtype=torch.int32, device=device)
    eye = torch.eye(n_slots, dtype=slot_dtype, device=device)
    return dict(gis_idx=z, gis_side=z.clone(),
                gis_vmask=torch.zeros(batch, n_slots, dtype=torch.bool, device=device),
                gis_Ginv=eye.expand(batch, n_slots, n_slots).contiguous())


def solve_qp_active(P, q, A, l, u, y0=None, *, lane_ctrl=None, a_ctrl=None, cache=None,
                    state0=None, iter_budget=None, max_active=None,
                    max_pivots=150, tol=1e-9, slot_dtype=None, solve=gi_solve):
    """Solve a batch of dense QPs by dual active set.

    ``P`` (n_d, n, n), ``A`` (n_d, m, n) and ``cache["gic_Pinv"]`` (n_d, n, n)
    are stacked over distinct controllers (``cache=None``: P⁻¹ is computed
    here, see the module docstring); ``q`` (B, n), ``l``/``u`` (B, m)
    and ``y0`` (B, m) are per lane.  ``lane_ctrl`` (B,) int32 maps lanes to
    controllers; ``None`` means n_d == B.  ``a_ctrl`` (B,) int32, the A
    map, reads ``A`` (n_a, m, n) through a map of its own (P and P⁻¹ still
    through ``lane_ctrl``): a fleet whose lanes share one A but not one P
    passes A once; ``None`` reads A through ``lane_ctrl``.

    ``y0`` seeds the warm list from previous duals (sign → side, magnitude
    ranks the candidates); ``state0`` (the ``gi_state`` of the previous
    period for the same P, A) re-enters at the warm-KKT point and overrides
    ``y0``.  ``iter_budget`` (int or (B,) ints) is ANDed with
    ``max_pivots``.  ``max_active`` caps the slot buffer (default n).
    ``solve`` is the per-lane solve (``gi_solve``; checks pass
    ``gi_solve_reference``).

    Returns a :class:`QPSolution` with ``rung`` 4 on every lane and the new
    ``gi_state``; ``gis_Ginv`` is in the slot dtype.
    """
    B, n = q.shape
    m = l.shape[1]
    dt, dev = q.dtype, q.device
    hi = slot_dtype_for(dt, slot_dtype)
    if max_active is not None and int(max_active) < 1:
        raise ValueError("max_active must be ≥ 1")
    ns = n if max_active is None else min(n, int(max_active))
    if dt == torch.float32:
        # f32 roundoff on a·x sits ~1e-7·‖a‖‖x‖; a 1e-9 test would re-pick
        # already-active rows forever (the reference's floor)
        tol = max(tol, 3e-6)
    if lane_ctrl is None:
        lane_ctrl = identity_lanes(B, dev)
    max_it = torch.full((B,), int(max_pivots), dtype=torch.int32, device=dev)
    if iter_budget is not None:
        budget = torch.as_tensor(iter_budget, device=dev).to(torch.int32)
        max_it = torch.minimum(max_it, budget.expand(B))
    # the warm-row list (filled from y0 below)
    widx = torch.zeros(B, ns, dtype=torch.int32, device=dev)
    wside = torch.zeros_like(widx)
    wcnt = torch.zeros(B, dtype=torch.int32, device=dev)
    if state0 is not None:
        idx, side, vmask, Ginv = (
            torch.as_tensor(state0[k], device=dev).to(dt_).clone() for k, dt_ in
            (("gis_idx", torch.int32), ("gis_side", torch.int32),
             ("gis_vmask", torch.bool), ("gis_Ginv", hi)))
        warm = True
    else:
        idx, side, vmask, Ginv = gi_state_init(ns, B, hi, dev).values()
        warm = y0 is not None
        if warm:
            # seed the warm list from the previous duals: the k = min(ns, m)
            # largest usable |y0|, ties in index order (a stable sort, as
            # lax.top_k orders them)
            k = min(ns, m)
            usable = torch.where(y0 > 0, u < _BIG, l > -_BIG)
            mag = torch.where(usable, y0.abs(), 0.0)
            topv, topi = torch.sort(mag, dim=1, descending=True, stable=True)
            topv, topi = topv[:, :k], topi[:, :k]
            hot = topv > 1e-12
            wcnt = hot.sum(1).to(torch.int32)
            widx[:, :k] = topi.to(torch.int32)
            sgn = torch.where(torch.gather(y0, 1, topi) > 0, 1, -1)
            wside[:, :k] = torch.where(hot, sgn, 0).to(torch.int32)
    if cache is not None:
        Pinv = cache["gic_Pinv"].to(hi).contiguous()
    elif n <= 8:
        Pinv = inv_spd_small(P.to(hi)).contiguous()
    else:
        eye = torch.eye(n, dtype=dt, device=dev).expand(P.shape)
        Pinv = torch.cholesky_solve(eye, torch.linalg.cholesky(P)).to(hi).contiguous()
    args = [t.contiguous() for t in (A, lane_ctrl, q, l, u)]
    a_map = () if a_ctrl is None else (a_ctrl.contiguous(),)
    x_hi, lam, it, conv = solve(Pinv, *args, idx, side, vmask, Ginv, widx,
                                wside, wcnt, warm, max_it, tol, *a_map)
    # duals back to row space, OSQP sign convention (+ at upper bound)
    contrib = torch.where(vmask, side.to(hi) * lam, 0.0).to(dt)
    y = torch.zeros(B, m, dtype=dt, device=dev).scatter_add_(1, idx.long(), contrib)
    x = x_hi.to(dt)
    obj = (0.5 * torch.sum(x * mv(P, x, lane_ctrl), -1)
           + torch.sum(q * x, -1))
    return QPSolution(x=x, y=y, z=mv(A, x, lane_ctrl if a_ctrl is None else a_ctrl),
                      converged=conv,
                      iters=it, obj=obj,
                      rung=torch.full((B,), 4, dtype=torch.int32, device=dev),
                      gi_state=dict(gis_idx=idx, gis_side=side,
                                    gis_vmask=vmask, gis_Ginv=Ginv))
