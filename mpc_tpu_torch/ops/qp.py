"""Batched dense QP solver — OSQP-style ADMM with active-set polish (torch).

Counterpart of ``mpc_tpu/ops/qp.py``: the same problem

    min ½ xᵀPx + qᵀx   s.t.   l ≤ Ax ≤ u      (equalities l == u, ±BIG rows)

the same iteration, termination, ρ adaptation, polish and ``converged``
test, written over a leading lane axis instead of under ``vmap``.

* ``P``/``A`` and the solver cache are stacked over the fleet's DISTINCT
  controllers; lane ``b`` reads controller ``lane_ctrl[b]``.  ``q``, ``l``,
  ``u`` and the iterates are per lane.
* The ``lax.while_loop`` is a Python loop over ``check_every``-sweep blocks.
  As under ``vmap``, a lane whose exit test passed keeps its iterates,
  rung and counters frozen while the others run on; the loop ends when no
  lane is active (one host sync per block).
* The inner sweep is ``ops/admm_kernel.py::admm_sweep``: the hand-written
  CUDA kernel on the GPU, its plain version on the CPU.

Two setups feed the same loop: the CACHED one (``cache=
build_solver_cache(...)``, what every ``LinMPC`` step uses) scales with the
cached Ruiz diagonals and reuses the cached ρ-ladder inverses; the UNCACHED
one equilibrates each lane's (P, q, A) and builds its ladder in the solve
(``n_lad`` rungs, plain torch: ``torch.linalg.inv`` and one Newton step),
then sweeps with per-lane ladders and per-lane ``A``.  ``solve_qp`` also
takes one unbatched QP, the reference's call form; ``solve_qp_batch`` takes
a leading lane axis on every argument.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.lanes import identity_lanes, mtv, mv, take
from ..utils.trace import synced
from .admm_kernel import admm_sweep

_BIG = 1e18  # bounds beyond this are treated as infinite


class QPSolution(NamedTuple):
    x: torch.Tensor          # primal solution (B, n)
    y: torch.Tensor          # dual solution (B, m)
    z: torch.Tensor          # Ax at solution (B, m)
    converged: torch.Tensor  # (B,) bool
    iters: torch.Tensor      # (B,) int32
    obj: torch.Tensor        # (B,) ½xᵀPx + qᵀx
    rung: torch.Tensor       # (B,) int32 final ρ-ladder rung
    # GI operator state for the next period (ops/qp_active.py; None for ADMM)
    gi_state: dict | None = None


def build_solver_cache(P, A, eq_mask, loose_mask, *,
                       sigma=1e-6, rho=0.1, scaling=10, q_scale=0.0):
    """Precompute the step-invariant part of ``solve_qp`` (host NumPy, f64).

    A verbatim copy of ``mpc_tpu.ops.qp.build_solver_cache``: Ruiz
    diagonals (D, E, c) of [[P, Aᵀ], [A, 0]] with ``q_ref = q_scale`` and the
    9-rung ρ-ladder of Newton-refined inverses of P + σI + AᵀρA.
    """
    P = np.asarray(P, np.float64)
    A = np.asarray(A, np.float64)
    eq = np.asarray(eq_mask, bool)
    loose = np.asarray(loose_mask, bool)
    n = P.shape[0]
    m = A.shape[0]
    # --- Ruiz equilibration of [[P, Aᵀ],[A, 0]] with q_ref = 0 ------------
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    Ps, As = P.copy(), A.copy()
    for _ in range(int(scaling)):
        col = np.max(np.abs(Ps), axis=0)
        if m:
            col = np.maximum(col, np.max(np.abs(As), axis=0))
        d = np.where(col < 1e-10, 1.0, 1.0 / np.sqrt(np.clip(col, 1e-12, 1e12)))
        row = np.max(np.abs(As), axis=1) if m else np.zeros(0)
        e = np.where(row < 1e-10, 1.0, 1.0 / np.sqrt(np.clip(row, 1e-12, 1e12)))
        Ps = (d[:, None] * Ps) * d[None, :]
        As = (e[:, None] * As) * d[None, :]
        gamma = 1.0 / np.clip(
            max(np.mean(np.max(np.abs(Ps), axis=0)), c * q_scale),
            1e-12, 1e12)
        Ps *= gamma
        D *= d
        E *= e
        c *= gamma
    # --- ρ-ladder of Newton-refined inverses ------------------------------
    N_LAD = 9
    lad = rho * np.logspace(-2.0, 2.0, N_LAD)
    rhovs = np.stack([np.where(eq, 1e3 * r, np.where(loose, 1e-6 * r, r))
                      for r in lad])
    Ms = Ps[None] + sigma * np.eye(n)[None] + \
        np.einsum("ji,kj,jl->kil", As, rhovs, As)
    Minvs = np.linalg.inv(Ms)
    Minvs = Minvs @ (2.0 * np.eye(n)[None] - Ms @ Minvs)
    return dict(qpc_D=D, qpc_E=E, qpc_c=np.float64(c),
                qpc_eq=eq, qpc_loose=loose,
                qpc_rhovs=rhovs, qpc_Minvs=Minvs,
                qpc_sigma=np.float64(sigma), qpc_rho=np.float64(rho))


def _rho_vec(eq, loose, rho):
    """Per-row ρ from the equality/loose masks (classified on the ORIGINAL
    bounds: equilibration must not flip a row's class)."""
    return torch.where(eq, 1e3 * rho, torch.where(loose, 1e-6 * rho, rho))


def _ruiz_equilibrate(P, q, A, iters=10):
    """Modified Ruiz equilibration of [[P, Aᵀ], [A, 0]] per lane (OSQP §5.1),
    ``mpc_tpu.ops.qp._ruiz_equilibrate`` over a leading lane axis: P (B, n,
    n), q (B, n), A (B, m, n) with m ≥ 1.  Returns scaled (P̄, q̄, Ā) and
    the diagonal scalings (D, E, c) with P̄ = c·D P D, q̄ = c·D q,
    Ā = E A D."""
    D = torch.ones_like(q)
    E = A.new_ones(A.shape[:2])
    c = q.new_ones(q.shape[0])
    for _ in range(int(iters)):
        # column norms of [P; A] → D; tiny norms keep scale 1
        col = torch.maximum(P.abs().amax(1), A.abs().amax(1))
        d = torch.where(col < 1e-10, 1.0, 1.0 / torch.sqrt(torch.clamp(col, 1e-12, 1e12)))
        row = A.abs().amax(2)
        e = torch.where(row < 1e-10, 1.0, 1.0 / torch.sqrt(torch.clamp(row, 1e-12, 1e12)))
        P = (d[:, :, None] * P) * d[:, None, :]
        q = d * q
        A = (e[:, :, None] * A) * d[:, None, :]
        # cost normalization
        gamma = 1.0 / torch.clamp(torch.maximum(P.abs().amax(1).mean(-1),
                                                q.abs().amax(-1)), 1e-12, 1e12)
        P = gamma[:, None, None] * P
        q = gamma[:, None] * q
        D, E, c = D * d, E * e, c * gamma
    return P, q, A, D, E, c


def _ninf(v):
    """Per-lane ∞-norm over the last axis (0 for an empty axis)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(-1)


def _check_cache_penalties(cache, sigma, rho):
    """A cache built for other penalties centres the ρ-ladder on the wrong
    rung and pairs Minv with the wrong σ: refuse it (the reference checks
    the same when the values are concrete)."""
    sc, rc = cache.get("qpc_sigma"), cache.get("qpc_rho")
    if sc is None or rc is None:
        return
    sc = np.asarray(sc.cpu() if torch.is_tensor(sc) else sc, float).ravel()
    rc = np.asarray(rc.cpu() if torch.is_tensor(rc) else rc, float).ravel()
    if (np.any(np.abs(sc - sigma) > 1e-12 * max(1.0, abs(sigma)))
            or np.any(np.abs(rc - rho) > 1e-12 * max(1.0, abs(rho)))):
        raise ValueError(
            f"solver cache was built with sigma={sc[0]}, rho={rc[0]} but "
            f"solve_qp was called with sigma={sigma}, rho={rho}; rebuild the "
            "cache with matching penalties")


def solve_qp(P, q, A, l, u, x0=None, y0=None, *, cache=None, lane_ctrl=None,
             sigma=1e-6, rho=0.1, alpha=1.6, max_iter=None, tol=1e-6,
             tol_final=1e-7, check_every=10, scaling=10, polish=True,
             polish_iters=3, polish_delta=1e-11, polish_rounds=2, rung0=None,
             iter_budget=None, n_lad=9, sweep=admm_sweep):
    """Solve a batch of dense QPs by ADMM, or one QP.

    Batched: ``P`` (n_d, n, n) and ``A`` (n_d, m, n) (and every ``cache``
    entry) are stacked over distinct controllers; ``q`` (B, n), ``l``/``u``
    (B, m) and the warm starts ``x0`` (B, n), ``y0`` (B, m), ``rung0`` (B,)
    are per lane.  ``lane_ctrl`` (B,) int32 maps lanes to controllers;
    ``None`` means n_d == B, one controller per lane.  Unbatched (``q`` of
    shape (n,)): one QP in the reference's call form, every argument
    without the lane axis; the result is unbatched too.

    ``cache=None`` runs the in-solve setup: per-lane Ruiz equilibration
    (``scaling`` sweeps, with the live max|q| in the cost normalization)
    and an ``n_lad``-rung ρ ladder (half-span 2 decades from 5 rungs up, 1
    below).  ``max_iter=None`` means 2000 iterations, CLAMPED to 250 for
    float32 inputs, as in the reference; ``iter_budget`` (int or (B,) ints)
    is ANDed with it at run time.  ``sweep`` is the inner ADMM sweep
    (``admm_sweep``; checks pass ``admm_sweep_reference``).
    """
    if q.dim() == 1:
        one = lambda t: None if t is None else torch.as_tensor(t, device=q.device)[None]
        if cache is not None:
            cache = {k: one(v) for k, v in cache.items()}
        sol = solve_qp(one(P), one(q), one(A), one(l), one(u), one(x0), one(y0),
                       cache=cache, sigma=sigma, rho=rho, alpha=alpha,
                       max_iter=max_iter, tol=tol, tol_final=tol_final,
                       check_every=check_every, scaling=scaling, polish=polish,
                       polish_iters=polish_iters, polish_delta=polish_delta,
                       polish_rounds=polish_rounds, rung0=one(rung0),
                       iter_budget=iter_budget, n_lad=n_lad, sweep=sweep)
        return sol._replace(**{f: getattr(sol, f)[0] for f in sol._fields[:7]})
    if cache is not None:
        _check_cache_penalties(cache, sigma, rho)
    B, n = q.shape
    m = l.shape[1]
    dt, dev = q.dtype, q.device
    default_iters = max_iter is None
    if default_iters:
        max_iter = 2000
    f32 = dt == torch.float32
    if f32:
        # f32 cannot reach f64 tolerances — loosen to its floor, add polish
        # refinement sweeps, and cap the DEFAULT budget at 250 (reference
        # qp.py: the extra lockstep iterations bought nothing at B=4096)
        tol = max(tol, 3e-5)
        tol_final = max(tol_final, 3e-4)
        polish_delta = max(polish_delta, 1e-6)
        polish_iters = max(polish_iters, 8)
        if default_iters:
            max_iter = min(max_iter, 250)
    x = torch.zeros(B, n, dtype=dt, device=dev) if x0 is None else x0
    y = torch.zeros(B, m, dtype=dt, device=dev) if y0 is None else y0
    rung_c = torch.full((B,), 4, dtype=torch.int32, device=dev)
    if m == 0:
        # unconstrained: the Newton step alone
        P_l = take(P, lane_ctrl)
        xs = torch.linalg.solve(P_l, -q)
        obj = 0.5 * torch.sum(xs * mv(P_l, xs), -1) + torch.sum(q * xs, -1)
        return QPSolution(xs, y, q.new_zeros(B, 0), torch.isfinite(xs).all(-1),
                          torch.zeros(B, dtype=torch.int32, device=dev), obj, rung_c)
    if lane_ctrl is None or cache is None:
        # the uncached setup is per lane: each lane is its own controller
        P, A = take(P, lane_ctrl), take(A, lane_ctrl)
        lane_ctrl = identity_lanes(B, dev)

    P_orig, q_orig, A_orig, l_orig, u_orig = P, q, A, l, u
    fin_l = l > -_BIG
    fin_u = u < _BIG
    if cache is not None:
        # step-invariant setup from the cache: scale the data with the
        # cached diagonals (per distinct controller), reuse the ladder
        eq_mask = take(cache["qpc_eq"], lane_ctrl)
        D = cache["qpc_D"].to(dt)
        Esc = cache["qpc_E"].to(dt)
        c = cache["qpc_c"].to(dt)
        P = (c[:, None, None] * D[:, :, None]) * P * D[:, None, :]
        A = (Esc[:, :, None] * A) * D[:, None, :]
        Dl, El, cl = take(D, lane_ctrl), take(Esc, lane_ctrl), take(c, lane_ctrl)[:, None]
        q = cl * Dl * q
        rhovs_lad = cache["qpc_rhovs"].to(dt)
        Minvs_lad = cache["qpc_Minvs"].to(dt)
        N_LAD = rhovs_lad.shape[1]
        span = 4.0
    else:
        # in-solve setup, per lane (mpc_tpu/ops/qp.py:293-337)
        eq_mask = (u - l) < 1e-12
        loose_mask = (u >= _BIG) & (l <= -_BIG)
        if scaling:
            P, q, A, Dl, El, c = _ruiz_equilibrate(P, q, A, iters=scaling)
            cl = c[:, None]
        else:
            Dl, El, cl = torch.ones_like(q), torch.ones_like(l), q.new_ones(B, 1)
        # ρ ladder of Newton-refined inverses of P + σI + Aᵀ diag(ρ) A
        N_LAD = int(n_lad)
        half_span = 2.0 if N_LAD >= 5 else 1.0
        lad = torch.as_tensor(rho * np.logspace(-half_span, half_span, N_LAD),
                              dtype=dt, device=dev)
        rhovs_lad = _rho_vec(eq_mask[:, None, :], loose_mask[:, None, :],
                             lad[None, :, None])
        eye = torch.eye(n, dtype=dt, device=dev)
        Ms = (P[:, None] + sigma * eye
              + A.transpose(-1, -2)[:, None] @ (rhovs_lad[..., None] * A[:, None]))
        Minvs_lad = torch.linalg.inv(Ms)
        Minvs_lad = Minvs_lad @ (2.0 * eye - Ms @ Minvs_lad)
        span = 4.0 if N_LAD >= 5 else 2.0
    l = torch.clamp(El * l, -2e18, 2e18)
    u = torch.clamp(El * u, -2e18, 2e18)
    x = x / Dl
    y = cl * y / El

    A_l = take(A, lane_ctrl)          # per-lane views for the batched matvecs
    P_l = take(P, lane_ctrl)
    Dinv, Einv, cinv = 1.0 / Dl, 1.0 / El, 1.0 / cl[:, 0]
    log_step = span / max(N_LAD - 1, 1)
    if rung0 is None:
        j = torch.full((B,), (N_LAD - 1) // 2, dtype=torch.int32, device=dev)
    else:
        j = torch.clamp(rung0.to(torch.int32), 0, N_LAD - 1)
    max_it = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    if iter_budget is not None:
        # the run-time cap of the Ts-deadline policy
        budget = torch.as_tensor(iter_budget, device=dev).to(torch.int32)
        max_it = torch.minimum(max_it, budget.expand(B))

    z = torch.clamp(mv(A_l, x), l, u)
    qnorm = torch.clamp(_ninf(Dinv * q), min=1.0)

    def residuals(x, z, y):
        # residuals UNSCALED to original problem units (OSQP §5.1)
        Ax = mv(A_l, x)
        Px = mv(P_l, x)
        ATy = mtv(A_l, y)
        r_prim = _ninf(Einv * (Ax - z))
        r_dual = cinv * _ninf(Dinv * (Px + q + ATy))
        s_prim = torch.clamp(torch.maximum(_ninf(Einv * Ax), _ninf(Einv * z)),
                             min=1.0)
        s_dual = cinv * torch.maximum(torch.maximum(_ninf(Dinv * Px),
                                                    _ninf(Dinv * ATy)), qnorm)
        return r_prim / s_prim, r_dual / (s_dual + 1e-30)

    x, z, y = x.contiguous(), z.contiguous(), y.contiguous()
    q_c, l_c, u_c, A_c = q.contiguous(), l.contiguous(), u.contiguous(), A.contiguous()
    Minvs_c, rhovs_c = Minvs_lad.contiguous(), rhovs_lad.contiguous()
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    exit_ = torch.zeros(B, dtype=torch.bool, device=dev)
    infeas = torch.zeros_like(exit_)
    done = torch.zeros_like(exit_)
    best = torch.full((B,), float("inf"), dtype=dt, device=dev)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    active = ~exit_ & (it < max_it)
    while synced(bool(active.any())):
        y_prev = y.clone()
        # the sweep reads each lane's Minv and ρ off the ladder by its rung
        sweep(Minvs_c, A_c, lane_ctrl, j, q_c, l_c, u_c, rhovs_c, x, z, y,
              active, check_every, sigma, alpha)
        it_n = it + check_every
        rp, rd = residuals(x, z, y)
        done_n = (rp < tol) & (rd < tol)
        # OSQP §3.4 primal-infeasibility certificate from the dual direction
        dy = y - y_prev
        ndy = _ninf(dy)
        crit1 = _ninf(mtv(A_l, dy)) <= 1e-5 * ndy
        sup = torch.sum(torch.where(dy > 0, torch.clamp(u, max=1e17) * dy, 0.0)
                        + torch.where(dy < 0, torch.clamp(l, min=-1e17) * dy, 0.0),
                        dim=-1)
        crit2 = sup < -1e-5 * ndy
        infeas_n = infeas | ((ndy > 1e-12) & crit1 & crit2)
        # OSQP §5.2 adaptive ρ snapped to the ladder, 5× hysteresis
        ratio = torch.sqrt((rp + 1e-18) / (rd + 1e-18))
        dj = torch.round(torch.log10(ratio) / log_step).to(torch.int32)
        move = (ratio > 5.0) | (ratio < 0.2)
        j_new = torch.clamp(j + dj, 0, N_LAD - 1)
        adapt = ~done_n & ~infeas_n & move
        j_next = torch.where(adapt, j_new, j)
        if f32:
            # f32 plateau exit: no ≥2% improvement over five checks (a rung
            # change resets the counter only before iteration 300)
            score = torch.maximum(rp, rd)
            improved = score < 0.98 * best
            best_n = torch.minimum(score, best)
            reset = improved | ((j_next != j) & (it_n < 300))
            stall_n = torch.where(reset, 0, stall + 1)
            plateau = stall_n >= 5
        else:
            best_n, stall_n = best, stall
            plateau = torch.zeros_like(done_n)
        exit_n = done_n | infeas_n | plateau
        # lockstep freeze: only lanes that entered this block move on
        it = torch.where(active, it_n, it)
        exit_ = torch.where(active, exit_n, exit_)
        infeas = torch.where(active, infeas_n, infeas)
        j = torch.where(active, j_next, j)
        best = torch.where(active, best_n, best)
        stall = torch.where(active, stall_n, stall)
        done = torch.where(active, done_n, done)
        active = ~exit_ & (it < max_it)

    if polish:
        x, y, z = _polish(P_l, q, A_l, l, u, x, y, fin_l, fin_u, eq_mask,
                          iters=polish_iters, delta=polish_delta,
                          rounds=polish_rounds)

    # convergence on the final (post-polish) KKT residuals, including
    # complementarity and dual signs (a mis-detected active set otherwise
    # reports "converged" at a non-optimal vertex)
    rp, rd = residuals(x, z, y)
    x = Dl * x
    y = El * y / cl
    z = z / El
    Ax_o = mv(A_orig, x, lane_ctrl)
    y_pos = torch.clamp(y, min=0.0)
    y_neg = torch.clamp(y, max=0.0)
    gap_u = torch.where(fin_u, u_orig - Ax_o, 0.0)
    gap_l = torch.where(fin_l, Ax_o - l_orig, 0.0)
    comp_scale = torch.clamp(_ninf(y), min=1.0) * torch.clamp(_ninf(Ax_o), min=1.0)
    comp = (_ninf(y_pos * gap_u) + _ninf(y_neg * gap_l)) / comp_scale
    sgn_bad = (torch.where(fin_u, 0.0, y_pos).amax(-1).clamp(min=0.0)
               + torch.where(fin_l, 0.0, -y_neg).amax(-1).clamp(min=0.0))
    tol_c = 1e2 * tol_final
    kkt_ok = (rp < tol_final) & (rd < tol_final) & (comp < tol_c) & \
        (sgn_bad < tol_c)
    converged = (kkt_ok | done) & ~infeas
    obj = 0.5 * torch.sum(x * mv(P_orig, x, lane_ctrl), -1) + torch.sum(q_orig * x, -1)
    return QPSolution(x, y, z, converged, it, obj, j)


def solve_qp_batch(P, q, A, l, u, x0=None, y0=None, **kw):
    """Batched solve with a leading lane axis on every argument (one QP per
    lane): the counterpart of ``mpc_tpu.ops.qp.solve_qp_batch``."""
    return solve_qp(P, q, A, l, u, x0, y0, **kw)


def _polish(P, q, A, l, u, x, y, fin_l, fin_u, eq_mask, iters=3,
            delta=1e-11, rounds=2):
    """Iterated active-set polish with a top-k gathered KKT + refinement.

    Per lane (all arguments batch-leading, P/A per lane): detect the active
    set from dual signs and primal proximity, gather the k = min(m, n + 8)
    highest-activity rows (equalities first) with ``topk``, invert the
    (n+k)² KKT and refine; float32 inputs accumulate the refinement residual
    in float64.  Best of ``rounds`` by a viol + stationarity +
    complementarity score.  Ties in the activity score may select other
    inactive rows than ``jax.lax.top_k``; those rows enter with act = 0, so
    their multiplier is forced to 0 and the result is the same.
    """
    B, n = q.shape
    m = l.shape[1]
    dt = q.dtype
    k = min(m, n + 8)
    hi = torch.float64 if dt == torch.float32 else dt
    P_h, q_h = P.to(hi), q.to(hi)
    prox = 1e-5 if dt == torch.float32 else 1e-7
    absA = A.abs()
    eye_n = torch.eye(n, dtype=dt, device=q.device)
    eye_k = torch.eye(k, dtype=dt, device=q.device)
    rows = torch.arange(B, device=q.device)[:, None]

    def one_round(x, y):
        z = mv(A, x)
        row_scale = torch.clamp(mv(absA, x.abs()) + 1e-12, min=1.0)
        tol_p = prox * row_scale
        act_low = (((z - l) < tol_p) | (y < -delta)) & fin_l
        act_up = (((u - z) < tol_p) | (y > delta)) & fin_u
        act_low = act_low & ~act_up
        act = act_low | act_up
        b = torch.where(act_low, l, u)
        margin = torch.minimum((z - l).abs(), (u - z).abs()) / row_scale
        # (the upload of _BIG blocks the host: a host sync)
        score = (act.to(dt) * (1.0 + y.abs() + 1.0 / (margin + 1e-6))
                 + torch.where(eq_mask, synced(torch.tensor(_BIG, dtype=dt, device=q.device)),
                               0.0))
        idx = torch.topk(score, k, dim=-1).indices
        Ak = A[rows, idx]
        eqk = torch.gather(eq_mask, 1, idx)
        actk = torch.gather(act, 1, idx) | eqk
        bk = torch.where(eqk, torch.gather(l, 1, idx), torch.gather(b, 1, idx))
        actf = actk.to(dt)
        Am = Ak * actf[..., None]
        # K = [[P+δI, Amᵀ], [Am, -δI - diag(1-act)]] on the gathered rows
        K = torch.cat([
            torch.cat([P + delta * eye_n, Am.transpose(-1, -2)], -1),
            torch.cat([Am, -delta * eye_k - torch.diag_embed(1.0 - actf)], -1),
        ], -2)
        Kinv = synced(torch.linalg.inv(K))     # its error check reads the device
        rhs = torch.cat([-q, actf * bk], -1)
        Am_h, actf_h, b_h = Am.to(hi), actf.to(hi), bk.to(hi)
        sol = mv(Kinv, rhs)
        for _ in range(iters):
            # residual of the UNregularized system, in high precision
            xs, nu = sol[:, :n].to(hi), sol[:, n:].to(hi)
            res_top = (torch.sum(P_h * xs[:, None, :], -1)
                       + torch.sum(Am_h * nu[..., None], -2) + q_h)
            res_bot = (torch.sum(Am_h * xs[:, None, :], -1)
                       - (1.0 - actf_h) * nu - actf_h * b_h)
            res = -torch.cat([res_top, res_bot], -1).to(dt)
            sol = sol + mv(Kinv, res)
        x_r, nu = sol[:, :n], sol[:, n:]
        y_r = torch.zeros_like(y).scatter(1, idx, torch.where(actk, nu, 0.0))
        ok = (torch.isfinite(x_r).all(-1) & torch.isfinite(y_r).all(-1))[:, None]
        return torch.where(ok, x_r, x), torch.where(ok, y_r, y)

    def score(xx, yy):
        Ax = mv(A, xx)
        viol = torch.clamp(torch.maximum((Ax - u).amax(-1), (l - Ax).amax(-1)),
                           min=0.0)
        rd = _ninf(mv(P, xx) + q + mtv(A, yy))
        y_p, y_n = torch.clamp(yy, min=0.0), torch.clamp(yy, max=0.0)
        comp = (_ninf(y_p * torch.where(fin_u, u - Ax, 0.0))
                + _ninf(y_n * torch.where(fin_l, Ax - l, 0.0)))
        return torch.where(torch.isfinite(xx).all(-1), viol + rd + comp,
                           float("inf"))

    # best-of-rounds: a later round re-detecting a worse active set must not
    # discard an earlier, strictly better polish
    best_x, best_y, best_s = x, y, score(x, y)
    x_pol, y_pol = x, y
    for _ in range(rounds):
        x_pol, y_pol = one_round(x_pol, y_pol)
        s = score(x_pol, y_pol)
        take_ = (s <= best_s)[:, None]
        best_x = torch.where(take_, x_pol, best_x)
        best_y = torch.where(take_, y_pol, best_y)
        best_s = torch.where(take_[:, 0], s, best_s)
    z = torch.clamp(mv(A, best_x), l, u)
    return best_x, best_y, z
