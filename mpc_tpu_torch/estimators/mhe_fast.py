"""Construct-time MHE window prediction matrices + GI window-QP backend
(counterpart of ``mpc_tpu/estimators/mhe_fast.py``).

The reference builds the MHE window prediction matrices E, G, J, B once at
construction (src/estimator/mhe/transcription.jl:20-260) and its per-step QP
update only refreshes the q̃/H̃ truncations (mhe/execute.jl:390-457).  This
module is the same path for a LinModel + SingleShooting window:

* ``build_pred_mats`` — all window maps as plain NumPy arrays at construct
  time.  With the decision vector Z̃ = [ϵ?; x̂arr; Ŵ] the window rollout is

      X̂  = Sx·x̂arr + Sw·Ŵ + Su·vec(U) + Sd·vec(Df) + s1       (He·nx̂,)
      Ŷm = Mx·x̂arr + Mw·Ŵ + (per-step data offset c_y)          (He·nym,)

  so the QP constraint matrix is **constant** — the growing window enters
  only through masked bounds (invalid slots get ±BIG) and the masked
  weights of H̃, exactly like the reference's truncated updates.
* ``build_step_qp`` — the per-step H̃ (depends only on the SHARED
  ``mask_w`` and ``invP̄``) and its Newton-refined inverse for the GI
  cache, host NumPy f64.
* ``make_assembler`` — the per-lane (q, l, u) assembly over a leading lane
  axis: two small matvecs from the window data.  The QP is then solved by
  the exact GI active-set solve (:func:`mpc_tpu_torch.ops.qp_active.
  solve_qp_active`, the hand-written kernel on the GPU) with the previous
  step's duals (slot-shifted) as warm start.
* ``make_nan_downdate`` — the per-lane H̃ and H̃⁻¹ of a window with NaN
  measurements: a Sherman–Morrison chain of batched rank-one updates.

Applicability: LinModel, SingleShooting (MultipleShooting condenses to
it), nc == 0; a NaN measurement inside the window needs the per-lane
downdate or the general solver.  Both the p=0 (direct/filter) and p=1
(predictor) forms are built.  The first three functions are verbatim
copies of the reference's (pure NumPy).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.config import BIG
from ..ops.qp_active import solve_qp_active


def build_pred_mats(estim):
    """Window prediction matrices for a LinModel MHE (NumPy f64).

    Mirrors the semantics of the general solver's ``rollout`` of
    :class:`~mpc_tpu_torch.estimators.mhe.MovingHorizonEstimator` exactly:
    p=0: x̂(j) = Â x̂(j−1) + B̂u u(j) + B̂d d(j) + (f̂op−x̂op) + ŵ(j),
    ŷm(j) = Ĉm x̂(j) + D̂dm d(j+1);  p=1 uses d(j+1) in the dynamics and
    evaluates outputs at [x̂arr, X̂[:-1]].
    """
    m = estim.model
    He, nx = estim.He, estim.nx_hat
    nu, nd, nym = m.nu, m.nd, estim.nym
    A = np.asarray(estim.A_hat, float)
    Bu = np.asarray(estim.Bu_hat, float)
    Bd = (np.asarray(estim.Bd_hat, float) if nd else np.zeros((nx, 0)))
    Cm = np.asarray(estim.Cm_hat, float)
    Ddm = (np.asarray(estim.Ddm_hat, float) if nd else np.zeros((nym, 0)))
    p_form = 0 if estim.direct else 1
    n_eps = estim.n_eps
    nZt = n_eps + nx + He * nx

    Ap = [np.eye(nx)]
    for _ in range(He):
        Ap.append(A @ Ap[-1])
    Sx = np.vstack([Ap[j + 1] for j in range(He)])
    Sw = np.zeros((He * nx, He * nx))
    Su = np.zeros((He * nx, He * nu))
    Sd = np.zeros((He * nx, He * nd))
    for j in range(He):
        for k in range(j + 1):
            blk = Ap[j - k]
            Sw[j * nx:(j + 1) * nx, k * nx:(k + 1) * nx] = blk
            Su[j * nx:(j + 1) * nx, k * nu:(k + 1) * nu] = blk @ Bu
            if nd:
                Sd[j * nx:(j + 1) * nx, k * nd:(k + 1) * nd] = blk @ Bd
    fop = np.asarray(estim.fop_hat - estim.xop_hat, float)
    acc = np.zeros((nx, nx))
    s1 = np.zeros(He * nx)
    for j in range(He):
        acc = acc + Ap[j]
        s1[j * nx:(j + 1) * nx] = acc @ fop

    # measurement maps (on [x̂arr; Ŵ])
    Cm_blk = np.kron(np.eye(He), Cm)
    if p_form == 0:
        Mx = Cm_blk @ Sx
        Mw = Cm_blk @ Sw
    else:
        Xm_x = np.vstack([np.eye(nx)] + [Ap[j + 1] for j in range(He - 1)])
        Xm_w = np.zeros((He * nx, He * nx))
        Xm_w[nx:, :] = Sw[:-nx, :]
        Mx = Cm_blk @ Xm_x
        Mw = Cm_blk @ Xm_w

    # full-width maps on Z̃ = [ϵ?; x̂arr; Ŵ]
    def widen(Bx, Bw):
        out = np.zeros((Bx.shape[0], nZt))
        out[:, n_eps:n_eps + nx] = Bx
        out[:, n_eps + nx:] = Bw
        return out

    Gx = widen(Sx, Sw)                       # X̂ map
    Gy = widen(Mx, Mw)                       # Ŷm map
    E_a = np.zeros((nx, nZt))
    E_a[:, n_eps:n_eps + nx] = np.eye(nx)
    E_w = np.zeros((He * nx, nZt))
    E_w[:, n_eps + nx:] = np.eye(He * nx)

    # base constraint rows: [x̂arr; X̂ window; Ŵ; V̂] — V̂ = r − Gy·Z̃ so its
    # base row is −Gy with per-lane offset r = y0m − c_y
    M_all = np.vstack([E_a, Gx, E_w, -Gy])
    return dict(He=He, nx=nx, nu=nu, nd=nd, nym=nym, n_eps=n_eps, nZt=nZt,
                p_form=p_form, Sx=Sx, Sw=Sw, Su=Su, Sd=Sd, s1=s1,
                Cm=Cm, Ddm=Ddm, Gx=Gx, Gy=Gy, E_a=E_a, E_w=E_w, M_all=M_all,
                n_rows0=M_all.shape[0])


def build_rows(mats, C_xmin, C_xmax, C_wmin, C_wmax, C_vmin, C_vmax):
    """Final constraint matrix with the softness (ϵ) columns folded in.

    n_eps=0 → two-sided rows (l ≤ M·Z̃ ≤ u), one row per bound pair.
    n_eps=1 → one-sided ≥/≤ row blocks (the ϵ coefficient differs per
    side) plus the ϵ ≥ 0 row, mirroring the general solver's row set.
    """
    M = mats["M_all"]
    if mats["n_eps"] == 0:
        return M
    cmin = np.concatenate([np.asarray(C_xmin, float),
                           np.asarray(C_wmin, float),
                           np.asarray(C_vmin, float)])
    cmax = np.concatenate([np.asarray(C_xmax, float),
                           np.asarray(C_wmax, float),
                           np.asarray(C_vmax, float)])
    A_min = M.copy()
    A_min[:, 0] = cmin            # M·Z̃ + Cmin·ϵ ≥ lo
    A_max = M.copy()
    A_max[:, 0] = -cmax           # M·Z̃ − Cmax·ϵ ≤ hi
    e_eps = np.zeros((1, mats["nZt"]))
    e_eps[0, 0] = 1.0
    return np.vstack([A_min, A_max, e_eps])


def build_step_qp(mats, mask_w, invP, invQ, invR, Cwt):
    """Per-step H̃ (QP ``P`` matrix) and its Newton-refined inverse.

    ``mask_w`` and ``invP̄`` are SHARED across a fleet (the arrival-cov
    recursion is data-independent for the LinModel covestim), so one host
    NumPy build serves every lane.  Invalid Ŵ slots get unit weight
    (driving them to 0) exactly like the general solver's objective.
    """
    nx, n_eps = mats["nx"], mats["n_eps"]
    Gy, E_a, E_w = mats["Gy"], mats["E_a"], mats["E_w"]
    mask_w = np.asarray(mask_w, float)
    Rbar = np.kron(np.diag(mask_w), np.asarray(invR, float))
    Qbar = (np.kron(np.diag(mask_w), np.asarray(invQ, float))
            + np.kron(np.diag(1.0 - mask_w), np.eye(nx)))
    P = 2.0 * (Gy.T @ Rbar @ Gy + E_a.T @ np.asarray(invP, float) @ E_a
               + E_w.T @ Qbar @ E_w)
    if n_eps:
        P[0, 0] += 2.0 * float(Cwt)
    Pinv = np.linalg.inv(P)
    Pinv = Pinv @ (2.0 * np.eye(P.shape[0]) - P @ Pinv)  # Newton refinement
    return P, Pinv


def make_assembler(mats):
    """The (q, l, u, c_x, r) assembly over a leading lane axis.

    Returns ``assemble(c, U0 (B,He,nu), D0 (B,He+1,nd), Y0m_nn (B,He,nym),
    x_prior (B,nx̂), mask_w (He,), invP (nx̂,nx̂), mask_v=None)`` with the
    constants ``c`` (Su, Sd, s1, Cm, Ddm, Gy, invR and the bounds) as
    tensors in the data dtype.  ``Y0m_nn`` must be nan_to_num'd; masked
    slots are inert (zero weight + ±BIG bounds).  ``mask_v`` (B, He, nym),
    optional: per-element V-row validity — ``mask_w`` broadcast AND
    non-NaN measurement (default: the broadcast of ``mask_w``); with a
    diagonal ``invR`` the elementwise masking reproduces the general
    solver's NaN semantics exactly, and :func:`make_nan_downdate` gives
    the matching H̃.
    """
    He, nx, nym, n_eps = (mats["He"], mats["nx"], mats["nym"],
                          mats["n_eps"])
    p_form = mats["p_form"]

    def assemble(c, U0, D0, Y0m, x_prior, mask_w, invP, mask_v=None):
        B, dt = U0.shape[0], U0.dtype
        if mask_v is None:
            mask_v = mask_w[None, :, None].expand(B, He, nym)
        uvec = U0.reshape(B, -1)
        Df = (D0[:, :-1] if p_form == 0 else D0[:, 1:]).reshape(B, -1)
        cx = uvec @ c["Su"].T + Df @ c["Sd"].T + c["s1"]       # (B, He·nx)
        cxm = (cx if p_form == 0
               else torch.cat([cx.new_zeros(B, nx), cx[:, :-nx]], 1))
        cy = cxm.reshape(B, He, nx) @ c["Cm"].T + D0[:, 1:] @ c["Ddm"].T
        r = (Y0m - cy).reshape(B, -1)                          # (B, He·nym)
        # gradient: q = −2·Gyᵀ R̄ r − 2·E_aᵀ invP̄ x_prior
        rr = (((Y0m - cy) * mask_v) @ c["invR"]) * mask_v
        q = -2.0 * (rr.reshape(B, -1) @ c["Gy"])
        q[:, n_eps:n_eps + nx] += -2.0 * (x_prior @ invP.T)
        # bounds per base-row section (arrival, X̂ window, Ŵ, V̂)
        big = torch.tensor(BIG, dtype=dt, device=U0.device)
        mxr = (mask_w > 0).repeat_interleave(nx)
        mvr = mask_v.reshape(B, -1) > 0
        lo = torch.cat([
            c["Xmin"][:nx].expand(B, nx),
            torch.where(mxr, c["Xmin"][nx:] - cx, -big),
            torch.where(mxr, c["Wmin"], -big).expand(B, -1),
            torch.where(mvr, c["Vmin"] - r, -big)], 1)
        hi = torch.cat([
            c["Xmax"][:nx].expand(B, nx),
            torch.where(mxr, c["Xmax"][nx:] - cx, big),
            torch.where(mxr, c["Wmax"], big).expand(B, -1),
            torch.where(mvr, c["Vmax"] - r, big)], 1)
        if n_eps:
            n0 = lo.shape[1]
            full = lambda v, k: torch.full((B, k), v, dtype=dt, device=U0.device)
            l_full = torch.cat([lo, full(-BIG, n0), full(0.0, 1)], 1)
            u_full = torch.cat([full(BIG, n0), hi, full(BIG, 1)], 1)
        else:
            l_full, u_full = lo, hi
        return q, l_full, u_full, cx, r

    return assemble


def make_nan_downdate(mats):
    """Per-lane (H̃, H̃⁻¹) low-rank downdate for NaN'd V rows (diag invR).

    A NaN measurement element removes exactly one scalar V row from the
    window objective (the general solver's masked-residual semantics,
    reference ``src/estimator/mhe/transcription.jl:1173-1186``), i.e. the
    shared H̃ loses ``2·invR_jj · gy_j gy_jᵀ`` for each NaN'd element j.
    Returns ``downdate(Pq, Pinv, w_nan) -> (Pq_l, Pinv_l)`` with the shared
    ``Pq`` (n, n) and ``Pinv`` (n, n) and ``w_nan`` (B, He·nym) the
    per-lane removed weights (``2·invR_jj`` where NaN inside the valid
    window, else 0): ``Pq_l`` (B, n, n) by one batched product, ``Pinv_l``
    (B, n, n) by a Sherman–Morrison chain of batched rank-one updates over
    the He·nym candidate rows (zero-weight rows are exact no-ops), plus one
    Newton refinement step in float32 to bound the chain's drift.
    """
    Gy_np = np.asarray(mats["Gy"], float)
    m_rows = Gy_np.shape[0]

    def downdate(Pq, Pinv, w_nan):
        Gy_q = torch.as_tensor(Gy_np, dtype=Pq.dtype, device=Pq.device)
        wq = w_nan.to(Pq.dtype)
        Pq_l = Pq - (Gy_q.T * wq[:, None, :]) @ Gy_q
        Gy_p = torch.as_tensor(Gy_np, dtype=Pinv.dtype, device=Pinv.device)
        wp = w_nan.to(Pinv.dtype)
        P = Pinv.expand(w_nan.shape[0], -1, -1)
        for j in range(m_rows):
            g, s = Gy_p[j], wp[:, j]
            u = torch.sum(P * g, -1)                 # P @ g (symmetric P)
            denom = 1.0 - s * torch.sum(g * u, -1)
            P = P + (s / denom)[:, None, None] * (u[:, :, None] * u[:, None, :])
        if P.dtype != torch.float64:
            # one Newton step vs the downdated H̃ bounds the f32 chain's
            # drift (the GI solve expects a refined inverse in its cache)
            eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
            P = P @ (2.0 * eye - Pq_l.to(P.dtype) @ P)
        return Pq_l, P

    return downdate


def shift_warm_duals(mats, y, moving):
    """Slot-shift the previous step's duals when the window moves: section
    blocks (X̂, Ŵ, V̂) drop slot 0 and zero the new last slot; arrival-row
    (and ϵ-row) duals are kept.  Works on (..., m) NumPy arrays and
    tensors; ``moving`` is a bool or a boolean array/tensor."""
    He, nx, nym, n_eps = (mats["He"], mats["nx"], mats["nym"],
                          mats["n_eps"])
    tens = torch.is_tensor(y)
    cat = (lambda a: torch.cat(a, -1)) if tens else (lambda a: np.concatenate(a, -1))

    def shift_sec(block, n):
        b = block.reshape(block.shape[:-1] + (He, n))
        z = (torch.zeros_like if tens else np.zeros_like)(b[..., -1:, :])
        sh = (torch.cat([b[..., 1:, :], z], -2) if tens
              else np.concatenate([b[..., 1:, :], z], -2))
        return sh.reshape(block.shape)

    def shift_one(y1):
        o = 0
        parts = [y1[..., o:o + nx]]          # arrival rows: keep
        o += nx
        for n in (nx, nx, nym):              # X̂, Ŵ, V̂ sections
            parts.append(shift_sec(y1[..., o:o + He * n], n))
            o += He * n
        return cat(parts)

    n0 = mats["n_rows0"]
    if n_eps == 0:
        y_sh = shift_one(y)
    else:
        y_sh = cat([shift_one(y[..., :n0]), shift_one(y[..., n0:2 * n0]),
                    y[..., 2 * n0:]])
    if isinstance(moving, (bool, np.bool_)):
        return y_sh if moving else y
    if tens:
        return torch.where(torch.as_tensor(moving, device=y.device), y_sh, y)
    return np.where(moving, y_sh, y)


def make_single_solver(mats):
    """The single-stream fast window solve as ONE function: the (q, l, u)
    assembly, the GI solve with the cached H̃⁻¹ and the output rollout.

    ``solve_single(c, U0, D0, Y0m_nn, x_prior, mask_w, invP, Pq, Pinv,
    A_rows, y0, lane)`` takes tensors without a lane axis (``c`` as in
    :func:`make_assembler`) and the one-lane map ``lane`` ((1,) int32
    zeros, kept by the caller); it returns ``(Z, X, Ym, converged, y, q,
    r)``.  All per-step data (windows, bounds, H̃, its inverse, warm duals)
    are arguments, so bound rolls, invP̄ updates and setconstraint need no
    rebuild.
    """
    asm = make_assembler(mats)
    He, nx, nym = mats["He"], mats["nx"], mats["nym"]

    def solve_single(c, U0, D0, Y0m_nn, x_prior, mask_w, invP, Pq, Pinv,
                     A_rows, y0, lane):
        q, l, u, cx, r = asm(c, U0[None], D0[None], Y0m_nn[None],
                             x_prior[None], mask_w, invP)
        sol = solve_qp_active(Pq[None], q, A_rows[None], l, u, y0=y0[None],
                              lane_ctrl=lane, cache=dict(gic_Pinv=Pinv[None]))
        Z = sol.x[0]
        X = (c["Gx"] @ Z + cx[0]).reshape(He, nx)
        # model prediction Ŷm = Gy·Z + c_y, with c_y = Y0m − r
        Ym = (Y0m_nn.reshape(-1) - r[0] + c["Gy"] @ Z).reshape(He, nym)
        return Z, X, Ym, sol.converged[0], sol.y[0], q[0], r[0]

    return solve_single
