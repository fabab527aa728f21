"""MovingHorizonEstimator (counterpart of ``mpc_tpu/estimators/mhe.py``;
reference src/estimator/mhe/*.jl).

Objective (mhe/construct.jl:253-258):

    min_{Z̃}  x̄ᵀP̄⁻¹x̄ + ŴᵀQ̂_Nk⁻¹Ŵ + V̂ᵀR̂_Nk⁻¹V̂ + Cε²

with Z = [x̂arr; Ŵ] (SingleShooting), x̄ = x̂arr_prior − x̂arr, and the window
rollout  x̂(j+1) = f̂(x̂(j), u(j), d(j)) + ŵ(j),  v̂(j+1) = ym(j+1) − ĥm(x̂(j+1), d(j+1)).

* The growing window ``Nk ≤ He`` is masking over fixed He-shaped arrays, as
  in the reference: invalid V̂ rows get zero weight, unused Ŵ slots unit
  weight (driving them to 0), NaN measurements zero-weight rows.
* LinModel + SingleShooting (or MultipleShooting, which condenses exactly)
  with no NaN in the window: construct-time window prediction matrices
  and one exact GI active-set solve per step (``mhe_fast.py``) with warm
  slot-shifted duals.
* Everything else (NonLinModel, custom ``gc``, NaN windows, trapezoidal
  collocation): the general window solver, a Gauss–Newton SQP written over
  a leading lane axis (a fleet's lanes, or one lane for this estimator):
  the rollout as a loop over the He slots, Jacobians by ``torch.func.
  jacrev`` under ``vmap``, MultipleShooting defects eliminated by a
  complete-QR nullspace with a second-order correction, an ℓ1 merit and an
  8-point line search, the QPs through ``solve_qp_active`` (the GI kernel)
  or ``solve_qp`` (the ADMM sweep kernel).  The reference's
  ``lax.while_loop`` becomes one loop over the lanes: each iteration after
  the first tests every lane's exit (one host sync, counted in
  ``COUNTS``), a lane whose test failed keeps its carry and gets a QP
  budget of 0.
* The arrival covariance is advanced by a nested covestim (the port's
  KalmanFilter, UnscentedKalmanFilter or ExtendedKalmanFilter) exactly like
  the reference (mhe/execute.jl:728-797).

The window state and every construct-time matrix live on the host in NumPy
float64, as the reference's; each window solve runs on ``device`` (the GPU
unless the caller asks for another) in float64, with one upload of its
inputs.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from ..models import LinModel, NonLinModel, RungeKutta
from ..ops.qp import solve_qp
from ..ops.qp_active import solve_qp_active
from ..utils.config import BIG, resolve_device
from ..utils.lanes import mtv, mv
from .base import StateEstimator
from .construct import validate_covariances
from .kalman import KalmanFilter, UnscentedKalmanFilter, _default_P0, _default_sigmas

# host syncs of the Gauss–Newton exit test (one per iteration after the
# first); checks reset it
COUNTS = {"gn_exit_tests": 0}

_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001)
# window-solver params with a lane axis (the rest are shared by the lanes)
LANE_KEYS = frozenset(("U", "D", "Y0m", "mask_v", "x_arr_prior", "invP"))
# per-slot bound vectors: key -> (per-slot size attribute, slot count offset)
_SLOT_BOUNDS = (("Xmin", "nx", 1), ("Xmax", "nx", 1), ("Wmin", "nx", 0),
                ("Wmax", "nx", 0), ("Vmin", "nym", 0), ("Vmax", "nym", 0),
                ("C_xmin", "nx", 1), ("C_xmax", "nx", 1), ("C_wmin", "nx", 0),
                ("C_wmax", "nx", 0), ("C_vmin", "nym", 0), ("C_vmax", "nym", 0))


def end_align(b, He, Nk, nx, nym):
    """END-align the per-slot bound vectors of a growing window (the
    reference's trunc_bounds, mhe/execute.jl:572-580): bound slot He always
    corresponds to the current time; out-of-window slots are masked by the
    solvers, so the wrapped tail is inert.  ``b`` maps the keys of
    ``_SLOT_BOUNDS`` to NumPy vectors; returns a new dict."""
    if Nk >= He:
        return dict(b)
    size = {"nx": nx, "nym": nym}
    out = dict(b)
    for k, n, extra in _SLOT_BOUNDS:
        v = np.asarray(b[k]).reshape(He + extra, size[n])
        out[k] = np.roll(v, -(He - Nk), axis=0).reshape(-1)
    return out


def upload(arrays, dtype, device):
    """Host arrays (a dict of NumPy arrays) as tensors of ``dtype`` on
    ``device``, in ONE copy; boolean arrays come back boolean."""
    keys = list(arrays)
    host = [np.asarray(arrays[k]) for k in keys]
    flat = torch.as_tensor(np.concatenate([np.asarray(a, np.float64).ravel() for a in host]),
                           dtype=torch.float64)
    parts = flat.to(device=device, dtype=dtype).split([a.size for a in host])
    return {k: (t.reshape(a.shape) > 0.5 if a.dtype == bool else t.reshape(a.shape))
            for k, t, a in zip(keys, parts, host)}


class MovingHorizonEstimator(StateEstimator):
    def __init__(self, model, He=None, i_ym=None, nint_u=0, nint_ym=None,
                 sigmaQ=None, sigmaR=None, sigmaQint_u=None, sigmaQint_ym=None,
                 sigmaP_0=None, sigmaPint_u_0=None, sigmaPint_ym_0=None,
                 Q_hat=None, R_hat=None, P0_hat=None, Cwt=np.inf,
                 covestim=None, direct=True, sqp_iters=12, sqp_tol=1e-6,
                 qp_solver="admm", gc=None, nc=0, p=None,
                 transcription=None, device=None):
        if He is None or He < 1:
            raise ValueError("estimation horizon He should be ≥ 1")
        self.device = resolve_device(device)
        self._init_common(model, i_ym, nint_u, nint_ym, direct)
        self.He = int(He)
        if Q_hat is None or R_hat is None:
            Q_hat, R_hat = _default_sigmas(model, self.i_ym, self.nint_u,
                                           self.nint_ym, sigmaQ, sigmaR,
                                           sigmaQint_u, sigmaQint_ym)
        if P0_hat is None:
            P0_hat = _default_P0(model, self.nint_u, self.nint_ym, sigmaP_0,
                                 sigmaPint_u_0, sigmaPint_ym_0)
        Q_hat, R_hat, P0_hat = validate_covariances(self.nx_hat, self.nym,
                                                    Q_hat, R_hat, P0_hat)
        self.Q_hat, self.R_hat, self.P0_hat = Q_hat, R_hat, P0_hat
        self.invQ = np.linalg.inv(Q_hat)
        self.invR = np.linalg.inv(R_hat)
        self.Cwt = float(Cwt)
        if self.Cwt < 0:
            raise ValueError("Cwt weight should be ≥ 0")
        self.n_eps = 0 if np.isinf(Cwt) else 1
        self.sqp_iters = int(sqp_iters)
        # relative step-norm exit of the GN loop: warm-started receding
        # windows re-converge in 1-2 iterations at steady state
        self.sqp_tol = float(sqp_tol)
        # QP backend of the GENERAL window solver: "admm" or "active_set"
        # (the LinModel fast path always uses GI)
        if qp_solver not in ("admm", "active_set"):
            raise ValueError("qp_solver must be 'admm' or 'active_set'")
        self.qp_solver = qp_solver
        # custom nonlinear constraints gc(X̂e, V̂e, Ŵe, Ue, Yem, De, P̄, x̄, p, ε)
        # ≤ 0 (mhe/construct.jl:437-448); invalid window slots are NaN-padded
        self.gc = gc
        self.nc = int(nc)
        self.p_user = p if p is not None else model.p
        # nested arrival-covariance estimator (mhe/construct.jl:641-648)
        if covestim is not None:
            P_ce = getattr(covestim, "P0_hat", None)
            if P_ce is not None and np.shape(P_ce) != (self.nx_hat, self.nx_hat):
                # mhe/construct.jl:655: covestim P̂ must match nx̂
                raise ValueError(
                    f"P̂ covariance size {np.shape(P_ce)} of covestim does "
                    f"not match nx̂={self.nx_hat}")
            self.covestim = covestim
        elif isinstance(model, LinModel):
            self.covestim = KalmanFilter(model, i_ym=self.i_ym,
                                         nint_u=self.nint_u, nint_ym=self.nint_ym,
                                         Q_hat=Q_hat, R_hat=R_hat, P0_hat=P0_hat,
                                         direct=direct)
        else:
            self.covestim = UnscentedKalmanFilter(
                model, i_ym=self.i_ym, nint_u=self.nint_u, nint_ym=self.nint_ym,
                Q_hat=Q_hat, R_hat=R_hat, P0_hat=P0_hat, direct=direct,
                device=self.device)
        # fixed-shape data windows (left-aligned, oldest first); slot j of all
        # windows holds the data of the j-th measurement in the window
        He_, nu, nd, nym, nx_hat = self.He, model.nu, model.nd, self.nym, self.nx_hat
        self.Y0m_win = np.full((He_, nym), np.nan)
        self.U0_win = np.zeros((He_, nu))
        self.D0_win = np.zeros((He_ + 1, nd))   # slot 0 = pre-window d (zeros)
        self.X0_old_win = np.zeros((He_, nx_hat))
        self.Nk = 0
        self.x_arr_prior = np.zeros(nx_hat)
        self.P_arr = P0_hat.copy()
        self.invP_arr = np.linalg.inv(self.P_arr)
        # decision vector: Z̃ = [ϵ; x̂arr; Ŵ] (SingleShooting) or
        # [ϵ; x̂arr; X̂0; Ŵ] with defect equalities (MultipleShooting,
        # mhe/transcription.jl:2-3)
        from ..controllers.transcription import (MultipleShooting,
                                                 OrthogonalCollocation,
                                                 SingleShooting,
                                                 TrapezoidalCollocation)
        self.transcription = transcription or SingleShooting()
        if isinstance(self.transcription, OrthogonalCollocation):
            # mirrors the reference's restriction (mhe/construct.jl:174-175)
            raise ValueError("OrthogonalCollocation is not supported for the "
                             "MHE for now.")
        self.is_trap = isinstance(self.transcription, TrapezoidalCollocation)
        if self.is_trap and not (isinstance(model, NonLinModel)
                                 and isinstance(model.solver, RungeKutta)):
            raise ValueError("TrapezoidalCollocation requires a "
                             "continuous-time NonLinModel (with a "
                             "RungeKutta solver).")
        # trapezoidal shares the MultipleShooting decision layout
        # (mhe/transcription.jl:3 — get_nZ_mhe for ::TranscriptionMethod)
        self.is_ms = isinstance(self.transcription, MultipleShooting) or self.is_trap
        self.nZ = nx_hat + He_ * nx_hat + (He_ * nx_hat if self.is_ms else 0)
        self.nZt = self.nZ + self.n_eps
        self._w_off = self.n_eps + nx_hat + (He_ * nx_hat if self.is_ms else 0)
        self.Z_tilde = np.zeros(self.nZt)
        self._pending_u0 = np.zeros(nu)
        # bounds, full-window shaped so time-varying (capital) forms work
        # (mhe/construct.jl:773-1046): X̂ has He+1 slots (slot 0 = arrival)
        self.X_min = np.full((He + 1) * nx_hat, -BIG)
        self.X_max = np.full((He + 1) * nx_hat, BIG)
        self.W_min = np.full(He * nx_hat, -BIG)
        self.W_max = np.full(He * nx_hat, BIG)
        self.V_min = np.full(He * nym, -BIG)
        self.V_max = np.full(He * nym, BIG)
        self.C_xmin = np.ones((He + 1) * nx_hat)
        self.C_xmax = np.ones((He + 1) * nx_hat)
        self.C_wmin = np.ones(He * nx_hat)
        self.C_wmax = np.ones(He * nx_hat)
        self.C_vmin = np.ones(He * nym)
        self.C_vmax = np.ones(He * nym)
        self._fns_cache = {}
        self._lane = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._last = {}
        # construct-time fast path (LinModel + SingleShooting + nc == 0):
        # window prediction matrices + exact GI window QP — the reference's
        # own architecture (mhe/transcription.jl:20-260 builds E,G,J,B once;
        # per-step updates only truncate q̃/H̃, mhe/execute.jl:390-457)
        self._fast_mats = None
        self._fast_solve = None
        self._fast_step_cache = None
        self._y_fast = None
        # COUNT of window moves since the last fast solve: a multi-step
        # general-solver interlude (NaN measurements) moves the window
        # several times, and the warm duals must be slot-shifted once per
        # move when the fast path resumes
        self._moves_since_solve = 0

    # ------------------------------------------------------------------
    def setconstraint(self, **kw):
        """Bounds on x̂, ŵ, v̂ (mhe/construct.jl:773-1046).  Lowercase
        keywords (xhatmin …) tile over the window; the capital forms
        (Xhatmin of size ``nx̂*(He+1)``, Whatmin/Vhatmin of size ``nx̂*He`` /
        ``nym*He``) set time-varying bounds per window slot (slot 0 of the
        X̂ forms is the arrival state)."""
        nx_hat, nym, He = self.nx_hat, self.nym, self.He
        # key -> (attr, per-slot size, slot count, subtract xop?)
        m = {"xhatmin": ("X_min", nx_hat, He + 1, True),
             "xhatmax": ("X_max", nx_hat, He + 1, True),
             "whatmin": ("W_min", nx_hat, He, False),
             "whatmax": ("W_max", nx_hat, He, False),
             "vhatmin": ("V_min", nym, He, False),
             "vhatmax": ("V_max", nym, He, False),
             "c_xhatmin": ("C_xmin", nx_hat, He + 1, False),
             "c_xhatmax": ("C_xmax", nx_hat, He + 1, False),
             "c_whatmin": ("C_wmin", nx_hat, He, False),
             "c_whatmax": ("C_wmax", nx_hat, He, False),
             "c_vhatmin": ("C_vmin", nym, He, False),
             "c_vhatmax": ("C_vmax", nym, He, False)}
        for k, v in kw.items():
            key = k.lower()
            if key not in m:
                raise ValueError(f"unknown constraint keyword {k}")
            attr, n, rep, sub_op = m[key]
            v = np.asarray(v, float).ravel()
            if v.shape == (n,):
                v = np.tile(v, rep)
            if v.shape != (n * rep,):
                raise ValueError(f"{k} size must be ({n},) or ({n * rep},)")
            if key.startswith("c_"):
                if self.n_eps != 1:
                    raise ValueError("Slack variable weight Cwt must be "
                                     "finite to set softness parameters")
                if np.any(v < 0):
                    # mhe/construct.jl:966-996: softness weights ≥ 0
                    raise ValueError(f"{k} weights should be non-negative")
            val = v.copy()
            if sub_op:
                val = val - np.tile(self.xop_hat, rep)
            getattr(self, attr)[:] = np.clip(np.nan_to_num(val, posinf=BIG,
                                                           neginf=-BIG), -BIG, BIG)
        self._fast_step_cache = None    # bounds feed the cached A_rows/consts
        return self

    # ------------------------------------------------------------------
    def _fns(self, dt, dev):
        """The per-lane pieces of the general window solver (functions of
        ONE lane's params ``pl`` and decisions ``Zt``), for data type
        ``dt`` on ``dev``; made once, and again after ``setmodel``."""
        key = (dt, torch.device(dev))
        if key not in self._fns_cache:
            self._fns_cache[key] = self._make_fns(dt, torch.device(dev))
        return self._fns_cache[key]

    def _make_fns(self, dt, dev):
        model = self.model
        He, nym, nx_hat = self.He, self.nym, self.nx_hat
        n_eps, Cwt = self.n_eps, self.Cwt
        is_ms, is_trap = self.is_ms, self.is_trap
        w_off = self._w_off
        p_form = 0 if self.direct else 1
        gc, nc, p_user = self.gc, self.nc, self.p_user
        t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dt, device=dev)
        f_hat, h_hat = self.tensor_fns(dt, dev)
        i_ym = torch.as_tensor(list(self.i_ym), device=dev)
        h_hat_m = lambda x, d: h_hat(x, d)[i_ym]
        vh = vmap(h_hat_m)
        yopm = t(model.yop[np.asarray(self.i_ym, int)])

        def pack(Zt):
            eps = Zt[0] if n_eps else Zt.new_zeros(())
            return eps, Zt[n_eps:n_eps + nx_hat], Zt[w_off:]

        def rollout(pl, Zt):
            """Window states and measurement predictions of one lane.

            ``D`` has He+1 slots with slot 0 the pre-window disturbance
            (mhe/execute.jl:521-538).  p=0 (direct/filter form): x̂(t0+j+1)
            = f̂(x̂(t0+j), u(t0+j), D[j]), ŷm row j at state X[j] with
            D[j+1].  p=1 (predictor form): dynamics use D[j+1]; outputs
            evaluated at [x̂arr, X[:-1]] with D[j+1].  MultipleShooting
            reads X̂ from the decisions."""
            eps, x_arr, W = pack(Zt)
            if is_ms:
                X = Zt[n_eps + nx_hat:w_off].reshape(He, nx_hat)
            else:
                Wm = W.reshape(He, nx_hat)
                Df = pl["D"][:-1] if p_form == 0 else pl["D"][1:]
                x, Xs = x_arr, []
                for j in range(He):
                    x = f_hat(x, pl["U"][j], Df[j]) + pl["fop_m_xop"] + Wm[j]
                    Xs.append(x)
                X = torch.stack(Xs)
            Xmeas = X if p_form == 0 else torch.cat([x_arr[None], X[:-1]])
            return X, vh(Xmeas, pl["D"][1:])

        if is_trap:
            nx_d, Ts_m, hold = model.nx, model.Ts, self.transcription.h
            As_s, Cs_u_s = t(self.As), t(self.Cs_u)
            f_cont = vmap(lambda x, u, d: model._f_user(x, u, d, model.p))
        vf = vmap(f_hat)

        def defects(pl, Zt, Nk):
            """Defect equalities per stage (MS: ŵ(j) = x̂(j+1) − f̂(x̂(j));
            trapezoidal: implicit-trapezoid rule on the deterministic
            substates, discrete MS on the stochastic ones,
            mhe/transcription.jl:1390-1470); masked stages copy the state
            forward so they stay anchored."""
            eps, x_arr, W = pack(Zt)
            X = Zt[n_eps + nx_hat:w_off].reshape(He, nx_hat)
            Wm = W.reshape(He, nx_hat)
            X_prev = torch.cat([x_arr[None], X[:-1]])
            D = pl["D"]
            Df = D[:-1] if p_form == 0 else D[1:]
            if is_trap:
                # disturbed inputs û(j) = u(j) + Cs_u·x̂s(j), x̂s from the
                # interval's START state (disturbedinput!, execute.jl:162-173)
                Uh = pl["U"] + X_prev[:, nx_d:] @ Cs_u_s.T
                # d at the END of interval j: slot j+1 of the He+1-slot
                # window (d0next, mhe/transcription.jl:1447); clamp for p=1
                Dn = D[1:] if p_form == 0 else torch.cat([Df[1:], Df[-1:]])
                if hold >= 1:
                    # û(end of newest valid interval) is unavailable at k —
                    # the reference clamps to û(j) at j ≥ Nk (:1460)
                    Un = Uh[[j + 1 if j + 1 < Nk else j for j in range(He)]]
                else:
                    Un = Uh
                k1 = f_cont(X_prev[:, :nx_d], Uh, Df)
                k2 = f_cont(X[:, :nx_d], Un, Dn)
                S_det = (X_prev[:, :nx_d] - X[:, :nx_d]
                         + 0.5 * Ts_m * (k1 + k2) + Wm[:, :nx_d])
                S_sto = X_prev[:, nx_d:] @ As_s.T - X[:, nx_d:] + Wm[:, nx_d:]
                S_valid = torch.cat([S_det, S_sto], 1)
            else:
                S_valid = vf(X_prev, pl["U"], Df) + pl["fop_m_xop"] + Wm - X
            S_anchor = X_prev + Wm - X
            return torch.where(pl["mask_w"][:, None] > 0, S_valid, S_anchor).reshape(-1)

        def objective(pl, Zt):
            eps, x_arr, W = pack(Zt)
            X, Ym = rollout(pl, Zt)
            return _objective(pl, eps, x_arr, W, Ym)

        def _objective(pl, eps, x_arr, W, Ym):
            xb = pl["x_arr_prior"] - x_arr
            Wm = W.reshape(He, nx_hat)
            mw = pl["mask_w"][:, None]
            # masks: valid window steps & non-NaN measurements
            Vv = torch.where(pl["mask_v"], pl["Y0m"] - Ym, 0.0)
            J = (xb @ pl["invP"] @ xb
                 + torch.sum((Wm @ pl["invQ"]) * Wm * mw)
                 + torch.sum(torch.clamp(1.0 - mw, min=0.0) * Wm ** 2)
                 + torch.sum((Vv @ pl["invR"]) * Vv))
            if n_eps:
                J = J + Cwt * eps ** 2
            return J

        def ineq_violation(pl, Zt, eps, x_arr, W, X, Ym):
            """ℓ1 violation of the TRUE (nonlinear) soft bounds — the merit
            must see infeasibility or the line search undoes the QP step's
            progress toward the active v̂/x̂ bounds."""
            relu = lambda a: torch.sum(torch.clamp(a, min=0.0))
            big = 2e18
            mw = pl["mask_w"].repeat_interleave(nx_hat) > 0
            mv_ = pl["mask_v"].reshape(-1)
            ce = (lambda c: c * eps) if n_eps else (lambda c: 0.0)
            v = relu(pl["Xmin"][:nx_hat] - ce(pl["C_xmin"][:nx_hat]) - x_arr)
            v = v + relu(x_arr - pl["Xmax"][:nx_hat] - ce(pl["C_xmax"][:nx_hat]))
            Xv = X.reshape(-1)
            v = v + relu(torch.where(mw, pl["Xmin"][nx_hat:], -big)
                         - ce(pl["C_xmin"][nx_hat:]) - Xv)
            v = v + relu(Xv - torch.where(mw, pl["Xmax"][nx_hat:], big)
                         - ce(pl["C_xmax"][nx_hat:]))
            v = v + relu(torch.where(mw, pl["Wmin"], -big) - ce(pl["C_wmin"]) - W)
            v = v + relu(W - torch.where(mw, pl["Wmax"], big) - ce(pl["C_wmax"]))
            Vv = torch.where(pl["mask_v"], pl["Y0m"] - Ym, 0.0).reshape(-1)
            v = v + relu(torch.where(mv_, pl["Vmin"], -big) - ce(pl["C_vmin"]) - Vv)
            v = v + relu(Vv - torch.where(mv_, pl["Vmax"], big) - ce(pl["C_vmax"]))
            if n_eps:
                v = v + relu(-eps)
            return v

        def merit(pl, Zt, mu, Nk):
            """ℓ1 exact-penalty merit: J + μ·(Σ|defects| + Σviol)."""
            eps, x_arr, W = pack(Zt)
            X, Ym = rollout(pl, Zt)
            m_ = _objective(pl, eps, x_arr, W, Ym)
            if is_ms:
                m_ = m_ + mu * torch.sum(torch.abs(defects(pl, Zt, Nk)))
            return m_ + mu * ineq_violation(pl, Zt, eps, x_arr, W, X, Ym)

        def values(pl, Zt):
            X, Ym = rollout(pl, Zt)
            out = (X.reshape(-1), (pl["Y0m"] - Ym).reshape(-1))
            return out, out

        def gfun(pl, Zt):
            """Custom constraints on the NaN-padded window arrays."""
            eps, xa, W = pack(Zt)
            X, Ym = rollout(pl, Zt)
            nan = torch.tensor(float("nan"), dtype=Zt.dtype, device=Zt.device)
            row = lambda n: nan.expand(1, n)
            mw, mv_, U = pl["mask_w"][:, None] > 0, pl["mask_v"], pl["U"]
            Xe = torch.cat([xa[None], torch.where(mw, X, nan)])
            Ve = torch.cat([row(nym), torch.where(mv_, pl["Y0m"] - Ym, nan)])
            We = torch.cat([torch.where(mw, W.reshape(He, -1), nan), row(nx_hat)])
            Ue = torch.cat([torch.where(mw, U, nan), row(U.shape[1])])
            Yme = torch.cat([row(nym), torch.where(mv_, pl["Y0m"] + yopm, nan)])
            g = gc(Xe.reshape(-1), Ve.reshape(-1), We.reshape(-1), Ue.reshape(-1),
                   Yme.reshape(-1), pl["D"].reshape(-1), pl["invP"],
                   pl["x_arr_prior"] - xa, p_user, eps)
            g = torch.nan_to_num(torch.as_tensor(g), nan=-1.0)
            return g, g

        def defects_aux(pl, Zt, Nk):
            S = defects(pl, Zt, Nk)
            return S, S

        return dict(rollout=rollout, defects=defects, objective=objective, merit=merit,
                    jac_values=jacrev(values, argnums=1, has_aux=True),
                    jac_gfun=jacrev(gfun, argnums=1, has_aux=True),
                    jac_defects=jacrev(defects_aux, argnums=1, has_aux=True))

    def _solve_fn(self, p, Zt0, lane, Nk, solve_gi=None, solve_admm=None):
        """The general window solve over B lanes: ``p`` holds the params
        (the ``LANE_KEYS`` with a leading lane axis, the rest shared),
        ``Zt0`` (B, nZ̃) the warm starts, ``lane`` the (B,) int32 lane map
        0..B−1 the caller keeps, ``Nk`` the (shared) window count;
        ``solve_gi``/``solve_admm`` replace this module's ``solve_qp_active``
        / ``solve_qp`` (checks pass the plain kernels through them).
        Returns ``(Zt, x̂, X̂, Ŷm, J, converged, iterations)`` per lane."""
        solve_gi = solve_qp_active if solve_gi is None else solve_gi
        solve_admm = solve_qp if solve_admm is None else solve_admm
        dt, dev = Zt0.dtype, Zt0.device
        B, nZt = Zt0.shape
        F = self._fns(dt, dev)
        He, nym, nx_hat = self.He, self.nym, self.nx_hat
        n_eps, Cwt, nc = self.n_eps, self.Cwt, self.nc
        is_lin, is_ms = isinstance(self.model, LinModel), self.is_ms
        w_off = self._w_off
        use_as = self.qp_solver == "active_set"
        n_iters = 1 if (is_lin and nc == 0) else self.sqp_iters
        neq = He * nx_hat if is_ms else 0
        in_p = {k: (0 if k in LANE_KEYS else None) for k in p}
        lanes = lambda fn: vmap(fn, in_dims=(in_p, 0))
        v_values = lanes(F["jac_values"])
        v_gfun = lanes(F["jac_gfun"])
        v_def = lanes(lambda pl, Zt: F["jac_defects"](pl, Zt, Nk))
        v_S = lanes(lambda pl, Zt: F["defects"](pl, Zt, Nk))
        v_merit = vmap(vmap(lambda pl, Zt, mu: F["merit"](pl, Zt, mu, Nk),
                            in_dims=(None, 0, None)), in_dims=(in_p, 0, 0))
        v_roll = lanes(F["rollout"])
        v_obj = lanes(F["objective"])
        eye = lambda n: torch.eye(n, dtype=dt, device=dev)
        big = 2e18
        ninf = lambda v: v.abs().amax(-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])
        alphas = torch.tensor(_ALPHAS, dtype=dt, device=dev)
        invP = p["invP"]
        sym = lambda M: M + M.mT
        mw = p["mask_w"].repeat_interleave(nx_hat) > 0            # (He·nx̂,)
        mv_ = p["mask_v"].reshape(B, -1)                           # (B, He·nym)
        # constant pieces of the linearized rows
        e_arr = torch.zeros(nx_hat, nZt, dtype=dt, device=dev)
        e_arr[:, n_eps:n_eps + nx_hat] = eye(nx_hat)
        e_w = torch.zeros(He * nx_hat, nZt, dtype=dt, device=dev)
        e_w[:, w_off:] = eye(He * nx_hat)

        def eps_col(M, c):
            """M with c added to its ϵ column (column 0)."""
            if not n_eps:
                return M
            M = M.clone()
            M[..., 0] += c
            return M
        Xmin_t = torch.where(mw, p["Xmin"][nx_hat:], -big)
        Xmax_t = torch.where(mw, p["Xmax"][nx_hat:], big)
        Wmin_t = torch.where(mw, p["Wmin"], -big)
        Wmax_t = torch.where(mw, p["Wmax"], big)
        Vmin_t = torch.where(mv_, p["Vmin"], -big)
        Vmax_t = torch.where(mv_, p["Vmax"], big)
        A_arr = torch.cat([-eps_col(e_arr, p["C_xmin"][:nx_hat]),
                           eps_col(e_arr, -p["C_xmax"][:nx_hat])])
        A_w = torch.cat([-eps_col(e_w, p["C_wmin"]), eps_col(e_w, -p["C_wmax"])])
        # Gauss–Newton Hessian: the arrival and Ŵ blocks are quadratic in Z̃
        invR_blk = torch.kron(eye(He), p["invR"])
        H0 = torch.zeros(B, nZt, nZt, dtype=dt, device=dev)
        H0[:, n_eps:n_eps + nx_hat, n_eps:n_eps + nx_hat] += 2.0 * invP
        wblk = (torch.kron(torch.diag(p["mask_w"]), p["invQ"])
                + torch.kron(torch.diag(1.0 - p["mask_w"]), eye(nx_hat)))
        H0[:, w_off:, w_off:] += 2.0 * wblk
        if n_eps:
            H0[:, 0, 0] += 2.0 * Cwt
        H0 = H0 + 1e-10 * eye(nZt)
        n_rows = 2 * nx_hat + 4 * He * nx_hat + 2 * He * nym + n_eps + nc

        def body(Zt, y_d, mu, active):
            (JX, JV), (Xv, Vv) = v_values(p, Zt)
            eps = Zt[:, 0] if n_eps else Zt.new_zeros(B)
            x_arr, Wv = Zt[:, n_eps:n_eps + nx_hat], Zt[:, w_off:]
            ce = (lambda c: c * eps[:, None]) if n_eps else (lambda c: 0.0)
            # the objective's gradient by the chain rule through the
            # Jacobian at hand (Vv unmasked; the masked rows carry no weight)
            JVm = torch.where(mv_[:, :, None], JV, 0.0)
            Vm = torch.where(mv_, Vv, 0.0)
            g = mtv(JVm, Vm.reshape(B, He, nym).matmul(sym(p["invR"])).reshape(B, -1))
            g[:, n_eps:n_eps + nx_hat] -= mv(sym(invP), p["x_arr_prior"] - x_arr)
            Wm = Wv.reshape(B, He, nx_hat)
            mwc = p["mask_w"][:, None]
            g[:, w_off:] += (mwc * (Wm @ sym(p["invQ"]))
                             + 2.0 * torch.clamp(1.0 - mwc, min=0.0) * Wm).reshape(B, -1)
            if n_eps:
                g[:, 0] += 2.0 * Cwt * eps
            H = 2.0 * JVm.mT @ invR_blk @ JVm + H0
            # linearized soft bounds on X̂ (arrival and window), Ŵ, V̂; ϵ ≥ 0
            rows = [A_arr.expand(B, -1, -1),
                    -eps_col(JX, p["C_xmin"][nx_hat:]), eps_col(JX, -p["C_xmax"][nx_hat:]),
                    A_w.expand(B, -1, -1),
                    -eps_col(JV, p["C_vmin"]), eps_col(JV, -p["C_vmax"])]
            up = [-(p["Xmin"][:nx_hat] - x_arr) + ce(p["C_xmin"][:nx_hat]),
                  p["Xmax"][:nx_hat] - x_arr + ce(p["C_xmax"][:nx_hat]),
                  -(Xmin_t - ce(p["C_xmin"][nx_hat:]) - Xv),
                  Xmax_t + ce(p["C_xmax"][nx_hat:]) - Xv,
                  -(Wmin_t - ce(p["C_wmin"]) - Wv), Wmax_t + ce(p["C_wmax"]) - Wv,
                  -(Vmin_t - ce(p["C_vmin"]) - Vv), Vmax_t + ce(p["C_vmax"]) - Vv]
            lo = [torch.full((B, n_rows - n_eps - nc), -big, dtype=dt, device=dev)]
            if n_eps:
                er = torch.zeros(B, 1, nZt, dtype=dt, device=dev)
                er[:, 0, 0] = 1.0
                rows.append(er)
                lo.append(-eps[:, None])
                up.append(torch.full((B, 1), big, dtype=dt, device=dev))
            if nc:
                # custom nonlinear constraints gc ≤ 0, linearized at the
                # iterate (NaN-padded aligned windows, mhe/construct.jl:437-448)
                Jgc, gcv = v_gfun(p, Zt)
                rows.append(Jgc)
                lo.append(torch.full((B, nc), -big, dtype=dt, device=dev))
                up.append(-gcv)
            A = torch.cat(rows, 1)
            l, u = torch.cat(lo, 1), torch.cat(up, 1)
            budget = torch.where(active, 2 ** 30, 0)

            def qp(Hq, gq, Aq, lq, uq):
                if use_as:
                    return solve_gi(Hq, gq, Aq, lq, uq, y0=y_d, lane_ctrl=lane,
                                    iter_budget=budget)
                return solve_admm(Hq, gq, Aq, lq, uq, y0=y_d, max_iter=None, tol=1e-8,
                                  n_lad=3, iter_budget=budget)
            if is_ms:
                # linearized defect equalities Js·dz = −S eliminated EXACTLY
                # through a complete-QR nullspace (dz = dp + N v): the QP
                # only sees the inequality-reduced problem
                Js, Sv = v_def(p, Zt)
                Qf, Rf = torch.linalg.qr(Js.mT, mode="complete")
                Q1, Nn = Qf[..., :neq], Qf[..., neq:]
                Rsq = Rf[..., :neq, :]
                lt = lambda rhs: mv(Q1, torch.linalg.solve_triangular(
                    Rsq.mT, rhs[..., None], upper=False)[..., 0])
                dp = lt(-Sv)
                Ad = mv(A, dp)
                sol = qp(Nn.mT @ H @ Nn, mtv(Nn, g + mv(H, dp)), A @ Nn, l - Ad, u - Ad)
                dz = dp + mv(Nn, sol.x)
                # equality multipliers from stationarity → adaptive ℓ1
                # penalty (must dominate the duals, N&W Thm 17.3)
                resid = mv(H, dz) + g + mtv(A, sol.y)
                lam = torch.linalg.solve_triangular(
                    Rsq, -mtv(Q1, resid)[..., None], upper=True)[..., 0]
                dual_inf = torch.maximum(ninf(sol.y), ninf(lam))
            else:
                sol = qp(H, g, A, l, u)
                dz = sol.x
                dual_inf = ninf(sol.y)
            mu = torch.minimum(torch.maximum(mu, 2.0 * dual_inf), 20.0 * dual_inf + 1e3)
            if is_lin:
                Zn = Zt + dz
            else:
                # second-order correction: restore the defects at the trial
                # point through the same QR (N&W §15.6)
                c_soc = lt(-v_S(p, Zt + dz)) if is_ms else torch.zeros_like(dz)
                # deep backtracking on the ℓ1 merit: the eight steps and the
                # iterate itself in one evaluation
                cand = torch.cat([Zt[:, None] + alphas[None, :, None] * dz[:, None]
                                  + (alphas * alphas)[None, :, None] * c_soc[:, None],
                                  Zt[:, None]], 1)
                merits = v_merit(p, cand, mu)
                m_now, merits = merits[:, -1], merits[:, :-1]
                nan = torch.isnan(merits).any(1)
                best = torch.argmin(torch.where(torch.isnan(merits), torch.inf, merits), 1)
                take = ~nan & (merits.gather(1, best[:, None])[:, 0] < m_now)
                a = torch.where(take, alphas[best], 0.0)
                Zn = Zt + a[:, None] * dz + (a * a)[:, None] * c_soc
            return Zn, sol.y, sol.converged, mu, ninf(Zn - Zt)

        Zt, y_d = Zt0, torch.zeros(B, n_rows, dtype=dt, device=dev)
        mu = torch.full((B,), 1e4, dtype=dt, device=dev)
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        it = torch.zeros(B, dtype=torch.int32, device=dev)
        sn = torch.full((B,), torch.inf, dtype=dt, device=dev)
        for k in range(n_iters):
            if k == 0:
                active = torch.ones(B, dtype=torch.bool, device=dev)
            else:
                # step-norm exit: warm-started receding windows re-converge
                # in 1-2 GN iterations at steady state
                active = sn > self.sqp_tol * (1.0 + ninf(Zt))
                COUNTS["gn_exit_tests"] += 1
                if not bool(active.any()):
                    break
            new = body(Zt, y_d, mu, active)
            keep = lambda n_, o_: torch.where(active.view(-1, *[1] * (n_.dim() - 1)), n_, o_)
            Zt, y_d, ok, mu, sn = (keep(n_, o_) for n_, o_ in
                                   zip(new, (Zt, y_d, ok, mu, sn)))
            it = it + active.to(it.dtype)
        # final rollout for the state estimate: x̂0 = x̂ at window slot Nk−1
        # (the newest valid state)
        X, Ym = v_roll(p, Zt)
        x_new = (X[:, min(max(Nk - 1, 0), He - 1)] if Nk > 0
                 else Zt[:, n_eps:n_eps + nx_hat])
        return Zt, x_new, X, Ym, v_obj(p, Zt), ok, it

    # ------------------------------------------------------------------
    def _windows_params(self):
        mask_w = (np.arange(self.He) < self.Nk).astype(float)
        mask_v = (mask_w[:, None] > 0) & np.isfinite(self.Y0m_win)
        return dict(
            U=self.U0_win, D=self.D0_win,
            Y0m=np.nan_to_num(self.Y0m_win),
            mask_w=mask_w, mask_v=mask_v,
            invP=self.invP_arr, invQ=self.invQ, invR=self.invR,
            x_arr_prior=self.x_arr_prior,
            fop_m_xop=self.fop_hat - self.xop_hat,
            Xmin=self.X_min, Xmax=self.X_max,
            Wmin=self.W_min, Wmax=self.W_max,
            Vmin=self.V_min, Vmax=self.V_max,
            C_xmin=self.C_xmin, C_xmax=self.C_xmax,
            C_wmin=self.C_wmin, C_wmax=self.C_wmax,
            C_vmin=self.C_vmin, C_vmax=self.C_vmax,
        )

    def _params_one_lane(self):
        """The window params on the device, each lane key with a lane axis
        of 1 (one upload)."""
        p = self._windows_params()
        if self.Nk < self.He:
            # growing window: END-align the per-slot bound vectors
            p.update(end_align(p, self.He, self.Nk, self.nx_hat, self.nym))
        p = {k: (np.asarray(v)[None] if k in LANE_KEYS else v) for k, v in p.items()}
        return upload(p, torch.float64, self.device)

    # ------------------------------------------------------------------
    def _fast_applicable(self):
        """Construct-time-matrix + GI path: LinModel, no custom
        constraints, and no NaN measurement in the window (a NaN changes
        the per-lane V-row weights and hence H̃).  MultipleShooting
        windows are served by the SAME path: for a LinModel the defect
        equalities are linear, so condensing X̂ = Gx·Z_ss + c_x is EXACT —
        the fast solver works on the SS-form decisions [ϵ; x̂arr; Ŵ] and
        the MS-layout Z̃ (with its X̂ block) is reconstructed from the
        rollout.  TrapezoidalCollocation never reaches here (it requires a
        NonLinModel)."""
        return (isinstance(self.model, LinModel) and self.nc == 0
                and not np.any(np.isnan(self.Y0m_win[:self.Nk])))

    def _solve_window_fast(self):
        """One exact GI solve of the window QP from the construct-time
        prediction matrices."""
        from . import mhe_fast

        if self._fast_mats is None:
            self._fast_mats = mhe_fast.build_pred_mats(self)
            self._fast_solve = mhe_fast.make_single_solver(self._fast_mats)
        mats = self._fast_mats
        He, nx, nym = self.He, self.nx_hat, self.nym
        # A_rows/consts depend only on (bounds, min(Nk, He)): cached on the
        # device once the window is full; setconstraint / setmodel
        # invalidate the cache
        ck = min(self.Nk, He)
        cache = self._fast_step_cache
        if cache is not None and cache[0] == ck:
            consts = cache[1]
        else:
            b = {k: np.asarray(getattr(self, a), float) for k, a in
                 (("Xmin", "X_min"), ("Xmax", "X_max"), ("Wmin", "W_min"),
                  ("Wmax", "W_max"), ("Vmin", "V_min"), ("Vmax", "V_max"),
                  ("C_xmin", "C_xmin"), ("C_xmax", "C_xmax"),
                  ("C_wmin", "C_wmin"), ("C_wmax", "C_wmax"),
                  ("C_vmin", "C_vmin"), ("C_vmax", "C_vmax"))}
            b = end_align(b, He, self.Nk, nx, nym)
            A_rows = mhe_fast.build_rows(mats, b["C_xmin"], b["C_xmax"],
                                         b["C_wmin"], b["C_wmax"],
                                         b["C_vmin"], b["C_vmax"])
            consts = upload(dict(Su=mats["Su"], Sd=mats["Sd"], s1=mats["s1"],
                                 Cm=mats["Cm"], Ddm=mats["Ddm"], Gy=mats["Gy"],
                                 Gx=mats["Gx"], invR=np.asarray(self.invR, float),
                                 A_rows=A_rows,
                                 **{k: b[k] for k in ("Xmin", "Xmax", "Wmin", "Wmax",
                                                      "Vmin", "Vmax")}),
                            torch.float64, self.device)
            self._fast_step_cache = (ck, consts)
        mask_w = (np.arange(He) < self.Nk).astype(float)
        P, Pinv = mhe_fast.build_step_qp(mats, mask_w, self.invP_arr,
                                         self.invQ, self.invR, self.Cwt)
        if self._y_fast is None:
            self._y_fast = np.zeros(consts["A_rows"].shape[0])
        else:
            for _ in range(min(self._moves_since_solve, He)):
                self._y_fast = mhe_fast.shift_warm_duals(mats, self._y_fast, True)
        self._moves_since_solve = 0
        d = upload(dict(U0=self.U0_win, D0=self.D0_win,
                        Y0m=np.nan_to_num(self.Y0m_win), x_prior=self.x_arr_prior,
                        mask_w=mask_w, invP=np.asarray(self.invP_arr), P=P, Pinv=Pinv,
                        y0=self._y_fast), torch.float64, self.device)
        Zd, Xd, Ymd, conv, y_new, q, r = self._fast_solve(
            consts, d["U0"], d["D0"], d["Y0m"], d["x_prior"], d["mask_w"],
            d["invP"], d["P"], d["Pinv"], consts["A_rows"], d["y0"], self._lane)
        Z = Zd.cpu().numpy()
        ok = bool(conv) and np.all(np.isfinite(Z))
        if not ok:
            warnings.warn("MHE window solve failed; keeping the warm-start "
                          "solution (graceful degradation)")
            return
        self._y_fast = y_new.cpu().numpy()
        X = Xd.cpu().numpy()
        Ym = Ymd.cpu().numpy()
        if self.is_ms:
            # MS layout [ϵ; x̂arr; X̂; Ŵ]: the condensed solve returns the
            # SS-form [ϵ; x̂arr; Ŵ]; reinsert the (exactly eliminated) X̂
            # block from the rollout so general-path fallbacks and warm
            # shifts see a consistent MS warm start
            ne, nx_ = self.n_eps, self.nx_hat
            self.Z_tilde = np.concatenate([Z[:ne + nx_], X.reshape(-1), Z[ne + nx_:]])
        else:
            self.Z_tilde = Z.copy()
        idx = int(np.clip(self.Nk - 1, 0, He - 1))
        self.x0_hat = (X[idx] if self.Nk > 0 else Z[self.n_eps:self.n_eps + nx]).copy()
        # J = ½ZᵀPZ + qᵀZ + const, const = x̂priorᵀP̄⁻¹x̂prior + Σⱼ mⱼ rⱼᵀR̂⁻¹rⱼ
        rm = r.cpu().numpy().reshape(He, nym) * mask_w[:, None]
        J = (0.5 * Z @ P @ Z + q.cpu().numpy() @ Z
             + float(self.x_arr_prior @ self.invP_arr @ self.x_arr_prior)
             + float(np.sum((rm @ self.invR) * rm)))
        self._last = dict(J=float(J), X=X, Ym=Ym, x_arr=Z[self.n_eps:self.n_eps + nx])

    def _solve_window(self):
        if self._fast_applicable():
            self._solve_window_fast()
            return
        p = self._params_one_lane()
        Zt0 = torch.as_tensor(self.Z_tilde[None], dtype=torch.float64, device=self.device)
        Zt, x_new, X, Ym, J, ok, _ = self._solve_fn(p, Zt0, self._lane, self.Nk)
        x_new = x_new[0].cpu().numpy()
        if not (bool(ok[0]) and np.all(np.isfinite(x_new))):
            warnings.warn("MHE window solve failed; keeping the warm-start "
                          "solution (graceful degradation)")
            Zt, x_new = Zt0, self.x0_hat
        self.Z_tilde = Zt[0].cpu().numpy().copy()
        self.x0_hat = np.array(x_new)
        self._last = dict(J=float(J[0]), X=X[0].cpu().numpy(), Ym=Ym[0].cpu().numpy(),
                          x_arr=self.Z_tilde[self.n_eps:self.n_eps + self.nx_hat].copy())

    # ------------------------------------------------------------------
    # reference protocol (mhe/execute.jl:44-84)
    def _add_data(self, y0m, d0, u0):
        """add_data_windows! (mhe/execute.jl:497-547): shift when full, then
        append (y, d, u, x̂0_old); returns True when the window is moving."""
        He = self.He
        if np.any(np.isnan(u0)):
            raise ValueError("manipulated input u contains NaN values")
        if np.any(np.isnan(d0)):
            raise ValueError("measured disturbance d contains NaN values")
        x0_old = self.x0_hat.copy()
        moving = (self.Nk + 1) > He
        if moving:
            self.Y0m_win[:-1] = self.Y0m_win[1:]
            self.U0_win[:-1] = self.U0_win[1:]
            self.D0_win[:-1] = self.D0_win[1:]   # He+1 slots; slot 0 = pre-window d
            self.X0_old_win[:-1] = self.X0_old_win[1:]
            self.Nk = He - 1
            # warm start: shift the window blocks one slot
            # (mhe/transcription.jl:936-1075)
            nx, ne, wo = self.nx_hat, self.n_eps, self._w_off
            Z = self.Z_tilde
            if self.is_ms:  # shift X̂0 block
                Z[ne + nx:ne + nx + (He - 1) * nx] = Z[ne + 2 * nx:ne + nx + He * nx]
            Z[wo:wo + (He - 1) * nx] = Z[wo + nx:]
            Z[wo + (He - 1) * nx:] = 0.0
            self._moves_since_solve += 1
        i = self.Nk
        self.Y0m_win[i] = y0m
        self.D0_win[i + 1] = d0
        self.U0_win[i] = u0
        self.X0_old_win[i] = x0_old
        self.Nk = i + 1
        self.x_arr_prior = self.X0_old_win[0].copy()
        if moving:
            self.Z_tilde[self.n_eps:self.n_eps + self.nx_hat] = self.x_arr_prior
        return moving

    def _P_arr_valid(self):
        """The stored P̄ must be finite and PD before it can be advanced
        (the reference's cholesky! throws on a corrupted P̄ and the previous
        covariance is retained, mhe/execute.jl:781-797)."""
        P = self.P_arr
        if not np.all(np.isfinite(P)):
            warnings.warn("Arrival covariance P̄ is not finite: keeping the "
                          "old one")
            return False
        if not np.all(np.linalg.eigvalsh(0.5 * (P + P.T)) > 0):
            warnings.warn("Arrival covariance P̄ is not positive definite: "
                          "keeping the old one")
            return False
        return True

    def _correct_cov(self):
        """correct_cov! (mhe/execute.jl:729-752): correct P̄ at the arrival
        with the oldest window data; the state is only a linearization point."""
        if not self._P_arr_valid():
            return
        ce = self.covestim
        ce.x0_hat = self.x_arr_prior.copy()
        ce.P_hat = self.P_arr.copy()
        y0m_arr, d0_arr = self.Y0m_win[0], self.D0_win[0]
        try:
            if not np.any(np.isnan(y0m_arr)):
                ce._correct(y0m_arr, d0_arr)
            self._accept_cov(ce.P_hat)
        except Exception:
            warnings.warn("MHE arrival covariance correction failed; keeping "
                          "the previous covariance")

    def _update_cov(self):
        """update_cov! (mhe/execute.jl:755-779): advance P̄ one step (predict
        only when direct — the correction was already done in _correct_cov)."""
        if not self._P_arr_valid():
            return
        ce = self.covestim
        ce.x0_hat = self.x_arr_prior.copy()
        ce.P_hat = self.P_arr.copy()
        u0_arr, y0m_arr, d0_arr = self.U0_win[0], self.Y0m_win[0], self.D0_win[0]
        try:
            if not self.direct and not np.any(np.isnan(y0m_arr)):
                ce._correct(y0m_arr, d0_arr)
            ce._predict(u0_arr, d0_arr)
            self._accept_cov(ce.P_hat)
        except Exception:
            warnings.warn("MHE arrival covariance update failed; keeping the "
                          "previous covariance")

    def _accept_cov(self, P_new):
        if np.all(np.isfinite(P_new)) and np.all(
                np.linalg.eigvalsh(0.5 * (P_new + P_new.T)) > 0):
            self.P_arr = 0.5 * (P_new + P_new.T)
            self.invP_arr = np.linalg.inv(self.P_arr)
        else:
            warnings.warn("Arrival covariance P̄ is not positive definite: "
                          "keeping the old one")

    def _correct(self, y0m, d0):
        if self.direct:
            moving = self._add_data(y0m, d0, self._pending_u0)
            if moving:
                self._correct_cov()
            self._solve_window()
        else:
            self._y0m_pending = np.asarray(y0m, float).copy()

    def _predict(self, u0, d0):
        if self.direct:
            if self.Nk == self.He:
                self._update_cov()
            self._pending_u0 = np.asarray(u0, float).copy()
        else:
            self._add_data(self._y0m_pending, d0, np.asarray(u0, float))
            self._solve_window()
            if self.Nk == self.He:
                self._update_cov()

    def initstate(self, u, ym, d=None):
        x = super().initstate(u, ym, d)
        self.Nk = 0
        self.Y0m_win[:] = np.nan
        self.U0_win[:] = 0.0
        self.D0_win[:] = 0.0
        if d is not None and self.model.nd:
            # seed the pre-window slot with d0(-1) (mhe/execute.jl:30)
            self.D0_win[0] = np.asarray(d, float) - self.model.dop
        self.X0_old_win[:] = 0.0
        self.Z_tilde[:] = 0.0
        self.x_arr_prior = self.x0_hat.copy()
        self.Z_tilde[self.n_eps:self.n_eps + self.nx_hat] = self.x0_hat
        self._pending_u0 = np.asarray(u, float) - self.model.uop
        self._y_fast = None
        self._moves_since_solve = 0
        return x

    def _update_model(self, model, Qhat, Rhat):
        """setmodel_estimator! for MHE (mhe/execute.jl:944-1050): re-augment,
        rebase every deviation-form window/warm-start/bound from the old
        operating points to the new ones, refresh the objective inverses,
        swap the nested covestim's model, and drop the solver pieces made
        from the old matrices."""
        old = self.model
        uop_old, dop_old = old.uop.copy(), old.dop.copy()
        yopm_old = old.yop[np.asarray(self.i_ym, int)].copy()
        xop_hat_old = self.xop_hat.copy()
        super()._update_model(model, Qhat, Rhat)
        du = uop_old - model.uop
        dd = dop_old - model.dop
        dym = yopm_old - model.yop[np.asarray(self.i_ym, int)]
        dx = xop_hat_old - self.xop_hat
        He, ne, nx = self.He, self.n_eps, self.nx_hat
        self.Y0m_win += dym          # NaN slots stay NaN
        self.U0_win += du
        self.D0_win += dd
        self.X0_old_win += dx
        self.x_arr_prior = self.x_arr_prior + dx
        self.Z_tilde[ne:ne + nx] += dx
        if self.is_ms:               # shift the X̂0 window block too
            self.Z_tilde[ne + nx:ne + nx + He * nx] += np.tile(dx, He)
        self._pending_u0 = self._pending_u0 + du
        for attr in ("X_min", "X_max"):
            b = getattr(self, attr)
            b += np.tile(dx, He + 1)
            np.clip(b, -BIG, BIG, out=b)
        if Qhat is not None:
            self.invQ = np.linalg.inv(self.Q_hat)
        if Rhat is not None:
            self.invR = np.linalg.inv(self.R_hat)
        if self.covestim is not None and self.covestim is not self:
            self.covestim.setmodel(model, Qhat, Rhat)
        self._fns_cache = {}
        self.__dict__.pop("_tensor_fns", None)
        # fast-path prediction matrices hold the OLD Â/B̂/Ĉ — rebuild
        self._fast_mats = None
        self._fast_solve = None
        self._fast_step_cache = None
        self._y_fast = None

    def _init_cov(self):
        self.P_arr = self.P0_hat.copy()
        self.invP_arr = np.linalg.inv(self.P_arr)

    def _set_cov(self, P_hat):
        if P_hat.shape != (self.nx_hat, self.nx_hat):
            raise ValueError(f"P̂ size must be {(self.nx_hat, self.nx_hat)}")
        self.P_arr = P_hat
        self.invP_arr = np.linalg.inv(P_hat)

    def getinfo(self):
        info = {}
        ne, nx = self.n_eps, self.nx_hat
        Nk = self.Nk
        info["What"] = info["Ŵ"] = self.Z_tilde[self._w_off:][:nx * Nk]
        x_arr = self._last.get("x_arr", self.x_arr_prior)
        info["xbar"] = info["x̄"] = self.x_arr_prior - x_arr
        info["xhatarr"] = info["x̂arr"] = x_arr + self.xop_hat
        info["epsilon"] = info["ϵ"] = float(self.Z_tilde[0]) if ne else 0.0
        info["J"] = self._last.get("J")
        info["Xhat"] = info["X̂"] = self._last.get("X")
        info["xhat"] = info["x̂"] = self.x0_hat + self.xop_hat
        info["Pbar"] = info["P̄"] = self.P_arr
        info["Ym"] = self._last.get("Ym")
        info["U"] = self.U0_win[:Nk] + self.model.uop
        info["D"] = self.D0_win + self.model.dop
        info["Nk"] = Nk
        # full output predictions over the valid window slots
        X = self._last.get("X")
        if X is not None and Nk > 0:
            d_slots = self.D0_win[1:Nk + 1]
            Yh = np.stack([np.asarray(self.h_hat(X[j], d_slots[j]), float)
                           for j in range(Nk)]) + self.model.yop
            info["Yhat"] = info["Ŷ"] = Yh.reshape(-1)
            info["Yhatm"] = info["Ŷm"] = Yh[:, np.asarray(self.i_ym, int)].reshape(-1)
        # sensor-noise estimates V̂ = ym − ŷm over the valid window slots
        # (reference getinfo :V̂, mhe/execute.jl:86-203)
        Ym_pred = self._last.get("Ym")
        if Ym_pred is not None:
            mask_w = np.arange(self.He) < self.Nk
            mask_v = mask_w[:, None] & np.isfinite(self.Y0m_win)
            V = np.where(mask_v, np.nan_to_num(self.Y0m_win) - Ym_pred, 0.0)
            info["Vhat"] = info["V̂"] = V[mask_w]
        # the objective's gradient at the optimum (reference getinfo :∇J),
        # of the objective as the window stands (bounds are not END-aligned
        # here: they do not enter the objective)
        p = upload(self._windows_params(), torch.float64, self.device)
        obj = self._fns(torch.float64, self.device)["objective"]
        Zt = torch.as_tensor(self.Z_tilde, dtype=torch.float64, device=self.device)
        info["nablaJ"] = info["∇J"] = grad(obj, argnums=1)(p, Zt).cpu().numpy()
        # solution summary (the reference attaches JuMP.solution_summary)
        info["sol"] = dict(
            solver=("time-varying QP (GI active set, construct-time "
                    "prediction matrices)" if self._fast_applicable()
                    else "time-varying QP (ADMM)" if isinstance(self.model, LinModel)
                    else "GN-SQP (ADMM subproblems)"),
            objective=self._last.get("J"),
            window_fill=f"{Nk}/{self.He}",
            transcription=type(self.transcription).__name__,
            nZt=self.nZt)
        return info
