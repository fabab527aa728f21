"""LinMPC — condensed-QP linear model predictive controller (torch port).

Counterpart of ``mpc_tpu/controllers/linmpc.py``.  Construction is the same
host NumPy code and yields the same ``params`` dict (prediction matrices,
bounds, Hessian, row stack, and the ADMM solver cache or, with
``qp_solver="active_set"``, the Goldfarb–Idnani cache ``gic_Pinv``).  The
per-period step is ``_build_step``: a torch function over a leading lane
axis (F/q̃ build → constraint RHS → warm-start shift → batched QP, ADMM or
GI → receding input), which the fleet (``parallel/batch.py``) runs for
every lane at once.

Not ported yet (see ROADMAP): the single-controller ``moveinput``/``getinfo``
and ``setmodel``, custom linear constraints in the runtime step, and
estimators other than the SteadyKalmanFilter.
"""
from __future__ import annotations

import numpy as np
import torch

from ..estimators import StateEstimator, SteadyKalmanFilter
from ..models import LinModel
from ..ops.admm_kernel import admm_sweep
from ..ops.gi_kernel import gi_solve
from ..ops.qp import build_solver_cache, solve_qp
from ..ops.qp_active import build_gi_cache, solve_qp_active
from ..utils.config import BIG
from ..utils.lanes import mtv, mv, take
from ..utils.linalg import repeatdiag
from .base import PredictiveController, default_Hp, estimate_delays
from .construct import (ControllerWeights, init_quadprog, relax_DU,
                        relax_terminal, relax_U, relax_Y)
from .transcription import (MultipleShooting, SingleShooting,
                            TranscriptionMethod, init_defectmat, init_predmat,
                            init_ZtoDU, init_ZtoU, move_blocking)

ADMM_CACHE_KEYS = ("qpc_D", "qpc_E", "qpc_c", "qpc_eq", "qpc_loose",
                   "qpc_rhovs", "qpc_Minvs")


def _clipinf(v):
    return np.clip(np.nan_to_num(v, nan=0.0, posinf=BIG, neginf=-BIG), -BIG, BIG)


class LinMPC(PredictiveController):
    def __init__(self, model_or_estim, Hp=None, Hc=2,
                 Mwt=None, Nwt=None, Lwt=None, M_Hp=None, N_Hc=None, L_Hp=None,
                 Cwt=1e5, transcription: TranscriptionMethod | None = None,
                 Wy=None, Wu=None, Wd=None, Wr=None, qp_solver="admm",
                 gi_max_active=None, **estim_kwargs):
        if qp_solver not in ("admm", "active_set"):
            raise ValueError("qp_solver must be 'admm' or 'active_set'")
        self.qp_solver = qp_solver
        # GI slot-buffer cap (ops/qp_active.py max_active); lanes whose true
        # active set overflows it report converged=False
        self.gi_max_active = (None if gi_max_active is None
                              else int(gi_max_active))
        if isinstance(model_or_estim, StateEstimator):
            estim = model_or_estim
            model = estim.model
            if not isinstance(model, LinModel):
                raise TypeError("estim.model type must be a LinModel")
            if not isinstance(estim, SteadyKalmanFilter):
                raise NotImplementedError(
                    "only the SteadyKalmanFilter is ported so far (ROADMAP "
                    f"queue 1, item 6); got {type(estim).__name__}")
        else:
            model = model_or_estim
            if not isinstance(model, LinModel):
                raise TypeError("model type must be a LinModel")
            estim = SteadyKalmanFilter(model, **estim_kwargs)
        self.estim = estim
        self.transcription = transcription or SingleShooting()
        if not isinstance(self.transcription, (SingleShooting, MultipleShooting)):
            # reference restricts LinMPC to SS/MS (src/controller/linmpc.jl:244)
            raise ValueError(
                "LinMPC only supports SingleShooting and MultipleShooting "
                f"transcriptions, got {type(self.transcription).__name__}")
        Hp = default_Hp(model) if Hp is None else int(Hp)
        nk_delays = estimate_delays(model)
        if Hp <= nk_delays:
            import warnings
            warnings.warn(f"prediction horizon Hp ({Hp}) <= estimated number "
                          f"of delays in model ({nk_delays}), the closed-loop "
                          "system may be unstable or zero-gain (unresponsive)")
        nb = move_blocking(Hp, Hc)
        Hc = len(nb)
        self.Hp, self.Hc, self.nb = Hp, Hc, nb
        nu, ny, nd = model.nu, model.ny, model.nd
        self.weights = ControllerWeights(nu, ny, Hp, Hc, Mwt, Nwt, Lwt,
                                         M_Hp, N_Hc, L_Hp, Cwt)
        self.n_eps = self.weights.n_eps
        self.Wy, self.Wu, self.Wd, self.Wr, self.nw = _validate_custom_lincon(
            model, Wy, Wu, Wd, Wr)
        self._solved_once = False
        self._build()
        self.Uop = np.tile(model.uop, Hp)
        self.Yop = np.tile(model.yop, Hp)
        self.Z_tilde = np.zeros(self.nZt)
        self.y_dual = np.zeros(self.A_stack.shape[0])
        self.rho_rung = 4      # ρ-ladder rung, carried across periods
        self.lastu0 = np.zeros(nu)

    # ------------------------------------------------------------------
    def _build(self):
        """(Re)build all construct-time matrices into self.params."""
        model, estim = self.estim.model, self.estim
        Hp, Hc, nb = self.Hp, self.Hc, self.nb
        nu, ny, nd, nx_hat = model.nu, model.ny, model.nd, estim.nx_hat
        tr = self.transcription
        n_eps = self.n_eps
        A_hat, Bu_hat, C_hat = estim.A_hat, estim.Bu_hat, estim.C_hat
        Bd_hat, Dd_hat = estim.Bd_hat, estim.Dd_hat
        xop_hat, fop_hat = estim.xop_hat, estim.fop_hat
        (E, G, J, K, V, B, ex, gx, jx, kx, vx, bx) = init_predmat(
            tr, A_hat, Bu_hat, C_hat, Bd_hat, Dd_hat, xop_hat, fop_hat, Hp, Hc, nb)
        ES, GS, JS, KS, VS, BS = init_defectmat(
            tr, A_hat, Bu_hat, Bd_hat, xop_hat, fop_hat, Hp, Hc, nb)
        PDu = init_ZtoDU(tr, nu, nx_hat, Hp, Hc)
        Pu, Tu = init_ZtoU(tr, nu, nx_hat, Hp, Hc, nb)
        nZ = tr.nZ(nu, nx_hat, Hp, Hc)
        self.nZ = nZ
        self.nZt = nZ + n_eps
        # softness parameters (defaults: hard u/Δu, soft y/terminal)
        if not hasattr(self, "C_umin"):
            self.C_umin = np.zeros(nu * Hp)
            self.C_umax = np.zeros(nu * Hp)
            self.C_dumin = np.zeros(nu * Hc)
            self.C_dumax = np.zeros(nu * Hc)
            self.C_ymin = np.ones(ny * Hp)
            self.C_ymax = np.ones(ny * Hp)
            self.c_xmin = np.ones(nx_hat)
            self.c_xmax = np.ones(nx_hat)
        A_Umin, A_Umax, Pu_t = relax_U(Pu, self.C_umin, self.C_umax, n_eps)
        A_DUmin, A_DUmax, PDu_t = relax_DU(PDu, self.C_dumin, self.C_dumax, n_eps)
        A_Ymin, A_Ymax, E_t = relax_Y(E, self.C_ymin, self.C_ymax, n_eps)
        A_xmin, A_xmax, ex_t = relax_terminal(ex, self.c_xmin, self.c_xmax, n_eps)
        # custom linear constraints: W = Ew Z + Fw (relaxW, construct.jl:1085-1160)
        nw = self.nw
        nW = nw * (Hp + 1)
        Wy_bar = repeatdiag(self.Wy, Hp + 1) if nw else np.zeros((0, (Hp + 1) * ny))
        Wu_bar = repeatdiag(self.Wu, Hp + 1) if nw else np.zeros((0, (Hp + 1) * nu))
        Wd_bar = repeatdiag(self.Wd, Hp + 1) if nw else np.zeros((0, (Hp + 1) * nd))
        Wr_bar = repeatdiag(self.Wr, Hp + 1) if nw else np.zeros((0, (Hp + 1) * ny))
        if nw:
            Ew = (Wy_bar @ np.vstack([np.zeros((ny, E.shape[1])), E])
                  + Wu_bar @ np.vstack([Pu, Pu[-nu:, :]]))
            if not hasattr(self, "C_wmin"):
                self.C_wmin = np.ones(nW)
                self.C_wmax = np.ones(nW)
                self.Wmin_b = np.full(nW, -BIG)
                self.Wmax_b = np.full(nW, BIG)
            if n_eps:
                A_Wmin = -np.hstack([Ew, self.C_wmin[:, None]])
                A_Wmax = np.hstack([Ew, -self.C_wmax[:, None]])
            else:
                A_Wmin, A_Wmax = -Ew, Ew
        else:
            self.C_wmin = np.zeros(0)
            self.C_wmax = np.zeros(0)
            self.Wmin_b = np.zeros(0)
            self.Wmax_b = np.zeros(0)
            A_Wmin = np.zeros((0, self.nZt))
            A_Wmax = np.zeros((0, self.nZt))
        if n_eps:
            ES_t = np.hstack([ES, np.zeros((ES.shape[0], 1))])
        else:
            ES_t = ES
        H = init_quadprog(E_t, PDu_t, Pu_t, self.weights,
                          single_shooting=isinstance(tr, SingleShooting))
        # one-sided inequality row stack (order = linconstraint! b layout,
        # controller/transcription.jl:824-842) + ϵ ≥ 0 + equality rows
        rows = [A_Umin, A_Umax, A_DUmin, A_DUmax, A_Ymin, A_Ymax,
                A_Wmin, A_Wmax, A_xmin, A_xmax]
        A_ineq = np.vstack(rows)
        if n_eps:
            eps_row = np.zeros((1, self.nZt))
            eps_row[0, -1] = 1.0
        else:
            eps_row = np.zeros((0, self.nZt))
        self.A_stack = np.vstack([A_ineq, eps_row, ES_t])
        self.n_ineq = A_ineq.shape[0]
        self.n_eq = ES_t.shape[0]
        # construct-time equality elimination (MultipleShooting): the defect
        # rows ES̃ Z̃ = beq are eliminated through a QR nullspace
        # (Z̃ = Z̃p + N v, ES̃ N = 0), so the device QP is SS-sized and
        # inequality-only
        self.elim_eq = self.n_eq > 0
        if self.elim_eq:
            Q, R = np.linalg.qr(ES_t.T, mode="complete")
            N = Q[:, self.n_eq:]                     # orthonormal null basis
            Aeq_dag = Q[:, :self.n_eq] @ np.linalg.inv(R[:self.n_eq, :]).T
            A_ie = np.vstack([A_ineq, eps_row])      # rows kept in the QP
            self._elim = dict(Nnull=N, Aeq_dag=Aeq_dag, NTH=N.T @ H,
                              H_r=N.T @ H @ N, A_r=A_ie @ N)
        else:
            self._elim = {}
        self.n_qp = self.nZt - self.n_eq if self.elim_eq else self.nZt
        # GI slot-buffer size: capped by gi_max_active when set
        self.gi_slots = (self.n_qp if self.gi_max_active is None
                         else min(self.n_qp, self.gi_max_active))
        # default bounds (deviation form), kept as data
        if not hasattr(self, "U0min"):
            self.U0min = np.full(nu * Hp, -BIG)
            self.U0max = np.full(nu * Hp, BIG)
            self.DUmin = np.full(nu * Hc, -BIG)
            self.DUmax = np.full(nu * Hc, BIG)
            self.Y0min = np.full(ny * Hp, -BIG)
            self.Y0max = np.full(ny * Hp, BIG)
            self.x0min = np.full(nx_hat, -BIG)
            self.x0max = np.full(nx_hat, BIG)
        # stochastic prediction: zero for the Kalman estimators (only the
        # InternalModel fills Ks/Ps)
        Ks_l = np.zeros((ny * Hp, estim.nxs))
        Ps_l = np.zeros((ny * Hp, ny))
        self.params = dict(
            H=H, E_t=E_t, G=G, J=J, K=K, V=V, B=B,
            gx=gx, jx=jx, kx=kx, vx=vx, bx=bx,
            GS=GS, JS=JS, KS=KS, VS=VS, BS=BS,
            Pu_t=Pu_t, PDu_t=PDu_t, Tu=Tu,
            A_stack=self.A_stack,
            M_Hp=self.weights.M_Hp, L_Hp=self.weights.L_Hp,
            Uop=np.tile(model.uop, Hp), Yop=np.tile(model.yop, Hp),
            U0min=self.U0min, U0max=self.U0max,
            DUmin=self.DUmin, DUmax=self.DUmax,
            Y0min=self.Y0min, Y0max=self.Y0max,
            x0min=self.x0min, x0max=self.x0max,
            C_umin_u=self.C_umin[:nu], C_umax_u=self.C_umax[:nu],
            Ks=Ks_l, Ps=Ps_l, ex_t=ex_t,
            Wy_bar=Wy_bar, Wu_bar=Wu_bar, Wd_bar=Wd_bar, Wr_bar=Wr_bar,
            Wmin_b=self.Wmin_b, Wmax_b=self.Wmax_b,
            dop_w=model.dop, Dop_w=np.tile(model.dop, Hp),
            **self._elim,
        )
        self._rebuild_qp_cache()

    # ------------------------------------------------------------------
    def _rebuild_qp_cache(self):
        """Step-invariant QP setup for the current (H̃, A_stack), built on
        the host in f64 (with MultipleShooting elimination on the reduced
        (H_r, A_r)): the refined P⁻¹ for GI, or the Ruiz diagonals and
        ρ-ladder inverses for the current bound classification for ADMM."""
        if self.elim_eq:
            Hm, Am = self.params["H_r"], self.params["A_r"]
        else:
            Hm, Am = self.params["H"], self.A_stack
        if self.qp_solver == "active_set":
            self.params.update(build_gi_cache(Hm, Am))
            return
        TH = 1e18   # ops.qp._BIG: rows at/beyond this are "infinite"
        loose = np.concatenate([
            self.U0min <= -TH, self.U0max >= TH,
            self.DUmin <= -TH, self.DUmax >= TH,
            self.Y0min <= -TH, self.Y0max >= TH,
            self.Wmin_b <= -TH, self.Wmax_b >= TH,
            self.x0min <= -TH, self.x0max >= TH,
            np.zeros(self.n_eps, bool)])
        if not self.elim_eq:
            loose = np.concatenate([loose, np.zeros(self.n_eq, bool)])
        eq = np.zeros(Am.shape[0], bool)
        self.params.update(build_solver_cache(Hm, Am, eq, loose))

    # ------------------------------------------------------------------
    def setconstraint(self, **kw):
        """Set bound constraints (setconstraint!, construct.jl:324-559).

        Keywords: umin/umax, Δumin (dumin)/Δumax (dumax), ymin/ymax,
        x̂min (xhatmin)/x̂max (xhatmax); capitalized versions (Umin, Ymax, …)
        for full-horizon time-varying bounds; c_* / C_* softness weights.
        """
        model, estim = self.estim.model, self.estim
        nu, ny, nx_hat = model.nu, model.ny, estim.nx_hat
        Hp, Hc = self.Hp, self.Hc
        Uop, Yop = np.tile(model.uop, Hp), np.tile(model.yop, Hp)
        g = kw.get

        def pick(small, cap, n, rep):
            v = g(cap)
            if v is not None:
                v = np.asarray(v, float).ravel()
                if v.shape != (n * rep,):
                    raise ValueError(f"{cap} size must be ({n * rep},)")
                return v
            v = g(small)
            if v is not None:
                v = np.asarray(v, float).ravel()
                if v.shape != (n,):
                    raise ValueError(f"{small} size must be ({n},)")
                return np.tile(v, rep)
            return None

        v = pick("umin", "Umin", nu, Hp)
        if v is not None:
            self.U0min[:] = _clipinf(v - Uop)
        v = pick("umax", "Umax", nu, Hp)
        if v is not None:
            self.U0max[:] = _clipinf(v - Uop)
        v = pick("dumin", "DUmin", nu, Hc) if "dumin" in kw or "DUmin" in kw else \
            pick("Deltaumin", "DeltaUmin", nu, Hc)
        if v is not None:
            self.DUmin[:] = _clipinf(v)
        v = pick("dumax", "DUmax", nu, Hc) if "dumax" in kw or "DUmax" in kw else \
            pick("Deltaumax", "DeltaUmax", nu, Hc)
        if v is not None:
            self.DUmax[:] = _clipinf(v)
        v = pick("ymin", "Ymin", ny, Hp)
        if v is not None:
            self.Y0min[:] = _clipinf(v - Yop)
        v = pick("ymax", "Ymax", ny, Hp)
        if v is not None:
            self.Y0max[:] = _clipinf(v - Yop)
        for kws, attr in (("xhatmin", "x0min"), ("xhatmax", "x0max")):
            v = g(kws)
            if v is not None:
                v = np.asarray(v, float).ravel()
                if v.shape != (nx_hat,):
                    raise ValueError(f"{kws} size must be ({nx_hat},)")
                getattr(self, attr)[:] = _clipinf(v - estim.xop_hat)
        if self.nw:
            v = pick("wmin", "Wmin", self.nw, Hp + 1)
            if v is not None:
                self.Wmin_b[:] = _clipinf(v)
            v = pick("wmax", "Wmax", self.nw, Hp + 1)
            if v is not None:
                self.Wmax_b[:] = _clipinf(v)
        # softness updates rebuild the A matrices (construct-time only)
        soft = {k: v for k, v in kw.items() if k.startswith("c_") or k.startswith("C_")}
        if soft:
            if self.n_eps != 1:
                raise ValueError("Slack variable weight Cwt must be finite to set "
                                 "softness parameters")
            if self._solved_once:
                raise RuntimeError("Cannot set softness parameters after calling "
                                   "moveinput")
            m = {"c_umin": ("C_umin", nu, Hp), "c_umax": ("C_umax", nu, Hp),
                 "c_dumin": ("C_dumin", nu, Hc), "c_dumax": ("C_dumax", nu, Hc),
                 "c_Deltaumin": ("C_dumin", nu, Hc), "c_Deltaumax": ("C_dumax", nu, Hc),
                 "c_ymin": ("C_ymin", ny, Hp), "c_ymax": ("C_ymax", ny, Hp),
                 "c_xhatmin": ("c_xmin", nx_hat, 1), "c_xhatmax": ("c_xmax", nx_hat, 1)}
            for k, v in soft.items():
                key = k if k.startswith("c_") else "c_" + k[2:].lower()
                if key not in m:
                    raise ValueError(f"unknown softness parameter {k}")
                attr, n, rep = m[key]
                v = np.asarray(v, float).ravel()
                if np.any(v < 0):
                    raise ValueError(f"{k} weights should be non-negative")
                vv = np.tile(v, rep) if v.shape == (n,) else v
                if vv.shape != (n * rep,):
                    raise ValueError(f"{k} size must be ({n},) or ({n * rep},)")
                setattr(self, attr, vv)
            self._build()
        else:
            for name in ("U0min", "U0max", "DUmin", "DUmax", "Y0min", "Y0max",
                         "x0min", "x0max", "Wmin_b", "Wmax_b"):
                self.params[name] = getattr(self, name)
            # a bound crossing ±BIG changes the ADMM row classification
            # (and with it the cached ρ-ladder) — rebuild the cache
            self._rebuild_qp_cache()
        return self

    def __repr__(self):
        model = self.estim.model
        optimizer = ("Goldfarb–Idnani active-set QP" if self.qp_solver == "active_set"
                     else "ADMM-QP")
        return (f"{type(self).__name__} controller with a sample time Ts = "
                f"{model.Ts} s:\n"
                f"├ estimator: {type(self.estim).__name__}\n"
                f"├ model: {type(model).__name__}\n"
                f"├ optimizer: {optimizer} (torch)\n"
                f"├ transcription: {type(self.transcription).__name__}\n"
                f"└ dimensions: Hp={self.Hp}, Hc={self.Hc}, nu={model.nu}, "
                f"nx̂={self.estim.nx_hat}, nym={self.estim.nym}, nd={model.nd}, "
                f"nZ̃={self.nZt}")


def _validate_custom_lincon(model, Wy, Wu, Wd, Wr):
    """Validate W matrices (construct.jl:665-695); None → zero matrices."""
    nu, nd, ny = model.nu, model.nd, model.ny
    nw = 0
    for M in (Wy, Wu, Wd, Wr):
        if M is not None:
            nw = np.atleast_2d(np.asarray(M, float)).shape[0]
            break

    def pad(M, ncols, name):
        if M is None:
            return np.zeros((nw, ncols))
        M = np.atleast_2d(np.asarray(M, float))
        if M.shape != (nw, ncols):
            raise ValueError(f"{name} must have shape ({nw}, {ncols})")
        return M
    return (pad(Wy, ny, "Wy"), pad(Wu, nu, "Wu"), pad(Wd, nd, "Wd"),
            pad(Wr, ny, "Wr"), nw)


# ---------------------------------------------------------------------------
def _build_step(nu, Hc, nd, n_eps, nZ, n_ineq, n_eq, is_ms, nx_hat, nw=0,
                qp_solver="admm", gi_max_active=None, slot_dtype=None):
    """Create the per-period step over a leading lane axis.

    ``p`` holds the params stacked over distinct controllers (tensors on the
    fleet's device); lane ``b`` reads controller ``lane_ctrl[b]``.  Every
    other argument is per lane.  Returns ``(u, Z̃, y, converged, F, obj,
    iters, rung, gi_state)``, each batch-leading; ``gi_state`` is None for
    ADMM.  With ``qp_solver="active_set"`` the QP is the Goldfarb–Idnani
    solve (``gi_max_active`` slots, ``slot_dtype`` slot precision), which
    carries ``qp_state`` across periods and seeds from ``y_prev`` only when
    no ``qp_state`` is given.
    """
    if nw:
        raise NotImplementedError(
            "custom linear constraints (Wy/Wu/Wd/Wr) in the runtime step wait "
            "for the single-controller moveinput port (ROADMAP queue 1, item 4)")
    use_as = qp_solver == "active_set"

    def step(p, x0_hat, lastu0, d0, D_hat_0, R_hat_y, R_hat_u, xs_hat, ys_hat,
             Z_prev, y_prev, rung_prev, lane_ctrl, sweep=admm_sweep,
             qp_state=None, gi=gi_solve):
        B = x0_hat.shape[0]
        dt, dev = x0_hat.dtype, x0_hat.device
        L = lambda k: take(p[k], lane_ctrl)
        M = lambda k, v: mv(p[k], v, lane_ctrl)
        Mt = lambda k, v: mtv(p[k], v, lane_ctrl)
        full = lambda k, val: torch.full((B, k), val, dtype=dt, device=dev)
        # --- stochastic + deterministic output predictions F (initpred!) ---
        Ys = M("Ks", xs_hat) + M("Ps", ys_hat)
        F = L("B") + M("K", x0_hat) + M("V", lastu0) + Ys
        if nd:
            F = F + M("G", d0) + M("J", D_hat_0)
        Tu_lastu0 = M("Tu", lastu0)
        # --- linear coefficient q̃ (initpred!, execute.jl:247-277) ---
        Cy = F + L("Yop") - R_hat_y
        Cu = Tu_lastu0 + L("Uop") - R_hat_u
        q = 2.0 * (Mt("E_t", M("M_Hp", Cy)) + Mt("Pu_t", M("L_Hp", Cu)))
        r_const = (torch.sum(Mt("M_Hp", Cy) * Cy, -1)
                   + torch.sum(Mt("L_Hp", Cu) * Cu, -1))
        # --- terminal prediction fx̂ (linconstraint!) ---
        fx = L("bx") + M("kx", x0_hat) + M("vx", lastu0)
        if nd:
            fx = fx + M("gx", d0) + M("jx", D_hat_0)
        # --- inequality RHS b (transcription.jl:824-842 order) ---
        b = torch.cat([
            -L("U0min") + Tu_lastu0,
            L("U0max") - Tu_lastu0,
            -L("DUmin"),
            L("DUmax"),
            -L("Y0min") + F,
            L("Y0max") - F,
            -L("x0min") + fx,
            L("x0max") - fx,
        ], -1)
        b = torch.clamp(b, -2e18, 2e18)
        # --- equality RHS beq = −FS (linconstrainteq!) ---
        FS = L("BS") + M("KS", x0_hat) + M("VS", lastu0)
        if nd and n_eq:
            FS = FS + M("GS", d0) + M("JS", D_hat_0)
        beq = -FS
        # --- stack l ≤ A Z̃ ≤ u ---
        l = torch.cat([full(n_ineq, -2e18), full(n_eps, 0.0), beq], -1)
        u_vec = torch.cat([b, full(n_eps, 2e18), beq], -1)
        # --- warm start: shift previous solution (transcription.jl:997-1100) ---
        nDU = nu * Hc
        Zs = torch.zeros_like(Z_prev)
        Zs[:, :nDU - nu] = Z_prev[:, nu:nDU]
        if is_ms:
            nX = nZ - nDU  # = nx̂*Hp
            Zs[:, nDU:nDU + nX - nx_hat] = Z_prev[:, nDU + nx_hat:nDU + nX]
            Zs[:, nDU + nX - nx_hat:nDU + nX] = Z_prev[:, nDU + nX - nx_hat:nDU + nX]
        if n_eps:
            Zs[:, -1] = Z_prev[:, -1]
        # --- solve QP ---
        def gi_qp(P, q_, A, l_, u_, y0):
            # GI with the cross-period operator carry when qp_state is given
            # (P and A are step-invariant, so the carried inverse Gram stays
            # exact); dual-seed warm start otherwise
            return solve_qp_active(
                P, q_, A, l_, u_, None if qp_state is not None else y0,
                lane_ctrl=lane_ctrl, cache={"gic_Pinv": p["gic_Pinv"]},
                state0=qp_state, max_active=gi_max_active,
                slot_dtype=slot_dtype, solve=gi)

        if not use_as:
            cache = {k: p[k] for k in ADMM_CACHE_KEYS}
        if is_ms and n_eq:
            # MultipleShooting via construct-time equality elimination:
            # Z̃ = Z̃p + N v with ES̃ N = 0
            n_ie = n_ineq + n_eps
            Zp = M("Aeq_dag", beq)
            q_r = Mt("Nnull", q) + M("NTH", Zp)
            shift = mv(p["A_stack"][:, :n_ie], Zp, lane_ctrl)
            l_r = torch.clamp(l[:, :n_ie] - shift, -2e18, 2e18)
            u_r = torch.clamp(u_vec[:, :n_ie] - shift, -2e18, 2e18)
            y0r = y_prev[:, :n_ie].contiguous()
            if use_as:
                sol = gi_qp(p["H_r"], q_r, p["A_r"], l_r, u_r, y0r)
            else:
                v0 = Mt("Nnull", Zs - Zp)
                sol = solve_qp(p["H_r"], q_r, p["A_r"], l_r, u_r, x0=v0,
                               y0=y0r, rung0=rung_prev, cache=cache,
                               lane_ctrl=lane_ctrl, sweep=sweep)
            Z_sol = Zp + M("Nnull", sol.x)
            y_full = torch.cat([sol.y, full(n_eq, 0.0)], -1)
            obj = (sol.obj + 0.5 * torch.sum(Zp * M("H", Zp), -1)
                   + torch.sum(q * Zp, -1))
            sol = sol._replace(x=Z_sol, y=y_full, obj=obj)
        elif use_as:
            sol = gi_qp(p["H"], q, p["A_stack"], l, u_vec, y_prev)
        else:
            sol = solve_qp(p["H"], q, p["A_stack"], l, u_vec, x0=Zs,
                           y0=y_prev, rung0=rung_prev, cache=cache,
                           lane_ctrl=lane_ctrl, sweep=sweep)
        Z_t = torch.where(sol.converged[:, None], sol.x, Zs)
        # --- receding horizon input (getinput!, execute.jl:536-546),
        # clamped to the (soft-relaxed) actuator box for hard safety ---
        u0 = Z_t[:, :nu] + lastu0
        eps_f = Z_t[:, -1:] if n_eps else 0.0
        u0 = torch.clamp(u0,
                         L("U0min")[:, :nu] - L("C_umin_u") * eps_f,
                         L("U0max")[:, :nu] + L("C_umax_u") * eps_f)
        u = u0 + L("Uop")[:, :nu]
        return (u, Z_t, sol.y, sol.converged, F, sol.obj + r_const,
                sol.iters, sol.rung, sol.gi_state)

    return step
