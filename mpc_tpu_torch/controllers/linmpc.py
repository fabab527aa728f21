"""LinMPC — condensed-QP linear model predictive controller (torch port).

Counterpart of ``mpc_tpu/controllers/linmpc.py``.  Construction is the same
host NumPy code and yields the same ``params`` dict (prediction matrices,
bounds, Hessian, row stack, and the ADMM solver cache or, with
``qp_solver="active_set"``, the Goldfarb–Idnani cache ``gic_Pinv``).  The
per-period step is ``_build_step``: a torch function over a leading lane
axis (F/q̃ build → constraint RHS → warm-start shift → batched QP, ADMM or
GI → receding input), which the fleet (``parallel/batch.py``) runs for
every lane at once and ``moveinput`` runs for one controller as a batch of
one lane, on ``device`` in ``dtype`` (float64 by default, the reference
under x64; float32 is its f32 mode).  The estimator stays on the host.
"""
from __future__ import annotations

import logging
import time
import warnings

import numpy as np
import torch

from ..estimators import InternalModel, StateEstimator, SteadyKalmanFilter
from ..models import LinModel
from ..ops.admm_kernel import admm_sweep
from ..ops.gi_kernel import gi_solve
from ..ops.qp import build_solver_cache, solve_qp
from ..ops.qp_active import build_gi_cache, gi_state_init, solve_qp_active
from ..utils.config import BIG, resolve_device
from ..utils.lanes import lane_products, mtv, mv, register_tiled, take
from ..utils.linalg import repeatdiag
from ..utils.trace import ROOT, span, synced
from .base import (PredictiveController, default_Hp, estimate_delays,
                   info2debugstr)
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
                 gi_max_active=None, dtype=None, device=None,
                 limit_solve_time=False, **estim_kwargs):
        if qp_solver not in ("admm", "active_set"):
            raise ValueError("qp_solver must be 'admm' or 'active_set'")
        self.qp_solver = qp_solver
        # GI slot-buffer cap (ops/qp_active.py max_active); lanes whose true
        # active set overflows it report converged=False
        self.gi_max_active = (None if gi_max_active is None
                              else int(gi_max_active))
        # the step's data dtype (None: float64) and device (None: the GPU;
        # without one it raises, unless the caller asks for the CPU)
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.device = resolve_device(device)
        if isinstance(model_or_estim, StateEstimator):
            estim = model_or_estim
            model = estim.model
            if not isinstance(model, LinModel):
                raise TypeError("estim.model type must be a LinModel")
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
        # Ts-deadline policy (limit_solve_time, general.jl:109-121): the
        # iteration budget of the next solve comes from Ts and an EWMA of the
        # measured per-iteration wall cost; an overrun raises deadline_miss
        self.limit_solve_time = bool(limit_solve_time)
        self._iter_cost = None      # EWMA seconds per QP iteration
        self._deadline_miss = False
        self._solve_time = None
        self._budget_dev = (None, None)
        self._p_dev, self._p_ver = None, None   # params on the device, version
        self._lane = register_tiled(torch.zeros(1, dtype=torch.int32, device=self.device), 1, 1)
        self._build()
        # runtime state
        self.Uop = np.tile(model.uop, Hp)
        self.Yop = np.tile(model.yop, Hp)
        self.Dop = np.tile(model.dop, Hp)
        self.Z_tilde = np.zeros(self.nZt)
        self.y_dual = np.zeros(self.A_stack.shape[0])
        self.rho_rung = 4      # ρ-ladder rung, carried across periods
        self.lastu0 = np.zeros(nu)
        self.d0 = np.zeros(nd)
        self.D_hat_0 = np.zeros(nd * Hp)
        self.R_hat_y = np.tile(model.yop, Hp)
        self.R_hat_u = self.Uop.copy()
        self.ry = model.yop.copy()
        self._last = {}

    # ------------------------------------------------------------------
    def _build(self):
        """(Re)build all construct-time matrices into self.params."""
        model, estim = self.estim.model, self.estim
        Hp, Hc, nb = self.Hp, self.Hc, self.nb
        nu, ny, nd, nx_hat = model.nu, model.ny, model.nd, estim.nx_hat
        tr = self.transcription
        n_eps = self.n_eps
        if isinstance(estim, InternalModel):
            A_hat, Bu_hat, C_hat = model.A, model.Bu, model.C
            Bd_hat, Dd_hat = model.Bd, model.Dd
            xop_hat, fop_hat = model.xop, model.fop
        else:
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
        # stochastic prediction (InternalModel only)
        if isinstance(estim, InternalModel):
            Ks_l, Ps_l = _init_stochpred(estim, Hp)
        else:
            Ks_l = np.zeros((ny * Hp, estim.nxs))
            Ps_l = np.zeros((ny * Hp, ny))
        # bumped on every params mutation; moveinput uploads once per version
        self._params_version = getattr(self, "_params_version", 0) + 1
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
        self._step = _build_step(
            nu, Hc, nd, n_eps, self.nZ, self.n_ineq, self.n_eq,
            isinstance(tr, MultipleShooting), nx_hat, self.nw,
            qp_solver=self.qp_solver, gi_max_active=self.gi_max_active)
        # GI cross-period operator state (one lane, kept on the device): valid
        # only for the CURRENT (H, A), so any rebuild resets it
        if self.qp_solver == "active_set":
            st = gi_state_init(self.gi_slots, 1, torch.float64, self.device)
            self._qp_state = {k: v[0] for k, v in st.items()}
        else:
            self._qp_state = None
        self.rho_rung = 4           # a rebuild restarts the ρ ladder's rung
        self._solved_once = False

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
            self._params_version += 1
        return self

    # ------------------------------------------------------------------
    def setmodel(self, model=None, Mwt=None, Nwt=None, Lwt=None, **cov):
        """Hot-swap the plant model / weights (execute.jl:579-799): rebuilds
        all prediction and constraint matrices with unchanged shapes."""
        if model is not None:
            old = self.estim.model
            if (model.nu, model.nx, model.ny, model.nd) != (old.nu, old.nx, old.ny, old.nd):
                raise ValueError("new model must have the same dimensions")
            # convert runtime bound data to absolute, re-derive with new ops
            Umin = self.U0min + self.Uop
            Umax = self.U0max + self.Uop
            Ymin = self.Y0min + self.Yop
            Ymax = self.Y0max + self.Yop
            xmin = self.x0min + self.estim.xop_hat
            xmax = self.x0max + self.estim.xop_hat
            lastu_abs = self.lastu0 + old.uop  # rebase below with the new uop
            _setmodel_estimator(self.estim, model, **cov)
            self.Uop = np.tile(model.uop, self.Hp)
            self.Yop = np.tile(model.yop, self.Hp)
            self.Dop = np.tile(model.dop, self.Hp)
            self.U0min[:] = _clipinf(Umin - self.Uop)
            self.U0max[:] = _clipinf(Umax - self.Uop)
            self.Y0min[:] = _clipinf(Ymin - self.Yop)
            self.Y0max[:] = _clipinf(Ymax - self.Yop)
            self.x0min[:] = _clipinf(xmin - self.estim.xop_hat)
            self.x0max[:] = _clipinf(xmax - self.estim.xop_hat)
            self.lastu0 = lastu_abs - model.uop
        if Mwt is not None or Nwt is not None or Lwt is not None:
            w = self.weights
            model_ = self.estim.model
            self.weights = ControllerWeights(
                model_.nu, model_.ny, self.Hp, self.Hc,
                Mwt if Mwt is not None else np.diag(w.M_Hp)[:model_.ny],
                Nwt if Nwt is not None else np.diag(w.N_Hc)[:model_.nu],
                Lwt if Lwt is not None else np.diag(w.L_Hp)[:model_.nu],
                Cwt=w.Cwt)
        self._build()
        return self

    # ------------------------------------------------------------------
    def moveinput(self, ry=None, d=None, D_hat=None, R_hat_y=None,
                  R_hat_u=None, lastu=None, Dhat=None, Rhaty=None, Rhatu=None):
        """Solve the MPC problem, return u(k) (execute.jl:59-80).

        One period is ``_build_step`` on a batch of one lane on the
        controller's device: the params go up once per version, the
        period's inputs in one copy, and the outputs come back in one copy,
        which ends the solve's wall time (``getinfo()["solve_time"]``)."""
        estim, model = self.estim, self.estim.model
        if estim.direct and not estim.prepared:
            warnings.warn("preparestate should be called before moveinput with "
                          "current estimators")
        D_hat = D_hat if D_hat is not None else Dhat
        R_hat_y = R_hat_y if R_hat_y is not None else Rhaty
        R_hat_u = R_hat_u if R_hat_u is not None else Rhatu
        ry, d, D_hat, R_hat_y, R_hat_u, lastu = self._prepare_args(
            ry, d, D_hat, R_hat_y, R_hat_u, lastu)
        self.lastu0 = lastu - model.uop
        self.d0 = d - model.dop
        self.D_hat_0 = D_hat - self.Dop
        self.ry, self.R_hat_y, self.R_hat_u = ry, R_hat_y, R_hat_u
        # stochastic prediction inputs (InternalModel)
        if isinstance(estim, InternalModel):
            xs_hat, ys_full = estim.xs_hat, estim.ys_hat
        else:
            xs_hat = np.zeros(self.params["Ks"].shape[1])
            ys_full = np.zeros(model.ny)
        if self.nw:
            y_now = np.asarray(estim.evaloutput(d if model.nd else None), float)
        else:
            y_now = np.zeros(model.ny)
        dev, dt = self.device, self.dtype
        p_dev = self._device_params()
        # Ts-deadline iteration budget for THIS solve (floor 50: the budget
        # must never forbid the warm-started typical case; 2**30 = unlimited)
        if self.limit_solve_time and self._iter_cost:
            budget = int(np.clip(0.8 * model.Ts / self._iter_cost, 50, 2**30))
        else:
            budget = 2**30
        with span(ROOT, dev):
            if self._budget_dev[0] != budget:
                self._budget_dev = (budget, synced(torch.tensor(budget, dtype=torch.int32,
                                                                device=dev)))
            t0_solve = time.perf_counter()
            ins = [estim.x0_hat, self.lastu0, self.d0, self.D_hat_0, R_hat_y,
                   R_hat_u, xs_hat, ys_full, self.Z_tilde, self.y_dual, ry, y_now,
                   [self.rho_rung]]
            flat = synced(torch.as_tensor(np.concatenate(ins)[None], dtype=dt).to(dev))
            (x0_t, lastu0_t, d0_t, Dh_t, Ry_t, Ru_t, xs_t, ys_t, Z_t, y_t, ry_t,
             yn_t, rung_t) = torch.split(flat, [len(a) for a in ins], dim=1)
            # the carried GI operator state stays on the device
            qs = (None if self._qp_state is None
                  else {k: v[None] for k, v in self._qp_state.items()})
            u, Z_t, y_dual, converged, F, obj, iters, rung, qp_state = self._step(
                p_dev, x0_t, lastu0_t, d0_t, Dh_t, Ry_t, Ru_t, xs_t, ys_t,
                Z_t, y_t, rung_t[:, 0].to(torch.int32), self._lane, qp_state=qs,
                ry=ry_t, y_now=yn_t, iter_budget=self._budget_dev[1])
            if qp_state is not None:
                self._qp_state = {k: v[0] for k, v in qp_state.items()}
            out = synced(torch.cat([u, Z_t, y_dual, F, obj[:, None], iters[:, None].to(dt),
                                    converged[:, None].to(dt), rung[:, None].to(dt)],
                                   1)[0].cpu()).numpy()
        wall = time.perf_counter() - t0_solve
        sizes = np.cumsum([model.nu, self.nZt, self.A_stack.shape[0], F.shape[1]])
        u, Z_h, y_h, F_h, rest = np.split(out, sizes)
        self.lastu0_at_solve = self.lastu0.copy()
        self.Z_tilde = Z_h.copy()
        self.y_dual = y_h.copy()
        self.rho_rung = int(rest[3])
        it = int(rest[1])
        if self._solved_once and it > 0:
            # EWMA of seconds per iteration, on periods after the first
            c = wall / it
            self._iter_cost = c if self._iter_cost is None else \
                0.7 * self._iter_cost + 0.3 * c
        self._solve_time = wall
        self._deadline_miss = bool(self.limit_solve_time
                                   and self._solved_once
                                   and wall > model.Ts)
        self._last = dict(F=F_h.copy(), converged=bool(rest[2]),
                          obj=float(rest[0]), d=d, D_hat=D_hat,
                          iters=it, iter_budget=budget,
                          x0_hat=estim.x0_hat.copy())
        self._solved_once = True
        if not self._last["converged"]:
            warnings.warn("MPC solver did not converge; applying shifted warm "
                          "start (graceful degradation)")
            logging.getLogger("mpc_tpu_torch").debug(info2debugstr(self.getinfo()))
        u = u.copy()
        self.lastu0 = u - model.uop
        return u

    def _device_params(self):
        """The params on the device in the step's dtype, with a leading
        controller axis of 1; uploaded again only after a change."""
        if self._p_ver != self._params_version:
            def put(a):
                t = torch.as_tensor(np.asarray(a)[None], device=self.device)
                return t.to(self.dtype) if t.is_floating_point() else t
            self._p_dev = {k: put(v) for k, v in self.params.items()}
            self._p_ver = self._params_version
        return self._p_dev

    # ------------------------------------------------------------------
    def getinfo(self):
        """Optimum diagnostics (execute.jl:145-198)."""
        model, estim = self.estim.model, self.estim
        nu, ny = model.nu, model.ny
        Z_t = self.Z_tilde
        info = {}
        eps = float(Z_t[-1]) if self.n_eps else 0.0
        DU = Z_t[:nu * self.Hc]
        lastu0 = getattr(self, "lastu0_at_solve", self.lastu0)
        U0 = self.params["Pu_t"] @ Z_t + self.params["Tu"] @ lastu0
        Y0 = self.params["E_t"] @ Z_t + self._last["F"]
        info["DeltaU"] = info["ΔU"] = np.asarray(DU)
        info["epsilon"] = info["ϵ"] = eps
        info["J"] = self._last["obj"]
        info["U"] = np.asarray(U0) + self.Uop
        info["u"] = info["U"][:nu]
        info["d"] = self._last.get("d")
        info["Dhat"] = info["D̂"] = self._last.get("D_hat")
        info["xhat"] = info["x̂"] = estim.x0_hat + estim.xop_hat
        info["Yhat"] = info["Ŷ"] = np.asarray(Y0) + self.Yop
        info["Rhaty"] = info["R̂y"] = self.R_hat_y
        info["Rhatu"] = info["R̂u"] = self.R_hat_u
        info["lastu"] = lastu0 + model.uop
        # current output estimate ŷ and stochastic predictions Ŷs
        # (execute.jl:179-182)
        d_now = self._last.get("d")
        info["yhat"] = info["ŷ"] = np.asarray(
            estim.evaloutput(d_now if model.nd else None), float)
        if isinstance(estim, InternalModel):
            info["Yhats"] = info["Ŷs"] = np.asarray(
                self.params["Ks"] @ estim.xs_hat
                + self.params["Ps"] @ estim.ys_hat)
        else:
            info["Yhats"] = info["Ŷs"] = np.zeros(ny * self.Hp)
        # terminal state x̂(k+Hp) = ẽx̂ Z̃ + fx̂ (linconstraint!, :806-821)
        x0s = self._last.get("x0_hat")
        if x0s is not None:
            p = self.params
            fx = p["bx"] + p["kx"] @ x0s + p["vx"] @ lastu0
            if model.nd:
                fx = fx + p["gx"] @ self.d0 + p["jx"] @ self.D_hat_0
            info["xhatend"] = info["x̂end"] = (
                np.asarray(p["ex_t"]) @ Z_t + fx + estim.xop_hat)
        info["converged"] = self._last["converged"]
        info["iters"] = self._last.get("iters")
        # Ts-deadline diagnostics: solve wall time, the iteration budget of
        # this solve, and whether the deadline was missed
        info["solve_time"] = self._solve_time
        info["iter_budget"] = self._last.get("iter_budget")
        info["deadline_miss"] = self._deadline_miss
        return info

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


def _init_stochpred(estim, Hp):
    """Ks, Ps: Ŷs = Ks x̂s + Ps ŷs, all-output form (construct.jl:1236-1267)."""
    As, Bs_hat, Cs = estim.As, estim.Bs_hat, estim.Cs
    ny = estim.model.ny
    nxs = estim.nxs
    Ks = np.zeros((ny * Hp, nxs))
    Ps = np.zeros((ny * Hp, ny))
    Apow = np.eye(nxs)
    for i in range(1, Hp + 1):
        Ms = Cs @ Apow @ Bs_hat          # Cs As^(i-1) B̂s
        rows = slice(ny * (i - 1), ny * i)
        Ks[rows, :] = Cs @ Apow @ As - Ms @ Cs  # Cs As^i − Ms Cs
        Ps[rows, :] = Ms
        Apow = Apow @ As
    return Ks, Ps


def _setmodel_estimator(estim, model, **cov):
    """Delegate to the public estimator API (execute.jl:440-544)."""
    estim.setmodel(model, Qhat=cov.get("Q_hat", cov.get("Qhat")),
                   Rhat=cov.get("R_hat", cov.get("Rhat")))


# ---------------------------------------------------------------------------
def _qp_data(g, nu, nd, nw, n_eq, x0_hat, lastu0, R_hat_y, R_hat_u, xs_hat,
             ys_hat, d0=None, D_hat_0=None, ry=None, y_now=None):
    """The period's QP data ``(F, q̃, r_const, b, beq)`` from the lane
    inputs, each product and per-controller vector through ``g`` (a layout
    of ``utils/lanes.py``: lane tensors (·, k), every op on the last axis)."""
    L, M, Mt = g.L, g.M, g.Mt
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
    # --- custom linear constraints Fw (relaxW + linconstraint_custom!,
    # execute.jl:337-366) ---
    if nw:
        Ue_t = g.cat([Tu_lastu0 + L("Uop"), lastu0 + L("Uop")[..., :nu]])
        Fw = M("Wu_bar", Ue_t)
        if nd:
            De_t = g.cat([d0 + L("dop_w"), D_hat_0 + L("Dop_w")])
            Fw = Fw + M("Wd_bar", De_t)
        Fw = Fw + M("Wr_bar", g.cat([ry, R_hat_y]))
        Fw = Fw + M("Wy_bar", g.cat([y_now, F + L("Yop")]))
        bW = g.cat([-L("Wmin_b") + Fw, L("Wmax_b") - Fw])
    else:
        bW = F[..., :0]
    # --- inequality RHS b (transcription.jl:824-842 order) ---
    b = g.cat([
        -L("U0min") + Tu_lastu0,
        L("U0max") - Tu_lastu0,
        -L("DUmin"),
        L("DUmax"),
        -L("Y0min") + F,
        L("Y0max") - F,
        bW,
        -L("x0min") + fx,
        L("x0max") - fx,
    ])
    b = torch.clamp(b, -2e18, 2e18)
    # --- equality RHS beq = −FS (linconstrainteq!) ---
    FS = L("BS") + M("KS", x0_hat) + M("VS", lastu0)
    if nd and n_eq:
        FS = FS + M("GS", d0) + M("JS", D_hat_0)
    return F, q, r_const, b, -FS


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
    no ``qp_state`` is given.  Custom linear constraints (``nw`` > 0) need
    the setpoint ``ry`` and the current output estimate ``y_now``, (B, ny)
    each.  ``iter_budget`` (int or tensor) caps the QP's iterations.
    """
    use_as = qp_solver == "active_set"

    def step(p, x0_hat, lastu0, d0, D_hat_0, R_hat_y, R_hat_u, xs_hat, ys_hat,
             Z_prev, y_prev, rung_prev, lane_ctrl, sweep=admm_sweep,
             qp_state=None, gi=gi_solve, ry=None, y_now=None, iter_budget=None):
        B = x0_hat.shape[0]
        dt, dev = x0_hat.dtype, x0_hat.device
        L = lambda k: take(p[k], lane_ctrl)
        M = lambda k, v: mv(p[k], v, lane_ctrl)
        Mt = lambda k, v: mtv(p[k], v, lane_ctrl)
        full = lambda k, val: torch.full((B, k), val, dtype=dt, device=dev)
        with span("qp.build"):
            # F, q̃, the rows' RHS b and beq in the layout the lane map allows
            # (one GEMM a controller over its lanes for a tiled map), back in
            # lane order for the solve
            g = lane_products(p, lane_ctrl, B)
            lane_in = dict(x0_hat=x0_hat, lastu0=lastu0, R_hat_y=R_hat_y,
                           R_hat_u=R_hat_u, xs_hat=xs_hat, ys_hat=ys_hat)
            if nd:
                lane_in.update(d0=d0, D_hat_0=D_hat_0)
            if nw:
                if ry is None or y_now is None:
                    raise ValueError("custom linear constraints need the step's "
                                     "ry and y_now")
                lane_in.update(ry=ry, y_now=y_now)
            F, q, r_const, b, beq = map(g.out, _qp_data(
                g, nu, nd, nw, n_eq, **{k: g.into(v) for k, v in lane_in.items()}))
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
        with span("qp.solve"):
            # --- solve QP ---
            def gi_qp(P, q_, A, l_, u_, y0):
                # GI with the cross-period operator carry when qp_state is given
                # (P and A are step-invariant, so the carried inverse Gram stays
                # exact); dual-seed warm start otherwise
                return solve_qp_active(
                    P, q_, A, l_, u_, None if qp_state is not None else y0,
                    lane_ctrl=lane_ctrl, cache={"gic_Pinv": p["gic_Pinv"]},
                    state0=qp_state, iter_budget=iter_budget,
                    max_active=gi_max_active, slot_dtype=slot_dtype, solve=gi)

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
                                   lane_ctrl=lane_ctrl, iter_budget=iter_budget,
                                   sweep=sweep)
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
                               lane_ctrl=lane_ctrl, iter_budget=iter_budget,
                               sweep=sweep)
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
