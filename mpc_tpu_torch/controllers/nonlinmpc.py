"""NonLinMPC — nonlinear MPC by an SQP loop (counterpart of
``mpc_tpu/controllers/nonlinmpc.py``; reference ``src/controller/nonlinmpc.jl``).

One control period is one step over a leading lane axis, on the device:

* the rollout of the augmented model over Hp (SingleShooting: a loop over
  the stages; MultipleShooting and collocation: every stage at once under
  ``torch.func.vmap``);
* Jacobians by ``torch.func.jacrev`` (plain MultipleShooting: per stage;
  otherwise through the whole rollout), the objective's gradient by the
  chain rule through them (``grad`` for an economic term), a Gauss–Newton
  Hessian (or the exact Lagrangian Hessian, reverse over reverse,
  projected to its PSD part), the linearized constraint rows;
* the defect equalities eliminated by a nullspace (structured for plain
  MultipleShooting, a complete QR for collocation), a trust box on the
  tangential step, the reduced QP solved by Goldfarb–Idnani or ADMM
  through the hand-written kernels, a second-order correction, the ℓ1
  merit with its μ rule, and a six-step line search.

The user functions ``f``/``h``/``JE``/``gc`` run on ONE sample and are
batched by ``vmap``.  The reference's SQP ``lax.while_loop`` runs under
``vmap`` in its fleet: every lane steps until the last one stops, and a
lane whose exit test failed keeps its carry.  Here the loop is one Python
loop over all lanes: each iteration evaluates the exit test per lane
(one host sync), updates the active lanes with ``torch.where`` and gives
the frozen lanes a QP budget of 0, so each lane's answer is what it would
be alone.  A single controller's ``moveinput`` is the one-lane case.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from ..estimators import (InternalModel, StateEstimator, SteadyKalmanFilter,
                          UnscentedKalmanFilter)
from ..models import LinModel, NonLinModel, RungeKutta
from ..ops.qp import solve_qp
from ..ops.qp_active import solve_qp_active
from ..utils.config import BIG, as_device, resolve_device
from ..utils.lanes import mtv, mv
from ..utils.linalg import repeatdiag
from .base import PredictiveController, default_Hp, info2debugstr
from .construct import ControllerWeights
from .linmpc import _clipinf, _init_stochpred, _validate_custom_lincon
from .transcription import (CollocationMethod, MultipleShooting,
                            OrthogonalCollocation, SingleShooting,
                            TrapezoidalCollocation, init_orthocolloc,
                            init_ZtoDU, init_ZtoU, move_blocking)

# host syncs of the SQP exit test (one per loop iteration); checks reset it
COUNTS = {"sqp_exit_tests": 0}

_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


# --- the user parameter p as a tree of numbers -------------------------------
def _leaves(p):
    if isinstance(p, (tuple, list)):
        return [x for v in p for x in _leaves(v)]
    if isinstance(p, dict):
        return [x for k in sorted(p) for x in _leaves(p[k])]
    return [] if p is None else [p]


def _tree_map(fn, p):
    if isinstance(p, (tuple, list)):
        return type(p)(_tree_map(fn, v) for v in p)
    if isinstance(p, dict):
        return {k: _tree_map(fn, v) for k, v in p.items()}
    return fn(p)


def _structure(p):
    if isinstance(p, (tuple, list)):
        return (type(p).__name__, tuple(_structure(v) for v in p))
    if isinstance(p, dict):
        return ("dict", tuple((k, _structure(p[k])) for k in sorted(p)))
    return np.shape(p)


def _numeric_p(p):
    """p as a tree of float arrays, or None if a leaf is not numeric (then
    p stays a constant of the step)."""
    leaves = _leaves(p)
    if not leaves:
        return None
    try:
        if not all(np.issubdtype(np.asarray(x).dtype, np.number) for x in leaves):
            return None
        return _tree_map(lambda x: np.asarray(x, float), p)
    except (TypeError, ValueError):
        return None


class NonLinMPC(PredictiveController):
    """Nonlinear MPC on any SimModel (nonlinmpc.jl).  The step runs on
    ``device`` (the GPU unless the caller asks for another) in ``dtype``
    (float64 unless ``torch.float32``); construct-time math is host NumPy
    float64.  The default estimator is a SteadyKalmanFilter for a LinModel
    and an UnscentedKalmanFilter (on ``device``) otherwise."""

    def __init__(self, model_or_estim, Hp=None, Hc=2,
                 Mwt=None, Nwt=None, Lwt=None, M_Hp=None, N_Hc=None, L_Hp=None,
                 Cwt=1e5, Ewt=0.0, JE=None, gc=None, nc=0, p=None,
                 Wy=None, Wu=None, Wd=None, Wr=None,
                 transcription=None, sqp_iters=30, sqp_tol=1e-8,
                 kkt_tol=0.0, kkt_feas_tol=1e-4,
                 trust_radius=None, qp_solver="admm",
                 hessian="gauss_newton", dtype=None, device=None, **estim_kwargs):
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.device = resolve_device(device)
        if isinstance(model_or_estim, StateEstimator):
            estim = model_or_estim
            model = estim.model
        else:
            model = model_or_estim
            if isinstance(model, LinModel):
                estim = SteadyKalmanFilter(model, **estim_kwargs)
            else:
                estim = UnscentedKalmanFilter(model, **{"device": self.device,
                                                        **estim_kwargs})
        self.estim = estim
        self.transcription = transcription or SingleShooting()
        Hp = default_Hp(model) if Hp is None else int(Hp)
        nb = move_blocking(Hp, Hc)
        Hc = len(nb)
        self.Hp, self.Hc, self.nb = Hp, Hc, nb
        nu, ny = model.nu, model.ny
        self.weights = ControllerWeights(nu, ny, Hp, Hc, Mwt, Nwt, Lwt,
                                         M_Hp, N_Hc, L_Hp, Cwt, Ewt)
        self.n_eps = self.weights.n_eps
        if JE is not None:
            # the economic cost takes (Ue, Ŷe, D̂e, p, ϵ) (nonlinmpc.jl:824-825)
            import inspect
            try:
                params = inspect.signature(JE).parameters
                var_pos = any(a.kind == a.VAR_POSITIONAL for a in params.values())
                n_args = len(params)
            except (TypeError, ValueError):
                var_pos, n_args = True, 5
            if not var_pos and n_args != 5:
                raise ValueError(f"the JE function should have 5 arguments "
                                 f"(Ue, Ye, De, p, eps), got {n_args}")
        self.JE = JE or (lambda Ue, Ye, De, p_, eps: 0.0)
        if (gc is not None) != (int(nc) > 0):
            raise ValueError(
                "custom constraints need BOTH gc and nc>0: got "
                f"gc={'set' if gc is not None else 'None'}, nc={int(nc)}")
        self.gc = gc
        self.nc = int(nc)
        # custom linear constraints W; the Wy term is linear in Z only for
        # a LinModel (construct.jl:668-669)
        if Wy is not None and not isinstance(model, LinModel):
            raise ValueError("Wy matrix can be specified only with LinModel")
        self.Wy, self.Wu, self.Wd, self.Wr, self.nw = _validate_custom_lincon(
            model, Wy, Wu, Wd, Wr)
        self.p = p if p is not None else model.p
        self.sqp_iters = int(sqp_iters)
        self.sqp_tol = float(sqp_tol)
        # KKT early exit: relative stationarity < kkt_tol AND worst
        # violation < kkt_feas_tol (0 keeps the step-norm-only exit)
        self.kkt_tol = float(kkt_tol)
        self.kkt_feas_tol = float(kkt_feas_tol)
        self.trust_radius = trust_radius
        if qp_solver not in ("admm", "active_set"):
            raise ValueError("qp_solver must be 'admm' or 'active_set'")
        self.qp_solver = qp_solver
        if hessian not in ("gauss_newton", "exact"):
            raise ValueError("hessian must be 'gauss_newton' or 'exact'")
        self.hessian = hessian
        self._lane = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._p_dev = {}
        self._build()
        self.Uop = np.tile(model.uop, Hp)
        self.Yop = np.tile(model.yop, Hp)
        self.Dop = np.tile(model.dop, Hp)
        self.Z_tilde = np.zeros(self.nZt)
        self.lastu0 = np.zeros(nu)
        self._last = {}

    # ------------------------------------------------------------------
    def _build(self, rebuild_step=True):
        model, estim = self.estim.model, self.estim
        Hp, Hc, nb = self.Hp, self.Hc, self.nb
        nu, ny, nd, nx_hat = model.nu, model.ny, model.nd, estim.nx_hat
        tr = self.transcription
        self.is_ms = isinstance(tr, (MultipleShooting, CollocationMethod))
        self.is_colloc = isinstance(tr, CollocationMethod)
        if self.is_colloc and not (isinstance(model, NonLinModel)
                                   and isinstance(model.solver, RungeKutta)):
            raise ValueError("Collocation methods require a continuous-time "
                             "NonLinModel (with a RungeKutta solver).")
        if isinstance(tr, OrthogonalCollocation):
            nZ = tr.nZ_colloc(nu, nx_hat, model.nx, Hp, Hc)
            self.Mo, self.Co, self.lam_o = init_orthocolloc(model.nx, model.Ts, tr)
        else:
            nZ = tr.nZ(nu, nx_hat, Hp, Hc)
        self.nZ = nZ
        self.nZt = nZ + self.n_eps
        # the defect equalities: collocation and multiple-shooting states
        if isinstance(tr, OrthogonalCollocation):
            self.neq = Hp * (tr.no * model.nx + nx_hat)
        else:
            self.neq = nx_hat * Hp if self.is_ms else 0

        class _NZ:   # PΔu/Pu only need the leading [ΔU; X̂0] layout
            def nZ(_, *a):
                return nZ
        PDu = init_ZtoDU(_NZ(), nu, nx_hat, Hp, Hc)
        Pu, Tu = init_ZtoU(_NZ(), nu, nx_hat, Hp, Hc, nb)
        # bounds (deviation form) and softness
        self.U0min, self.U0max = np.full(nu * Hp, -BIG), np.full(nu * Hp, BIG)
        self.DUmin, self.DUmax = np.full(nu * Hc, -BIG), np.full(nu * Hc, BIG)
        self.Y0min, self.Y0max = np.full(ny * Hp, -BIG), np.full(ny * Hp, BIG)
        self.x0min, self.x0max = np.full(nx_hat, -BIG), np.full(nx_hat, BIG)
        self.C_umin, self.C_umax = np.zeros(nu * Hp), np.zeros(nu * Hp)
        self.C_dumin, self.C_dumax = np.zeros(nu * Hc), np.zeros(nu * Hc)
        self.C_ymin, self.C_ymax = np.ones(ny * Hp), np.ones(ny * Hp)
        self.c_xmin, self.c_xmax = np.ones(nx_hat), np.ones(nx_hat)
        # custom linear constraints: W(Z) rows (relaxW, construct.jl:1085-1160)
        nw = self.nw
        nW = nw * (Hp + 1)
        self.nW = nW
        if nw:
            Wy_bar = repeatdiag(self.Wy, Hp + 1)
            Wu_bar = repeatdiag(self.Wu, Hp + 1)
            Wd_bar = repeatdiag(self.Wd, Hp + 1)
            Wr_bar = repeatdiag(self.Wr, Hp + 1)
            # the held terminal input u(k+Hp) = u(k+Hp−1) folds into U
            Wu_fold = Wu_bar[:, :nu * Hp].copy()
            Wu_fold[:, -nu:] += Wu_bar[:, nu * Hp:]
            Wy_now, Wy_pred = Wy_bar[:, :ny], Wy_bar[:, ny:]
        else:
            Wy_now, Wy_pred = np.zeros((0, ny)), np.zeros((0, ny * Hp))
            Wu_fold = np.zeros((0, nu * Hp))
            Wd_bar, Wr_bar = np.zeros((0, (Hp + 1) * nd)), np.zeros((0, (Hp + 1) * ny))
        self.C_wmin, self.C_wmax = np.ones(nW), np.ones(nW)
        self.Wmin_b, self.Wmax_b = np.full(nW, -BIG), np.full(nW, BIG)
        if isinstance(estim, InternalModel):
            # stochastic output predictions Ŷs (construct.jl:1236-1267)
            Ks_l, Ps_l = _init_stochpred(estim, Hp)
        else:
            Ks_l = np.zeros((ny * Hp, getattr(estim, "nxs", 0)))
            Ps_l = np.zeros((ny * Hp, ny))
        # bumped on every params mutation; the device copies follow it
        self._params_version = getattr(self, "_params_version", 0) + 1
        self.params = dict(
            Ks=Ks_l, Ps=Ps_l, Ys_now=np.zeros(ny * Hp),
            Pu=Pu, PDu=PDu, Tu=Tu,
            M_Hp=self.weights.M_Hp, Nt_Hc=self.weights.Nt_Hc, L_Hp=self.weights.L_Hp,
            Uop=np.tile(model.uop, Hp), Yop=np.tile(model.yop, Hp),
            U0min=self.U0min, U0max=self.U0max, DUmin=self.DUmin, DUmax=self.DUmax,
            Y0min=self.Y0min, Y0max=self.Y0max, x0min=self.x0min, x0max=self.x0max,
            C_umin=self.C_umin, C_umax=self.C_umax, C_dumin=self.C_dumin,
            C_dumax=self.C_dumax, C_ymin=self.C_ymin, C_ymax=self.C_ymax,
            c_xmin=self.c_xmin, c_xmax=self.c_xmax,
            Wy_now=Wy_now, Wy_pred=Wy_pred, Wu_fold=Wu_fold,
            Wd_bar=Wd_bar, Wr_bar=Wr_bar,
            Wmin_b=self.Wmin_b, Wmax_b=self.Wmax_b,
            C_wmin=self.C_wmin, C_wmax=self.C_wmax,
            fop_m_xop=estim.fop_hat - estim.xop_hat,
            yop=model.yop, uop=model.uop, dop=model.dop,
        )
        # a numeric user p travels in params (setparam swaps it as data);
        # anything else stays a constant of the step
        p_num = _numeric_p(self.p)
        self._p_traced = p_num is not None
        if self._p_traced:
            self.params["p_user"] = p_num
        if rebuild_step or not getattr(self, "_fns_cache", None):
            # the step bakes in f/h and the shapes; weights and bounds
            # travel in params
            self._fns_cache = {}
        self._solved_once = False

    def _params_on(self, dt, dev=None):
        """The params as tensors on the device (or ``dev``) in ``dt``,
        uploaded again only after a change."""
        dev = as_device(self.device if dev is None else dev)
        ver, cached = self._p_dev.get((dt, dev), (None, None))
        if ver != self._params_version:
            t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dt, device=dev)
            cached = {k: (_tree_map(t, v) if k == "p_user" else t(v))
                      for k, v in self.params.items()}
            self._p_dev[(dt, dev)] = (self._params_version, cached)
        return cached

    def _fns(self, dt, dev=None):
        """``(step, diag, coldstart)`` for data type ``dt`` on the device (or
        ``dev``), made once."""
        key = (dt, as_device(self.device if dev is None else dev))
        if key not in self._fns_cache:
            self._fns_cache[key] = self._make_step(*key)
        return self._fns_cache[key]

    # ------------------------------------------------------------------
    def setconstraint(self, **kw):
        model, estim = self.estim.model, self.estim
        nu, ny, nx_hat = model.nu, model.ny, estim.nx_hat
        Hp, Hc = self.Hp, self.Hc

        def pick(small, cap, n, rep):
            v = kw.get(cap)
            if v is not None:
                v = np.asarray(v, float).ravel()
                if v.shape != (n * rep,):
                    raise ValueError(f"{cap} size must be ({n * rep},)")
                return v
            v = kw.get(small)
            if v is not None:
                v = np.asarray(v, float).ravel()
                if v.shape != (n,):
                    raise ValueError(f"{small} size must be ({n},)")
                return np.tile(v, rep)
            return None

        m = [("umin", "Umin", nu, Hp, "U0min", self.Uop),
             ("umax", "Umax", nu, Hp, "U0max", self.Uop),
             ("dumin", "DUmin", nu, Hc, "DUmin", 0.0),
             ("dumax", "DUmax", nu, Hc, "DUmax", 0.0),
             ("Deltaumin", "DeltaUmin", nu, Hc, "DUmin", 0.0),
             ("Deltaumax", "DeltaUmax", nu, Hc, "DUmax", 0.0),
             ("ymin", "Ymin", ny, Hp, "Y0min", self.Yop),
             ("ymax", "Ymax", ny, Hp, "Y0max", self.Yop)]
        for small, cap, n, rep, attr, op in m:
            v = pick(small, cap, n, rep)
            if v is not None:
                getattr(self, attr)[:] = _clipinf(v - op)
        for kws, attr in (("xhatmin", "x0min"), ("xhatmax", "x0max")):
            v = kw.get(kws)
            if v is not None:
                v = np.asarray(v, float).ravel()
                if v.shape != (nx_hat,):
                    raise ValueError(f"{kws} size must be ({nx_hat},)")
                getattr(self, attr)[:] = _clipinf(v - estim.xop_hat)
        if self.nw:
            for small, cap, attr in (("wmin", "Wmin", "Wmin_b"), ("wmax", "Wmax", "Wmax_b")):
                v = pick(small, cap, self.nw, Hp + 1)
                if v is not None:
                    getattr(self, attr)[:] = _clipinf(v)
        for name in ("U0min", "U0max", "DUmin", "DUmax", "Y0min", "Y0max",
                     "x0min", "x0max", "Wmin_b", "Wmax_b"):
            self.params[name] = getattr(self, name)
        self._params_version += 1
        soft = {k: v for k, v in kw.items() if k.startswith(("c_", "C_"))}
        if soft:
            if self.n_eps != 1:
                raise ValueError("Slack variable weight Cwt must be finite to "
                                 "set softness parameters")
            sm = {"c_umin": ("C_umin", nu, Hp), "c_umax": ("C_umax", nu, Hp),
                  "c_dumin": ("C_dumin", nu, Hc), "c_dumax": ("C_dumax", nu, Hc),
                  "c_ymin": ("C_ymin", ny, Hp), "c_ymax": ("C_ymax", ny, Hp),
                  "c_xhatmin": ("c_xmin", nx_hat, 1), "c_xhatmax": ("c_xmax", nx_hat, 1),
                  "c_wmin": ("C_wmin", self.nw, Hp + 1),
                  "c_wmax": ("C_wmax", self.nw, Hp + 1)}
            for k, v in soft.items():
                key = k if k.startswith("c_") else "c_" + k[2:].lower()
                if key not in sm:
                    raise ValueError(f"unknown softness parameter {k}")
                attr, n, rep = sm[key]
                v = np.asarray(v, float).ravel()
                vv = np.tile(v, rep) if v.shape == (n,) else v
                if vv.shape != (n * rep,):
                    raise ValueError(f"{k} size must be ({n},) or ({n * rep},)")
                getattr(self, attr)[:] = vv
                self.params[attr] = getattr(self, attr)
                self._params_version += 1
        return self

    # ------------------------------------------------------------------
    def _rollout_fn(self, f_hat, h_hat, dt, dev):
        """The rollout of the augmented model for this transcription, on ONE
        sample: ``rollout(p, Z, x0_hat, lastu0, Df, Dh) -> (Ŷ0, x̂end, Ŝ,
        U0)`` with Df, Dh (Hp, nd)."""
        estim, model = self.estim, self.estim.model
        nu, nx_hat, nx = model.nu, estim.nx_hat, model.nx
        Hp, nDU = self.Hp, model.nu * self.Hc
        nX = nx_hat * Hp
        tr = self.transcription
        vh = vmap(h_hat)
        vf = vmap(f_hat)

        def inputs(p, Z, lastu0):
            U0 = p["Pu"] @ Z + p["Tu"] @ lastu0
            return U0, U0.reshape(Hp, nu)

        def outputs_ss(p, Z, x0_hat, lastu0, Df, Dh):
            U0, U0m = inputs(p, Z, lastu0)
            x, Y = x0_hat, []
            for j in range(Hp):
                x = f_hat(x, U0m[j], Df[j]) + p["fop_m_xop"]
                Y.append(h_hat(x, Dh[j]))
            return torch.stack(Y).reshape(-1) + p["Ys_now"], x, Z.new_zeros(0), U0

        def outputs_ms(p, Z, x0_hat, lastu0, Df, Dh):
            U0, U0m = inputs(p, Z, lastu0)
            X = Z[nDU:nDU + nX].reshape(Hp, nx_hat)
            Y = vh(X, Dh)
            # defects ŝ_j = f̂(x̂_{j-1}) + (f̂op − x̂op) − x̂_j, all stages at once
            X_prev = torch.cat([x0_hat[None], X[:-1]])
            S = (vf(X_prev, U0m, Df) + p["fop_m_xop"] - X).reshape(-1)
            return Y.reshape(-1) + p["Ys_now"], X[-1], S, U0

        if not self.is_colloc:
            return outputs_ms if self.is_ms else outputs_ss
        t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dt, device=dev)
        Cs_u, As_s = t(estim.Cs_u), t(estim.As)
        f_cont = lambda x, u, d: model._f_user(x, u, d, model.p)
        vfc = vmap(f_cont)
        Ts, hold = model.Ts, tr.h

        def states(p, Z, x0_hat, lastu0, Dh):
            U0, U0m = inputs(p, Z, lastu0)
            X = Z[nDU:nDU + nX].reshape(Hp, nx_hat)
            X_prev = torch.cat([x0_hat[None], X[:-1]])
            # û_j = u_j + Cs_u·x̂s(j) (estimator/execute.jl:162-173)
            Uh = U0m + X_prev[:, nx:] @ Cs_u.T
            return U0, X, X_prev, Uh, vh(X, Dh)

        if isinstance(tr, TrapezoidalCollocation):
            def outputs_trap(p, Z, x0_hat, lastu0, Df, Dh):
                """Trapezoidal defects (controller/transcription.jl:1392-1437)."""
                U0, X, X_prev, Uh, Y = states(p, Z, x0_hat, lastu0, Dh)
                # u at the END of interval j: u_{j+1} for h=1 (held), u_j for h=0
                Uh_next = torch.cat([Uh[1:], Uh[-1:]]) if hold else Uh
                k1 = vfc(X_prev[:, :nx], Uh, Df)
                k2 = vfc(X[:, :nx], Uh_next, Dh)
                S_det = X_prev[:, :nx] - X[:, :nx] + 0.5 * Ts * (k1 + k2)
                S_sto = X_prev[:, nx:] @ As_s.T - X[:, nx:]
                S = torch.cat([S_det, S_sto], 1).reshape(-1)
                return Y.reshape(-1) + p["Ys_now"], X[-1], S, U0
            return outputs_trap

        no, tau, Mo, Co = tr.no, t(tr.tau), t(self.Mo), t(self.Co)
        lam = float(self.lam_o)

        def stage(xp, xn, kj, u0j, u0nj, d0j, d0nj):
            xd = xp[:nx]
            sk = Mo @ (kj - xd[None, :]).reshape(-1)
            pts = []
            for i in range(no):
                di = (1 - tau[i]) * d0j + tau[i] * d0nj
                ui = u0j if hold < 1 else (1 - tau[i]) * u0j + tau[i] * u0nj
                pts.append(f_cont(kj[i], ui, di))
            sk = sk - torch.stack(pts).reshape(-1)
            sc = Co @ kj.reshape(-1) + lam * xd - xn[:nx]
            ss = As_s @ xp[nx:] - xn[nx:]
            return torch.cat([sk, sc, ss])
        vstage = vmap(stage)

        def outputs_ortho(p, Z, x0_hat, lastu0, Df, Dh):
            """Orthogonal collocation defects (transcription.jl:1486-1541)."""
            U0, X, X_prev, Uh, Y = states(p, Z, x0_hat, lastu0, Dh)
            K = Z[nDU + nX:].reshape(Hp, no, nx)
            Uh_next = torch.cat([Uh[1:], Uh[-1:]])
            S = vstage(X_prev, X, K, Uh, Uh_next, Df, Dh).reshape(-1)
            return Y.reshape(-1) + p["Ys_now"], X[-1], S, U0
        return outputs_ortho

    # ------------------------------------------------------------------
    def _make_step(self, dt, dev):
        """``(step, diag, coldstart)`` in data type ``dt``.  The functions
        named ``*_1`` below act on ONE lane (as the reference's traced step
        does) and run under ``vmap``; the rest is written over the lane
        axis."""
        estim, model = self.estim, self.estim.model
        nu, ny, nd, nx_hat = model.nu, model.ny, model.nd, estim.nx_hat
        Hp, Hc, nZ, nZt = self.Hp, self.Hc, self.nZ, self.nZt
        n_eps, nc, nw, nW = self.n_eps, self.nc, self.nw, self.nW
        nDU, nX, neq = nu * Hc, nx_hat * Hp, self.neq
        nK = nZ - nDU - nX if self.is_ms else 0     # orthogonal collocation's K block
        nv = nZt - neq
        n_in = self._n_dual() - nv
        JE, gc, Ewt = self.JE, self.gc, self.weights.Ewt
        p_const = self.p
        getp = (lambda p: p["p_user"]) if self._p_traced else (lambda p: p_const)
        f_hat, h_hat = estim.tensor_fns(dt, dev)
        rollout = self._rollout_fn(f_hat, h_hat, dt, dev)
        sqp_iters, sqp_tol = self.sqp_iters, self.sqp_tol
        kkt_tol, kkt_feas_tol = self.kkt_tol, self.kkt_feas_tol
        # the structured nullspace applies to plain MultipleShooting only:
        # collocation defect rows have ∂S/∂x̂_j ≠ −I
        use_struct = type(self.transcription) is MultipleShooting
        is_ms, use_as = self.is_ms, self.qp_solver == "active_set"
        use_exact_h = self.hessian == "exact"
        tr0 = float(self.trust_radius) if self.trust_radius else 16.0
        alphas = torch.tensor(_ALPHAS, dtype=dt, device=dev)
        eye = lambda n: torch.eye(n, dtype=dt, device=dev)
        zeros = lambda *s: torch.zeros(s, dtype=dt, device=dev)
        I_nZt, I_nv = eye(nZt), eye(nv)
        # block-diagonal and sub-diagonal masks of the (Hp × Hp) stage grid
        diag5 = torch.eye(Hp, dtype=torch.bool, device=dev)[None, :, None, :, None]
        sub5 = torch.ones(Hp - 1, device=dev).diag(-1).bool()[None, :, None, :, None]
        Jx_1 = zeros(nx_hat, nZt)
        if use_struct:
            Jx_1[:, nDU + (Hp - 1) * nx_hat:nDU + Hp * nx_hat] = eye(nx_hat)
        e_row = zeros(1, nZt)
        e_row[0, -1] = 1.0
        big = 2e18

        def disturbances(p, d0, D_hat_0):
            """d, D̂ and the disturbance sequences of f (k..k+Hp−1) and h
            (k+1..k+Hp), over lanes."""
            d = d0 + p["dop"]
            if not nd:
                Df = d0.new_zeros(d0.shape[0], Hp, 0)
                return d, D_hat_0, Df, Df
            Dall = torch.cat([d0, D_hat_0], 1).reshape(-1, Hp + 1, nd)
            return d, D_hat_0 + p["dop"].repeat(Hp), Dall[:, :-1], Dall[:, 1:]

        def split(Zt):
            return Zt[:nZ], (Zt[-1] if n_eps else Zt.new_zeros(()))

        def extended(p, U0, Y0, d, D_hat, yk):
            Ue = torch.cat([U0 + p["Uop"], U0[-nu:] + p["Uop"][-nu:]])
            Ye = torch.cat([yk, Y0 + p["Yop"]])
            De = torch.cat([d, D_hat]) if nd else U0.new_zeros(0)
            return Ue, Ye, De

        def cost_1(p, Zt, Y0, U0, R_y, R_u, d, D_hat, yk):
            Z, eps = split(Zt)
            DUt = torch.cat([Z[:nDU], Zt[nZ:]])            # [ΔU; ϵ]
            ey = Y0 + p["Yop"] - R_y
            eu = U0 + p["Uop"] - R_u
            J = ey @ p["M_Hp"] @ ey + DUt @ p["Nt_Hc"] @ DUt + eu @ p["L_Hp"] @ eu
            if Ewt != 0.0:
                Ue, Ye, De = extended(p, U0, Y0, d, D_hat, yk)
                J = J + Ewt * JE(Ue, Ye, De, getp(p), eps)
            return J

        # the lane arguments of every per-lane function, in this order
        def objective_1(p, Zt, x0, lu, Df, Dh, R_y, R_u, d, D_hat, yk, ry):
            Y0, _, _, U0 = rollout(p, split(Zt)[0], x0, lu, Df, Dh)
            return cost_1(p, Zt, Y0, U0, R_y, R_u, d, D_hat, yk)

        def je_1(p, Zt, x0, lu, Df, Dh, R_y, R_u, d, D_hat, yk, ry):
            Z, eps = split(Zt)
            Y0, _, _, U0 = rollout(p, Z, x0, lu, Df, Dh)
            Ue, Ye, De = extended(p, U0, Y0, d, D_hat, yk)
            return Ewt * JE(Ue, Ye, De, getp(p), eps)

        def W_of(p, U0, Y0, yk, d, D_hat, ry, R_y):
            """Custom linear constraint values, over lanes (absolute units;
            w(k+Hp) reuses the held input through Wu_fold)."""
            De_t, Re_t = torch.cat([d, D_hat], -1), torch.cat([ry, R_y], -1)
            return (yk @ p["Wy_now"].T + (Y0 + p["Yop"]) @ p["Wy_pred"].T
                    + (U0 + p["Uop"]) @ p["Wu_fold"].T + De_t @ p["Wd_bar"].T
                    + Re_t @ p["Wr_bar"].T)

        relu = lambda v: torch.clamp(v, min=0.0)

        def viol_terms_1(p, Zt, Y0, xend, S, U0, d, D_hat, yk, ry, R_y):
            """Per-row constraint violations (≥ 0) of one lane."""
            Z, eps = split(Zt)
            DU = Z[:nDU]
            parts = [relu(p["U0min"] - p["C_umin"] * eps - U0)
                     + relu(U0 - p["U0max"] - p["C_umax"] * eps),
                     relu(p["DUmin"] - p["C_dumin"] * eps - DU)
                     + relu(DU - p["DUmax"] - p["C_dumax"] * eps),
                     relu(p["Y0min"] - p["C_ymin"] * eps - Y0)
                     + relu(Y0 - p["Y0max"] - p["C_ymax"] * eps),
                     relu(p["x0min"] - p["c_xmin"] * eps - xend)
                     + relu(xend - p["x0max"] - p["c_xmax"] * eps)]
            if nw:
                Wv = W_of(p, U0, Y0, yk, d, D_hat, ry, R_y)
                parts.append(relu(p["Wmin_b"] - p["C_wmin"] * eps - Wv)
                             + relu(Wv - p["Wmax_b"] - p["C_wmax"] * eps))
            parts.append(S.abs())
            if nc:
                Ue, Ye, De = extended(p, U0, Y0, d, D_hat, yk)
                parts.append(relu(gc(Ue, Ye, De, getp(p), eps)))
            if n_eps:
                parts.append(relu(-eps)[None])
            return torch.cat(parts)

        def merit_1(p, Zt, mu, x0, lu, Df, Dh, R_y, R_u, d, D_hat, yk, ry):
            """The ℓ1 exact-penalty merit J + μ·Σviol (one rollout)."""
            Y0, xend, S, U0 = rollout(p, split(Zt)[0], x0, lu, Df, Dh)
            return (cost_1(p, Zt, Y0, U0, R_y, R_u, d, D_hat, yk)
                    + mu * viol_terms_1(p, Zt, Y0, xend, S, U0, d, D_hat, yk, ry,
                                        R_y).sum())

        def final_1(p, Zt, x0, lu, Df, Dh, R_y, R_u, d, D_hat, yk, ry):
            Y0, xend, S, U0 = rollout(p, split(Zt)[0], x0, lu, Df, Dh)
            return (cost_1(p, Zt, Y0, U0, R_y, R_u, d, D_hat, yk),
                    viol_terms_1(p, Zt, Y0, xend, S, U0, d, D_hat, yk, ry, R_y).max(),
                    Y0, xend, U0)

        def S_1(p, Zt, x0, lu, Df, Dh):
            return rollout(p, split(Zt)[0], x0, lu, Df, Dh)[2]

        def yx_1(p, Zt, x0, lu, Df, Dh):
            Y0, xend, S, _ = rollout(p, split(Zt)[0], x0, lu, Df, Dh)
            return (Y0, xend, S), (Y0, xend, S)

        def stage_jacs_1(p, Zt, x0, lu, Df, Dh):
            """Plain MultipleShooting: Ŷ, x̂end and Ŝ depend on Z only
            through the stage maps Ŝ_j = f̂(x̂_{j-1}, u_j) + c − x̂_j and
            Ŷ_j = ĥ(x̂_j), so per-stage Jacobians (nx̂ + ny cotangents a
            stage) give every block of theirs."""
            Z = split(Zt)[0]
            X = Z[nDU:nDU + nX].reshape(Hp, nx_hat)
            X_prev = torch.cat([x0[None], X[:-1]])
            U0m = (p["Pu"] @ Z + p["Tu"] @ lu).reshape(Hp, nu)
            fx, fu = vmap(jacrev(f_hat, argnums=(0, 1)))(X_prev, U0m, Df)
            return fx, fu, vmap(jacrev(h_hat))(X, Dh)

        def gc_1(p, Zt, x0, lu, Df, Dh, d, D_hat, yk):
            Z, eps = split(Zt)
            Y0, _, _, U0 = rollout(p, Z, x0, lu, Df, Dh)
            Ue, Ye, De = extended(p, U0, Y0, d, D_hat, yk)
            g_ = gc(Ue, Ye, De, getp(p), eps)
            return g_, g_

        def lag_nl_1(p, Zt, w_yrow, w_xrow, lam_c, y_gc, x0, lu, Df, Dh, R_y, R_u,
                     d, D_hat, yk, ry):
            """The nonlinear rows' part of the Lagrangian (Ŷ, W, terminal, gc
            and the defects; the U/ΔU/ϵ/trust rows are linear in Z̃)."""
            Z, eps = split(Zt)
            Y0, xend, S, U0 = rollout(p, Z, x0, lu, Df, Dh)
            t = w_yrow @ Y0 + w_xrow @ xend
            if neq:
                t = t + lam_c @ S
            if nc:
                Ue, Ye, De = extended(p, U0, Y0, d, D_hat, yk)
                t = t + y_gc @ gc(Ue, Ye, De, getp(p), eps)
            return t

        def lanes(fn, n_shared=1):
            """``fn`` over the lane axis: its first ``n_shared`` arguments
            (the params) are shared, the rest have the lane axis."""
            def run(*a):
                return vmap(fn, in_dims=(None,) * n_shared + (0,) * (len(a) - n_shared))(*a)
            return run

        v_je_grad = lanes(grad(je_1, argnums=1))
        v_merits = lanes(lambda p, Zc, mu, *la: vmap(
            merit_1, in_dims=(None, 0, None) + (None,) * len(la))(p, Zc, mu, *la))
        v_final, v_S = lanes(final_1), lanes(S_1)
        v_values = lanes(lambda *a: yx_1(*a)[0])
        # reverse mode for every derivative: torch runs the forward-mode
        # rules of products with Python scalars as Python decompositions
        # (several times the cost of the backward ops), and their tangents
        # of 0-dim float32 values can come out in float64 (x[0] * 1.0)
        v_yx = lanes(jacrev(yx_1, argnums=1, has_aux=True))
        v_stage_jacs = lanes(stage_jacs_1)
        v_gc = lanes(jacrev(gc_1, argnums=1, has_aux=True))
        hessian = lambda fn: jacrev(jacrev(fn, argnums=1), argnums=1)
        v_hess_obj = lanes(hessian(objective_1))
        v_hess_lag = lanes(hessian(lag_nl_1))
        v_hess_je = lanes(hessian(je_1))

        def psd(Hm):
            """PSD part by eigh: the indefiniteness guard of the QP."""
            w_e, V_e = torch.linalg.eigh(0.5 * (Hm + Hm.mT))
            return (V_e * torch.clamp(w_e, min=0.0)[:, None, :]) @ V_e.mT

        ninf = lambda v: v.abs().amax(-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])
        mx = lambda v: relu(v).amax(-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])
        add_last = lambda J, c: torch.cat([J[..., :-1], J[..., -1:] + c[:, None]], -1)

        def blockdiag(blocks):
            """(B, Hp, r, c) blocks → the (B, Hp·r, Hp·c) block diagonal."""
            B_, _, r, c = blocks.shape
            return torch.where(diag5, blocks[:, :, :, None, :], 0.0).reshape(B_, Hp * r, Hp * c)

        def qp(P, q, A, l, u, y0, active, lane):
            # a lane whose SQP loop has stopped gets no QP iteration: its
            # result is not used
            if use_as:
                return solve_qp_active(P, q, A, l, u, y0=y0, lane_ctrl=lane,
                                       iter_budget=torch.where(active, 2 ** 30, 0))
            return solve_qp(P, q, A, l, u, y0=y0, max_iter=500,
                            iter_budget=torch.where(active, 2 ** 30, 0))

        def step(p, x0_hat, lastu0, d0, D_hat_0, R_y, R_u, yk, ry, Z_prev, y_prev, lane):
            """One period over B lanes (every argument but ``p`` has the lane
            axis; ``lane`` is the (B,) lane map 0..B−1 the caller keeps)."""
            B = x0_hat.shape[0]
            d, D_hat, Df, Dh = disturbances(p, d0, D_hat_0)
            LA = (x0_hat, lastu0, Df, Dh, R_y, R_u, d, D_hat, yk, ry)
            # warm start: the previous solution shifted one stage
            Zs = torch.zeros_like(Z_prev)
            Zs[:, :nDU - nu] = Z_prev[:, nu:nDU]
            if is_ms:
                Zs[:, nDU:nDU + nX - nx_hat] = Z_prev[:, nDU + nx_hat:nDU + nX]
                Zs[:, nDU + nX - nx_hat:nDU + nX] = Z_prev[:, nDU + nX - nx_hat:nDU + nX]
                if nK:   # the collocation-point block (transcription.jl:1056-1058)
                    nk_st, o = nK // Hp, nDU + nX
                    Zs[:, o:o + nK - nk_st] = Z_prev[:, o + nk_st:o + nK]
                    Zs[:, o + nK - nk_st:o + nK] = Z_prev[:, o + nK - nk_st:o + nK]
            if n_eps:
                Zs[:, -1] = Z_prev[:, -1]
            Tu_lastu0 = lastu0 @ p["Tu"].T
            Pu_t = torch.cat([p["Pu"], zeros(nu * Hp, n_eps)], 1)
            PDu_t = zeros(nDU + n_eps, nZt)
            PDu_t[:nDU, :nDU] = eye(nDU)
            if n_eps:
                PDu_t[-1, -1] = 1.0
            H_du = PDu_t.T @ p["Nt_Hc"] @ PDu_t
            H_u = Pu_t.T @ p["L_Hp"] @ Pu_t
            M_s, N_s, L_s = (p[k] + p[k].T for k in ("M_Hp", "Nt_Hc", "L_Hp"))
            ceps = lambda C: C[:, None] if n_eps else C.new_zeros(C.shape[0], 0)
            PDuZ = torch.eye(nDU, nZ, dtype=dt, device=dev)
            A_lin = torch.cat([-torch.cat([p["Pu"], ceps(p["C_umin"])], 1),
                               torch.cat([p["Pu"], -ceps(p["C_umax"])], 1),
                               -torch.cat([PDuZ, ceps(p["C_dumin"])], 1),
                               torch.cat([PDuZ, -ceps(p["C_dumax"])], 1)]).expand(B, -1, -1)

            def body(Zt, y_d, mu, tr, lam_c, active):
                Z = Zt[:, :nZ]
                eps = Zt[:, -1:] if n_eps else Zt.new_zeros(B, 1)
                # --- values and Jacobians of the nonlinear pieces
                if use_struct:
                    Y0, xend, S = v_values(p, Zt, *LA[:4])
                    fx, fu, hx = (J.to(dt) for J in v_stage_jacs(p, Zt, *LA[:4]))
                    Jy = torch.cat([zeros(B, ny * Hp, nDU), blockdiag(hx),
                                    zeros(B, ny * Hp, nZt - nDU - nX)], -1)
                    JsX = torch.where(diag5, -eye(nx_hat)[None, None, :, None, :],
                                      torch.where(sub5, fx[:, :, :, None, :], 0.0))
                    # ΔU columns: ∂S_j/∂ΔU = fu_j ∂u_j/∂ΔU (Pu rows)
                    Pu_du = p["Pu"][:, :nDU].reshape(Hp, nu, nDU)
                    Js_du = torch.einsum("bjxu,jud->bjxd", fu, Pu_du).reshape(B, neq, nDU)
                    Js = torch.cat([Js_du, JsX.reshape(B, neq, nX),
                                    zeros(B, neq, nZt - nDU - nX)], -1)
                    Jx = Jx_1.expand(B, -1, -1)
                else:
                    (Jy, Jx, Js), (Y0, xend, S) = v_yx(p, Zt, *LA[:4])
                    Jy, Jx, Js = Jy.to(dt), Jx.to(dt), Js.to(dt)
                if nc:
                    Jgc, gcv = v_gc(p, Zt, *LA[:4], d, D_hat, yk)
                    Jgc = Jgc.to(dt)
                # --- worst single-row violation at the iterate (the KKT test)
                U0 = Z @ p["Pu"].T + Tu_lastu0
                DU = Z[:, :nDU]
                # the objective's gradient by the chain rule through the
                # Jacobian already at hand: Jyᵀ(M + Mᵀ)ey + P̃Δuᵀ(Ñ + Ñᵀ)ΔŨ
                # + P̃uᵀ(L + Lᵀ)eu, and the economic term's own gradient
                g = (mtv(Jy, (Y0 + p["Yop"] - R_y) @ M_s)
                     + (torch.cat([DU, Zt[:, nZ:]], 1) @ N_s) @ PDu_t
                     + ((U0 + p["Uop"] - R_u) @ L_s) @ Pu_t)
                if Ewt != 0.0:
                    g = g + v_je_grad(p, Zt, *LA)
                vparts = [mx(p["U0min"] - p["C_umin"] * eps - U0),
                          mx(U0 - p["U0max"] - p["C_umax"] * eps),
                          mx(p["DUmin"] - p["C_dumin"] * eps - DU),
                          mx(DU - p["DUmax"] - p["C_dumax"] * eps),
                          mx(p["Y0min"] - p["C_ymin"] * eps - Y0),
                          mx(Y0 - p["Y0max"] - p["C_ymax"] * eps),
                          mx(p["x0min"] - p["c_xmin"] * eps - xend),
                          mx(xend - p["x0max"] - p["c_xmax"] * eps)]
                if neq:
                    vparts.append(ninf(S))
                if nw:
                    W0 = W_of(p, U0, Y0, yk, d, D_hat, ry, R_y)
                    vparts.append(mx(p["Wmin_b"] - p["C_wmin"] * eps - W0))
                    vparts.append(mx(W0 - p["Wmax_b"] - p["C_wmax"] * eps))
                if nc:
                    vparts.append(mx(gcv))
                if n_eps:
                    vparts.append(relu(-eps[:, 0]))
                viol_now = torch.stack(vparts, -1).amax(-1)
                # --- Hessian
                if use_exact_h:
                    # ∇²J + Σᵢ yᵢ∇²cᵢ with the previous iteration's
                    # multipliers, projected to its PSD part
                    m_u, m_y = nu * Hp, ny * Hp
                    o = 2 * m_u + 2 * nDU
                    w_yrow = y_d[:, o + m_y:o + 2 * m_y] - y_d[:, o:o + m_y]
                    o += 2 * m_y
                    if nw:
                        w_yrow = w_yrow + (y_d[:, o + nW:o + 2 * nW]
                                           - y_d[:, o:o + nW]) @ p["Wy_pred"]
                        o += 2 * nW
                    w_xrow = y_d[:, o + nx_hat:o + 2 * nx_hat] - y_d[:, o:o + nx_hat]
                    o += 2 * nx_hat
                    y_gc = y_d[:, o:o + nc]
                    H = psd(v_hess_obj(p, Zt, *LA).to(dt)
                            + v_hess_lag(p, Zt, w_yrow, w_xrow, lam_c, y_gc, *LA).to(dt))
                else:
                    # Gauss–Newton Hessian of the tracking terms
                    H = 2.0 * (Jy.mT @ p["M_Hp"] @ Jy + H_du + H_u)
                    if Ewt != 0.0:
                        # exact Hessian of the economic term, its PSD part
                        H = H + psd(v_hess_je(p, Zt, *LA).to(dt))
                H = H + 1e-8 * I_nZt
                # --- linearized rows: ½dᵀHd + gᵀd s.t. l ≤ A d ≤ u
                rows = [A_lin]
                up = [-(p["U0min"] - p["C_umin"] * eps - U0),
                      p["U0max"] + p["C_umax"] * eps - U0,
                      -(p["DUmin"] - p["C_dumin"] * eps - DU),
                      p["DUmax"] + p["C_dumax"] * eps - DU]
                Jy_min = add_last(Jy, p["C_ymin"]) if n_eps else Jy
                Jy_max = add_last(Jy, -p["C_ymax"]) if n_eps else Jy
                rows += [-Jy_min, Jy_max]
                up += [-(p["Y0min"] - p["C_ymin"] * eps - Y0),
                       p["Y0max"] + p["C_ymax"] * eps - Y0]
                if nw:
                    Jw = p["Wy_pred"] @ Jy + p["Wu_fold"] @ Pu_t
                    Jw_min = add_last(Jw, p["C_wmin"]) if n_eps else Jw
                    Jw_max = add_last(Jw, -p["C_wmax"]) if n_eps else Jw
                    rows += [-Jw_min, Jw_max]
                    up += [-(p["Wmin_b"] - p["C_wmin"] * eps - W0),
                           p["Wmax_b"] + p["C_wmax"] * eps - W0]
                Jx_min = add_last(Jx, p["c_xmin"]) if n_eps else Jx
                Jx_max = add_last(Jx, -p["c_xmax"]) if n_eps else Jx
                rows += [-Jx_min, Jx_max]
                up += [-(p["x0min"] - p["c_xmin"] * eps - xend),
                       p["x0max"] + p["c_xmax"] * eps - xend]
                if nc:
                    rows.append(Jgc)
                    up.append(-gcv)
                lo = [torch.full((B, n_in - n_eps), -big, dtype=dt, device=dev)]
                if n_eps:   # ϵ ≥ 0 step bound
                    rows.append(e_row.expand(B, -1, -1))
                    up.append(torch.full((B, 1), big, dtype=dt, device=dev))
                    lo.append(-eps)
                A = torch.cat(rows, 1)
                l, u_b = torch.cat(lo, 1), torch.cat(up, 1)
                # relative stationarity with the carried multipliers (the
                # trust rows' duals are left out)
                grad_L = g + mtv(A, y_d[:, :n_in])
                if neq:
                    grad_L = grad_L + mtv(Js, lam_c)
                stat_now = ninf(grad_L) / (1.0 + ninf(g))
                if neq:
                    # the linearized defects Js·dz = −S hold exactly through
                    # dz = dp + Nn·v; the QP is left with the inequalities
                    if use_struct:
                        # Jx̂ is block-bidiagonal with −I on the diagonal:
                        # forward substitution, and a null basis by
                        # sensitivity propagation made orthonormal
                        Ablk = fx[:, 1:]                          # (B, Hp−1, nx̂, nx̂)
                        Jdu_c = torch.cat([Js[..., :nDU], Js[..., nDU + neq:]], -1)

                        def jx_solve(Bm):
                            """Jx̂·T = B (row j: A_j t_{j−1} − t_j = b_j)."""
                            Bs = Bm.reshape(B, Hp, nx_hat, -1)
                            t = -Bs[:, 0]
                            ts = [t]
                            for j in range(1, Hp):
                                t = Ablk[:, j - 1] @ t - Bs[:, j]
                                ts.append(t)
                            return torch.stack(ts, 1).reshape(B, neq, -1)

                        N_raw = zeros(B, nZt, nv)
                        N_raw[:, :nDU, :nDU] = eye(nDU)
                        N_raw[:, nDU:nDU + neq] = jx_solve(-Jdu_c)
                        if n_eps:
                            N_raw[:, -1, -1] = 1.0
                        # modified Gram–Schmidt, two passes; the identity
                        # block keeps every column's norm ≥ 1
                        cols = []
                        for ci in range(nv):
                            v_c = N_raw[:, :, ci]
                            for _ in range(2):
                                for q_c in cols:
                                    v_c = v_c - (q_c * v_c).sum(-1, keepdim=True) * q_c
                            cols.append(v_c / torch.linalg.vector_norm(v_c, dim=-1,
                                                                       keepdim=True))
                        Nn = torch.stack(cols, -1)                 # thin (B, nZt, nv)

                        def eq_min_norm(rhs):
                            """Minimal-norm x with Js·x = rhs."""
                            x_any = zeros(B, nZt)
                            x_any[:, nDU:nDU + neq] = jx_solve(rhs[..., None])[..., 0]
                            return x_any - mv(Nn, mtv(Nn, x_any))

                        def eq_mult(resid_):
                            """λ with Jsᵀλ = −resid (X̂ rows), backward:
                            λ_j = r_j + A_{j+1}ᵀ λ_{j+1}."""
                            rs = resid_[:, nDU:nDU + neq].reshape(B, Hp, nx_hat)
                            lj = rs[:, Hp - 1]
                            ls = [lj]
                            for j in range(Hp - 2, -1, -1):
                                lj = rs[:, j] + mtv(Ablk[:, j], lj)
                                ls.append(lj)
                            return torch.stack(ls[::-1], 1).reshape(B, neq)
                    else:
                        # (the Householder signs of cuSOLVER and LAPACK may
                        # differ, and the trust box is not rotation-invariant)
                        Qf, Rf = torch.linalg.qr(Js.mT, mode="complete")
                        Q1, Nn = Qf[..., :neq], Qf[..., neq:]
                        Rsq = Rf[..., :neq, :]

                        def eq_min_norm(rhs):
                            return mv(Q1, torch.linalg.solve_triangular(
                                Rsq.mT, rhs[..., None], upper=False)[..., 0])

                        def eq_mult(resid_):
                            return torch.linalg.solve_triangular(
                                Rsq, -mtv(Q1, resid_)[..., None], upper=True)[..., 0]

                    dp = eq_min_norm(-S)
                    Hr = Nn.mT @ H @ Nn
                    gr = mtv(Nn, g + mv(H, dp))
                    # trust box on the tangential step ‖v‖∞ ≤ Δ
                    A_r = torch.cat([A @ Nn, I_nv.expand(B, -1, -1)], 1)
                    l_r = torch.cat([l - mv(A, dp), -tr[:, None].expand(B, nv)], 1)
                    u_r = torch.cat([u_b - mv(A, dp), tr[:, None].expand(B, nv)], 1)
                    sol = qp(Hr, gr, A_r, l_r, u_r, y_d, active, lane)
                    dz = dp + mv(Nn, sol.x)
                    # equality multipliers from stationarity (the μ rule)
                    resid = (mv(H, dz) + g + mtv(A, sol.y[:, :n_in])
                             + mv(Nn, sol.y[:, n_in:]))
                    lam_new = eq_mult(resid)
                    dual_inf = torch.maximum(ninf(sol.y[:, :n_in]), ninf(lam_new))
                    # second-order correction: minimal-norm restoration of
                    # the defects at the trial point (N&W §15.6)
                    c_soc = eq_min_norm(-v_S(p, Zt + dz, *LA[:4]))
                else:
                    A_r = torch.cat([A, I_nZt.expand(B, -1, -1)], 1)
                    l_r = torch.cat([l, -tr[:, None].expand(B, nZt)], 1)
                    u_r = torch.cat([u_b, tr[:, None].expand(B, nZt)], 1)
                    sol = qp(H, g, A_r, l_r, u_r, y_d, active, lane)
                    dz = sol.x
                    lam_new = lam_c
                    dual_inf = ninf(sol.y[:, :n_in])
                    c_soc = torch.zeros_like(dz)
                # ℓ1 penalty: μ dominates the multipliers (N&W Thm 17.3),
                # with a bounded decrease
                mu = torch.minimum(torch.maximum(mu, 2.0 * dual_inf), 20.0 * dual_inf + 1e3)
                # the six steps and the iterate itself in one evaluation, so
                # that a step of round-off size compares like with like
                cand = torch.cat([Zt[:, None] + alphas[None, :, None] * dz[:, None]
                                  + (alphas * alphas)[None, :, None] * c_soc[:, None],
                                  Zt[:, None]], 1)
                merits = v_merits(p, cand, mu, *LA)
                m_now, merits = merits[:, -1], merits[:, :-1]
                merits = torch.where(torch.isnan(merits), torch.inf, merits)
                best = torch.argmin(merits, 1)
                improve = merits.gather(1, best[:, None])[:, 0] <= m_now
                a = torch.where(improve, alphas[best], 0.0)
                dz_soc = a[:, None] * dz + (a * a)[:, None] * c_soc
                sn = ninf(dz_soc)
                # trust radius from the accepted step fraction
                tr = torch.where(a >= 0.99, torch.clamp(tr * 2.0, max=1e5),
                                 torch.where(a == 0.0, tr * 0.25,
                                             torch.where(a <= 0.11, tr * 0.5, tr)))
                tr = torch.clamp(tr, min=1e-3)
                return Zt + dz_soc, sol.y, sn, mu, tr, a, lam_new, stat_now, viol_now

            def sqp_cond(it, sn, tr, a, stat, viol):
                retry = (a == 0.0) & (tr > 1.1e-3)   # rejected, can still shrink
                kkt_ok = (kkt_tol > 0.0) & (stat < kkt_tol) & (viol < kkt_feas_tol)
                return (it < sqp_iters) & ((it < 2) | ((sn > sqp_tol) & ~kkt_ok) | retry)

            full = lambda v: torch.full((B,), v, dtype=dt, device=dev)
            Zt, y_d, it = Zs, y_prev, torch.zeros(B, dtype=torch.int32, device=dev)
            sn, mu, tr, a = full(torch.inf), full(1e4), full(tr0), full(1.0)
            lam_c, stat, viol = zeros(B, max(neq, 0)), full(torch.inf), full(torch.inf)
            while True:
                active = sqp_cond(it, sn, tr, a, stat, viol)
                COUNTS["sqp_exit_tests"] += 1
                if not bool(active.any()):
                    break
                new = body(Zt, y_d, mu, tr, lam_c, active)
                keep = lambda n_, o_: torch.where(active.view(-1, *[1] * (n_.dim() - 1)), n_, o_)
                Zt, y_d, sn, mu, tr, a, lam_c, stat, viol = (
                    keep(n_, o_) for n_, o_ in zip(new, (Zt, y_d, sn, mu, tr, a, lam_c,
                                                         stat, viol)))
                it = it + active.to(it.dtype)
            J_f, viol_f, Y0f, xendf, U0f = v_final(p, Zt, *LA)
            # the receding input, clamped to the (soft-relaxed) input box
            eps_f = Zt[:, -1:] if n_eps else Zt.new_zeros(B, 1)
            u0 = torch.clamp(Zt[:, :nu] + lastu0,
                             p["U0min"][:nu] - p["C_umin"][:nu] * eps_f,
                             p["U0max"][:nu] + p["C_umax"][:nu] * eps_f)
            # stat: the stationarity of the last exit test (it describes the
            # iterate before the returned one, as the reference's)
            return (u0 + p["uop"], Zt, Zs, y_d, J_f, viol_f, stat, it, Y0f, xendf, U0f)

        def diag(p, x0_hat, lastu0, d0, D_hat_0, R_y, R_u, yk, ry, Zt):
            """Derivative and constraint dumps at one lane's optimum for
            getinfo (nonlinmpc.jl:565-660): J, ∇J, the nonlinear inequality
            values g (Ŷ, terminal, custom) and the defects."""
            d, D_hat, Df, Dh = (a[0] for a in disturbances(p, d0[None], D_hat_0[None]))
            la = (x0_hat, lastu0, Df, Dh, R_y, R_u, d, D_hat, yk, ry)
            gJ = grad(objective_1, argnums=1)(p, Zt, *la)
            Z, eps = split(Zt)
            Y0, xend, S, U0 = rollout(p, Z, x0_hat, lastu0, Df, Dh)
            g_rows = [p["Y0min"] - p["C_ymin"] * eps - Y0, Y0 - p["Y0max"] - p["C_ymax"] * eps,
                      p["x0min"] - p["c_xmin"] * eps - xend,
                      xend - p["x0max"] - p["c_xmax"] * eps]
            if nc:
                Ue, Ye, De = extended(p, U0, Y0, d, D_hat, yk)
                g_rows.append(gc(Ue, Ye, De, getp(p), eps))
            return objective_1(p, Zt, *la), gJ, torch.cat(g_rows), S

        def coldstart(p, x0_hat, lastu0, d0, D_hat_0):
            """Feasibility cold start of the MultipleShooting/collocation
            states: the held-input rollout from x̂0 in the X̂ block and, for
            orthogonal collocation, the linear interpolation of the
            deterministic state in the K block — in PRE-SHIFTED form (the
            step shifts it one stage)."""
            B = x0_hat.shape[0]
            Df = disturbances(p, d0, D_hat_0)[2]
            U0m = (lastu0 @ p["Tu"].T).reshape(B, Hp, nu)
            vf = vmap(f_hat)
            x, X = x0_hat, []
            for j in range(Hp):
                x = vf(x, U0m[:, j], Df[:, j]) + p["fop_m_xop"]
                X.append(x)
            X = torch.stack(X, 1)
            Zp = zeros(B, nZt)
            Zp[:, nDU + nx_hat:nDU + nX] = X[:, :-1].reshape(B, -1)
            if nK:
                no, nxd = self.transcription.no, model.nx
                tau = torch.as_tensor(self.transcription.tau, dtype=dt, device=dev)
                X_prev = torch.cat([x0_hat[:, None], X[:, :-1]], 1)
                Kd = (X_prev[:, :, None, :nxd] * (1 - tau)[None, None, :, None]
                      + X[:, :, None, :nxd] * tau[None, None, :, None])
                o, nk_st = nDU + nX, no * nxd
                Zp[:, o + nk_st:o + Hp * nk_st] = Kd[:, :-1].reshape(B, -1)
            return Zp

        return step, diag, coldstart

    # ------------------------------------------------------------------
    def setmodel(self, model=None, Mwt=None, Nwt=None, Lwt=None, Qhat=None, Rhat=None):
        """Swap a LinModel-backed controller's plant or weights at run time
        (setmodel!, controller/execute.jl:621-699).  The bounds are kept
        (re-expressed at the new operating point); ``lastu0`` is rebased."""
        model_old = self.estim.model
        bound_keys = ("U0min", "U0max", "DUmin", "DUmax", "Y0min", "Y0max",
                      "x0min", "x0max", "C_umin", "C_umax", "C_dumin",
                      "C_dumax", "C_ymin", "C_ymax", "c_xmin", "c_xmax",
                      "Wmin_b", "Wmax_b", "C_wmin", "C_wmax")
        saved = {k: getattr(self, k).copy() for k in bound_keys}
        if model is not None:
            Umin, Umax = saved["U0min"] + self.Uop, saved["U0max"] + self.Uop
            Ymin, Ymax = saved["Y0min"] + self.Yop, saved["Y0max"] + self.Yop
            xmin = saved["x0min"] + self.estim.xop_hat
            xmax = saved["x0max"] + self.estim.xop_hat
            lastu_abs = self.lastu0 + model_old.uop
            self.estim.setmodel(model, Qhat=Qhat, Rhat=Rhat)
            self.Uop = np.tile(model.uop, self.Hp)
            self.Yop = np.tile(model.yop, self.Hp)
            self.Dop = np.tile(model.dop, self.Hp)
            saved["U0min"], saved["U0max"] = _clipinf(Umin - self.Uop), _clipinf(Umax - self.Uop)
            saved["Y0min"], saved["Y0max"] = _clipinf(Ymin - self.Yop), _clipinf(Ymax - self.Yop)
            saved["x0min"] = _clipinf(xmin - self.estim.xop_hat)
            saved["x0max"] = _clipinf(xmax - self.estim.xop_hat)
            self.lastu0 = lastu_abs - model.uop
        elif Qhat is not None or Rhat is not None:
            self.estim.setmodel(Qhat=Qhat, Rhat=Rhat)
        if Mwt is not None or Nwt is not None or Lwt is not None:
            # unchanged weights keep their full matrices
            w, m_ = self.weights, self.estim.model
            self.weights = ControllerWeights(
                m_.nu, m_.ny, self.Hp, self.Hc, Mwt, Nwt, Lwt,
                M_Hp=None if Mwt is not None else w.M_Hp,
                N_Hc=None if Nwt is not None else w.N_Hc,
                L_Hp=None if Lwt is not None else w.L_Hp, Cwt=w.Cwt, Ewt=w.Ewt)
        self._build(rebuild_step=model is not None)
        for k, v in saved.items():
            getattr(self, k)[:] = v
        return self

    def setparam(self, p):
        """Swap the user parameter ``p`` of JE/gc at run time.  A numeric p
        of the same structure travels as data (the step is kept); anything
        else rebuilds the step."""
        self.p = p
        p_num = _numeric_p(p)
        if (self._p_traced and p_num is not None
                and _structure(p_num) == _structure(self.params["p_user"])):
            self.params["p_user"] = p_num
            self._params_version += 1
        else:
            self._build(rebuild_step=True)
        return self

    def initstate(self, u, ym, d=None):
        x = super().initstate(u, ym, d)
        self._solved_once = False   # the MultipleShooting cold start again
        self.y_dual = None          # a fresh episode drops the QP duals
        return x

    # ------------------------------------------------------------------
    def moveinput(self, ry=None, d=None, D_hat=None, R_hat_y=None,
                  R_hat_u=None, lastu=None, **alias):
        """Solve the NMPC problem, return u(k) (execute.jl:59-80).  One
        period is the step on one lane: the params go up once per version,
        the period's inputs in one copy, and the outputs come back in one
        copy."""
        model, estim = self.estim.model, self.estim
        if estim.direct and not estim.prepared:
            warnings.warn("preparestate should be called before moveinput")
        D_hat = D_hat if D_hat is not None else alias.pop("Dhat", None)
        R_hat_y = R_hat_y if R_hat_y is not None else alias.pop("Rhaty", None)
        R_hat_u = R_hat_u if R_hat_u is not None else alias.pop("Rhatu", None)
        for k in ("Dhat", "Rhaty", "Rhatu"):
            alias.pop(k, None)
        if alias:
            raise TypeError(f"unknown moveinput arguments: {sorted(alias)}")
        ry, d, D_hat, R_hat_y, R_hat_u, lastu = self._prepare_args(
            ry, d, D_hat, R_hat_y, R_hat_u, lastu)
        self.lastu0 = lastu - model.uop
        d0 = d - model.dop
        D0 = D_hat - self.Dop
        yk = np.asarray(estim.evaloutput(d if model.nd else None), float)
        if isinstance(estim, InternalModel):
            # the stochastic output predictions enter the rollout
            self.params["Ys_now"] = (self.params["Ks"] @ estim.xs_hat
                                     + self.params["Ps"] @ estim.ys_hat)
            self._params_version += 1
        dt, dev = self.dtype, self.device
        p = self._params_on(dt)
        step, _, coldstart = self._fns(dt)
        y_prev = getattr(self, "y_dual", None)
        n_dual = self._n_dual()
        ins = [estim.x0_hat, self.lastu0, d0, D0, R_hat_y, R_hat_u, yk, ry,
               self.Z_tilde, np.zeros(n_dual) if y_prev is None else y_prev]
        flat = torch.as_tensor(np.concatenate(ins)[None], dtype=dt).to(dev)
        x0_t, lu_t, d0_t, D0_t, Ry_t, Ru_t, yk_t, ry_t, Z_t, y_t = torch.split(
            flat, [len(a) for a in ins], 1)
        if self.is_ms and not self._solved_once:
            Z_t = coldstart(p, x0_t, lu_t, d0_t, D0_t)
        u, Zt, Zs, y_d, J, viol, stat, iters, Y0f, xendf, U0f = step(
            p, x0_t, lu_t, d0_t, D0_t, Ry_t, Ru_t, yk_t, ry_t, Z_t, y_t, self._lane)
        out = torch.cat([u, Zt, Zs, y_d, J[:, None], viol[:, None], stat[:, None],
                         iters[:, None].to(dt), Y0f, xendf, U0f], 1)[0].cpu().numpy()
        nu = model.nu
        u, Zt, Zs, y_d, (J, viol, stat, iters), Y0f, xendf, U0f = np.split(
            out, np.cumsum([nu, self.nZt, self.nZt, n_dual, 4, Y0f.shape[1],
                            xendf.shape[1]]))
        self.y_dual = y_d.copy()
        self._solved_once = True
        self.lastu0_at_solve = self.lastu0.copy()
        self.Z_tilde = Zt.copy()
        self.R_hat_y, self.R_hat_u = R_hat_y, R_hat_u
        self._last = dict(J=float(J), viol=float(viol), stat=float(stat),
                          iters=int(iters), d=d, D_hat=D_hat, Y0=Y0f.copy(),
                          xend=xendf.copy(), U0=U0f.copy(), yk=yk.copy(), failed=False,
                          x0_hat=np.asarray(estim.x0_hat, float).copy(),
                          d0=d0.copy(), D0=D0.copy(), ry=ry.copy())
        u = u.copy()
        if not np.isfinite(J) or viol > 1e-2:
            # the reference's failure policy (controller/execute.jl:499-504):
            # warn and apply the SHIFTED WARM START, never the violated plan
            warnings.warn(f"NonLinMPC solution is poor (J={float(J):.3g}, "
                          f"max violation={float(viol):.3g}); applying the "
                          f"shifted warm start instead — inspect getinfo()")
            self.Z_tilde = Zs.copy()
            u0 = np.clip(Zs[:nu] + self.lastu0, self.U0min[:nu], self.U0max[:nu])
            u = u0 + model.uop
            self._last["failed"] = True
            logging.getLogger("mpc_tpu_torch").debug(info2debugstr(self.getinfo()))
        self.lastu0 = u - model.uop
        return u

    def _n_dual(self):
        """Length of the QP dual vector the SQP carries: the inequality rows
        and the trust rows."""
        nu, ny = self.estim.model.nu, self.estim.model.ny
        n_in = (2 * nu * self.Hp + 2 * nu * self.Hc + 2 * ny * self.Hp + 2 * self.nW
                + 2 * self.estim.nx_hat + self.nc + self.n_eps)
        return n_in + self.nZt - self.neq

    def getinfo(self):
        model, estim = self.estim.model, self.estim
        nu = model.nu
        info = {}
        Z = self.Z_tilde[:self.nZ]
        info["DeltaU"] = info["ΔU"] = Z[:nu * self.Hc]
        info["epsilon"] = info["ϵ"] = float(self.Z_tilde[-1]) if self.n_eps else 0.0
        info["J"] = self._last.get("J")
        info["viol"] = self._last.get("viol")
        info["kkt_stat"] = self._last.get("stat")
        info["iters"] = self._last.get("iters")
        lastu0 = getattr(self, "lastu0_at_solve", self.lastu0)
        U0 = self._last.get("U0")
        if U0 is None:
            U0 = self.params["Pu"] @ Z + self.params["Tu"] @ lastu0
        info["U"] = U0 + self.Uop
        info["u"] = info["U"][:nu]
        info["lastu"] = lastu0 + model.uop
        info["d"] = self._last.get("d")
        info["Dhat"] = info["D̂"] = self._last.get("D_hat")
        if self._last.get("Y0") is not None:
            info["Yhat"] = info["Ŷ"] = self._last["Y0"] + self.Yop
        if self._last.get("xend") is not None:
            info["xhatend"] = info["x̂end"] = self._last["xend"] + estim.xop_hat
        info["Rhaty"] = info["R̂y"] = getattr(self, "R_hat_y", None)
        info["Rhatu"] = info["R̂u"] = getattr(self, "R_hat_u", None)
        info["xhat"] = info["x̂"] = estim.x0_hat + estim.xop_hat
        yk = self._last.get("yk")
        if yk is not None:
            info["yhat"] = info["ŷ"] = np.asarray(yk, float)
        else:
            d_now = self._last.get("d", model.dop)
            info["yhat"] = info["ŷ"] = np.asarray(
                estim.evaloutput(d_now if model.nd else None), float)
        if isinstance(estim, InternalModel):
            info["Yhats"] = info["Ŷs"] = np.asarray(self.params["Ys_now"])
        else:
            info["Yhats"] = info["Ŷs"] = np.zeros(model.ny * self.Hp)
        dt, dev = self.dtype, self.device
        t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dt, device=dev)
        if info.get("Ŷ") is not None and info.get("d") is not None:
            # the economic cost and the custom constraints at the optimum
            # (addinfo!, nonlinmpc.jl:565-580), on the controller's device
            Ue = t(np.concatenate([info["U"], info["U"][-nu:]]))
            Ye = t(np.concatenate([info["ŷ"], info["Ŷ"]]))
            De = t(np.concatenate([np.asarray(info["d"], float),
                                   np.asarray(info["D̂"], float)]))
            eps = info["ϵ"]
            info["JE"] = float(torch.as_tensor(self.JE(Ue, Ye, De, self.p, eps)))
            info["gc"] = (self.gc(Ue, Ye, De, self.p, eps).cpu().numpy()
                          if self.gc is not None and self.nc else np.zeros(0))
        if self._last.get("x0_hat") is not None:
            L = self._last
            _, diag, _ = self._fns(dt)
            J, gJ, g_vals, geq = (a.cpu().numpy() for a in diag(
                self._params_on(dt), t(L["x0_hat"]), t(lastu0), t(L["d0"]), t(L["D0"]),
                t(self.R_hat_y), t(self.R_hat_u), t(L["yk"]), t(L["ry"]),
                t(self.Z_tilde)))
            info["gradJ"] = info["∇J"] = gJ
            info["g"], info["geq"] = g_vals, geq
            info["sol"] = dict(
                solver=f"SQP ({self.hessian.replace('_', '-')} Hessian + "
                       f"{'active-set' if self.qp_solver == 'active_set' else 'ADMM'} QP)",
                iterations=L.get("iters"), objective=L.get("J"),
                max_violation=L.get("viol"),
                defect_norm=float(np.max(np.abs(geq))) if geq.size else 0.0,
                failed=L.get("failed", False), nZt=self.nZt)
        return info

    def __repr__(self):
        model = self.estim.model
        qp = "Goldfarb–Idnani active-set QP" if self.qp_solver == "active_set" else "ADMM-QP"
        return (f"NonLinMPC controller with a sample time Ts = {model.Ts} s:\n"
                f"├ estimator: {type(self.estim).__name__}\n"
                f"├ model: {type(model).__name__}\n"
                f"├ optimizer: SQP (torch, {self.hessian.replace('_', '-')} Hessian + {qp})\n"
                f"├ transcription: {type(self.transcription).__name__}\n"
                f"└ dimensions: Hp={self.Hp}, Hc={self.Hc}, nu={model.nu}, "
                f"nx̂={self.estim.nx_hat}, nZ̃={self.nZt}")
