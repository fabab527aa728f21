"""ExplicitMPC — unconstrained linear MPC solved analytically (counterpart of
``mpc_tpu/controllers/explicitmpc.py``; reference
``src/controller/explicitmpc.jl``).

Z̃ = −H̃⁻¹q̃ with H̃⁻¹ computed once on the host (NumPy float64, one Newton
refinement step): a period is a handful of matrix-vector products, with no
optimizer and no kernel.  ``moveinput`` runs the step on one lane on the
controller's device; ``parallel.BatchedExplicitMPC`` runs the same step
over a fleet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..estimators import InternalModel, StateEstimator, SteadyKalmanFilter
from ..models import LinModel
from ..utils.config import resolve_device
from .base import PredictiveController, default_Hp
from .construct import ControllerWeights, init_quadprog
from .linmpc import _init_stochpred, _setmodel_estimator
from .transcription import (SingleShooting, init_predmat, init_ZtoDU, init_ZtoU,
                            move_blocking)


class ExplicitMPC(PredictiveController):
    def __init__(self, model_or_estim, Hp=None, Hc=2, Mwt=None, Nwt=None, Lwt=None,
                 M_Hp=None, N_Hc=None, L_Hp=None, dtype=None, device=None,
                 **estim_kwargs):
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.device = resolve_device(device)
        if isinstance(model_or_estim, StateEstimator):
            estim = model_or_estim
            model = estim.model
        else:
            model = model_or_estim
            estim = SteadyKalmanFilter(model, **estim_kwargs)
        if not isinstance(model, LinModel):
            raise TypeError("model type must be a LinModel")
        self.estim = estim
        self.transcription = SingleShooting()
        Hp = default_Hp(model) if Hp is None else int(Hp)
        nb = move_blocking(Hp, Hc)
        self.Hp, self.Hc, self.nb = Hp, len(nb), nb
        # no slack variable: Cwt = ∞ (hard constraints, here absent)
        self.weights = ControllerWeights(model.nu, model.ny, Hp, self.Hc, Mwt, Nwt, Lwt,
                                         M_Hp, N_Hc, L_Hp, Cwt=np.inf)
        self.n_eps = 0
        self._lane_step = _build_step(model.nu, model.nd)
        self._build()
        self.Z_tilde = np.zeros(self.nZt)
        self.lastu0 = np.zeros(model.nu)
        self._last = {}

    def _build(self):
        model, estim = self.estim.model, self.estim
        Hp, Hc, nb = self.Hp, self.Hc, self.nb
        nu, ny = model.nu, model.ny
        if isinstance(estim, InternalModel):
            # deterministic predictions + stochastic output predictions Ŷs
            # (init_stochpred, construct.jl:1236-1267), as LinMPC's
            mats = (model.A, model.Bu, model.C, model.Bd, model.Dd, model.xop, model.fop)
            Ks, Ps = _init_stochpred(estim, Hp)
        else:
            mats = (estim.A_hat, estim.Bu_hat, estim.C_hat, estim.Bd_hat, estim.Dd_hat,
                    estim.xop_hat, estim.fop_hat)
            Ks = np.zeros((ny * Hp, getattr(estim, "nxs", 0)))
            Ps = np.zeros((ny * Hp, ny))
        E, G, J, K, V, B, *_ = init_predmat(self.transcription, *mats, Hp, Hc, nb)
        nx_pred = mats[0].shape[0]
        PDu = init_ZtoDU(self.transcription, nu, nx_pred, Hp, Hc)
        Pu, Tu = init_ZtoU(self.transcription, nu, nx_pred, Hp, Hc, nb)
        H = init_quadprog(E, PDu, Pu, self.weights)
        self.nZ = self.nZt = E.shape[1]
        Hinv = np.linalg.inv(H)
        Hinv = Hinv @ (2.0 * np.eye(H.shape[0]) - H @ Hinv)   # Newton refinement
        self.params = dict(H_inv=Hinv, E=E, G=G, J=J, K=K, V=V, B=B, Pu=Pu, Tu=Tu,
                           Ks=Ks, Ps=Ps, M_Hp=self.weights.M_Hp, L_Hp=self.weights.L_Hp,
                           Uop=np.tile(model.uop, Hp), Yop=np.tile(model.yop, Hp))
        self._p_dev = None   # uploaded again at the next moveinput
        self._H = H
        self.Uop = np.tile(model.uop, Hp)
        self.Yop = np.tile(model.yop, Hp)
        self.Dop = np.tile(model.dop, Hp)

    def setconstraint(self, **kw):
        """ExplicitMPC solves the unconstrained QP analytically: constraints
        are not supported (explicitmpc.jl has no setconstraint!)."""
        raise NotImplementedError(
            "ExplicitMPC does not support constraints; use LinMPC instead")

    def setmodel(self, model=None, Mwt=None, Nwt=None, Lwt=None, **cov):
        """Swap the plant model or the weights (explicitmpc.jl setmodel!)."""
        model_ = self.estim.model
        if model is not None:
            lastu_abs = self.lastu0 + model_.uop
            _setmodel_estimator(self.estim, model, **cov)
            self.lastu0 = lastu_abs - model.uop
            model_ = model
        if Mwt is not None or Nwt is not None or Lwt is not None:
            w = self.weights
            self.weights = ControllerWeights(
                model_.nu, model_.ny, self.Hp, self.Hc,
                Mwt if Mwt is not None else np.diag(w.M_Hp)[:model_.ny],
                Nwt if Nwt is not None else np.diag(w.N_Hc)[:model_.nu],
                Lwt if Lwt is not None else np.diag(w.L_Hp)[:model_.nu], Cwt=np.inf)
        self._build()
        return self

    def moveinput(self, ry=None, d=None, D_hat=None, R_hat_y=None, R_hat_u=None,
                  lastu=None, **alias):
        model, estim = self.estim.model, self.estim
        D_hat = D_hat if D_hat is not None else alias.get("Dhat")
        R_hat_y = R_hat_y if R_hat_y is not None else alias.get("Rhaty")
        R_hat_u = R_hat_u if R_hat_u is not None else alias.get("Rhatu")
        ry, d, D_hat, R_hat_y, R_hat_u, lastu = self._prepare_args(
            ry, d, D_hat, R_hat_y, R_hat_u, lastu)
        self.lastu0 = lastu - model.uop
        dt, dev = self.dtype, self.device
        if self._p_dev is None:
            self._p_dev = {k: torch.as_tensor(np.asarray(v, float)[None], dtype=dt, device=dev)
                           for k, v in self.params.items()}
        if isinstance(estim, InternalModel):
            xs_hat, ys_full = estim.xs_hat, estim.ys_hat
        else:
            xs_hat, ys_full = np.zeros(self.params["Ks"].shape[1]), np.zeros(model.ny)
        ins = [estim.x0_hat, self.lastu0, d - model.dop, D_hat - self.Dop, R_hat_y,
               R_hat_u, xs_hat, ys_full]
        flat = torch.as_tensor(np.concatenate(ins)[None], dtype=dt).to(dev)
        u, Z, F = self._lane_step(self._p_dev, *torch.split(flat, [len(a) for a in ins], 1))
        out = torch.cat([u, Z, F], 1)[0].cpu().numpy()
        u, Z, F = np.split(out, [model.nu, model.nu + self.nZt])
        self.lastu0_at_solve = self.lastu0.copy()
        self.Z_tilde = Z.copy()
        self._last = dict(F=F.copy(), d=d, D_hat=D_hat, R_hat_y=R_hat_y, R_hat_u=R_hat_u)
        u = u.copy()
        self.lastu0 = u - model.uop
        return u

    def getinfo(self):
        nu = self.estim.model.nu
        Z = self.Z_tilde
        info = {}
        info["DeltaU"] = info["ΔU"] = Z[:nu * self.Hc]
        info["epsilon"] = info["ϵ"] = 0.0
        U0 = self.params["Pu"] @ Z + self.params["Tu"] @ self.lastu0_at_solve
        info["U"] = U0 + self.Uop
        info["u"] = info["U"][:nu]
        Y0 = self.params["E"] @ Z + self._last["F"]
        info["Yhat"] = info["Ŷ"] = Y0 + self.Yop
        info["xhat"] = info["x̂"] = self.estim.x0_hat + self.estim.xop_hat
        info["yhat"] = info["ŷ"] = np.asarray(self.estim.evaloutput(
            self._last.get("d") if self.estim.model.nd else None), float)
        # the objective of the tracking terms (execute.jl:172)
        w = self.weights
        ey = Y0 + self.Yop - self._last["R_hat_y"]
        eu = U0 + self.Uop - self._last["R_hat_u"]
        DU = info["DeltaU"]
        info["J"] = float(ey @ w.M_Hp @ ey + DU @ w.N_Hc @ DU + eu @ w.L_Hp @ eu)
        info["lastu"] = self.lastu0_at_solve + self.estim.model.uop
        return info

    def __repr__(self):
        model = self.estim.model
        return (f"ExplicitMPC controller with a sample time Ts = {model.Ts} s:\n"
                f"├ estimator: {type(self.estim).__name__}\n"
                f"└ dimensions: Hp={self.Hp}, Hc={self.Hc}, nu={model.nu}, "
                f"nx̂={self.estim.nx_hat}")


def _build_step(nu, nd):
    """The analytic step over a leading lane axis: ``step(p, x0_hat, lastu0,
    d0, D0, R_hat_y, R_hat_u, xs_hat, ys_full) -> (u, Z, F)``, every params
    entry with a leading axis of 1 or B (one controller per lane)."""
    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    def step(p, x0_hat, lastu0, d0, D0, R_hat_y, R_hat_u, xs_hat, ys_full):
        F = p["B"] + mv(p["K"], x0_hat) + mv(p["V"], lastu0)
        if nd:
            F = F + mv(p["G"], d0) + mv(p["J"], D0)
        # InternalModel stochastic predictions (execute.jl:321-327); zero
        # matrices otherwise
        F = F + mv(p["Ks"], xs_hat) + mv(p["Ps"], ys_full)
        Cy = F + p["Yop"] - R_hat_y
        Cu = mv(p["Tu"], lastu0) + p["Uop"] - R_hat_u
        q = 2.0 * (mv(p["E"].mT, mv(p["M_Hp"], Cy)) + mv(p["Pu"].mT, mv(p["L_Hp"], Cu)))
        Z = -mv(p["H_inv"], q)
        return Z[:, :nu] + lastu0 + p["Uop"][:, :nu], Z, F
    return step
