"""Internal model (IMC/DMC) estimator (counterpart of
``mpc_tpu/estimators/internal_model.py``; reference
src/estimator/internal_model.jl).

No state augmentation: deterministic model runs open loop, the stochastic
output ``ŷs = ym − ŷd`` feeds a stochastic model with update matrices
``Âs = As − B̂s Cs``, ``B̂s = Bs Ds⁻¹`` (internal_model.jl:228-232).  The MPC
F-vector receives its stochastic output predictions Ŷs.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..models import LinModel, SimModel
from ..utils import lti
from .base import StateEstimator
from .construct import validate_ym


class InternalModel(StateEstimator):
    def __init__(self, model: SimModel, i_ym=None, stoch_ym=None):
        self.model = model
        i_ym = list(range(model.ny)) if i_ym is None else [int(i) for i in np.atleast_1d(i_ym)]
        self.i_ym = i_ym
        self.nym, self.nyu = validate_ym(model, i_ym)
        if isinstance(model, LinModel):
            poles = np.linalg.eigvals(model.A)
            if np.any(np.abs(poles) >= 1):
                raise ValueError("InternalModel does not support integrating or "
                                 "unstable model")
        # default stochastic model: one integrator per measured output
        if stoch_ym is None:
            In = np.eye(self.nym)
            stoch = lti.StateSpace(In, In, In, In, model.Ts)
        elif isinstance(stoch_ym, lti.StateSpace):
            stoch = stoch_ym
            if stoch.Ts is None:
                stoch = lti.c2d_tustin(stoch, model.Ts)
            elif not np.isclose(stoch.Ts, model.Ts):
                stoch = lti.c2d_tustin(lti.d2c_tustin(stoch), model.Ts)
        else:
            raise TypeError("stoch_ym must be a StateSpace")
        if stoch.ny != self.nym:
            raise ValueError(f"Stochastic model output quantity ({stoch.ny}) is "
                             f"different from measured output quantity ({self.nym})")
        if np.allclose(stoch.D, 0):
            raise ValueError("Stochastic model requires a nonzero direct "
                             "transmission matrix D")
        # expand the measured-output stochastic model to all outputs
        # (stoch_ym2y, estimator/construct.jl:196-209)
        As, Bsm, Csm, Dsm = stoch.A, stoch.B, stoch.C, stoch.D
        ny, ne = model.ny, Bsm.shape[1]
        Cs = np.zeros((ny, Csm.shape[1]))
        Cs[np.asarray(i_ym, int), :] = Csm
        Ds = np.zeros((ny, ne))
        Ds[np.asarray(i_ym, int), :] = Dsm
        # B̂s = Bs Ds⁻¹ (pinv when nym ≠ ny), Âs = As − B̂s Cs
        # (internal_model.jl:228-232)
        Bs_hat = Bsm @ np.linalg.pinv(Ds)
        As_hat = As - Bs_hat @ Cs
        self.As, self.Bs, self.Cs, self.Ds = As, Bsm, Cs, Ds
        self.As_hat, self.Bs_hat = As_hat, Bs_hat
        self.nxs = As.shape[0]
        self.nx_hat = model.nx  # no augmentation
        self.nint_u = [0] * model.nu
        self.nint_ym = [0] * self.nym
        self.Cs_u = np.zeros((model.nu, self.nxs))
        self.Cs_y = np.zeros((model.ny, self.nxs))
        self.xop_hat = model.xop.copy()
        self.fop_hat = model.fop.copy()
        if isinstance(model, LinModel):
            self.A_hat, self.Bu_hat, self.C_hat = model.A, model.Bu, model.C
            self.Bd_hat, self.Dd_hat = model.Bd, model.Dd
            self.Cm_hat = model.C[i_ym, :]
            self.Ddm_hat = model.Dd[i_ym, :]
        else:
            self.A_hat = self.Bu_hat = self.C_hat = None
            self.Bd_hat = self.Dd_hat = self.Cm_hat = self.Ddm_hat = None
        self.direct = True
        self.prepared = False
        self.x0_hat = np.zeros(model.nx)
        self.xs_hat = np.zeros(self.nxs)
        self.ys_hat = np.zeros(model.ny)

    # augmented dynamics = plain model dynamics (no augmentation)
    def f_hat(self, x0_hat, u0, d0):
        return self.model.f(x0_hat, u0, d0, self.model.p)

    def h_hat(self, x0_hat, d0):
        return self.model.h(x0_hat, d0, self.model.p)

    def _make_tensor_fns(self, t):
        if isinstance(self.model, LinModel):
            return super()._make_tensor_fns(t)
        model = self.model
        return (lambda x, u, d: model._fd(x, u, d, model.p),
                lambda x, d: model._h_user(x, d, model.p))

    def _correct(self, y0m, d0):
        """ŷs = ym − ŷd for measured outputs, 0 for unmeasured / NaN
        (internal_model.jl:268-284)."""
        if not np.all(np.isfinite(y0m)):
            warnings.warn("NaN values in the internal model measurements ym: "
                          "assigning them ŷs=0")
        y0d = np.asarray(self.h_hat(self.x0_hat, d0), float)
        ys = np.zeros(self.model.ny)
        for pos, iy in enumerate(self.i_ym):
            v = y0m[pos] - y0d[iy]
            ys[iy] = v if np.isfinite(v) else 0.0
        self.ys_hat = ys

    def _predict(self, u0, d0):
        x0n = np.asarray(self.f_hat(self.x0_hat, u0, d0), float)
        self.x0_hat = x0n + self.fop_hat - self.xop_hat
        self.xs_hat = self.As_hat @ self.xs_hat + self.Bs_hat @ self.ys_hat

    def _update_model(self, model, Qhat, Rhat):
        """setmodel_estimator! for InternalModel (internal_model.jl:239-247):
        the stochastic model is untouched; only the deterministic model data
        and operating points change."""
        if Qhat is not None or Rhat is not None:
            raise ValueError("InternalModel does not use Q̂/R̂ covariances")
        x_abs = self.x0_hat + self.xop_hat
        self.model = model
        self.xop_hat = model.xop.copy()
        self.fop_hat = model.fop.copy()
        self.A_hat, self.Bu_hat, self.C_hat = model.A, model.Bu, model.C
        self.Bd_hat, self.Dd_hat = model.Bd, model.Dd
        self.Cm_hat = model.C[np.asarray(self.i_ym, int), :]
        self.Ddm_hat = model.Dd[np.asarray(self.i_ym, int), :]
        self.x0_hat = x_abs - self.xop_hat

    def evaloutput(self, d=None):
        """ŷ = ŷd + ŷs (internal_model.jl:357-368)."""
        if not self.prepared:
            warnings.warn("preparestate should be called before evaloutput with "
                          "InternalModel")
        d = np.zeros(0) if d is None else np.asarray(d, float).ravel()
        d0 = d - self.model.dop
        y0d = np.asarray(self.h_hat(self.x0_hat, d0), float)
        return y0d + self.model.yop + self.ys_hat

    __call__ = evaloutput

    def initstate(self, u, ym, d=None):
        """Steady-state init (internal_model.jl:338-354)."""
        y0m, d0, u0 = self._remove_op(ym, d, u)
        model = self.model
        if isinstance(model, LinModel):
            rhs = model.Bu @ u0 + self.fop_hat - self.xop_hat
            if model.nd:
                rhs = rhs + model.Bd @ d0
            self.x0_hat = np.linalg.solve(np.eye(model.nx) - model.A, rhs)
            y0d = np.asarray(self.h_hat(self.x0_hat, d0), float)
            ys = np.zeros(model.ny)
            for pos, iy in enumerate(self.i_ym):
                ys[iy] = y0m[pos] - y0d[iy]
            self.xs_hat = np.linalg.solve(np.eye(self.nxs) - self.As_hat,
                                          self.Bs_hat @ ys)
            self.ys_hat = ys
        self.prepared = False
        return self.x0_hat + self.xop_hat

    def setstate(self, x_hat, P_hat=None):
        if P_hat is not None:
            raise ValueError("InternalModel does not compute an estimation "
                             "covariance matrix P̂.")
        return super().setstate(x_hat)
