"""Luenberger observer by pole placement (counterpart of
``mpc_tpu/estimators/luenberger.py``; reference src/estimator/luenberger.jl)."""
from __future__ import annotations

import numpy as np

from ..models import LinModel
from ..utils import linalg as ula
from .base import StateEstimator
from .kalman import SteadyKalmanFilter


class Luenberger(StateEstimator):
    """Pole-placement observer; shares the constant-gain correct/predict of
    the SteadyKalmanFilter (kalman.jl:284-309)."""

    def __init__(self, model: LinModel, i_ym=None, nint_u=0, nint_ym=None,
                 poles=None, direct=True):
        if not isinstance(model, LinModel):
            raise TypeError("Luenberger requires a LinModel")
        self._init_common(model, i_ym, nint_u, nint_ym, direct)
        nx_hat = self.nx_hat
        if poles is None:
            # reference default: 1e-3*(1:nx̂) .+ 0.5 (luenberger.jl:65)
            poles = 1e-3 * np.arange(1, nx_hat + 1) + 0.5
        poles = np.asarray(poles)
        if poles.shape != (nx_hat,):
            raise ValueError(f"poles size must be ({nx_hat},)")
        if np.any(np.abs(poles) >= 1):
            raise ValueError("poles should be inside the unit circle")
        try:
            # correct-then-predict composite has closed loop Â − Â K̂ Ĉm for
            # both direct settings; place eig(Â − Kp Ĉm) = poles, K̂ = Â⁻¹Kp
            Kp = ula.place_poles(self.A_hat.T, self.Cm_hat.T, poles).T
            K_hat = np.linalg.solve(self.A_hat, Kp)
        except Exception as err:
            raise ValueError("Cannot compute the Luenberger gain K̂ with specified "
                             "poles.") from err
        self.K_hat = K_hat

    _correct = SteadyKalmanFilter._correct
    _predict = SteadyKalmanFilter._predict

    def _update_model(self, model, Qhat, Rhat):
        raise ValueError("Luenberger does not support setmodel "
                         "(luenberger.jl:149-155)")
