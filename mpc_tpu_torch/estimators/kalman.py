"""Linear Kalman estimators (counterpart of ``mpc_tpu/estimators/kalman.py``).

SteadyKalmanFilter (constant gain from the filter DARE) and the time-varying
KalmanFilter, both for LinModel.  The single-stream correct/predict run on
the host in NumPy float64, as the reference's do; the batched fleet applies
the steady gain on the device itself (``parallel/batch.py``).  The
unscented and extended filters wait for ROADMAP queue 1, item 6.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..models import LinModel
from ..utils import linalg as ula
from .base import StateEstimator
from .construct import validate_covariances


def _sigma_scales(nu_or_sigma, n, name):
    v = np.asarray(nu_or_sigma, float).ravel()
    if v.shape != (n,):
        raise ValueError(f"{name} size {v.shape} ≠ ({n},)")
    if np.any(v < 0):
        # σ values are standard deviations; a negative one silently squares
        # into a "valid" covariance and hides the user error
        raise ValueError(f"{name} entries must be non-negative")
    return v


def _default_sigmas(model, i_ym, nint_u, nint_ym, sigmaQ, sigmaR,
                    sigmaQint_u, sigmaQint_ym):
    nx, nym = model.nx, len(i_ym)
    sQ = np.full(nx, 1 / nx) if sigmaQ is None else _sigma_scales(sigmaQ, nx, "σQ")
    sR = np.ones(nym) if sigmaR is None else _sigma_scales(sigmaR, nym, "σR")
    nu_int = sum(nint_u) if not np.isscalar(nint_u) else 0
    nym_int = sum(nint_ym) if not np.isscalar(nint_ym) else 0
    sQu = np.ones(nu_int) if sigmaQint_u is None else _sigma_scales(sigmaQint_u, nu_int, "σQint_u")
    sQy = np.ones(nym_int) if sigmaQint_ym is None else _sigma_scales(sigmaQint_ym, nym_int, "σQint_ym")
    Q_hat = np.diag(np.concatenate([sQ, sQu, sQy]) ** 2)
    R_hat = np.diag(sR ** 2)
    return Q_hat, R_hat


class SteadyKalmanFilter(StateEstimator):
    """Asymptotic Kalman filter for LinModel (kalman.jl:4-309).

    The gain is the steady-state filter gain from the prediction-form DARE,
    as in the reference package.
    """

    def __init__(self, model: LinModel, i_ym=None, nint_u=0, nint_ym=None,
                 sigmaQ=None, sigmaR=None, sigmaQint_u=None, sigmaQint_ym=None,
                 Q_hat=None, R_hat=None, direct=True):
        if not isinstance(model, LinModel):
            raise TypeError("SteadyKalmanFilter requires a LinModel")
        self._init_common(model, i_ym, nint_u, nint_ym, direct)
        if Q_hat is None or R_hat is None:
            Q_hat, R_hat = _default_sigmas(model, self.i_ym, self.nint_u, self.nint_ym,
                                           sigmaQ, sigmaR, sigmaQint_u, sigmaQint_ym)
        Q_hat, R_hat = validate_covariances(self.nx_hat, self.nym, Q_hat, R_hat)
        self.Q_hat, self.R_hat = Q_hat, R_hat
        try:
            K_hat, P_hat = ula.steady_kalman_gain(self.A_hat, self.Cm_hat, Q_hat,
                                                  R_hat, direct=direct)
        except Exception as err:
            raise ValueError(
                "Cannot compute the optimal Kalman gain K̂ for the SteadyKalmanFilter. "
                "You may try to remove integrators with nint_u/nint_ym parameter or "
                "use the time-varying KalmanFilter.") from err
        self.K_hat, self.P_hat = K_hat, P_hat

    def _correct(self, y0m, d0):
        x0 = self.x0_hat
        y0m_pred = self.Cm_hat @ x0 + self.Ddm_hat @ d0
        v = y0m - y0m_pred
        if np.any(np.isnan(v)):
            warnings.warn("NaN values in the Kalman filter measurements ym: "
                          "skipping correction step")
            return
        self.x0_hat = x0 + self.K_hat @ v

    def _predict(self, u0, d0):
        x0n = np.asarray(self.f_hat(self.x0_hat, u0, d0), float)
        self.x0_hat = x0n + self.fop_hat - self.xop_hat

    def _update_model(self, model, Qhat, Rhat):
        """As the reference does (and unlike the Julia package, which rejects
        setmodel! on this filter, kalman.jl:228-234): the steady gain is
        recomputed from the new model's DARE."""
        super()._update_model(model, Qhat, Rhat)
        self.K_hat, self.P_hat = ula.steady_kalman_gain(
            self.A_hat, self.Cm_hat, self.Q_hat, self.R_hat, direct=self.direct)


class KalmanFilter(StateEstimator):
    """Time-varying Kalman filter for LinModel (kalman.jl:311-527)."""

    def __init__(self, model: LinModel, i_ym=None, nint_u=0, nint_ym=None,
                 sigmaQ=None, sigmaR=None, sigmaQint_u=None, sigmaQint_ym=None,
                 sigmaP_0=None, sigmaPint_u_0=None, sigmaPint_ym_0=None,
                 Q_hat=None, R_hat=None, P0_hat=None, direct=True):
        if not isinstance(model, LinModel):
            raise TypeError("KalmanFilter requires a LinModel")
        self._init_common(model, i_ym, nint_u, nint_ym, direct)
        if Q_hat is None or R_hat is None:
            Q_hat, R_hat = _default_sigmas(model, self.i_ym, self.nint_u, self.nint_ym,
                                           sigmaQ, sigmaR, sigmaQint_u, sigmaQint_ym)
        if P0_hat is None:
            P0_hat = _default_P0(model, self.nint_u, self.nint_ym,
                                 sigmaP_0, sigmaPint_u_0, sigmaPint_ym_0)
        Q_hat, R_hat, P0_hat = validate_covariances(self.nx_hat, self.nym,
                                                    Q_hat, R_hat, P0_hat)
        self.Q_hat, self.R_hat, self.P0_hat = Q_hat, R_hat, P0_hat
        self.P_hat = P0_hat.copy()

    def _init_cov(self):
        self.P_hat = self.P0_hat.copy()

    def _set_cov(self, P_hat):
        if P_hat.shape != (self.nx_hat, self.nx_hat):
            raise ValueError(f"P̂ size must be {(self.nx_hat, self.nx_hat)}")
        self.P_hat = P_hat

    def _correct(self, y0m, d0):
        """kalman.jl:1235-1264; a NaN measurement skips the correction."""
        y0m_pred = self.Cm_hat @ self.x0_hat + self.Ddm_hat @ d0
        if np.any(np.isnan(y0m)):
            warnings.warn("NaN values in the Kalman filter measurements ym: "
                          "skipping correction step")
            return
        P = self.P_hat
        PCt = P @ self.Cm_hat.T
        M = self.Cm_hat @ PCt + self.R_hat
        K = np.linalg.solve(M.T, PCt.T).T
        self.x0_hat = self.x0_hat + K @ (np.asarray(y0m, float) - y0m_pred)
        Pc = (np.eye(P.shape[0]) - K @ self.Cm_hat) @ P
        self.P_hat = 0.5 * (Pc + Pc.T)

    def _predict(self, u0, d0):
        """kalman.jl:1275-1290."""
        x0n_raw = np.asarray(self.f_hat(self.x0_hat, u0, d0), float)
        self.x0_hat = x0n_raw + (self.fop_hat - self.xop_hat)
        Pn = self.A_hat @ self.P_hat @ self.A_hat.T + self.Q_hat
        self.P_hat = 0.5 * (Pn + Pn.T)


def _default_P0(model, nint_u, nint_ym, sigmaP_0, sigmaPint_u_0, sigmaPint_ym_0):
    nx = model.nx
    # reference default σP_0 = fill(1/nx, nx), same as σQ (kalman.jl:430-431)
    sP = np.full(nx, 1.0 / nx) if sigmaP_0 is None else _sigma_scales(sigmaP_0, nx, "σP_0")
    nu_int, nym_int = sum(nint_u), sum(nint_ym)
    sPu = np.ones(nu_int) if sigmaPint_u_0 is None else _sigma_scales(sigmaPint_u_0, nu_int, "σPint_u_0")
    sPy = np.ones(nym_int) if sigmaPint_ym_0 is None else _sigma_scales(sigmaPint_ym_0, nym_int, "σPint_ym_0")
    return np.diag(np.concatenate([sP, sPu, sPy]) ** 2)
