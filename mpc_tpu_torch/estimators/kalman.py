"""Kalman-family estimators (counterpart of ``mpc_tpu/estimators/kalman.py``).

SteadyKalmanFilter (constant gain from the filter DARE) and the time-varying
KalmanFilter, both for LinModel: their single-stream correct/predict run on
the host in NumPy float64, as the reference's do.  ``kf_correct`` and
``kf_predict`` are the same time-varying steps on tensors over leading lane
axes, for the fleets (``parallel/batch_kf.py``, ``controllers/slmpc.py``)
and the ExtendedKalmanFilter.  The UnscentedKalmanFilter and the
ExtendedKalmanFilter take any SimModel and run their steps on ``device``
(the GPU unless the caller asks for another) in float64, with
``torch.func.vmap`` over the sigma points and ``torch.func.jacfwd``
Jacobians.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..models import LinModel
from ..utils import linalg as ula
from ..utils.config import resolve_device
from ..utils.small_linalg import chol_small, inv_spd_small
from .base import StateEstimator
from .construct import validate_covariances

_NAN_SKIP = "NaN values in the Kalman filter measurements ym: skipping correction step"


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
            warnings.warn(_NAN_SKIP)
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
            warnings.warn(_NAN_SKIP)
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


# ---------------------------------------------------------------------------
# the time-varying KF steps on tensors (fleets, SLMPC, the EKF)
def kf_correct(x0, P, y0m_pred, y0m, Cm, R):
    """Time-varying KF correction (kalman.jl:1235-1264) over leading lane
    axes: x0 (…, n), P (…, n, n), y0m and y0m_pred (…, nym), Cm (…, nym,
    n), R (…, nym, nym).  A lane whose measurement holds a NaN keeps its x0
    and P (the reference's NaN skip)."""
    PCt = P @ Cm.mT
    M = Cm @ PCt + R
    K = PCt @ inv_spd_small(0.5 * (M + M.mT))
    v = y0m - y0m_pred
    skip = torch.isnan(v).any(-1, keepdim=True)
    v = torch.nan_to_num(v)
    x0c = x0 + (K @ v.unsqueeze(-1)).squeeze(-1)
    Pc = (torch.eye(P.shape[-1], dtype=P.dtype, device=P.device) - K @ Cm) @ P
    x0c = torch.where(skip, x0, x0c)
    Pc = torch.where(skip.unsqueeze(-1), P, Pc)
    return x0c, 0.5 * (Pc + Pc.mT)


def kf_predict(x0n_raw, P, A, Q, fop_m_xop):
    """Time-varying KF prediction (kalman.jl:1275-1290) over leading lane
    axes."""
    x0n = x0n_raw + fop_m_xop
    Pn = A @ P @ A.mT + Q
    return x0n, 0.5 * (Pn + Pn.mT)


class _DeviceFilter(StateEstimator):
    """Shared construction of the unscented and extended filters: the
    covariances of the time-varying KF, and the device their steps run on
    (host NumPy state, float64 tensors for each step)."""

    def _init_filter(self, model, i_ym, nint_u, nint_ym, sigmaQ, sigmaR,
                     sigmaQint_u, sigmaQint_ym, sigmaP_0, sigmaPint_u_0,
                     sigmaPint_ym_0, Q_hat, R_hat, P0_hat, direct, device):
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
        self.device = resolve_device(device)

    _init_cov = KalmanFilter._init_cov
    _set_cov = KalmanFilter._set_cov

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                               device=self.device)

    def _store(self, x0, P):
        self.x0_hat, self.P_hat = x0.cpu().numpy(), P.cpu().numpy()


class UnscentedKalmanFilter(_DeviceFilter):
    """UKF for any SimModel (kalman.jl:528-906), generalized unscented
    transform with 2nx̂+1 sigma points."""

    def __init__(self, model, i_ym=None, nint_u=0, nint_ym=None,
                 sigmaQ=None, sigmaR=None, sigmaQint_u=None, sigmaQint_ym=None,
                 sigmaP_0=None, sigmaPint_u_0=None, sigmaPint_ym_0=None,
                 Q_hat=None, R_hat=None, P0_hat=None,
                 alpha=1e-3, beta=2.0, kappa=0.0, direct=True, device=None):
        self._init_filter(model, i_ym, nint_u, nint_ym, sigmaQ, sigmaR,
                          sigmaQint_u, sigmaQint_ym, sigmaP_0, sigmaPint_u_0,
                          sigmaPint_ym_0, Q_hat, R_hat, P0_hat, direct, device)
        # init_ukf constants (kalman.jl:760-770)
        nx_hat = self.nx_hat
        gamma = alpha * np.sqrt(nx_hat + kappa)
        m0 = 1 - nx_hat / gamma ** 2
        w = 1 / (2 * gamma ** 2)
        self.gamma = float(gamma)
        self.alpha = float(alpha)
        self.m_hat = np.concatenate([[m0], np.full(2 * nx_hat, w)])
        self.S_hat = np.concatenate([[m0 + 1 - alpha ** 2 + beta], np.full(2 * nx_hat, w)])

    def _kernels(self, dtype=torch.float64, device=None):
        """The correction and prediction over a leading lane axis (the
        reference's ``_kernels()``, which its fleet vmaps):
        ``correct(x0, P, y0m, d0, m, S, R)`` and ``predict(x0, P, u0, d0,
        m, S, Q, fop_m_xop)`` with x0 (B, n), P (B, n, n), y0m/u0/d0 (B, ·)
        and the weights and covariances shared.  Unlike ``_correct``, a NaN
        measurement is not skipped (the reference's vmapped kernel has no
        skip either).  The model's matrices live on ``device`` (default:
        the filter's) in ``dtype``."""
        f_hat, h_hat = self.tensor_fns(dtype, self.device if device is None else device)
        i_ym, gamma = list(self.i_ym), self.gamma
        h_m = lambda x, d: h_hat(x, d)[i_ym]
        correct = lambda x0, P, y0m, d0, m, S, R: ukf_correct(x0, P, y0m, d0, m, S, R,
                                                             h_m, gamma)
        predict = lambda x0, P, u0, d0, m, S, Q, c: ukf_predict(x0, P, u0, d0, m, S, Q, c,
                                                                f_hat, gamma)
        return correct, predict

    def _correct(self, y0m, d0):
        if np.any(np.isnan(y0m)):
            warnings.warn(_NAN_SKIP)
            return
        correct, _ = self._kernels()
        x0, P, y0m, d0, m, S, R = map(self._t, (self.x0_hat, self.P_hat, y0m, d0,
                                                self.m_hat, self.S_hat, self.R_hat))
        x0c, Pc = correct(x0[None], P[None], y0m[None], d0[None], m, S, R)
        self._store(x0c[0], Pc[0])

    def _predict(self, u0, d0):
        _, predict = self._kernels()
        x0, P, u0, d0, m, S, Q, fop_m_xop = map(
            self._t, (self.x0_hat, self.P_hat, u0, d0, self.m_hat, self.S_hat,
                      self.Q_hat, self.fop_hat - self.xop_hat))
        x0n, Pn = predict(x0[None], P[None], u0[None], d0[None], m, S, Q, fop_m_xop)
        self._store(x0n[0], Pn[0])


def _sigma_points(x0, P, gamma):
    """The 2n+1 sigma points as columns, over a leading lane axis: (B, n,
    2n+1) from x0 (B, n) and P (B, n, n)."""
    gL = gamma * chol_small(P)
    return torch.cat([x0[..., None], x0[..., None] + gL, x0[..., None] - gL], -1)


def _each_point(fn, X, *lane_args):
    """``fn(x, *args)`` on every sigma point (column) of every lane: X (B,
    n, k) and per-lane args (B, ·) → (B, ·, k)."""
    per_lane = vmap(fn, in_dims=(1,) + (None,) * len(lane_args), out_dims=1)
    return vmap(per_lane)(X, *lane_args)


def ukf_correct(x0, P, y0m, d0, m, S, R, h_hat_m, gamma):
    """UKF correction (kalman.jl:646-700) over a leading lane axis, with
    ``h_hat_m`` on one sample."""
    X = _sigma_points(x0, P, gamma)
    Ym = _each_point(h_hat_m, X, d0)
    y0m_pred = Ym @ m
    Xb = X - x0[..., None]
    Yb = Ym - y0m_pred[..., None]
    M = (Yb * S) @ Yb.mT + R
    K = ((Xb * S) @ Yb.mT) @ inv_spd_small(0.5 * (M + M.mT))
    x0c = x0 + (K @ (y0m - y0m_pred)[..., None])[..., 0]
    Pc = P - K @ M @ K.mT
    return x0c, 0.5 * (Pc + Pc.mT)


def ukf_predict(x0, P, u0, d0, m, S, Q, fop_m_xop, f_hat, gamma):
    """UKF prediction (kalman.jl:702-760) over a leading lane axis, with
    ``f_hat`` on one sample."""
    X = _sigma_points(x0, P, gamma)
    Xn = _each_point(lambda xc, u, d: f_hat(xc, u, d) + fop_m_xop, X, u0, d0)
    x0n = Xn @ m
    Xb = Xn - x0n[..., None]
    Pn = (Xb * S) @ Xb.mT + Q
    return x0n, 0.5 * (Pn + Pn.mT)


class ExtendedKalmanFilter(_DeviceFilter):
    """EKF with ``torch.func.jacfwd`` Jacobians of the augmented model, or
    Â/Ĉm on a LinModel (kalman.jl:908-1211)."""

    def __init__(self, model, i_ym=None, nint_u=0, nint_ym=None,
                 sigmaQ=None, sigmaR=None, sigmaQint_u=None, sigmaQint_ym=None,
                 sigmaP_0=None, sigmaPint_u_0=None, sigmaPint_ym_0=None,
                 Q_hat=None, R_hat=None, P0_hat=None, direct=True, device=None):
        self._init_filter(model, i_ym, nint_u, nint_ym, sigmaQ, sigmaR,
                          sigmaQint_u, sigmaQint_ym, sigmaP_0, sigmaPint_u_0,
                          sigmaPint_ym_0, Q_hat, R_hat, P0_hat, direct, device)

    def _correct(self, y0m, d0):
        # unlike the UKF, a NaN measurement goes on into kf_correct, which
        # skips the update (the reference's behaviour)
        if np.any(np.isnan(y0m)):
            warnings.warn(_NAN_SKIP)
        x0, P, y0m, d0, R = map(self._t, (self.x0_hat, self.P_hat, y0m, d0, self.R_hat))
        if isinstance(self.model, LinModel):
            Hm = self._t(self.Cm_hat)
        else:
            Hm = jacfwd(lambda xx: self.h_hat_m(xx, d0))(x0)
        self._store(*kf_correct(x0, P, self.h_hat_m(x0, d0), y0m, Hm, R))

    def _predict(self, u0, d0):
        x0, P, u0, d0, Q, fop_m_xop = map(
            self._t, (self.x0_hat, self.P_hat, u0, d0, self.Q_hat,
                      self.fop_hat - self.xop_hat))
        if isinstance(self.model, LinModel):
            F = self._t(self.A_hat)
        else:
            F = jacfwd(lambda xx: self.f_hat(xx, u0, d0))(x0)
        self._store(*kf_predict(self.f_hat(x0, u0, d0), P, F, Q, fop_m_xop))
