"""Batched Kalman estimation — lockstep fleets of SKF/KF estimators (torch
port of ``mpc_tpu/parallel/batch_kf.py``).

Thousands of independent sensor streams filtered in one step over a leading
lane axis.  Parameters are stacked over the DISTINCT estimators only and
read per lane through ``lane_ctrl`` (``grouped.py``, public lane order
``lane = r·n_d + c``); the per-stream state lives on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..estimators.kalman import (KalmanFilter, SteadyKalmanFilter, kf_correct,
                                 kf_predict)
from ..utils.config import resolve_device
from ..utils.lanes import mv, take
from .grouped import lane_ctrl as _lane_ctrl


class BatchedKalman:
    """Lockstep batch of SteadyKalmanFilter or KalmanFilter estimators.

    ``step(ym, u, d)`` runs one full filter cycle for every stream:
    correction with the current measurement, then prediction with the
    applied input.  Returns the corrected absolute state estimates (B, nx̂)
    on ``device`` (the GPU unless the caller asks for another), in ``dtype``
    (float64 unless ``torch.float32``).
    """

    def __init__(self, estimators, dtype=None, reps: int = 1, device=None):
        e0 = estimators[0]
        if not isinstance(e0, (SteadyKalmanFilter, KalmanFilter)):
            raise TypeError("BatchedKalman supports SteadyKalmanFilter and "
                            "KalmanFilter fleets")
        self.steady = isinstance(e0, SteadyKalmanFilter)
        if any(isinstance(e, SteadyKalmanFilter) != self.steady
               for e in estimators):
            raise TypeError("mixed estimator kinds in one fleet")
        self.device = resolve_device(device)
        self.dtype = torch.float64 if dtype is None else dtype
        self.n_distinct = len(estimators)
        self.reps = int(reps)
        self.B = self.n_distinct * self.reps
        self.nx_hat = e0.nx_hat
        self.nym = e0.nym
        self.nd = e0.model.nd

        def g(attr):
            return np.stack([np.asarray(getattr(e, attr), float)
                             for e in estimators])

        params = dict(A_hat=g("A_hat"), Bu_hat=g("Bu_hat"), Bd_hat=g("Bd_hat"),
                      Cm_hat=g("Cm_hat"), Ddm_hat=g("Ddm_hat"),
                      fop_m_xop=np.stack([e.fop_hat - e.xop_hat
                                          for e in estimators]),
                      xop_hat=g("xop_hat"),
                      yopm=np.stack([e.model.yop[np.asarray(e.i_ym, int)]
                                     for e in estimators]),
                      uop=np.stack([e.model.uop for e in estimators]),
                      dop=np.stack([e.model.dop for e in estimators]))
        if self.steady:
            params["K_hat"] = g("K_hat")
        else:
            params["Q_hat"] = g("Q_hat")
            params["R_hat"] = g("R_hat")
        state = dict(x0_hat=g("x0_hat"))
        if not self.steady:
            state["P_hat"] = g("P_hat")
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        # parameters stay distinct-stacked; the per-stream state is tiled
        self.params = {k: t(v) for k, v in params.items()}
        self.state = {k: t(np.tile(v, (self.reps,) + (1,) * (v.ndim - 1)))
                      for k, v in state.items()}
        # one lane map for the fleet's life
        self.lane_ctrl = _lane_ctrl(self.n_distinct, self.reps, self.device)

    def _tensor(self, a, width):
        t = torch.as_tensor(a, dtype=self.dtype, device=self.device)
        if t.shape != (self.B, width):
            raise ValueError(f"expected shape ({self.B}, {width}), got {tuple(t.shape)}")
        return t

    def step(self, ym, u, d=None):
        p, lc = self.params, self.lane_ctrl
        P = lambda k: take(p[k], lc)
        PM = lambda k, v: mv(p[k], v, lc)
        ym = self._tensor(ym, self.nym)
        u = self._tensor(u, p["uop"].shape[1])
        d0 = (torch.zeros(self.B, self.nd, dtype=self.dtype, device=self.device)
              if d is None else self._tensor(d, self.nd) - P("dop"))
        y0m = ym - P("yopm")
        u0 = u - P("uop")
        x0 = self.state["x0_hat"]
        y0m_pred = PM("Cm_hat", x0)
        if self.nd:
            y0m_pred = y0m_pred + PM("Ddm_hat", d0)
        if self.steady:
            x0c = x0 + PM("K_hat", y0m - y0m_pred)
            x0n = PM("A_hat", x0c) + PM("Bu_hat", u0)
            if self.nd:
                x0n = x0n + PM("Bd_hat", d0)
            self.state = dict(x0_hat=x0n + P("fop_m_xop"))
        else:
            A = P("A_hat")
            x0c, Pc = kf_correct(x0, self.state["P_hat"], y0m_pred, y0m,
                                 P("Cm_hat"), P("R_hat"))
            xr = PM("A_hat", x0c) + PM("Bu_hat", u0)
            if self.nd:
                xr = xr + PM("Bd_hat", d0)
            x0n, Pn = kf_predict(xr, Pc, A, P("Q_hat"), P("fop_m_xop"))
            self.state = dict(x0_hat=x0n, P_hat=Pn)
        return x0c + P("xop_hat")
