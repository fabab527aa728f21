"""Batched ExplicitMPC: fleets of unconstrained analytic MPC (counterpart
of ``mpc_tpu/parallel/batch_explicit.py``).

A period of every lane is the SteadyKalmanFilter correction, the analytic
step of ``controllers/explicitmpc.py`` (Z̃ = −H̃⁻¹q̃, a few matrix-vector
products) and the prediction, over the lane axis on the device.  The
parameters are stacked over the distinct controllers and read per lane
through the public lane order ``lane = r·n_d + c``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..controllers.explicitmpc import _build_step
from ..utils.config import resolve_device
from ..utils.lanes import mv
from .batch import estimator_params
from .grouped import lane_ctrl


class BatchedExplicitMPC:
    """A fleet of ExplicitMPC controllers (one plant model each), ``reps``
    lanes of each: ``step(ym, ry, d)`` runs the period of every lane.  The
    fleet lives on ``device`` (the GPU unless the caller asks for another)
    in ``dtype`` (default float64)."""

    def __init__(self, controllers, dtype=None, reps: int = 1, device=None):
        c0 = controllers[0]
        for i, c in enumerate(controllers[1:], 1):
            m0, mi = c0.estim.model, c.estim.model
            key0 = (c0.Hp, c0.Hc, m0.nu, m0.ny, m0.nd)
            keyi = (c.Hp, c.Hc, mi.nu, mi.ny, mi.nd)
            if keyi != key0:
                raise ValueError(
                    f"BatchedExplicitMPC needs homogeneous controllers: "
                    f"controller 0 has (Hp, Hc, nu, ny, nd)={key0}, "
                    f"controller {i} has {keyi}")
        self.n_distinct = len(controllers)
        self.reps = int(reps)
        self.B = self.n_distinct * self.reps
        self.Hp, self.nu = c0.Hp, c0.estim.model.nu
        self.ny, self.nd = c0.estim.model.ny, c0.estim.model.nd
        self.dtype = torch.float64 if dtype is None else dtype
        self.device = dev = resolve_device(device)
        lc = lane_ctrl(self.n_distinct, self.reps, dev).long()
        per_lane = lambda a: torch.as_tensor(np.asarray(a, float), dtype=self.dtype,
                                             device=dev)[lc]
        self.params = {k: per_lane(np.stack([np.asarray(c.params[k]) for c in controllers]))
                       for k in c0.params}
        self.eparams = {k: per_lane(v) for k, v in estimator_params(controllers).items()}
        self.state = dict(
            x0_hat=torch.zeros(self.B, c0.estim.nx_hat, dtype=self.dtype, device=dev),
            lastu0=torch.zeros(self.B, self.nu, dtype=self.dtype, device=dev))
        self._step = _build_step(self.nu, self.nd)
        self._nxs = self.params["Ks"].shape[2]

    def step(self, ym, ry, d=None):
        """One period of every lane; returns u (B, nu) on the device."""
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype).to(self.device)
        B, Hp, nd = self.B, self.Hp, self.nd
        ym, ry = as_t(ym), as_t(ry)
        d = torch.zeros(B, nd, dtype=self.dtype, device=self.device) if d is None else as_t(d)
        ep, st = self.eparams, self.state
        d0 = d - ep["dop"] if nd else d
        x0 = st["x0_hat"]
        v = ym - ep["yop_m"] - mv(ep["Cm_hat"], x0)
        if nd:
            v = v - mv(ep["Ddm_hat"], d0)
        x0c = x0 + mv(ep["K_hat"], v)
        z = x0.new_zeros
        u, _, _ = self._step(self.params, x0c, st["lastu0"], d0, d0.repeat(1, Hp),
                             ry.repeat(1, Hp), self.params["Uop"], z(B, self._nxs),
                             z(B, self.ny))
        lastu0 = u - ep["uop"]
        x0n = mv(ep["A_hat"], x0c) + mv(ep["Bu_hat"], lastu0)
        if nd:
            x0n = x0n + mv(ep["Bd_hat"], d0)
        self.state = dict(x0_hat=x0n + ep["fop_m_xop"], lastu0=lastu0)
        return u
