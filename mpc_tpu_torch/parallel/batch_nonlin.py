"""Batched NonLinMPC: a fleet of nonlinear MPC problems (counterpart of
``mpc_tpu/parallel/batch_nonlin.py``).

Every lane runs, in one step over the lane axis: the UKF correction, the
NonLinMPC SQP step (``controllers/nonlinmpc.py``: per-lane rollouts,
Jacobians and reduced QPs, the QPs through the hand-written Goldfarb–Idnani
or ADMM kernel) and the UKF prediction (``mpc_tpu`` ``batch_nonlin.py:
118-135``).  The template controller gives the structure (model, horizons,
weights, bounds); the lanes carry x̂0, P̂, lastu0 and the Z̃ warm starts.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..controllers.nonlinmpc import NonLinMPC
from ..estimators import UnscentedKalmanFilter
from ..utils.lanes import identity_lanes
from .mesh import LaneShards

STATE_KEYS = ("x0_hat", "P_hat", "lastu0", "Z_tilde")


class _Shard:
    """One device's lanes: their state and the UKF, the constants and the
    lane map on that device."""

    def __init__(self, template, B, dt, dev):
        est, model = template.estim, template.estim.model
        t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dt, device=dev)
        P0 = t(est.P0_hat)
        self.dev, self.B = dev, B
        self.state = dict(
            x0_hat=torch.zeros(B, est.nx_hat, dtype=dt, device=dev),
            P_hat=P0[None].repeat(B, 1, 1),
            lastu0=torch.zeros(B, model.nu, dtype=dt, device=dev),
            Z_tilde=torch.zeros(B, template.nZt, dtype=dt, device=dev))
        self.lane = identity_lanes(B, dev)
        self.corr, self.pred = est._kernels(dt, dev)
        self.h = torch.func.vmap(est.tensor_fns(dt, dev)[1])
        self.c = {k: t(v) for k, v in dict(
            m=est.m_hat, S=est.S_hat, R=est.R_hat, Q=est.Q_hat,
            fop_m_xop=est.fop_hat - est.xop_hat, yopm=model.yop[np.asarray(est.i_ym, int)],
            uop=model.uop, dop=model.dop, yop=model.yop).items()}
        self.y0 = torch.zeros(B, template._n_dual(), dtype=dt, device=dev)


class BatchedNonLinMPC:
    """A fleet of ``batch`` lanes of one NonLinMPC problem, on the
    template's device, in ``dtype`` (default float64; ``torch.float32`` is
    the reference's f32 fleet mode, with float64 GI slots).

    ``chunk`` keeps the reference's contract (clamped to ``batch``, which
    must be a multiple of it) but changes no answer: the reference chunks
    its lockstep SQP loop so that a chunk stops at its own slowest lane,
    while here all lanes go through ONE loop in which a lane whose exit test
    has failed keeps its carry and gets no QP iteration, as under the
    reference's ``vmap``.  ``mesh`` (``parallel/mesh.py``) shards the lanes
    over devices, each shard running its lanes' periods on its device with
    the template's params there; the fleet then lives on ``mesh[0]`` and
    ``chunk`` is ignored, as in the reference.
    """

    def __init__(self, template: NonLinMPC, batch: int, dtype=None, mesh=None,
                 chunk: int | None = None):
        est = template.estim
        if not isinstance(est, UnscentedKalmanFilter):
            raise TypeError("BatchedNonLinMPC runs the UnscentedKalmanFilter of its "
                            f"template, got {type(est).__name__}")
        self.t = template
        self.B = int(batch)
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        # the f32 UKF envelope: α < 0.1 puts ~1/α² sigma weights into the
        # mean and covariance sums, and f32 rounding then reaches degrees of
        # state error per correction (measured on the pendulum)
        if self.dtype == torch.float32 and est.alpha < 0.1:
            warnings.warn(
                f"UnscentedKalmanFilter(alpha={est.alpha:g}) in a float32 fleet: "
                f"sigma weights ~1/alpha^2 amplify f32 rounding to O(degrees) of "
                f"state error per step — construct the estimator with alpha >= 0.1 "
                f"for f32 fleets (the mean/cov are exact in alpha for linear "
                f"measurement maps).")
        self.chunk = None
        if chunk is not None and mesh is None:
            chunk = min(int(chunk), self.B)
            if self.B % chunk:
                raise ValueError(f"batch ({batch}) must be a multiple of chunk ({chunk})")
            if chunk < self.B:
                self.chunk = chunk
        self.mesh = None if mesh is None else LaneShards(mesh, self.B)
        self.device = template.device if mesh is None else self.mesh.home
        self.nu, self.nd = est.model.nu, est.model.nd
        if self.mesh is None:
            self._shards = [_Shard(template, self.B, self.dtype, self.device)]
        else:
            self._shards = [_Shard(template, self.mesh.size, self.dtype, d)
                            for d in self.mesh.devices]
        self._dzero = torch.zeros(self.B, self.nd, dtype=self.dtype, device=self.device)

    @property
    def state(self):
        """The lanes' state dict (``STATE_KEYS``, the lane axis first)."""
        if self.mesh is None:
            return self._shards[0].state
        return {k: self.mesh.gather([sh.state[k] for sh in self._shards]) for k in STATE_KEYS}

    @state.setter
    def state(self, st):
        if self.mesh is None:
            self._shards[0].state = st
            return
        parts = {k: self.mesh.split(v) for k, v in st.items()}
        for i, sh in enumerate(self._shards):
            sh.state = {k: parts[k][i] for k in st}

    def _period(self, sh, ym, ry, d):
        """One period of a shard's lanes: ``(u, J, iters, viol, stat)``; the
        shard's state advances."""
        t, c, Hp, st = self.t, sh.c, self.t.Hp, sh.state
        p = t._params_on(self.dtype, sh.dev)
        step = t._fns(self.dtype, sh.dev)[0]
        d0 = d - c["dop"] if self.nd else d
        x0c, Pc = sh.corr(st["x0_hat"], st["P_hat"], ym - c["yopm"], d0,
                          c["m"], c["S"], c["R"])
        yk = sh.h(x0c, d0) + c["yop"]
        u, Zt, _, _, J, viol, stat, iters, _, _, _ = step(
            p, x0c, st["lastu0"], d0, d0.repeat(1, Hp), ry.repeat(1, Hp),
            c["uop"].repeat(Hp).expand(sh.B, -1), yk, ry, st["Z_tilde"], sh.y0,
            sh.lane)
        lastu0 = u - c["uop"]
        x0n, Pn = sh.pred(x0c, Pc, lastu0, d0, c["m"], c["S"], c["Q"], c["fop_m_xop"])
        sh.state = dict(x0_hat=x0n, P_hat=Pn, lastu0=lastu0, Z_tilde=Zt)
        return u, J, iters, viol, stat

    def _as(self, a):
        return torch.as_tensor(a, dtype=self.dtype).to(self.device)

    def _split(self, x, dim=0):
        return [x] if self.mesh is None else self.mesh.split(x, dim)

    def _step_split(self, ym, ry, d):
        outs = [self._period(sh, *x) for sh, *x in zip(self._shards, ym, ry, d)]
        u, J, iters, viol, stat = (outs[0][i] if self.mesh is None
                                   else self.mesh.gather([o[i] for o in outs])
                                   for i in range(5))
        self.last_iters = torch.stack([iters.max(), iters.sum() // iters.shape[0]])
        self.last_viol = viol.max()
        self.last_kkt = torch.stack([viol, stat], 1)
        return u, J

    def step(self, ym, ry, d=None):
        """One period of the fleet: ``(u, J)`` (B, nu) and (B,) on the
        device.  ``last_iters`` holds [max, sum // B] of the lanes' SQP
        iterations, ``last_viol`` the worst lane's violation and
        ``last_kkt`` (B, 2) each lane's (violation, stationarity), the
        stationarity being that of the last exit test (the iterate before
        the returned one, as the reference's)."""
        d = self._dzero if d is None else self._as(d)
        return self._step_split(*(self._split(x) for x in (self._as(ym), self._as(ry), d)))

    def multistep(self, ym_seq, ry_seq, d_seq=None):
        """K periods (``ym_seq`` (K, B, nym), ``ry_seq`` (K, B, ny), ``d_seq``
        (K, B, nd) or None): ``(U, J)`` stacked (K, B, ·), the same as K
        ``step`` calls (one upload of the inputs, split on the lane axis,
        dim 1); ``last_*`` hold the final period's statistics."""
        ym_seq, ry_seq = self._as(ym_seq), self._as(ry_seq)
        K = ym_seq.shape[0]
        d_seq = (self._dzero.expand(K, -1, -1) if d_seq is None else self._as(d_seq))
        parts = [self._split(x, 1) for x in (ym_seq, ry_seq, d_seq)]
        U, J = [], []
        for k in range(K):
            u, j = self._step_split(*([x[k] for x in p] for p in parts))
            U.append(u)
            J.append(j)
        return torch.stack(U), torch.stack(J)
