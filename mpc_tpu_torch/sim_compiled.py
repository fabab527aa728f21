"""Compiled closed loops: a whole N-step loop without the host stepping it
(counterpart of ``mpc_tpu/sim_compiled.py``).

``sim`` runs the plant and the estimator on the host and one controller
solve per period.  The loops here run plant, estimator and controller step
as one Python loop over tensors on the controller's device: every input of
the run (setpoints, disturbances, steps, the noise drawn on the host in
``sim``'s order) goes up in ONE copy at the start, each period writes its
outputs into preallocated (N, B, ·) device buffers, and ONE copy brings
them back at the end.  Nothing in the loop copies to the host; the only
host syncs are the ones the step has itself (the ADMM outer loop's exit
test, the SQP and Gauss–Newton exit tests), so a Goldfarb–Idnani loop
queues every period without waiting.  Every loop runs on a lane axis:
``run`` is one lane, ``run_fleet`` B lanes of one controller (the GPU
kernels group them into one block per controller), and
``CompiledClosedLoopFleet`` B lanes of B controllers.

* ``CompiledClosedLoop``: LinMPC (the lane-batched ``_build_step`` of
  ``controllers/linmpc.py``, ADMM or GI) with a SteadyKalmanFilter, a
  Luenberger or a KalmanFilter (P̂ carried), ``direct=True``, on a LinModel
  plant; ``CompiledClosedLoopFleet`` the same with one controller and plant
  per lane.
* ``CompiledSLLoop``: the SLMPC step on a NonLinModel plant.
* ``CompiledNonLinLoop``: the NonLinMPC SQP step with its UKF.
* ``CompiledMHELoop``: a measurement record through a MovingHorizonEstimator
  (window shift, arrival covariance, general window solve per period);
  ``CompiledMHEMPCLoop`` that estimator feeding a LinMPC.

The linear and MHE loops keep ``sweep`` and ``gi`` attributes, the ADMM
sweep and the GI solve their QPs go through (checks set the plain
versions); the SL and NonLin loops solve through their controller module's
``solve_qp_active``/``solve_qp``, as their fleets do.
``CompiledClosedLoop.run_fleet`` and ``CompiledSLLoop.run_fleet`` take a
``mesh`` (``parallel/mesh.py``): the noise is drawn on the host for every
lane as without it, then each shard uploads its lanes' inputs once, runs
their N periods on its device and is read back once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import vmap

from .controllers.linmpc import LinMPC
from .controllers.slmpc import SLMPC
from .estimators.kalman import (KalmanFilter, SteadyKalmanFilter, kf_correct,
                                kf_predict)
from .estimators.luenberger import Luenberger
from .estimators.mhe import upload
from .models import LinModel, NonLinModel
from .ops.admm_kernel import admm_sweep
from .ops.gi_kernel import gi_solve, slot_dtype_for
from .ops.qp import solve_qp
from .ops.qp_active import gi_state_init, solve_qp_active
from .parallel.grouped import lane_ctrl
from .parallel.mesh import LaneShards
from .sim import SimResult, _copy_model
from .utils.config import as_device
from .utils.lanes import identity_lanes, mv, take
from .utils.small_linalg import chol_small, inv_spd_small


def _vec(v, n):
    return np.zeros(n) if v is None else np.asarray(v, float).ravel()


def _setpoints(ry, default, B, N):
    """``ry`` of shape (ny,), (B, ny) or (B, N, ny) as (B, N, ny)."""
    ry = np.asarray(ry, float) if ry is not None else np.asarray(default, float).copy()
    if ry.ndim == 1:
        return np.tile(ry, (B, N, 1))
    if ry.ndim == 2:
        return np.tile(ry[:, None, :], (1, N, 1))
    return ry


def _run_noise(rng, N, nd, ny, nu, nx, d_noise, y_noise, u_noise, x_noise):
    """``sim``'s per-step draw order: d (when nd > 0), y, u, x."""
    eps_d, eps_y = np.zeros((N, nd)), np.zeros((N, ny))
    eps_u, eps_x = np.zeros((N, nu)), np.zeros((N, nx))
    for k in range(N):
        if nd:
            eps_d[k] = d_noise * rng.normal(size=nd)
        eps_y[k] = y_noise * rng.normal(size=ny)
        eps_u[k] = u_noise * rng.normal(size=nu)
        eps_x[k] = x_noise * rng.normal(size=nx)
    return eps_d, eps_y, eps_u, eps_x


def _fleet_noise(B, N, nd, ny, nu, nx, y_noise, u_noise=None, x_noise=None,
                 seed=0):
    """Per-lane (y, u, x) noise draws; lane i reproduces the single-loop
    ``run(seed=seed+i)`` RNG order, including the per-step d draw that
    ``sim()``/``run()`` consume whenever nd > 0 (even with zero d_noise)."""
    u_noise = np.zeros(nu) if u_noise is None else u_noise
    x_noise = np.zeros(nx) if x_noise is None else x_noise
    eps_y = np.zeros((B, N, ny)); eps_u = np.zeros((B, N, nu))
    eps_x = np.zeros((B, N, nx))
    for i in range(B):
        rng = np.random.default_rng(seed + i)
        for k in range(N):
            if nd:
                rng.normal(size=nd)     # consumed by run() when nd > 0
            eps_y[i, k] = y_noise * rng.normal(size=ny)
            eps_u[i, k] = u_noise * rng.normal(size=nu)
            eps_x[i, k] = x_noise * rng.normal(size=nx)
    return eps_y, eps_u, eps_x


def _inputs(dtype, device, per_step, per_lane):
    """ONE upload: ``per_step`` arrays (B, N, ·) come back time-major
    (N, B, ·), ``per_lane`` arrays as they are."""
    arrays = {k: np.ascontiguousarray(np.swapaxes(np.asarray(v, float), 0, 1))
              for k, v in per_step.items()}
    arrays.update(per_lane)
    return upload(arrays, dtype, device)


class _Record:
    """The outputs of a loop: one preallocated (N, B, Σwidths) device
    buffer, a column slice per output, read back in ONE copy."""

    def __init__(self, N, B, widths, dtype, device):
        self.cols, o = {}, 0
        for k, w in widths.items():
            self.cols[k] = (o, o + w)
            o += w
        self.buf = torch.empty(N, B, o, dtype=dtype, device=device)

    def put(self, k, **outs):
        for name, v in outs.items():
            a, b = self.cols[name]
            self.buf[k, :, a:b] = v.reshape(v.shape[0], -1)

    def host(self, *extra):
        """The outputs as NumPy (B, N, w) arrays, and each of ``extra``
        (tensors) flattened, from one copy."""
        flat = torch.cat([self.buf.reshape(-1)] + [e.reshape(-1).to(self.buf.dtype)
                                                   for e in extra])
        h = flat.cpu().numpy()
        n = self.buf.numel()
        out = np.swapaxes(h[:n].reshape(self.buf.shape), 0, 1)
        res = {k: out[:, :, a:b] for k, (a, b) in self.cols.items()}
        rest, o = [], n
        for e in extra:
            rest.append(h[o:o + e.numel()].reshape(tuple(e.shape)))
            o += e.numel()
        return res, rest


def _picker(i_ym, device):
    """``y ↦ y[:, i_ym]`` with the index on the device, made once: indexing
    with a host list would copy the list to the device (a host sync) every
    period."""
    idx = torch.as_tensor(np.asarray(i_ym, np.int64), device=device)
    return lambda y: y.index_select(1, idx)


def _lanes(cache, B, device, shared):
    """The loop's lane map for B lanes, made once per B and device: all
    zeros (one controller for every lane, the tiled map of one) or 0..B−1."""
    key = (B, torch.device(device))
    if key not in cache:
        cache[key] = lane_ctrl(1, B, device) if shared else identity_lanes(B, device)
    return cache[key]


def _sharded(mesh, B, per_step, per_lane, run):
    """``run(B_s, per_step_s, per_lane_s, device) -> record`` on each
    shard's lanes (host slices of the (B, ·) inputs), then the records read
    back, one copy a shard, and joined on the lane axis: ``(outputs,
    None)`` as ``_Record.host()``."""
    lanes = LaneShards(mesh, B)
    sl = lambda d: {k: lanes.split(v) for k, v in d.items()}
    ps, pl = sl(per_step), sl(per_lane)
    recs = [run(lanes.size, {k: v[s] for k, v in ps.items()},
                {k: v[s] for k, v in pl.items()}, dev)
            for s, dev in enumerate(lanes.devices)]
    outs = [r.host()[0] for r in recs]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}, None


def _plant_dict(plants):
    """The LinModel plant matrices, stacked over ``plants``."""
    g = lambda f: np.stack([np.asarray(f(p), float) for p in plants])
    return dict(A=g(lambda p: p.A), Bu=g(lambda p: p.Bu), Bd=g(lambda p: p.Bd),
                C=g(lambda p: p.C), Dd=g(lambda p: p.Dd),
                fop_m_xop=g(lambda p: p.fop - p.xop), xop=g(lambda p: p.xop),
                uop=g(lambda p: p.uop), yop=g(lambda p: p.yop), dop=g(lambda p: p.dop))


def _qp_state0(ctrl, B, device=None):
    """Initial GI cross-period operator state of B lanes (None for ADMM) on
    ``device`` (default the controller's); the operator stays in the
    solver's slot precision."""
    if ctrl.qp_solver != "active_set":
        return None
    return gi_state_init(ctrl.gi_slots, B, slot_dtype_for(ctrl.dtype, None),
                         ctrl.device if device is None else device)


def _lin_step(ctrl, p, lane, sweep, gi):
    """The LinMPC solve of one period over the lanes (the controller's
    lane-batched ``_build_step``): ``solve(x0c, d0, ry, st) -> (u, conv,
    solver state)`` from the corrected estimate and the carried solver
    state."""
    step, Hp, ny = ctrl._step, ctrl.Hp, ctrl.estim.model.ny
    nxs = p["Ks"].shape[2]
    R_hat_u = take(p["Uop"], lane)

    def solve(x0c, d0, ry, st):
        B = x0c.shape[0]
        z = lambda n: x0c.new_zeros(B, n)
        u, Z_t, y_dual, conv, _F, _obj, _it, rung, qps = step(
            p, x0c, st["lastu0"], d0, d0.repeat(1, Hp), ry.repeat(1, Hp), R_hat_u,
            z(nxs), z(ny), st["Z_tilde"], st["y_dual"], st["rho_rung"], lane, sweep,
            qp_state=st["qp_state"], gi=gi)
        return u, conv, dict(Z_tilde=Z_t, y_dual=y_dual, rho_rung=rung, qp_state=qps)
    return solve


def _solver_state(ctrl, B, dtype, device):
    """The LinMPC solver state a run starts from: zero warm starts, the
    ρ ladder's middle rung, an empty GI active set."""
    return dict(Z_tilde=torch.zeros(B, ctrl.nZt, dtype=dtype, device=device),
                y_dual=torch.zeros(B, ctrl.A_stack.shape[0], dtype=dtype, device=device),
                rho_rung=torch.full((B,), 4, dtype=torch.int32, device=device),
                qp_state=_qp_state0(ctrl, B, device))


class CompiledClosedLoop:
    """The closed loop of a LinMPC with a constant-gain estimator or a
    KalmanFilter, on a LinModel plant, as one loop over device tensors.

    >>> loop = CompiledClosedLoop(ctrl)            # plant = copy of model
    >>> res = loop.run(40, ry=[5.0, 0.0])          # one upload, one download
    """

    def __init__(self, ctrl: LinMPC, plant: LinModel | None = None):
        estim = ctrl.estim
        if not isinstance(estim, (SteadyKalmanFilter, Luenberger, KalmanFilter)):
            raise TypeError(
                "CompiledClosedLoop needs a constant-gain estimator "
                "(SteadyKalmanFilter or Luenberger) or a KalmanFilter; got "
                f"{type(estim).__name__}")
        self._kf = isinstance(estim, KalmanFilter)
        if not estim.direct:
            raise ValueError("CompiledClosedLoop requires direct=True "
                             "(filter form) estimators")
        if plant is None:
            plant = _copy_model(estim.model)
        if not isinstance(plant, LinModel):
            raise TypeError("plant must be a LinModel")
        self.ctrl, self.estim, self.plant = ctrl, estim, plant
        self.nu, self.ny, self.nd = plant.nu, plant.ny, plant.nd
        self.i_ym = np.asarray(estim.i_ym, int)
        self.device, self.dtype = ctrl.device, ctrl.dtype
        self._ym = _picker(self.i_ym, self.device)
        self.sweep, self.gi = admm_sweep, gi_solve
        e, model = estim, estim.model
        ep = dict(A_hat=e.A_hat, Bu_hat=e.Bu_hat, Cm_hat=e.Cm_hat, Ddm_hat=e.Ddm_hat,
                  Bd_hat=e.Bd_hat, C_hat=e.C_hat, Dd_hat=e.Dd_hat,
                  fop_m_xop=e.fop_hat - e.xop_hat, xop_hat=e.xop_hat,
                  yop=model.yop, uop=model.uop, dop=model.dop,
                  yop_m=np.asarray(model.yop)[self.i_ym])
        if self._kf:
            ep.update(Q_hat=e.Q_hat, R_hat=e.R_hat)
        else:
            ep["K_hat"] = e.K_hat
        self._ep = upload({k: np.asarray(v, float) for k, v in ep.items()},
                          self.dtype, self.device)
        self._pp = upload({k: v[0] for k, v in _plant_dict([plant]).items()},
                          self.dtype, self.device)
        self._lane_maps = {}

    def _loop(self, N, B, xs, st, p, lane, ep, pp, ctrl, ym=None):
        """N periods of B lanes: ``xs`` the (N, B, ·) inputs, ``st`` the
        carried state, every tensor on one device (``ym`` picks the
        measured outputs there; default this loop's device); returns the
        output record and the final state."""
        nd, is_kf = self.nd, self._kf
        dev = xs["ry"].device
        ym = self._ym if ym is None else ym
        solve = _lin_step(ctrl, p, lane, self.sweep, self.gi)
        nx_hat = ep["A_hat"].shape[-1]
        rec = _Record(N, B, dict(y=self.ny, u=self.nu, y_est=self.ny, x_p=pp["A"].shape[-1],
                                 x_hat=nx_hat, conv=1), self.dtype, dev)
        for k in range(N):
            dk = xs["d"][k]
            d0p = dk - pp["dop"] if nd else dk
            # plant output + sensor injection
            y = mv(pp["C"], st["x0_p"]) + pp["yop"] + xs["y_step"][k] + xs["eps_y"][k]
            if nd:
                y = y + mv(pp["Dd"], d0p)
            # estimator correction (direct form)
            d0 = dk - ep["dop"] if nd else dk
            y0m = ym(y) - ep["yop_m"]
            x0 = st["x0_hat"]
            y0m_pred = mv(ep["Cm_hat"], x0)
            if nd:
                y0m_pred = y0m_pred + mv(ep["Ddm_hat"], d0)
            if is_kf:
                x0c, Pc = kf_correct(x0, st["P_hat"], y0m_pred, y0m, ep["Cm_hat"],
                                     ep["R_hat"])
            else:
                x0c = x0 + mv(ep["K_hat"], y0m - y0m_pred)
            y_est = mv(ep["C_hat"], x0c) + ep["yop"]
            if nd:
                y_est = y_est + mv(ep["Dd_hat"], d0)
            # MPC solve
            u, conv, qst = solve(x0c, d0, xs["ry"][k], st)
            lastu0 = u - ep["uop"]
            # plant update with actuator injection + state noise
            u0p = (u + xs["u_step"][k] + xs["eps_u"][k]) - pp["uop"]
            x0p_n = mv(pp["A"], st["x0_p"]) + mv(pp["Bu"], u0p) + pp["fop_m_xop"]
            if nd:
                x0p_n = x0p_n + mv(pp["Bd"], d0p)
            x0p_n = x0p_n + xs["eps_x"][k]
            # estimator prediction (with the commanded u, like sim)
            x0n = mv(ep["A_hat"], x0c) + mv(ep["Bu_hat"], lastu0)
            if nd:
                x0n = x0n + mv(ep["Bd_hat"], d0)
            rec.put(k, y=y, u=u, y_est=y_est, x_p=st["x0_p"] + pp["xop"],
                    x_hat=x0c + ep["xop_hat"], conv=conv)
            new = dict(x0_p=x0p_n, lastu0=lastu0, **qst)
            if is_kf:
                x0n, new["P_hat"] = kf_predict(x0n, Pc, ep["A_hat"], ep["Q_hat"],
                                               ep["fop_m_xop"])
            else:
                x0n = x0n + ep["fop_m_xop"]
            new["x0_hat"] = x0n
            st = new
        return rec, st

    def _on(self, dev):
        """``(params, estimator, plant, measured-output picker)`` on
        ``dev``: this loop's own on its device, copies elsewhere."""
        p = self.ctrl._device_params()
        if as_device(dev) == as_device(self.device):
            return p, self._ep, self._pp, self._ym
        to = lambda d: {k: v.to(dev) for k, v in d.items()}
        return to(p), to(self._ep), to(self._pp), _picker(self.i_ym, dev)

    def _start(self, B, lanes_in, device=None):
        """The carried state at the start: the uploaded lane arrays and the
        solver's zeros (on ``device``, default this loop's)."""
        st = _solver_state(self.ctrl, B, self.dtype,
                           self.device if device is None else device)
        st.update({k: lanes_in[k] for k in ("x0_p", "x0_hat", "lastu0", "P_hat")
                   if k in lanes_in})
        return st

    # -- Monte-Carlo fleet: B independent closed loops in one loop --
    def run_fleet(self, B, N, ry=None, *, x_0=None, x_hat_0=None,
                  u_noise=None, y_noise=None, x_noise=None, d=None,
                  seed=0, mesh=None):
        """Simulate ``B`` independent N-step closed loops of this controller
        on one lane axis.

        Per-lane variation: noise realizations (lane i draws from
        ``default_rng(seed + i)``, identical to ``run(..., seed=seed+i)``),
        setpoints ``ry`` of shape (ny,), (B, ny) or (B, N, ny), initial
        plant states ``x_0`` (B, nx) and estimator states ``x_hat_0`` (B,
        nx̂).  Stateless: controller/plant objects are not advanced.
        Returns a dict of stacked trajectories (Y (B,N,ny), U, Y_est, X,
        X_hat, conv).  ``mesh`` (a sequence of devices) shards the lanes:
        each shard runs its lanes on its device, with one upload and one
        download."""
        estim, plant, model = self.estim, self.plant, self.estim.model
        nu, ny, nd, nx = self.nu, self.ny, self.nd, plant.nx
        B, N = int(B), int(N)
        Ry = _setpoints(ry, model.yop, B, N)
        d = np.asarray(d, float).ravel() if d is not None else model.dop.copy()
        eps_y, eps_u, eps_x = _fleet_noise(B, N, nd, ny, nu, nx, _vec(y_noise, ny),
                                           _vec(u_noise, nu), _vec(x_noise, nx), seed)
        lanes_in = dict(
            x0_p=(np.tile(np.asarray(plant.x0, float), (B, 1)) if x_0 is None
                  else np.asarray(x_0, float) - plant.xop),
            x0_hat=(np.tile(np.asarray(estim.x0_hat, float), (B, 1)) if x_hat_0 is None
                    else np.asarray(x_hat_0, float) - estim.xop_hat),
            lastu0=np.zeros((B, nu)))
        if self._kf:
            lanes_in["P_hat"] = np.tile(np.asarray(estim.P_hat, float), (B, 1, 1))
        per_step = dict(ry=Ry, d=np.tile(d, (B, N, 1)) if nd else np.zeros((B, N, 0)),
                        u_step=np.zeros((B, N, nu)), y_step=np.zeros((B, N, ny)),
                        eps_y=eps_y, eps_u=eps_u, eps_x=eps_x)

        def run(Bs, per_step, per_lane, dev):
            xs = _inputs(self.dtype, dev, per_step, per_lane)
            p, ep, pp, ym = self._on(dev)
            return self._loop(N, Bs, xs, self._start(Bs, xs, dev), p,
                              _lanes(self._lane_maps, Bs, dev, True), ep, pp, self.ctrl,
                              ym)[0]
        out, _ = (run(B, per_step, lanes_in, self.device).host() if mesh is None
                  else _sharded(mesh, B, per_step, lanes_in, run))
        return dict(Y=out["y"], U=out["u"], Y_est=out["y_est"], X=out["x_p"],
                    X_hat=out["x_hat"], conv=out["conv"][..., 0] > 0.5)

    def run(self, N, ry=None, d=None, *, u_step=None, u_noise=None,
            y_step=None, y_noise=None, d_step=None, d_noise=None,
            x_noise=None, x_0=None, x_hat_0=None, lastu=None, seed=0):
        """Run the loop; kwargs and RNG order mirror ``mpc_tpu_torch.sim``."""
        estim, plant, model = self.estim, self.plant, self.estim.model
        nu, ny, nd, nx = self.nu, self.ny, self.nd, plant.nx
        N = int(N)
        rng = np.random.default_rng(seed)
        ry = np.asarray(ry, float) if ry is not None else model.yop.copy()
        Ry = np.tile(ry, (N, 1)) if ry.ndim == 1 else ry
        d = np.asarray(d, float).ravel() if d is not None else model.dop.copy()
        u_step, y_step, d_step = _vec(u_step, nu), _vec(y_step, ny), _vec(d_step, nd)
        eps_d, eps_y, eps_u, eps_x = _run_noise(rng, N, nd, ny, nu, nx, _vec(d_noise, nd),
                                                _vec(y_noise, ny), _vec(u_noise, nu),
                                                _vec(x_noise, nx))
        dks = np.tile(d + d_step, (N, 1)) + eps_d if nd else np.zeros((N, 0))
        # initial states: the same host-side protocol as sim()
        if x_0 is not None:
            plant.setstate(np.asarray(x_0, float))
        lastu = model.uop.copy() if lastu is None else np.asarray(lastu, float).ravel()
        if x_hat_0 is not None:
            self.ctrl.setstate(np.asarray(x_hat_0, float))
        else:
            d00 = d if nd else None  # sim() inits with the nominal d
            self.ctrl.initstate(lastu, plant.evaloutput(d00)[self.i_ym], d00)
        lanes_in = dict(x0_p=np.asarray(plant.x0, float)[None],
                        x0_hat=np.asarray(estim.x0_hat, float)[None],
                        lastu0=(lastu - model.uop)[None])
        if self._kf:
            lanes_in["P_hat"] = np.asarray(estim.P_hat, float)[None]
        one = lambda a: np.asarray(a, float)[None]
        xs = _inputs(self.dtype, self.device,
                     dict(ry=one(Ry), d=one(dks), u_step=one(np.tile(u_step, (N, 1))),
                          y_step=one(np.tile(y_step, (N, 1))), eps_y=one(eps_y),
                          eps_u=one(eps_u), eps_x=one(eps_x)), lanes_in)
        rec, _ = self._loop(N, 1, xs, self._start(1, xs), self.ctrl._device_params(),
                            _lanes(self._lane_maps, 1, self.device, True), self._ep,
                            self._pp, self.ctrl)
        out = {k: v[0] for k, v in rec.host()[0].items()}
        T = np.arange(N) * plant.Ts
        D = dks if nd else np.zeros((N, 1))
        return SimResult(T, out["y"], out["u"], Ry_data=Ry, D_data=D,
                         X_data=out["x_p"], Y_est_data=out["y_est"],
                         X_est_data=out["x_hat"], obj=self.ctrl)


class CompiledClosedLoopFleet:
    """Heterogeneous compiled closed loops: B different (controller, plant)
    pairs, each an independent N-step loop, on one lane axis.

    Unlike ``CompiledClosedLoop.run_fleet`` (one controller, many noise
    realizations), every lane here has its own plant and controller
    matrices (stacked by ``parallel.stack_params``/``estimator_params``),
    for model-mismatch and tuning sweeps.  Constant-gain estimators only
    (the ``BatchedLinMPC`` feedback path).
    """

    def __init__(self, controllers, plants=None):
        from .parallel.batch import estimator_params, stack_params
        c0 = controllers[0]
        i_ym0 = list(c0.estim.i_ym)
        for c in controllers:
            if not isinstance(c.estim, (SteadyKalmanFilter, Luenberger)):
                raise TypeError(
                    "CompiledClosedLoopFleet needs constant-gain estimators "
                    f"(SteadyKalmanFilter/Luenberger); got {type(c.estim).__name__}")
            if not c.estim.direct:
                raise ValueError("CompiledClosedLoopFleet requires "
                                 "direct=True estimators")
            if list(c.estim.i_ym) != i_ym0:
                raise ValueError("all lanes must share the same i_ym "
                                 "measurement selection")
        if {(c.qp_solver, c.gi_max_active) for c in controllers} != {(c0.qp_solver,
                                                                     c0.gi_max_active)}:
            raise ValueError("a fleet's controllers must share qp_solver and "
                             "gi_max_active")
        if plants is None:
            plants = [_copy_model(c.estim.model) for c in controllers]
        if len(plants) != len(controllers):
            raise ValueError("need one plant per controller")
        self.ctrls, self.plants = controllers, plants
        self.B = len(controllers)
        self.nu, self.ny = plants[0].nu, plants[0].ny
        self.nd = plants[0].nd
        self.i_ym = np.asarray(c0.estim.i_ym, int)
        self.device, self.dtype = c0.device, c0.dtype
        self.sweep, self.gi = admm_sweep, gi_solve
        stack = lambda f: np.stack([np.asarray(f(c), float) for c in controllers])
        ep = estimator_params(controllers)
        ep.update(C_hat=stack(lambda c: c.estim.C_hat), Dd_hat=stack(lambda c: c.estim.Dd_hat),
                  xop_hat=stack(lambda c: c.estim.xop_hat),
                  yop=stack(lambda c: c.estim.model.yop))
        self._ep = upload({k: np.asarray(v, float) for k, v in ep.items()}, self.dtype,
                          self.device)
        self._pp_host = _plant_dict(plants)
        self._pp = upload(self._pp_host, self.dtype, self.device)

        def put(a):
            t = torch.as_tensor(a, device=self.device)
            return t.to(self.dtype) if t.is_floating_point() else t
        self._p = {k: put(v) for k, v in stack_params(controllers).items()}
        # the homogeneous loop's body, over the per-lane matrices
        proto = CompiledClosedLoop.__new__(CompiledClosedLoop)
        proto.ctrl, proto.estim, proto.plant = c0, c0.estim, plants[0]
        proto.nu, proto.ny, proto.nd, proto.i_ym = self.nu, self.ny, self.nd, self.i_ym
        proto.device, proto.dtype, proto._kf = self.device, self.dtype, False
        proto._ym = _picker(self.i_ym, self.device)
        self._proto = proto
        self._lane = identity_lanes(self.B, self.device)

    def run(self, N, ry=None, *, y_noise=None, x_0=None, d=None, seed=0):
        """Run all B loops for N steps.  ``ry``: (ny,), (B, ny) or
        (B, N, ny), default each lane's own model yop; ``d``: absolute
        measured disturbance, (nd,) or (B, nd), default each lane's dop;
        per-lane noise seeds ``seed + i``."""
        B, nu, ny, nd = self.B, self.nu, self.ny, self.nd
        N = int(N)
        c0 = self.ctrls[0]
        Ry = (np.tile(self._pp_host["yop"][:, None, :], (1, N, 1)) if ry is None
              else _setpoints(ry, None, B, N))
        nx_p = self.plants[0].nx
        eps_y, _, _ = _fleet_noise(B, N, nd, ny, nu, nx_p, _vec(y_noise, ny), seed=seed)
        if nd:
            if d is None:
                dlanes = self._pp_host["dop"]
            else:
                d = np.asarray(d, float)
                dlanes = np.tile(d, (B, 1)) if d.ndim == 1 else d
            dks = np.tile(dlanes[:, None, :], (1, N, 1))
        else:
            dks = np.zeros((B, N, 0))
        zeros = lambda n: np.zeros((B, N, n))
        x0p = (np.stack([np.asarray(p.x0, float) for p in self.plants]) if x_0 is None
               else np.asarray(x_0, float) - self._pp_host["xop"])
        lanes_in = dict(x0_p=x0p, lastu0=np.zeros((B, nu)),
                        x0_hat=np.stack([np.asarray(c.estim.x0_hat, float)
                                         for c in self.ctrls]))
        xs = _inputs(self.dtype, self.device,
                     dict(ry=Ry, d=dks, u_step=zeros(nu), y_step=zeros(ny), eps_y=eps_y,
                          eps_u=zeros(nu), eps_x=zeros(nx_p)), lanes_in)
        proto = self._proto
        proto.sweep, proto.gi = self.sweep, self.gi
        rec, _ = proto._loop(N, B, xs, proto._start(B, xs), self._p, self._lane,
                             self._ep, self._pp, c0)
        out, _ = rec.host()
        return dict(Y=out["y"], U=out["u"], Y_est=out["y_est"], X=out["x_p"],
                    X_hat=out["x_hat"], conv=out["conv"][..., 0] > 0.5)


def _nonlin_plant(plant, dtype, device):
    """A NonLinModel plant's batched ``fd``/``h`` and operating points."""
    p_pl = plant.p
    vf = vmap(lambda x, u, d: plant._fd(x, u, d, p_pl))
    vh = vmap(lambda x, d: plant._h_user(x, d, p_pl))
    pop = upload(dict(uop=plant.uop, dop=plant.dop, yop=plant.yop, xop=plant.xop,
                      fop_m_xop=plant.fop - plant.xop), dtype, device)
    return vf, vh, pop


class CompiledSLLoop:
    """The closed loop of successive-linearization MPC on a NonLinModel
    plant: the SLMPC step (jacfwd linearization → condensed matrices → QP →
    EKF) and the plant rollout, one loop over device tensors — the
    compiled form of the reference's fastest nonlinear pattern
    (docs/src/manual/nonlinmpc.md successive linearization)."""

    def __init__(self, ctrl: SLMPC, plant: NonLinModel | None = None):
        if not isinstance(ctrl, SLMPC):
            raise TypeError("CompiledSLLoop drives an SLMPC controller")
        if plant is None:
            plant = _copy_model(ctrl.model)
        if not isinstance(plant, NonLinModel):
            raise TypeError("plant must be a NonLinModel")
        self.ctrl, self.plant = ctrl, plant
        self.nu, self.ny, self.nd = plant.nu, plant.ny, plant.nd
        self.i_ym = np.asarray(ctrl.i_ym, int)
        self.device, self.dtype = ctrl.device, ctrl.dtype
        self._ym = _picker(self.i_ym, self.device)
        self._vf, self._vh, self._pop = _nonlin_plant(plant, self.dtype, self.device)
        self._xop_hat = torch.as_tensor(ctrl._xop_hat(), dtype=self.dtype,
                                        device=self.device)
        self._lane_maps = {}

    def _loop(self, N, B, xs, st, x0p):
        """N periods of B lanes on the device of the inputs ``xs``."""
        ctrl, nd, dev = self.ctrl, self.nd, xs["ry"].device
        step = ctrl._step_on(dev)
        if as_device(dev) == as_device(self.device):
            bounds, po, xop_hat, ym = ctrl.bounds(), self._pop, self._xop_hat, self._ym
        else:
            to = lambda d: {k: v.to(dev) for k, v in d.items()}
            bounds, po, ym = to(ctrl.bounds()), to(self._pop), _picker(self.i_ym, dev)
            xop_hat = self._xop_hat.to(dev)
        lane = _lanes(self._lane_maps, B, dev, False)
        rec = _Record(N, B, dict(y=self.ny, u=self.nu, x_p=self.plant.nx,
                                 x_hat=ctrl.nx_hat, conv=1), self.dtype, dev)
        for k in range(N):
            dk = xs["d"][k]
            d0p = dk - po["dop"] if nd else dk
            y = self._vh(x0p, d0p) + po["yop"] + xs["eps_y"][k]
            u, conv, st = step(st, ym(y), xs["ry"][k], dk, bounds, lane)
            u0p = (u + xs["u_step"][k] + xs["eps_u"][k]) - po["uop"]
            rec.put(k, y=y, u=u, conv=conv, x_p=x0p + po["xop"],
                    x_hat=st["x_hat"] + xop_hat)
            x0p = self._vf(x0p, u0p, d0p) + po["fop_m_xop"] + xs["eps_x"][k]
        return rec, st, x0p

    def run(self, N, ry=None, d=None, *, u_step=None, u_noise=None,
            y_noise=None, d_step=None, d_noise=None, x_noise=None,
            x_0=None, seed=0):
        """Run the SL-MPC loop; the controller's ``state`` and the plant's
        ``x0`` are advanced N periods, as stepping them would."""
        ctrl, plant = self.ctrl, self.plant
        nu, ny, nd, nx = self.nu, self.ny, self.nd, plant.nx
        N = int(N)
        rng = np.random.default_rng(seed)
        ry = np.asarray(ry, float) if ry is not None else plant.yop.copy()
        Ry = np.tile(ry, (N, 1)) if ry.ndim == 1 else ry
        d = np.asarray(d, float).ravel() if d is not None else plant.dop.copy()
        u_step, d_step = _vec(u_step, nu), _vec(d_step, nd)
        eps_d, eps_y, eps_u, eps_x = _run_noise(rng, N, nd, ny, nu, nx, _vec(d_noise, nd),
                                                _vec(y_noise, ny), _vec(u_noise, nu),
                                                _vec(x_noise, nx))
        dks = np.tile(d + d_step, (N, 1)) + eps_d if nd else np.zeros((N, 0))
        if x_0 is not None:
            plant.setstate(np.asarray(x_0, float))
        one = lambda a: np.asarray(a, float)[None]
        xs = _inputs(self.dtype, self.device,
                     dict(ry=one(Ry), d=one(dks), u_step=one(np.tile(u_step, (N, 1))),
                          eps_y=one(eps_y), eps_u=one(eps_u), eps_x=one(eps_x)),
                     dict(x0_p=one(plant.x0)))
        st0 = {k: v[None] for k, v in ctrl.state.items()}
        rec, stN, x0pN = self._loop(N, 1, xs, st0, xs["x0_p"])
        out, (x0p_h,) = rec.host(x0pN)
        ctrl.state = {k: v[0] for k, v in stN.items()}   # stepped N times
        plant.x0 = np.asarray(x0p_h[0], float)
        out = {k: v[0] for k, v in out.items()}
        T = np.arange(N) * plant.Ts
        D = dks if nd else np.zeros((N, 1))
        return SimResult(T, out["y"], out["u"], Ry_data=Ry, D_data=D,
                         X_data=out["x_p"], X_est_data=out["x_hat"])

    def run_fleet(self, B, N, ry=None, *, x_0=None, u_noise=None,
                  y_noise=None, x_noise=None, d=None, seed=0, mesh=None):
        """B independent nonlinear closed loops on one lane axis.

        Lane i reproduces ``run(..., seed=seed+i)`` (same RNG draw order).
        ``ry``: (ny,), (B, ny) or (B, N, ny); ``x_0``: (B, nx) absolute
        initial plant states.  All lanes start from the controller's current
        state.  Stateless (does not advance ``ctrl``/``plant``).  Returns a
        dict of stacked trajectories (Y, U, X, X_hat, conv).  ``mesh`` (a
        sequence of devices) shards the lanes: each shard runs its lanes on
        its device, with one upload and one download."""
        ctrl, plant = self.ctrl, self.plant
        nu, ny, nd, nx = self.nu, self.ny, self.nd, plant.nx
        B, N = int(B), int(N)
        Ry = _setpoints(ry, plant.yop, B, N)
        d = np.asarray(d, float).ravel() if d is not None else plant.dop.copy()
        eps_y, eps_u, eps_x = _fleet_noise(B, N, nd, ny, nu, nx, _vec(y_noise, ny),
                                           _vec(u_noise, nu), _vec(x_noise, nx), seed)
        x0p = (np.tile(np.asarray(plant.x0, float), (B, 1)) if x_0 is None
               else np.asarray(x_0, float) - plant.xop)
        per_step = dict(ry=Ry, d=np.tile(d, (B, N, 1)) if nd else np.zeros((B, N, 0)),
                        u_step=np.zeros((B, N, nu)), eps_y=eps_y, eps_u=eps_u, eps_x=eps_x)

        def run(Bs, per_step, per_lane, dev):
            xs = _inputs(self.dtype, dev, per_step, per_lane)
            st = {k: v.to(dev) for k, v in ctrl.fleet_state(Bs).items()}
            return self._loop(N, Bs, xs, st, xs["x0_p"])[0]
        out, _ = (run(B, per_step, dict(x0_p=x0p), self.device).host() if mesh is None
                  else _sharded(mesh, B, per_step, dict(x0_p=x0p), run))
        return dict(Y=out["y"], U=out["u"], X=out["x_p"], X_hat=out["x_hat"],
                    conv=out["conv"][..., 0] > 0.5)


class CompiledNonLinLoop:
    """The closed loop of a full NonLinMPC (the SQP step) with its
    UnscentedKalmanFilter on a NonLinModel plant — the compiled form of the
    reference's pendulum case (UKF feedback and one NLP a period).  The
    period is ``parallel.BatchedNonLinMPC``'s with the plant rollout added:
    one SQP loop over the lane axis, a lane frozen when its exit test says
    so (one host sync an SQP iteration)."""

    def __init__(self, ctrl, plant: NonLinModel | None = None):
        from .controllers.nonlinmpc import NonLinMPC
        from .estimators.kalman import UnscentedKalmanFilter
        if not isinstance(ctrl, NonLinMPC):
            raise TypeError("CompiledNonLinLoop drives a NonLinMPC")
        if not isinstance(ctrl.estim, UnscentedKalmanFilter):
            raise TypeError("CompiledNonLinLoop needs an "
                            "UnscentedKalmanFilter estimator (the NonLinModel "
                            "default)")
        if plant is None:
            plant = _copy_model(ctrl.estim.model)
        if not isinstance(plant, NonLinModel):
            raise TypeError("plant must be a NonLinModel")
        self.ctrl, self.plant = ctrl, plant
        self.nu, self.ny, self.nd = plant.nu, plant.ny, plant.nd
        self.i_ym = np.asarray(ctrl.estim.i_ym, int)
        self.device, self.dtype = ctrl.device, ctrl.dtype
        self._ym = _picker(self.i_ym, self.device)
        estim, model = ctrl.estim, ctrl.estim.model
        self._vf, self._vh, self._pop = _nonlin_plant(plant, self.dtype, self.device)
        self._corr, self._pred = estim._kernels(self.dtype, self.device)
        self._h_hat = vmap(estim.tensor_fns(self.dtype, self.device)[1])
        self._c = upload(dict(m=estim.m_hat, S=estim.S_hat, R=estim.R_hat, Q=estim.Q_hat,
                              fop_m_xop=estim.fop_hat - estim.xop_hat,
                              xop_hat=estim.xop_hat, yopm=model.yop[self.i_ym],
                              uop=model.uop, dop=model.dop, yop=model.yop),
                         self.dtype, self.device)
        self._lane_maps = {}

    def _loop(self, N, B, xs, st):
        ctrl, c, po, nd, Hp = self.ctrl, self._c, self._pop, self.nd, self.ctrl.Hp
        p = ctrl._params_on(self.dtype)
        step = ctrl._fns(self.dtype)[0]
        lane = _lanes(self._lane_maps, B, self.device, False)
        y0 = torch.zeros(B, ctrl._n_dual(), dtype=self.dtype, device=self.device)
        R_u = p["Uop"].expand(B, -1)
        rec = _Record(N, B, dict(y=self.ny, u=self.nu, J=1, x_hat=ctrl.estim.nx_hat,
                                 x_p=self.plant.nx, iters=1), self.dtype, self.device)
        for k in range(N):
            dk, ry = xs["d"][k], xs["ry"][k]
            d0p = dk - po["dop"] if nd else dk
            x0p = st["x0_p"]
            y = self._vh(x0p, d0p) + po["yop"] + xs["eps_y"][k]
            d0 = dk - c["dop"] if nd else dk
            # UKF correction
            x0c, Pc = self._corr(st["x0_hat"], st["P_hat"], self._ym(y) - c["yopm"], d0,
                                 c["m"], c["S"], c["R"])
            yk = self._h_hat(x0c, d0) + c["yop"]
            # SQP solve
            u, Zt, _, _, J, _viol, _stat, iters, _, _, _ = step(
                p, x0c, st["lastu0"], d0, d0.repeat(1, Hp), ry.repeat(1, Hp), R_u, yk, ry,
                st["Z_tilde"], y0, lane)
            lastu0 = u - c["uop"]
            # plant update, UKF prediction
            x0p_n = self._vf(x0p, u - po["uop"], d0p) + po["fop_m_xop"]
            x0n, Pn = self._pred(x0c, Pc, lastu0, d0, c["m"], c["S"], c["Q"],
                                 c["fop_m_xop"])
            rec.put(k, y=y, u=u, J=J, x_hat=x0c + c["xop_hat"], x_p=x0p + po["xop"],
                    iters=iters)
            st = dict(x0_p=x0p_n, x0_hat=x0n, P_hat=Pn, lastu0=lastu0, Z_tilde=Zt)
        return rec, st

    _STATE = ("x0_p", "x0_hat", "P_hat", "lastu0", "Z_tilde")

    def _lanes_in(self, B, x0p):
        ctrl, estim = self.ctrl, self.ctrl.estim
        tile = lambda a: np.tile(np.asarray(a, float)[None], (B,) + (1,) * np.ndim(a))
        return dict(x0_p=x0p, x0_hat=tile(estim.x0_hat), P_hat=tile(estim.P_hat),
                    lastu0=tile(ctrl.lastu0), Z_tilde=tile(ctrl.Z_tilde))

    def run(self, N, ry=None, d=None, *, y_noise=None, x_0=None, seed=0):
        """The N-step nonlinear closed loop (stateless w.r.t. the host
        controller/plant objects)."""
        plant, model = self.plant, self.ctrl.estim.model
        ny, nd = self.ny, self.nd
        N = int(N)
        rng = np.random.default_rng(seed)
        ry = np.asarray(ry, float) if ry is not None else plant.yop.copy()
        Ry = np.tile(ry, (N, 1)) if ry.ndim == 1 else ry
        d = np.asarray(d, float).ravel() if d is not None else model.dop.copy()
        eps_y = _vec(y_noise, ny) * rng.normal(size=(N, ny))
        dks = np.tile(d, (N, 1)) if nd else np.zeros((N, 0))
        if x_0 is not None:
            plant.setstate(np.asarray(x_0, float))
        one = lambda a: np.asarray(a, float)[None]
        xs = _inputs(self.dtype, self.device, dict(ry=one(Ry), d=one(dks), eps_y=one(eps_y)),
                     self._lanes_in(1, one(plant.x0)))
        rec, _ = self._loop(N, 1, xs, {k: xs[k] for k in self._STATE})
        out = {k: v[0] for k, v in rec.host()[0].items()}
        T = np.arange(N) * plant.Ts
        return SimResult(T, out["y"], out["u"], Ry_data=Ry,
                         D_data=dks if nd else np.zeros((N, 1)),
                         X_data=out["x_p"], X_est_data=out["x_hat"])

    def run_fleet(self, B, N, ry=None, *, x_0=None, y_noise=None, d=None, seed=0):
        """B independent NonLinMPC closed loops on one lane axis
        (stateless; lane i ≡ ``run(seed=seed+i)``).  Returns a dict of
        stacked trajectories (Y, U, X, X_hat, J); ``last_iters`` (B, N)
        holds each lane's SQP iterations."""
        plant, model = self.plant, self.ctrl.estim.model
        ny, nd = self.ny, self.nd
        B, N = int(B), int(N)
        Ry = _setpoints(ry, plant.yop, B, N)
        d = np.asarray(d, float).ravel() if d is not None else model.dop.copy()
        # run()'s vectorized draw: rng(seed+i).normal(size=(N, ny))
        y_noise = _vec(y_noise, ny)
        eps_y = np.stack([y_noise * np.random.default_rng(seed + i).normal(size=(N, ny))
                          for i in range(B)])
        dks = np.tile(d, (B, N, 1)) if nd else np.zeros((B, N, 0))
        x0p = (np.tile(np.asarray(plant.x0, float), (B, 1)) if x_0 is None
               else np.asarray(x_0, float) - plant.xop)
        xs = _inputs(self.dtype, self.device, dict(ry=Ry, d=dks, eps_y=eps_y),
                     self._lanes_in(B, x0p))
        rec, _ = self._loop(N, B, xs, {k: xs[k] for k in self._STATE})
        out, _ = rec.host()
        self.last_iters = out["iters"][..., 0].astype(int)
        return dict(Y=out["y"], U=out["u"], X=out["x_p"], X_hat=out["x_hat"],
                    J=out["J"][..., 0])


def _accept_cov(P_new, P_old, invP_old):
    """The finite/PD acceptance of an advanced arrival covariance (the
    reference's cholesky! probe, mhe/execute.jl:781-797): a lane keeps its
    old P̄ and P̄⁻¹ when the new one is not finite or not PD."""
    Ps = 0.5 * (P_new + P_new.mT)
    n = Ps.shape[-1]
    if n <= 8:
        L = chol_small(Ps)                   # non-PD → NaN in L
    else:
        L, info = torch.linalg.cholesky_ex(Ps)
        L = torch.where((info == 0)[..., None, None], L, torch.nan)
    ok = (torch.isfinite(Ps).all(-1).all(-1) & torch.isfinite(L).all(-1).all(-1))
    okm = ok[..., None, None]
    eye = torch.eye(n, dtype=Ps.dtype, device=Ps.device)
    Pg = torch.where(okm, Ps, eye)
    invP = inv_spd_small(Pg) if n <= 8 else torch.linalg.inv_ex(Pg)[0]
    return torch.where(okm, Ps, P_old), torch.where(okm, invP, invP_old)


def _make_mhe_step(mhe, dtype, device, solvers):
    """One MHE period over a lane axis, on tensors: add-data shift/append,
    arrival-covariance correct/predict with the finite/PD acceptance, the
    general window solve (``MovingHorizonEstimator._solve_fn``).  Returns
    ``step(st, y0m, d0, Nk) -> (new_st, x_new, J, ok)`` with ``Nk`` the
    window count before the period (a host int: it follows from the start
    state, min(Nk + 1, He)); the caller stores the next applied input in
    ``new_st["pending_u0"]`` (the next period's add-data needs it,
    mhe/execute.jl:44-84).  Per-slot bounds keep the full-window alignment
    (no end alignment while the window fills), as the reference's loop."""
    He, nx, ne = mhe.He, mhe.nx_hat, mhe.n_eps
    wo, is_ms = mhe._w_off, mhe.is_ms
    nd = mhe.model.nd
    ce = mhe.covestim
    cep = upload(dict(A=ce.A_hat, Bu=ce.Bu_hat, Bd=ce.Bd_hat, Cm=ce.Cm_hat,
                      Ddm=ce.Ddm_hat, Q=ce.Q_hat, R=ce.R_hat,
                      fop_m_xop=ce.fop_hat - ce.xop_hat), dtype, device)
    statics = upload({k: v for k, v in mhe._windows_params().items()
                      if k in ("invQ", "invR", "fop_m_xop", "Xmin", "Xmax", "Wmin",
                               "Wmax", "Vmin", "Vmax", "C_xmin", "C_xmax", "C_wmin",
                               "C_wmax", "C_vmin", "C_vmax")}, dtype, device)
    slots = torch.arange(He, device=device)
    lanes = {}

    def shift_Z(Z):
        Zs = Z.clone()
        if is_ms:
            Zs[:, ne + nx:ne + nx + (He - 1) * nx] = Z[:, ne + 2 * nx:ne + nx + He * nx]
        Zs[:, wo:wo + (He - 1) * nx] = Z[:, wo + nx:wo + He * nx]
        Zs[:, wo + (He - 1) * nx:] = 0.0
        return Zs

    def step(st, y0m, d0, Nk):
        B = y0m.shape[0]
        moving = Nk + 1 > He
        # --- add_data_windows!: shift when full, then append ---
        roll = (lambda W: torch.roll(W, -1, dims=1)) if moving else (lambda W: W.clone())
        Y0m_w, U0_w, X0_old_w, D0_w = (roll(st[k]) for k in ("Y0m", "U0", "X0_old", "D0"))
        Nk2 = He - 1 if moving else Nk
        Z = shift_Z(st["Z"]) if moving else st["Z"]
        Y0m_w[:, Nk2] = y0m
        U0_w[:, Nk2] = st["pending_u0"]
        X0_old_w[:, Nk2] = st["x0_hat"]
        D0_w[:, Nk2 + 1] = d0
        Nk3 = Nk2 + 1
        x_arr_prior = X0_old_w[:, 0]
        if moving:
            Z = Z.clone()
            Z[:, ne:ne + nx] = x_arr_prior
        P_arr, invP = st["P_arr"], st["invP"]
        # --- correct_cov! on the arrival slot (only when moving) ---
        if moving:
            y_pred = mv(cep["Cm"], x_arr_prior)
            if nd:
                y_pred = y_pred + mv(cep["Ddm"], D0_w[:, 0])
            _, Pc = kf_correct(x_arr_prior, P_arr, y_pred, Y0m_w[:, 0], cep["Cm"], cep["R"])
            P_arr, invP = _accept_cov(Pc, P_arr, invP)
        # --- window solve ---
        mask_w = (slots < Nk3).to(dtype)
        mask_v = (mask_w[:, None] > 0) & torch.isfinite(Y0m_w)
        p = dict(U=U0_w, D=D0_w, Y0m=torch.nan_to_num(Y0m_w), mask_w=mask_w,
                 mask_v=mask_v, invP=invP, x_arr_prior=x_arr_prior, **statics)
        if B not in lanes:
            lanes[B] = identity_lanes(B, device)
        Zt, x_new, _X, _Ym, J, ok, _it = mhe._solve_fn(p, Z, lanes[B], Nk3, *solvers())
        # --- update_cov! (predict) once the window is full ---
        if Nk3 == He:
            xr = mv(cep["A"], x_arr_prior) + mv(cep["Bu"], U0_w[:, 0])
            if nd:
                xr = xr + mv(cep["Bd"], D0_w[:, 0])
            _, Pn = kf_predict(xr, P_arr, cep["A"], cep["Q"], cep["fop_m_xop"])
            P_arr, invP = _accept_cov(Pn, P_arr, invP)
        new_st = dict(Y0m=Y0m_w, U0=U0_w, D0=D0_w, X0_old=X0_old_w, Z=Zt,
                      x0_hat=x_new, P_arr=P_arr, invP=invP, pending_u0=st["pending_u0"])
        return new_st, x_new, J, ok

    return step


def _mhe_state0(mhe):
    """The MHE's host state as lane arrays (a lane axis of 1)."""
    one = lambda a: np.asarray(a, float)[None]
    return dict(Y0m=one(mhe.Y0m_win), U0=one(mhe.U0_win), D0=one(mhe.D0_win),
                X0_old=one(mhe.X0_old_win), Z=one(mhe.Z_tilde), x0_hat=one(mhe.x0_hat),
                P_arr=one(mhe.P_arr), invP=one(mhe.invP_arr),
                pending_u0=one(getattr(mhe, "_pending_u0", np.zeros(mhe.model.nu))))


def _qp_solvers(loop):
    """The window solve's QP functions through the loop's GI solve and
    ADMM sweep."""
    return (functools.partial(solve_qp_active, solve=loop.gi),
            functools.partial(solve_qp, sweep=loop.sweep))


def _mhe_checks(mhe):
    from .estimators.mhe import MovingHorizonEstimator
    if not isinstance(mhe, MovingHorizonEstimator):
        raise TypeError("CompiledMHELoop drives a MovingHorizonEstimator")
    if not mhe.direct:
        raise ValueError("CompiledMHELoop supports direct=True MHE")
    if not isinstance(mhe.covestim, KalmanFilter):
        raise TypeError("CompiledMHELoop needs a KalmanFilter covestim "
                        "(the LinModel default)")


class CompiledMHELoop:
    """A whole measurement record through a MovingHorizonEstimator as one
    loop over device tensors: the windows, the warm start and the arrival
    covariance live on the device for the whole record; each period shifts
    the window when it is full (mhe/transcription.jl:936-1075), advances the
    arrival covariance on the oldest slot with the finite/PD acceptance
    (mhe/execute.jl:729-797), masks NaN measurements per sample and runs the
    general window solve.

    Supported: ``direct=True`` MHE with a KalmanFilter covestim.  Per-slot
    (capital-form) bounds are applied with full-window alignment: if the
    record starts before the window has filled AND time-varying bounds are
    set, the transient alignment differs from the host path's end-aligned
    form (the reference's behaviour).  Call ``initstate`` (or step the MHE)
    on the host first; the loop starts from the estimator's current state
    and does not advance it.  Runs in float64 on ``mhe.device``.
    """

    def __init__(self, mhe):
        _mhe_checks(mhe)
        self.mhe = mhe
        self.i_ym = np.asarray(mhe.i_ym, int)
        self.device, self.dtype = mhe.device, torch.float64
        self.sweep, self.gi = admm_sweep, gi_solve
        self._step = _make_mhe_step(mhe, self.dtype, self.device,
                                    lambda: _qp_solvers(self))

    def run(self, Ym, U, D=None):
        """Estimate a recorded sequence: Ym (N, nym) measurements, U (N, nu)
        the inputs applied AFTER each measurement, D (N, nd) measured
        disturbances.  Returns dict(X_hat (N, nx̂ absolute), J, ok)."""
        mhe = self.mhe
        model = mhe.model
        Ym = np.asarray(Ym, float)
        U = np.asarray(U, float)
        N = Ym.shape[0]
        nd = model.nd
        D = np.asarray(D, float) if D is not None else np.tile(model.dop, (N, 1))
        one = lambda a: np.asarray(a, float)[None]
        xs = _inputs(self.dtype, self.device,
                     dict(y0m=one(Ym - model.yop[self.i_ym]), u0=one(U - model.uop),
                          d0=one(D - model.dop if nd else np.zeros((N, 0)))),
                     _mhe_state0(mhe))
        st = {k: xs[k] for k in _mhe_state0(mhe)}
        rec = _Record(N, 1, dict(x0_hat=mhe.nx_hat, J=1, ok=1), self.dtype, self.device)
        Nk = int(mhe.Nk)
        for k in range(N):
            st, x_new, J, ok = self._step(st, xs["y0m"][k], xs["d0"][k], Nk)
            Nk = min(Nk + 1, mhe.He)
            st["pending_u0"] = xs["u0"][k]
            rec.put(k, x0_hat=x_new, J=J, ok=ok)
        out = {k: v[0] for k, v in rec.host()[0].items()}
        return dict(X_hat=out["x0_hat"] + np.asarray(mhe.xop_hat), J=out["J"][:, 0],
                    ok=out["ok"][:, 0] > 0.5)


class CompiledMHEMPCLoop:
    """MHE → LinMPC → plant, fused: the reference's ManualEstimator
    composition (manual.jl:99-128 docstring pattern: an MHE feeding a linear
    MPC through setstate) as one loop over device tensors.

    ``ctrl`` must be a LinMPC whose estimator has the same augmented-state
    layout as ``mhe`` (e.g. ``LinMPC(ManualEstimator(model))`` with matching
    integrator defaults): the MHE's deviation estimate goes straight into
    the condensed-QP solve each period.  Runs on the controller's device in
    its dtype.
    """

    def __init__(self, mhe, ctrl: LinMPC, plant: LinModel | None = None):
        from .estimators.mhe import MovingHorizonEstimator
        if not isinstance(mhe, MovingHorizonEstimator):
            raise TypeError("mhe must be a MovingHorizonEstimator")
        if not isinstance(ctrl, LinMPC):
            raise TypeError("ctrl must be a LinMPC")
        if ctrl.estim.nx_hat != mhe.nx_hat:
            raise ValueError(
                f"augmented-state mismatch: MHE nx̂={mhe.nx_hat}, controller "
                f"estimator nx̂={ctrl.estim.nx_hat} — construct both with the "
                "same integrator configuration")
        _mhe_checks(mhe)
        if plant is None:
            plant = _copy_model(mhe.model)
        if not isinstance(plant, LinModel):
            raise TypeError("plant must be a LinModel")
        self.mhe, self.ctrl, self.plant = mhe, ctrl, plant
        self.nu, self.ny, self.nd = plant.nu, plant.ny, plant.nd
        self.i_ym = np.asarray(mhe.i_ym, int)
        self.device, self.dtype = ctrl.device, ctrl.dtype
        self._ym = _picker(self.i_ym, self.device)
        self.sweep, self.gi = admm_sweep, gi_solve
        model = mhe.model
        self._mp = upload(dict(uop=model.uop, dop=model.dop, yop_m=model.yop[self.i_ym],
                               xop_hat=mhe.xop_hat), self.dtype, self.device)
        self._pp = upload({k: v[0] for k, v in _plant_dict([plant]).items()},
                          self.dtype, self.device)
        self._mhe_step = _make_mhe_step(mhe, self.dtype, self.device,
                                        lambda: _qp_solvers(self))
        self._lane_maps = {}

    def run(self, N, ry=None, d=None, *, y_noise=None, seed=0, lastu=None):
        """Run the fused MHE → MPC → plant loop for N steps.

        Starts from the MHE's and plant's current host state; call
        ``mhe.initstate(...)`` first.  Stateless (host objects not
        advanced)."""
        mhe, plant, model = self.mhe, self.plant, self.mhe.model
        ny, nd, nu = self.ny, self.nd, self.nu
        N = int(N)
        rng = np.random.default_rng(seed)
        ry = np.asarray(ry, float) if ry is not None else model.yop.copy()
        Ry = np.tile(ry, (N, 1)) if ry.ndim == 1 else ry
        d = np.asarray(d, float).ravel() if d is not None else model.dop.copy()
        eps_y = _vec(y_noise, ny) * rng.normal(size=(N, ny))
        dks = np.tile(d, (N, 1)) if nd else np.zeros((N, 0))
        lastu = model.uop.copy() if lastu is None else np.asarray(lastu, float).ravel()
        one = lambda a: np.asarray(a, float)[None]
        est0 = _mhe_state0(mhe)
        xs = _inputs(self.dtype, self.device, dict(ry=one(Ry), d=one(dks), eps_y=one(eps_y)),
                     dict(est0, x0_p=one(plant.x0), lastu0=one(lastu - model.uop)))
        est = {k: xs[k] for k in est0}
        st = dict(x0_p=xs["x0_p"], lastu0=xs["lastu0"],
                  **_solver_state(self.ctrl, 1, self.dtype, self.device))
        mp, pp = self._mp, self._pp
        solve = _lin_step(self.ctrl, self.ctrl._device_params(),
                          _lanes(self._lane_maps, 1, self.device, True), self.sweep, self.gi)
        rec = _Record(N, 1, dict(y=ny, u=nu, x_hat=mhe.nx_hat, J_mhe=1, ok=1, conv=1),
                      self.dtype, self.device)
        Nk = int(mhe.Nk)
        for k in range(N):
            dk = xs["d"][k]
            d0p = dk - pp["dop"] if nd else dk
            y = mv(pp["C"], st["x0_p"]) + pp["yop"] + xs["eps_y"][k]
            if nd:
                y = y + mv(pp["Dd"], d0p)
            d0 = dk - mp["dop"] if nd else dk
            # --- MHE window step ---
            est, x_new, J_mhe, ok = self._mhe_step(est, self._ym(y) - mp["yop_m"], d0, Nk)
            Nk = min(Nk + 1, mhe.He)
            # --- LinMPC solve from the MHE estimate ---
            u, conv, qst = solve(x_new, d0, xs["ry"][k], st)
            lastu0 = u - mp["uop"]
            est["pending_u0"] = lastu0
            # --- plant update ---
            x0p_n = mv(pp["A"], st["x0_p"]) + mv(pp["Bu"], u - pp["uop"]) + pp["fop_m_xop"]
            if nd:
                x0p_n = x0p_n + mv(pp["Bd"], d0p)
            rec.put(k, y=y, u=u, x_hat=x_new + mp["xop_hat"], J_mhe=J_mhe, ok=ok, conv=conv)
            st = dict(x0_p=x0p_n, lastu0=lastu0, **qst)
        out = {k: v[0] for k, v in rec.host()[0].items()}
        T = np.arange(N) * plant.Ts
        return SimResult(T, out["y"], out["u"], Ry_data=Ry,
                         D_data=dks if nd else np.zeros((N, 1)),
                         X_est_data=out["x_hat"])
