"""Closed-loop / open-loop simulation harness (counterpart of
``mpc_tpu/sim.py``; reference src/plot_sim.jl).

``sim(plant_or_estim_or_mpc, N, ...)`` reproduces the reference's ``sim!``:
open-loop bump test for models, closed-loop setpoint simulation for
estimators and controllers with step/noise disturbance injection
(plot_sim.jl:253-319).  The plant and the estimator run on the host; a
controller's QP runs on the controller's device.  Results land in a
:class:`SimResult`; ``plot`` imports matplotlib when it is called.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .controllers.base import PredictiveController
from .models import SimModel


@dataclass
class SimResult:
    T_data: np.ndarray
    Y_data: np.ndarray            # (N, ny) plant outputs
    U_data: np.ndarray            # (N, nu) applied inputs
    Ry_data: np.ndarray | None = None
    D_data: np.ndarray | None = None
    X_data: np.ndarray | None = None
    Y_est_data: np.ndarray | None = None   # estimator/controller ŷ
    X_est_data: np.ndarray | None = None
    obj: object = None

    # short aliases used in tests/docs
    @property
    def y_data(self):
        return self.Y_data

    @property
    def u_data(self):
        return self.U_data

    def _auto_bounds(self, which, n):
        """Derive absolute constraint bounds from the simulated controller
        (mirrors the reference plot recipes' bound overlays,
        plot_sim.jl:362,484,745).  Returns (vmin, vmax) or (None, None)."""
        obj = self.obj
        params = getattr(obj, "params", None)
        if not isinstance(params, dict):
            return None, None
        try:
            if which == "y":
                lo = np.asarray(params["Y0min"])[:n] + np.asarray(params["Yop"])[:n]
                hi = np.asarray(params["Y0max"])[:n] + np.asarray(params["Yop"])[:n]
            else:
                lo = np.asarray(params["U0min"])[:n] + np.asarray(params["Uop"])[:n]
                hi = np.asarray(params["U0max"])[:n] + np.asarray(params["Uop"])[:n]
        except (KeyError, IndexError):
            return None, None
        big = 1e17
        lo = np.where(np.abs(lo) < big, lo, -np.inf)
        hi = np.where(np.abs(hi) < big, hi, np.inf)
        return lo, hi

    @staticmethod
    def _indices(flag, n):
        """Reference ``get_indices``: True → all, False/None → none,
        index collection → that per-signal selection (plot_sim.jl:377-380)."""
        if flag is True:
            return list(range(n))
        if flag is False or flag is None:
            return []
        return [int(i) for i in np.atleast_1d(flag)]

    def plot(self, file=None, *, ploty=True, plotu=True, plotd=False,
             plotx=False, plotyhat=None, plotxhat=False, plotxwithxhat=False,
             plotry=True, plotymax=True, plotymin=True,
             plotumax=True, plotumin=True, plotxhatmin=True, plotxhatmax=True,
             ymax=None, ymin=None, umax=None, umin=None):
        """Render the simulation — panels and options mirror the reference's
        Plots recipes (plot_sim.jl:362,484,745): ``ploty``/``plotu``/``plotd``/
        ``plotx``/``plotxhat`` accept True/False or an index list for
        per-signal selection; ``plotxwithxhat`` overlays x̂ on the plant
        states; bound overlays come from the simulated object's constraints.
        """
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        N, ny = self.Y_data.shape
        nu = self.U_data.shape[1]
        is_mpc = isinstance(self.obj, PredictiveController)
        if plotyhat is None:            # reference default: ŷ on estimator runs
            plotyhat = self.Y_est_data is not None and not is_mpc
        iy = self._indices(ploty, ny)
        iu = self._indices(plotu, nu)
        nd = self.D_data.shape[1] if self.D_data is not None else 0
        idd = self._indices(plotd, nd) if nd else []
        nx = self.X_data.shape[1] if self.X_data is not None else 0
        ix = self._indices(plotx or plotxwithxhat, nx) if nx else []
        nxh = self.X_est_data.shape[1] if self.X_est_data is not None else 0
        ixh = self._indices(plotxhat, nxh) if nxh else []
        auto_ymin, auto_ymax = self._auto_bounds("y", ny)
        auto_umin, auto_umax = self._auto_bounds("u", nu)
        ymin = ymin if ymin is not None else auto_ymin
        ymax = ymax if ymax is not None else auto_ymax
        umin = umin if umin is not None else auto_umin
        umax = umax if umax is not None else auto_umax
        # estimator x̂ bounds (MHE setconstraint; plot_sim.jl:468-470)
        xh_lo = xh_hi = None
        est = self.obj.estim if is_mpc else self.obj
        if ixh and hasattr(est, "X_min") and hasattr(est, "xop_hat"):
            big = 1e17
            lo = np.asarray(est.X_min)[:nxh] + np.asarray(est.xop_hat)
            hi = np.asarray(est.X_max)[:nxh] + np.asarray(est.xop_hat)
            xh_lo = np.where(np.abs(lo) < big, lo, -np.inf)
            xh_hi = np.where(np.abs(hi) < big, hi, np.inf)
        n_pan = len(iy) + len(iu) + len(idd) + len(ix) + len(ixh)
        if n_pan == 0:
            raise ValueError("nothing to plot: all panels deselected")
        fig, axes = plt.subplots(n_pan, 1, figsize=(7, 2 * n_pan),
                                 sharex=True)
        axes = np.atleast_1d(axes)
        k = 0
        for i in iy:
            ax = axes[k]; k += 1
            ax.plot(self.T_data, self.Y_data[:, i], label=f"$y_{{{i+1}}}$")
            if plotry and self.Ry_data is not None:
                ax.plot(self.T_data, self.Ry_data[:, i], "--",
                        label=f"$r_{{{i+1}}}$")
            if plotyhat and self.Y_est_data is not None:
                ax.plot(self.T_data, self.Y_est_data[:, i], ":",
                        label=f"$\\hat{{y}}_{{{i+1}}}$")
            if plotymax and ymax is not None and np.isfinite(ymax[i]):
                ax.axhline(ymax[i], color="r", ls=":")
            if plotymin and ymin is not None and np.isfinite(ymin[i]):
                ax.axhline(ymin[i], color="r", ls=":")
            ax.legend(loc="best")
        for j in iu:
            ax = axes[k]; k += 1
            ax.step(self.T_data, self.U_data[:, j], where="post",
                    label=f"$u_{{{j+1}}}$")
            if plotumax and umax is not None and np.isfinite(umax[j]):
                ax.axhline(umax[j], color="r", ls=":")
            if plotumin and umin is not None and np.isfinite(umin[j]):
                ax.axhline(umin[j], color="r", ls=":")
            ax.legend(loc="best")
        for j in idd:
            ax = axes[k]; k += 1
            ax.plot(self.T_data, self.D_data[:, j], label=f"$d_{{{j+1}}}$")
            ax.legend(loc="best")
        for j in ix:
            ax = axes[k]; k += 1
            ax.plot(self.T_data, self.X_data[:, j], label=f"$x_{{{j+1}}}$")
            if plotxwithxhat and self.X_est_data is not None and j < nxh:
                ax.plot(self.T_data, self.X_est_data[:, j], ":",
                        label=f"$\\hat{{x}}_{{{j+1}}}$")
            ax.legend(loc="best")
        for j in ixh:
            ax = axes[k]; k += 1
            ax.plot(self.T_data, self.X_est_data[:, j],
                    label=f"$\\hat{{x}}_{{{j+1}}}$")
            if plotxhatmin and xh_lo is not None and np.isfinite(xh_lo[j]):
                ax.axhline(xh_lo[j], color="r", ls=":")
            if plotxhatmax and xh_hi is not None and np.isfinite(xh_hi[j]):
                ax.axhline(xh_hi[j], color="r", ls=":")
            ax.legend(loc="best")
        axes[-1].set_xlabel("time (s)")
        fig.tight_layout()
        if file:
            fig.savefig(file, dpi=100)
        return fig


def sim(obj, N, ry=None, d=None, *, plant=None, u=None,
        u_step=None, u_noise=None, y_step=None, y_noise=None,
        d_step=None, d_noise=None, x_noise=None, x_0=None, x_hat_0=None,
        lastu=None, seed=0, progress=None):
    """Simulate ``obj`` for N steps.

    * SimModel: open-loop with constant input ``u`` (bump test).
    * StateEstimator / PredictiveController: closed loop against ``plant``
      (defaults to a copy of the internal model) with disturbance injection
      kwargs mirroring the reference's ``sim!``.

    ``progress``: opt-in progress reporting for long runs (the reference's
    ``@progressif`` / ProgressLogging, general.jl:301-310, used by
    plot_sim.jl:144,291): ``True`` prints a single-line percentage to
    stderr every ~5%%; a callable receives ``(k, N)`` after each step.
    """
    cb = _progress_cb(progress, N)
    if isinstance(obj, SimModel):
        # open-loop bump test accepts (N, u, d, x_0) like the reference
        # (plot_sim.jl:123 doctest); ry doubles as u positionally
        if u is None and ry is not None:
            u = ry
        return _sim_model(obj, N, u, d, x_0, cb)
    return _sim_closedloop(obj, N, ry, d, plant, u_step, u_noise, y_step,
                           y_noise, d_step, d_noise, x_noise, x_0, x_hat_0,
                           lastu, seed, cb)


def _progress_cb(progress, N):
    """Normalize the ``progress`` kwarg to a callable (or None)."""
    if progress is None or progress is False:
        return None
    if callable(progress):
        return progress
    import sys as _sys
    stride = max(1, N // 20)

    def cb(k, n):
        if (k + 1) % stride == 0 or k + 1 == n:
            print(f"\rsim: {100 * (k + 1) // n:3d}% ({k + 1}/{n})",
                  end="" if k + 1 < n else "\n", file=_sys.stderr,
                  flush=True)

    return cb


def _sim_model(model: SimModel, N, u, d, x_0=None, cb=None):
    u = np.ones(model.nu) if u is None else np.asarray(u, float).ravel()
    d = model.dop.copy() if d is None else np.asarray(d, float).ravel()
    if x_0 is not None:
        model.setstate(np.asarray(x_0, float))
    T = np.arange(N) * model.Ts
    Y = np.zeros((N, model.ny))
    U = np.tile(u, (N, 1))
    X = np.zeros((N, model.nx))
    for k in range(N):
        Y[k] = model.evaloutput(d if model.nd else None)
        X[k] = model.x0 + model.xop
        model.updatestate(u, d if model.nd else None)
        if cb is not None:
            cb(k, N)
    return SimResult(T, Y, U, D_data=np.tile(d, (N, 1)), X_data=X)


def _copy_model(model):
    import copy
    return copy.deepcopy(model)


def _sim_closedloop(est_mpc, N, ry, d, plant, u_step, u_noise, y_step,
                    y_noise, d_step, d_noise, x_noise, x_0, x_hat_0, lastu,
                    seed, cb=None):
    is_mpc = isinstance(est_mpc, PredictiveController)
    estim = est_mpc.estim if is_mpc else est_mpc
    model = estim.model
    plant = plant if plant is not None else _copy_model(model)
    nu, ny, nd = plant.nu, plant.ny, plant.nd
    Ts = plant.Ts
    rng = np.random.default_rng(seed)
    ry = np.asarray(ry, float).ravel() if ry is not None else model.yop.copy()
    d = np.asarray(d, float).ravel() if d is not None else model.dop.copy()
    z = lambda v, n: np.zeros(n) if v is None else np.asarray(v, float).ravel()
    u_step, u_noise = z(u_step, nu), z(u_noise, nu)
    y_step, y_noise = z(y_step, ny), z(y_noise, ny)
    d_step, d_noise = z(d_step, nd), z(d_noise, nd)
    x_noise = z(x_noise, plant.nx)
    if x_0 is not None:
        plant.setstate(np.asarray(x_0, float))
    lastu = model.uop.copy() if lastu is None else np.asarray(lastu, float).ravel()
    if x_hat_0 is not None:
        est_mpc.setstate(np.asarray(x_hat_0, float))
    else:
        est_mpc.initstate(lastu, plant.evaloutput(d if nd else None)[estim.i_ym],
                          d if nd else None)
    T = np.arange(N) * Ts
    Y = np.zeros((N, ny))
    Y_est = np.zeros((N, ny))
    U = np.zeros((N, nu))
    Ry = np.tile(ry, (N, 1))
    D = np.zeros((N, max(nd, 1)))
    X = np.zeros((N, plant.nx))
    X_est = np.zeros((N, estim.nx_hat))
    u = lastu.copy()
    for k in range(N):
        dk = d + d_step + d_noise * rng.normal(size=nd) if nd else np.zeros(0)
        y = plant.evaloutput(dk if nd else None) + y_step + y_noise * rng.normal(size=ny)
        ym = y[estim.i_ym]
        est_mpc.preparestate(ym, dk if nd else None)
        if is_mpc:
            u = est_mpc.moveinput(ry, dk if nd else None)
        Y[k] = y
        Y_est[k] = estim.evaloutput(dk if nd else None)
        U[k] = u
        if nd:
            D[k] = dk
        X[k] = plant.x0 + plant.xop
        X_est[k] = estim.x0_hat + estim.xop_hat
        up = u + u_step + u_noise * rng.normal(size=nu)
        plant.updatestate(up, dk if nd else None)
        plant.x0 = plant.x0 + x_noise * rng.normal(size=plant.nx)
        est_mpc.updatestate(u, ym, dk if nd else None)
        if cb is not None:
            cb(k, N)
    return SimResult(T, Y, U, Ry_data=Ry, D_data=D, X_data=X,
                     Y_est_data=Y_est, X_est_data=X_est, obj=est_mpc)
