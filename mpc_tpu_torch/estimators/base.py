"""StateEstimator base (counterpart of ``mpc_tpu/estimators/base.py``).

Construct-time matrices and the single-stream state live in NumPy float64
on the host.  The linear filters correct and predict there, as the
reference's single-stream path does (``mpc_tpu/estimators/kalman.py:
162-166``): a handful of tiny matrix products, cheaper on the host than a
round trip to a device.  A NonLinModel evaluates its ``f``/``h`` on its
device, and the unscented and extended filters run their steps on theirs.
The augmented dynamics ``f_hat``/``h_hat`` take NumPy arrays or tensors of
one sample and return the same kind, so that ``torch.func.vmap`` and
``jacfwd`` trace them.  The stateful ``preparestate``/``updatestate``/
``evaloutput`` reproduce the reference protocol (``estimator/execute.jl:
303-387``), ``direct`` timing included.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import LinModel, SimModel
from .construct import (augment_model, default_nint, init_estimstoch,
                        validate_ym)


def like(a, x):
    """Host array ``a`` in the kind of ``x``: as is beside NumPy, a tensor
    of ``x``'s dtype and device beside a tensor."""
    if not torch.is_tensor(x):
        return a
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


class StateEstimator:
    model: SimModel

    def _init_common(self, model, i_ym, nint_u, nint_ym, direct=True):
        self.model = model
        i_ym = list(range(model.ny)) if i_ym is None else [int(i) for i in np.atleast_1d(i_ym)]
        self.i_ym = i_ym
        self.nym, self.nyu = validate_ym(model, i_ym)
        if nint_ym is None:
            nint_ym = default_nint(model, i_ym, nint_u)
        As, Cs_u, Cs_y, nint_u, nint_ym = init_estimstoch(model, i_ym, nint_u, nint_ym)
        self.As, self.Cs_u, self.Cs_y = As, Cs_u, Cs_y
        self.nint_u, self.nint_ym = nint_u, nint_ym
        self.nxs = As.shape[0]
        self.nx_hat = model.nx + self.nxs
        (A_hat, Bu_hat, C_hat, Bd_hat, Dd_hat, xop_hat, fop_hat) = augment_model(
            model, As, Cs_u, Cs_y)
        self.A_hat, self.Bu_hat, self.C_hat = A_hat, Bu_hat, C_hat
        self.Bd_hat, self.Dd_hat = Bd_hat, Dd_hat
        self.xop_hat, self.fop_hat = xop_hat, fop_hat
        if C_hat is not None:
            self.Cm_hat = C_hat[i_ym, :]
            self.Ddm_hat = Dd_hat[i_ym, :]
        else:
            self.Cm_hat = self.Ddm_hat = None
        self.direct = bool(direct)
        self.prepared = False
        self.x0_hat = np.zeros(self.nx_hat)

    # ------------------------------------------------------------------
    # augmented dynamics (NumPy or tensors of one sample)
    def f_hat(self, x0_hat, u0, d0):
        """Augmented state update WITHOUT the +f̂op−x̂op term
        (estimator/execute.jl:64-109)."""
        model = self.model
        if isinstance(model, LinModel):
            r = like(self.A_hat, x0_hat) @ x0_hat + like(self.Bu_hat, x0_hat) @ u0
            if model.nd:
                r = r + like(self.Bd_hat, x0_hat) @ d0
            return r
        # the integrating states enter the plant through Cs_u (input
        # integrators) and propagate through As
        nx = model.nx
        xd, xs = x0_hat[:nx], x0_hat[nx:]
        xdn = model.f(xd, u0 + like(self.Cs_u, xs) @ xs, d0, model.p)
        xsn = like(self.As, xs) @ xs
        if torch.is_tensor(xdn):
            return torch.cat([xdn, xsn])
        return np.concatenate([xdn, xsn])

    def h_hat(self, x0_hat, d0):
        model = self.model
        if isinstance(model, LinModel):
            r = like(self.C_hat, x0_hat) @ x0_hat
            if model.nd:
                r = r + like(self.Dd_hat, x0_hat) @ d0
            return r
        nx = model.nx
        xd, xs = x0_hat[:nx], x0_hat[nx:]
        return model.h(xd, d0, model.p) + like(self.Cs_y, xs) @ xs

    def h_hat_m(self, x0_hat, d0):
        y = self.h_hat(x0_hat, d0)
        return y[list(self.i_ym)]

    def tensor_fns(self, dtype, device):
        """``(f_hat, h_hat)`` on tensors of one sample, with the matrices
        already on ``device`` in ``dtype``: the arithmetic of ``f_hat`` and
        ``h_hat``, for steps that ``torch.func.vmap`` batches (``like``
        would upload the matrices at every call).  Made once per dtype and
        device, and again after ``setmodel``."""
        key = (dtype, torch.device(device))
        cache = self.__dict__.setdefault("_tensor_fns", {})
        if key not in cache:
            t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=device)
            cache[key] = self._make_tensor_fns(t)
        return cache[key]

    def _make_tensor_fns(self, t):
        model = self.model
        if isinstance(model, LinModel):
            A, Bu, C, Bd, Dd = map(t, (self.A_hat, self.Bu_hat, self.C_hat,
                                       self.Bd_hat, self.Dd_hat))
            nd = model.nd

            def f_hat(x, u, d):
                r = A @ x + Bu @ u
                return r + Bd @ d if nd else r

            def h_hat(x, d):
                r = C @ x
                return r + Dd @ d if nd else r
            return f_hat, h_hat
        nx, Cs_u, As, Cs_y = model.nx, t(self.Cs_u), t(self.As), t(self.Cs_y)
        # products with the integrator blocks as sums of broadcast products:
        # forward-mode tangents of 0-dim float32 values can come out in
        # float64 (x[0] * 1.0), and a float32 matmul then refuses them
        dot = lambda M, v: (M * v).sum(-1)

        def f_hat(x, u, d):
            xs = x[nx:]
            return torch.cat([model._fd(x[:nx], u + dot(Cs_u, xs), d, model.p), dot(As, xs)])

        def h_hat(x, d):
            return model._h_user(x[:nx], d, model.p) + dot(Cs_y, x[nx:])
        return f_hat, h_hat

    # ------------------------------------------------------------------
    # hooks implemented by concrete estimators
    def _correct(self, y0m, d0):
        raise NotImplementedError

    def _predict(self, u0, d0):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # reference protocol (execute.jl:303-387)
    def _remove_op(self, ym, d, u=None):
        d = np.zeros(0) if d is None else np.asarray(d, float).ravel()
        if d.shape != (self.model.nd,):
            raise ValueError(f"d size {d.shape} ≠ meas. dist. size ({self.model.nd},)")
        d0 = d - self.model.dop
        y0m = None
        if ym is not None:
            ym = np.asarray(ym, float).ravel()
            if ym.shape != (self.nym,):
                raise ValueError(f"ym size {ym.shape} ≠ measured output size ({self.nym},)")
            y0m = ym - self.model.yop[self.i_ym]
        if u is not None:
            u = np.asarray(u, float).ravel()
            if u.shape != (self.model.nu,):
                raise ValueError(f"u size {u.shape} ≠ manip. input size ({self.model.nu},)")
            return y0m, d0, u - self.model.uop
        return y0m, d0

    def preparestate(self, ym=None, d=None):
        if self.direct:
            y0m, d0 = self._remove_op(ym if ym is not None else np.full(self.nym, np.nan), d)
            self._correct(y0m, d0)
        self.prepared = True
        return self.x0_hat + self.xop_hat

    def updatestate(self, u, ym=None, d=None):
        ymv = ym if ym is not None else np.full(self.nym, np.nan)
        y0m, d0, u0 = self._remove_op(ymv, d, u)  # dim errors before protocol
        if self.direct and not self.prepared:
            raise RuntimeError("preparestate must be called before updatestate with direct=True")
        if not self.direct:
            self._correct(y0m, d0)
        self._predict(u0, d0)
        self.prepared = False
        return self.x0_hat + self.xop_hat

    def evaloutput(self, d=None):
        d = np.zeros(0) if d is None else np.asarray(d, float).ravel()
        d0 = d - self.model.dop
        y0 = np.asarray(self.h_hat(self.x0_hat, d0), float)
        return y0 + self.model.yop

    __call__ = evaloutput

    def initstate(self, u, ym, d=None):
        """Steady-state init (execute.jl:208-259) for LinModel; else no-op."""
        y0m, d0, u0 = self._remove_op(ym, d, u)
        if isinstance(self.model, LinModel):
            rhs = self.Bu_hat @ u0 + self.fop_hat - self.xop_hat
            if self.model.nd:
                rhs = rhs + self.Bd_hat @ d0
            yrhs = y0m - self.Ddm_hat @ d0
            M = np.vstack([np.eye(self.nx_hat) - self.A_hat, self.Cm_hat])
            self.x0_hat = np.linalg.lstsq(M, np.concatenate([rhs, yrhs]), rcond=None)[0]
        self._init_cov()
        self.prepared = False
        return self.x0_hat + self.xop_hat

    def _init_cov(self):
        pass

    def setstate(self, x_hat, P_hat=None):
        x_hat = np.asarray(x_hat, float).ravel()
        if x_hat.shape != (self.nx_hat,):
            raise ValueError(f"x̂ size must be ({self.nx_hat},)")
        self.x0_hat = x_hat - self.xop_hat
        if P_hat is not None:
            self._set_cov(np.asarray(P_hat, float))
        return self

    def _set_cov(self, P_hat):
        raise ValueError(f"{type(self).__name__} does not compute an estimation "
                         "covariance matrix P̂.")

    # ------------------------------------------------------------------
    def setmodel(self, model=None, Qhat=None, Rhat=None, **alias):
        """Swap the LinModel data and augmented matrices at run time
        (``setmodel!``, estimator/execute.jl:440-544).  x̂ is rebased to the
        new operating point; dimensions and Ts must match."""
        Qhat = Qhat if Qhat is not None else alias.pop("Q_hat", None)
        Rhat = Rhat if Rhat is not None else alias.pop("R_hat", None)
        if alias:
            raise TypeError(f"unknown setmodel arguments {list(alias)}")
        old = self.model
        model = model if model is not None else old
        if model is not old:
            if not (isinstance(model, LinModel) and isinstance(old, LinModel)):
                raise ValueError("Only LinModel can be modified in setmodel")
            for a in ("Ts", "nu", "nx", "ny", "nd"):
                if getattr(model, a) != getattr(old, a):
                    raise ValueError(f"model.{a} must be {getattr(old, a)}")
        if Qhat is not None or Rhat is not None:
            # same validation as construction (2_test_state_estim.jl:1745-1746)
            from .construct import validate_covariances
            validate_covariances(
                self.nx_hat, self.nym,
                Qhat if Qhat is not None else self.Q_hat,
                Rhat if Rhat is not None else self.R_hat)
        self._update_model(model, Qhat, Rhat)
        self.__dict__.pop("_tensor_fns", None)
        return self

    def _update_model(self, model, Qhat, Rhat):
        """Default: re-augment the swapped model (setmodel_estimator!,
        estimator/execute.jl:524-544)."""
        self.model = model
        (A_hat, Bu_hat, C_hat, Bd_hat, Dd_hat, xop_hat, fop_hat) = augment_model(
            model, self.As, self.Cs_u, self.Cs_y, verify_obsv=False)
        x_abs = self.x0_hat + self.xop_hat
        self.A_hat, self.Bu_hat, self.C_hat = A_hat, Bu_hat, C_hat
        self.Bd_hat, self.Dd_hat = Bd_hat, Dd_hat
        self.xop_hat, self.fop_hat = xop_hat, fop_hat
        if C_hat is not None:
            self.Cm_hat = C_hat[np.asarray(self.i_ym, int), :]
            self.Ddm_hat = Dd_hat[np.asarray(self.i_ym, int), :]
        self.x0_hat = x_abs - xop_hat
        if Qhat is not None:
            self.Q_hat = np.asarray(Qhat, float)
        if Rhat is not None:
            self.R_hat = np.asarray(Rhat, float)

    def __repr__(self):
        return (f"{type(self).__name__} estimator with a sample time "
                f"Ts = {self.model.Ts} s:\n"
                f"├ model: {type(self.model).__name__}\n"
                f"├ direct: {self.direct}\n"
                f"└ dimensions:\n"
                f"  ├ {self.model.nu} manipulated inputs u "
                f"({sum(self.nint_u)} integrating states)\n"
                f"  ├ {self.nx_hat} estimated states x̂\n"
                f"  ├ {self.nym} measured outputs ym "
                f"({sum(self.nint_ym)} integrating states)\n"
                f"  ├ {self.nyu} unmeasured outputs yu\n"
                f"  └ {self.model.nd} measured disturbances d")
