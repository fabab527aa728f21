"""Exact linearization of NonLinModel via ``torch.func.jacfwd`` (counterpart
of ``mpc_tpu/models/linearize.py``; reference src/model/linearization.jl).

Builds a :class:`LinModel` whose matrices are the Jacobians of the
*discretized* dynamics and of ``h`` at an arbitrary ``(x, u, d)`` point,
with operating points ``uop=u, yop=h(x,d), dop=d, xop=x, fop=f(x,u,d)`` so
that non-equilibrium points work (``linearization.jl:123-205``).
"""
from __future__ import annotations

import numpy as np
from torch.func import jacfwd

from .linmodel import LinModel
from .nonlinmodel import NonLinModel


def get_linearization_func(model: NonLinModel):
    """``(x, u, d, p) -> (A, Bu, Bd, C, Dd, f, y)`` on tensors of one sample
    (cached on the model)."""
    fn = getattr(model, "_linfunc", None)
    if fn is not None:
        return fn
    fd, h = model._fd, model._h_user
    nx, ny, nd = model.nx, model.ny, model.nd

    def linfunc(x, u, d, p):
        A = jacfwd(lambda xx: fd(xx, u, d, p))(x)
        Bu = jacfwd(lambda uu: fd(x, uu, d, p))(u)
        Bd = jacfwd(lambda dd: fd(x, u, dd, p))(d) if nd else x.new_zeros(nx, 0)
        C = jacfwd(lambda xx: h(xx, d, p))(x)
        Dd = jacfwd(lambda dd: h(x, dd, p))(d) if nd else x.new_zeros(ny, 0)
        return A, Bu, Bd, C, Dd, fd(x, u, d, p), h(x, d, p)

    model._linfunc = linfunc
    return linfunc


def linearize(model, x=None, u=None, d=None) -> LinModel:
    """Linearize ``model`` at ``(x, u, d)`` and return a new LinModel.

    For a LinModel input the matrices are copied and only the operating
    points move (linearization.jl:208-213)."""
    u = model.uop.copy() if u is None else np.asarray(u, float).ravel()
    d = model.dop.copy() if d is None else np.asarray(d, float).ravel()
    x = (model.x0 + model.xop) if x is None else np.asarray(x, float).ravel()
    if isinstance(model, LinModel):
        lin = LinModel(model.A.copy(), model.Bu.copy(), model.C.copy(),
                       model.Bd.copy(), model.Dd.copy(), model.Ts)
        x0 = x - model.xop
        u0, d0 = u - model.uop, d - model.dop
        fx = np.asarray(model.f(x0, u0, d0, None), float) + model.fop
        y = np.asarray(model.h(x0, d0, None), float) + model.yop
        lin.setop(uop=u, yop=y, dop=d, xop=x, fop=fx)
        return lin
    linmodel = LinModel(np.zeros((model.nx, model.nx)), np.zeros((model.nx, model.nu)),
                        np.zeros((model.ny, model.nx)), np.zeros((model.nx, model.nd)),
                        np.zeros((model.ny, model.nd)), model.Ts)
    return linearize_(linmodel, model, x, u, d)


def linearize_(linmodel: LinModel, model: NonLinModel, x, u, d=None) -> LinModel:
    """In-place relinearization (reference ``linearize!``, linearization.jl:159)."""
    linfunc = get_linearization_func(model)
    u = model.uop.copy() if u is None else np.asarray(u, float).ravel()
    d = model.dop.copy() if d is None else np.asarray(d, float).ravel()
    u0, d0, x0 = u - model.uop, d - model.dop, np.asarray(x, float) - model.xop
    out = linfunc(*model._tensors(x0, u0, d0), model.p)
    A, Bu, Bd, C, Dd, fx, yx = (t.cpu().numpy() for t in out)
    linmodel.A[:] = A
    linmodel.Bu[:] = Bu
    linmodel.Bd[:] = Bd
    linmodel.C[:] = C
    linmodel.Dd[:] = Dd
    # fop = f(x0,u0,d0) + fop_nl  (linearization.jl:178-180)
    linmodel.setop(uop=u, yop=yx + model.yop, dop=d, xop=x, fop=fx + model.fop)
    linmodel.x0 = np.zeros(model.nx)
    return linmodel
