"""The port's SymPy model bridge against mpc_tpu.utils.symbolic.

The cases of tests/test_symbolic.py, one for one: the same symbolic
pendulum through both bridges (same symbol orders, same rollout to 1e-10,
same linearization to 1e-9, a short NonLinMPC closed loop to 1e-6), the
same errors; besides, constant components (a number as an output, an ODE
dx = 0) under ``vmap``, ``jacfwd`` and ``jacrev`` in float32.
"""
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.utils.symbolic import nonlinmodel_from_sympy as ref_bridge
from mpc_tpu_torch.utils.symbolic import nonlinmodel_from_sympy as port_bridge

sp = pytest.importorskip("sympy")
torch.set_num_threads(1)
CPU = torch.device("cpu")


def bridge(pkg, *args, **kw):
    return ref_bridge(*args, **kw) if pkg is mr else port_bridge(*args, **kw, device=CPU)


def sym_pendulum(pkg):
    th, om, tau, g, L, K, m = sp.symbols("theta omega tau g L K m")
    odes = {th: om, om: -g / L * sp.sin(th) - K / m * om + tau / (m * L**2)}
    return bridge(pkg, odes, outputs=[th * 180 / sp.pi], Ts=0.1, inputs=[tau],
                  params={g: 9.8, L: 0.4, K: 1.2, m: 0.3})


def torch_pendulum():
    def f(x, u, d, par):
        g, L, K, m = par
        return torch.stack([x[1], -g / L * torch.sin(x[0]) - K / m * x[1]
                            + u[0] / (m * L ** 2)])
    h = lambda x, d, par: torch.stack([x[0] * 180 / torch.pi])
    return mt.NonLinModel(f, h, 0.1, 1, 2, 1, p=(9.8, 0.4, 1.2, 0.3),
                          solver=mt.RungeKutta(4), device=CPU)


def test_matches_reference_and_handwritten_rollout():
    (mref, iref), (mport, iport) = sym_pendulum(mr), sym_pendulum(mt)
    for k in ("x_syms", "u_syms", "d_syms", "p_syms"):
        assert [str(s) for s in iref[k]] == [str(s) for s in iport[k]], k
    assert [str(s) for s in iport["p_syms"]] == ["g", "L", "K", "m"]
    hand = torch_pendulum()
    rng = np.random.default_rng(0)
    for m in (mref, mport, hand):
        m.setstate(np.array([0.1, -0.2]))
    for k in range(20):
        u = rng.normal(size=1)
        y = [m.evaloutput() for m in (mref, mport, hand)]
        assert np.abs(y[0] - y[1]).max() < 1e-10 and np.abs(y[2] - y[1]).max() < 1e-10, k
        for m in (mref, mport, hand):
            m.updatestate(u)
    assert np.abs(mref.x0 - mport.x0).max() < 1e-10


def test_linearizes_and_controls():
    """The lambdified model linearizes (jacfwd) and drives a NonLinMPC."""
    lins = [pkg.linearize(sym_pendulum(pkg)[0], x=[np.pi, 0.0], u=[0.0]) for pkg in (mr, mt)]
    for k in ("A", "Bu", "C", "Dd"):
        diff = np.abs(np.asarray(getattr(lins[0], k)) - getattr(lins[1], k))
        assert np.max(diff, initial=0.0) < 1e-9, k
    # at the inverted equilibrium: one discrete eigenvalue outside the unit circle
    eig = np.abs(np.linalg.eigvals(np.asarray(lins[1].A)))
    assert eig.max() > 1.0 and eig.min() < 1.0
    res = []
    for pkg in (mr, mt):
        kw = {"device": CPU} if pkg is mt else {}
        estim = pkg.UnscentedKalmanFilter(sym_pendulum(pkg)[0], sigmaQ=[0.1, 1.0],
                                          sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1], **kw)
        ctrl = pkg.NonLinMPC(estim, Hp=10, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf, **kw)
        ctrl.setconstraint(umin=[-1.5], umax=[1.5])
        res.append(pkg.sim(ctrl, 6, [180.0]))
    for k in ("Y_data", "U_data", "X_data", "X_est_data"):
        assert np.abs(getattr(res[0], k) - getattr(res[1], k)).max() < 1e-6, k


def test_disturbance_and_errors():
    x1, u1, d1, a = sp.symbols("x1 u1 d1 a")
    models = [bridge(pkg, {x1: -a * x1 + u1 + d1}, outputs=[2 * x1], Ts=0.5, inputs=[u1],
                     disturbances=[d1], params={a: 0.5})[0] for pkg in (mr, mt)]
    assert (models[1].nu, models[1].nx, models[1].ny, models[1].nd) == (1, 1, 1, 1)
    x = [m.updatestate([1.0], d=[0.3]) for m in models]
    assert np.abs(x[0] - x[1]).max() < 1e-12
    assert np.abs(models[0].evaloutput(d=[0.3]) - models[1].evaloutput(d=[0.3])).max() < 1e-12
    for pkg in (mr, mt):
        # strictly-proper guard (reference mtk.md h! MethodError)
        with pytest.raises(ValueError, match="strictly proper"):
            bridge(pkg, {x1: -x1 + u1}, outputs=[x1 + u1], Ts=0.5, inputs=[u1])
        # unknown free symbol
        with pytest.raises(ValueError, match="free symbols"):
            bridge(pkg, {x1: -a * x1 + u1}, outputs=[x1], Ts=0.5, inputs=[u1])
        # non-symbol state key (algebraic / higher-order rejection)
        with pytest.raises(TypeError, match="first-order"):
            bridge(pkg, {sp.Derivative(x1): -x1 + u1}, outputs=[x1], Ts=0.5, inputs=[u1])


def test_constant_components_under_vmap_and_jacobians():
    """An output that is a number and an ODE dx = 0 come out as tensors of
    the state's dtype and batch shape, under vmap, jacfwd and jacrev."""
    x1, x2, u1, k = sp.symbols("x1 x2 u1 k")
    m, _ = port_bridge({x1: x2, x2: sp.Integer(0) * x1 + k * u1, }, outputs=[x1, 3],
                       Ts=0.5, inputs=[u1], params={k: 2.0}, device=CPU)
    m0, _ = port_bridge({x1: 0, x2: -x2}, outputs=[sp.Float(1.5)], Ts=0.5, inputs=[u1],
                        device=CPU)
    X = torch.randn(5, 2, dtype=torch.float32)
    U = torch.randn(5, 1, dtype=torch.float32)
    z = torch.zeros(0)
    for model in (m, m0):
        f = lambda x, u: model._fd(x, u, z, model.p)
        h = lambda x: model._h_user(x, z, model.p)
        fx = torch.func.vmap(f)(X, U)
        hx = torch.func.vmap(h)(X)
        assert fx.dtype == hx.dtype == torch.float32
        assert fx.shape == (5, 2) and hx.shape == (5, model.ny)
        A = torch.func.vmap(torch.func.jacfwd(f))(X, U)
        C = torch.func.vmap(torch.func.jacrev(h))(X)
        assert A.shape == (5, 2, 2) and C.shape == (5, model.ny, 2)
    assert torch.equal(torch.func.vmap(lambda x: m._h_user(x, z, m.p))(X)[:, 1],
                       torch.full((5,), 3.0))
    lin = mt.linearize(m0, x=[0.2, 0.1], u=[0.0])
    assert np.allclose(lin.C, 0.0) and np.isclose(lin.A[0, 0], 1.0)
    assert np.allclose(m0.evaloutput(), [1.5])
