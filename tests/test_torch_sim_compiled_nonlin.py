"""The port's compiled nonlinear loops against mpc_tpu.sim_compiled.

The SLMPC and NonLinMPC cases of tests/test_sim_compiled.py, one for one
(the pendulum; SL-MPC with the Goldfarb–Idnani QP, NonLinMPC with its
default ADMM): each builds the ``mpc_tpu``
object and the port's (``device="cpu"``) with the same arguments, both run
the same call, and every returned array is compared — to 1e-7 for the
SL-MPC loop, to 1e-6 for NonLinMPC (the reference's own compiled-vs-host
bars; the NonLinMPC objective J to 1e-6·(1 + max|J|)).  Besides:
``CompiledSLLoop.run`` leaves the controller and the plant advanced as the
reference's does, lane i of ``run_fleet`` equals the port's own
``run(seed=seed+i)``, and ``mesh=`` raises.
"""
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu import sim_compiled as rs
from mpc_tpu_torch import sim_compiled as ps

torch.set_num_threads(1)
CPU = torch.device("cpu")
SL, NL = 1e-7, 1e-6
PAR = (9.8, 0.4, 1.2, 0.3)


def on_cpu(pkg):
    return {"device": CPU} if pkg is mt else {}


def pendulum(pkg):
    if pkg is mr:
        import jax.numpy as jnp

        def f(x, u, d, par):
            g, L, K, m = par
            return jnp.array([x[1], -g / L * jnp.sin(x[0]) - K / m * x[1]
                              + u[0] / (m * L ** 2)])
        h = lambda x, d, par: jnp.array([x[0] * 180 / jnp.pi])
    else:
        def f(x, u, d, par):
            g, L, K, m = par
            return torch.stack([x[1], -g / L * torch.sin(x[0]) - K / m * x[1]
                                + u[0] / (m * L ** 2)])
        h = lambda x, d, par: torch.stack([x[0] * 180 / torch.pi])
    return pkg.NonLinModel(f, h, 0.1, 1, 2, 1, p=PAR, solver=pkg.RungeKutta(4),
                           **on_cpu(pkg))


def slmpc(pkg):
    c = pkg.SLMPC(pendulum(pkg), Hp=20, Hc=2, Mwt=[0.5], Nwt=[2.5], sigmaQ=[0.1, 1.0],
                  sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1], qp_solver="active_set",
                  **on_cpu(pkg))
    c.setconstraint(umin=[-1.5], umax=[1.5])
    return c


def nonlinmpc(pkg):
    estim = pkg.UnscentedKalmanFilter(pendulum(pkg), sigmaQ=[0.1, 1.0], sigmaR=[5.0],
                                      nint_ym=[1], sigmaQint_ym=[0.1], **on_cpu(pkg))
    c = pkg.NonLinMPC(estim, Hp=10, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf,
                      **on_cpu(pkg))
    c.setconstraint(umin=[-1.5], umax=[1.5])
    return c


def loops(pkg):
    return rs if pkg is mr else ps


def same(a, b, tol, scaled=()):
    """Every array of two SimResults or dicts agrees to ``tol``; the keys in
    ``scaled`` to tol·(1 + max|·|)."""
    keys = list(a) if isinstance(a, dict) else ["T_data", "Y_data", "U_data", "Ry_data",
                                                "D_data", "X_data", "Y_est_data",
                                                "X_est_data"]
    get = (lambda r, k: r[k]) if isinstance(a, dict) else getattr
    for k in keys:
        x, y = get(a, k), get(b, k)
        assert (x is None) == (y is None), k
        if x is None:
            continue
        x, y = np.asarray(x, float), np.asarray(y, float)
        assert x.shape == y.shape, k
        bar = tol * (1 + np.abs(x).max()) if k in scaled else tol
        assert np.max(np.abs(x - y), initial=0.0) < bar, k


@pytest.fixture(scope="module")
def sl_runs():
    """Each package's SL-MPC loop after ``run(30, ry=[180])``."""
    out = {}
    for pkg in (mr, mt):
        loop = loops(pkg).CompiledSLLoop(slmpc(pkg))
        out[pkg] = (loop, loop.run(30, ry=[180.0]))
    return out


def test_sl_run_matches_reference(sl_runs):
    same(sl_runs[mr][1], sl_runs[mt][1], SL)
    assert abs(sl_runs[mt][1].y_data[-1, 0] - 180.0) < 5.0   # swing-up achieved


def test_sl_run_advances_controller_and_plant(sl_runs):
    """``run`` steps the controller's state and the plant's x0 N times, as
    the reference's does (and as N ``moveinput_closed`` calls would)."""
    (lr, _), (lp, _) = sl_runs[mr], sl_runs[mt]
    for k, v in lr.ctrl.state.items():
        assert np.abs(np.asarray(v) - lp.ctrl.state[k].numpy()).max() < SL, k
    assert np.abs(lr.plant.x0 - lp.plant.x0).max() < SL
    c, plant = slmpc(mt), pendulum(mt)
    for k in range(30):
        u, _ = c.moveinput_closed(plant.evaloutput(), [180.0])
        plant.updatestate(u)
    assert np.abs(plant.x0 - lp.plant.x0).max() < SL
    assert np.abs(c.getstate() - lp.ctrl.getstate()).max() < SL


def test_sl_run_with_noise_and_steps():
    kw = dict(ry=[170.0], y_noise=[1.0], u_noise=[0.05], u_step=[0.1],
              x_noise=[0.001, 0.002], x_0=[0.2, 0.0], seed=3)
    same(*(loops(pkg).CompiledSLLoop(slmpc(pkg)).run(12, **kw) for pkg in (mr, mt)), SL)


def test_sl_run_fleet_matches_reference_and_own_runs():
    B, N = 2, 15
    outs = [loops(pkg).CompiledSLLoop(slmpc(pkg)).run_fleet(B, N, ry=[180.0],
                                                            y_noise=[2.0], seed=5)
            for pkg in (mr, mt)]
    same(*outs, SL)
    for i in range(B):
        ri = ps.CompiledSLLoop(slmpc(mt)).run(N, ry=[180.0], y_noise=[2.0], seed=5 + i)
        assert np.abs(outs[1]["U"][i] - ri.u_data).max() < SL
        assert np.abs(outs[1]["Y"][i] - ri.y_data).max() < SL


@pytest.fixture(scope="module")
def nl_refs():
    """The reference's NonLinMPC loop: one object, so one compile each of
    ``run`` and ``run_fleet``."""
    return rs.CompiledNonLinLoop(nonlinmpc(mr))


def test_nonlin_run_matches_reference(nl_refs):
    N = 6
    res = [nl_refs.run(N, ry=[180.0]),
           ps.CompiledNonLinLoop(nonlinmpc(mt)).run(N, ry=[180.0])]
    same(*res, NL)


def test_nonlin_run_fleet_matches_reference_and_own_runs(nl_refs):
    B, N = 2, 5
    outs = [nl_refs.run_fleet(B, N, ry=[180.0], y_noise=[2.0], seed=4),
            ps.CompiledNonLinLoop(nonlinmpc(mt)).run_fleet(B, N, ry=[180.0],
                                                           y_noise=[2.0], seed=4)]
    same(*outs, NL, scaled=("J",))
    for i in range(B):
        ri = ps.CompiledNonLinLoop(nonlinmpc(mt)).run(N, ry=[180.0], y_noise=[2.0],
                                                      seed=4 + i)
        assert np.abs(outs[1]["U"][i] - ri.u_data).max() < NL
        assert np.abs(outs[1]["X_hat"][i] - ri.X_est_data).max() < NL


def test_rejections_and_mesh():
    for pkg in (mr, mt):
        L = loops(pkg)
        with pytest.raises(TypeError, match="SLMPC"):
            L.CompiledSLLoop(nonlinmpc(pkg))
        with pytest.raises(TypeError, match="NonLinModel"):
            L.CompiledSLLoop(slmpc(pkg), plant=pkg.LinModel(pkg.tf(1, [2, 1]), 0.1))
        with pytest.raises(TypeError, match="NonLinMPC"):
            L.CompiledNonLinLoop(slmpc(pkg))
        ekf = pkg.NonLinMPC(pkg.ExtendedKalmanFilter(pendulum(pkg), **on_cpu(pkg)), Hp=5,
                            **on_cpu(pkg))
        with pytest.raises(TypeError, match="UnscentedKalmanFilter"):
            L.CompiledNonLinLoop(ekf)
    # the reference's NonLin fleet takes no mesh; the SL fleet shards over one
    for L, c in ((rs, nonlinmpc(mr)), (ps, nonlinmpc(mt))):
        with pytest.raises(TypeError, match="mesh"):
            L.CompiledNonLinLoop(c).run_fleet(2, 3, mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        ps.CompiledSLLoop(slmpc(mt)).run_fleet(2, 3, mesh=object())
    a = ps.CompiledSLLoop(slmpc(mt)).run_fleet(2, 3, mesh=["cpu", "cpu"])
    b = ps.CompiledSLLoop(slmpc(mt)).run_fleet(2, 3)
    for k in b:
        assert np.allclose(a[k], b[k], rtol=0, atol=1e-12), k
