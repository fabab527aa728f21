"""The port's NonLinMPC against mpc_tpu.NonLinMPC: every scenario of
tests/test_nonlinmpc.py, at a shorter horizon and fewer periods where the
reference's compile time demands it.

Both packages build the controller from the same model and drive it with
the same measurements (the reference's plant, stepped with the reference's
u); the port runs in float64 on the CPU (the kernels' plain versions).
Bars: u, Z̃ and the getinfo arrays to 1e-6·(1 + max|·|): the SQP stops at a
step norm of 1e-8 (``sqp_tol``), so the two iterates agree to about that
and no closer where the loops stop at other iterations.  The SQP iteration
counts match on most periods: the
line search of a converged iterate compares merits that differ by round-off
(a step of 1e-16 rejected or not), and the retries it then spends on its
trust radius follow that coin on each side (ROADMAP §3), so the tests hold
the counts on at least half the periods and the answers everywhere.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from test_torch_nonlin import CPU, PEND_P, close, nonlin, pendulum

torch.set_num_threads(1)
UKF = dict(sigmaQ=[0.1, 1.0], sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1])
SWING = dict(Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf)


def xp(pkg):
    return jnp if pkg is mr else torch


def dev(pkg):
    return {} if pkg is mr else {"device": CPU}


def ukf(pkg, model, **kw):
    return pkg.UnscentedKalmanFilter(model, **UKF, **kw, **dev(pkg))


def swing(pkg, Hp=10, umax=1.5, **kw):
    """The manual's pendulum controller (test_nonlinmpc.py:52-63)."""
    c = pkg.NonLinMPC(ukf(pkg, pendulum(pkg)), Hp=Hp, **{**SWING, **kw}, **dev(pkg))
    return c.setconstraint(umin=[-umax], umax=[umax])


def rel(a, b, tol):
    a, b = np.asarray(a, float), np.asarray(b, float)
    close(a, b, tol * (1.0 + np.max(np.abs(b), initial=0.0)))


def run(cr, cp, N, ry, plant=None, d=None, tol=1e-6, info_keys=("J",)):
    """N closed-loop periods of both controllers on the reference's plant;
    returns the port's u and the two packages' SQP iteration counts."""
    plant = pendulum(mr) if plant is None else plant
    us, its = [], []
    for k in range(N):
        y = plant.evaloutput(d)
        cr.preparestate(y, d)
        cp.preparestate(y, d)
        ur, up = np.asarray(cr.moveinput(ry, d)), cp.moveinput(ry, d)
        assert isinstance(up, np.ndarray)
        rel(ur, up, tol)
        ir, ip = cr.getinfo(), cp.getinfo()
        for key in info_keys:
            rel(ir[key], ip[key], tol)
        its.append((ir["iters"], ip["iters"]))
        us.append(up)
        cr.updatestate(ur, y, d)
        cp.updatestate(up, y, d)
        plant.updatestate(ur, d)
    rel(cr.Z_tilde, cp.Z_tilde, tol)
    return np.array(us), np.array(its), plant


def most_equal(its):
    """The SQP iteration counts agree on at least half the periods."""
    assert np.mean(its[:, 0] == its[:, 1]) >= 0.5, its.T


def test_nonlinmpc_equals_linmpc_on_linear_plant():
    m = {pkg: pkg.LinModel(pkg.tf(3, [10, 1]), 1.0) for pkg in (mr, mt)}
    cr, cp = (pkg.NonLinMPC(m[pkg], Hp=10, Hc=2, **dev(pkg)) for pkg in (mr, mt))
    lin = mt.LinMPC(m[mt], Hp=10, Hc=2, device=CPU)
    y = [0.0]
    for k in range(5):
        for c in (cr, cp, lin):
            c.preparestate(y)
        ur, up, ul = cr.moveinput([3.0]), cp.moveinput([3.0]), lin.moveinput([3.0])
        rel(ur, up, 1e-6)
        assert np.allclose(up, ul, atol=1e-5), k
        for c, u in ((cr, ur), (cp, up), (lin, ul)):
            c.updatestate(u, y)


@pytest.mark.parametrize("transcription,qp_solver,N", [
    ("SingleShooting", "active_set", 12), ("MultipleShooting", "active_set", 12),
    ("SingleShooting", "admm", 6), ("MultipleShooting", "admm", 6),
    ("TrapezoidalCollocation", "active_set", 6), ("OrthogonalCollocation", "active_set", 5)])
def test_pendulum_swing_up_matches_reference(transcription, qp_solver, N):
    """test_nonlinmpc.py:52-78, :154-178, :277-303: the swing-up to 180°
    under each transcription (the collocation QR on both sides is LAPACK's,
    so the null bases agree; cuSOLVER on the card may pick other Householder
    signs, and the trust box is not rotation-invariant)."""
    make = {"SingleShooting": lambda p: p.SingleShooting(),
            "MultipleShooting": lambda p: p.MultipleShooting(),
            "TrapezoidalCollocation": lambda p: p.TrapezoidalCollocation(0),
            "OrthogonalCollocation": lambda p: p.OrthogonalCollocation(0, 3)}[transcription]
    Hp = 8 if transcription == "OrthogonalCollocation" else 10
    cr, cp = (swing(pkg, Hp=Hp, transcription=make(pkg), qp_solver=qp_solver)
              for pkg in (mr, mt))
    us, its, _ = run(cr, cp, N, [180.0], info_keys=("J", "U", "Yhat", "viol"))
    assert np.max(np.abs(us)) <= 1.5 + 1e-9
    most_equal(its)


def test_economic_cost_matches_reference():
    """test_nonlinmpc.py:79-104: EMPC with JE = Σu² (Ewt = 0.03)."""
    def make(pkg):
        JE = lambda Ue, Ye, De, p, eps: xp(pkg).sum(Ue[:-1] ** 2)
        return swing(pkg, Ewt=0.03, JE=JE)
    cr, cp = make(mr), make(mt)
    run(cr, cp, 8, [180.0], info_keys=("J", "JE"))


def test_custom_nonlinear_constraint_matches_reference():
    """test_nonlinmpc.py:107-123: gc keeps the predicted angles ≤ 110°
    (soft, Cwt = 1e5)."""
    Hp = 10

    def make(pkg):
        gc = lambda Ue, Ye, De, p, eps: Ye[1:] - 110.0 - eps * 10.0
        return swing(pkg, Hp=Hp, Cwt=1e5, gc=gc, nc=Hp)
    cr, cp = make(mr), make(mt)
    _, its, plant = run(cr, cp, 10, [100.0], info_keys=("J", "gc", "g"))
    most_equal(its)


def test_successive_linearization_matches_reference():
    """test_nonlinmpc.py:126-151: LinMPC + linearize_ + setmodel each step."""
    ctrls = {}
    for pkg in (mr, mt):
        lin = pkg.linearize(pendulum(pkg), x=[0.0, 0.0], u=[0.0])
        kf = pkg.KalmanFilter(lin, sigmaQ=[0.1, 1.0], sigmaR=[5.0], nint_ym=[1],
                              sigmaQint_ym=[0.1])
        c = pkg.LinMPC(kf, Hp=10, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf, **dev(pkg))
        ctrls[pkg] = (c.setconstraint(umin=[-1.5], umax=[1.5]), lin, pendulum(pkg))
    plant = pendulum(mr)
    u = np.zeros(1)
    for k in range(12):
        y = plant.evaloutput()
        us = []
        for pkg, (c, lin, model) in ctrls.items():
            x_hat = c.preparestate(y)
            pkg.linearize_(lin, model, x_hat[:2], u, np.zeros(0))
            c.setmodel(lin)
            us.append(np.asarray(c.moveinput([180.0])))
        rel(us[0], us[1], 1e-6)
        u = us[0]
        for pkg, (c, _, _) in ctrls.items():
            c.updatestate(u, y)
        plant.updatestate(u)


def test_collocation_requires_continuous_model():
    f = lambda x, u, d, p: 0.5 * x + u
    m = mt.NonLinModel(f, lambda x, d, p: x, 1.0, 1, 1, 1, solver=None, device=CPU)
    with pytest.raises(ValueError, match="Collocation"):
        mt.NonLinMPC(m, Hp=5, Hc=2, transcription=mt.TrapezoidalCollocation(), device=CPU)


def test_disturbance_matches_reference():
    """test_nonlinmpc.py:188-197: a measured disturbance channel (sim)."""
    res = {}
    for pkg in (mr, mt):
        m = nonlin(pkg, *(lambda x, u, d, p: 0.6 * x + u + 0.5 * d,) * 2,
                   *(lambda x, d, p: x,) * 2, 1.0, 1, 1, 1, 1, solver=None)
        c = pkg.NonLinMPC(m, Hp=10, Hc=2, Cwt=np.inf, **dev(pkg))
        res[pkg] = pkg.sim(c, 15, [2.0], d=[1.0])
    rel(res[mr].U_data, res[mt].U_data, 1e-8)
    assert np.allclose(res[mt].Y_data[-1], [2.0], atol=1e-2)


def test_custom_lincon_matches_reference_and_linmpc():
    """test_nonlinmpc.py:200-221: W = Wy·ŷ + Wu·u rows on a LinModel."""
    kw = dict(Hp=10, Hc=3, Wy=[[1.0]], Wu=[[0.5]])
    cr = mr.NonLinMPC(mr.LinModel(mr.tf(3, [10, 1]), 1.0), **kw)
    m = mt.LinModel(mt.tf(3, [10, 1]), 1.0)
    cp, lin = mt.NonLinMPC(m, **kw, device=CPU), mt.LinMPC(m, **kw, device=CPU)
    y = [0.0]
    for c in (cr, cp, lin):
        c.setconstraint(wmax=[2.2])
    for k in range(4):
        for c in (cr, cp, lin):
            c.preparestate(y)
        ur, up, ul = cr.moveinput([5.0]), cp.moveinput([5.0]), lin.moveinput([5.0])
        rel(ur, up, 1e-6)
        assert np.allclose(up, ul, atol=2e-4), (k, up, ul)
        for c, u in ((cr, ur), (cp, up), (lin, ul)):
            c.updatestate(u, y)


def test_custom_lincon_wu_nonlinear_plant():
    """test_nonlinmpc.py:224-242: a Wu-only row caps u on the pendulum; Wy
    is refused on a NonLinModel."""
    us = {}
    for pkg in (mr, mt):
        c = pkg.NonLinMPC(pendulum(pkg), Hp=10, Wu=[[1.0]], **SWING, **dev(pkg))
        c.setconstraint(umin=[-5], umax=[5], wmax=[0.8])
        c.preparestate([0.0])
        us[pkg] = c.moveinput([180.0])
    rel(us[mr], us[mt], 1e-8)
    assert us[mt][0] <= 0.8 + 1e-5
    with pytest.raises(ValueError, match="Wy"):
        mt.NonLinMPC(pendulum(mt), Hp=5, Wy=[[1.0]], device=CPU)


def test_setmodel_matches_fresh_controller():
    """test_nonlinmpc.py:245-274: setmodel on a LinModel-backed controller
    equals one built on the new model and keeps the bounds; a NonLinModel
    refuses the swap."""
    z = np.zeros((1, 0))
    m1 = mt.LinModel(np.array([[0.5]]), np.array([[1.0]]), np.array([[1.0]]), z, z, 1.0)
    m2 = mt.LinModel(np.array([[0.8]]), np.array([[0.5]]), np.array([[1.0]]), z, z, 1.0)
    a = mt.NonLinMPC(m1, Hp=8, Hc=2, device=CPU).setconstraint(umax=[1.5])
    a.setmodel(m2)
    b = mt.NonLinMPC(m2, Hp=8, Hc=2, device=CPU).setconstraint(umax=[1.5])
    ref = mr.NonLinMPC(mr.LinModel(m2.A, m2.Bu, m2.C, z, z, 1.0), Hp=8, Hc=2)
    ref.setconstraint(umax=[1.5])
    y = [0.0]
    for k in range(4):
        for c in (a, b, ref):
            c.preparestate(y)
        u1, u2, u3 = a.moveinput([2.0]), b.moveinput([2.0]), ref.moveinput([2.0])
        close(u1, u2, 1e-10)
        rel(u3, u2, 1e-6)
        assert u1[0] <= 1.5 + 1e-8
        for c, u in ((a, u1), (b, u2), (ref, u3)):
            c.updatestate(u, y)
    nm = mt.NonLinModel(lambda x, u, d, p: 0.5 * x + u, lambda x, d, p: x, 1.0, 1, 1, 1,
                        solver=None, device=CPU)
    with pytest.raises(ValueError):
        mt.NonLinMPC(nm, Hp=5, device=CPU).setmodel(m2)


def test_float32_collocation_and_weight_swap():
    """test_nonlinmpc.py:306-334: collocation constants follow the float32
    iterate; a weight-only setmodel keeps the step."""
    for tr in (mt.TrapezoidalCollocation(), mt.OrthogonalCollocation(no=2)):
        c = mt.NonLinMPC(pendulum(mt), Hp=6, Hc=2, transcription=tr, sqp_iters=2,
                         dtype=torch.float32, device=CPU)
        c.preparestate([0.0])
        u = c.moveinput([30.0])
        assert np.isfinite(u).all()
        step = c._fns(torch.float32)[0]
        assert c._fns(torch.float32)[0] is step
    c = mt.NonLinMPC(mt.LinModel(mt.tf(3, [10, 1]), 1.0), Hp=8, Hc=2, device=CPU)
    c.preparestate([0.0])
    c.moveinput([3.0])
    step = c._fns(torch.float64)[0]
    c.setmodel(Mwt=[2.0])
    assert c._fns(torch.float64)[0] is step
    r = mr.NonLinMPC(mr.LinModel(mr.tf(3, [10, 1]), 1.0), Hp=8, Hc=2)
    r.preparestate([0.0])
    r.moveinput([3.0])
    r.setmodel(Mwt=[2.0])
    for x in (c, r):
        x.preparestate([0.0])
    rel(r.moveinput([3.0]), c.moveinput([3.0]), 1e-6)


def test_initstate_resets_coldstart():
    c = mt.NonLinMPC(pendulum(mt), Hp=6, Hc=2, transcription=mt.MultipleShooting(),
                     sqp_iters=4, device=CPU)
    c.preparestate([10.0])
    c.moveinput([90.0])
    assert c._solved_once
    c.initstate([0.0], [10.0])
    assert not c._solved_once and c.y_dual is None


def test_argument_validation():
    """test_nonlinmpc.py:348-357 and :510-515."""
    m = pendulum(mt)
    with pytest.raises(ValueError, match="gc"):
        mt.NonLinMPC(m, Hp=5, Hc=2, nc=2, device=CPU)
    with pytest.raises(ValueError, match="gc"):
        mt.NonLinMPC(m, Hp=5, Hc=2, gc=lambda *a: torch.zeros(1), device=CPU)
    with pytest.raises(ValueError, match="JE"):
        mt.NonLinMPC(m, Hp=5, Ewt=1.0, JE=lambda Ue, Ye: 0.0, device=CPU)
    with pytest.raises(ValueError, match="hessian"):
        mt.NonLinMPC(m, Hp=4, hessian="bogus", device=CPU)
    with pytest.raises(ValueError, match="qp_solver"):
        mt.NonLinMPC(m, Hp=4, qp_solver="osqp", device=CPU)
    with pytest.raises(TypeError, match="dtype"):
        mt.NonLinMPC(m, Hp=4, dtype=np.float32, device=CPU)
    c = mt.NonLinMPC(m, Hp=5, Hc=2, device=CPU)
    c.preparestate([0.0])
    with pytest.raises(TypeError, match="unknown moveinput"):
        c.moveinput([90.0], Rhat_y=np.zeros(5))
    assert "NonLinMPC controller" in repr(c) and "nZ̃=3" in repr(c)


def test_failure_applies_shifted_warm_start():
    """test_nonlinmpc.py:360-376: an unreachable hard output bound."""
    out = {}
    for pkg in (mr, mt):
        nm = nonlin(pkg, *(lambda x, u, d, p: 0.5 * x + u,) * 2,
                    *(lambda x, d, p: 2.0 * x,) * 2, 1.0, 1, 1, 1, solver=None)
        c = pkg.NonLinMPC(nm, Hp=5, Hc=2, Cwt=None, **dev(pkg))
        c.setconstraint(ymin=[10.0], umin=[-0.1], umax=[0.1])
        c.preparestate([0.0])
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out[pkg] = c.moveinput([10.0])
        assert any("shifted warm start" in str(r.message) for r in rec)
        assert c.getinfo()["sol"]["failed"] is True
    np.testing.assert_allclose(out[mt], [0.0], atol=1e-12)
    close(out[mr], out[mt], 1e-12)


@pytest.fixture(scope="module")
def dumps():
    """test_nonlinmpc.py:379-396: one MultipleShooting solve in each
    package, for the getinfo dumps and ∇J."""
    cs = {}
    for pkg in (mr, mt):
        nm = nonlin(pkg, lambda x, u, d, p: 0.5 * x + jnp.tanh(u),
                    lambda x, u, d, p: 0.5 * x + torch.tanh(u),
                    *(lambda x, d, p: 2.0 * x,) * 2, 1.0, 1, 1, 1, solver=None)
        c = pkg.NonLinMPC(nm, Hp=6, Hc=2, transcription=pkg.MultipleShooting(),
                          sqp_iters=8, **dev(pkg))
        c.preparestate([0.3])
        c.moveinput([1.0])
        cs[pkg] = c
    return cs


def test_getinfo_dumps_match_reference(dumps):
    ir, ip = dumps[mr].getinfo(), dumps[mt].getinfo()
    for k in ("gradJ", "g", "geq", "J", "viol", "U", "Yhat", "xhatend", "yhat", "JE"):
        rel(ir[k], ip[k], 1e-6)
    assert ip["gradJ"].shape == (dumps[mt].nZt,)
    assert np.all(ip["g"] <= 1e-6) and ip["sol"]["defect_norm"] < 1e-6
    assert ip["sol"]["failed"] is False and ip["sol"]["iterations"] == ip["iters"]


def test_gradJ_matches_finite_differences(dumps):
    """test_nonlinmpc.py:423-454: ∇J against central differences of J."""
    c = dumps[mt]
    L, dt = c._last, torch.float64
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dt)
    args = (c._params_on(dt), t(L["x0_hat"]), t(c.lastu0_at_solve), t(L["d0"]),
            t(L["D0"]), t(c.R_hat_y), t(c.R_hat_u), t(L["yk"]), t(L["ry"]))
    diag = c._fns(dt)[1]
    gJ = c.getinfo()["gradJ"]
    Z0, eps, fd = c.Z_tilde.copy(), 1e-6, np.zeros_like(gJ)
    for i in range(Z0.size):
        zp, zm = Z0.copy(), Z0.copy()
        zp[i] += eps
        zm[i] -= eps
        fd[i] = (float(diag(*args, t(zp))[0]) - float(diag(*args, t(zm))[0])) / (2 * eps)
    np.testing.assert_allclose(gJ, fd, rtol=1e-4, atol=1e-6)


def test_setparam_swaps_as_data():
    """test_nonlinmpc.py:399-420: a numeric p swaps without a new step."""
    us = {}
    for pkg in (mr, mt):
        m = pkg.LinModel(pkg.tf(5, [2000, 1]), 3000.0)
        m.setop(yop=[10.0])

        s = xp(pkg).sum

        def JE(Ue, Ye, De, p, eps):
            Wy, ry, Wu, ru = p
            return Wy * s((ry - Ye[1:]) ** 2) + Wu * s((ru - Ue[:-1]) ** 2)
        c = pkg.NonLinMPC(m, Mwt=[0], Nwt=[0], Cwt=None, Ewt=1.0, JE=JE,
                          p=(1.0, 15.0, 0.0, 4.0), Hp=30, Hc=1, **dev(pkg))
        c.preparestate([10.0])
        u1 = c.moveinput()
        if pkg is mt:
            step = c._fns(torch.float64)[0]
        c.setparam((0.0, 15.0, 1.0, 4.0))
        if pkg is mt:
            assert c._fns(torch.float64)[0] is step
        c.preparestate([10.0])
        us[pkg] = (u1, c.moveinput())
    np.testing.assert_allclose(us[mt][0], [1.0], atol=5e-2)
    np.testing.assert_allclose(us[mt][1], [4.0], atol=5e-2)
    for a, b in zip(us[mr], us[mt]):
        rel(a, b, 1e-6)


def economic(pkg, hessian):
    """The economic pendulum of test_nonlinmpc.py:457-498 in one package:
    h the angle and the rate, JE the mean electrical power."""
    x_ = xp(pkg)
    stack = jnp.array if pkg is mr else torch.stack

    def f(x, u, d, par):
        g, L, K, m = par
        return stack([x[1], -g / L * x_.sin(x[0]) - K / m * x[1] + u[0] / (m * L ** 2)])

    def h2(x, d, par):
        return stack([x[0] * 180 / x_.pi, x[1] * 180 / x_.pi])

    def JE(Ue, Ye, De, p_, eps_):
        omega = Ye[1::2][1:] * x_.pi / 180
        return 0.1 * x_.sum(x_.abs(Ue[1:] * omega) + 0.01 * (Ue[1:] * omega) ** 2)
    pend = nonlin(pkg, f, f, h2, h2, 0.1, 1, 2, 2, p=PEND_P, solver=pkg.RungeKutta(4))
    est = pkg.UnscentedKalmanFilter(pend, sigmaQ=[0.1, 1.0], sigmaR=[5.0, 5.0],
                                    nint_ym=[1, 0], sigmaQint_ym=[0.1], **dev(pkg))
    c = pkg.NonLinMPC(est, Hp=10, Hc=2, Mwt=[0.5, 0.0], Nwt=[2.5], Cwt=np.inf,
                      Ewt=3.5e3, JE=JE, sqp_iters=40, qp_solver="active_set",
                      hessian=hessian, **dev(pkg))
    return c.setconstraint(umin=[-1.5], umax=[1.5])


@pytest.mark.parametrize("hessian", ["gauss_newton", "exact"])
def test_exact_hessian_economic_pendulum(hessian):
    """test_nonlinmpc.py:457-507 (the bench's A/B): the economic pendulum
    with either Hessian, 5 periods, u against the reference."""
    res = {pkg: economic(pkg, hessian) for pkg in (mr, mt)}
    x = np.zeros(2)
    plant = res[mr].estim.model
    for k in range(5):
        ym = x * 180 / np.pi
        us = []
        for pkg in (mr, mt):
            res[pkg].preparestate(ym)
            us.append(np.asarray(res[pkg].moveinput([180.0, 0.0])))
        rel(us[0], us[1], 1e-6)
        for pkg in (mr, mt):
            res[pkg].updatestate(us[0], ym)
        x = np.asarray(plant.f(x, us[0], np.zeros(0), plant.p))
