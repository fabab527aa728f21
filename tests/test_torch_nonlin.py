"""The port's nonlinear-model foundation against mpc_tpu.

The solvers, NonLinModel, ``linearize``/``linearize_``, the InternalModel
and the extended and unscented Kalman filters on nonlinear models, and
``sim`` with nonlinear plants.  Both packages get the same seed-made inputs
in float64; the port runs on the CPU.  Bars: ``updatestate``/``evaloutput``
and the linearized matrices and operating points to 1e-12; EKF x̂ and P̂
over 30 periods to 1e-10; UKF to 1e-8·(1 + |x̂|) (its weights scale as
1/α², α = 1e-3, which amplifies round-off).
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpc_tpu as mr
import mpc_tpu_torch as mt

torch.set_num_threads(1)
CPU = torch.device("cpu")
PEND_P = (9.8, 0.4, 1.2, 0.3)


def nonlin(pkg, f_jax, f_torch, h_jax, h_torch, *args, **kw):
    """The same NonLinModel in both packages; the port's on the CPU."""
    if pkg is mr:
        return mr.NonLinModel(f_jax, h_jax, *args, **kw)
    return mt.NonLinModel(f_torch, h_torch, *args, device=CPU, **kw)


def pendulum(pkg, solver="rk4", nd=0):
    """The reference's pendulum (tests/test_slmpc.py), with an optional
    measured disturbance torque d[0] (nd=1)."""
    def f_j(x, u, d, par):
        g, L, K, m = par
        tau = u[0] + (d[0] if nd else 0.0)
        return jnp.array([x[1], -g / L * jnp.sin(x[0]) - K / m * x[1] + tau / (m * L ** 2)])

    def f_t(x, u, d, par):
        g, L, K, m = par
        tau = u[0] + (d[0] if nd else 0.0)
        return torch.stack([x[1], -g / L * torch.sin(x[0]) - K / m * x[1] + tau / (m * L ** 2)])

    h_j = lambda x, d, par: jnp.array([x[0] * 180 / jnp.pi + (d[0] if nd else 0.0)])
    h_t = lambda x, d, par: torch.stack([x[0] * 180 / torch.pi + (d[0] if nd else 0.0)])
    if solver == "rk4":
        solver = pkg.RungeKutta(4)
    return nonlin(pkg, f_j, f_t, h_j, h_t, 0.1, 1, 2, 1, nd, p=PEND_P, solver=solver)


def sine(pkg):
    """tests/test_estimators.py::test_ukf_nonlinear: discrete x+ = ½sin x + u."""
    return nonlin(pkg, lambda x, u, d, p: 0.5 * jnp.sin(x) + u,
                  lambda x, u, d, p: 0.5 * torch.sin(x) + u,
                  lambda x, d, p: x, lambda x, d, p: x, 1.0, 1, 1, 1, solver=None)


def close(a, b, tol):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol, np.max(np.abs(a - b))


# --- solvers -----------------------------------------------------------------
@pytest.mark.parametrize("solver", [("rk", 4, 1), ("rk", 4, 3), ("rk", 1, 2),
                                    ("euler", 1, 10), ("empty", 0, 1)])
def test_solvers_discretize_like_the_reference(solver):
    kind, order, ss = solver
    make = {"rk": lambda pkg: pkg.RungeKutta(order, supersample=ss),
            "euler": lambda pkg: pkg.ForwardEuler(ss),
            "empty": lambda pkg: None}[kind]
    mods = [pendulum(pkg, make(pkg)) for pkg in (mr, mt)]
    rng = np.random.default_rng(0)
    for _ in range(5):
        x, u = rng.normal(size=2), rng.normal(size=1)
        close(mods[0].f(x, u, np.zeros(0), PEND_P), mods[1].f(x, u, np.zeros(0), PEND_P),
              1e-12)
    assert repr(mods[0]) == repr(mods[1])


def test_solver_validation():
    with pytest.raises(ValueError, match="order"):
        mt.RungeKutta(2)
    with pytest.raises(ValueError, match="supersample"):
        mt.RungeKutta(4, supersample=0)
    assert mt.ForwardEuler(3).order == 1 and mt.ForwardEuler(3).supersample == 3
    assert isinstance(mt.EmptySolver(), mt.DiffSolver)
    with pytest.raises(TypeError, match="solver"):
        pendulum(mt, solver="rk2")


def test_shape_validation_errors():
    good_h = lambda x, d, p: x[:1]
    with pytest.raises(ValueError, match=r"f must return shape \(2,\), got \(3,\)"):
        mt.NonLinModel(lambda x, u, d, p: torch.cat([x, u]), good_h, 0.1, 1, 2, 1,
                       device=CPU, solver=None)
    with pytest.raises(ValueError, match=r"h must return shape \(1,\), got \(2,\)"):
        mt.NonLinModel(lambda x, u, d, p: x, lambda x, d, p: x, 0.1, 1, 2, 1,
                       device=CPU, solver=None)
    with pytest.raises(ValueError, match="not traceable"):
        mt.NonLinModel(lambda x, u, d, p: x @ u, good_h, 0.1, 1, 2, 1,
                       device=CPU, solver=None)


# --- NonLinModel (tests/test_models.py:74-124) -------------------------------
def test_nonlinmodel_discrete():
    for pkg in (mr, mt):
        model = nonlin(pkg, lambda x, u, d, p: -x + u, lambda x, u, d, p: -x + u,
                       lambda x, d, p: x + 20.0, lambda x, d, p: x + 20.0,
                       4.0, 1, 1, 1, solver=None)
        assert np.allclose(model.evaloutput(), [20.0])
        model.updatestate([3.0])
        assert np.allclose(model.x0, [3.0])


def test_nonlinmodel_rk4_matches_linear():
    xs = []
    for pkg in (mr, mt):
        model = nonlin(pkg, lambda x, u, d, p: -0.5 * x + u, lambda x, u, d, p: -0.5 * x + u,
                       lambda x, d, p: x, lambda x, d, p: x, 0.1, 1, 1, 1,
                       solver=pkg.RungeKutta(4, supersample=2))
        xs.append(model.updatestate([1.0]))
    lin = mt.LinModel(mt.ss(-0.5, 1.0, 1.0, 0.0), 0.1)
    close(xs[0], xs[1], 1e-12)
    close(xs[1], lin.updatestate([1.0]), 1e-8)


@pytest.mark.parametrize("nd", [0, 1])
def test_updatestate_evaloutput_match_reference(nd):
    """A 20-step bump test around shifted operating points."""
    mods = [pendulum(pkg, nd=nd) for pkg in (mr, mt)]
    for m in mods:
        m.setop(uop=[0.2], yop=[3.0], dop=[0.1] * nd, xop=[0.05, 0.0], fop=[0.05, 0.01])
        m.setstate([0.3, -0.2])
    rng = np.random.default_rng(1)
    for _ in range(20):
        u, d = rng.normal(size=1), rng.normal(size=nd)
        dd = d if nd else None
        close(mods[0].evaloutput(dd), mods[1].evaloutput(dd), 1e-12)
        close(mods[0].updatestate(u, dd), mods[1].updatestate(u, dd), 1e-12)
    assert isinstance(mods[1].evaloutput(dd), np.ndarray)


# --- linearize ---------------------------------------------------------------
def test_linearize_cubic():
    """tests/test_models.py::test_linearize, in both packages."""
    for pkg in (mr, mt):
        model = nonlin(pkg, lambda x, u, d, p: x ** 3 + u, lambda x, u, d, p: x ** 3 + u,
                       lambda x, d, p: x, lambda x, d, p: x, 0.1, 1, 1, 1, solver=None)
        linmodel = pkg.linearize(model, x=[10.0], u=[0.0])
        assert np.isclose(linmodel.A[0, 0], 300.0)
        pkg.linearize_(linmodel, model, np.array([20.0]), np.array([0.0]), np.zeros(0))
        assert np.isclose(linmodel.A[0, 0], 1200.0)
        assert np.allclose(linmodel.fop, [20.0 ** 3])


@pytest.mark.parametrize("nd", [0, 1])
def test_linearize_matches_reference(nd):
    """Matrices and operating points at a non-equilibrium point, a second
    point through ``linearize_``, and the linear model's step at the point
    equal to the nonlinear one (tests/test_models.py:107-124)."""
    mods = [pendulum(pkg, nd=nd) for pkg in (mr, mt)]
    for m in mods:
        m.setop(uop=[0.1], yop=[1.0], dop=[0.2] * nd)
    x, u, d = np.array([0.3, -0.2]), np.array([0.5]), np.array([0.4] * nd)
    dd = d if nd else None
    lins = [pkg.linearize(m, x=x, u=u, d=dd) for pkg, m in zip((mr, mt), mods)]
    keys = ("A", "Bu", "Bd", "C", "Dd", "uop", "yop", "dop", "xop", "fop")
    for k in keys:
        close(getattr(lins[0], k), getattr(lins[1], k), 1e-12)
    x2, u2 = np.array([1.0, 0.5]), np.array([-0.3])
    for pkg, lin, m in zip((mr, mt), lins, mods):
        pkg.linearize_(lin, m, x2, u2, dd)
    for k in keys:
        close(getattr(lins[0], k), getattr(lins[1], k), 1e-12)
    model, lin = mods[1], lins[1]
    model.setstate(x2)
    lin.setstate(x2)
    close(model.updatestate(u2, dd), lin.updatestate(u2, dd), 1e-9)
    assert mt.get_linearization_func(model) is mt.get_linearization_func(model)


def test_linearize_linmodel_copies():
    """A LinModel is copied with moved operating points (linearization.jl:
    208-213)."""
    out = []
    for pkg in (mr, mt):
        lm = pkg.LinModel(pkg.tf(2, [10, 1]), 1.0)
        lin = pkg.linearize(lm, x=[0.5], u=[1.0])
        assert lin is not lm and lin.A is not lm.A
        out.append(lin)
    for k in ("A", "Bu", "C", "uop", "yop", "xop", "fop"):
        close(getattr(out[0], k), getattr(out[1], k), 1e-12)


# --- estimators on nonlinear models (tests/test_estimators.py:99-152) --------
def lockstep_estimators(make, model_fn, N, seed, nan_at=None):
    """Run the same estimator in both packages on the same measurements and
    inputs; yields the two after every ``updatestate``."""
    ests = [make(pkg, model_fn(pkg)) for pkg in (mr, mt)]
    rng = np.random.default_rng(seed)
    nym, nu = ests[0].nym, ests[0].model.nu
    for k in range(N):
        y = rng.normal(size=nym)
        if k == nan_at:
            y[0] = np.nan
        u = rng.normal(size=nu) * 0.5
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for e in ests:
                e.preparestate(y)
                e.updatestate(u, y)
        yield ests


def _ekf(pkg, model):
    kw = {"device": CPU} if pkg is mt else {}
    return pkg.ExtendedKalmanFilter(model, nint_ym=[1], sigmaQ=[0.1, 0.5],
                                    sigmaR=[2.0], **kw)


def _ukf(pkg, model):
    kw = {"device": CPU} if pkg is mt else {}
    return pkg.UnscentedKalmanFilter(model, nint_ym=[1], sigmaQ=[0.1, 0.5],
                                     sigmaR=[2.0], **kw)


@pytest.mark.parametrize("nan_at", [None, 7])
def test_ekf_pendulum_matches_reference(nan_at):
    for er, ep in lockstep_estimators(_ekf, pendulum, 30, 3, nan_at):
        close(er.x0_hat, ep.x0_hat, 1e-10)
        close(er.P_hat, ep.P_hat, 1e-10)
    close(er.evaloutput(), ep.evaloutput(), 1e-10)


@pytest.mark.parametrize("nan_at", [None, 7])
def test_ukf_pendulum_matches_reference(nan_at):
    for er, ep in lockstep_estimators(_ukf, pendulum, 30, 4, nan_at):
        scale = 1.0 + np.abs(er.x0_hat).max()
        close(er.x0_hat, ep.x0_hat, 1e-8 * scale)
        close(er.P_hat, ep.P_hat, 1e-8 * (1.0 + np.abs(er.P_hat).max()))


def test_nan_measurement_protocol():
    """The UKF returns before its correction, the EKF warns and its
    correction skips inside (mirroring the reference)."""
    for make in (_ukf, _ekf):
        e = make(mt, pendulum(mt))
        e.x0_hat[:] = [0.1, 0.2, 0.3]
        P = e.P_hat.copy()
        with pytest.warns(UserWarning, match="NaN"):
            e.preparestate([np.nan])
        close(e.x0_hat, [0.1, 0.2, 0.3], 0.0)
        close(e.P_hat, P, 0.0)


def test_ekf_and_ukf_equal_kf_on_linear():
    """tests/test_estimators.py:99-128: on a LinModel the EKF is the KF
    (to 1e-10) and the UKF is close to it, in both packages alike."""
    def sysm(pkg):
        G = np.array([[pkg.tf(1.90, [18, 1]), pkg.tf(1.90, [18, 1])],
                      [pkg.tf(-0.74, [8, 1]), pkg.tf(0.74, [8, 1])]], dtype=object)
        return pkg.LinModel(G, 2.0)
    kf = mt.KalmanFilter(sysm(mt), nint_ym=[1, 1])
    ekf = mt.ExtendedKalmanFilter(sysm(mt), nint_ym=[1, 1], device=CPU)
    ukf = mt.UnscentedKalmanFilter(sysm(mt), nint_ym=[1, 1], device=CPU)
    ukf_r = mr.UnscentedKalmanFilter(sysm(mr), nint_ym=[1, 1])
    rng = np.random.default_rng(1)
    for _ in range(20):
        y, u = rng.normal(size=2), rng.normal(size=2)
        for e in (kf, ekf, ukf, ukf_r):
            e.preparestate(y)
            e.updatestate(u, y)
    close(kf.x0_hat, ekf.x0_hat, 1e-10)
    close(kf.P_hat, ekf.P_hat, 1e-10)
    close(kf.x0_hat, ukf.x0_hat, 1e-6)
    close(ukf_r.x0_hat, ukf.x0_hat, 1e-8 * (1 + np.abs(ukf_r.x0_hat).max()))


@pytest.mark.parametrize("kind", ["ukf", "ekf"])
def test_sine_model_converges(kind):
    """tests/test_estimators.py:131-152."""
    make = {"ukf": mt.UnscentedKalmanFilter, "ekf": mt.ExtendedKalmanFilter}[kind]
    est = make(sine(mt), nint_ym=[1], device=CPU)
    for _ in range(50):
        est.preparestate([1.0])
        est.updatestate([0.3], [1.0])
    assert np.allclose(est.evaloutput(), [1.0], atol=1e-2)


def test_internal_model_on_nonlinear_plant():
    """InternalModel's NonLinModel branches: the deterministic model runs
    open loop, ŷs = ym − ŷd feeds the stochastic model."""
    ests = [pkg.InternalModel(pendulum(pkg)) for pkg in (mr, mt)]
    rng = np.random.default_rng(5)
    for _ in range(25):
        y, u = rng.normal(size=1) * 5, rng.normal(size=1) * 0.3
        for e in ests:
            e.preparestate(y)
        close(ests[0].evaloutput(), ests[1].evaloutput(), 1e-12)
        for e in ests:
            e.updatestate(u, y)
        close(ests[0].x0_hat, ests[1].x0_hat, 1e-12)
        close(ests[0].xs_hat, ests[1].xs_hat, 1e-12)
    for e in ests:   # initstate leaves a NonLinModel's state as it is
        x = e.x0_hat.copy()
        e.initstate([0.0], [1.0])
        close(e.x0_hat, x, 0.0)


# --- sim with nonlinear plants -------------------------------------------------
SIM_ARRAYS = ("T_data", "Y_data", "U_data", "X_data", "Y_est_data", "X_est_data")


def same_sim(rr, rp, tol):
    for k in SIM_ARRAYS:
        a, b = getattr(rr, k), getattr(rp, k)
        assert (a is None) == (b is None), k
        if a is not None:
            close(a, b, tol)


def test_sim_open_loop_nonlinear():
    res = [pkg.sim(pendulum(pkg), 30, [0.5], x_0=[0.2, 0.0]) for pkg in (mr, mt)]
    same_sim(*res, 1e-12)


@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_sim_estimator_closed_loop(kind):
    make = {"ekf": _ekf, "ukf": _ukf}[kind]
    res = [pkg.sim(make(pkg, pendulum(pkg)), 25, y_noise=[0.5], y_step=[2.0],
                   x_0=[0.3, 0.0], seed=2) for pkg in (mr, mt)]
    same_sim(*res, 1e-8)


def test_sim_linmpc_with_nonlinear_plant():
    """A LinMPC on the pendulum linearized at rest, against the nonlinear
    pendulum as ``plant=``."""
    res = []
    for pkg in (mr, mt):
        kw = {"device": CPU} if pkg is mt else {}
        lin = pkg.linearize(pendulum(pkg), x=[0.0, 0.0], u=[0.0])
        ctrl = pkg.LinMPC(lin, Hp=15, Hc=2, Mwt=[0.5], Nwt=[2.5], **kw)
        ctrl.setconstraint(umin=[-1.5], umax=[1.5])
        res.append(pkg.sim(ctrl, 30, [20.0], plant=pendulum(pkg)))
    same_sim(*res, 1e-6)
    assert copy.deepcopy(pendulum(mt)).nx == 2
