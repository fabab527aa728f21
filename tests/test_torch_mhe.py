"""The port's MovingHorizonEstimator against mpc_tpu's: the scenarios of
tests/test_mhe.py, where that file holds the reference to itself or to a
Kalman filter, with both packages fed the same seed-made measurements.

The port runs in float64 on the CPU (the kernels' plain versions).  Bars on
x̂ (and the getinfo arrays) per period, relative to 1 + max|x̂|:

* 1e-9 on the fast path (one exact GI solve of the window QP) and on the
  linear general path with GI;
* 1e-6 on the ADMM paths (both stop at the same tolerance, in other
  summation orders) and on the nonlinear Gauss–Newton paths, whose loop
  exits at a relative step norm of ``sqp_tol`` = 1e-6.  Near the exit the
  merit decrease of a step can lie at round-off, and the line search then
  takes or rejects that step (below the exit's tolerance) on round-off: x̂
  differs by that step with equal iteration counts
  (``test_torch_batch_mhe.py::test_gn_last_step_round_off_tie``), or one
  side stops an iteration earlier (ROADMAP §3).  The GN paths also compare the two packages'
  Gauss–Newton iteration counts solve by solve (``gn``), equal on most.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from test_torch_nonlin import CPU, nonlin, pendulum

torch.set_num_threads(1)
GI, ADMM, GN = 1e-9, 1e-6, 1e-6


def dev(pkg):
    return {} if pkg is mr else {"device": CPU}


def rel(a, b, tol, what=""):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape, what
    err = np.max(np.abs(a - b), initial=0.0)
    assert err <= tol * (1.0 + np.max(np.abs(b), initial=0.0)), (what, err)


class GNCounts:
    """The Gauss–Newton iteration counts of each window solve, one per
    lane: the reference's from its GN ``while_loop`` (a debug callback on
    the final count), the port's from ``_solve_fn``'s last output."""

    def __init__(self):
        self.ref, self.port = [], []

    def watch(self, est):
        """Record the port estimator ``est``'s solves (a fleet's template)."""
        solve = est._solve_fn

        def recorded(*a, **kw):
            out = solve(*a, **kw)
            self.port.extend(out[-1].tolist())
            return out
        est._solve_fn = recorded
        return est

    def take(self):
        """(reference, port) counts since the last call."""
        jax.effects_barrier()
        out = (self.ref.copy(), self.port.copy())
        self.ref.clear()
        self.port.clear()
        return out

    def most_equal(self):
        """Counts recorded on both sides, equal on most solves."""
        r, p = self.take()
        assert len(r) == len(p) > 0, (r, p)
        assert np.mean(np.equal(r, p)) >= 0.75, (r, p)
        return r, p


@pytest.fixture
def gn(monkeypatch):
    counts = GNCounts()
    loop = jax.lax.while_loop

    def while_loop(cond, body, init):
        out = loop(cond, body, init)
        if cond.__module__ == "mpc_tpu.estimators.mhe" and "_make_solver" in cond.__qualname__:
            jax.debug.callback(lambda it: counts.ref.append(int(it)), out[4])
        return out
    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    return counts


def mhe(pkg, model, **kw):
    return pkg.MovingHorizonEstimator(model, **kw, **dev(pkg))


def linmodel(pkg):
    """tests/test_mhe.py's 3-input, 2-output plant with one measured
    disturbance and operating points."""
    G = pkg.tf_matrix([[pkg.tf(1.90, [18, 1]), pkg.tf(1.90, [18, 1]), pkg.tf(1.90, [18, 1])],
                       [pkg.tf(-0.74, [8, 1]), pkg.tf(0.74, [8, 1]), pkg.tf(-0.74, [8, 1])]])
    m = pkg.LinModel(G, 2.0, i_d=[2])
    m.setop(uop=[10, 50], yop=[50, 30], dop=[20])
    return m


def siso(pkg):
    return pkg.LinModel(pkg.tf(3, [10, 1]), 1.0)


def drive(er, ep, N, tol, seed=0, y0=0.0, y_scale=0.5, u_scale=0.3, d=None, nan_at=(),
          extra=None):
    """N periods of both estimators on the same data; x̂ of both after each
    ``preparestate`` and ``updatestate`` to ``tol``; returns the port's x̂."""
    rng = np.random.default_rng(seed)
    xs = []
    for k in range(N):
        y = y0 + rng.normal(size=er.nym) * y_scale
        if k in nan_at:
            y[-1] = np.nan
        xr, xp = er.preparestate(y, d), ep.preparestate(y, d)
        rel(xp, xr, tol, ("preparestate", k))
        if extra is not None:
            extra(k, er, ep)
        u = er.model.uop + rng.normal(size=er.model.nu) * u_scale
        xr, xp = er.updatestate(u, y, d), ep.updatestate(u, y, d)
        rel(xp, xr, tol, ("updatestate", k))
        xs.append(xp)
    rel(ep.Z_tilde, er.Z_tilde, tol, "Z̃")
    rel(ep.P_arr, er.P_arr, tol, "P̄")
    return np.array(xs)


@pytest.mark.parametrize("direct,transcription", [(False, None), (True, None),
                                                  (False, "MultipleShooting")])
def test_unconstrained_mhe_is_the_kalman_filter(direct, transcription):
    """test_mhe.py:20-66: the unconstrained MHE equals the KalmanFilter in
    both forms and with MultipleShooting; the port's equals the reference's
    (the fast path: one GI solve) and the port's KalmanFilter."""
    rng = np.random.default_rng(42 + direct)
    kf = mt.KalmanFilter(linmodel(mt), nint_ym=0, direct=direct)
    kw = {}
    if direct:
        kf.preparestate([50, 30], [20])
        kw["P0_hat"] = kf.P_hat.copy()
        kf.updatestate([10, 50], [50, 30], [20])
    ests = [mhe(pkg, linmodel(pkg), He=3, nint_ym=0, direct=direct,
                transcription=getattr(pkg, transcription)() if transcription else None, **kw)
            for pkg in (mr, mt)]
    for i in range(8):
        y = np.array([50, 31]) + rng.normal(size=2)
        xr, xp, xk = (e.preparestate(y, [25]) for e in (*ests, kf))
        rel(xp, xr, GI, i)
        assert np.allclose(xp, xk, atol=1e-6, rtol=1e-6), i
        for e in (*ests, kf):
            e.updatestate([11, 50], y, [25])


def test_nonlinear_mhe_is_the_ekf(gn):
    """test_mhe.py:69-86: a wrapped-linear NonLinModel MHE (the GN path)
    equals the ExtendedKalmanFilter; the port's equals the reference's."""
    ref = linmodel(mr)
    A, Bu, Bd, C, Dd = (np.asarray(getattr(ref, k)) for k in ("A", "Bu", "Bd", "C", "Dd"))
    t = lambda M: torch.as_tensor(M)
    nl = {pkg: nonlin(pkg, lambda x, u, d, p: A @ x + Bu @ u + Bd @ d,
                      lambda x, u, d, p: t(A) @ x + t(Bu) @ u + t(Bd) @ d,
                      lambda x, d, p: C @ x + Dd @ d, lambda x, d, p: t(C) @ x + t(Dd) @ d,
                      ref.Ts, 2, ref.nx, 2, 1, solver=None) for pkg in (mr, mt)}
    for m in nl.values():
        m.setop(uop=[10, 50], yop=[50, 30], dop=[20])
    ekf = mt.ExtendedKalmanFilter(nl[mt], nint_ym=0, direct=False, device=CPU)
    er, ep = (mhe(pkg, nl[pkg], He=4, nint_ym=0, direct=False) for pkg in (mr, mt))
    gn.watch(ep)
    rng = np.random.default_rng(44)
    for i in range(7):
        y = np.array([50, 31]) + rng.normal(size=2)
        xr, xp, xe = er.preparestate(y, [25]), ep.preparestate(y, [25]), ekf.preparestate(y, [25])
        rel(xp, xr, GN, i)
        assert np.allclose(xp, xe, atol=1e-5, rtol=1e-5), i
        for e in (er, ep, ekf):
            e.updatestate([11, 50], y, [25])
    gn.most_equal()


@pytest.mark.parametrize("kind", ["xhat", "what", "vhat"])
def test_bounds_are_enforced_like_the_reference(kind):
    """test_mhe.py:89-114, :179-190: x̂, ŵ and v̂ bounds (the fast path)."""
    bounds = {"xhat": dict(xhatmin=[-0.1, -0.1], xhatmax=[0.1, 0.1]),
              "what": dict(whatmin=[-1e-6, -1e-6], whatmax=[1e-6, 1e-6]),
              "vhat": dict(vhatmin=[-0.02], vhatmax=[0.02])}[kind]
    er, ep = (mhe(pkg, siso(pkg), He=4, nint_ym=[1]).setconstraint(**bounds)
              for pkg in (mr, mt))
    x = drive(er, ep, 8, GI, seed=1, y0=3.0 if kind == "xhat" else 1.0)
    info = ep.getinfo()
    if kind == "xhat":
        assert np.all(np.abs(x) <= 0.1 + 1e-5)
    else:
        key, lim = ("What", 1e-5) if kind == "what" else ("Vhat", 0.02 + 1e-5)
        assert np.all(np.abs(info[key]) <= lim)
        rel(info[key], er.getinfo()[key], GI)


@pytest.mark.parametrize("grow", [False, True])
def test_time_varying_bounds_end_aligned(grow):
    """test_mhe.py:193-212 and :494-511: a capital-form ŵ bound on the
    newest slot pins the newest VALID slot, also while the window grows
    (the END-aligned bounds of the fast path)."""
    ests = []
    for pkg in (mr, mt):
        e = mhe(pkg, siso(pkg), He=4, nint_ym=[1])
        nx = e.nx_hat
        Wmax, Wmin = np.full(4 * nx, 1e17), np.full(4 * nx, -1e17)
        Wmax[-nx:], Wmin[-nx:] = 1e-6, -1e-6
        ests.append(e.setconstraint(Whatmin=Wmin, Whatmax=Wmax))
    er, ep = ests

    def newest_pinned(k, er, ep):
        W = ep.getinfo()["What"].reshape(-1, ep.nx_hat)
        assert np.all(np.abs(W[-1]) <= 1e-5), k
        rel(W, er.getinfo()["What"].reshape(-1, er.nx_hat), GI)
    drive(er, ep, 2 if grow else 8, GI, seed=5, y_scale=3.0 if grow else 1.0,
          extra=newest_pinned)
    if not grow:
        assert np.any(np.abs(ep.getinfo()["What"].reshape(4, -1)[:-1]) > 1e-4)


@pytest.mark.parametrize("qp_solver,tol", [("admm", ADMM), ("active_set", GI)])
def test_nan_window_takes_the_general_solver(qp_solver, tol):
    """test_mhe.py:117-125: NaN measurements are masked out of the window
    objective (the general solver, n_iters = 1 for a LinModel)."""
    er, ep = (mhe(pkg, linmodel(pkg), He=3, nint_ym=0, qp_solver=qp_solver)
              .setconstraint(xhatmin=[-5.0] * 4, xhatmax=[5.0] * 4) for pkg in (mr, mt))
    x = drive(er, ep, 7, tol, y0=np.array([50.0, 30.0]), d=[25], nan_at=(1, 2))
    assert np.all(np.isfinite(x))


def test_fast_path_resumes_after_nan_interlude():
    """test_mhe.py:676-709: after a 3-step NaN interlude on the general
    path, the fast path slot-shifts its warm duals once per move: the warm
    resume equals a cold-dual twin and the reference, with no warning."""
    def run(pkg, cold_resume):
        rng = np.random.default_rng(7)
        e = mhe(pkg, linmodel(pkg), He=4, nint_ym=0, qp_solver="active_set")
        e.setconstraint(xhatmin=[-100.0] * e.nx_hat, xhatmax=[100.0] * e.nx_hat)
        xs = []
        for i in range(14):
            y = (np.array([50.0, np.nan]) if 6 <= i < 9
                 else np.array([50, 31]) + rng.normal(size=2))
            if i == 9 and cold_resume:
                e._y_fast = None
            with warnings.catch_warnings():
                if i >= 9:
                    warnings.simplefilter("error")
                xs.append(np.asarray(e.preparestate(y, [25])))
                e.updatestate([11, 50], y, [25])
        return np.stack(xs)
    warm, cold, ref = run(mt, False), run(mt, True), run(mr, False)
    assert np.all(np.isfinite(warm))
    assert np.allclose(warm, cold, atol=1e-8)
    rel(warm, ref, GI)


def test_custom_nonlinear_constraint(gn):
    """test_mhe.py:128-145: gc on the NaN-padded window states (the GN
    path on a LinModel, ADMM subproblems)."""
    He = 4

    def gc_j(Xe, Ve, We, Ue, Yme, De, invP, xbar, p, eps):
        return jnp.nan_to_num(Xe.reshape(He + 1, 2)[:, 0] - 0.4, nan=-1.0)

    def gc_t(Xe, Ve, We, Ue, Yme, De, invP, xbar, p, eps):
        return torch.nan_to_num(Xe.reshape(He + 1, 2)[:, 0] - 0.4, nan=-1.0)
    er, ep = (mhe(pkg, siso(pkg), He=He, gc=gc_j if pkg is mr else gc_t, nc=He + 1)
              for pkg in (mr, mt))
    x = drive(er, gn.watch(ep), 8, ADMM, y0=3.0, y_scale=0.1, u_scale=0.0)
    assert np.all(x[:, 0] <= 0.4 + 1e-5)
    gn.most_equal()


def test_setmodel_rebases_operating_points():
    """test_mhe.py:440-470: setmodel to a reparameterization of the same
    physics: the port's rebased windows and warm start against the
    reference's, before and after the swap."""
    def shifted(pkg):
        m0 = siso(pkg)
        A, Bu, C = np.asarray(m0.A), np.asarray(m0.Bu), np.asarray(m0.C)
        uop = np.array([2.0])
        xop = np.linalg.solve(np.eye(len(A)) - A, Bu @ uop)
        mB = siso(pkg)
        mB.setop(uop=uop, yop=C @ xop, xop=xop, fop=A @ xop + Bu @ uop)
        return mB
    er, ep = (mhe(pkg, siso(pkg), He=4, nint_ym=0, direct=False) for pkg in (mr, mt))
    drive(er, ep, 6, GI, u_scale=0.0)
    for e in (er, ep):
        e.setmodel(shifted(mr if e is er else mt))
    drive(er, ep, 8, GI, seed=3, u_scale=0.2)


def test_setmodel_tracks_new_model():
    """test_mhe.py:215-243: after setmodel both packages converge to the new
    plant the same way."""
    z = np.zeros((1, 0))
    ests = []
    for pkg in (mr, mt):
        m1 = pkg.LinModel(np.array([[0.5]]), np.array([[1.0]]), np.array([[1.0]]), z, z, 1.0)
        e = mhe(pkg, m1, He=3, nint_ym=[1])
        for _ in range(3):
            e.preparestate([0.3])
            e.updatestate([0.5], [0.3])
        e.setmodel(pkg.LinModel(np.array([[0.8]]), np.array([[0.6]]), np.array([[1.0]]), z, z,
                                1.0))
        ests.append(e)
    plant = mt.LinModel(np.array([[0.8]]), np.array([[0.6]]), np.array([[1.0]]), z, z, 1.0)
    plant.setstate([0.7])
    for k in range(30):
        y = plant.evaloutput()
        xr, xp = (e.preparestate(y) for e in ests)
        rel(xp, xr, GI, k)
        for e in ests:
            e.updatestate([0.4], y)
        plant.updatestate([0.4])
    assert np.allclose(ests[1].evaloutput(), plant.evaloutput(), atol=5e-4)


def cont_model(pkg):
    """test_mhe.py:275-281: a continuous-time NonLinModel (RK4)."""
    return nonlin(pkg, lambda x, u, d, p: jnp.array([-0.5 * x[0] + 0.3 * jnp.tanh(x[1]) + 0.4 * u[0],
                                                     -0.8 * x[1] + 0.2 * x[0]]),
                  lambda x, u, d, p: torch.stack([-0.5 * x[0] + 0.3 * torch.tanh(x[1])
                                                  + 0.4 * u[0], -0.8 * x[1] + 0.2 * x[0]]),
                  lambda x, d, p: jnp.array([x[0] + 0.1 * jnp.sin(x[1])]),
                  lambda x, d, p: torch.stack([x[0] + 0.1 * torch.sin(x[1])]),
                  0.05, 1, 2, 1, solver="rk4")


@pytest.mark.parametrize("hold,direct", [(0, True), (1, False)])
def test_trapezoidal_collocation_matches_reference(hold, direct, gn):
    """test_mhe.py:284-363: the trapezoidal defects (GN, ADMM subproblems),
    against the reference and near the SingleShooting estimate."""
    kw = dict(He=4, direct=direct, sigmaQ=[0.4, 0.4], sigmaR=[0.2], sigmaP_0=[1.0, 1.0])
    er, ep = (mhe(pkg, cont_model(pkg), transcription=pkg.TrapezoidalCollocation(hold), **kw)
              for pkg in (mr, mt))
    ss = mhe(mt, cont_model(mt), **kw)
    x = drive(er, gn.watch(ep), 6, GN, seed=7)
    gn.most_equal()
    rng = np.random.default_rng(7)
    xs = []
    for k in range(6):
        y = rng.normal(size=1) * 0.5
        ss.preparestate(y)
        xs.append(ss.updatestate(rng.normal(size=1) * 0.3, y))
    assert np.allclose(x, np.array(xs), atol=5e-3)


def test_getinfo_matches_reference():
    """test_mhe.py:545-598: getinfo's keys, the objective and ∇J (by
    ``torch.func.grad`` of the port's objective) against the reference's,
    ∇J ≈ 0 at an unconstrained optimum, and the window rollout."""
    er, ep = (mhe(pkg, siso(pkg), He=4) for pkg in (mr, mt))
    rng = np.random.default_rng(3)
    for k in range(7):
        ym = rng.normal(size=1) * 0.3
        er.preparestate(ym)
        ep.preparestate(ym)
        if k < 6:
            u = rng.normal(size=1) * 0.2
            er.updatestate(u, ym)
            ep.updatestate(u, ym)
    ir, ip = er.getinfo(), ep.getinfo()
    assert set(ip) == set(ir)
    for key in ("What", "xbar", "xhatarr", "J", "Xhat", "xhat", "Pbar", "Ym", "U", "D",
                "Yhat", "Yhatm", "Vhat", "nablaJ"):
        rel(ip[key], ir[key], GI, key)
    assert {k: v for k, v in ip["sol"].items() if k != "objective"} == \
        {k: v for k, v in ir["sol"].items() if k != "objective"}
    rel(ip["sol"]["objective"], ir["sol"]["objective"], GI)
    assert np.linalg.norm(ip["nablaJ"], np.inf) < 1e-6


def test_constrained_getinfo_gradient():
    """test_mhe.py:601-626: with active x̂ bounds ∇J is nonzero and equal to
    the reference's."""
    er, ep = (mhe(pkg, siso(pkg), He=3).setconstraint(xhatmin=[-0.15, -np.inf],
                                                      xhatmax=[0.15, np.inf])
              for pkg in (mr, mt))
    drive(er, ep, 6, GI, y_scale=1.0)
    g = ep.getinfo()["nablaJ"]
    assert np.linalg.norm(g, np.inf) > 1e-3
    rel(g, er.getinfo()["nablaJ"], 1e-8)


def test_mhe_in_linmpc_through_sim():
    """test_mhe.py:162-176: a LinMPC with the MHE as its estimator, in
    closed loop through ``sim`` (which reads the MHE's x̂ bounds): the
    port's run equals the reference's."""
    res = []
    for pkg in (mr, mt):
        est = mhe(pkg, siso(pkg), He=4).setconstraint(xhatmin=[-10.0, -10.0],
                                                      xhatmax=[10.0, 10.0])
        ctrl = pkg.LinMPC(est, Hp=10, Hc=2, **dev(pkg))
        res.append(pkg.sim(ctrl, 25, [1.0], y_step=[0.2], plant=siso(pkg)))
    for key in ("U_data", "Y_data", "X_est_data"):
        rel(getattr(res[1], key), np.asarray(getattr(res[0], key)), 1e-8, key)
    assert abs(res[1].Y_data[-1][0] - 1.0) < 5e-2


def test_linmodel_equals_wrapped_nonlinmodel(gn):
    """test_mhe.py:386-412: the LinModel MHE (fast path) and the same plant
    as a NonLinModel (GN path) agree with active ŵ bounds, in both
    packages."""
    A, Bu, C = np.array([[0.85, 0.1], [0.0, 0.7]]), np.array([[0.5], [0.25]]), np.array([[1.0, 0.4]])
    t = lambda M: torch.as_tensor(M)
    kw = dict(He=4, nint_ym=0, sigmaQ=[0.5, 0.5], sigmaR=[0.3], sigmaP_0=[1.0, 1.0])
    wb = dict(whatmin=[-0.02, -0.02], whatmax=[0.02, 0.02])
    lin = mhe(mt, mt.LinModel(A, Bu, C, np.zeros((1, 0)), np.zeros((1, 0)), 1.0), **kw)
    er, ep = (mhe(pkg, nonlin(pkg, lambda x, u, d, p: A @ x + Bu @ u,
                              lambda x, u, d, p: t(A) @ x + t(Bu) @ u,
                              lambda x, d, p: C @ x, lambda x, d, p: t(C) @ x,
                              1.0, 1, 2, 1, solver=None), **kw).setconstraint(**wb)
              for pkg in (mr, mt))
    lin.setconstraint(**wb)
    gn.watch(ep)
    rng = np.random.default_rng(21)
    for k in range(9):
        ym = [float(0.5 * np.sin(0.4 * k) + rng.normal() * 0.1)]
        xs = [e.preparestate(ym) for e in (er, ep, lin)]
        rel(xs[1], xs[0], GN, k)
        assert np.allclose(xs[1], xs[2], atol=5e-5), k
        u = [float(np.cos(0.3 * k))]
        for e in (er, ep, lin):
            e.updatestate(u, ym)
    gn.most_equal()


def test_nonlinear_active_set_matches_admm(gn):
    """test_mhe.py:712-745: the constrained pendulum window (GN) with GI and
    with ADMM subproblems, each against the reference's (GN iteration
    counts too), and GI against ADMM."""
    def make(pkg, qp):
        e = mhe(pkg, pendulum(pkg), He=4, sigmaQ=[0.1, 1.0], sigmaR=[0.5], nint_ym=[1],
                sigmaQint_ym=[0.1], qp_solver=qp)
        return e.setconstraint(xhatmin=[-0.3, -5.0, -5.0], xhatmax=[0.3, 5.0, 5.0])
    ests = {(pkg, qp): make(pkg, qp) for pkg in (mr, mt) for qp in ("active_set", "admm")}
    for qp in ("active_set", "admm"):
        gn.watch(ests[mt, qp])
    rng = np.random.default_rng(47)
    for k in range(6):
        ym = rng.normal(size=1) * 20.0
        x = {key: e.preparestate(ym) for key, e in ests.items()}
        for qp in ("active_set", "admm"):
            rel(x[mt, qp], x[mr, qp], GN, (k, qp))
        assert np.allclose(x[mt, "active_set"], x[mt, "admm"], atol=2e-5), k
        assert x[mt, "active_set"][0] <= 0.3 + 1e-6
        u = rng.normal(size=1) * 0.3
        for e in ests.values():
            e.updatestate(u, ym)
    gn.most_equal()


def test_soft_constraints_fast_matches_general():
    """test_mhe.py:647-673: finite Cwt, slack active; the port's fast path
    equals its general solver and the reference's fast path."""
    def run(pkg, force_general):
        est = mhe(pkg, siso(pkg), He=4, Cwt=1e4, qp_solver="active_set")
        est.setconstraint(xhatmin=[-0.05, -np.inf], xhatmax=[0.05, np.inf])
        if force_general:
            est._fast_applicable = lambda: False
        rng = np.random.default_rng(9)
        out, eps = [], []
        for k in range(8):
            ym = rng.normal(size=1)
            out.append(np.asarray(est.preparestate(ym)).copy())
            eps.append(est.getinfo()["epsilon"])
            est.updatestate(rng.normal(size=1) * 0.3, ym)
        return np.array(out), np.array(eps)
    (x_f, e_f), (x_g, e_g), (x_r, e_r) = run(mt, False), run(mt, True), run(mr, False)
    assert np.max(e_f) > 1e-4
    assert np.allclose(x_f, x_g, atol=2e-6) and np.allclose(e_f, e_g, atol=2e-6)
    rel(x_f, x_r, GI)
    rel(e_f, e_r, GI)


def test_initstate_seeds_prewindow_disturbance():
    """test_mhe.py:473-491: initstate stores d0(-1) in the pre-window slot."""
    ests = []
    for pkg in (mr, mt):
        m = pkg.LinModel(pkg.tf_matrix([[pkg.tf(3, [10, 1]), pkg.tf(1, [5, 1])]]), 1.0, i_d=[1])
        e = mhe(pkg, m, He=4, nint_ym=0, direct=False)
        rel(e.initstate(np.zeros(1), np.asarray(m.yop + 0.3), [0.7]),
            ests[0].x0_hat + ests[0].xop_hat if ests else e.x0_hat + e.xop_hat, GI)
        ests.append(e)
    drive(*ests, 6, GI, seed=2, u_scale=0.1, d=np.array([0.7]))


def test_arrival_covariance_fallback():
    """test_mhe.py:415-437: a non-PD or non-finite P̄ is refused with a
    warning and the previous inverse kept."""
    lin = mt.LinModel(np.array([[0.8]]), np.array([[1.0]]), np.array([[1.0]]),
                      np.zeros((1, 0)), np.zeros((1, 0)), 1.0)
    e = mhe(mt, lin, He=1, nint_ym=0)
    for _ in range(2):
        e.preparestate([0.5])
        e.updatestate([0.1], [0.5])
    for bad in (-1e-3, np.inf):
        e.P_arr[0, 0] = bad
        invP = e.invP_arr.copy()
        with pytest.warns(UserWarning, match="keeping"):
            e.preparestate([0.5])
            e.updatestate([0.1], [0.5])
        assert np.allclose(e.invP_arr, invP)


@pytest.mark.parametrize("case", ["He", "covestim", "softness", "orthogonal", "trapezoidal",
                                  "nan_u", "qp_solver", "keyword"])
def test_construction_and_protocol_errors(case):
    """The reference's validation (mhe.py:53-223, test_mhe.py:366-383,
    :514-520, :629-644)."""
    m = siso(mt)
    with pytest.raises(ValueError, match={"He": "horizon", "covestim": "covestim",
                                          "softness": "non-negative",
                                          "orthogonal": "OrthogonalCollocation",
                                          "trapezoidal": "continuous-time",
                                          "nan_u": "NaN", "qp_solver": "qp_solver",
                                          "keyword": "unknown"}[case]):
        if case == "He":
            mhe(mt, m, He=0)
        elif case == "covestim":
            mhe(mt, m, He=3, covestim=mt.KalmanFilter(m, nint_ym=0))
        elif case == "softness":
            mhe(mt, m, He=3, Cwt=1e4).setconstraint(c_xhatmin=[-1.0, 1.0])
        elif case == "orthogonal":
            mhe(mt, cont_model(mt), He=3, transcription=mt.OrthogonalCollocation())
        elif case == "trapezoidal":
            mhe(mt, m, He=3, transcription=mt.TrapezoidalCollocation())
        elif case == "nan_u":
            e = mhe(mt, m, He=3)
            e.preparestate([0.1])
            e.updatestate([np.nan], [0.1])
            e.preparestate([0.1])
        elif case == "qp_solver":
            mhe(mt, m, He=3, qp_solver="osqp")
        else:
            mhe(mt, m, He=3).setconstraint(xmin=[0.0])
