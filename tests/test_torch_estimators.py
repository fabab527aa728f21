"""The port's linear estimators against mpc_tpu's, step by step.

SteadyKalmanFilter, KalmanFilter, Luenberger, InternalModel and
ManualEstimator, each built in both packages on the same plant (two
outputs, one input, one measured disturbance, nonzero operating points)
and driven through the reference protocol with the same seeded inputs:
``initstate``, then 20 periods of ``preparestate``/``evaloutput``/
``updatestate`` with a NaN measurement at period 7 and a ``setmodel`` at
period 12 (``setstate`` for the ManualEstimator).  Options: ``direct=False``
and a partial ``i_ym``.  Both run in host NumPy float64; bars: x̂, P̂, ŷ
and the returned estimates to 1e-10·(1 + |value|).
"""
import warnings

import numpy as np
import pytest

import mpc_tpu as mr
import mpc_tpu_torch as mt


def plant(pkg, k=1.0):
    G = np.array([[pkg.tf(3 * k, [30, 1]), pkg.tf(-2, [5, 1])],
                  [pkg.tf(1, [10 * k, 1]), pkg.tf(0.5, [4, 1])]], dtype=object)
    m = pkg.LinModel(G, 1.0, i_d=[1])
    m.setop(uop=[0.5], yop=[2.0, -1.0], dop=[0.3])
    return m


KINDS = {
    "skf": lambda pkg, m, kw: pkg.SteadyKalmanFilter(m, **kw),
    "kf": lambda pkg, m, kw: pkg.KalmanFilter(m, **kw),
    "luenberger": lambda pkg, m, kw: pkg.Luenberger(m, **kw),
    "internal_model": lambda pkg, m, kw: pkg.InternalModel(m, **kw),
    "manual": lambda pkg, m, kw: pkg.ManualEstimator(m, **kw),
}
CASES = [("skf", {}), ("skf", {"direct": False}), ("skf", {"i_ym": [1]}),
         ("kf", {}), ("kf", {"direct": False}),
         ("kf", {"i_ym": [0], "nint_u": [1], "nint_ym": [0]}),
         ("luenberger", {}), ("luenberger", {"direct": False}),
         ("internal_model", {}), ("internal_model", {"i_ym": [0]}),
         ("manual", {})]


def close(a, b, what):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape, what
    assert np.all(np.abs(a - b) <= 1e-10 * (1.0 + np.abs(a))), (what, a, b)


def same_state(er, ep, what):
    close(er.x0_hat, ep.x0_hat, f"{what}: x0_hat")
    for attr in ("P_hat", "xs_hat", "ys_hat", "K_hat"):
        if hasattr(er, attr):
            close(getattr(er, attr), getattr(ep, attr), f"{what}: {attr}")


@pytest.mark.parametrize("kind,kw", CASES,
                         ids=[f"{k}-{'-'.join(o) or 'default'}" for k, o in CASES])
def test_protocol_matches_reference(kind, kw):
    er, ep = (KINDS[kind](pkg, plant(pkg), kw) for pkg in (mr, mt))
    assert type(ep).__name__ == type(er).__name__
    rng = np.random.default_rng(len(kind))
    nym = er.nym
    u0, d0 = np.array([0.4]), np.array([0.2])
    ym0 = rng.normal(size=nym)
    close(er.initstate(u0, ym0, d0), ep.initstate(u0, ym0, d0), "initstate")
    same_state(er, ep, "initstate")
    for k in range(20):
        u = rng.normal(size=1)
        d = rng.normal(size=1)
        ym = rng.normal(size=nym)
        if k == 7:
            ym[0] = np.nan
        if kind == "manual":
            x = rng.normal(size=er.nx_hat)
            er.setstate(x)
            ep.setstate(x)
        if k == 12 and kind in ("skf", "kf", "internal_model"):
            for e, pkg in ((er, mr), (ep, mt)):
                e.setmodel(plant(pkg, 1.3))
        if k == 12 and kind == "luenberger":
            for e, pkg in ((er, mr), (ep, mt)):
                with pytest.raises(ValueError, match="setmodel"):
                    e.setmodel(plant(pkg, 1.3))
        with warnings.catch_warnings(record=True) as wr:
            warnings.simplefilter("always")
            xr = er.preparestate(ym, d)
            n_r = len(wr)
            xp = ep.preparestate(ym, d)
            assert len(wr) == 2 * n_r, [str(w.message) for w in wr]
        close(xr, xp, f"period {k}: preparestate")
        close(er.evaloutput(d), ep.evaloutput(d), f"period {k}: evaloutput")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            close(er.updatestate(u, ym, d), ep.updatestate(u, ym, d),
                  f"period {k}: updatestate")
        same_state(er, ep, f"period {k}")


def test_kalman_setstate_and_covariance_reset():
    """setstate with P̂, initstate resetting P̂ to P̂₀, and the errors of an
    estimator without P̂."""
    kr, kp = (pkg.KalmanFilter(plant(pkg)) for pkg in (mr, mt))
    n = kr.nx_hat
    P = np.eye(n) * 0.3 + 0.01
    x = np.linspace(-1, 1, n)
    kr.setstate(x, P)
    kp.setstate(x, P)
    same_state(kr, kp, "setstate")
    for e in (kr, kp):
        e.preparestate([1.0, 2.0], [0.1])
        e.updatestate([0.2], [1.0, 2.0], [0.1])
    same_state(kr, kp, "after one period")
    close(kr.initstate([0.5], [2.0, -1.0], [0.3]), kp.initstate([0.5], [2.0, -1.0], [0.3]),
          "initstate")
    close(kp.P_hat, kp.P0_hat, "P̂ reset")
    for pkg in (mr, mt):
        with pytest.raises(ValueError, match="covariance"):
            pkg.SteadyKalmanFilter(plant(pkg)).setstate(x, P)
        with pytest.raises(ValueError, match="covariance"):
            pkg.InternalModel(plant(pkg)).setstate(np.zeros(plant(pkg).nx), P)
        with pytest.raises(RuntimeError, match="preparestate"):
            pkg.SteadyKalmanFilter(plant(pkg)).updatestate([0.0], [0.0, 0.0], [0.0])
