"""The port's compiled MHE loops against mpc_tpu.sim_compiled.

The cases of tests/test_mhe_compiled.py, one for one: each builds the
``mpc_tpu`` estimator (and controller) and the port's (``device="cpu"``)
with the same arguments, both run the same call, and every returned array
is compared — to 1e-9 for the plain, NaN and continued records, to 1e-7
with bounds or MultipleShooting (the reference's own compiled-vs-host
bars), and to 1e-6 for the MHE → LinMPC loop, whose LinMPC solves with
ADMM (the port's ADMM parity bar, tests/test_torch_sim.py).
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


def on_cpu(pkg):
    return {"device": CPU} if pkg is mt else {}


def loops(pkg):
    return rs if pkg is mr else ps


def model(pkg):
    return pkg.LinModel(pkg.tf(3, [10, 1]), 1.0)


def data(N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, 1)) * 0.5, rng.normal(size=(N, 1)) * 0.2


def host_trace(mhe, Ym, U):
    X = np.zeros((Ym.shape[0], mhe.nx_hat))
    for k in range(Ym.shape[0]):
        X[k] = mhe.preparestate(Ym[k])
        mhe.updatestate(U[k], Ym[k])
    return X


def same(a, b, tol):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        if x.dtype == bool:
            assert np.array_equal(x, y), k
        else:
            assert np.abs(x - y).max() < tol, k


def plain(pkg, He):
    return pkg.MovingHorizonEstimator(model(pkg), He=He, **on_cpu(pkg))


def bounded(pkg, He):
    e = plain(pkg, He)
    e.setconstraint(xhatmin=[-0.4, -0.4], xhatmax=[0.4, 0.4])
    return e


def shooting(pkg, He):
    return pkg.MovingHorizonEstimator(model(pkg), He=He, transcription=pkg.MultipleShooting(),
                                      **on_cpu(pkg))


def time_varying(pkg, He):
    """Capital-form bounds from the start: the full-window alignment while
    the window fills (the reference's documented behaviour)."""
    e = plain(pkg, He)
    e.setconstraint(Xhatmax=np.linspace(0.2, 0.6, 2 * (He + 1)),
                    Xhatmin=-np.linspace(0.6, 0.2, 2 * (He + 1)))
    return e


def dropout(Ym):
    Ym = Ym.copy()
    Ym[5] = np.nan
    Ym[11] = np.nan
    return Ym


# name -> (estimator maker, He, N, seed, measurement edit, bar)
CASES = {
    "plain": (plain, 5, 18, 0, None, 1e-9),
    "nan_dropout": (plain, 4, 16, 3, dropout, 1e-9),
    "bounds": (bounded, 4, 15, 7, lambda Y: 3.0 * Y, 1e-7),
    "multiple_shooting": (shooting, 4, 14, 1, None, 1e-7),
    "time_varying_bounds": (time_varying, 4, 12, 2, lambda Y: 3.0 * Y, 1e-7),
}


@pytest.mark.parametrize("name", list(CASES))
def test_record_matches_reference(name):
    make, He, N, seed, edit, tol = CASES[name]
    Ym, U = data(N, seed)
    if edit is not None:
        Ym = edit(Ym)
    outs = [loops(pkg).CompiledMHELoop(make(pkg, He)).run(Ym, U) for pkg in (mr, mt)]
    same(*outs, tol)
    assert outs[1]["ok"].all()
    if name == "bounds":
        assert outs[1]["X_hat"].max() <= 0.4 + 1e-6


def test_record_matches_host_stepping():
    """The port's loop against the port's own host protocol."""
    Ym, U = data(18)
    Xh = host_trace(plain(mt, 5), Ym, U)
    out = ps.CompiledMHELoop(plain(mt, 5)).run(Ym, U)
    assert np.abs(out["X_hat"] - Xh).max() < 1e-9


def test_continues_host_state():
    """Host-step half the record, then the loop on the rest, in both
    packages; the port's against the reference's and its own full trace."""
    Ym, U = data(16, seed=9)
    outs = []
    for pkg in (mr, mt):
        h = plain(pkg, 5)
        host_trace(h, Ym[:8], U[:8])
        outs.append(loops(pkg).CompiledMHELoop(h).run(Ym[8:], U[8:]))
    same(*outs, 1e-9)
    full = host_trace(plain(mt, 5), Ym, U)
    assert np.abs(outs[1]["X_hat"] - full[8:]).max() < 1e-9


def test_fused_mhe_mpc_matches_reference():
    """CompiledMHEMPCLoop, the ManualEstimator composition (manual.jl:99-128)."""
    outs = []
    for pkg in (mr, mt):
        mhe = plain(pkg, 5)
        ctrl = pkg.LinMPC(pkg.ManualEstimator(model(pkg)), Hp=10, Hc=2, **on_cpu(pkg))
        mhe.initstate(np.zeros(1), np.zeros(1))
        outs.append(loops(pkg).CompiledMHEMPCLoop(mhe, ctrl).run(20, ry=np.array([4.0]),
                                                                y_noise=[0.1], seed=3))
    for k in ("T_data", "Y_data", "U_data", "Ry_data", "D_data", "X_est_data"):
        assert np.abs(getattr(outs[0], k) - getattr(outs[1], k)).max() < 1e-6, k
    assert outs[1].X_data is None and outs[1].Y_est_data is None


def test_fused_mhe_mpc_matches_host_composition():
    """The port's fused loop against the same composition stepped on the
    host with the port's objects."""
    N = 12
    rng = np.random.default_rng(3)
    eps_y = 0.1 * rng.normal(size=(N, 1))
    mhe = plain(mt, 5)
    ctrl = mt.LinMPC(mt.ManualEstimator(model(mt)), Hp=10, Hc=2, qp_solver="active_set",
                     device=CPU)
    plant = model(mt)
    mhe.initstate(np.zeros(1), np.zeros(1))
    Y, U = np.zeros((N, 1)), np.zeros((N, 1))
    for k in range(N):
        y = plant.evaloutput() + eps_y[k]
        ctrl.setstate(mhe.preparestate(y))
        ctrl.preparestate(y)
        u = ctrl.moveinput([4.0])
        Y[k], U[k] = y, u
        plant.updatestate(u)
        mhe.updatestate(u, y)
    mhe2 = plain(mt, 5)
    mhe2.initstate(np.zeros(1), np.zeros(1))
    ctrl2 = mt.LinMPC(mt.ManualEstimator(model(mt)), Hp=10, Hc=2, qp_solver="active_set",
                      device=CPU)
    res = ps.CompiledMHEMPCLoop(mhe2, ctrl2).run(N, ry=[4.0], y_noise=[0.1], seed=3)
    assert np.abs(U - res.u_data).max() < 1e-9
    assert np.abs(Y - res.y_data).max() < 1e-9


def test_rejections():
    for pkg in (mr, mt):
        L = loops(pkg)
        m = model(pkg)
        mhe = pkg.MovingHorizonEstimator(m, He=4, nint_ym=[2], **on_cpu(pkg))
        ctrl = pkg.LinMPC(pkg.ManualEstimator(m), Hp=10, Hc=2, **on_cpu(pkg))
        with pytest.raises(ValueError, match="mismatch"):
            L.CompiledMHEMPCLoop(mhe, ctrl)
        with pytest.raises(TypeError, match="MovingHorizonEstimator"):
            L.CompiledMHELoop(pkg.KalmanFilter(m))
        with pytest.raises(ValueError, match="direct=True"):
            L.CompiledMHELoop(pkg.MovingHorizonEstimator(m, He=4, direct=False,
                                                         **on_cpu(pkg)))
        ukf = pkg.UnscentedKalmanFilter(m, **on_cpu(pkg))
        with pytest.raises(TypeError, match="KalmanFilter covestim"):
            L.CompiledMHELoop(pkg.MovingHorizonEstimator(m, He=4, covestim=ukf,
                                                         **on_cpu(pkg)))
