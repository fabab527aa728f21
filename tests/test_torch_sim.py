"""The port's ``sim`` against mpc_tpu.sim.

The cases of tests/test_sim_plot.py and the README flow, each run through
both packages' ``sim`` with the same arguments (seeded noise included):
open loop on a model, closed loop on an estimator and on a LinMPC with
either QP backend.  Every array of the two SimResults agrees to 1e-6.
"""
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt

torch.set_num_threads(1)

CPU = torch.device("cpu")


def LinMPC(pkg, *args, **kw):
    """``pkg.LinMPC``, the port's asked for the CPU (its default is the GPU)."""
    return pkg.LinMPC(*args, **kw, **({"device": CPU} if pkg is mt else {}))


ARRAYS = ("T_data", "Y_data", "U_data", "Ry_data", "D_data", "X_data",
          "Y_est_data", "X_est_data")


def same_result(rr, rp):
    for k in ARRAYS:
        a, b = getattr(rr, k), getattr(rp, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.shape == b.shape, k
            assert np.max(np.abs(a - b), initial=0.0) < 1e-6, k


def siso(pkg):
    return pkg.LinModel(pkg.tf(2, [10, 1]), 1.0)


def disturbed(pkg):
    G = np.array([[pkg.tf(3, [30, 1]), pkg.tf(-2, [5, 1])]], dtype=object)
    return pkg.LinModel(G, 1.0, i_d=[1])


def readme(pkg, qp_solver):
    G = pkg.tf_matrix([[pkg.tf(2, [10, 1]) * pkg.delay(20)],
                       [pkg.tf(10, [4, 1])]])
    c = LinMPC(pkg, pkg.LinModel(G, 1.0), Mwt=[1, 0], Nwt=[0.1], qp_solver=qp_solver)
    return c.setconstraint(ymax=[np.inf, 35])


CASES = {
    "model_open_loop": lambda pkg: (siso(pkg), 30, dict(u=[1.0])),
    "model_open_loop_x0_d": lambda pkg: (disturbed(pkg), 20,
                                         dict(u=[0.5], d=[0.2], x_0=[1.0, -0.5])),
    "estimator_closed_loop": lambda pkg: (pkg.SteadyKalmanFilter(siso(pkg)), 25,
                                          dict(ry=[0.0], y_step=[0.3])),
    "kalman_noise_x0": lambda pkg: (pkg.KalmanFilter(pkg.LinModel(pkg.tf(3, [10, 1]), 1.0)),
                                    12, dict(y_noise=[0.1], x_0=[2.0])),
    "controller_with_noise": lambda pkg: (LinMPC(pkg, siso(pkg), Hp=10, Hc=2), 30,
                                          dict(ry=[1.0], y_noise=[0.01],
                                               u_noise=[0.01], seed=3)),
    "controller_x0_xhat0": lambda pkg: (LinMPC(pkg, siso(pkg), Hp=10, Hc=2), 15,
                                        dict(ry=[0.5], x_0=[1.0], x_hat_0=[1.0, 0.0])),
    "measured_disturbance_plant": lambda pkg: (LinMPC(pkg, disturbed(pkg), Hp=15, Hc=2),
                                               40, dict(ry=[1.0], d=[0.2], d_step=[0.1],
                                                        d_noise=[0.05], x_noise=[0.01, 0.0])),
    "readme_admm": lambda pkg: (readme(pkg, "admm"), 40, dict(ry=[5, 0])),
    "readme_active_set": lambda pkg: (readme(pkg, "active_set"), 40, dict(ry=[5, 0])),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sim_matches_reference(name):
    results = []
    for pkg in (mr, mt):
        obj, N, kw = CASES[name](pkg)
        results.append(pkg.sim(obj, N, **kw))
    same_result(*results)
    assert isinstance(results[1], mt.SimResult)


def test_readme_flow_bounds_and_tracking():
    """README.md:9-21 on the port: y1 reaches 5 and y2 rides its soft bound
    of 35 (tests/test_linmpc.py:85-96), with either backend."""
    for qp in ("admm", "active_set"):
        res = mt.sim(readme(mt, qp), 40, [5, 0])
        assert np.isclose(res.Y_data[-1, 0], 5.0, atol=1e-2)
        assert res.Y_data[:, 1].max() <= 35.0 + 1e-4
        assert np.isclose(res.Y_data[:, 1].max(), 35.0, atol=1e-3)


def test_progress_and_plot(tmp_path):
    """``progress`` callbacks and ``SimResult.plot`` (matplotlib, imported by
    the method) on the port's results."""
    m = mt.LinModel(mt.tf(2, [10, 1]), 3.0)
    hits = []
    res = mt.sim(mt.LinMPC(m, Hp=5, device=CPU), 8, [1.0],
                 progress=lambda k, n: hits.append((k, n)))
    assert hits == [(k, 8) for k in range(8)]
    pytest.importorskip("matplotlib")
    f = tmp_path / "ctrl.png"
    fig = res.plot(str(f), ymax=[1.5], ymin=[-0.5])
    assert f.exists() and len(fig.axes) == 2
