"""The port's compiled linear loops against mpc_tpu.sim_compiled.

The cases of tests/test_sim_compiled.py on a LinModel plant, one for one:
each builds the ``mpc_tpu`` object and the port's (``device="cpu"``) with
the same arguments, both run the same call, and every returned array is
compared — to 1e-9 with the Goldfarb–Idnani QP, to 1e-6 with ADMM (the
port's ADMM parity bar, tests/test_torch_sim.py).  Besides: ``mesh=``
raises, lane i of ``run_fleet`` equals the port's own ``run(seed=seed+i)``,
and a run's outputs leave the device in one copy.
"""
import copy

import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu import sim_compiled as rs
from mpc_tpu.parallel import random_cstr_controllers as ref_cstr
from mpc_tpu_torch import sim_compiled as ps
from mpc_tpu_torch.parallel import random_cstr_controllers as port_cstr

torch.set_num_threads(1)
CPU = torch.device("cpu")
GI, ADMM = 1e-9, 1e-6
ARRAYS = ("T_data", "Y_data", "U_data", "Ry_data", "D_data", "X_data",
          "Y_est_data", "X_est_data")


def loops(pkg):
    return rs if pkg is mr else ps


def on_cpu(pkg):
    return {"device": CPU} if pkg is mt else {}


def same(a, b, tol):
    """Every array of two SimResults (or two dicts of arrays) agrees."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        pairs = [(k, a[k], b[k]) for k in a]
    else:
        pairs = [(k, getattr(a, k), getattr(b, k)) for k in ARRAYS]
    for k, x, y in pairs:
        assert (x is None) == (y is None), k
        if x is None:
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, k
        if x.dtype == bool:
            assert np.array_equal(x, y), k
        else:
            assert np.max(np.abs(x - y), initial=0.0) < tol, k


def cstr_G(pkg):
    return pkg.tf_matrix([[pkg.tf(1.90, [18, 1]), pkg.tf(1.90, [18, 1])],
                          [pkg.tf(-0.74, [8, 1]), pkg.tf(0.74, [8, 1])]])


def mk(pkg, **kw):
    c = pkg.LinMPC(pkg.LinModel(cstr_G(pkg), 2.0), Hp=10, Hc=2,
                   Mwt=[1, 1], Nwt=[0.1, 0.1], **kw, **on_cpu(pkg))
    c.setconstraint(umin=[-20, -20], umax=[20, 20])
    return c


def mk_kf(pkg):
    c = pkg.LinMPC(pkg.KalmanFilter(pkg.LinModel(cstr_G(pkg), 2.0)),
                   Hp=10, Hc=2, Mwt=[1, 1], Nwt=[0.1, 0.1], **on_cpu(pkg))
    c.setconstraint(umin=[-20, -20], umax=[20, 20])
    return c


def mk_nd(pkg, Hp=10):
    Gd = pkg.tf_matrix([[pkg.tf(0.74, [8, 1])], [pkg.tf(0.74, [8, 1])]])
    GG = np.hstack([np.asarray(cstr_G(pkg), object), np.asarray(Gd, object)])
    c = pkg.LinMPC(pkg.LinModel(GG, 2.0, i_d=[2]), Hp=Hp, Hc=2, Mwt=[1, 1],
                   Nwt=[0.1, 0.1], qp_solver="active_set", **on_cpu(pkg))
    c.setconstraint(umin=[-20, -20], umax=[20, 20])
    return c


NOISE = dict(y_noise=[0.1, 0.2], u_noise=[0.05, 0.05], u_step=[0.5, 0.0],
             y_step=[0.0, 0.3], seed=7)
RY_TRAJ = np.vstack([np.tile([2.0, 0.5], (10, 1)), np.tile([6.0, -1.0], (10, 1))])
# name -> (controller maker, run's N and keywords, bar)
RUNS = {
    "admm": (lambda pkg: mk(pkg), 30, dict(ry=[5, 1]), ADMM),
    "admm_noise": (lambda pkg: mk(pkg), 25, dict(ry=[5, 1], **NOISE), ADMM),
    "active_set": (lambda pkg: mk(pkg, qp_solver="active_set"), 20, dict(ry=[5, 1]), GI),
    "kalman_filter": (mk_kf, 25, dict(ry=[5, 1], y_noise=[0.1, 0.1], seed=4), ADMM),
    "measured_disturbance": (mk_nd, 20, dict(ry=[4, 0], d=[0.5], d_step=[0.3],
                                             d_noise=[0.05], y_noise=[0.05, 0.05],
                                             seed=6), GI),
    "time_varying_setpoint": (lambda pkg: mk(pkg, qp_solver="active_set"), 20,
                              dict(ry=RY_TRAJ), GI),
    "x0_xhat0_lastu": (lambda pkg: mk(pkg, qp_solver="active_set"), 12,
                       dict(ry=[3, 1], x_0=[0.5, -0.2], x_hat_0=[0.4, -0.1, 0.1, 0.0],
                            lastu=[1.0, 0.5], x_noise=[0.01, 0.0], seed=2), GI),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_run_matches_reference(name):
    make, N, kw, tol = RUNS[name]
    res = [loops(pkg).CompiledClosedLoop(make(pkg)).run(N, **kw) for pkg in (mr, mt)]
    same(*res, tol)
    assert isinstance(res[1], mt.SimResult) and res[1].obj is not None
    if name == "time_varying_setpoint":
        assert abs(res[1].y_data[9, 0] - 2.0) < 0.5
        assert abs(res[1].y_data[-1, 0] - 6.0) < 0.8


@pytest.mark.parametrize("seed", [11, 29])
def test_fuzz_random_plants(seed):
    """Randomized plants, tunings and noise (ADMM)."""
    kw = dict(y_noise=[0.3, 0.3], u_noise=[0.1, 0.1], seed=seed)
    rr = rs.CompiledClosedLoop(ref_cstr(1, Hp=8, Hc=3, seed=seed)[0]).run(20, ry=[6, -2], **kw)
    rp = ps.CompiledClosedLoop(port_cstr(1, Hp=8, Hc=3, seed=seed, device=CPU)[0]).run(
        20, ry=[6, -2], **kw)
    same(rr, rp, ADMM)


# name -> (controller maker, B, N, run_fleet keywords without x_hat_0, bar)
FLEETS = {
    "active_set": (lambda pkg: mk(pkg, qp_solver="active_set"), 3, 15,
                   dict(ry=[5, 1], y_noise=[0.1, 0.2], u_noise=[0.05, 0.05], seed=10), GI),
    "admm": (lambda pkg: mk(pkg), 3, 10,
             dict(ry=[5, 1], y_noise=[0.1, 0.2], x_noise=[0.01, 0.02], seed=3), ADMM),
    "measured_disturbance": (lambda pkg: mk_nd(pkg, Hp=8), 2, 12,
                             dict(ry=[4, 0], d=[0.3], y_noise=[0.1, 0.1], seed=31), GI),
}


@pytest.mark.parametrize("name", list(FLEETS))
def test_run_fleet_matches_reference_and_own_runs(name):
    """run_fleet against the reference's, and lane i against the port's own
    run(seed=seed+i) from the same estimator state."""
    make, B, N, kw, tol = FLEETS[name]
    outs = []
    for pkg in (mr, mt):
        loop = loops(pkg).CompiledClosedLoop(make(pkg))
        xh = np.tile(np.asarray(loop.estim.xop_hat, float), (B, 1))
        outs.append(loop.run_fleet(B, N, x_hat_0=xh, **kw))
    same(*outs, tol)
    assert outs[1]["conv"].all() and outs[1]["U"].shape == (B, N, 2)
    seed = kw.pop("seed")
    for i in range(B):
        loop = ps.CompiledClosedLoop(make(mt))
        ri = loop.run(N, x_hat_0=np.asarray(loop.estim.xop_hat, float), seed=seed + i, **kw)
        assert np.abs(outs[1]["U"][i] - ri.u_data).max() < tol
        assert np.abs(outs[1]["Y"][i] - ri.y_data).max() < tol
        assert np.abs(outs[1]["X_hat"][i] - ri.X_est_data).max() < tol


def test_heterogeneous_fleet_model_mismatch():
    """Per-lane plants ≠ controller models, against the reference's fleet;
    lanes match the port's own single loops and stay offset-free."""
    B, N = 2, 25
    outs, plants = [], {}
    for pkg, cstr in ((mr, ref_cstr), (mt, port_cstr)):
        ctrls = cstr(B, Hp=8, Hc=2, seed=5, **on_cpu(pkg))
        plants[pkg] = []
        for c in ctrls:
            p = copy.deepcopy(c.estim.model)
            p.Bu = np.asarray(p.Bu) * 1.1    # 10% gain mismatch
            plants[pkg].append(p)
        fleet = loops(pkg).CompiledClosedLoopFleet(ctrls, [copy.deepcopy(p)
                                                            for p in plants[pkg]])
        outs.append(fleet.run(N, ry=[5, 1], y_noise=[0.05, 0.05], seed=20))
    same(*outs, ADMM)
    ctrls = port_cstr(B, Hp=8, Hc=2, seed=5, device=CPU)
    for i in range(B):
        c = ctrls[i]
        ri = ps.CompiledClosedLoop(c, copy.deepcopy(plants[mt][i])).run(
            N, ry=[5, 1], y_noise=[0.05, 0.05], seed=20 + i,
            x_hat_0=np.asarray(c.estim.x0_hat + c.estim.xop_hat, float))
        assert np.abs(outs[1]["U"][i] - ri.u_data).max() < ADMM
    assert np.abs(outs[1]["Y"][:, -1, 0] - 5.0).max() < 0.35


def test_heterogeneous_fleet_active_set_defaults():
    """GI lanes with the default setpoints (each lane's yop) and d."""
    outs = []
    for pkg, cstr in ((mr, ref_cstr), (mt, port_cstr)):
        ctrls = cstr(3, Hp=8, Hc=2, seed=2, qp_solver="active_set",
                     **on_cpu(pkg))
        outs.append(loops(pkg).CompiledClosedLoopFleet(ctrls).run(10, y_noise=[0.1, 0.1],
                                                                  seed=1))
    same(*outs, GI)


def test_rejections():
    m = lambda pkg: pkg.LinModel(pkg.tf(3, [10, 1]), 1.0)
    for pkg in (mr, mt):
        L = loops(pkg)
        ukf = pkg.LinMPC(pkg.UnscentedKalmanFilter(m(pkg), **on_cpu(pkg)), Hp=10, Hc=2,
                         **on_cpu(pkg))
        with pytest.raises(TypeError, match="constant-gain"):
            L.CompiledClosedLoop(ukf)
        pred = pkg.LinMPC(pkg.SteadyKalmanFilter(m(pkg), direct=False), Hp=10, Hc=2,
                          **on_cpu(pkg))
        with pytest.raises(ValueError, match="direct=True"):
            L.CompiledClosedLoop(pred)
        c = pkg.LinMPC(m(pkg), Hp=10, Hc=2, **on_cpu(pkg))
        with pytest.raises(TypeError, match="LinModel"):
            L.CompiledClosedLoop(c, plant=pkg.NonLinModel(
                *_siso_fns(pkg), 1.0, 1, 1, 1, **on_cpu(pkg)))
        with pytest.raises(TypeError, match="constant-gain"):
            L.CompiledClosedLoopFleet([mk_kf(pkg)])
        with pytest.raises(ValueError, match="one plant per controller"):
            L.CompiledClosedLoopFleet([mk(pkg)], [])


def _siso_fns(pkg):
    if pkg is mr:
        import jax.numpy as jnp
        return (lambda x, u, d, p: jnp.array([0.9 * x[0] + u[0]]),
                lambda x, d, p: jnp.array([x[0]]))
    return (lambda x, u, d, p: torch.stack([0.9 * x[0] + u[0]]),
            lambda x, d, p: torch.stack([x[0]]))


def test_mesh_is_not_ported():
    """run_fleet shards over a mesh of devices, as the reference's over a
    ``jax.sharding.Mesh``: a CPU mesh gives the unsharded answers, and a
    mesh that is not a sequence of devices is a ``TypeError`` (the parity
    cases are tests/test_torch_mesh.py)."""
    loop = ps.CompiledClosedLoop(mk(mt, qp_solver="active_set"))
    with pytest.raises(TypeError, match="mesh"):
        loop.run_fleet(8, 10, ry=[5, 1], seed=2, mesh=object())
    a = loop.run_fleet(8, 10, ry=[5, 1], seed=2, y_noise=[0.1, 0.1], mesh=["cpu"] * 2)
    b = loop.run_fleet(8, 10, ry=[5, 1], seed=2, y_noise=[0.1, 0.1])
    for k in b:
        assert np.allclose(a[k], b[k], rtol=0, atol=1e-12), k


def test_active_set_float32():
    """float32 data with the GI operator carried in its float64 slots."""
    res = ps.CompiledClosedLoop(mk(mt, qp_solver="active_set", dtype=torch.float32)).run(
        15, ry=[5, 1])
    assert res.U_data.dtype == np.float32 and np.all(np.isfinite(res.U_data))
    ref = rs.CompiledClosedLoop(mk(mr, qp_solver="active_set")).run(15, ry=[5, 1])
    assert np.abs(res.U_data - ref.U_data).max() < 1e-3 * (1 + np.abs(ref.U_data).max())
    fl = ps.CompiledClosedLoop(mk(mt, qp_solver="active_set", dtype=torch.float32)).run_fleet(
        4, 6, ry=[5.0, 1.0], seed=0)
    assert fl["U"].shape == (4, 6, 2) and np.all(np.isfinite(fl["U"]))


def test_outputs_leave_the_device_once(monkeypatch):
    """A run uploads its inputs once and copies its outputs back once: no
    tensor goes to the host inside the loop."""
    loop = ps.CompiledClosedLoop(mk(mt, qp_solver="active_set"))
    calls = []
    orig = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: calls.append(t.shape)
                        or orig(t, *a, **k))
    loop.run_fleet(2, 7, ry=[5, 1], seed=0)
    assert len(calls) == 1 and calls[0] == (7 * 2 * (2 + 2 + 2 + 2 + 4 + 1),)
