"""The port's SLMPC against mpc_tpu.SLMPC (the cases of tests/test_slmpc.py
and the closed loops).

Both packages build the controller from the same pendulum and drive it with
the same measurements; the port runs in float64 on the CPU (the kernels'
plain versions).  Bars: Goldfarb–Idnani u to 1e-8 with equal QP iteration
counts and converged flags, ADMM u to 1e-6; the construct-time matrices to
1e-12.  The QP iteration counts are read by wrapping each package's
``solve_qp_active`` in its SLMPC module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu.controllers.slmpc as ref_slmpc
import mpc_tpu_torch as mt
import mpc_tpu_torch.controllers.slmpc as port_slmpc
from test_torch_nonlin import CPU, close, nonlin, pendulum

torch.set_num_threads(1)
BENCH = dict(Hp=15, Hc=2, Mwt=[0.5], Nwt=[2.5], sigmaQ=[0.1, 1.0], sigmaR=[5.0],
             sigmaQint_ym=[0.1])


def slmpc(pkg, model=None, qp_solver="admm", dtype=None, **kw):
    model = pendulum(pkg) if model is None else model
    kw = {**BENCH, **kw}
    if pkg is mt:
        kw["device"] = CPU
    c = pkg.SLMPC(model, qp_solver=qp_solver, dtype=dtype, **kw)
    return c.setconstraint(umin=[-1.5], umax=[1.5])


@pytest.fixture
def gi_iters(monkeypatch):
    """The GI iteration counts of every solve, per package."""
    out = {"ref": [], "port": []}

    def ref_wrap(*a, **k):
        sol = ref_orig(*a, **k)
        jax.debug.callback(lambda it: out["ref"].append(np.asarray(it).ravel()), sol.iters)
        return sol

    def port_wrap(*a, **k):
        sol = port_orig(*a, **k)
        out["port"].append(sol.iters.numpy().ravel())
        return sol
    ref_orig, port_orig = ref_slmpc.solve_qp_active, port_slmpc.solve_qp_active
    monkeypatch.setattr(ref_slmpc, "solve_qp_active", ref_wrap)
    monkeypatch.setattr(port_slmpc, "solve_qp_active", port_wrap)
    return out


def test_construct_time_matrices_match_reference():
    cr, cp = slmpc(mr), slmpc(mt)
    for k in ("Q_hat", "R_hat", "P0_hat", "As", "Cs_u", "Cs_y"):
        close(getattr(cr, k), getattr(cp, k), 1e-12)
    for k in ("M_Hp", "Nt_Hc", "L_Hp"):
        close(getattr(cr.weights, k), getattr(cp.weights, k), 1e-12)
    assert (cr.nZt, cr.n_eps, cr.nx_hat) == (cp.nZt, cp.n_eps, cp.nx_hat)
    for k, v in cr.state.items():
        close(v, cp.state[k], 0.0)
    for k, v in cr.bounds().items():
        close(v, cp.bounds()[k], 0.0)


def test_requires_nonlinmodel_and_valid_options():
    with pytest.raises(TypeError):
        mt.SLMPC(mt.LinModel(mt.tf(1, [1, 1]), 1.0), device=CPU)
    with pytest.raises(ValueError, match="qp_solver"):
        slmpc(mt, qp_solver="qp")
    with pytest.raises(TypeError, match="dtype"):
        slmpc(mt, dtype=np.float32)
    with pytest.raises(ValueError, match="move-blocking"):
        slmpc(mt, Hc=[2, 3])


@pytest.mark.parametrize("qp_solver", ["active_set", "admm"])
def test_swing_up_matches_reference(qp_solver, gi_iters):
    """tests/test_slmpc.py:22-36 and :94-116: the swing-up to 180° on the
    true pendulum (Hp=20, 40 periods), both QP backends."""
    cr, cp = (slmpc(pkg, Hp=20, qp_solver=qp_solver) for pkg in (mr, mt))
    plant = pendulum(mr)
    plant.setstate([0.0, 0.0])
    ry = np.array([180.0])
    us = []
    for k in range(40):
        y = plant.evaloutput()
        (ur, conv_r), (up, conv_p) = cr.moveinput_closed(y, ry), cp.moveinput_closed(y, ry)
        assert isinstance(up, np.ndarray) and isinstance(conv_p, bool)
        assert conv_r == conv_p, k
        close(ur, up, 1e-8 if qp_solver == "active_set" else 1e-6)
        us.append(up[0])
        plant.updatestate(np.asarray(ur))
    assert abs(plant.evaloutput()[0] - 180.0) < 2.0
    assert np.max(np.abs(us)) <= 1.5 + 1e-9
    if qp_solver == "active_set":
        jax.effects_barrier()
        assert len(gi_iters["ref"]) == len(gi_iters["port"]) == 40
        assert np.array_equal(np.concatenate(gi_iters["ref"]),
                              np.concatenate(gi_iters["port"]))
    close(cr.getstate(), cp.getstate(), 1e-8)


@pytest.mark.parametrize("qp_solver,chunk", [("active_set", 4), ("active_set", 8),
                                             ("admm", 4), ("admm", 8)])
def test_fleet_matches_reference(qp_solver, chunk, gi_iters):
    """tests/test_slmpc.py:39-91: a B=8 fleet with per-lane linearization,
    stepped with its true pendulums for 6 periods, chunked as asked."""
    B = 8
    cr, cp = (slmpc(pkg, qp_solver=qp_solver) for pkg in (mr, mt))
    step_r = cr.make_fleet_step(B, chunk=chunk)
    step_p = cp.make_fleet_step(B, chunk=chunk)
    st_r = cr.fleet_state(B)
    st_p = cp.state_from_arrays({k: np.asarray(v) for k, v in st_r.items()})
    bd_r, bd_p = cr.bounds(), cp.bounds()
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-0.3, 0.3, B), np.zeros(B)], 1)
    ry = np.full((B, 1), 90.0)
    fv = jax.vmap(lambda x, u: pendulum(mr).f(x, u, jnp.zeros(0), pendulum(mr).p))
    for k in range(6):
        ym = X[:, :1] * 180 / np.pi
        u_r, c_r, st_r = step_r(st_r, jnp.asarray(ym), jnp.asarray(ry), jnp.zeros((B, 0)), bd_r)
        u_p, c_p, st_p = step_p(st_p, torch.as_tensor(ym), torch.as_tensor(ry),
                                torch.zeros(B, 0, dtype=torch.float64), bd_p)
        assert np.array_equal(np.asarray(c_r), c_p.numpy()), k
        close(u_r, u_p, 1e-8 if qp_solver == "active_set" else 1e-6)
        assert np.all(np.abs(u_p.numpy()) <= 1.5 + 1e-9)
        X = np.asarray(fv(jnp.asarray(X), u_r))
    for key in ("x_hat", "P_hat", "lastu", "Z"):
        close(st_r[key], st_p[key], 1e-6)
    if qp_solver == "active_set":
        # the reference's callback sees the lanes of its vmap in no set
        # order: each period's counts are compared as a multiset
        jax.effects_barrier()
        per = lambda its: np.sort(np.concatenate(its).reshape(6, B), axis=1)
        assert np.array_equal(per(gi_iters["ref"]), per(gi_iters["port"]))
    with pytest.raises(ValueError, match="multiple of chunk"):
        cp.make_fleet_step(10, chunk=4)


def test_chunk_changes_no_answer():
    """Chunks of 4 and one chunk of 8 (clamped from 256) give the same bits."""
    cp = slmpc(mt, qp_solver="active_set")
    rng = np.random.default_rng(1)
    ym = torch.as_tensor(rng.uniform(-20, 20, (8, 1)))
    args = (ym, torch.full((8, 1), 90.0, dtype=torch.float64),
            torch.zeros(8, 0, dtype=torch.float64), cp.bounds())
    outs = [cp.make_fleet_step(8, chunk=ch)(cp.fleet_state(8), *args) for ch in (4, 256)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_operating_point_invariance():
    """tests/test_slmpc.py:119-155: two op-point parameterizations of the
    same physics act identically, and the port follows the reference."""
    uop, yop = 0.5, 30.0

    def fj(x, u, d, par):
        g, L, K, m = par
        return jnp.array([x[1], -g / L * jnp.sin(x[0]) - K / m * x[1] + u[0] / (m * L ** 2)])

    def ft(x, u, d, par):
        g, L, K, m = par
        return torch.stack([x[1], -g / L * torch.sin(x[0]) - K / m * x[1] + u[0] / (m * L ** 2)])
    hj = lambda x, d, par: jnp.array([x[0] * 180 / jnp.pi])
    ht = lambda x, d, par: torch.stack([x[0] * 180 / torch.pi])
    ctrls = []
    for pkg in (mr, mt):
        mA = nonlin(pkg, fj, ft, hj, ht, 0.1, 1, 2, 1, p=pendulum(mr).p)
        mB = nonlin(pkg, lambda x, u, d, p: fj(x, u + uop, d, p),
                    lambda x, u, d, p: ft(x, u + uop, d, p),
                    lambda x, d, p: hj(x, d, p) - yop, lambda x, d, p: ht(x, d, p) - yop,
                    0.1, 1, 2, 1, p=pendulum(mr).p)
        mB.setop(uop=[uop], yop=[yop])
        ctrls += [slmpc(pkg, m, qp_solver="active_set", nint_ym=[1]) for m in (mA, mB)]
    plant = pendulum(mr)
    ry = np.array([120.0])
    for k in range(25):
        y = plant.evaloutput()
        us = [c.moveinput_closed(y, ry)[0] for c in ctrls]
        close(us[2], us[3], 1e-7)
        close(us[0], us[2], 1e-8)
        close(us[1], us[3], 1e-8)
        plant.updatestate(us[0])


def test_setstate_getstate():
    f = lambda x, u, d, par: torch.stack([x[1], -torch.sin(x[0]) - x[1] + u[0]])
    h = lambda x, d, par: x[:1]
    m = mt.NonLinModel(f, h, 0.1, 1, 2, 1, device=CPU)
    m.setop(xop=[0.1, 0.0])
    c = mt.SLMPC(m, Hp=5, Hc=2, device=CPU)
    c.setstate([0.3, -0.1, 0.05], P_hat=np.eye(3) * 2)
    assert np.allclose(c.getstate(), [0.3, -0.1, 0.05])
    assert np.allclose(c.state["x_hat"].numpy(), [0.2, -0.1, 0.05])
    assert np.allclose(c.state["P_hat"].numpy(), np.eye(3) * 2)
    for fn in (c.preparestate, c.updatestate, c.initstate):
        with pytest.raises(NotImplementedError):
            fn([0.0])
    with pytest.raises(ValueError):
        c.setstate([0.0, 0.0])
    with pytest.raises(KeyError):
        c.state_from_arrays({"x_hat": np.zeros(3)})


@pytest.mark.parametrize("qp_solver", ["active_set", "admm"])
def test_state_carried_from_reference(qp_solver):
    """The reference's state after 10 swing-up periods, carried into a
    fresh port controller: both continue in step for 8 more periods."""
    cr, cp = (slmpc(pkg, qp_solver=qp_solver) for pkg in (mr, mt))
    plant = pendulum(mr)
    ry = np.array([180.0])
    for _ in range(10):
        u, _ = cr.moveinput_closed(plant.evaloutput(), ry)
        plant.updatestate(np.asarray(u))
    cp.state = cp.state_from_arrays({k: np.asarray(v) for k, v in cr.state.items()})
    for k in range(8):
        y = plant.evaloutput()
        (ur, _), (up, _) = cr.moveinput_closed(y, ry), cp.moveinput_closed(y, ry)
        close(ur, up, 1e-8 if qp_solver == "active_set" else 1e-6)
        plant.updatestate(np.asarray(ur))


def test_float32_gi_fleet_follows_reference():
    """The bench's mode: float32 data, GI with float64 slots (the reference
    under x64), B=8, measurement noise and a setpoint step: every period
    converged in both, u to 5e-3 (the packages round float32 sums in other
    orders; the largest difference seen is 2.0e-3, of a ±1.5 input range)."""
    B = 8
    cr, cp = (slmpc(pkg, qp_solver="active_set", dtype=dt)
              for pkg, dt in ((mr, jnp.float32), (mt, torch.float32)))
    step_r, step_p = cr.make_fleet_step(B), cp.make_fleet_step(B)
    st_r = cr.fleet_state(B)
    st_p = cp.state_from_arrays({k: np.asarray(v) for k, v in st_r.items()})
    assert st_p["x_hat"].dtype == torch.float32
    rng = np.random.default_rng(2)
    X = np.zeros((B, 2), np.float32)
    fv = jax.vmap(lambda x, u: pendulum(mr).f(x, u, jnp.zeros(0), pendulum(mr).p))
    for k in range(12):
        ym = (X[:, :1] * 180 / np.pi + rng.normal(size=(B, 1))).astype(np.float32)
        ry = np.full((B, 1), 180.0 if k < 6 else 170.0, np.float32)
        u_r, c_r, st_r = step_r(st_r, jnp.asarray(ym), jnp.asarray(ry),
                                jnp.zeros((B, 0), jnp.float32), cr.bounds())
        u_p, c_p, st_p = step_p(st_p, torch.as_tensor(ym), torch.as_tensor(ry),
                                torch.zeros(B, 0), cp.bounds())
        assert u_p.dtype == torch.float32
        assert bool(np.all(np.asarray(c_r))) and bool(c_p.all()), k
        close(u_r, u_p, 5e-3)
        X = np.asarray(fv(jnp.asarray(X, jnp.float64), np.asarray(u_r, np.float64)),
                       np.float32)
