"""The port's Ts-deadline policy (``limit_solve_time``) against mpc_tpu's.

The five cases of tests/test_deadline.py.  The policy's decisions follow
wall clocks, so each case holds the port to the same assertions as the
reference and, where the clock cannot move the answer (a fixed iteration
budget, the Ts = 1 µs floor of 50), to the reference's numbers: iteration
counts equal and u or x to 1e-6.
"""
import numpy as np
import torch

import jax.numpy as jnp

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.ops import solve_qp as ref_solve_qp
from mpc_tpu.parallel import BatchedLinMPC as RefFleet
from mpc_tpu_torch.ops import solve_qp
from mpc_tpu_torch.parallel import BatchedLinMPC

torch.set_num_threads(1)

CPU = torch.device("cpu")


def LinMPC(pkg, *args, **kw):
    """``pkg.LinMPC``, the port's asked for the CPU (its default is the GPU)."""
    return pkg.LinMPC(*args, **kw, **({"device": CPU} if pkg is mt else {}))


def _hard_qp(n=20, m=60, seed=3):
    """tests/test_deadline.py::_hard_qp: ill-scaled, many active rows."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(n, n))
    scales = np.logspace(-2, 2, n)
    P = (H * scales) @ (H * scales).T + 1e-3 * np.eye(n)
    q = rng.normal(size=n) * 10
    A = rng.normal(size=(m, n))
    Ax = A @ (rng.normal(size=n) * 0.05)
    return P, q, A, Ax - rng.uniform(0.01, 0.1, m), Ax + rng.uniform(0.01, 0.1, m)


def test_iter_budget_caps_solver_iterations():
    args = _hard_qp()
    t = [torch.from_numpy(a) for a in args]
    j = [jnp.asarray(a) for a in args]
    for kw in (dict(), dict(iter_budget=30), dict(max_iter=20)):
        ref = ref_solve_qp(*j, scaling=0, **kw)
        got = solve_qp(*t, scaling=0, **kw)
        assert int(got.iters) == int(ref.iters), kw
        assert bool(got.converged) == bool(ref.converged), kw
        assert np.max(np.abs(np.asarray(ref.x) - got.x.numpy())) < 1e-6, kw
    assert int(solve_qp(*t, scaling=0).iters) > 60
    assert int(solve_qp(*t, scaling=0, iter_budget=30).iters) <= 40
    assert int(solve_qp(*t, scaling=0, max_iter=20).iters) <= 20


def _fast_diag(pkg, Ts, qp_solver="admm"):
    G = pkg.ss(np.diag([0.6, 0.5, 0.7, 0.4]), np.eye(4), np.eye(4),
               np.zeros((4, 4)), Ts)
    c = LinMPC(pkg, pkg.LinModel(G, Ts), Hp=10, Hc=4, Mwt=np.ones(4),
               Nwt=np.full(4, 0.1), Cwt=1e3, limit_solve_time=True,
               qp_solver=qp_solver)
    return c.setconstraint(umin=np.full(4, -0.3), umax=np.full(4, 0.3),
                           ymin=np.full(4, -0.2), ymax=np.full(4, 0.2))


def test_linmpc_deadline_policy_caps_and_flags():
    """Ts = 1 µs: after the first measured period the budget clamps to its
    floor of 50, the QP respects it and every period is a miss — in both
    packages, with the same u and iteration counts (the budget does not
    depend on the clock once it sits on the floor)."""
    ctrls = [_fast_diag(pkg, 1e-6) for pkg in (mr, mt)]
    ry = np.full(4, 5.0)
    for k in range(4):
        us = []
        for c in ctrls:
            c.estim.preparestate(np.full(4, 0.1 * k))
            us.append(c.moveinput(ry=-ry if k % 2 else ry))
            c.estim.updatestate(c.getinfo()["u"], np.full(4, 0.1 * k))
        ir, ip = (c.getinfo() for c in ctrls)
        assert ir["iter_budget"] == ip["iter_budget"], k
        assert ir["iters"] == ip["iters"], k
        assert np.max(np.abs(np.asarray(us[0]) - us[1])) < 1e-6, k
    c = ctrls[1]
    info = c.getinfo()
    assert c._iter_cost is not None and c._iter_cost > 0
    assert info["iter_budget"] == 50
    assert info["iters"] <= 60
    assert info["deadline_miss"] is True
    assert info["solve_time"] > 1e-6


def test_linmpc_deadline_policy_no_miss_when_fast():
    """A generous Ts never caps iterations nor flags a miss (both solvers)."""
    for qp in ("admm", "active_set"):
        outs = []
        for pkg in (mr, mt):
            G = pkg.ss(np.array([[0.5]]), np.array([[1.0]]), np.array([[1.0]]),
                       np.array([[0.0]]), 50.0)
            c = LinMPC(pkg, pkg.LinModel(G, 50.0), Hp=5, Hc=2,
                       limit_solve_time=True, qp_solver=qp)
            for _ in range(3):
                c.estim.preparestate([0.0])
                u = c.moveinput(ry=[1.0])
                c.estim.updatestate(c.getinfo()["u"], [0.0])
            outs.append(u)
            info = c.getinfo()
            assert info["deadline_miss"] is False
            assert info["converged"]
            assert info["iter_budget"] < 2**30     # the policy is on
        assert np.max(np.abs(np.asarray(outs[0]) - outs[1])) < 1e-6


def _fleet_ctrls(pkg, Hp=5, Hc=2, n=2, bounded=False):
    nx = 2 if bounded else 1
    G = pkg.ss(np.diag([0.6, 0.5])[:nx, :nx] if bounded else np.array([[0.5]]),
               np.eye(nx), np.eye(nx), np.zeros((nx, nx)), 1e-6)
    ctrls = []
    for _ in range(n):
        c = LinMPC(pkg, pkg.LinModel(G, 1e-6), Hp=Hp, Hc=Hc,
                   Cwt=1e3 if bounded else 1e5)
        if bounded:
            c.setconstraint(umin=np.full(2, -0.3), umax=np.full(2, 0.3),
                            ymin=np.full(2, -0.2), ymax=np.full(2, 0.2))
        ctrls.append(c)
    return ctrls


def test_batched_fleet_deadline_stats():
    """Per-step wall time, budget and miss counter of a Ts = 1 µs fleet;
    the first step neither seeds the EWMA nor counts."""
    ref = RefFleet(_fleet_ctrls(mr), reps=2, limit_solve_time=True)
    bat = BatchedLinMPC(_fleet_ctrls(mt), reps=2, limit_solve_time=True, device=CPU)
    for k in range(3):
        ym, ry = np.full((4, 1), 0.1 * k), np.ones((4, 1))
        u_r, _ = ref.step(jnp.asarray(ym), jnp.asarray(ry))
        u_p, _ = bat.step(ym, ry)
        assert bat.last_iter_budget == ref.last_iter_budget, k
        assert np.max(np.abs(np.asarray(u_r) - u_p.numpy())) < 1e-6, k
    assert bat.last_step_time is not None and bat.last_step_time > 0
    assert bat.last_deadline_miss is True
    assert bat.deadline_miss_count == ref.deadline_miss_count == 2
    assert bat.last_iter_budget >= 50


def test_multistep_deadline_in_graph():
    """multistep: the budget comes from the cost EWMA at the call's start,
    misses are estimated per period from one host copy per call, and a
    call with a new (K, B) shape neither seeds the EWMA nor counts."""
    ref = RefFleet(_fleet_ctrls(mr, 8, 3, bounded=True), reps=2, limit_solve_time=True)
    bat = BatchedLinMPC(_fleet_ctrls(mt, 8, 3, bounded=True), reps=2,
                        limit_solve_time=True, device=CPU)
    B, K = bat.B, 4
    rng = np.random.default_rng(31)
    ym_s = rng.normal(size=(K, B, 2)) * 0.1
    ry_s = np.tile(np.array([5.0, -5.0]), (K, B, 1))   # infeasible: many iters
    for call in range(3):
        n0 = bat.deadline_miss_count
        U_r, NC_r = ref.multistep(ym_s, ry_s)
        U_p, NC_p = bat.multistep(ym_s, ry_s)
        assert U_p.shape == (K, B, 2)
        if call == 0:
            # the first call counts nothing and leaves the budget unlimited
            assert bat.deadline_miss_count == 0 and bat._iter_cost is None
            assert np.max(np.abs(np.asarray(U_r) - U_p.numpy())) < 1e-6
        if call == 1:
            assert bat._iter_cost is not None and bat._iter_cost > 0
            assert np.max(np.abs(np.asarray(U_r) - U_p.numpy())) < 1e-6
    # third call: the policy is on; Ts = 1 µs → every period a miss, and
    # the budget (floor 50 + check slack) clamps the solver
    assert bat.deadline_miss_count - n0 == K
    assert bat.last_deadline_miss is True
    assert int(bat.last_iters[0]) <= 80
    assert np.array_equal(np.asarray(ref.last_iters), bat.last_iters.numpy())
    assert np.max(np.abs(np.asarray(U_r) - U_p.numpy())) < 1e-6
