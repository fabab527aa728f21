"""The port's BatchedNonLinMPC against mpc_tpu.parallel.BatchedNonLinMPC.

Both fleets get the same seeded measurements (noise on the reference's
true pendulums) and setpoints; the port runs in float64 on the CPU (the
kernels' plain versions).  Bars: u, Z̃ and ``last_kkt`` to 1e-8·(1 + max)
with Goldfarb–Idnani and 1e-6 with ADMM, ``last_iters`` equal.  The fleet
runs the bench's controller (MultipleShooting, the KKT exit), at Hp = 8.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.ops.qp import solve_qp as ref_solve_qp
from mpc_tpu.ops.qp_active import solve_qp_active as ref_solve_qp_active
from mpc_tpu.parallel import BatchedNonLinMPC as RefFleet
from mpc_tpu_torch.controllers import nonlinmpc as port_nonlinmpc
from mpc_tpu_torch.ops import solve_qp, solve_qp_active
from mpc_tpu_torch.parallel import BatchedNonLinMPC
from test_torch_nonlin import CPU, close, pendulum

torch.set_num_threads(1)


def bench(pkg, qp_solver="active_set", Hp=8, alpha=0.5, **kw):
    """bench.py:646-659 at a shorter horizon."""
    dev = {} if pkg is mr else {"device": CPU}
    est = pkg.UnscentedKalmanFilter(pendulum(pkg), sigmaQ=[0.1, 1.0], sigmaR=[5.0],
                                    nint_ym=[1], sigmaQint_ym=[0.1], alpha=alpha, **dev)
    c = pkg.NonLinMPC(est, Hp=Hp, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf, sqp_iters=15,
                      qp_solver=qp_solver, transcription=pkg.MultipleShooting(),
                      kkt_tol=1e-3, kkt_feas_tol=1e-4, **kw, **dev)
    return c.setconstraint(umin=[-1.5], umax=[1.5])


def rel(a, b, tol):
    a, b = np.asarray(a, float), np.asarray(b, float)
    close(a, b, tol * (1.0 + np.max(np.abs(b), initial=0.0)))


def inputs(B, K, seed=0):
    rng = np.random.default_rng(seed)
    ym = rng.normal(size=(K, B, 1)) * 2.0
    ry = np.where(np.arange(K)[:, None, None] < K // 2, 180.0, 170.0) * np.ones((K, B, 1))
    return ym, ry


@pytest.mark.parametrize("qp_solver,B,K", [("active_set", 6, 8), ("admm", 4, 5)])
def test_fleet_matches_reference(qp_solver, B, K):
    """B lanes swinging their true pendulums up from spread angles."""
    tol = 1e-8 if qp_solver == "active_set" else 1e-6
    fr = RefFleet(bench(mr, qp_solver), B)
    fp = BatchedNonLinMPC(bench(mt, qp_solver), B, chunk=2)
    noise, ry = inputs(B, K)
    pend = pendulum(mr)
    fv = jax.vmap(lambda x, u: pend.f(x, u, jnp.zeros(0), pend.p))
    X = np.stack([np.linspace(-0.3, 0.3, B), np.zeros(B)], 1)
    for k in range(K):
        ym = X[:, :1] * 180 / np.pi + noise[k]
        ur, Jr = fr.step(jnp.asarray(ym), jnp.asarray(ry[k]))
        up, Jp = fp.step(ym, ry[k])
        rel(ur, up, tol)
        rel(Jr, Jp, tol)
        rel(fr.state["Z_tilde"], fp.state["Z_tilde"], tol)
        rel(fr.last_kkt, fp.last_kkt, tol)
        assert np.array_equal(np.asarray(fr.last_iters), fp.last_iters.numpy()), k
        close(fr.last_viol, fp.last_viol, tol)
        X = np.asarray(fv(jnp.asarray(X), ur))
    for key in ("x0_hat", "P_hat", "lastu0"):
        rel(fr.state[key], fp.state[key], 1e-6)
    assert fp.last_kkt.shape == (B, 2) and up.shape == (B, 1) and Jp.shape == (B,)


def test_multistep_matches_steps_and_reference():
    """multistep(K) ≡ K successive steps (bit for bit), and the reference's
    multistep (tests/test_batch.py:473-505)."""
    B, K = 3, 4
    fa, fb = (BatchedNonLinMPC(bench(mt, Hp=6), B) for _ in range(2))
    ym, ry = inputs(B, K, seed=23)
    U, J = fa.multistep(ym * 5.0, ry)
    assert U.shape == (K, B, 1) and J.shape == (K, B)
    for k in range(K):
        u, j = fb.step(ym[k] * 5.0, ry[k])
        assert torch.equal(U[k], u) and torch.equal(J[k], j), k
    assert torch.equal(fa.last_iters, fb.last_iters)
    assert torch.equal(fa.last_kkt, fb.last_kkt)
    Ur, Jr = RefFleet(bench(mr, Hp=6), B).multistep(ym * 5.0, ry)
    rel(Ur, U, 1e-8)
    rel(Jr, J, 1e-8)


def test_chunk_changes_no_answer():
    """Chunks of 2 and one chunk of 6 (clamped from 256) give the same
    bits; a chunk that does not divide B is refused."""
    ym, ry = inputs(6, 3, seed=1)
    runs = []
    for chunk in (2, 256, None):
        fl = BatchedNonLinMPC(bench(mt, Hp=6), 6, chunk=chunk)
        runs.append([fl.step(ym[k], ry[k])[0] for k in range(3)])
    assert runs[0][0] is not runs[1][0]
    for a, b, c in zip(*runs):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="multiple of chunk"):
        BatchedNonLinMPC(bench(mt, Hp=6), 6, chunk=4)


def test_options_and_validation():
    c = bench(mt, Hp=6)
    with pytest.raises(TypeError, match="mesh"):
        BatchedNonLinMPC(c, 4, mesh=object())
    fl = BatchedNonLinMPC(c, 4, mesh=["cpu", CPU], chunk=3)   # chunk ignored
    assert fl.chunk is None and fl.state["Z_tilde"].shape[0] == 4
    with pytest.raises(TypeError, match="dtype"):
        BatchedNonLinMPC(c, 4, dtype=np.float32)
    lin = mt.NonLinMPC(mt.LinModel(mt.tf(3, [10, 1]), 1.0), Hp=5, device=CPU)
    with pytest.raises(TypeError, match="UnscentedKalmanFilter"):
        BatchedNonLinMPC(lin, 4)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        BatchedNonLinMPC(bench(mt, Hp=6, alpha=1e-3), 4, dtype=torch.float32)
        BatchedNonLinMPC(bench(mt, Hp=6), 4, dtype=torch.float32)
    assert sum("alpha=0.001" in str(r.message) for r in rec) == 1


def test_float32_fleet_follows_reference():
    """The bench's mode: float32 data, GI with float64 slots (the
    reference under x64): every lane KKT-converged at the end in both, u to
    5e-3 (the packages round float32 sums in other orders)."""
    B, K = 6, 8
    fr = RefFleet(bench(mr), B, dtype=jnp.float32)
    fp = BatchedNonLinMPC(bench(mt), B, dtype=torch.float32)
    noise, ry = inputs(B, K, seed=2)
    X = np.zeros((B, 2))
    pend = pendulum(mr)
    fv = jax.vmap(lambda x, u: pend.f(x, u, jnp.zeros(0), pend.p))
    for k in range(K):
        ym = (X[:, :1] * 180 / np.pi + noise[k]).astype(np.float32)
        ur, _ = fr.step(jnp.asarray(ym), jnp.asarray(ry[k], jnp.float32))
        up, _ = fp.step(ym, ry[k].astype(np.float32))
        assert up.dtype == torch.float32
        close(ur, up, 5e-3)
        X = np.asarray(fv(jnp.asarray(X), np.asarray(ur, np.float64)))
    for kkt in (np.asarray(fr.last_kkt), fp.last_kkt.numpy()):
        assert np.all((kkt[:, 0] < 1e-4) & (kkt[:, 1] < 1e-3))


def test_batched_ukf_step_matches_reference_kernels():
    """The lane-batched UKF correction and prediction against the
    reference's ``_kernels()`` under vmap (no NaN skip in either)."""
    B = 5
    est = {pkg: pkg.UnscentedKalmanFilter(pendulum(pkg), sigmaQ=[0.1, 1.0], sigmaR=[5.0],
                                          nint_ym=[1], sigmaQint_ym=[0.1], alpha=0.5,
                                          **({} if pkg is mr else {"device": CPU}))
           for pkg in (mr, mt)}
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(B, 3)) * 0.3
    L = rng.normal(size=(B, 3, 3)) * 0.3
    P = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(3)
    y0m, u0, d0 = rng.normal(size=(B, 1)) * 10, rng.normal(size=(B, 1)), np.zeros((B, 0))
    e = est[mr]
    m, S, R, Q = e.m_hat, e.S_hat, e.R_hat, e.Q_hat
    c = e.fop_hat - e.xop_hat
    corr_r, pred_r = e._kernels()
    ref_c = jax.vmap(corr_r, in_axes=(0, 0, 0, 0, None, None, None))(x0, P, y0m, d0, m, S, R)
    ref_p = jax.vmap(pred_r, in_axes=(0, 0, 0, 0, None, None, None, None))(
        *ref_c, u0, d0, m, S, Q, c)
    corr_p, pred_p = est[mt]._kernels()
    t = lambda a: torch.as_tensor(np.asarray(a, float))
    out_c = corr_p(t(x0), t(P), t(y0m), t(d0), t(m), t(S), t(R))
    out_p = pred_p(*out_c, t(u0), t(d0), t(m), t(S), t(Q), t(c))
    for r, p in zip(ref_c + ref_p, out_c + out_p):
        rel(r, p, 1e-12)
    # a NaN measurement goes through in the batched step, as under vmap
    y_nan = y0m.copy()
    y_nan[0] = np.nan
    assert torch.isnan(corr_p(t(x0), t(P), t(y_nan), t(d0), t(m), t(S), t(R))[0][0]).all()


@pytest.fixture(scope="module")
def nonlin_qp():
    """One reduced SQP subproblem of the bench fleet (n = 2, m = 72, per-lane
    P and A), captured from the port's fleet in its second SQP iteration
    (warm duals)."""
    rec = []

    def capture(P, q, A, l, u, y0=None, **kw):
        rec.append([a.clone() for a in (P, q, A, l, u, y0)])
        return solve_qp_active(P, q, A, l, u, y0, **kw)
    fl = BatchedNonLinMPC(bench(mt, Hp=15), 6)
    orig = port_nonlinmpc.solve_qp_active
    port_nonlinmpc.solve_qp_active = capture
    try:
        ym, ry = inputs(6, 1, seed=4)
        fl.step(ym[0], ry[0])
    finally:
        port_nonlinmpc.solve_qp_active = orig
    return rec[1]


def test_plain_solves_hold_at_the_nonlin_shape(nonlin_qp):
    """The plain GI and ADMM solves at n = 2, m = 72 against the
    reference's solve_qp_active / solve_qp (vmapped over the lanes)."""
    P, q, A, l, u, y0 = nonlin_qp
    assert (P.shape[1:], A.shape[1:]) == ((2, 2), (72, 2))
    j = [jnp.asarray(a.numpy()) for a in nonlin_qp]
    ref = jax.vmap(lambda *a: ref_solve_qp_active(*a))(*j)
    gi = solve_qp_active(P, q, A, l, u, y0)
    rel(ref.x, gi.x, 1e-9)
    assert np.array_equal(np.asarray(ref.iters), gi.iters.numpy())
    assert np.array_equal(np.asarray(ref.converged), gi.converged.numpy())
    ref = jax.vmap(lambda *a: ref_solve_qp(*a[:5], y0=a[5], max_iter=500))(*j)
    ad = solve_qp(P, q, A, l, u, y0=y0, max_iter=500)
    rel(ref.x, ad.x, 1e-7)
    assert np.array_equal(np.asarray(ref.iters), ad.iters.numpy())
