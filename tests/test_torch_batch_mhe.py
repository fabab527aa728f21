"""The port's BatchedMHE against mpc_tpu.parallel.BatchedMHE: the fleet
scenarios of tests/test_batch.py, with both fleets fed the same seed-made
measurements (float64, the port on the CPU: the kernels' plain versions).

Bars on x̂ per period, relative to 1 + max|x̂|: 1e-9 on the fast path, the
NaN variant (the GI solves, whose pivot counts equal the reference's every
period) and the linear general path (one window QP); 1e-6 on the nonlinear
fleet, whose Gauss–Newton loop exits at a relative step norm of 1e-6 and
whose last step can be a line-search tie at round-off
(``test_gn_last_step_round_off_tie``); its per-lane GN iteration counts
equal the reference's on most solves.  The converged flags and the NaN
guard equal the reference's every period.
"""
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.parallel import BatchedMHE as RefFleet
from mpc_tpu_torch.parallel import BatchedMHE
from test_torch_mhe import gn  # noqa: F401  (the fixture)
from test_torch_nonlin import CPU, pendulum

torch.set_num_threads(1)
GI, GN = 1e-9, 1e-6


def dev(pkg):
    return {} if pkg is mr else {"device": CPU}


def rel(a, b, tol, what=""):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape, what
    err = np.max(np.abs(a - b), initial=0.0)
    assert err <= tol * (1.0 + np.max(np.abs(b), initial=0.0)), (what, err)


def siso(pkg, He=3, bound=None, **kw):
    e = pkg.MovingHorizonEstimator(pkg.LinModel(pkg.tf(3, [10, 1]), 1.0), He=He, **kw,
                                   **dev(pkg))
    if bound is not None:
        e.setconstraint(xhatmin=[-bound] * e.nx_hat, xhatmax=[bound] * e.nx_hat)
    return e


def fleets(make, B, **kw):
    return RefFleet(make(mr), B, **kw), BatchedMHE(make(mt), B, **kw)


def same_pivots(fr, fp, k):
    """The fast path's most GI pivots of a lane, equal to the reference's."""
    assert int(fp.last_pivots) == int(np.asarray(fr.last_pivots)), k


def run(fr, fp, N, tol, seed=0, nan=(), ys=1.0):
    """N ``step`` periods of both fleets: x̂, the converged flags and the
    NaN guard every period."""
    rng = np.random.default_rng(seed)
    u = None
    for k in range(N):
        ym = rng.normal(size=(fr.B, fr.t.nym)) * ys
        for kk, lane in nan:
            if kk == k:
                ym[lane, 0] = np.nan
        xr, xp = np.asarray(fr.step(ym, u)), fp.step(ym, u)
        assert torch.is_tensor(xp)
        rel(xp.numpy(), xr, tol, k)
        assert np.array_equal(fp.last_ok.numpy(), np.asarray(fr.last_ok)), k
        assert fp._nan_guard == fr._nan_guard, k
        u = rng.normal(size=(fr.B, fr.t.model.nu)) * 0.2


def test_fast_path_matches_reference_and_singles():
    """test_batch.py:39-56: the fast-path fleet against the reference's and
    against the port's single estimators."""
    fr, fp = fleets(lambda pkg: siso(pkg, He=4), 4)
    assert fp._fast and not fp._ms_cond
    singles = [siso(mt, He=4) for _ in range(4)]
    rng = np.random.default_rng(0)
    u_prev = np.zeros((4, 1))
    for k in range(8):
        ym = rng.normal(size=(4, 1))
        xr, xp = np.asarray(fr.step(ym, u_prev)), fp.step(ym, u_prev).numpy()
        rel(xp, xr, GI, k)
        same_pivots(fr, fp, k)
        rel(xp, np.array([s.preparestate(y) for s, y in zip(singles, ym)]), GI, k)
        u_prev = rng.normal(size=(4, 1)) * 0.2
        for s, u, y in zip(singles, u_prev, ym):
            s.updatestate(u, y)


def test_nan_routing_and_guard():
    """test_batch.py:59-93: a dropout on one lane routes the fleet through
    the per-lane H̃-downdate variant until the NaN drains (the guard
    step by step), the bounds hold, and the estimates match the
    reference's and the port's singles (which mask exactly)."""
    fr, fp = fleets(lambda pkg: siso(pkg, bound=0.2), 3)
    assert fp._fast and fp._nan_fast_ok
    singles = [siso(mt, bound=0.2) for _ in range(3)]
    rng = np.random.default_rng(5)
    u_prev = np.zeros((3, 1))
    for k in range(10):
        ym = rng.normal(size=(3, 1))
        if k == 4:
            ym[1, 0] = np.nan
        xr, xp = np.asarray(fr.step(ym, u_prev)), fp.step(ym, u_prev).numpy()
        rel(xp, xr, GI, k)
        same_pivots(fr, fp, k)
        rel(xp, np.array([s.preparestate(y) for s, y in zip(singles, ym)]), 1e-7, k)
        assert np.all(xp <= 0.2 + 1e-7), k
        assert fp._nan_guard == (max(0, 3 - (k - 4)) if k >= 4 else 0), k
        u_prev = rng.normal(size=(3, 1)) * 0.2
        for s, u, y in zip(singles, u_prev, ym):
            s.updatestate(u, y)


def test_nan_lane_isolation():
    """test_batch.py:508-527: a NaN on one lane leaves the others' x̂
    unchanged (the per-lane downdate is lane-local)."""
    a, b = (BatchedMHE(siso(mt), 4) for _ in range(2))
    rng = np.random.default_rng(29)
    yms = [rng.normal(size=(4, 1)) for _ in range(8)]
    us = [rng.normal(size=(4, 1)) * 0.2 for _ in range(8)]
    for k in range(8):
        ym_n = yms[k].copy()
        if k == 5:
            ym_n[2, 0] = np.nan
        xa = a.step(ym_n, u_prev=us[k - 1] if k else None).numpy()
        xb = b.step(yms[k], u_prev=us[k - 1] if k else None).numpy()
        assert np.allclose(xa[[0, 1, 3]], xb[[0, 1, 3]], atol=1e-9), k


def test_gi_cap_matches_uncapped_and_reference():
    """test_batch.py:194-215: gi_max_active=8 reproduces the uncapped fleet
    while the active sets fit, and the reference's capped fleet."""
    def make(pkg):
        e = siso(pkg, He=4)
        return e.setconstraint(xhatmin=[-0.25, -np.inf], xhatmax=[0.25, np.inf])
    fr, fp = fleets(make, 4, gi_max_active=8)
    full = BatchedMHE(make(mt), 4)
    rng = np.random.default_rng(7)
    u_prev = np.zeros((4, 1))
    for k in range(8):
        ym = rng.normal(size=(4, 1))
        xr, xp, xf = np.asarray(fr.step(ym, u_prev)), fp.step(ym, u_prev), full.step(ym, u_prev)
        rel(xp.numpy(), xr, GI, k)
        same_pivots(fr, fp, k)
        rel(xp.numpy(), xf.numpy(), GI, k)
        assert bool(fp.last_ok.all()), k
        u_prev = rng.normal(size=(4, 1)) * 0.2


def test_measured_disturbances():
    """test_batch.py:241-268: nd > 0 with operating points; d enters window
    slot i+1."""
    def make(pkg):
        G = pkg.tf_matrix([[pkg.tf(1.9, [18, 1]), pkg.tf(1.9, [18, 1])],
                           [pkg.tf(-0.74, [8, 1]), pkg.tf(0.74, [8, 1])]])
        m = pkg.LinModel(G, 2.0, i_d=[1])
        m.setop(uop=[10], yop=[50, 30], dop=[20])
        return pkg.MovingHorizonEstimator(m, He=3, nint_ym=0, **dev(pkg))
    fr, fp = fleets(make, 3)
    rng = np.random.default_rng(11)
    u_prev = np.full((3, 1), 10.0)
    for k in range(8):
        ym = np.array([50.0, 30.0]) + rng.normal(size=(3, 2))
        d = np.full((3, 1), 20.0) + rng.normal(size=(3, 1)) * 2.0
        rel(fp.step(ym, u_prev, d=d).numpy(), np.asarray(fr.step(ym, u_prev, d=d)), GI, k)
        u_prev = np.full((3, 1), 10.0) + rng.normal(size=(3, 1)) * 0.5


@pytest.mark.parametrize("nan", [False, True])
def test_multistep_equals_steps(nan):
    """test_batch.py:414-470: multistep(K) ≡ K steps across the fill →
    moving boundary (the host recursion of P̄, Nk and H̃), with a NaN in
    the sequence routing the whole dispatch; against the reference's
    multistep too."""
    He = 3 if nan else 4
    fr, fa = fleets(lambda pkg: siso(pkg, He=He, bound=5.0), 3)
    fb = BatchedMHE(siso(mt, He=He, bound=5.0), 3)
    rng = np.random.default_rng(19 if nan else 17)
    ym0 = rng.normal(size=(3, 1))
    for f in (fr, fa, fb):
        f.step(ym0)
    K = 6 if nan else 7
    ym_s = rng.normal(size=(K, 3, 1))
    if nan:
        ym_s[2, 1, 0] = np.nan
    u_s = rng.normal(size=(K, 3, 1)) * 0.2
    X, Xr = fa.multistep(ym_s, u_s), np.asarray(fr.multistep(ym_s, u_s))
    assert tuple(X.shape) == (K, 3, fa.t.nx_hat)
    rel(X.numpy(), Xr, GI)
    for k in range(K):
        rel(X[k].numpy(), fb.step(ym_s[k], u_prev=u_s[k]).numpy(), 1e-10, k)
    assert fa.Nk == fb.Nk == fr.Nk
    assert fa._nan_guard == fb._nan_guard == fr._nan_guard
    assert np.allclose(fa.invP_arr, fb.invP_arr)
    assert bool(fa.last_ok.all())


@pytest.mark.parametrize("qp_solver", ["active_set", "admm"])
def test_general_solver_matches_reference(qp_solver):
    """test_batch.py:530-556: solver="general" (the window GN solver over
    the lanes, one QP for a LinModel) against the reference's general fleet
    and the port's fast fleet, through a dropout."""
    make = lambda pkg: siso(pkg, qp_solver=qp_solver)
    fr, fg = fleets(make, 3, solver="general")
    fm = BatchedMHE(make(mt), 3)
    assert not fg._fast and fm._nan_fast_ok
    tol = GI if qp_solver == "active_set" else 1e-6
    rng = np.random.default_rng(37)
    u_prev = None
    for k in range(8):
        ym = rng.normal(size=(3, 1))
        if k == 5:
            ym[1, 0] = np.nan
        xg = fg.step(ym, u_prev=u_prev).numpy()
        rel(xg, np.asarray(fr.step(ym, u_prev=u_prev)), tol, k)
        rel(xg, fm.step(ym, u_prev=u_prev).numpy(), tol, k)
        u_prev = rng.normal(size=(3, 1)) * 0.2


def test_multiple_shooting_rides_the_fast_path():
    """test_batch.py:617-657: a MultipleShooting fleet condenses to the fast
    path (SS-form state), equal to the reference's MS fleet and to the
    port's SS fleet, also through a dropout."""
    make = lambda tr: (lambda pkg: siso(pkg, He=4, bound=0.5,
                                        transcription=pkg.MultipleShooting() if tr else None))
    fr, fm = fleets(make(True), 3)
    fs = BatchedMHE(make(False)(mt), 3)
    assert fm._fast and fm._ms_cond
    rng = np.random.default_rng(43)
    u_prev = np.zeros((3, 1))
    for k in range(10):
        ym = rng.normal(size=(3, 1))
        if k == 9:
            ym[1, 0] = np.nan
        xm = fm.step(ym, u_prev).numpy()
        rel(xm, np.asarray(fr.step(ym, u_prev)), GI, k)
        same_pivots(fr, fm, k)
        rel(xm, fs.step(ym, u_prev).numpy(), GI, k)
        u_prev = rng.normal(size=(3, 1)) * 0.2
    assert bool(fm.last_ok.all())


def test_gi_chunks_change_no_answer():
    """gi_chunks > 1 is validated and runs the one solve (the kernel has no
    lockstep tail to split): the same estimates as gi_chunks=1."""
    a, b = BatchedMHE(siso(mt, bound=0.3), 6), BatchedMHE(siso(mt, bound=0.3), 6, gi_chunks=3)
    rng = np.random.default_rng(3)
    u = None
    for k in range(7):
        ym = rng.normal(size=(6, 1))
        rel(b.step(ym, u).numpy(), a.step(ym, u).numpy(), 1e-12, k)
        u = rng.normal(size=(6, 1)) * 0.2


def nonlin_mhe(pkg):
    """test_batch.py:559-582: the pendulum MHE with an EKF covestim (the
    per-lane arrival covariance), GI window QPs."""
    kw = dict(sigmaQ=[0.1, 1.0], sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1], **dev(pkg))
    ce = pkg.ExtendedKalmanFilter(pendulum(pkg), **kw)
    e = pkg.MovingHorizonEstimator(pendulum(pkg), He=4, covestim=ce, qp_solver="active_set",
                                   **kw)
    return e.setconstraint(xhatmin=[-0.3, -5.0, -5.0], xhatmax=[0.3, 5.0, 5.0])


def test_nonlinear_fleet_matches_reference(gn):
    """test_batch.py:559-614: the NonLinModel fleet (GN window solves,
    per-lane EKF arrival covariance with its NaN skip) against the
    reference's fleet, GN iteration counts lane by lane; its multistep ≡
    steps."""
    fr, fp = fleets(nonlin_mhe, 3)
    assert not fp._lin and not fp._fast
    gn.watch(fp.t)
    run(fr, fp, 7, GN, seed=41, nan=((4, 0),), ys=10.0)
    assert len(gn.most_equal()[0]) == 7 * 3
    rel(fp.state["P_arr"].numpy(), np.asarray(fr.state["P_arr"]), GN)
    a, b = BatchedMHE(nonlin_mhe(mt), 3), BatchedMHE(nonlin_mhe(mt), 3)
    rng = np.random.default_rng(41)
    ym0 = rng.normal(size=(3, 1)) * 10.0
    a.step(ym0)
    b.step(ym0)
    ym_s, u_s = rng.normal(size=(5, 3, 1)) * 10.0, rng.normal(size=(5, 3, 1)) * 0.3
    X = a.multistep(ym_s, u_s)
    for k in range(5):
        rel(X[k].numpy(), b.step(ym_s[k], u_prev=u_s[k]).numpy(), 1e-12, k)
    assert a.last_iters.tolist() == b.last_iters.tolist()


def test_gn_last_step_round_off_tie(gn):
    """Why the GN bar is not 1e-9: two port fleets, one fed measurements
    1e-15 (relative) away, take the same GN iteration counts on every lane
    of every period, yet their x̂ part by more than 1e-10 relative on some
    period — a last step whose merit decrease lies at round-off is taken
    by one line search and rejected by the other — and stay within GN."""
    a, b = BatchedMHE(gn.watch(nonlin_mhe(mt)), 3), BatchedMHE(gn.watch(nonlin_mhe(mt)), 3)
    rng = np.random.default_rng(41)
    u, worst = None, 0.0
    for k in range(7):
        ym = rng.normal(size=(3, 1)) * 10.0
        xa = a.step(ym, u).numpy()
        its_a = gn.take()[1]
        xb = b.step(ym * (1.0 + 1e-15), u).numpy()
        assert gn.take()[1] == its_a, k
        rel(xb, xa, GN, k)
        worst = max(worst, np.max(np.abs(xa - xb)) / (1.0 + np.max(np.abs(xa))))
        u = rng.normal(size=(3, 1)) * 0.2
    assert worst > 1e-10, worst


@pytest.mark.parametrize("case", ["direct", "solver", "chunks", "chunk_split", "mesh", "dtype"])
def test_fleet_validation(case):
    """The reference's argument checks (batch_mhe.py:89-101); a ``mesh``
    that is not a sequence of devices is a ``TypeError``."""
    err = TypeError if case in ("mesh", "dtype") else ValueError
    kw = {"solver": dict(solver="osqp"), "chunks": dict(gi_chunks=0),
          "chunk_split": dict(gi_chunks=3), "mesh": dict(mesh=object()),
          "dtype": dict(dtype=torch.int32)}.get(case, {})
    with pytest.raises(err):
        BatchedMHE(siso(mt, direct=case != "direct"), 4, **kw)
