"""The port's single-controller LinMPC against mpc_tpu.LinMPC.

Every case builds the same controller in both packages (plant, weights,
bounds, estimator) and drives both with the same inputs, period by period:
the ``preparestate``/``moveinput``/``updatestate`` protocol against a copy
of the plant (``sim``'s loop without noise), or a few calls by hand.  The
cases are those of tests/test_linmpc.py whose estimators the port has.  The
reference runs in float64 under the suite's x64, the port in float64 on the
CPU (the kernels' plain versions).  Bars, after every ``moveinput``: u to
1e-6, the getinfo arrays and J to 1e-6·(1 + |value|), and the same QP
iteration count, budget and converged flag.
"""
import copy
import inspect
import json
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu_torch.ops.qp import solve_qp

torch.set_num_threads(1)

CPU = torch.device("cpu")


def LinMPC(pkg, *args, **kw):
    """``pkg.LinMPC``, the port's asked for the CPU (its default is the GPU)."""
    return pkg.LinMPC(*args, **kw, **({"device": CPU} if pkg is mt else {}))


INF = np.inf
INFO_KEYS = ("DeltaU", "epsilon", "J", "U", "u", "Yhat", "xhat", "yhat",
             "Yhats", "xhatend", "lastu", "d", "Dhat", "Rhaty", "Rhatu")


def assert_same_info(cr, cp, iters_slack=0):
    ir, ip = cr.getinfo(), cp.getinfo()
    for k in ("converged", "iter_budget", "deadline_miss"):
        assert ir[k] == ip[k], (k, ir[k], ip[k])
    assert abs(ir["iters"] - ip["iters"]) <= iters_slack, \
        ("iters", ir["iters"], ip["iters"])
    for k in INFO_KEYS:
        a, b = np.asarray(ir[k], float), np.asarray(ip[k], float)
        assert a.shape == b.shape, k
        if a.size:
            assert np.max(np.abs(a - b) / (1.0 + np.abs(a))) < 1e-6, k


def lockstep(case, iters_slack=0, **kw):
    """Run ``case`` (a generator of (controller, u) per moveinput) in both
    packages side by side; returns the two last controllers.
    ``iters_slack`` bounds the QP iteration difference (0: equal)."""
    runs = zip(case(mr, **kw), case(mt, **kw))
    n = 0
    for (cr, ur), (cp, up) in runs:
        assert np.max(np.abs(np.asarray(ur) - up)) < 1e-6, (n, ur, up)
        assert_same_info(cr, cp, iters_slack)
        n += 1
    assert n > 0
    return cr, cp


def closed_loop(ctrl, N, ry, d=None, y_step=0.0, u_step=0.0, init=True):
    """sim's closed loop, noise-free, yielding after every moveinput."""
    estim = ctrl.estim
    model = estim.model
    plant = copy.deepcopy(model)
    nd = model.nd
    dd = np.asarray(d, float) if nd else None
    if init:
        ctrl.initstate(model.uop.copy(), plant.evaloutput(dd)[estim.i_ym], dd)
    for _ in range(N):
        y = plant.evaloutput(dd) + np.asarray(y_step)
        ym = y[estim.i_ym]
        ctrl.preparestate(ym, dd)
        u = ctrl.moveinput(ry, dd)
        yield ctrl, u
        plant.updatestate(u + np.asarray(u_step), dd)
        ctrl.updatestate(u, ym, dd)


def siso(pkg, gain=3.0, tau=10.0):
    return pkg.LinModel(pkg.tf(gain, [tau, 1]), 1.0)


def mimo(pkg):
    G = np.array([[pkg.tf(1.90, [18, 1]), pkg.tf(1.90, [18, 1])],
                  [pkg.tf(-0.74, [8, 1]), pkg.tf(0.74, [8, 1])]], dtype=object)
    m = pkg.LinModel(G, 2.0)
    m.setop(uop=[10, 50], yop=[50, 30])
    return m


def readme_plant(pkg):
    G = pkg.tf_matrix([[pkg.tf(2, [10, 1]) * pkg.delay(20)],
                       [pkg.tf(10, [4, 1])]])
    return pkg.LinModel(G, 1.0)


# --- the cases (tests/test_linmpc.py, same names) ---------------------------
def unconstrained_tracking(pkg):
    m = pkg.LinModel(pkg.tf(5, [2, 1]), 3.0)
    c = LinMPC(pkg, m, Nwt=[0], Hp=1000, Hc=1)
    c.preparestate([0])
    yield c, c.moveinput([5])


def constraint_saturation_umax(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=20, Hc=2, Cwt=INF)
    c.setconstraint(umax=[1.0], umin=[-1.0])
    c.preparestate([0])
    yield c, c.moveinput([100.0])
    yield c, c.moveinput([-100.0])


def constraint_saturation_dumax(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=20, Hc=2, Cwt=INF)
    c.setconstraint(dumax=[0.3], dumin=[-0.3])
    c.preparestate([0])
    yield c, c.moveinput([100.0])


def soft_output_constraints_relax(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=10, Hc=2, Cwt=1e4)
    c.setconstraint(ymax=[0.5], dumax=[10.0])
    yield from closed_loop(c, 30, [2.0])


def getinfo(pkg):
    c = LinMPC(pkg, mimo(pkg), Hp=10, Hc=2)
    c.preparestate([50, 30])
    yield c, c.moveinput([55, 30])
    c2 = LinMPC(pkg, pkg.LinModel(pkg.tf(5, [2, 1]), 3.0), Nwt=[0], Hp=1, Hc=1)
    c2.preparestate([0])
    yield c2, c2.moveinput([10])


def setpoint_preview(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=10, Hc=5)
    c.preparestate([0])
    yield c, c.moveinput([0.0], R_hat_y=np.concatenate([np.zeros(5), np.full(5, 5.0)]))


def constant_measured_disturbance_tracking(pkg):
    G = np.array([[pkg.tf(3, [30, 1]), pkg.tf(-2, [5, 1])]], dtype=object)
    c = LinMPC(pkg, pkg.LinModel(G, 1.0, i_d=[1]), Hp=20, Hc=2)
    yield from closed_loop(c, 40, [1.0], d=[0.5])


def setmodel_hot_swap(pkg):
    c = LinMPC(pkg, pkg.KalmanFilter(siso(pkg)), Hp=12, Hc=2)
    c.preparestate([0])
    yield c, c.moveinput([1.0])
    c.setmodel(siso(pkg, 6.0, 8.0))
    c.preparestate([0])
    yield c, c.moveinput([1.0], lastu=[0.0])
    c.updatestate(c.getinfo()["u"], [0.2])
    c.setmodel(Mwt=[2.0], Nwt=[0.3])
    c.preparestate([0.1])
    yield c, c.moveinput([1.5])


def internal_model_estimator_mpc(pkg):
    c = LinMPC(pkg, pkg.InternalModel(siso(pkg)), Hp=15, Hc=2)
    yield from closed_loop(c, 40, [1.0], y_step=[0.3])


def terminal_state_constraint(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=10, Hc=3, Cwt=INF, nint_ym=0)
    c.setconstraint(xhatmin=[-0.5], xhatmax=[0.5])
    c.preparestate([0])
    yield c, c.moveinput([100.0])


def move_blocking_behavior(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=10, Hc=[2, 3, 5], Cwt=INF)
    c.preparestate([0])
    yield c, c.moveinput([2.0])


def infeasible_qp_graceful_degradation(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=10, Hc=2, Cwt=INF)
    c.preparestate([0])
    yield c, c.moveinput([1.0])
    c.setconstraint(ymin=[2.0], ymax=[-2.0])
    with pytest.warns(UserWarning, match="did not converge"):
        u = c.moveinput([1.0])
    yield c, u


def custom_linear_constraints(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=10, Hc=2, Cwt=1e5, Wu=[[1.0]], Wy=[[0.5]])
    c.setconstraint(wmax=[2.0])
    yield from closed_loop(c, 40, [3.0])


def custom_constraints_disturbance(pkg):
    """Wd, Wr and nd > 0 (the Fw terms the SISO case leaves at zero)."""
    G = np.array([[pkg.tf(3, [30, 1]), pkg.tf(-2, [5, 1])]], dtype=object)
    m = pkg.LinModel(G, 1.0, i_d=[1])
    c = LinMPC(pkg, m, Hp=12, Hc=2, Wu=[[1.0]], Wy=[[0.3]], Wd=[[0.5]],
               Wr=[[-0.2]])
    c.setconstraint(wmax=[1.5], wmin=[-1.0])
    yield from closed_loop(c, 25, [2.0], d=[0.4])


def lastu_and_manual_protocol(pkg):
    c = LinMPC(pkg, mimo(pkg), Hp=10, Hc=2)
    c.preparestate([50, 30])
    yield c, c.moveinput([50, 30])


def manual_estimator_vs_default(pkg):
    model = pkg.LinModel(pkg.tf(5, [2, 1]), 3.0)
    model.setop(yop=[10.0])
    man = LinMPC(pkg, pkg.ManualEstimator(model))
    skf = pkg.SteadyKalmanFilter(model)
    plant = pkg.LinModel(pkg.tf(5, [2, 1]), 3.0)
    plant.setop(yop=[10.0])
    for _ in range(12):
        ym = plant.evaloutput() - 5.0
        man.estim.setstate(skf.preparestate(ym))
        man.estim.prepared = True
        u = man.moveinput([15.0])
        yield man, u
        skf.updatestate(u, ym)
        plant.updatestate(u)


def bumpless_transfer(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=10, Hc=2)
    c.initstate(np.array([0.7]), [2.1])
    c.preparestate([2.1])
    yield c, c.moveinput([2.1], lastu=[0.7])


def time_varying_bounds(pkg):
    c = LinMPC(pkg, pkg.LinModel(pkg.tf(2, [5, 1]), 1.0), Hp=10, Hc=5,
               Cwt=INF, Nwt=[0.05])
    Ymax = np.full(10, INF)
    Ymax[:4] = 0.6
    c.setconstraint(Ymax=Ymax)
    c.preparestate([0.0])
    yield c, c.moveinput([2.0])
    c2 = LinMPC(pkg, pkg.LinModel(pkg.tf(1, [2, 1]), 1.0), Hp=8, Hc=8,
                Cwt=INF, Nwt=[0.0])
    c2.setconstraint(Umax=0.1 + 0.1 * np.arange(8), umin=[-10.0])
    c2.preparestate([0.0])
    yield c2, c2.moveinput([50.0])
    c3 = LinMPC(pkg, pkg.LinModel(pkg.tf(1, [2, 1]), 1.0), Hp=10, Hc=3,
                Cwt=INF, Nwt=[0.0])
    DUmax = np.array([0.2, 0.1, 0.05])
    c3.setconstraint(DUmax=DUmax, DUmin=-DUmax, umax=[10.0], umin=[-10.0])
    c3.preparestate([0.0])
    yield c3, c3.moveinput([50.0])


def offset_free_disturbance_rejection(pkg):
    c = LinMPC(pkg, siso(pkg), Hp=20, Hc=2)
    yield from closed_loop(c, 40, [2.0], y_step=[0.5])


def input_integrator_offset_free(pkg):
    c = LinMPC(pkg, pkg.KalmanFilter(siso(pkg), nint_u=[1], nint_ym=[0]), Hp=20, Hc=2)
    yield from closed_loop(c, 40, [2.0], u_step=[0.4])


def luenberger_closed_loop(pkg):
    c = LinMPC(pkg, pkg.Luenberger(mimo(pkg)), Hp=10, Hc=2, Mwt=[1, 1], Nwt=[0.1, 0.1])
    c.setconstraint(umin=[5, 45], umax=[15, 55])
    yield from closed_loop(c, 20, [52, 29])


def terminal_cost_equals_lqr(pkg):
    import scipy.linalg as sla
    A = np.array([[0.5, -0.4], [0.6, 0.5]])
    B, z2 = np.eye(2), np.zeros((2, 0))
    M_end = sla.solve_discrete_are(A, B, np.eye(2), 0.5 * np.eye(2))
    M_Hp = np.block([[np.eye(4), np.zeros((4, 2))], [np.zeros((2, 4)), M_end]])
    c = LinMPC(pkg, pkg.LinModel(A, B, np.eye(2), z2, z2, 1.0), Hp=3, Hc=3,
               M_Hp=M_Hp, Nwt=[0.0, 0.0], Lwt=[0.5, 0.5], nint_ym=0)
    c.estim.setstate([1.0, 1.0])
    plant = pkg.LinModel(A, B, np.eye(2), z2, z2, 1.0)
    plant.setstate([1.0, 1.0])
    for _ in range(10):
        y = plant.evaloutput()
        c.preparestate(y)
        u = c.moveinput([0.0, 0.0])
        yield c, u
        plant.updatestate(u)
        c.updatestate(u, y)


CASES = [unconstrained_tracking, constraint_saturation_umax,
         constraint_saturation_dumax, soft_output_constraints_relax, getinfo,
         setpoint_preview, constant_measured_disturbance_tracking,
         setmodel_hot_swap, internal_model_estimator_mpc,
         terminal_state_constraint, move_blocking_behavior,
         infeasible_qp_graceful_degradation, custom_linear_constraints,
         custom_constraints_disturbance, lastu_and_manual_protocol,
         manual_estimator_vs_default, bumpless_transfer, time_varying_bounds,
         offset_free_disturbance_rejection, input_integrator_offset_free,
         luenberger_closed_loop, terminal_cost_equals_lqr]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_matches_reference(case):
    lockstep(case)


def readme_loop(pkg, qp_solver="admm", transcription="ss", N=25):
    tr = pkg.MultipleShooting() if transcription == "ms" else pkg.SingleShooting()
    c = LinMPC(pkg, readme_plant(pkg), Mwt=[1, 0], Nwt=[0.1], qp_solver=qp_solver,
               transcription=tr)
    c.setconstraint(ymax=[INF, 35])
    yield from closed_loop(c, N, [5, 0])


@pytest.mark.parametrize("qp_solver,transcription",
                         [("admm", "ss"), ("active_set", "ss"),
                          ("admm", "ms"), ("active_set", "ms")])
def test_readme_loop_solvers_and_transcriptions(qp_solver, transcription):
    """GI ≡ ADMM and MS ≡ SS (tests/test_linmpc.py:457-495): each
    combination held to the reference, and the port's own to its SS/ADMM
    run at the reference's bars (1e-9 GI vs ADMM, 1e-8 MS vs SS).

    MultipleShooting with ADMM reduces to n = 3 variables with six rows
    active at once from period 1 on: the polish's KKT is singular up to its
    δ = 1e-11.  Fed the same inputs, the two polishes agree to the last bit
    before refinement; the refinement steps multiply the round-off of the
    residual's sums (``jnp.sum`` under XLA against ``torch.sum``) by
    ‖K⁻¹‖ ~ 1/δ, so the duals it returns (the next period's warm start)
    differ while x does not, and the next solve may take another number of
    residual checks.  u and the getinfo arrays stay equal; the iteration
    counts there are held to two of the controller's ``check_every``
    blocks."""
    check_every = inspect.signature(solve_qp).parameters["check_every"].default
    slack = 2 * check_every if (qp_solver, transcription) == ("admm", "ms") else 0
    lockstep(readme_loop, iters_slack=slack, qp_solver=qp_solver,
             transcription=transcription)
    u = lambda **kw: np.array([u_ for _, u_ in readme_loop(mt, **kw)])
    base = u()
    bar = 1e-9 if transcription == "ss" else 1e-8
    assert np.max(np.abs(u(qp_solver=qp_solver, transcription=transcription)
                         - base)) < bar


def reference_ms_run(nudge_duals=False):
    """The reference's README loop with MultipleShooting and ADMM for three
    periods: the iteration counts, the duals each polish returns and u.
    ``nudge_duals`` moves the period-1 duals (period 2's warm start) by one
    ulp."""
    c = mr.LinMPC(readme_plant(mr), Mwt=[1, 0], Nwt=[0.1],
                  transcription=mr.MultipleShooting())
    c.setconstraint(ymax=[INF, 35])
    plant = copy.deepcopy(c.estim.model)
    c.initstate(plant.uop.copy(), plant.evaloutput())
    its, duals, us = [], [], []
    for k in range(3):
        ym = plant.evaloutput()
        c.preparestate(ym)
        u = c.moveinput([5.0, 0.0])
        its.append(int(c.getinfo()["iters"]))
        duals.append(np.array(c.y_dual))
        us.append(np.asarray(u))
        if k == 1 and nudge_duals:
            yd = c.y_dual
            c.y_dual = np.where(yd != 0, np.nextafter(yd, np.inf), yd)
        plant.updatestate(u)
        c.updatestate(u, ym)
    return its, duals, np.array(us)


def reference_ms_run_on_isa(isa):
    """``reference_ms_run()`` in a fresh process whose XLA compiles for the
    CPU instruction set ``isa`` (``--xla_cpu_max_isa``)."""
    script = ("import json, sys, jax\n"
              "jax.config.update('jax_platforms', 'cpu')\n"
              "jax.config.update('jax_enable_x64', True)\n"
              f"sys.path.insert(0, {str(pathlib.Path(__file__).parent)!r})\n"
              "from test_torch_linmpc import reference_ms_run\n"
              "its, duals, u = reference_ms_run()\n"
              "print(json.dumps(dict(its=its, duals=[d.tolist() for d in duals],"
              " u=u.tolist())))\n")
    env = dict(os.environ, XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} "
               f"--xla_cpu_max_isa={isa}".strip())
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=pathlib.Path(__file__).parents[1])
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return res["its"], [np.array(d) for d in res["duals"]], np.array(res["u"])


def test_admm_ms_duals_are_the_references_round_off():
    """The reference alone (no port) on the README loop with
    MultipleShooting and ADMM, where the polish's KKT is singular up to its
    δ = 1e-11 from period 1 on.

    One ulp on the duals the period-1 polish returns (the next period's
    warm start) leaves period 2's iteration count and every u unchanged:
    the warm start does not amplify round-off.  The polish does: the same
    reference compiled by XLA for SSE4.2 instead of AVX2 (the vector width
    of its sums) returns period-1 duals more than 1e-3 apart, u equal to
    1e-12, and period 2 then takes another number of iterations (110
    against 130): the port's own difference where
    ``test_readme_loop_solvers_and_transcriptions[admm-ms]`` saw it.  The
    iteration counts that follow period 1 are the reference's round-off,
    so that test bounds them by two ``check_every`` blocks, not equates
    them."""
    its0, _, u0 = reference_ms_run()
    its1, _, u1 = reference_ms_run(nudge_duals=True)
    assert its1 == its0 and np.array_equal(u1, u0)
    its_avx, duals_avx, u_avx = reference_ms_run_on_isa("AVX2")
    its_sse, duals_sse, u_sse = reference_ms_run_on_isa("SSE4_2")
    assert np.max(np.abs(u_sse - u_avx)) < 1e-12
    assert its_sse[:2] == its_avx[:2]
    assert np.max(np.abs(duals_sse[1] - duals_avx[1])) > 1e-3
    check_every = inspect.signature(solve_qp).parameters["check_every"].default
    assert check_every <= abs(its_sse[2] - its_avx[2]) <= 2 * check_every


@pytest.mark.parametrize("qp_solver", ["admm", "active_set"])
def test_state_carry_continues_reference_run(qp_solver):
    """The reference's runtime state after 12 periods of the README loop,
    copied into a fresh port controller (x̂, Z̃, the duals, the ρ rung,
    lastu0 and the GI operator state): both continue in step for 8 more
    periods on the same measurements."""
    for cr, _ in readme_loop(mr, qp_solver, N=12):
        pass
    cp = mt.LinMPC(readme_plant(mt), Mwt=[1, 0], Nwt=[0.1], qp_solver=qp_solver,
                   device=CPU)
    cp.setconstraint(ymax=[INF, 35])
    cp.estim.x0_hat = np.asarray(cr.estim.x0_hat).copy()
    cp.Z_tilde = np.asarray(cr.Z_tilde).copy()
    cp.y_dual = np.asarray(cr.y_dual).copy()
    cp.lastu0 = np.asarray(cr.lastu0).copy()
    cp.rho_rung = int(np.asarray(cr._rung_dev))
    if qp_solver == "active_set":
        cp._qp_state = {k: torch.as_tensor(np.asarray(v))
                        for k, v in cr._qp_state.items()}
    y = np.array([4.0, 30.0])
    for k in range(8):
        cr.preparestate(y)
        cp.preparestate(y)
        u_r, u_p = cr.moveinput([5, 0]), cp.moveinput([5, 0])
        assert np.max(np.abs(np.asarray(u_r) - u_p)) < 1e-6, k
        assert_same_info(cr, cp)
        cr.updatestate(u_r, y)
        cp.updatestate(u_p, y)
        y = y + np.array([0.1, 0.4])


@pytest.mark.parametrize("qp_solver", ["admm", "active_set"])
def test_float32_closed_loop(qp_solver):
    """dtype=torch.float32 against the reference's f32 mode
    (dtype=jnp.float32) on the 2x2 plant with input bounds: u to
    1e-3·(1 + max|u|) and every QP converged in both.  (The README plant,
    whose second output has weight 0, is not used here: its f32 ADMM QP
    converges or not with 1e-6 perturbations of q, in both packages.)"""
    import jax.numpy as jnp

    def make(pkg, dt):
        c = LinMPC(pkg, mimo(pkg), Hp=10, Hc=2, Mwt=[1, 1], Nwt=[0.1, 0.1],
                   dtype=dt, qp_solver=qp_solver)
        return c.setconstraint(umin=[5, 45], umax=[15, 55])
    cr, cp = make(mr, jnp.float32), make(mt, torch.float32)
    for (_, ur), (_, up) in zip(closed_loop(cr, 20, [52, 29]),
                                closed_loop(cp, 20, [52, 29])):
        assert up.dtype == np.float32
        assert np.max(np.abs(np.asarray(ur, float) - up)) < 1e-3 * (1 + np.abs(ur).max())
        assert cr.getinfo()["converged"] and cp.getinfo()["converged"]


def test_estimators_and_options_construct():
    """LinMPC takes every linear estimator of the port; a CUDA device that is
    not there raises; dtype must be a torch float dtype."""
    m = siso(mt)
    for est in (mt.SteadyKalmanFilter(m), mt.KalmanFilter(m), mt.Luenberger(m),
                mt.InternalModel(m), mt.ManualEstimator(m)):
        assert mt.LinMPC(est, Hp=5, device=CPU).estim is est
    with pytest.raises(TypeError, match="dtype"):
        mt.LinMPC(m, Hp=5, dtype=np.float32, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mt.LinMPC(m, Hp=5, device="cuda")
