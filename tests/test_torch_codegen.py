"""The port's embedded C export against mpc_tpu.codegen.

Every case builds the same LinMPC in both packages (the port's on the CPU)
and exports it with the same name and QP solver.  Bars: the port's C source
equals the reference's line by line except the header comment, every baked
constant within 1e-12·(1 + |c|) (the Ruiz scalings come from torch instead
of jnp); the port's compiled step holds u to the reference's compiled step,
per step, to 1e-9 (GI) and 1e-7 (ADMM), and to the port's own ``moveinput``
at the bar of the reference's test of that controller
(tests/test_codegen.py).  The guards raise the reference's exception types
with its messages.  The cases are tests/test_codegen.py's five controllers
and the README controller with the exact active set.
"""
import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.codegen import export_c as ref_export
from mpc_tpu_torch.codegen import compile_and_load, export_c
from mpc_tpu_torch.sim import _copy_model

torch.set_num_threads(1)
CPU = torch.device("cpu")
pytestmark = pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")


def on_cpu(pkg):
    return {"device": CPU} if pkg is mt else {}


def siso(pkg, **kw):
    m = pkg.LinModel(pkg.tf(3, [10, 1]), 1.0)
    m.setop(uop=[2.0], yop=[5.0])
    c = pkg.LinMPC(m, Hp=10, Hc=2, Cwt=1e5, **on_cpu(pkg), **kw)
    c.setconstraint(umin=[-10], umax=[10], dumax=[3], dumin=[-3], ymax=[9.0], ymin=[0.0])
    return c


def mimo_d(pkg):
    G = np.array([[pkg.tf(1.9, [18, 1])] * 3,
                  [pkg.tf(-0.74, [8, 1]), pkg.tf(0.74, [8, 1]), pkg.tf(-0.74, [8, 1])]],
                 dtype=object)
    c = pkg.LinMPC(pkg.LinModel(G, 2.0, i_d=[2]), Hp=8, Hc=2, Cwt=1e5, **on_cpu(pkg))
    c.setconstraint(umax=[4.0, 4.0], umin=[-4.0, -4.0])
    return c


def luenberger(pkg):
    m = pkg.LinModel(pkg.tf(3, [10, 1]), 1.0)
    c = pkg.LinMPC(pkg.Luenberger(m, nint_ym=[1], poles=[0.4, 0.45]), Hp=10, Hc=2,
                   **on_cpu(pkg))
    c.setconstraint(umax=[2.0])
    return c


def soft(pkg):
    c = pkg.LinMPC(pkg.LinModel(pkg.tf(3, [10, 1]), 1.0), Hp=8, Hc=2, Cwt=1e2,
                   **on_cpu(pkg))
    c.setconstraint(umin=[-0.5], umax=[0.5], c_umin=[1.0], c_umax=[1.0], ymin=[2.0])
    return c


def readme(pkg):
    G = pkg.tf_matrix([[pkg.tf(2, [10, 1]) * pkg.delay(20)], [pkg.tf(10, [4, 1])]])
    c = pkg.LinMPC(pkg.LinModel(G, 1.0), Mwt=[1, 0], Nwt=[0.1], qp_solver="active_set",
                   **on_cpu(pkg))
    c.setconstraint(ymax=[np.inf, 35])
    return c


def noisy(mean, scale, seed):
    rng = np.random.default_rng(seed)
    return lambda k, u: np.asarray(mean, float) + rng.normal(size=np.size(mean)) * scale


def plant_fed(pkg, noise=0.0, seed=0):
    """Measurements of a copy of the model stepped with the port's u."""
    def make(ctrl):
        plant = _copy_model(ctrl.estim.model)
        rng = np.random.default_rng(seed)

        def y_of(k, u_prev):
            if u_prev is not None:
                plant.updatestate(u_prev)
            return np.asarray(plant.evaloutput(), float) + noise * rng.normal(size=plant.ny)
        return y_of
    return make


# name: (controller, export solver, steps, ry, d, measurements, bar vs moveinput)
CASES = {
    "siso": (siso, "admm", 15, [7.0], None, lambda c: noisy(5.0, 0.3, 3), 2e-4),
    "mimo_d": (mimo_d, "admm", 10, [1.0, -0.5], [0.3], lambda c: noisy([0.0, 0.0], 0.5, 4),
               5e-4),
    "luenberger": (luenberger, "admm", 20, [2.5], None, plant_fed(mt), 2e-4),
    "active_set": (siso, "active_set", 15, [7.0], None, lambda c: noisy(5.0, 0.3, 3), 1e-9),
    "soft": (soft, "admm", 10, [3.0], None, lambda c: noisy(0.0, 0.1, 0), 5e-3),
    "readme_active_set": (readme, "active_set", 30, [5.0, 0.0], None,
                          plant_fed(mt, noise=0.05, seed=1), 1e-9),
}
STEP_BAR = {"admm": 1e-7, "active_set": 1e-9}


def state_type(ctrl, solver):
    """The generated ``<name>_state_t`` as a ctypes structure."""
    nx, nu, nz, mr_ = (ctrl.estim.nx_hat, ctrl.estim.model.nu, ctrl.nZt,
                       ctrl.A_stack.shape[0])
    fields = [("xhat", ctypes.c_double * nx), ("lastu0", ctypes.c_double * nu),
              ("z", ctypes.c_double * nz)]
    if solver == "admm":
        fields.append(("zd", ctypes.c_double * mr_))
    fields.append(("yd", ctypes.c_double * mr_))
    return type("State", (ctypes.Structure,), {"_fields_": fields})


class CStep:
    """One compiled controller: ``step(ym, ry, d) -> u``."""

    def __init__(self, lib, name, ctrl, solver):
        self.lib, self.name, self.nu = lib, name, ctrl.estim.model.nu
        self.st = state_type(ctrl, solver)()
        getattr(lib, f"{name}_init")(ctypes.byref(self.st))

    def step(self, ym, ry, d):
        arr = lambda v: (ctypes.c_double * max(len(v), 1))(*v)
        u = (ctypes.c_double * self.nu)()
        getattr(self.lib, f"{self.name}_step")(ctypes.byref(self.st), arr(list(ym)),
                                               arr(list(ry)), arr(list(d or [])), u)
        return np.array(u[:])


@pytest.fixture(scope="module")
def runs():
    """Per case, built once: both sources, both compiled steps and the
    port's moveinput driven over one measurement sequence."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        make, solver, steps, ry, d, meas, _ = CASES[case]
        cr, cp = make(mr), make(mt)
        name = f"t_{case}"
        src_r = ref_export(cr, name=name, solver=solver)
        src_p = export_c(cp, name=name, solver=solver)
        c_r = CStep(compile_and_load(src_r, name=name), name, cr, solver)
        c_p = CStep(compile_and_load(src_p, name=name), name, cp, solver)
        y_of = meas(cp)
        U_py, U_r, U_p = [], [], []
        u_prev = None
        for k in range(steps):
            y = np.atleast_1d(y_of(k, u_prev))
            cp.preparestate(y, *([d] if d else []))
            u = cp.moveinput(ry, *([d] if d else []))
            cp.updatestate(u, y, *([d] if d else []))
            U_py.append(np.asarray(u, float))
            U_r.append(c_r.step(y, ry, d))
            U_p.append(c_p.step(y, ry, d))
            u_prev = u
        cache[case] = dict(src_r=src_r, src_p=src_p, U_py=np.array(U_py),
                           U_r=np.array(U_r), U_p=np.array(U_p), solver=solver)
        return cache[case]
    return get


CONST = re.compile(r"static const double (\w+)\[(\d+)\] = \{(.*)\};$")


@pytest.mark.parametrize("case", CASES)
def test_source_equals_the_references(case, runs):
    r = runs(case)
    lr, lp = r["src_r"].splitlines(), r["src_p"].splitlines()
    assert len(lr) == len(lp)
    assert lr[0] == "/* Auto-generated by mpc_tpu.codegen — standalone LinMPC step."
    assert lp[0] == "/* Auto-generated by mpc_tpu_torch.codegen — standalone LinMPC step."
    n_const = 0
    for a, b in zip(lr[1:], lp[1:]):
        if a == b:
            continue
        ma, mb = CONST.match(a), CONST.match(b)
        assert ma and mb and ma.groups()[:2] == mb.groups()[:2], (a[:80], b[:80])
        va = np.array([float(v) for v in ma.group(3).split(",")])
        vb = np.array([float(v) for v in mb.group(3).split(",")])
        assert np.all(np.abs(va - vb) <= 1e-12 * (1.0 + np.abs(va))), ma.group(1)
        n_const += 1
    if r["solver"] == "active_set":
        assert n_const == 0          # no Ruiz scaling: every constant is exact


@pytest.mark.parametrize("case", CASES)
def test_compiled_step_matches_the_references(case, runs):
    r = runs(case)
    gap = np.max(np.abs(r["U_p"] - r["U_r"]), axis=1)
    assert np.all(gap <= STEP_BAR[r["solver"]]), gap


@pytest.mark.parametrize("case", CASES)
def test_compiled_step_matches_moveinput(case, runs):
    r = runs(case)
    gap = np.max(np.abs(r["U_p"] - r["U_py"]), axis=1)
    assert np.all(gap < CASES[case][6]), gap
    if case == "soft":
        assert np.all(r["U_py"][1:, 0] > 0.5)       # the soft bound is exceeded
    if case == "luenberger":
        assert np.all(r["U_py"] <= 2.0 + 1e-8)


def _guard_ctrl(pkg, guard):
    m = pkg.LinModel(pkg.tf(3, [10, 1]), 1.0)
    if guard == "solver":
        return pkg.LinMPC(m, Hp=5, Hc=2, **on_cpu(pkg)), dict(solver="osqp")
    if guard == "estimator":
        return pkg.LinMPC(pkg.KalmanFilter(m), Hp=5, Hc=2, **on_cpu(pkg)), {}
    if guard == "transcription":
        return pkg.LinMPC(m, Hp=5, Hc=2, transcription=pkg.MultipleShooting(),
                          **on_cpu(pkg)), {}
    if guard == "custom_constraints":
        return pkg.LinMPC(m, Hp=5, Hc=2, Wy=np.array([[1.0]]), **on_cpu(pkg)), {}
    # Nwt = 0 on a plant whose input enters no output: H is singular
    G = np.array([[pkg.tf(3, [10, 1]), pkg.tf(0.0, [1.0])]], dtype=object)
    return (pkg.LinMPC(pkg.LinModel(G, 1.0), Hp=5, Hc=2, Nwt=[0.1, 0.0], **on_cpu(pkg)),
            dict(solver="active_set"))


@pytest.mark.parametrize("guard", ["solver", "estimator", "transcription",
                                   "custom_constraints", "not_positive_definite"])
def test_guards_raise_as_the_reference(guard):
    (cr, kr), (cp, kp) = _guard_ctrl(mr, guard), _guard_ctrl(mt, guard)
    with pytest.raises(Exception) as er:
        ref_export(cr, **kr)
    with pytest.raises(Exception) as ep:
        export_c(cp, **kp)
    assert type(er.value) is type(ep.value) is ValueError
    assert str(er.value) == str(ep.value)
