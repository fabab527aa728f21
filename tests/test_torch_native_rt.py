"""The port's native real-time executor against mpc_tpu.native.

Both packages' ``rt_run_exported`` drive the same exported controller (the
port's export of tests/test_native_rt.py's controller) from fresh states
over the same inputs: the applied inputs are bitwise equal, and so are
``steps_done`` and the keys of ``asdict()``.  The solve-budget accounting
flags every step at a 1 ns budget and none at 10 s.  No wall-clock pacing
is asserted here; ``chip_smoke.py`` checks it on the card machine.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

import mpc_tpu_torch as mt
from mpc_tpu.native import rt_run_exported as ref_run
from mpc_tpu_torch.codegen import compile_and_load, export_c
from mpc_tpu_torch.native import RTStats, build_executor, rt_run_exported

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(shutil.which("gcc") is None or shutil.which("g++") is None,
                                reason="no C/C++ compiler")


@pytest.fixture(scope="module")
def exported():
    m = mt.LinModel(mt.tf(3, [10, 1]), 0.01)
    ctrl = mt.LinMPC(m, Hp=10, Hc=2, Cwt=1e5, device="cpu")
    ctrl.setconstraint(umax=[5.0], umin=[-5.0])
    lib = compile_and_load(export_c(ctrl, name="rtp"), name="rtp")
    fields = [("xhat", ctypes.c_double * ctrl.estim.nx_hat), ("lastu0", ctypes.c_double),
              ("z", ctypes.c_double * ctrl.nZt),
              ("zd", ctypes.c_double * ctrl.A_stack.shape[0]),
              ("yd", ctypes.c_double * ctrl.A_stack.shape[0])]
    State = type("State", (ctypes.Structure,), {"_fields_": fields})

    def fresh():
        st = State()
        lib.rtp_init(ctypes.byref(st))
        return st
    return lib, fresh


def _inputs(steps=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(steps, 1)) * 0.1, np.full((steps, 1), 2.0)


@pytest.mark.parametrize("runner", ["port", "reference"])
def test_runs_the_exported_controller(exported, runner):
    lib, fresh = exported
    ym, ry = _inputs()
    run = rt_run_exported if runner == "port" else ref_run
    u, stats = run(lib, "rtp", fresh(), ym, ry, None, 0.002, 1, 1, 0, 1)
    s = stats.asdict()
    assert s["steps_done"] == len(ym)
    assert np.all(np.isfinite(u)) and np.all(np.abs(u) <= 5.0 + 1e-9)
    assert u[0, 0] > 0.5                   # drives toward the setpoint


def test_matches_the_reference_bitwise(exported):
    lib, fresh = exported
    ym, ry = _inputs(seed=1)
    u_p, s_p = rt_run_exported(lib, "rtp", fresh(), ym, ry, None, 0.001, 1, 1, 0, 1)
    u_r, s_r = ref_run(lib, "rtp", fresh(), ym, ry, None, 0.001, 1, 1, 0, 1)
    assert np.array_equal(u_p, u_r)
    assert s_p.asdict().keys() == s_r.asdict().keys()
    assert s_p.steps_done == s_r.steps_done == len(ym)
    assert [f for f, _ in RTStats._fields_] == list(s_r.asdict())


@pytest.mark.parametrize("budget_s, overruns", [(1e-9, "all"), (10.0, 0)])
def test_budget_overruns(exported, budget_s, overruns):
    lib, fresh = exported
    ym, ry = _inputs(steps=20)
    u, stats = rt_run_exported(lib, "rtp", fresh(), ym, ry, None, 0.002, 1, 1, 0, 1,
                               budget_s=budget_s)
    s = stats.asdict()
    assert s["steps_done"] == 20
    assert s["budget_overruns"] == (20 if overruns == "all" else 0)


def test_executor_is_built_once_into_the_build_directory():
    lib = build_executor()
    assert build_executor() is lib
    assert lib._name.endswith("build/librt_executor.so")
