"""mpc_tpu_torch stands alone: no JAX, and no silent move to the CPU."""
import subprocess
import sys

import pytest
import torch

import mpc_tpu_torch as mt
from mpc_tpu_torch.utils.symbolic import nonlinmodel_from_sympy
from mpc_tpu_torch.parallel import (BatchedExplicitMPC, BatchedKalman, BatchedLinMPC,
                                    random_cstr_controllers)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_import_pulls_in_no_jax():
    # a subprocess: tests/conftest.py has imported jax into this one
    code = ("import sys, mpc_tpu_torch, mpc_tpu_torch.parallel, "
            "mpc_tpu_torch.ops, mpc_tpu_torch.sim, mpc_tpu_torch.estimators, "
            "mpc_tpu_torch.models, mpc_tpu_torch.controllers; "
            "from mpc_tpu_torch import (sim, SimResult, KalmanFilter, "
            "Luenberger, InternalModel, ManualEstimator, NonLinModel, "
            "RungeKutta, ForwardEuler, DiffSolver, EmptySolver, linearize, "
            "linearize_, get_linearization_func, UnscentedKalmanFilter, "
            "ExtendedKalmanFilter, SLMPC, NonLinMPC, ExplicitMPC, "
            "TranscriptionMethod, TrapezoidalCollocation, OrthogonalCollocation, "
            "MovingHorizonEstimator); "
            "from mpc_tpu_torch.parallel import (BatchedKalman, BatchedNonLinMPC, "
            "BatchedExplicitMPC, BatchedMHE); "
            "from mpc_tpu_torch.models import solver, nonlinmodel; "
            "from mpc_tpu_torch.controllers import slmpc, nonlinmpc, explicitmpc; "
            "from mpc_tpu_torch.parallel import batch_kf, batch_nonlin, batch_explicit, "
            "batch_mhe; "
            "from mpc_tpu_torch.estimators import mhe, mhe_fast; "
            "import mpc_tpu_torch.sim_compiled, mpc_tpu_torch.utils.symbolic; "
            "from mpc_tpu_torch import (CompiledClosedLoop, CompiledSLLoop, "
            "CompiledMHELoop, CompiledMHEMPCLoop, CompiledNonLinLoop); "
            "from mpc_tpu_torch.sim_compiled import CompiledClosedLoopFleet; "
            "from mpc_tpu_torch.utils.symbolic import nonlinmodel_from_sympy; "
            "import mpc_tpu_torch.codegen, mpc_tpu_torch.native, mpc_tpu_torch.parallel.mesh; "
            "from mpc_tpu_torch.codegen import export_c, compile_and_load; "
            "from mpc_tpu_torch.native import RTStats, build_executor, rt_run_exported; "
            "from mpc_tpu_torch.parallel.mesh import LaneShards; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'mpc_tpu.')) "
            "or m == 'mpc_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _pendulum(device=None):
    f = lambda x, u, d, p: torch.stack([x[1], -torch.sin(x[0]) + u[0]])
    h = lambda x, d, p: x[:1]
    return mt.NonLinModel(f, h, 0.1, 1, 2, 1, device=device)


def _sympy_model(device=None):
    sp = pytest.importorskip("sympy")
    x, u = sp.symbols("x u")
    return nonlinmodel_from_sympy({x: -x + u}, [x], 0.1, inputs=[u], device=device)


def test_default_device_is_the_gpu():
    """Every entry point runs on the GPU unless the caller asks for the
    CPU; without a GPU the default raises, it never falls back."""
    if torch.cuda.is_available():
        assert mt.resolve_device(None).type == "cuda"
        assert mt.resolve_device("cuda").type == "cuda"
        return
    assert mt.resolve_device("cpu") == CPU
    lin = mt.LinModel(mt.tf(2, [10, 1]), 1.0)
    cpu_ctrls = random_cstr_controllers(1, device=CPU)
    eps = [{k: v[0] for k, v in mt.parallel.estimator_params(cpu_ctrls).items()}]
    entry_points = {
        "resolve_device": lambda dev: mt.resolve_device(dev),
        "LinMPC admm": lambda dev: mt.LinMPC(lin, Hp=5, device=dev),
        "LinMPC active_set": lambda dev: mt.LinMPC(lin, Hp=5, device=dev,
                                                   qp_solver="active_set"),
        "BatchedLinMPC": lambda dev: BatchedLinMPC(cpu_ctrls, device=dev),
        "BatchedLinMPC.from_params": lambda dev: BatchedLinMPC.from_params(
            [cpu_ctrls[0].params], eps, device=dev),
        "random_cstr_controllers": lambda dev: random_cstr_controllers(1, device=dev),
        "NonLinModel": _pendulum,
        "SLMPC": lambda dev: mt.SLMPC(_pendulum(CPU), Hp=5, device=dev),
        "UnscentedKalmanFilter": lambda dev: mt.UnscentedKalmanFilter(lin, device=dev),
        "ExtendedKalmanFilter": lambda dev: mt.ExtendedKalmanFilter(lin, device=dev),
        "BatchedKalman": lambda dev: BatchedKalman([mt.KalmanFilter(lin)], device=dev),
        "NonLinMPC": lambda dev: mt.NonLinMPC(_pendulum(CPU), Hp=5, device=dev),
        "ExplicitMPC": lambda dev: mt.ExplicitMPC(lin, Hp=5, device=dev),
        "BatchedExplicitMPC": lambda dev: BatchedExplicitMPC(
            [mt.ExplicitMPC(lin, Hp=5, device=CPU)], device=dev),
        "MovingHorizonEstimator": lambda dev: mt.MovingHorizonEstimator(lin, He=3, device=dev),
        "MovingHorizonEstimator nonlinear": lambda dev: mt.MovingHorizonEstimator(
            _pendulum(CPU), He=3, device=dev),
        "nonlinmodel_from_sympy": _sympy_model,
    }
    for name, make in entry_points.items():
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="cuda"):
                make(dev)
        make(CPU)
