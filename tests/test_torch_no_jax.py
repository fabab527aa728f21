"""mpc_tpu_torch stands alone: no JAX, and no silent move to the CPU."""
import subprocess
import sys

import pytest
import torch

import mpc_tpu_torch
from mpc_tpu_torch.parallel import BatchedLinMPC, random_cstr_controllers

torch.set_num_threads(1)


def test_import_pulls_in_no_jax():
    # a subprocess: tests/conftest.py has imported jax into this one
    code = ("import sys, mpc_tpu_torch, mpc_tpu_torch.parallel, "
            "mpc_tpu_torch.ops, mpc_tpu_torch.sim, mpc_tpu_torch.estimators; "
            "from mpc_tpu_torch import (sim, SimResult, KalmanFilter, "
            "Luenberger, InternalModel, ManualEstimator); "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'mpc_tpu.')) "
            "or m == 'mpc_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cuda_request_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        assert mpc_tpu_torch.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        mpc_tpu_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchedLinMPC(random_cstr_controllers(1), device="cuda")
    model = mpc_tpu_torch.LinModel(mpc_tpu_torch.tf(2, [10, 1]), 1.0)
    for qp_solver in ("admm", "active_set"):
        with pytest.raises(RuntimeError, match="cuda"):
            mpc_tpu_torch.LinMPC(model, Hp=5, device="cuda", qp_solver=qp_solver)
    assert mpc_tpu_torch.resolve_device(None) == torch.device("cpu")
