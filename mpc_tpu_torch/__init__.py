"""mpc_tpu_torch — the PyTorch/CUDA port of mpc_tpu.

A second package beside ``mpc_tpu`` (the JAX reference), with the same
module layout and names.  It imports torch, NumPy and SciPy, never JAX.

Ported so far: the batched LinMPC serving step — the construct-time NumPy
constructors (lti, LinModel, SteadyKalmanFilter, transcriptions, LinMPC params
and the ADMM and Goldfarb–Idnani solver caches), the cached batched ADMM QP
solve with its polish, the batched Goldfarb–Idnani active-set solve with
its cross-period operator carry, and ``parallel.BatchedLinMPC`` — with the
ADMM inner sweep and the whole per-lane GI solve as hand-written CUDA
kernels for Hopper (``csrc/admm_sweep.cu``, ``csrc/gi_solve.cu``).
"""
from .utils import tf, delay, ss, tf_matrix, StateSpace, TransferFunction
from .utils.config import BIG, resolve_device
from .models import SimModel, LinModel
from .estimators import StateEstimator, SteadyKalmanFilter
from .controllers import (PredictiveController, LinMPC, SingleShooting,
                          MultipleShooting)

__version__ = "0.1.0"
