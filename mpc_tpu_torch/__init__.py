"""mpc_tpu_torch — the PyTorch/CUDA port of mpc_tpu.

A second package beside ``mpc_tpu`` (the JAX reference), with the same
module layout and names.  It imports torch, NumPy and SciPy, never JAX.

Ported: every module of the reference.  The linear-MPC path: lti, LinModel, the
linear estimators (SteadyKalmanFilter, KalmanFilter, Luenberger,
InternalModel, ManualEstimator, host NumPy at run time), LinMPC with
``moveinput``/``getinfo``/``setmodel``, custom constraints and the
Ts-deadline policy, ``sim``, the ADMM QP (cached and in-solve setup, with
its polish) and the Goldfarb–Idnani active-set QP (cached or in-solve P⁻¹,
with its cross-period operator carry), and ``parallel.BatchedLinMPC`` — and
the nonlinear-plant path: NonLinModel with its RK4/Euler solvers,
``linearize`` (``torch.func.jacfwd``), the unscented and extended Kalman
filters, ``parallel.BatchedKalman`` and SLMPC (successive linearization,
single controller and fleet); NonLinMPC and ExplicitMPC with their fleets;
moving horizon estimation (``MovingHorizonEstimator`` and
``parallel.BatchedMHE``); the compiled closed loops (``sim_compiled``:
whole N-step loops and Monte-Carlo fleets of them with one upload and one
download) and the SymPy model bridge (``utils.symbolic``); the embedded
C export (``codegen``: ``export_c``, ``compile_and_load``) and the native
real-time executor (``native``: ``RTStats``, ``build_executor``,
``rt_run_exported``); the fleets' and compiled loops' ``mesh=`` lane
sharding over a sequence of devices (``parallel.mesh``) and the fleet's
``grouped_chunks``.  The ADMM inner sweep and the whole per-lane
GI solve are hand-written CUDA kernels for Hopper (``csrc/admm_sweep.cu``,
``csrc/gi_solve.cu``) that every QP, single controller or fleet, goes
through on the GPU.  Every entry point runs on the GPU unless the caller
asks for ``device="cpu"``.
"""
from .utils import tf, delay, ss, tf_matrix, StateSpace, TransferFunction
from .utils.config import BIG, resolve_device
from .models import (SimModel, LinModel, NonLinModel, RungeKutta, ForwardEuler,
                     EmptySolver, DiffSolver, linearize, linearize_,
                     get_linearization_func)
from .estimators import (StateEstimator, SteadyKalmanFilter, KalmanFilter,
                         UnscentedKalmanFilter, ExtendedKalmanFilter,
                         Luenberger, InternalModel, ManualEstimator,
                         MovingHorizonEstimator, default_nint)
from .controllers import (PredictiveController, LinMPC, ExplicitMPC, NonLinMPC, SLMPC,
                          TranscriptionMethod, SingleShooting, MultipleShooting,
                          TrapezoidalCollocation, OrthogonalCollocation, info2debugstr)
from .sim import sim, SimResult
from .sim_compiled import (CompiledClosedLoop, CompiledSLLoop,
                           CompiledMHELoop, CompiledMHEMPCLoop,
                           CompiledNonLinLoop)

__version__ = "0.1.0"
