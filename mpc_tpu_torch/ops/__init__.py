from .qp import QPSolution, build_solver_cache, solve_qp
from ._build import LAUNCHES, reset_launch_counts
from .admm_kernel import admm_batch, admm_sweep, admm_sweep_reference
from .gi_kernel import gi_solve, gi_solve_reference, violation_scan_reference
from .qp_active import build_gi_cache, gi_state_init, solve_qp_active
