from .base import SimModel
from .linmodel import LinModel
from .nonlinmodel import NonLinModel
from .solver import DiffSolver, EmptySolver, ForwardEuler, RungeKutta
from .linearize import linearize, linearize_, get_linearization_func

__all__ = [
    "SimModel", "LinModel", "NonLinModel",
    "DiffSolver", "EmptySolver", "ForwardEuler", "RungeKutta",
    "linearize", "linearize_", "get_linearization_func",
]
