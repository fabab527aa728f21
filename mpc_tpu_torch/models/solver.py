"""Fixed-step ODE solvers for NonLinModel (counterpart of
``mpc_tpu/models/solver.py``; reference src/model/solver.jl).

Each solver turns the continuous ``dx/dt = f(x, u, d, p)`` into a
*discrete-time* update ``xnext = fd(x, u, d, p)`` on one sample, built of
torch ops, so that ``torch.func.vmap`` batches it and ``torch.func.jacfwd``
differentiates it.  The ``supersample`` sub-steps are a plain Python loop.
"""
from __future__ import annotations


class DiffSolver:
    """Base class for explicit fixed-step solvers."""

    order: int = 0
    supersample: int = 1

    def discretize(self, f, Ts):
        raise NotImplementedError


class EmptySolver(DiffSolver):
    """Marker for an already-discrete ``f`` (reference: nonlinmodel.jl:4-13)."""

    def discretize(self, f, Ts):
        return f


class RungeKutta(DiffSolver):
    """Explicit Runge-Kutta solver, order 1 (Euler) or 4 (solver.jl:1-17)."""

    def __init__(self, order: int = 4, supersample: int = 1):
        if order not in (1, 4):
            raise ValueError("only 1st and 4th order RK are supported")
        if supersample < 1:
            raise ValueError("supersample must be ≥ 1")
        self.order = order
        self.supersample = int(supersample)

    def discretize(self, f, Ts):
        h = Ts / self.supersample
        ns = self.supersample
        if self.order == 1:
            def body(xk, u, d, p):
                return xk + h * f(xk, u, d, p)
        else:
            def body(xk, u, d, p):
                k1 = f(xk, u, d, p)
                k2 = f(xk + 0.5 * h * k1, u, d, p)
                k3 = f(xk + 0.5 * h * k2, u, d, p)
                k4 = f(xk + h * k3, u, d, p)
                return xk + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

        def step(x, u, d, p):
            for _ in range(ns):
                x = body(x, u, d, p)
            return x
        return step


def ForwardEuler(supersample: int = 1) -> RungeKutta:
    """Forward Euler solver (solver.jl:59-79)."""
    return RungeKutta(order=1, supersample=supersample)
