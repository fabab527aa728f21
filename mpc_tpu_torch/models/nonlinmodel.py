"""Nonlinear plant model (counterpart of ``mpc_tpu/models/nonlinmodel.py``;
reference src/model/nonlinmodel.jl).

The user writes ``f(x, u, d, p)`` and ``h(x, d, p)`` with torch ops on ONE
sample (``torch.stack([...])`` where the JAX user writes ``jnp.array``);
continuous dynamics are discretized with a
:class:`~mpc_tpu_torch.models.solver.RungeKutta` solver (``solver=None``
means ``f`` is already discrete, as ``nonlinmodel.jl:4-13``).  Fleets batch
the per-sample functions ``_fd`` and ``_h_user`` with ``torch.func.vmap``
and differentiate them with ``torch.func.jacfwd``.

The host API (``updatestate``, ``evaloutput``, ``linearize``) takes and
returns NumPy; it evaluates on ``device`` (the GPU unless the caller asks
for another) in ``dtype`` (float64).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.config import resolve_device
from .base import SimModel
from .solver import DiffSolver, EmptySolver, RungeKutta


class NonLinModel(SimModel):
    def __init__(self, f, h, Ts, nu, nx, ny, nd=0, p=None, solver="rk4",
                 device=None, dtype=torch.float64):
        if solver is None:
            solver = EmptySolver()
        elif solver == "rk4":
            solver = RungeKutta(4)
        elif not isinstance(solver, DiffSolver):
            raise TypeError("solver must be None, 'rk4' or a DiffSolver")
        self.solver = solver
        self._f_user, self._h_user = f, h
        self._fd = solver.discretize(f, Ts)
        self._init_common(nu, nx, ny, nd, Ts)
        self.p = p
        self.device = resolve_device(device)
        self.dtype = dtype
        # validate the user functions' output shapes with one evaluation on
        # CPU zeros: a silent nx/ny mismatch otherwise surfaces much later as
        # an opaque shape error inside an estimator or controller step
        z = lambda n: torch.zeros(n, dtype=torch.float64)
        try:
            f_shape = tuple(self._fd(z(nx), z(nu), z(nd), p).shape)
            h_shape = tuple(h(z(nx), z(nd), p).shape)
        except Exception as e:
            raise ValueError(
                f"f/h are not traceable with x({nx},), u({nu},), d({nd},): {e}"
            ) from e
        if f_shape != (nx,):
            raise ValueError(f"f must return shape ({nx},), got {f_shape}")
        if h_shape != (ny,):
            raise ValueError(f"h must return shape ({ny},), got {h_shape}")

    def _tensors(self, *arrays):
        """Host arrays as tensors on the model's device, in one upload."""
        arrays = [np.asarray(a, float).ravel() for a in arrays]
        flat = torch.as_tensor(np.concatenate(arrays), dtype=self.dtype)
        return flat.to(self.device).split([a.size for a in arrays])

    def f(self, x0, u0, d0, p):
        # tensors (inside a step): the per-sample function; NumPy (the host
        # API): evaluated on the device, returned as NumPy
        if torch.is_tensor(x0):
            return self._fd(x0, u0, d0, p)
        return self._fd(*self._tensors(x0, u0, d0), p).cpu().numpy()

    def h(self, x0, d0, p):
        if torch.is_tensor(x0):
            return self._h_user(x0, d0, p)
        return self._h_user(*self._tensors(x0, d0), p).cpu().numpy()

    def __repr__(self):
        sname = type(self.solver).__name__
        if isinstance(self.solver, RungeKutta):
            sname = f"RungeKutta({self.solver.order}, supersample={self.solver.supersample})"
        return (f"NonLinModel with a sample time Ts = {self.Ts} s, {sname} solver:\n"
                f"└ dimensions:\n"
                f"  ├ {self.nu} manipulated inputs u\n"
                f"  ├ {self.nx} states x\n"
                f"  ├ {self.ny} outputs y\n"
                f"  └ {self.nd} measured disturbances d")
