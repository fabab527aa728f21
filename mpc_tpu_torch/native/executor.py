"""ctypes wrapper for the native real-time executor (counterpart of
``mpc_tpu/native/executor.py``).

``build_executor`` compiles the repo-level ``native/rt_executor.cpp`` with
``$CXX`` (default ``g++``) once per process into the checkout's ``build/``
directory, beside the kernels' library, and loads it.  ``rt_run_exported``
drives a controller generated by :mod:`mpc_tpu_torch.codegen` at a fixed
period with deadline, jitter and solve-budget accounting — the production
counterpart of the reference's soft real-time loop.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = BUILD_DIR.parent / "native" / "rt_executor.cpp"


class RTStats(ctypes.Structure):
    _fields_ = [("steps_done", ctypes.c_int64),
                ("deadline_misses", ctypes.c_int64),
                ("budget_overruns", ctypes.c_int64),
                ("max_jitter_ns", ctypes.c_double),
                ("mean_jitter_ns", ctypes.c_double),
                ("max_exec_ns", ctypes.c_double),
                ("mean_exec_ns", ctypes.c_double)]

    def asdict(self):
        return {k: getattr(self, k) for k, _ in self._fields_}


_LIB = None


def build_executor():
    """Compile (once a process) and load the native executor; returns the
    CDLL.  The library is written under a per-process name and renamed into
    place, so concurrent processes never load a half-written file."""
    global _LIB
    if _LIB is not None:
        return _LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / "librt_executor.so"
    tmp = BUILD_DIR / f"librt_executor.{os.getpid()}.so"
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", str(SOURCE),
                    "-o", str(tmp)], check=True)
    os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.rt_run.restype = ctypes.c_int
    _LIB = lib
    return lib


def rt_run_exported(ctrl_lib, name, state, ym_seq, ry_seq, d_seq,
                    period_s, nym, ny, nd, nu, budget_s=None):
    """Run an exported controller (``mpc_tpu_torch.codegen``) under the
    native executor for ``len(ym_seq)`` periods of ``period_s`` seconds.

    ``budget_s``: per-step solve-time budget; defaults to the period (the
    reference's limit_solve_time = Ts policy) — steps whose execution
    exceeds it are counted in ``stats.budget_overruns``.

    Returns ``(u_history, RTStats)``.
    """
    lib = build_executor()
    steps = len(ym_seq)
    ym = np.ascontiguousarray(ym_seq, dtype=np.float64)
    ry = np.ascontiguousarray(ry_seq, dtype=np.float64)
    d = np.ascontiguousarray(d_seq if d_seq is not None
                             else np.zeros((steps, max(nd, 1))), dtype=np.float64)
    u = np.zeros((steps, nu), dtype=np.float64)
    stats = RTStats()
    FNTYPE = ctypes.CFUNCTYPE(None, ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_double),
                              ctypes.POINTER(ctypes.c_double),
                              ctypes.POINTER(ctypes.c_double),
                              ctypes.POINTER(ctypes.c_double))
    fn_ptr = ctypes.cast(getattr(ctrl_lib, f"{name}_step"), FNTYPE)
    dp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.rt_run(
        fn_ptr, ctypes.byref(state), dp(ym), dp(ry), dp(d), dp(u),
        ctypes.c_int(steps), ctypes.c_int(nym), ctypes.c_int(ny),
        ctypes.c_int(nd), ctypes.c_int(nu),
        ctypes.c_int64(int(period_s * 1e9)),
        ctypes.c_int64(0 if budget_s is None else int(budget_s * 1e9)),
        ctypes.byref(stats))
    if rc != 0:
        raise RuntimeError(f"rt_run failed with code {rc}")
    return u, stats
