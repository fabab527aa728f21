"""Build and load the port's hand-written CUDA kernels.

The sources under ``mpc_tpu_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
``build/libmpc_tpu_torch_kernels.so`` at the root of the checkout, on first
use.  A stamp file beside it holds the hash of the sources and flags; the
library is rebuilt when the hash changes.  The launch counts and the launch
geometry both kernels share live here too.  Nothing here runs at import:
the CPU tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_NAME = "libmpc_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
# what the last build did: seconds spent in nvcc (0.0 when the stamp
# matched) and the compiler's output (ptxas register/shared-memory report)
last_build = {"seconds": None, "log": ""}

# Kernel launches made by the wrappers, one count per kernel (read and reset
# by callers that need to show a run went through the kernels).
LAUNCHES = {"admm_sweep": 0, "gi_solve": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# Launch geometry both kernels share.  Shared memory one block may use on an
# H100 (232,448 bytes): the budget the plain versions check, so the CPU tests
# exercise the same guard.
HOPPER_SMEM_OPTIN = 232448
MAX_WARPS = 8       # kMaxWarps in csrc/admm_sweep.cu and csrc/gi_solve.cu


def block_threads(m: int) -> int:
    """Threads of one lane's block: the rows rounded up to a warp, 32…256."""
    return min(32 * MAX_WARPS, max(32, -(-m // 32) * 32))


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of mpc_tpu_torch cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels unless the stamped library is current."""
    so = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if so.exists() and stamp.exists() and stamp.read_text() == digest:
        last_build.update(seconds=0.0, log="")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, so)
    stamp.write_text(digest)
    last_build.update(seconds=seconds, log=r.stdout + r.stderr)
    return so


def load_library():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("mpc_admm_sweep_f32", "mpc_admm_sweep_f64"):
            fn = getattr(lib, name)
            # Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active,
            # B, n, m, iters, threads, smem_bytes, sigma, alpha, stream
            fn.argtypes = [ptr] * 11 + [i32] * 6 + [f64, f64, ptr]
            fn.restype = i32
        for name in ("mpc_gi_solve_f32_f64", "mpc_gi_solve_f32_f32",
                     "mpc_gi_solve_f64_f64"):
            fn = getattr(lib, name)
            # Pinv, A, lane_ctrl, q, l, u, idx, side, vmask, Ginv, widx,
            # wside, wcnt, max_it, x, lam, it, conv,
            # B, n, m, ns, warm, threads, smem_bytes, tol, stream
            fn.argtypes = [ptr] * 18 + [i32] * 7 + [f64, ptr]
            fn.restype = i32
        _lib = lib
    return _lib
