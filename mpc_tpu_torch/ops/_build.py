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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_NAME = "libmpc_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
# H100 (232,448 bytes, or the card's own opt-in if less): the launch budget.
# Each kernel has three layouts, tried in order: "resident" when its one-lane
# block fits the budget (the controller's tables and the lanes' state in
# shared memory); then the sweep's "staged" (the lanes' state in shared
# memory, A's leading rows there too and the rest streamed through a ring)
# or GI's "split" (P⁻¹, the row norms and the warps' small state in shared
# memory, A's leading rows there too, the rest read from a column-major
# copy); "global" as the last resort (all of it in device memory, in a
# workspace).  The plain versions have no budget.  A block runs lanes of one
# controller, at most MAX_WARPS warps (kMaxWarps in both sources), one warp a
# lane at the fleet shapes; a GI block pulls up to LANES_PER_BLOCK lanes
# through its warps.  STATIC_RESERVE is kept out of a staged or split
# block's budget for the kernels' static shared variables.
HOPPER_SMEM_OPTIN = 232448
STATIC_RESERVE = 256
LAYOUTS = {"admm_sweep": ("resident", "staged", "global"),
           "gi_solve": ("resident", "split", "global")}
LAYOUT_CODE = {"resident": 0, "global": 1, "staged": 2, "split": 2}
MAX_WARPS = 16
LANES_PER_BLOCK = 32


def launch_budget(props) -> int:
    """Shared memory a block may use on the card of ``props``."""
    return min(HOPPER_SMEM_OPTIN, props.shared_memory_per_block_optin)


def check_layout(kernel, layout):
    """``(name, rows)`` of a forced layout: None, one of the kernel's
    ``LAYOUTS``, or (for the card checks) ``(name, rows)`` with the staged
    or split layout's count of A's rows kept in shared memory."""
    names = LAYOUTS[kernel]
    name, rows = layout if isinstance(layout, tuple) else (layout, None)
    if name is not None and name not in names or (
            rows is not None and (name != names[1] or int(rows) < 0)):
        raise ValueError(f"_layout must be None, one of {names} or ({names[1]!r}, rows), "
                         f"got {layout!r}")
    return name, None if rows is None else int(rows)


def align16(b: int) -> int:
    """``b`` bytes rounded up to 16 (the kernels' shared-memory parts)."""
    return (b + 15) // 16 * 16


def pow2(k: int) -> int:
    """The power of two ≥ k (≥ 1)."""
    return 1 << max(0, int(k) - 1).bit_length()


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
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [p.communicate()[0] for p in procs]
    rcs = [p.returncode for p in procs]
    if not any(rcs):
        r = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                            *map(str, objs)],
                           capture_output=True, text=True)
        rcs.append(r.returncode)
        logs.append(r.stdout + r.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if any(rcs):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({rcs}):\n" + "\n".join(logs))
    os.replace(tmp, so)
    stamp.write_text(digest)
    last_build.update(seconds=seconds, log="".join(logs))
    return so


def load_library():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("mpc_admm_sweep_f32", "mpc_admm_sweep_f64"):
            fn = getattr(lib, name)
            # Minvs, A, table, block_ctrl, rung, q, l, u, rhovs, x, z, y,
            # active, ws, n_blocks, width, warps, grouped, own, n, m,
            # n_lad, iters, smem_bytes, layout, rows, tile, stages, sigma,
            # alpha, stream
            fn.argtypes = [ptr] * 14 + [i32] * 14 + [f64, f64, ptr]
            fn.restype = i32
        for name in ("mpc_gi_solve_f32_f64", "mpc_gi_solve_f32_f32",
                     "mpc_gi_solve_f64_f64"):
            fn = getattr(lib, name)
            # Pinv, A, At, rows, table, block_ctrl, pmap, amap, own, q, l,
            # u, idx, side, vmask, Ginv, widx, wside, wcnt, max_it, x, lam,
            # it, conv, ws, n_blocks, width, warps, n, m, ns, warm,
            # smem_bytes, layout, tol, stream
            fn.argtypes = ([ptr] * 3 + [i32] + [ptr] * 4 + [i32] + [ptr] * 16 + [i32] * 9
                           + [f64, ptr])
            fn.restype = i32
        # residency: (variant, layout, warps, smem, mode) and (f64, layout,
        # grouped, width, threads, smem, own, n) → blocks per SM
        lib.mpc_gi_blocks_per_sm.argtypes = [i32] * 5
        lib.mpc_admm_blocks_per_sm.argtypes = [i32] * 8
        _lib = lib
    return _lib
