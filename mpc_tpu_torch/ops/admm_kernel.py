"""Fused batched ADMM sweep: the port of ``mpc_tpu/ops/pallas_qp.py``.

``admm_sweep`` runs ``iters`` relaxed-ADMM sweeps (``mpc_tpu/ops/qp.py``
``admm_step``, the body of the Pallas ``_admm_kernel``) in place on the
``(x, z, y)`` of every ACTIVE lane of a batch of condensed QPs::

    min ½xᵀPx + qᵀx   s.t.  l ≤ Ax ≤ u

On a CUDA tensor it launches the hand-written kernel
``mpc_tpu_torch/csrc/admm_sweep.cu`` (one thread block per lane, the whole
sweep in shared memory; see the note at the top of that file).  On a CPU
tensor it runs ``admm_sweep_reference``, the plain torch version beside it.
There is no fallback from one to the other: a failed build or launch raises.

Shapes, batch leading: ``Minv`` (B, n, n), ``A`` (n_d, m, n) read per lane
through ``lane_ctrl`` (B,) int32, ``q``/``x`` (B, n), ``l``/``u``/``rho``/
``z``/``y`` (B, m), ``active`` (B,) bool.

``admm_batch`` keeps the lane-major signature of ``pallas_admm_batch``.
"""
from __future__ import annotations

import torch

from ..utils.lanes import mtv, mv, take
from ._build import HOPPER_SMEM_OPTIN, LAUNCHES, MAX_WARPS, block_threads


def smem_bytes(n: int, m: int, itemsize: int) -> int:
    """Shared memory of one lane's block: A, Minv, q/x/rhs/x̃, l/u/ρ/z/y and
    the per-warp partial sums of Aᵀ(ρz − y), exactly as the kernel lays them
    out."""
    return (m * n + n * n + 4 * n + 5 * m + MAX_WARPS * n) * itemsize


def _check_budget(n, m, dtype, budget):
    need = smem_bytes(n, m, torch.empty((), dtype=dtype).element_size())
    if need > budget:
        raise ValueError(
            f"problem too large for the fused ADMM kernel: one lane needs "
            f"{need} bytes of shared memory (n={n}, m={m}, {dtype}), the "
            f"block budget is {budget} bytes; use a smaller QP or float32")


def _check_args(Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active):
    B, n = x.shape
    m = z.shape[1]
    want = {"Minv": (Minv, (B, n, n)), "q": (q, (B, n)), "l": (l, (B, m)),
            "u": (u, (B, m)), "rho": (rho, (B, m)), "y": (y, (B, m)),
            "lane_ctrl": (lane_ctrl, (B,)), "active": (active, (B,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if A.dim() != 3 or tuple(A.shape[1:]) != (m, n):
        raise ValueError(f"A has shape {tuple(A.shape)}, expected (n_d, {m}, {n})")
    for name, t in (("Minv", Minv), ("A", A), ("q", q), ("l", l), ("u", u),
                    ("rho", rho), ("z", z), ("y", y)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"admm_sweep takes float32 or float64, got {x.dtype}")
    if lane_ctrl.dtype != torch.int32:
        raise TypeError(f"lane_ctrl must be int32, got {lane_ctrl.dtype}")
    if active.dtype != torch.bool:
        raise TypeError(f"active must be bool, got {active.dtype}")
    return B, n, m


def admm_sweep_reference(Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active,
                         iters, sigma, alpha):
    """Plain torch version of the kernel (same contract, same budget)."""
    B, n, m = _check_args(Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active)
    _check_budget(n, m, x.dtype, HOPPER_SMEM_OPTIN)
    A_l = take(A, lane_ctrl)
    xs, zs, ys = x, z, y
    for _ in range(int(iters)):
        rhs = sigma * xs - q + mtv(A_l, rho * zs - ys)
        xt = mv(Minv, rhs)
        zt = mv(A_l, xt)
        xn = alpha * xt + (1 - alpha) * xs
        zp = alpha * zt + (1 - alpha) * zs
        zn = torch.clamp(zp + ys / rho, l, u)
        ys = ys + rho * (zp - zn)
        xs, zs = xn, zn
    keep = active[:, None]
    x.copy_(torch.where(keep, xs, x))
    z.copy_(torch.where(keep, zs, z))
    y.copy_(torch.where(keep, ys, y))
    return x, z, y


def admm_sweep(Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active, iters,
               sigma, alpha):
    """``iters`` ADMM sweeps in place on the active lanes' (x, z, y).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    dev = x.device
    if dev.type == "cpu":
        return admm_sweep_reference(Minv, A, lane_ctrl, q, l, u, rho, x, z,
                                    y, active, iters, sigma, alpha)
    if dev.type != "cuda":
        raise ValueError(f"admm_sweep runs on cpu or cuda, got {dev}")
    B, n, m = _check_args(Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active)
    ts = (Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active)
    for t in ts:
        if t.device != dev:
            raise ValueError(f"admm_sweep arguments must all lie on {dev}")
        if not t.is_contiguous():
            raise ValueError("admm_sweep arguments must be contiguous")
    budget = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    _check_budget(n, m, x.dtype, budget)
    if B == 0 or iters <= 0:
        return x, z, y
    from ._build import load_library
    lib = load_library()
    fn = lib.mpc_admm_sweep_f32 if x.dtype == torch.float32 else lib.mpc_admm_sweep_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ts), B, n, m, int(iters),
                block_threads(m), smem_bytes(n, m, x.element_size()),
                float(sigma), float(alpha), stream)
    if rc != 0:
        raise RuntimeError(f"admm_sweep kernel launch failed: CUDA error {rc}")
    LAUNCHES["admm_sweep"] += 1
    return x, z, y


def admm_batch(Minv, A, q, l, u, rho, x0, *, iters=200, sigma=1e-6,
               alpha=1.6):
    """Lane-major counterpart of ``pallas_admm_batch``.

    Shapes: ``Minv`` (n, n, B), ``A`` (m, n, B), ``q``/``x0`` (n, B),
    ``l``/``u``/``rho`` (m, B).  Starts from z = clip(A x0, l, u), y = 0, runs
    ``iters`` sweeps and returns x (n, B).  Any B (the multiple-of-128 rule
    was the TPU's tiling).
    """
    lead = lambda t: torch.movedim(t, -1, 0).contiguous()
    Minv_b, A_b, q_b, l_b, u_b, rho_b = map(lead, (Minv, A, q, l, u, rho))
    x = lead(x0).clone()
    B = x.shape[0]
    lane_ctrl = torch.arange(B, dtype=torch.int32, device=x.device)
    z = torch.clamp(mv(A_b, x), l_b, u_b).contiguous()
    y = torch.zeros_like(z)
    active = torch.ones(B, dtype=torch.bool, device=x.device)
    admm_sweep(Minv_b, A_b, lane_ctrl, q_b, l_b, u_b, rho_b, x, z, y, active,
               iters, sigma, alpha)
    return torch.movedim(x, 0, -1)
