"""Fused batched ADMM sweep: the port of ``mpc_tpu/ops/pallas_qp.py``.

``admm_sweep`` runs ``iters`` relaxed-ADMM sweeps (``mpc_tpu/ops/qp.py``
``admm_step``, the body of the Pallas ``_admm_kernel``) in place on the
``(x, z, y)`` of every ACTIVE lane of a batch of condensed QPs::

    min ½xᵀPx + qᵀx   s.t.  l ≤ Ax ≤ u

On a CUDA tensor it launches the hand-written kernel
``mpc_tpu_torch/csrc/admm_sweep.cu`` (lanes grouped by controller, one
block per group: one warp per lane for n ≤ 32 in a large batch, else the
group's lanes in step; see the note at the top of that file).  On a CPU tensor it runs
``admm_sweep_reference``, the plain torch version beside it.  There is no
fallback from one to the other: a failed build or launch raises.

Shapes, batch leading: the ρ ladder ``Minvs`` (n_d, n_lad, n, n) and
``rhovs`` (n_d, n_lad, m) and ``A`` (n_d, m, n) are stacked over distinct
controllers; lane b sweeps with ``Minvs[lane_ctrl[b], rung[b]]``,
``rhovs[lane_ctrl[b], rung[b]]`` and ``A[lane_ctrl[b]]``.  ``lane_ctrl`` and
``rung`` are (B,) int32, ``q``/``x`` (B, n), ``l``/``u``/``z``/``y`` (B, m),
``active`` (B,) bool.

``admm_batch`` keeps the lane-major signature of ``pallas_admm_batch``.
"""
from __future__ import annotations

import torch

from ..utils.lanes import lane_blocks, mtv, mv, take
from ._build import HOPPER_SMEM_OPTIN, LAUNCHES, MAX_WARPS, align16, pow2

# The lanes in step (admm_group_kernel): at most GROUP a block (kGroup), on
# GROUP_THREADS threads (kGroupThreads).  One warp a lane (admm_warp_kernel)
# for n ≤ 32 once the batch puts WARP_LANES_PER_SM lanes on each SM: fewer
# lanes are swept faster by a whole block each.
GROUP = 2
GROUP_THREADS = 256
GROUP_PARTS = 16        # row classes of the in-step Aᵀv split, at most (kMaxParts)
WARP_LANES_PER_SM = 8


def smem_bytes(n: int, m: int, itemsize: int, lanes: int = 1, grouped=None) -> int:
    """Shared memory of one block of ``lanes`` lanes, exactly as the kernel
    lays it out (each part rounded up to 16 bytes): the controller's A once;
    then per lane l, u, ρ, z and y, and for a warp a lane (n ≤ 32 unless
    ``grouped``) the lane's Minv, rhs, x̃ and the ⌊32/n⌋·n partial sums of
    Aᵀ(ρz − y), for the lanes in step ρz − y, x, q, rhs and x̃, plus the
    block's parts·lanes·n partial sums, parts = ⌊256/n⌋ clamped to
    [1, 16]."""
    a = align16(itemsize * m * n)
    if not (n > 32 if grouped is None else grouped):
        return a + lanes * align16(itemsize * (5 * m + n * n + 2 * n + (32 // n) * n))
    parts = min(max(1, GROUP_THREADS // n), GROUP_PARTS)
    return (a + lanes * align16(itemsize * (6 * m + 4 * n))
            + align16(itemsize * parts * lanes * n))


def launch_geometry(lane_ctrl, n, m, itemsize, budget, sms):
    """``(table, block_ctrl, warps, grouped, smem)`` of a launch: the lanes
    grouped by controller (``utils/lanes.py::lane_blocks``, cached per
    ``lane_ctrl``).  One warp a lane when n ≤ 32 and the B lanes put at
    least ``WARP_LANES_PER_SM`` on each of the card's ``sms``
    multiprocessors: ⌈B/sms⌉ lanes a block, rounded up to a power of two,
    up to ``MAX_WARPS`` and the shared-memory budget.  Else the lanes in
    step: up to ``GROUP`` a block, but no more than leave two blocks for
    each SM, so a small batch keeps every SM busy before it shares A reads
    (8x8/Hp=15 on an H100: B=256 runs fastest a lane a block, B=4096 two
    lanes a block; four and eight were slower there)."""
    B = lane_ctrl.shape[0]
    grouped = (n > 32 or B < WARP_LANES_PER_SM * sms
               and smem_bytes(n, m, itemsize, 1, True) <= budget)
    if not grouped:
        cap = min(MAX_WARPS, pow2(-(-B // sms)))
        while cap > 1 and smem_bytes(n, m, itemsize, cap, False) > budget:
            cap -= 1
    else:
        per = max(1, B // (2 * sms))
        cap = GROUP
        while cap > 1 and (cap > per or smem_bytes(n, m, itemsize, cap, True) > budget):
            cap //= 2
    table, block_ctrl = lane_blocks(lane_ctrl, cap)
    width = table.shape[1]
    warps = GROUP_THREADS // 32 if grouped else width
    return table, block_ctrl, warps, grouped, smem_bytes(n, m, itemsize, width, grouped)


def _check_budget(n, m, dtype, budget):
    need = smem_bytes(n, m, torch.empty((), dtype=dtype).element_size())
    if need > budget:
        raise ValueError(
            f"problem too large for the fused ADMM kernel: one lane needs "
            f"{need} bytes of shared memory (n={n}, m={m}, {dtype}), the "
            f"block budget is {budget} bytes; use a smaller QP or float32")


def _check_args(Minvs, A, lane_ctrl, rung, q, l, u, rhovs, x, z, y, active):
    B, n = x.shape
    m = z.shape[1]
    n_d = A.shape[0]
    if A.dim() != 3 or tuple(A.shape[1:]) != (m, n):
        raise ValueError(f"A has shape {tuple(A.shape)}, expected (n_d, {m}, {n})")
    n_lad = Minvs.shape[1] if Minvs.dim() == 4 else -1
    want = {"Minvs": (Minvs, (n_d, n_lad, n, n)), "rhovs": (rhovs, (n_d, n_lad, m)),
            "q": (q, (B, n)), "l": (l, (B, m)), "u": (u, (B, m)), "y": (y, (B, m)),
            "lane_ctrl": (lane_ctrl, (B,)), "rung": (rung, (B,)),
            "active": (active, (B,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t in (("Minvs", Minvs), ("A", A), ("q", q), ("l", l), ("u", u),
                    ("rhovs", rhovs), ("z", z), ("y", y)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"admm_sweep takes float32 or float64, got {x.dtype}")
    for name, t in (("lane_ctrl", lane_ctrl), ("rung", rung)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if active.dtype != torch.bool:
        raise TypeError(f"active must be bool, got {active.dtype}")
    return B, n, m, n_lad


def admm_sweep_reference(Minvs, A, lane_ctrl, rung, q, l, u, rhovs, x, z, y,
                         active, iters, sigma, alpha):
    """Plain torch version of the kernel (same contract, same budget)."""
    B, n, m, _ = _check_args(Minvs, A, lane_ctrl, rung, q, l, u, rhovs, x, z,
                             y, active)
    _check_budget(n, m, x.dtype, HOPPER_SMEM_OPTIN)
    lc, rg = lane_ctrl.long(), rung.long()
    Minv, rho = Minvs[lc, rg], rhovs[lc, rg]
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


def admm_sweep(Minvs, A, lane_ctrl, rung, q, l, u, rhovs, x, z, y, active,
               iters, sigma, alpha):
    """``iters`` ADMM sweeps in place on the active lanes' (x, z, y).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    dev = x.device
    if dev.type == "cpu":
        return admm_sweep_reference(Minvs, A, lane_ctrl, rung, q, l, u, rhovs,
                                    x, z, y, active, iters, sigma, alpha)
    if dev.type != "cuda":
        raise ValueError(f"admm_sweep runs on cpu or cuda, got {dev}")
    B, n, m, n_lad = _check_args(Minvs, A, lane_ctrl, rung, q, l, u, rhovs, x,
                                 z, y, active)
    ts = (Minvs, A, lane_ctrl, rung, q, l, u, rhovs, x, z, y, active)
    for t in ts:
        if t.device != dev:
            raise ValueError(f"admm_sweep arguments must all lie on {dev}")
        if not t.is_contiguous():
            raise ValueError("admm_sweep arguments must be contiguous")
    props = torch.cuda.get_device_properties(dev)
    budget = props.shared_memory_per_block_optin
    _check_budget(n, m, x.dtype, budget)
    if B == 0 or iters <= 0:
        return x, z, y
    from ._build import load_library
    lib = load_library()
    fn = lib.mpc_admm_sweep_f32 if x.dtype == torch.float32 else lib.mpc_admm_sweep_f64
    table, block_ctrl, warps, grouped, smem = launch_geometry(
        lane_ctrl, n, m, x.element_size(), budget, props.multi_processor_count)
    ptrs = (Minvs, A, table, block_ctrl, rung, q, l, u, rhovs, x, z, y, active)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), table.shape[0], table.shape[1],
                warps, int(grouped), n, m, n_lad, int(iters), smem, float(sigma),
                float(alpha), stream)
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
    was the TPU's tiling).  Each lane is its own controller with a one-rung
    ladder.
    """
    lead = lambda t: torch.movedim(t, -1, 0).contiguous()
    Minv_b, A_b, q_b, l_b, u_b, rho_b = map(lead, (Minv, A, q, l, u, rho))
    x = lead(x0).clone()
    B = x.shape[0]
    lane_ctrl = torch.arange(B, dtype=torch.int32, device=x.device)
    rung = torch.zeros(B, dtype=torch.int32, device=x.device)
    z = torch.clamp(mv(A_b, x), l_b, u_b).contiguous()
    y = torch.zeros_like(z)
    active = torch.ones(B, dtype=torch.bool, device=x.device)
    admm_sweep(Minv_b[:, None].contiguous(), A_b, lane_ctrl, rung, q_b, l_b,
               u_b, rho_b[:, None].contiguous(), x, z, y, active, iters, sigma,
               alpha)
    return torch.movedim(x, 0, -1)
