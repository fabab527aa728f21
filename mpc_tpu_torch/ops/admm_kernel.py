"""Fused batched ADMM sweep: the port of ``mpc_tpu/ops/pallas_qp.py``.

``admm_sweep`` runs ``iters`` relaxed-ADMM sweeps (``mpc_tpu/ops/qp.py``
``admm_step``, the body of the Pallas ``_admm_kernel``) in place on the
``(x, z, y)`` of every ACTIVE lane of a batch of condensed QPs::

    min ½xᵀPx + qᵀx   s.t.  l ≤ Ax ≤ u

On a CUDA tensor it launches the hand-written kernel
``mpc_tpu_torch/csrc/admm_sweep.cu`` (lanes grouped by controller, one
block per group: one warp per lane for n ≤ 32 in a large batch, else the
group's lanes in step; see the note at the top of that file), in its
resident layout when one lane's block fits the card's shared memory, else
in its staged layout when the lanes do (A streamed through shared memory),
else in its global layout, with a workspace in device memory.  On a CPU
tensor it runs ``admm_sweep_reference``, the plain torch version beside it,
which sweeps any shape.  There is no fallback from one to the other: a
failed build or launch raises.

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

from ..utils.lanes import (identity_lanes, lane_blocks, lane_rows, mtv, mv,
                           singleton_groups, take)
from ._build import (LAUNCHES, LAYOUT_CODE, MAX_WARPS, STATIC_RESERVE,
                     align16, check_layout, launch_budget, pow2)

# The lanes in step (admm_group_kernel): at most GROUP a block (kGroup), on
# GROUP_THREADS threads (kGroupThreads).  One warp a lane (admm_warp_kernel)
# for n ≤ 32 once the batch puts WARP_LANES_PER_SM lanes on each SM: fewer
# lanes are swept faster by a whole block each.
GROUP = 2
GROUP_THREADS = 256
GROUP_PARTS = 16        # row classes of the in-step Aᵀv split, at most (kMaxParts)
WARP_LANES_PER_SM = 8
# The staged layout (admm_staged_kernel, the lanes in step, n ≤ GROUP_THREADS):
# up to STAGED_LANES lanes a block (kStagedGroup), A's rows past the resident
# ones streamed in tiles of STAGED_TILE_ROWS rows through a ring of
# STAGED_STAGES buffers; A's leading rows fill what the lanes and the ring
# leave of a block's shared memory (one block an SM).
STAGED_LANES = 4
STAGED_TILE_ROWS = 256
STAGED_STAGES = 2
# The per-lane geometry (every lane its own controller): at most
# PER_LANE_WARPS lanes a block, one a warp
PER_LANE_WARPS = MAX_WARPS


def _parts(n: int) -> int:
    """Row classes of the in-step Aᵀv split: ⌊256/n⌋ clamped to [1, 16]."""
    return min(max(1, GROUP_THREADS // n), GROUP_PARTS)


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
    return (a + lanes * align16(itemsize * (6 * m + 4 * n))
            + align16(itemsize * _parts(n) * lanes * n))


def own_bytes(n: int, m: int, itemsize: int, warps: int = 1) -> int:
    """Shared memory of a per-lane block (every lane its own controller) of
    ``warps`` warps, one lane a warp: each warp's area is its lane's A and
    then the lane's part of ``smem_bytes``."""
    return warps * (align16(itemsize * m * n)
                    + align16(itemsize * (5 * m + n * n + 2 * n + (32 // n) * n)))


def workspace_bytes(n: int, m: int, itemsize: int, lanes: int = 1, grouped=None,
                    blocks: int = 1) -> int:
    """Device memory of a global-layout launch of ``blocks`` blocks of
    ``lanes`` lanes, exactly as the kernel lays it out: each block's part
    of ``smem_bytes`` after A, in the same order, without each lane's l, u
    and ρ (A, l, u and ρ are read where they lie)."""
    if not (n > 32 if grouped is None else grouped):
        return blocks * lanes * align16(itemsize * (2 * m + n * n + 2 * n + (32 // n) * n))
    return blocks * (lanes * align16(itemsize * (3 * m + 4 * n))
                     + align16(itemsize * _parts(n) * lanes * n))


def row_stride(n: int, itemsize: int) -> int:
    """n rounded up to 16 bytes: the row stride of the staged layout's
    padded copy of A."""
    per = 16 // itemsize
    return -(-n // per) * per


def staged_bytes(n: int, m: int, itemsize: int, lanes: int = 1, rows: int = 0,
                 tile: int = None, stages: int = None) -> int:
    """Shared memory of a staged block of ``lanes`` lanes, exactly as
    ``admm_staged_kernel`` lays it out (each part rounded up to 16 bytes):
    per lane z, y (m each) and x, q, rhs (n each); ρz − y (m) and x̃ (n) of
    every lane, interleaved; the parts·lanes·n partial sums; then chunks of
    rows, each A's rows padded to 16 bytes and the lanes' l, u and ρ of
    them: the resident chunk of ``rows`` rows and ``stages`` ring chunks of
    min(``tile``, m − rows) rows."""
    tile = min(STAGED_TILE_ROWS if tile is None else tile, m - rows)
    stages = STAGED_STAGES if stages is None else stages
    s, lda = itemsize, row_stride(n, itemsize)
    chunk = lambda r: align16(s * r * lda) + align16(s * 3 * lanes * r)
    return (lanes * align16(s * (2 * m + 3 * n)) + align16(s * m * lanes)
            + align16(s * n * lanes) + align16(s * _parts(n) * lanes * n)
            + chunk(rows) + stages * chunk(tile))


def staged_plan(n: int, m: int, itemsize: int, lanes: int, budget: int, rows=None):
    """``(rows, tile, stages, smem)`` of a staged block of ``lanes`` lanes
    (rounded up to a power of two, as the kernel's instantiations), or None
    where it does not fit in the ``budget`` less STATIC_RESERVE.  The ring's
    tiles are STAGED_TILE_ROWS rows, halved (down to 64) until the block
    fits; ``rows`` None keeps as many of A's leading rows as the rest
    leaves room for."""
    if n > GROUP_THREADS:
        return None
    lanes = pow2(lanes)
    cap = budget - STATIC_RESERVE
    size = lambda r, t: staged_bytes(n, m, itemsize, lanes, r, t)
    tile = STAGED_TILE_ROWS
    while tile > 64 and size(rows or 0, tile) > cap:
        tile //= 2
    if rows is None:
        if size(0, tile) > cap:
            return None
        rows = min(m, (cap - size(0, tile))
                   // (itemsize * (row_stride(n, itemsize) + 3 * lanes)))
        while rows > 0 and size(rows, tile) > cap:
            rows -= 1
    elif not 0 <= rows <= m or size(rows, tile) > cap:
        return None
    return rows, min(tile, m - rows), STAGED_STAGES, size(rows, tile)


def launch_geometry(lane_ctrl, n, m, itemsize, budget, sms, layout=None):
    """``(table, block_ctrl, warps, grouped, smem, layout)`` of a launch: the
    lanes grouped by controller (``utils/lanes.py::lane_blocks``, cached per
    ``lane_ctrl``).  One warp a lane when n ≤ 32 and the B lanes put at
    least ``WARP_LANES_PER_SM`` on each of the card's ``sms``
    multiprocessors (or the lanes in step do not fit the shared-memory
    ``budget``): ⌈B/sms⌉ lanes a block, rounded up to a power of two, up to
    ``MAX_WARPS``.  Else the lanes in step: up to ``GROUP`` a block, but no
    more than leave two blocks for each SM, so a small batch keeps every SM
    busy before it shares A reads (8x8/Hp=15 on an H100: B=256 runs fastest
    a lane a block, B=4096 two lanes a block; four and eight were slower
    there).  ``layout`` None takes "resident" when one lane's block of that
    variant fits the budget (lanes are then added while they fit), else
    "staged" for the lanes in step when one lane's staged block fits
    (``staged_plan``; up to STAGED_LANES lanes a block), else "global"; the
    variant does not depend on the layout, so where several take a shape
    they sum in the same order.  ``layout`` may also be ("staged", rows),
    the count of A's rows kept in shared memory (for the card checks).

    The per-lane geometry: one warp a lane where every lane is the only one
    of its controller (n_d = B) and the resident layout takes it — each
    warp with its lane's own A (``own_bytes``), as many warps a block as
    ⌈B/sms⌉ asks for (a power of two, up to ``PER_LANE_WARPS``, while they
    fit):
    ``table`` is ``utils/lanes.py::lane_rows`` and ``block_ctrl`` None."""
    layout, rows = check_layout("admm_sweep", layout)
    B = lane_ctrl.shape[0]
    staged = lambda lanes, r=None: staged_plan(n, m, itemsize, lanes, budget, r)
    grouped = (n > 32 or B < WARP_LANES_PER_SM * sms
               and (smem_bytes(n, m, itemsize, 1, True) <= budget or staged(1) is not None))
    if (not grouped and layout in (None, "resident") and own_bytes(n, m, itemsize) <= budget
            and singleton_groups(lane_ctrl)):
        cap = min(PER_LANE_WARPS, pow2(-(-B // sms)))
        while cap > 1 and own_bytes(n, m, itemsize, cap) > budget:
            cap -= 1
        return (lane_rows(B, cap, lane_ctrl.device), None, cap, False,
                own_bytes(n, m, itemsize, cap), "resident")
    if layout is None:
        layout = ("resident" if smem_bytes(n, m, itemsize, 1, grouped) <= budget
                  else "staged" if grouped and staged(1) is not None else "global")
    if layout == "staged" and (not grouped or staged(1, rows) is None):
        raise ValueError(f"the staged layout does not take n={n}, m={m} "
                         f"({'a warp a lane' if not grouped else f'{rows} rows'})")
    fits = {"resident": lambda lanes: smem_bytes(n, m, itemsize, lanes, grouped) <= budget,
            "staged": lambda lanes: staged(lanes, rows) is not None,
            "global": lambda lanes: True}[layout]
    if not grouped:
        cap = min(MAX_WARPS, pow2(-(-B // sms)))
        while cap > 1 and not fits(cap):
            cap -= 1
    else:
        per = max(1, B // (2 * sms))
        cap = STAGED_LANES if layout == "staged" else GROUP
        while cap > 1 and (cap > per or not fits(cap)):
            cap //= 2
    table, block_ctrl = lane_blocks(lane_ctrl, cap)
    width = table.shape[1]
    warps = GROUP_THREADS // 32 if grouped else width
    smem = {"resident": lambda: smem_bytes(n, m, itemsize, width, grouped),
            "staged": lambda: staged(width, rows)[3], "global": lambda: 0}[layout]()
    return table, block_ctrl, warps, grouped, smem, layout


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
    """Plain torch version of the kernel (same contract, any shape)."""
    _check_args(Minvs, A, lane_ctrl, rung, q, l, u, rhovs, x, z, y, active)
    lc, rg = lane_ctrl.long(), rung.long()
    Minv, rho = Minvs[lc, rg], rhovs[lc, rg]
    A_l = take(A, lane_ctrl, count=False)
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
               iters, sigma, alpha, *, _layout=None):
    """``iters`` ADMM sweeps in place on the active lanes' (x, z, y).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    ``_layout`` ("resident", "staged", ("staged", rows) or "global") forces
    the kernel's layout, for the checks that hold one against the other;
    None picks it by size.
    """
    _, rows = check_layout("admm_sweep", _layout)
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
    if B == 0 or iters <= 0:
        return x, z, y
    from ._build import load_library
    lib = load_library()
    fn = lib.mpc_admm_sweep_f32 if x.dtype == torch.float32 else lib.mpc_admm_sweep_f64
    s = x.element_size()
    table, block_ctrl, warps, grouped, smem, layout = launch_geometry(
        lane_ctrl, n, m, s, launch_budget(props), props.multi_processor_count, _layout)
    # the per-lane geometry (block_ctrl None) reads each lane's controller
    own = block_ctrl is None
    ptrs = (Minvs, A, table, lane_ctrl if own else block_ctrl, rung, q, l, u, rhovs, x, z, y,
            active)
    # the global layout's workspace: a block of the caching allocator, which
    # hands the same block back to the next launch of this shape on this
    # stream
    ws = None
    if layout == "global":
        ws = torch.empty(workspace_bytes(n, m, s, table.shape[1], grouped, table.shape[0]),
                         dtype=torch.uint8, device=dev)
    # the staged layout's resident rows, tile rows and stages, and its copy
    # of A with rows padded to 16 bytes (one copy a launch)
    plan = (staged_plan(n, m, s, table.shape[1], launch_budget(props), rows)
            if layout == "staged" else (0, 0, 0))
    if layout == "staged":
        ptrs = (Minvs, torch.nn.functional.pad(A, (0, row_stride(n, s) - n)), *ptrs[2:])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), None if ws is None else ws.data_ptr(),
                table.shape[0], table.shape[1], warps, int(grouped), int(own), n, m, n_lad,
                int(iters), smem, LAYOUT_CODE[layout], *plan[:3], float(sigma),
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
    lane_ctrl = identity_lanes(B, x.device)
    rung = torch.zeros(B, dtype=torch.int32, device=x.device)
    z = torch.clamp(mv(A_b, x), l_b, u_b).contiguous()
    y = torch.zeros_like(z)
    active = torch.ones(B, dtype=torch.bool, device=x.device)
    admm_sweep(Minv_b[:, None].contiguous(), A_b, lane_ctrl, rung, q_b, l_b,
               u_b, rho_b[:, None].contiguous(), x, z, y, active, iters, sigma,
               alpha)
    return torch.movedim(x, 0, -1)
