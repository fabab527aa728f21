"""Per-lane Goldfarb–Idnani solve: the kernel wrapper and its plain version.

``gi_solve`` runs, for every lane of a batch of dense QPs

    min ½xᵀPx + qᵀx   s.t.  l ≤ Ax ≤ u

what ``mpc_tpu/ops/qp_active.py::_gi_impl`` runs for one: the warm loop
(warm-row inserts by bordering, the KKT jump, wrong-sign drops) and then the
main loop, whose every iteration is the violation scan (the work of the
Pallas ``kmv`` kernel, ``docs/pallas_gi_experiment.py:84``), the fused
select-and-pivot step, the unified rank-one update of the inverse Gram
``Ginv``, the slot-cap overflow test, the f32 anti-cycling detectors, the
one-shot cold restart and the infeasibility certificate.

On a CUDA tensor it launches the hand-written kernel
``mpc_tpu_torch/csrc/gi_solve.cu`` (lanes grouped by controller, one block
per group and one warp per lane; see the note at the top of that file), in
its resident layout when one warp's block fits the card's shared memory,
else in its split layout when the warps' small state does (A's leading rows
in shared memory, the rest read from a column-major copy), else in its
global layout, with a workspace in device memory.  On a
CPU tensor it runs ``gi_solve_reference``, the plain torch version beside
it, which solves any shape.  There is no fallback from one to the other: a
failed build or launch raises.

Arguments, batch leading (B lanes, n variables, m rows, ns slots):

* ``Pinv`` (n_d, n, n) in the SLOT dtype and ``A`` (n_a, m, n) in the DATA
  dtype, read per lane through ``lane_ctrl`` (B,) int32, A through the A
  map ``a_ctrl`` (B,) int32 where one is given (the MHE fleet's NaN
  variant: a P⁻¹ a lane, one shared A), else through ``lane_ctrl`` too;
* ``q`` (B, n), ``l``/``u`` (B, m) in the data dtype;
* the operator state ``idx``/``side`` (B, ns) int32, ``vmask`` (B, ns) bool
  and ``Ginv`` (B, ns, ns) in the slot dtype — updated IN PLACE;
* the warm-row list ``widx``/``wside`` (B, ns) int32 with ``wcnt`` (B,)
  int32 pending rows, ``warm`` (bool: a carried state or a dual seed was
  given), the per-lane iteration cap ``max_it`` (B,) int32 and ``tol``.

Returns ``(x, lam, it, converged)``: x (B, n) and the slot multipliers
(B, ns) in the slot dtype, the iteration count (B,) int32 and the
``done & feasible`` flag (B,) bool.  The data dtype is float32 or float64;
the slot dtype is float64, or float32 with float32 data.
"""
from __future__ import annotations

import torch

from ..utils.lanes import lane_blocks, lane_rows, singleton_groups, take
from ._build import (LANES_PER_BLOCK, LAUNCHES, LAYOUT_CODE, MAX_WARPS,
                     STATIC_RESERVE, align16, check_layout, launch_budget,
                     pow2)

_BIG = 1e18        # ops.qp._BIG: bounds beyond this are infinite
_TINY = 1e-30
# warps a block in the split layout, at most: the rest of the shared memory
# holds A's leading rows
SPLIT_WARPS = 16


def smem_bytes(n: int, m: int, ns: int, data_size: int, slot_size: int,
               warps: int = 1, pw: bool = False) -> int:
    """Shared memory of one block of ``warps`` lanes, exactly as the kernel
    lays it out (each part rounded up to 16 bytes): the controller's P⁻¹
    (slot dtype), A with its rows padded to 16 bytes and its row norms (data
    dtype), once per block; then per warp Ginv, the n-vectors (x, x_un, the
    pivot row, P⁻¹aₚ, a scratch vector) and the ns-vectors (λ, g, r, a Ginv
    row, the KKT right-hand side and multipliers) in the slot dtype, x
    (padded), l, u and the slot table Aact in the data dtype, and idx, side,
    vmask as 4-byte ints.  ``pw`` (P⁻¹ a lane, A shared): P⁻¹ moves from
    the block's part to the head of each warp's slice."""
    lda = _row_stride(n, data_size)
    p = align16(slot_size * n * n)
    ctrl = (0 if pw else p) + data_size * m * lda + align16(data_size * m)
    return ctrl + warps * ((p if pw else 0) + _slice_bytes(n, m, ns, data_size, slot_size))


def own_bytes(n: int, m: int, ns: int, data_size: int, slot_size: int,
              warps: int = 1) -> int:
    """Shared memory of a per-lane block (every lane its own controller) of
    ``warps`` warps: each warp's area is its lane's P⁻¹, A (rows padded to
    16 bytes) and row norms, then the slice of ``smem_bytes``."""
    return warps * smem_bytes(n, m, ns, data_size, slot_size, 1)


def _row_stride(n, data_size):
    """n rounded up to 16 bytes of the data dtype (A's rows, x)."""
    per = 16 // data_size
    return -(-n // per) * per


def _slice_bytes(n, m, ns, data_size, slot_size, lu=True):
    """One lane's slice: a warp's part of ``smem_bytes``; without l and u
    (``lu`` False) in the split and global layouts, which read them in
    place."""
    return (align16(slot_size * (ns * ns + 5 * n + 6 * ns))
            + align16(data_size * (_row_stride(n, data_size) + (2 * m if lu else 0) + ns * n))
            + align16(4 * 3 * ns))


def workspace_bytes(n: int, m: int, ns: int, data_size: int, slot_size: int,
                    lanes: int = 1, blocks: int = 1) -> int:
    """Device memory of a global-layout launch of ``blocks`` blocks over
    ``lanes`` lanes, exactly as the kernel lays it out: each block's row
    norms (data dtype, rounded up to 16 bytes), then each lane's slice, the
    parts of a warp's slice in ``smem_bytes`` but l and u, at the lane's
    index.  A, P⁻¹, l and u stay where they lie."""
    return (blocks * align16(data_size * m)
            + lanes * _slice_bytes(n, m, ns, data_size, slot_size, lu=False))


def split_bytes(n: int, m: int, ns: int, data_size: int, slot_size: int,
                warps: int = 1, rows: int = 0, pw: bool = False) -> int:
    """Shared memory of a split-layout block of ``warps`` warps, exactly as
    the kernel lays it out: P⁻¹ (unless P⁻¹ comes a lane, ``pw``: then read
    where it lies), A's first ``rows`` rows padded to 16 bytes and the m row
    norms, then per warp the slice of ``smem_bytes`` without l and u."""
    lda = _row_stride(n, data_size)
    return ((0 if pw else align16(slot_size * n * n)) + data_size * rows * lda
            + align16(data_size * m)
            + warps * _slice_bytes(n, m, ns, data_size, slot_size, lu=False))


def split_plan(n, m, ns, data_size, slot_size, warps, budget, rows=None, pw=False):
    """``(rows, smem)`` of a split block of ``warps`` warps in the
    shared-memory ``budget`` less STATIC_RESERVE, or None where it does not
    fit; ``rows`` None keeps as many of A's leading rows as the budget
    leaves room for."""
    cap = budget - STATIC_RESERVE
    size = lambda r: split_bytes(n, m, ns, data_size, slot_size, warps, r, pw)
    if rows is None:
        base = size(0)
        if base > cap:
            return None
        rows = min(m, (cap - base) // (data_size * _row_stride(n, data_size)))
    elif not 0 <= rows <= m or size(rows) > cap:
        return None
    return rows, size(rows)


def launch_geometry(lane_ctrl, n, m, ns, data_size, slot_size, budget, sms,
                    layout=None, a_ctrl=None):
    """``(table, block_ctrl, warps, smem, layout)`` of a launch: the lanes
    grouped by controller (``utils/lanes.py::lane_blocks``, cached per
    ``lane_ctrl``; by A's controller, the A map ``a_ctrl``, where one is
    given, each warp then reading its lane's P⁻¹), ⌈B/sms⌉ lanes a block
    rounded up to a power of two, at most ``LANES_PER_BLOCK``, so that a
    small batch still spreads over the card's ``sms`` multiprocessors; as
    many warps a block as the table is wide, up to ``MAX_WARPS``.
    ``layout`` None takes "resident" when one warp's block fits the
    shared-memory ``budget`` (the warps then also fit it), else "split"
    when one warp's split block fits it (up to SPLIT_WARPS warps, A's
    leading rows in the rest: ``split_plan``), else "global" (no shared
    memory but the lane counter).  ``layout`` may also be ("split", rows),
    the count of A's rows kept in shared memory (for the card checks).

    The per-lane geometry: where every lane is the only one of its A's
    controller (n_d = B) and the resident layout takes it, a block holds
    one lane a warp, each warp with its lane's own P⁻¹, A and row norms
    (``own_bytes``), as many warps as ⌈B/sms⌉ asks for (a power of two, up
    to ``MAX_WARPS``, while they fit): ``table`` is ``utils/lanes.py::
    lane_rows`` and ``block_ctrl`` None."""
    layout, rows = check_layout("gi_solve", layout)
    sizes = (n, m, ns, data_size, slot_size)
    pw = a_ctrl is not None
    group = lane_ctrl if a_ctrl is None else a_ctrl
    B = lane_ctrl.shape[0]
    width = min(LANES_PER_BLOCK, pow2(-(-B // sms)))
    if (layout in (None, "resident") and own_bytes(*sizes) <= budget
            and singleton_groups(group)):
        warps = min(width, MAX_WARPS)
        while warps > 1 and own_bytes(*sizes, warps) > budget:
            warps -= 1
        return lane_rows(B, warps, group.device), None, warps, own_bytes(*sizes, warps), \
            "resident"
    split = lambda warps: split_plan(*sizes, warps, budget, rows, pw)
    if layout is None:
        layout = ("resident" if smem_bytes(*sizes, 1, pw) <= budget
                  else "split" if split_plan(*sizes, 1, budget, None, pw) is not None
                  else "global")
    if layout == "split" and split(1) is None:
        raise ValueError(f"the split layout does not take n={n}, m={m}, {ns} slots, "
                         f"{rows} rows")
    table, block_ctrl = lane_blocks(group, width)
    warps = min(table.shape[1], MAX_WARPS)
    if layout == "global":
        return table, block_ctrl, warps, 0, layout
    if layout == "split":
        warps = min(warps, SPLIT_WARPS)
        while warps > 1 and split(warps) is None:
            warps -= 1
        return table, block_ctrl, warps, split(warps)[1], layout
    while warps > 1 and smem_bytes(*sizes, warps, pw) > budget:
        warps -= 1
    return table, block_ctrl, warps, smem_bytes(*sizes, warps, pw), layout


def slot_dtype_for(dt, slot_dtype=None):
    """The slot dtype of a solve on ``dt`` data: float64 unless float32
    slots are asked for on float32 data."""
    if slot_dtype is None or slot_dtype == torch.float64:
        return torch.float64
    if slot_dtype == torch.float32 and dt == torch.float32:
        return torch.float32
    raise TypeError(f"slot dtype {slot_dtype} with {dt} data: the slots are "
                    "float64, or float32 with float32 data")


def _check_args(Pinv, A, lane_ctrl, q, l, u, idx, side, vmask, Ginv, widx,
                wside, wcnt, max_it, a_ctrl=None):
    B, n = q.shape
    m = l.shape[1]
    ns = idx.shape[1]
    want = {"q": (q, (B, n)), "l": (l, (B, m)), "u": (u, (B, m)),
            "idx": (idx, (B, ns)), "side": (side, (B, ns)),
            "vmask": (vmask, (B, ns)), "Ginv": (Ginv, (B, ns, ns)),
            "widx": (widx, (B, ns)), "wside": (wside, (B, ns)),
            "wcnt": (wcnt, (B,)), "max_it": (max_it, (B,)),
            "lane_ctrl": (lane_ctrl, (B,))}
    if a_ctrl is not None:
        want["a_ctrl"] = (a_ctrl, (B,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if A.dim() != 3 or tuple(A.shape[1:]) != (m, n):
        raise ValueError(f"A has shape {tuple(A.shape)}, expected (n_a, {m}, {n})")
    n_d = Pinv.shape[0] if a_ctrl is not None else A.shape[0]
    if tuple(Pinv.shape) != (n_d, n, n):
        raise ValueError(f"Pinv has shape {tuple(Pinv.shape)}, expected ({n_d}, {n}, {n})")
    if not 1 <= ns <= n:
        raise ValueError(f"the slot count must lie in [1, n={n}], got {ns}")
    dt, hi = A.dtype, Ginv.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"gi_solve takes float32 or float64 data, got {dt}")
    slot_dtype_for(dt, hi)       # raises unless hi is a slot dtype of dt
    for name, t in (("q", q), ("l", l), ("u", u)):
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, A is {dt}")
    if Pinv.dtype != hi:
        raise TypeError(f"Pinv is {Pinv.dtype}, Ginv (the slot dtype) is {hi}")
    for name, t in (("lane_ctrl", lane_ctrl), ("idx", idx), ("side", side),
                    ("widx", widx), ("wside", wside), ("wcnt", wcnt),
                    ("max_it", max_it)) + ((("a_ctrl", a_ctrl),) if a_ctrl is not None else ()):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if vmask.dtype != torch.bool:
        raise TypeError(f"vmask must be bool, got {vmask.dtype}")
    return B, n, m, ns


def violation_scan_reference(A_l, x_d, l, u, row_nrm):
    """The scan phase of one GI iteration (the work of ``kmv``), per lane.

    ``A_l`` (B, m, n), ``x_d`` (B, n) and ``l``/``u``/``row_nrm`` (B, m), all
    in the data dtype.  Returns ``(Ax, vl, vu, score)``: A·x, the lower and
    upper violations (−∞ on infinite sides) and max(vl, vu) over the
    round-off scale max(‖aᵢ‖·‖x‖, 1), whose first argmax is the row picked.
    """
    Ax = torch.matmul(A_l, x_d.unsqueeze(-1)).squeeze(-1)
    scale = torch.clamp(row_nrm * torch.linalg.vector_norm(x_d, dim=1,
                                                           keepdim=True), min=1.0)
    ninf = float("-inf")
    vl = torch.where(l > -_BIG, l - Ax, ninf)
    vu = torch.where(u < _BIG, Ax - u, ninf)
    return Ax, vl, vu, torch.maximum(vl, vu) / scale


def gi_solve_reference(Pinv, A, lane_ctrl, q, l, u, idx, side, vmask, Ginv,
                       widx, wside, wcnt, warm, max_it, tol, a_ctrl=None):
    """Plain torch version of the kernel (same contract, any shape).

    ``_gi_impl`` over a leading lane axis: one Python loop per GI loop,
    running while any lane is live, with every carry field committed by
    ``torch.where(live, new, old)`` — the semantics of ``vmap`` over
    ``lax.while_loop``, which keeps a finished lane's carry.
    """
    B, n, m, ns = _check_args(Pinv, A, lane_ctrl, q, l, u, idx, side, vmask,
                              Ginv, widx, wside, wcnt, max_it, a_ctrl)
    dt, hi, dev = A.dtype, Ginv.dtype, q.device
    inf = float("inf")
    A_l = take(A, lane_ctrl if a_ctrl is None else a_ctrl, count=False)  # (B, m, n) data
    P_l = take(Pinv, lane_ctrl, count=False)       # (B, n, n) slot dtype
    ar = torch.arange(B, device=dev)
    slot_id = torch.arange(ns, device=dev)
    eye = torch.eye(ns, dtype=hi, device=dev).expand(B, ns, ns)
    row_nrm = torch.linalg.vector_norm(A_l, dim=2)
    has_lo, has_up = l > -_BIG, u < _BIG

    def mv(M, v):                                  # (B, i, j) @ (B, j)
        return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)

    def mtv(M, v):                                 # (B, i, j)ᵀ @ (B, i)
        return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)

    def outer(a, b):
        return a.unsqueeze(-1) * b.unsqueeze(-2)

    def first_free(vm):                            # jnp.argmin(vmask)
        return torch.argmin(vm.to(torch.int8), dim=1)

    def row_of(M, k):                              # M[b, k[b], :]
        return M[ar, k]

    def commit(live, new, old):
        return {k: torch.where(live.view((B,) + (1,) * (old[k].dim() - 1)),
                               new[k], old[k]) for k in old}

    x_un = -mv(P_l, q.to(hi))
    Aact = torch.where(vmask.unsqueeze(-1), A_l[ar[:, None], idx.long()],
                       torch.zeros((), dtype=dt, device=dev))
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    st = dict(x=x_un, idx=idx.clone(), side=side.clone(),
              lam=torch.zeros(B, ns, dtype=hi, device=dev),
              vmask=vmask.clone(), Ginv=Ginv.clone(), Aact=Aact,
              wpos=torch.zeros_like(it), it=it,
              done=~(torch.full((B,), bool(warm), device=dev) | (wcnt > 0)))

    # ---------------- warm loop: insert + KKT jump + wrong-sign drop ------
    live = ~st["done"] & (st["it"] < max_it)
    while bool(live.any()):
        vm_, Gi, Aa = st["vmask"], st["Ginv"], st["Aact"]
        s = torch.where(vm_, st["side"], 0).to(hi)
        free = ~vm_.all(1)
        inserting = st["wpos"] < wcnt
        wsel = torch.clamp(st["wpos"], max=ns - 1).long()
        cand = widx[ar, wsel]
        cside = wside[ar, wsel]
        cspf = cside.to(hi)
        arow = A_l[ar, cand.long()].to(hi)
        col = mv(P_l, arow)
        g = torch.where(vm_, mv(Aa.to(hi), col) * s * cspf[:, None], 0.0)
        gamma = torch.sum(arow * col, 1)
        r = torch.where(vm_, mv(Gi, g), 0.0)
        sc = gamma - torch.sum(g * r, 1)
        ins_ok = inserting & (sc > tol * torch.clamp(gamma, min=1.0)) & free
        app = first_free(vm_)
        ii = slot_id == app[:, None]
        e = ii.to(hi)
        w = r - e
        Gv_add = (Gi + outer(w, w) / torch.clamp(sc, min=_TINY)[:, None, None]
                  - outer(e, e))
        Aact_add = torch.where(ii.unsqueeze(-1), A_l[ar, cand.long()].unsqueeze(1), Aa)
        # KKT jump of the current set and the wrong-sign drop
        bnd = torch.where(st["side"] > 0, torch.gather(u, 1, st["idx"].long()),
                          torch.gather(l, 1, st["idx"].long())).to(hi)
        dvec = s * (mv(Aa.to(hi), x_un) - bnd)
        lamw = mv(Gi, torch.where(vm_, dvec, 0.0))
        lam_chk = torch.where(vm_, lamw, inf)
        k_w = torch.argmin(lam_chk, 1)
        negw = lam_chk.amin(1) < -tol
        kkt = ~inserting
        adopt = kkt & ~negw
        wdrop = kkt & negw
        e_w = slot_id == k_w[:, None]
        e_k = e_w.to(hi)
        ck = row_of(Gi, k_w)
        piv = torch.clamp(torch.sum(ck * e_k, 1), min=_TINY)
        Gv_drop = Gi - outer(ck, ck) / piv[:, None, None] + outer(e_k, e_k)

        def pick(add_v, drop_v, keep_v):
            b3 = (B,) + (1,) * (keep_v.dim() - 1)
            return torch.where(ins_ok.view(b3), add_v,
                               torch.where(wdrop.view(b3), drop_v, keep_v))

        x_adopt = x_un - mv(P_l, mtv(Aa.to(hi), s * lamw))
        new = dict(
            x=torch.where(adopt[:, None], x_adopt, st["x"]),
            idx=torch.where(ins_ok[:, None] & ii, cand[:, None], st["idx"]),
            side=torch.where(ins_ok[:, None] & ii, cside[:, None], st["side"]),
            lam=torch.where(adopt[:, None],
                            torch.where(vm_, torch.clamp(lamw, min=0.0), 0.0),
                            st["lam"]),
            vmask=pick(vm_ | ii, vm_ & ~e_w, vm_),
            Ginv=pick(Gv_add, Gv_drop, Gi),
            Aact=torch.where(ins_ok[:, None, None], Aact_add, Aa),
            wpos=st["wpos"] + inserting.to(torch.int32),
            it=st["it"] + 1,
            done=st["done"] | adopt)
        st = commit(live, new, st)
        live = ~st["done"] & (st["it"] < max_it)

    # ---------------- main loop: scan + fused select and pivot ------------
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    zh = torch.zeros(B, dtype=hi, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    st = dict(x=st["x"], idx=st["idx"], side=st["side"], lam=st["lam"],
              vmask=st["vmask"], Ginv=st["Ginv"], Aact=st["Aact"],
              p=zi - 1, sp=zi, slack=zh, lam_p=zh, zrun=zi, d1=zi - 1,
              d2=zi - 1, vstall=zi, restarted=false, it=st["it"], done=false,
              feas=~false)
    live = ~st["done"] & (st["it"] < max_it)
    while bool(live.any()):
        vm_, Gi, Aa, lam = st["vmask"], st["Ginv"], st["Aact"], st["lam"]
        x = st["x"]
        s = torch.where(vm_, st["side"], 0).to(hi)
        free = ~vm_.all(1)
        # --- violation scan in the data dtype (kmv's work) ---
        _, vl, vu, score = violation_scan_reference(A_l, x.to(dt), l, u, row_nrm)
        j = torch.argmax(score, 1)
        opt = score[ar, j] <= tol
        vj = torch.maximum(vl[ar, j], vu[ar, j])
        j_side = torch.where(vu[ar, j] >= vl[ar, j], 1, -1).to(torch.int32)
        cont = st["p"] >= 0
        fresh = ~cont & ~opt
        stepping = cont | fresh
        p_eff = torch.where(cont, st["p"], j.to(torch.int32))
        sp = torch.where(cont, st["sp"], j_side)
        spf = sp.to(hi)
        slack = torch.where(cont, st["slack"], torch.clamp(vj, min=0.0).to(hi))
        lam_p = torch.where(cont, st["lam_p"], 0.0)
        # --- Gram work for the pivot row (slot dtype) ---
        arow_d = A_l[ar, p_eff.long()]
        arow = arow_d.to(hi)
        col = mv(P_l, arow)
        g = torch.where(vm_, mv(Aa.to(hi), col) * s * spf[:, None], 0.0)
        gamma = torch.sum(arow * col, 1)
        r = torch.where(vm_, mv(Gi, g), 0.0)
        sc = gamma - torch.sum(g * r, 1)
        # --- step lengths ---
        t2 = torch.where(sc > tol, slack / torch.clamp(sc, min=_TINY), inf)
        ratio = torch.where(vm_ & (r > tol), lam / torch.clamp(r, min=tol), inf)
        k_b = torch.argmin(ratio, 1)
        t1 = ratio.amin(1)
        t = torch.minimum(t1, t2)
        infeas_raw = stepping & ~torch.isfinite(t)
        t = torch.where(torch.isfinite(t), t, 0.0)
        z = mv(P_l, mtv(Aa.to(hi), r * s)) - spf[:, None] * col
        x_step = x + t[:, None] * z
        lam_step = torch.where(vm_, torch.clamp(lam - t[:, None] * r, min=0.0), lam)
        lam_p_new = lam_p + t
        slack_new = torch.clamp(slack - t * sc, min=0.0)
        fin2 = torch.isfinite(t2)
        full = (t2 <= t1) & fin2 & free
        do_add = stepping & full & ~infeas_raw
        do_drop = stepping & ~full & (t1 <= t2) & ~infeas_raw & torch.isfinite(t1)
        overflow_raw = stepping & ~free & fin2 & (t2 <= t1) & ~infeas_raw
        # --- f32 anti-cycling detectors and the one-shot restart ---
        zero_run = torch.where(stepping & (t <= _TINY), st["zrun"] + 1, 0)
        j32 = j.to(torch.int32)
        rehit = fresh & ((j32 == st["d1"]) | (j32 == st["d2"]))
        vstall = torch.where(rehit, st["vstall"] + 1,
                             torch.where(fresh, 0, st["vstall"]))
        restart = ~st["restarted"] & ((zero_run > ns + 2) | (vstall >= 4)
                                      | infeas_raw | overflow_raw)
        infeasible = infeas_raw & st["restarted"]
        overflow = overflow_raw & st["restarted"]
        app = first_free(vm_)
        e_b = slot_id == k_b[:, None]
        ii = slot_id == app[:, None]
        e_app = ii.to(hi)
        e_bh = e_b.to(hi)
        # --- unified rank-one update: Ginv + c1·aaᵀ + c2·bbᵀ ---
        ck = row_of(Gi, k_b)
        piv = torch.clamp(torch.sum(ck * e_bh, 1), min=_TINY)
        a_vec = torch.where(do_add[:, None], r - e_app, ck)
        c1 = torch.where(do_add, 1.0 / torch.clamp(sc, min=_TINY),
                         torch.where(do_drop, -1.0 / piv, 0.0))
        b_vec = torch.where(do_add[:, None], e_app, e_bh)
        c2 = torch.where(do_add, -1.0, torch.where(do_drop, 1.0, 0.0)).to(hi)
        Ginv_n = (Gi + c1[:, None, None] * outer(a_vec, a_vec)
                  + c2[:, None, None] * outer(b_vec, b_vec))
        Aact_n = torch.where((do_add[:, None] & ii).unsqueeze(-1),
                             arow_d.unsqueeze(1), Aa)
        keep_lam = torch.where((stepping & ~overflow_raw)[:, None], lam_step, lam)
        # the keep path must NOT apply the step's dual update
        lam_n = torch.where(do_add[:, None], torch.where(ii, lam_p_new[:, None], lam_step),
                            torch.where(do_drop[:, None], lam_step * (1.0 - e_bh),
                                        keep_lam))
        vmask_n = torch.where(do_add[:, None], vm_ | ii,
                              torch.where(do_drop[:, None], vm_ & ~e_b, vm_))
        upd_x = stepping & ~infeas_raw & ~overflow_raw
        idx_kb = st["idx"][ar, k_b]
        R, R2 = restart, restart[:, None]
        new = dict(
            x=torch.where(R2, x_un, torch.where(upd_x[:, None], x_step, x)),
            idx=torch.where(R2, 0, torch.where(do_add[:, None] & ii,
                                               p_eff[:, None], st["idx"])),
            side=torch.where(R2, 0, torch.where(do_add[:, None] & ii,
                                                sp[:, None], st["side"])),
            lam=torch.where(R2, 0.0, lam_n),
            vmask=vmask_n & ~R2,
            Ginv=torch.where(R[:, None, None], eye, Ginv_n),
            Aact=torch.where(R[:, None, None], torch.zeros((), dtype=dt, device=dev),
                             Aact_n),
            p=torch.where(do_drop & ~R, p_eff, -1),
            sp=torch.where(do_drop & ~R, sp, 0),
            slack=torch.where(do_drop & ~R, slack_new, 0.0),
            lam_p=torch.where(do_drop & ~R, lam_p_new, 0.0),
            zrun=torch.where(R, 0, zero_run),
            d1=torch.where(R, -1, torch.where(do_drop, idx_kb, st["d1"])),
            d2=torch.where(R, -1, torch.where(do_drop, st["d1"], st["d2"])),
            vstall=torch.where(R, 0, vstall),
            restarted=st["restarted"] | restart,
            it=st["it"] + 1,
            done=st["done"] | infeasible | overflow | (~cont & opt),
            feas=st["feas"] & ~infeasible & ~overflow)
        new = {k: v.to(st[k].dtype) for k, v in new.items()}
        st = commit(live, new, st)
        live = ~st["done"] & (st["it"] < max_it)

    idx.copy_(st["idx"])
    side.copy_(st["side"])
    vmask.copy_(st["vmask"])
    Ginv.copy_(st["Ginv"])
    return st["x"], st["lam"], st["it"], st["done"] & st["feas"]


def gi_solve(Pinv, A, lane_ctrl, q, l, u, idx, side, vmask, Ginv, widx,
             wside, wcnt, warm, max_it, tol, a_ctrl=None, *, _layout=None):
    """The per-lane GI solve (see the module docstring).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    ``_layout`` ("resident", "split", ("split", rows) or "global") forces
    the kernel's layout, for the checks that hold one against the other;
    None picks it by size.
    """
    _, rows = check_layout("gi_solve", _layout)
    dev = q.device
    if dev.type == "cpu":
        return gi_solve_reference(Pinv, A, lane_ctrl, q, l, u, idx, side,
                                  vmask, Ginv, widx, wside, wcnt, warm,
                                  max_it, tol, a_ctrl)
    if dev.type != "cuda":
        raise ValueError(f"gi_solve runs on cpu or cuda, got {dev}")
    B, n, m, ns = _check_args(Pinv, A, lane_ctrl, q, l, u, idx, side, vmask,
                              Ginv, widx, wside, wcnt, max_it, a_ctrl)
    ts = (Pinv, A, lane_ctrl, q, l, u, idx, side, vmask, Ginv, widx, wside,
          wcnt, max_it) + (() if a_ctrl is None else (a_ctrl,))
    for t in ts:
        if t.device != dev:
            raise ValueError(f"gi_solve arguments must all lie on {dev}")
        if not t.is_contiguous():
            raise ValueError("gi_solve arguments must be contiguous")
    dt, hi = A.dtype, Ginv.dtype
    props = torch.cuda.get_device_properties(dev)
    x = torch.empty(B, n, dtype=hi, device=dev)
    lam = torch.empty(B, ns, dtype=hi, device=dev)
    it = torch.empty(B, dtype=torch.int32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return x, lam, it, conv
    from ._build import load_library
    lib = load_library()
    fn = {(torch.float32, torch.float64): lib.mpc_gi_solve_f32_f64,
          (torch.float32, torch.float32): lib.mpc_gi_solve_f32_f32,
          (torch.float64, torch.float64): lib.mpc_gi_solve_f64_f64}[(dt, hi)]
    sizes = (A.element_size(), Ginv.element_size())
    table, block_ctrl, warps, smem, layout = launch_geometry(
        lane_ctrl, n, m, ns, *sizes, launch_budget(props),
        props.multi_processor_count, _layout, a_ctrl)
    # the per-lane geometry (block_ctrl None) reads A and P⁻¹ through the
    # lanes' maps; with an A map the blocks are A's, P⁻¹ comes a lane
    own = block_ctrl is None
    pmap = lane_ctrl if own or a_ctrl is not None else None
    amap = (lane_ctrl if a_ctrl is None else a_ctrl) if own else None
    maps = [None if t is None else t.data_ptr() for t in (block_ctrl, pmap, amap)]
    ptrs = (q, l, u, idx, side, vmask, Ginv, widx, wside, wcnt, max_it, x, lam, it, conv)
    # the global layout's workspace: a block of the caching allocator, which
    # hands the same block back to the next launch of this shape on this
    # stream
    ws = None
    if layout == "global":
        ws = torch.empty(workspace_bytes(n, m, ns, *sizes, B, table.shape[0]),
                         dtype=torch.uint8, device=dev)
    # the split layout: A's leading rows in shared memory, the column-major
    # copy of the others (n_d, n, m − rows), one copy a launch
    n_res, At = 0, None
    if layout == "split":
        n_res = split_plan(n, m, ns, *sizes, warps, launch_budget(props), rows,
                           a_ctrl is not None)[0]
        if n_res < m:
            At = A[:, n_res:, :].transpose(1, 2).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(Pinv.data_ptr(), A.data_ptr(), None if At is None else At.data_ptr(), n_res,
                table.data_ptr(), *maps, int(own), *(t.data_ptr() for t in ptrs),
                None if ws is None else ws.data_ptr(),
                table.shape[0], table.shape[1], warps, n, m, ns, int(bool(warm)), smem,
                LAYOUT_CODE[layout], float(tol), stream)
    if rc != 0:
        raise RuntimeError(f"gi_solve kernel launch failed: CUDA error {rc}")
    LAUNCHES["gi_solve"] += 1
    return x, lam, it, conv
