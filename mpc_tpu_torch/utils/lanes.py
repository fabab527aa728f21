"""Per-lane access to per-controller data.

A fleet stacks every parameter over its ``n_d`` DISTINCT controllers only;
lane ``b`` reads controller ``lane_ctrl[b]`` (``parallel/grouped.py`` builds
``lane_ctrl`` from the public lane order ``lane = r·n_d + c``).  With
``lane_ctrl=None`` the data is already per lane.

The CUDA kernels run lanes of ONE controller per thread block, so that the
block loads that controller's matrices once for all of them; ``lane_blocks``
builds that grouping from ``lane_ctrl``.  A fleet whose every lane is its
own controller (n_d = B) takes ``identity_lanes(B, device)``: one cached
``arange`` a batch size and device, which ``take`` does not gather through
and ``lane_blocks`` groups with no host sync.

A tiled map (``parallel/grouped.py::lane_ctrl``, registered by
``register_tiled``) lets a product of per-controller matrices with per-lane
vectors skip the per-lane copies: ``lane_products`` returns ``CtrlMajor``
for it, which holds a lane vector (B, j) as (n_d, R, j), a controller's
lanes together, and takes each product as ONE batched GEMM over the
controllers, each matrix read once for all its lanes.  Any other map gets
``LaneOrder``: ``take`` and a batched gemv, as ``mv``/``mtv``.

Counters (``trace.COUNTS``, host integers): ``lane_copy_bytes``, the bytes
of per-lane copies of per-controller matrices (``take`` of a tensor of ≥ 3
dims through a map, from shapes); ``grouped_products``, the products taken
by ``CtrlMajor``.  The kernels' plain versions pass ``count=False``: the
count is what a step makes on the card.
"""
from __future__ import annotations

import math

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .trace import COUNTS, synced

# lane_blocks results per lane_ctrl tensor, dropped with the tensor: a fleet
# or a controller keeps one lane_ctrl for its life, so the grouping (which
# needs one host sync) is built once, not once per period
_BLOCKS = WeakIdKeyDictionary()
# identity_lanes results per (B, device) and lane_rows results per (B, W,
# device); the tensors are never written
_IDENTITY = {}
_ROWS = {}
# register_tiled maps: (n_d, R, the tensor's version counter at registration)
_TILED = WeakIdKeyDictionary()


def identity_lanes(B: int, device) -> torch.Tensor:
    """The identity lane map ``arange(B)`` (int32) on ``device``, made once
    a (B, device) and kept: callers with n_d = B pass it as ``lane_ctrl``."""
    key = (int(B), torch.device(device))
    if key not in _IDENTITY:
        t = torch.arange(int(B), dtype=torch.int32, device=key[1])
        # kept under the tensor's own device too ("cuda" is "cuda:0" there)
        _IDENTITY[key] = _IDENTITY.setdefault((int(B), t.device), t)
    return _IDENTITY[key]


def is_identity(lane_ctrl) -> bool:
    """Whether ``lane_ctrl`` is an ``identity_lanes`` map (by object, so no
    device read)."""
    return (lane_ctrl is not None and lane_ctrl.dim() == 1 and
            _IDENTITY.get((lane_ctrl.shape[0], lane_ctrl.device)) is lane_ctrl)


def register_tiled(lane_ctrl, n_d: int, reps: int) -> torch.Tensor:
    """Record ``lane_ctrl`` as the tiled map of ``n_d`` controllers ×
    ``reps`` (``lane = r·n_d + c`` reads controller c); returns it."""
    _TILED[lane_ctrl] = (int(n_d), int(reps), lane_ctrl._version)
    return lane_ctrl


def tiling(lane_ctrl):
    """``(n_d, R)`` for a ``register_tiled`` map not written since, by
    object and version counter (no device read); None for any other map."""
    if lane_ctrl is None:
        return None
    reg = _TILED.get(lane_ctrl)
    if reg is None or reg[2] != lane_ctrl._version:
        return None
    return reg[:2]


def take(M, lane_ctrl, count=True):
    """``M[lane_ctrl]``: the per-lane copy of per-controller data; ``M``
    itself for no map or an identity map over its rows.  A copy of a
    matrix (≥ 3 dims) adds its bytes to ``lane_copy_bytes`` unless
    ``count`` is False."""
    if lane_ctrl is None or (is_identity(lane_ctrl) and M.shape[0] == lane_ctrl.shape[0]):
        return M
    if count and M.dim() >= 3:
        COUNTS["lane_copy_bytes"] += (lane_ctrl.shape[0] * math.prod(M.shape[1:])
                                      * M.element_size())
    return M.index_select(0, lane_ctrl)


def mv(M, v, lane_ctrl=None):
    """Batched matrix-vector product: ``M`` (·, i, j), ``v`` (B, j) → (B, i)."""
    return torch.matmul(take(M, lane_ctrl), v.unsqueeze(-1)).squeeze(-1)


def mtv(M, v, lane_ctrl=None):
    """Batched ``Mᵀv``: ``M`` (·, i, j), ``v`` (B, i) → (B, j)."""
    return torch.matmul(v.unsqueeze(-2), take(M, lane_ctrl)).squeeze(-2)


class LaneOrder:
    """Products of the per-controller data ``p`` with lane vectors (B, ·)
    in lane order: ``take`` and a batched gemv a product.  ``into``/``out``
    move a lane tensor into and out of the layout (here: as it is)."""

    def __init__(self, p, lane_ctrl, B):
        self.p, self.lane_ctrl, self.lead = p, lane_ctrl, (B,)

    def into(self, v):
        return v

    def out(self, x):
        return x

    def L(self, k):
        """Per-controller vector ``k``, broadcastable over the lanes."""
        return take(self.p[k], self.lane_ctrl)

    def M(self, k, v):
        """``p[k] @ v`` a lane."""
        return mv(self.p[k], v, self.lane_ctrl)

    def Mt(self, k, v):
        """``p[k]ᵀ @ v`` a lane."""
        return mtv(self.p[k], v, self.lane_ctrl)

    def cat(self, parts):
        """Concatenate on the last axis, each part broadcast over the lanes."""
        return torch.cat([t.expand(self.lead + t.shape[-1:]) for t in parts], -1)


class CtrlMajor(LaneOrder):
    """The same products over a tiled map of ``n_d`` controllers × ``R``:
    a lane vector (B, j) is held as (n_d, R, j), controller c's lanes
    ``r·n_d + c`` in row r of its slab, so ``p[k] @ v`` over every lane is
    one GEMM a controller, (R, j) @ (j, i), batched over the controllers;
    a per-controller vector is the broadcast (n_d, 1, ·).  No per-lane copy
    of any matrix is made; each output element is its own sum, as in lane
    order."""

    def __init__(self, p, n_d, R):
        self.p, self.n_d, self.R, self.lead = p, n_d, R, (n_d, R)

    def into(self, v):
        return v.reshape(self.R, self.n_d, v.shape[-1]).transpose(0, 1).contiguous()

    def out(self, x):
        return x.transpose(0, 1).reshape((self.n_d * self.R,) + x.shape[2:])

    def L(self, k):
        return self.p[k].unsqueeze(1)

    def M(self, k, v):
        COUNTS["grouped_products"] += 1
        return torch.matmul(v, self.p[k].mT)

    def Mt(self, k, v):
        COUNTS["grouped_products"] += 1
        return torch.matmul(v, self.p[k])


def lane_products(p, lane_ctrl, B):
    """``CtrlMajor`` for a tiled map (of B lanes), else ``LaneOrder``."""
    tiled = tiling(lane_ctrl)
    return LaneOrder(p, lane_ctrl, B) if tiled is None else CtrlMajor(p, *tiled)


def lane_blocks(lane_ctrl: torch.Tensor, max_width: int):
    """Group the lanes by controller into blocks of at most ``max_width``.

    Returns ``(table, block_ctrl)``: ``table`` (n_blocks, W) int32 holds the
    lane indices of each block in increasing order, padded with −1 at the
    end; ``block_ctrl`` (n_blocks,) int32 is the controller every lane of
    the block reads.  W = min(max_width, the largest group), so a fleet with
    one lane per controller (uncached solves, n_d = B) gets blocks of one
    lane.  Blocks follow the controllers in increasing order, a
    controller's lanes fill ⌈count / W⌉ blocks, and every lane appears
    exactly once.  Both tensors lie on ``lane_ctrl``'s device.  The result
    is cached per ``lane_ctrl`` tensor (and its version counter); an
    ``identity_lanes`` map is grouped on its device, with no host sync.
    """
    key = (int(max_width), lane_ctrl._version)
    memo = _BLOCKS.setdefault(lane_ctrl, {})
    if key in memo:
        return memo[key]
    if max_width < 1:
        raise ValueError(f"max_width must be ≥ 1, got {max_width}")
    if is_identity(lane_ctrl):
        memo[key] = (lane_ctrl.view(-1, 1), lane_ctrl)
        return memo[key]
    dev = lane_ctrl.device
    lc = synced(lane_ctrl.detach().to("cpu", torch.int64))
    B = lc.numel()
    if B == 0:
        out = (torch.empty(0, 1, dtype=torch.int32, device=dev),
               torch.empty(0, dtype=torch.int32, device=dev))
        memo[key] = out
        return out
    order = torch.sort(lc, stable=True).indices      # lanes, by controller
    ctrl, counts = torch.unique_consecutive(lc[order], return_counts=True)
    W = int(min(int(max_width), int(counts.max())))
    per = (counts + W - 1) // W                      # blocks per controller
    first_block = torch.cumsum(per, 0) - per
    first_lane = torch.cumsum(counts, 0) - counts
    grp = torch.repeat_interleave(torch.arange(ctrl.numel()), counts)
    rank = torch.arange(B) - first_lane[grp]         # rank within the group
    blk = first_block[grp] + rank // W
    table = torch.full((int(per.sum()), W), -1, dtype=torch.int32)
    table[blk, rank % W] = order.to(torch.int32)
    block_ctrl = torch.repeat_interleave(ctrl, per).to(torch.int32)
    out = (table.to(dev), block_ctrl.to(dev))
    memo[key] = out
    return out


def singleton_groups(lane_ctrl: torch.Tensor) -> bool:
    """Whether every lane of ``lane_ctrl`` is the only lane of its
    controller (n_d = B): the kernels' per-lane geometry.  From the cached
    grouping (no host sync for an identity map)."""
    return lane_blocks(lane_ctrl, 2)[0].shape[1] == 1


def lane_rows(B: int, width: int, device) -> torch.Tensor:
    """The per-lane geometry's table: lanes 0..B−1 in order, ``width`` a
    block, (⌈B/width⌉, width) int32 padded with −1 at the end; made on
    ``device`` with no host sync, once a (B, width, device)."""
    key = (int(B), int(width), torch.device(device))
    if key not in _ROWS:
        n = -(-int(B) // int(width)) * int(width)
        r = torch.arange(n, dtype=torch.int32, device=key[2])
        _ROWS[key] = torch.where(r < int(B), r, -1).view(-1, int(width))
    return _ROWS[key]
