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
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .trace import synced

# lane_blocks results per lane_ctrl tensor, dropped with the tensor: a fleet
# or a controller keeps one lane_ctrl for its life, so the grouping (which
# needs one host sync) is built once, not once per period
_BLOCKS = WeakIdKeyDictionary()
# identity_lanes results per (B, device) and lane_rows results per (B, W,
# device); the tensors are never written
_IDENTITY = {}
_ROWS = {}


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


def take(M, lane_ctrl):
    """``M[lane_ctrl]``: the per-lane copy of per-controller data; ``M``
    itself for no map or an identity map over its rows."""
    if lane_ctrl is None or (is_identity(lane_ctrl) and M.shape[0] == lane_ctrl.shape[0]):
        return M
    return M.index_select(0, lane_ctrl)


def mv(M, v, lane_ctrl=None):
    """Batched matrix-vector product: ``M`` (·, i, j), ``v`` (B, j) → (B, i)."""
    return torch.matmul(take(M, lane_ctrl), v.unsqueeze(-1)).squeeze(-1)


def mtv(M, v, lane_ctrl=None):
    """Batched ``Mᵀv``: ``M`` (·, i, j), ``v`` (B, i) → (B, j)."""
    return torch.matmul(v.unsqueeze(-2), take(M, lane_ctrl)).squeeze(-2)


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
