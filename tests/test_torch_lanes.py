"""The lane grouping of the CUDA kernels (``utils/lanes.py::lane_blocks``),
and the QP build's products over a tiled map (``lane_products``).

Both kernels run the lanes of one controller per thread block; the table
that groups them is built on the host from ``lane_ctrl``.  Every lane
layout the port produces is checked: the tiled fleet (lane = r·n_d + c),
``share_params`` (n_d = 1), uncached solves (n_d = B), a single controller
(B = 1) and ragged groups whose sizes are not a multiple of the width.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpc_tpu_torch.parallel.grouped import lane_ctrl as tiled
from mpc_tpu_torch.utils import trace
from mpc_tpu_torch.utils.lanes import (CtrlMajor, LaneOrder, identity_lanes, lane_blocks,
                                       lane_products, mtv, mv, take, tiling)

torch.set_num_threads(1)


def check_table(lc, max_width):
    table, ctrl = lane_blocks(lc, max_width)
    B = lc.numel()
    counts = np.bincount(lc.numpy(), minlength=1)
    W = min(max_width, int(counts.max()))
    assert table.dtype == ctrl.dtype == torch.int32
    assert table.shape == (int(sum(-(-c // W) for c in counts)), W)
    assert ctrl.shape == (table.shape[0],)
    t = table.numpy()
    lanes = t[t >= 0]
    # each lane exactly once
    assert sorted(lanes.tolist()) == list(range(B))
    for row, c in zip(t, ctrl.numpy()):
        real = row[row >= 0]
        # −1 only pads the end of a row, never a whole row
        assert real.size > 0 and (row[real.size:] == -1).all()
        # every lane of a block reads the block's controller, in lane order
        assert (lc.numpy()[real] == c).all()
        assert (np.diff(real) > 0).all()
    # blocks follow the controllers in increasing order
    assert (np.diff(ctrl.numpy()) >= 0).all()
    return table, ctrl


@pytest.mark.parametrize("n_d,reps,max_width", [
    (4, 5, 16),      # tiled fleet, a group fits one block
    (4, 5, 2),       # tiled fleet, groups split into ragged blocks (5 = 2+2+1)
    (1, 37, 16),     # share_params: one controller, 37 lanes
    (256, 16, 16),   # the headline fleet
    (32, 128, 32),   # the large-GI fleet
    (9, 1, 16),      # one lane per controller (uncached solves, n_d = B)
    (1, 1, 16),      # a single controller (B = 1)
])
def test_every_layout(n_d, reps, max_width):
    lc = tiled(n_d, reps)
    table, ctrl = check_table(lc, max_width)
    W = min(max_width, reps)
    assert table.shape[1] == W
    assert table.shape[0] == n_d * -(-reps // W)
    # the tiled order: block k of controller c holds lanes r·n_d + c
    first = table[0][table[0] >= 0].tolist()
    assert first == [r * n_d for r in range(min(W, reps))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_random_groups(seed):
    """Controllers with 1 to 20 lanes each in a shuffled lane order, and
    controllers that no lane reads."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 21, size=7)
    lc = np.repeat(np.array([0, 2, 3, 5, 8, 9, 11]), sizes)
    rng.shuffle(lc)
    table, ctrl = check_table(torch.tensor(lc, dtype=torch.int32), 8)
    assert set(ctrl.tolist()) == {0, 2, 3, 5, 8, 9, 11}


def test_cached_per_tensor_width_and_version():
    lc = tiled(3, 4)
    a = lane_blocks(lc, 4)
    assert lane_blocks(lc, 4) is a                 # built once per tensor
    assert lane_blocks(lc, 2)[0].shape == (6, 2)   # another width: its own
    assert lane_blocks(tiled(3, 4), 4) is not a    # another tensor
    lc[:] = 0                                      # changed in place
    table, ctrl = lane_blocks(lc, 4)
    assert table.shape == (3, 4) and ctrl.tolist() == [0, 0, 0]


def test_empty_and_bad_width():
    table, ctrl = lane_blocks(torch.zeros(0, dtype=torch.int32), 4)
    assert table.shape[0] == 0 and ctrl.shape == (0,)
    with pytest.raises(ValueError, match="max_width"):
        lane_blocks(tiled(2, 2), 0)


# ------------------------------------------- the QP build's grouped products
def _operands(n_d, R, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(n_d, 7, 4, generator=g, dtype=torch.float64).to(dtype)
    v = torch.randn(n_d * R, 4, generator=g, dtype=torch.float64).to(dtype)
    w = torch.randn(n_d * R, 7, generator=g, dtype=torch.float64).to(dtype)
    return {"M": M}, v, w


@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n_d,R", [(1, 1), (1, 7), (3, 1), (4, 5), (256, 4)])
def test_grouped_products_equal_the_lane_order_ones(n_d, R, dtype, rtol):
    p, v, w = _operands(n_d, R, dtype)
    lc = tiled(n_d, R)
    g = lane_products(p, lc, n_d * R)
    assert isinstance(g, CtrlMajor) and (g.n_d, g.R) == (n_d, R)
    plain = lc.clone()                     # the same map, unregistered
    assert type(lane_products(p, plain, n_d * R)) is LaneOrder
    Mv = g.out(g.M("M", g.into(v)))
    Mtw = g.out(g.Mt("M", g.into(w)))
    assert Mv.shape == (n_d * R, 7) and Mtw.shape == (n_d * R, 4)
    scale = lambda x: rtol * float(x.abs().max())
    torch.testing.assert_close(Mv, mv(p["M"], v, plain), rtol=rtol, atol=scale(Mv))
    torch.testing.assert_close(Mtw, mtv(p["M"], w, plain), rtol=rtol, atol=scale(Mtw))
    # a per-controller vector is a broadcast; a reduction comes back per lane
    vec = torch.randn(n_d, 4, dtype=dtype)
    g.p["vec"] = vec
    assert torch.equal(g.out(g.L("vec") + g.into(v)), take(vec, plain) + v)
    assert torch.equal(g.out(g.into(v).sum(-1)), v.sum(-1))


class _Ops(TorchDispatchMode):
    """Records every ATen operation dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_a_registered_map_is_recognised_with_no_device_operation():
    lc = tiled(3, 4)
    with _Ops() as seen:
        assert tiling(lc) == (3, 4)
        assert isinstance(lane_products({}, lc, 12), CtrlMajor)
    assert seen.ops == []


def test_maps_the_helper_does_not_know_keep_the_lane_order():
    lc = tiled(4, 3)
    shuffled = lc[torch.randperm(12, generator=torch.Generator().manual_seed(0))]
    # grouped_chunks' parts: their lanes' controllers renumbered by searchsorted
    used = np.array([0, 1])
    chunk = torch.as_tensor(np.searchsorted(used, (np.arange(12) % 4)[np.arange(12) % 4 < 2]),
                            dtype=torch.int32)
    written = tiled(4, 3)
    written[0] = 1                         # changed in place after registration
    for m, B in [(None, 12), (identity_lanes(12, "cpu"), 12), (shuffled, 12), (lc.clone(), 12),
                 (chunk, 6), (written, 12)]:
        assert tiling(m) is None, m
        assert type(lane_products({}, m, B)) is LaneOrder


def test_a_lane_copy_counts_its_bytes_and_a_view_counts_none():
    M = torch.zeros(3, 5, 2, dtype=torch.float32)
    lc = tiled(3, 4)
    n0 = trace.COUNTS["lane_copy_bytes"]
    take(M, lc)
    assert trace.COUNTS["lane_copy_bytes"] - n0 == 12 * 5 * 2 * 4
    take(M, lc, count=False)                            # the kernels' plain versions
    take(M[:, 0], lc)                                   # a vector a controller
    take(torch.zeros(12, 5, 2), identity_lanes(12, "cpu"))   # no copy
    take(M, None)
    assert trace.COUNTS["lane_copy_bytes"] - n0 == 12 * 5 * 2 * 4
