"""The lane grouping of the CUDA kernels (``utils/lanes.py::lane_blocks``).

Both kernels run the lanes of one controller per thread block; the table
that groups them is built on the host from ``lane_ctrl``.  Every lane
layout the port produces is checked: the tiled fleet (lane = r·n_d + c),
``share_params`` (n_d = 1), uncached solves (n_d = B), a single controller
(B = 1) and ragged groups whose sizes are not a multiple of the width.
"""
import numpy as np
import pytest
import torch

from mpc_tpu_torch.parallel.grouped import lane_ctrl as tiled
from mpc_tpu_torch.utils.lanes import lane_blocks

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
