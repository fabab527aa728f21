"""Grouped (distinct × reps) fleet layout — the shared lane mapping.

A fleet of ``n_d`` distinct configurations tiled ``reps`` times keeps its
parameters stacked over the ``n_d`` DISTINCT configurations only; every
lane reads its configuration's matrices through ``lane_ctrl``, so each
distinct matrix is read once per replica group (the CUDA kernel reads it
through L2) instead of being copied per lane.

The PUBLIC lane order is the tiled one: ``lane = r·n_d + c`` for replica
``r`` of configuration ``c`` (``mpc_tpu/parallel/grouped.py``), so
``lane_ctrl[lane] = lane mod n_d``.  ``share_params`` is the case n_d = 1.
"""
from __future__ import annotations

import torch

from ..utils.lanes import register_tiled


def lane_ctrl(n_distinct: int, reps: int, device=None) -> torch.Tensor:
    """(n_distinct·reps,) int32: the configuration of every public lane,
    registered as a tiled map (``utils/lanes.py::tiling``), so that the QP
    build takes each product one GEMM a configuration over its lanes."""
    lanes = torch.arange(n_distinct * reps, dtype=torch.int32, device=device)
    return register_tiled(lanes % n_distinct, n_distinct, reps)
