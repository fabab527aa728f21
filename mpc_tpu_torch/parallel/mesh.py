"""Lane sharding over devices — the port's ``NamedSharding(mesh, P("batch"))``.

A ``mesh`` is a non-empty sequence of torch devices (or device strings),
read as a one-axis mesh over the fleet's lane (``batch``) axis.  A device
may repeat: shards on one device run one after another there, which is how
a split into several shards runs on a machine with one card (or on the
CPU).  Shard ``s`` of ``k`` holds the contiguous lanes ``[s·B/k,
(s+1)·B/k)`` in the fleet's public lane order; ``B % k != 0`` is refused,
as ``device_put`` refuses an uneven ``P("batch")``.

Every sharded fleet (``BatchedLinMPC``, ``BatchedNonLinMPC``,
``BatchedMHE``, the compiled loops' ``run_fleet``) keeps one sub-fleet a
shard, holding its lanes' state on its device, and goes through this map:
``split`` sends each shard its slice, ``gather`` concatenates the shards'
outputs on ``mesh[0]`` and ``psum`` sums the shards' convergence counts
there, on the device, with no host sync — the reference's cross-shard
collectives.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from ..utils.config import as_device


def mesh_devices(mesh) -> tuple[torch.device, ...]:
    """The devices of ``mesh`` (a CUDA device without an index is the
    current card); ``TypeError`` for anything that is not a non-empty
    sequence of devices or device strings."""
    if isinstance(mesh, (str, torch.device)) or not isinstance(mesh, Sequence) or not mesh:
        raise TypeError("mesh must be a non-empty sequence of torch devices or device "
                        f"strings, got {mesh!r}")
    out = []
    for d in mesh:
        if not isinstance(d, (str, torch.device)):
            raise TypeError(f"mesh entries must be torch devices or device strings, got {d!r}")
        out.append(as_device(d))
    return tuple(out)


class LaneShards:
    """The contiguous split of ``B`` lanes over the devices of ``mesh``."""

    def __init__(self, mesh, B: int):
        self.devices = mesh_devices(mesh)
        self.k = len(self.devices)
        self.B = int(B)
        if self.B % self.k:
            raise ValueError(f"the fleet's {self.B} lanes do not split evenly over a "
                             f"mesh of {self.k} devices")
        self.size = self.B // self.k
        self.home = self.devices[0]
        self.slices = tuple(slice(s * self.size, (s + 1) * self.size) for s in range(self.k))

    def split(self, x, dim=0):
        """Shard ``s``'s slice of ``x`` along the lane axis ``dim``: a tensor
        lands on the shard's device (a view when it is there already, a
        non-blocking copy otherwise); a host array stays a host view, for
        the shard's own upload."""
        idx = (slice(None),) * dim
        if not torch.is_tensor(x):
            x = np.asarray(x)
            return [x[idx + (sl,)] for sl in self.slices]
        return [x[idx + (sl,)].to(dev, non_blocking=True)
                for sl, dev in zip(self.slices, self.devices)]

    def gather(self, parts, dim=0):
        """The shards' outputs concatenated along ``dim`` on ``mesh[0]``."""
        return torch.cat([p.to(self.home, non_blocking=True) for p in parts], dim)

    def psum(self, parts):
        """The sum of the shards' (scalar or equal-shape) tensors on
        ``mesh[0]``."""
        return torch.stack([p.to(self.home, non_blocking=True) for p in parts]).sum(0)

    def per_device(self, make):
        """``[make(device)]`` for the shards, ``make`` called once per
        distinct device (a repeated device shares its result)."""
        made = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]
