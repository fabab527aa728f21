"""The one generator of setpoint and disturbance traffic.

A traffic file holds a table of ``phases`` (each a setpoint ``ry`` and,
where the plant has measured disturbances, a ``d``), the periods a lane
holds a phase (``hold_periods``), how the lanes' phases are staggered
(lane ``b`` starts ``(b * stagger) mod (hold_periods * len(phases))``
periods into the cycle) and the standard deviation of the measurement
noise on each output (``y_noise_sd``, fresh every period).  The schedule
is a function of the period and the lane alone, so every seed sees the
same sequence of setpoint steps; the seed draws the plants and the noise.
"""
from __future__ import annotations

import torch


class Traffic:
    def __init__(self, spec, B, device, dtype):
        self.hold = int(spec["hold_periods"])
        phases = spec["phases"]
        self.cycle = self.hold * len(phases)
        lane = torch.arange(B, dtype=torch.int64, device=device)
        self.offset = (lane * int(spec.get("stagger", 1))) % self.cycle
        self.ry = torch.tensor([p["ry"] for p in phases], dtype=dtype, device=device)
        nd = len(phases[0].get("d", []))
        self.d = torch.tensor([p.get("d", []) for p in phases], dtype=dtype,
                              device=device).reshape(len(phases), nd)
        self.noise_sd = torch.tensor(spec["y_noise_sd"], dtype=torch.float64, device=device)

    def phase(self, k):
        """(B,) phase index of every lane at period ``k``."""
        return ((self.offset + int(k)) // self.hold) % (self.cycle // self.hold)

    def setpoints(self, k):
        """``(ry, d)`` of every lane at period ``k``: (B, ny), (B, nd)."""
        j = self.phase(k)
        return self.ry.index_select(0, j), self.d.index_select(0, j)
