"""Reading ``torch.profiler``'s records of a profiled stretch of periods.

Device activity is every record the profiler keeps on the card (kernels,
copies, sets) except the ``record_function`` ranges, which also appear
there as annotations.  Busy time is the union of their intervals; an idle
gap is a stretch between two of them, named by the harness's range and
the innermost host operation open at the gap's start (as
``profile_gi.py`` computes the busy time).
"""
from __future__ import annotations

import bisect

RANGES = ("period.measure", "period.step", "period.copy_out", "period.record",
          "period.world")


def union_s(intervals):
    """Length in seconds of the union of (start, end) intervals in µs."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e6


def read(prof, torch):
    """Everything the readers use from one profile: the device records
    ``[(name, start_us, end_us)]``, the host ranges and operations
    ``[(name, start_us, end_us, depth)]``, the busy seconds, the top device
    operations and the longest idle gaps."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        tr = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if e.name not in RANGES:
                dev.append(tr)
        elif e.name in RANGES or e.name.startswith(("aten::", "cuda")):
            host.append(tr)
    dev.sort(key=lambda t: t[1])
    busy = union_s([(s, e) for _, s, e in dev])
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(device=dev, busy_s=busy, device_ops=top,
                idle_gaps=_idle_gaps(dev, host))


def _idle_gaps(dev, host, k=10):
    """The ``k`` longest gaps between device activities, each named by the
    harness range and the innermost host operation open at its start."""
    gaps, end = [], None
    for _, s, e in dev:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    host = sorted(host, key=lambda t: t[1])
    starts = [t[1] for t in host]
    out = []
    for length, at in gaps[:k]:
        i = bisect.bisect_right(starts, at)
        rng = op = None
        for name, s, e in reversed(host[:i]):
            if e < at:
                continue
            if name in RANGES:
                rng = rng or name
            elif op is None:
                op = name
            if rng and op:
                break
        out.append([f"{rng or 'outside a period'}/{op or 'no host op'}", length / 1e6])
    return out
