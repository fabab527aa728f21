#!/usr/bin/env python3
"""Profile steady fleet periods on one NVIDIA GPU.

    python3 profile_gi.py [--out FILE.json]

Run from the root of a checkout, on a machine with one CUDA card.  For each
of the two GI configurations of ``chip_smoke.py`` (headline-GI: 256 CSTR
controllers x 16 reps, float32 data, float64 slots; large-GI: 32 8x8
plants, Hp=15, Hc=4, ``gi_max_active=8`` x 128 reps, float32 data and
slots; both B=4096, in closed loop), for headline-ADMM (the headline
fleet with the ADMM backend, float32) and for SLMPC-GI (bench.py's SLMPC
pendulum fleet, B=4096, float32 data, float64 slots, its true pendulums
stepped on the card) it runs 8 periods from rest (SLMPC: 16, the
swing-up), times 12 unprofiled periods (host clock, from a synchronized
start to the host read of ``n_conv``), then profiles 4 more with
``torch.profiler`` and reports per period:

* ``wall_unprofiled_ms`` (median of the 12) and ``wall_profiled_ms``;
* ``device_busy_ms``: the union of the intervals of the device's own
  activities — kernels, copies and sets.  The ``record_function`` ranges
  this script opens (``fleet_step``, ``solve_qp``/``solve_qp_active``,
  ``gi_solve``/``admm_sweep``)
  also show up as device-side annotations; they are left out, or the
  busy time would count the whole step;
* ``idle_share_profiled`` = 1 − busy / profiled wall (both from the
  profiled periods) and ``idle_share_unprofiled`` = 1 − busy / unprofiled
  wall, which divides the profiled device busy time by the median wall of
  the unprofiled periods (the profiler slows the host, not the device);
* the host time inside each range, the largest host ops by self time, and
  the largest device items.

The ranges are opened from outside the package: around the fleet step,
around ``solve_qp_active`` and ``solve_qp`` (patched in
``controllers.linmpc`` and ``controllers.slmpc``) and around the fleet's
``gi`` or ``sweep`` attribute (the kernel's wrapper).  The card's name and
power limit are printed last.
"""
import argparse
import json
import statistics
import sys
import time

from chip_smoke import (ROOT, ClosedLoop, PendulumLoop, SLMPCFleet, card_line,
                        large_controllers, slmpc)

RANGES = ("fleet_step", "solve_qp_active", "solve_qp", "gi_solve", "admm_sweep")
KERNELS = {"gi": "gi_solve_kernel", "sweep": "admm_"}
WARM, TIMED, PROFILED = 8, 12, 4


def union_ms(intervals):
    """Length of the union of (start, end) intervals given in microseconds."""
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
    return total / 1e3


def profile_fleet(torch, fleet, loop, attr, warm=WARM):
    from torch.profiler import ProfilerActivity, profile, record_function
    inner = getattr(fleet, attr)
    label = "gi_solve" if attr == "gi" else "admm_sweep"

    def ranged(*args):
        with record_function(label):
            return inner(*args)
    setattr(fleet, attr, ranged)
    for k in range(warm):
        u, _ = fleet.step(*loop.measure(k))
        loop.advance(u)
    torch.cuda.synchronize()
    walls = []
    for k in range(warm, warm + TIMED):
        ym, ry = loop.measure(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, nc = fleet.step(ym, ry)
        int(nc)
        walls.append((time.perf_counter() - t0) * 1e3)
        loop.advance(u)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(warm + TIMED, warm + TIMED + PROFILED):
            with record_function("fleet_step"):
                u, nc = fleet.step(*loop.measure(k))
                int(nc)
            loop.advance(u)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3 / PROFILED
    setattr(fleet, attr, inner)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev_ev = [e for e in events if e.device_type == cuda and e.name not in RANGES]
    busy = union_ms([(e.time_range.start, e.time_range.end) for e in dev_ev]) / PROFILED
    host_ranges = {}
    for e in events:
        if e.name in RANGES and e.device_type != cuda:
            host_ranges[e.name] = (host_ranges.get(e.name, 0.0)
                                   + (e.time_range.end - e.time_range.start) / 1e3)
    ka = prof.key_averages()
    dev_items = sorted(((k.key, k.device_time_total / 1e3 / PROFILED, k.count / PROFILED)
                        for k in ka if k.device_time_total > 0 and k.key not in RANGES
                        and not k.key.startswith("aten::")), key=lambda t: -t[1])
    host_ops = sorted(((k.key, k.self_cpu_time_total / 1e3 / PROFILED, k.count / PROFILED)
                       for k in ka if k.key.startswith(("aten::", "cuda"))),
                      key=lambda t: -t[1])
    wall_u = statistics.median(walls)
    return dict(
        wall_unprofiled_ms=wall_u, walls_ms=walls, wall_profiled_ms=wall_p,
        device_busy_ms=busy, device_activities=len(dev_ev) / PROFILED,
        idle_share_profiled=1 - busy / wall_p,
        idle_share_unprofiled=1 - busy / wall_u,
        host_ranges_ms={k: v / PROFILED for k, v in host_ranges.items()},
        host_self_top_ms=host_ops[:8],
        kernel_device_ms=sum(ms for key, ms, _ in dev_items if KERNELS[attr] in key),
        kernel_launches=sum(c for key, _, c in dev_items if KERNELS[attr] in key),
        top_device_ms=dev_items[:10],
        solves_per_s=fleet.B / wall_u * 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results to this JSON file too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_gi: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.controllers import linmpc, slmpc as slmpc_module
    from mpc_tpu_torch.parallel import BatchedLinMPC, random_cstr_controllers
    from torch.profiler import record_function

    for module in (linmpc, slmpc_module):
        for fname in ("solve_qp_active", "solve_qp"):
            def solve_ranged(*a, _f=getattr(module, fname), _n=fname, **k):
                with record_function(_n):
                    return _f(*a, **k)
            setattr(module, fname, solve_ranged)
    dev = torch.device("cuda")
    configs = (
        ("headline-GI", lambda: random_cstr_controllers(256, Hp=10, Hc=2, seed=0,
                                                        qp_solver="active_set"),
         16, None, "gi"),
        ("large-GI", lambda: large_controllers(mt, 32, qp_solver="active_set",
                                               gi_max_active=8),
         128, torch.float32, "gi"),
        ("headline-ADMM", lambda: random_cstr_controllers(256, Hp=10, Hc=2, seed=0),
         16, None, "sweep"))
    out = {}
    for name, make, reps, slots, attr in configs:
        ctrls = make()
        fleet = BatchedLinMPC(ctrls, reps=reps, device=dev, dtype=torch.float32,
                              gi_slot_dtype=slots)
        loop = ClosedLoop(torch, ctrls, reps, dev, torch.float32)
        out[name] = profile_fleet(torch, fleet, loop, attr)
        print(name, json.dumps(out[name], indent=1), flush=True)
        del fleet
    sl = slmpc(torch, mt, dev, dtype=torch.float32)
    fleet = SLMPCFleet(torch, sl, 4096)
    loop = PendulumLoop(torch, sl.model, 4096, dev, torch.float32)
    out["SLMPC-GI"] = profile_fleet(torch, fleet, loop, "gi", warm=16)
    print("SLMPC-GI", json.dumps(out["SLMPC-GI"], indent=1), flush=True)
    out["card"] = card_line()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
