"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

A period is: the world's measurement of every lane (the benchmark's own
plants and noise, on the device), the port's step on it, and the copy of
u and of the converged count to the host (an actuator needs u there); the
host clock times it from the measurement handed to the port to the count
on the host.  Then the recorded lanes' data are copied into preallocated
device buffers (no host synchronisation) and the world advances with the
port's u.  The window runs periods until ``--seconds`` have passed; with
``--trace 1`` a stretch of periods under ``torch.profiler`` follows it.

``attempted`` and ``failed`` count the lane-periods of the cell file's
``counted_periods`` periods after warm-up, and no others: ``B`` times that
number, and the lanes the port reports unconverged in them.  Every run of a
seed then counts the same lane-periods, however fast it ran.  Where the
window closes before it holds them, the run goes on with the same periods
until it does; those periods are recorded and checked like the window's,
and are outside every timing.
"""
from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time

import torch

from . import registry, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_tpu")


class Recorder:
    """The recorded lanes' rows (measurements, setpoints, disturbances,
    inputs) and every period's counters, in device buffers made at
    the first period, before the window."""

    def __init__(self, lanes, cap):
        self.lanes, self.cap = lanes, cap
        self.buf, self.k = {}, 0

    def put(self, k, rows, counters):
        if k >= self.cap:
            raise RuntimeError(f"more than {self.cap} periods: raise max_periods")
        vals = {n: v.index_select(0, self.lanes) for n, v in rows.items()}
        vals.update(counters)
        for n, v in vals.items():
            if n not in self.buf:
                self.buf[n] = torch.empty((self.cap,) + tuple(v.shape), dtype=v.dtype,
                                          device=v.device)
            self.buf[n][k].copy_(v)
        self.k = k + 1

    def get(self, name, a=0, b=None):
        if name not in self.buf:
            return None
        return self.buf[name][a:self.k if b is None else b]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(workload, seed, seconds, trace_on, device, t0, root=registry.ROOT,
        cell_override=None, config_override=None, fault=None, control=False):
    """Run one cell; returns ``(result, notes, check_lines)`` or raises.

    ``cell_override`` and ``config_override`` change entries of the cell's
    and the configuration's files (the tests' small sizes); ``fault(cell)``
    breaks the timed path before the run (the tests' faults); ``control``
    also runs the reference in TF32 over the same record and adds its gap
    to the float64 reference as ``result["control"]``."""
    spec = registry.benchmark_spec(root)
    entry = registry.cell_entry(spec, workload)
    cfg = registry.config_file(spec, entry["config"], root)
    if config_override:
        cfg = {**cfg, **config_override}
    cell_spec = registry.cell_file(workload)
    if cell_override:
        cell_spec = {**cell_spec, **cell_override}
    traffic_spec = registry.traffic_file(entry["traffic"])
    kind = registry.kind_module(cfg["kind"])
    dev = torch.device(device)
    t_start = time.perf_counter()
    from mpc_tpu_torch import ops
    cell = kind.Cell(cfg, cell_spec, traffic_spec, seed, dev)
    t_built = time.perf_counter()
    if fault is not None:
        fault(cell)
    B = cell.B
    rec = Recorder(cell.check_lanes, int(cell_spec["max_periods"]))
    pinned = dev.type == "cuda"
    u_host = None
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    log = dict(start=[], period=[], dispatch=[], nconv=[], launches=[])

    def period(k):
        log["start"].append(time.perf_counter())
        with torch.profiler.record_function("period.measure"):
            ym, ry, d = cell.measure(k)
        _sync(dev)
        ta = time.perf_counter()
        with torch.profiler.record_function("period.step"):
            u, n_conv = cell.step(ym, ry, d)
        tb = time.perf_counter()
        nonlocal u_host
        with torch.profiler.record_function("period.copy_out"):
            if u_host is None:
                u_host = torch.empty(u.shape, dtype=u.dtype, pin_memory=pinned)
            u_host.copy_(u)
            nc = int(n_conv)
        tc = time.perf_counter()
        with torch.profiler.record_function("period.record"):
            bad.add_((~torch.isfinite(u)).sum())
            rec.put(k, dict(ym=ym, ry=ry, d=d, u=u), cell.counters())
        with torch.profiler.record_function("period.world"):
            cell.advance(u)
        log["period"].append((tc - ta) * 1e3)
        log["dispatch"].append((tb - ta) * 1e3)
        log["nconv"].append(nc)
        log["launches"].append(dict(ops.LAUNCHES))
        return tc

    ops.reset_launch_counts()
    warm = int(traffic_spec.get("warmup_periods", 3))
    for k in range(warm):
        period(k)
    _sync(dev)
    t_win = time.perf_counter()
    setup_s = t_win - t0
    stages = (f"set-up: {t_start - t0:.3f} s to the run, {t_built - t_start:.3f} s to build "
              f"the cell, {t_win - t_built:.3f} s for {warm} warm-up periods")
    counted = int(cell_spec["counted_periods"])
    k = warm
    t_end = t_win
    while t_end - t_win < seconds:
        t_end = period(k)
        k += 1
    window_s = t_end - t_win
    k_win = k
    n_win = k_win - warm
    win = slice(warm, k_win)
    while k < warm + counted:                   # counted periods the window missed: untimed
        period(k)
        k += 1
    n_past = k - k_win
    result = dict(correct=False, attempted=B * counted,
                  failed=sum(B - n for n in log["nconv"][warm:warm + counted]))
    n_over = max(n_win - counted, 0)
    over_failed = sum(B - n for n in log["nconv"][warm + counted:k_win])
    ctx = dict(B=B, setup_s=setup_s, window_s=window_s, n_window=n_win,
               period_ms=log["period"][win], kernel=cell.kernel,
               # each window period's whole cycle, start to the next start
               cycle_s=[b - a for a, b in zip(log["start"][warm:k_win - 1],
                                              log["start"][warm + 1:k_win])],
               cycle_launches=_per_period(log["launches"], warm, k_win - 1))
    prof = None
    if trace_on:
        n_st = int(cell_spec["stretch_periods"])
        a = k_win - min(n_st, n_win)            # the window's last periods
        ctx["dispatch_ms"] = log["dispatch"][a:k_win]
        ctx["launches"] = _per_period(log["launches"], a, k_win)
        iters = rec.get("iters_max", a, k_win)
        ctx["iters_max"] = None if iters is None else iters.tolist()
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if pinned else [])
        with profile(activities=acts) as prof:
            tp = time.perf_counter()
            for j in range(k, k + n_st):
                period(j)
            _sync(dev)
            ctx["profiled_s"] = time.perf_counter() - tp
        piv = rec.get("pivots", k, k + n_st)
        ctx["profiled_pivots"] = [0] * n_st if piv is None else piv.tolist()
        ctx["profiled_launches"] = _per_period(log["launches"], k, k + n_st)
        k += n_st
        ctx["stretch_periods"] = n_st
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ref = cell.reference(dev)
    if prof is not None:
        ctx["trace"] = trace.read(prof, torch)
        ctx["bound_s"] = lambda pivots, launches: cell.bound_s(ref, pivots, launches)
    # --- the check, after the window, with the program's state freed ---
    data = {n: rec.get(n) for n in ("ym", "ry", "d", "u")}
    nconv_all = sum(log["nconv"])
    n_all = len(log["nconv"])
    bad_u = int(bad)
    cell.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tr0 = time.perf_counter()
    u_ref, kkt = ref.run(data["ym"], data["ry"], data["d"])
    ref_s = time.perf_counter() - tr0
    gap = (data["u"].to(u_ref.dtype) - u_ref).abs()
    if control:
        from .precision import TF32
        u_c, _ = cell.reference(dev, TF32).run(data["ym"], data["ry"], data["d"])
        result["control"] = dict(u_gap=float((u_c.to(u_ref.dtype) - u_ref).abs().max()),
                                 program_u_gap=float(gap.max()))
    limits = cell_spec["limits"]
    checks = dict(
        u_gap=float(gap.max()),
        unconverged_share=1.0 - nconv_all / (B * n_all),
        nonfinite_u=bad_u,
        ref_kkt=float(kkt.max()))
    ok = all(checks[n] <= limits[n] for n in checks)
    result["correct"] = ok
    metrics = registry.cell_metrics(spec, workload, trace_on)
    result["metrics"] = {}
    for m in metrics:
        v = registry.metric_reader(m["name"])(ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["device"] = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                            kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                            count=1, memory_peak_bytes=int(peak))
    if prof is not None:
        result["device"]["busy_s"] = ctx["trace"]["busy_s"]
        result["device"]["window_s"] = ctx["profiled_s"]
        result["breakdown"] = dict(device_ops=[list(t) for t in ctx["trace"]["device_ops"]],
                                   idle_gaps=ctx["trace"]["idle_gaps"])
    result["checks"] = {n: {"value": v, "limit": limits[n]} for n, v in checks.items()}
    notes = [f"cell {workload}: B={B}, seed={seed}, window {window_s:.3f} s, "
             f"{n_win} periods in the window ({len(ctx['period_ms'])} period samples), "
             f"{n_all} periods recorded, {int(cell.check_lanes.numel())} lanes checked",
             f"counted: {counted} periods after warm-up ({result['attempted']} lane-periods, "
             f"{result['failed']} unconverged); {n_past} periods run past the timed window; "
             f"{n_over} timed periods beyond the counted ones, with {over_failed} unconverged "
             "lane-periods",
             f"window: host dispatch of the step {_mean(log['dispatch'][win]):.3f} ms, "
             f"period {_mean(ctx['period_ms']):.3f} ms, cycle {_mean(ctx['cycle_s']) * 1e3:.3f} ms "
             "(means)",
             f"reference: {ref_s:.3f} s for {n_all} periods",
             stages, f"disk writes of this process so far: {_written()} bytes", _host()]
    lines = [f"check {n}: {v!r} (limit {limits[n]!r})" for n, v in checks.items()]
    return result, notes, lines


def _written():
    """Bytes this process has caused to be written to storage (Linux's
    ``/proc/self/io``), or "unknown"."""
    try:
        with open("/proc/self/io", encoding="ascii") as f:
            return next(int(ln.split()[1]) for ln in f if ln.startswith("write_bytes"))
    except (OSError, StopIteration, ValueError):
        return "unknown"


def _mean(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def _host():
    """Where the host's time went: the CPUs the process may run on, its CPU
    seconds and its context switches (``getrusage``)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        cpus = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cpus = "unknown"
    return (f"host: {cpus} CPUs allowed, user {ru.ru_utime:.3f} s, system {ru.ru_stime:.3f} s, "
            f"context switches {ru.ru_nvcsw} voluntary, {ru.ru_nivcsw} involuntary")


def forbidden_loaded():
    """Top-level names of loaded modules that the run must not have loaded,
    compared whole (``mpc_tpu_torch`` is not ``mpc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _per_period(snaps, a, b):
    """Kernel launches of each period a..b−1 from the counters' snapshots
    taken at the end of every period (counted from 0 before period 0)."""
    zero = dict.fromkeys(snaps[0], 0)
    return {name: [snaps[j][name] - (snaps[j - 1] if j else zero)[name] for j in range(a, b)]
            for name in snaps[0]}


def emit(result, notes, lines, card=None):
    """Print the notes and check lines on standard error and the result line
    on standard output; raise instead, printing nothing, where a forbidden
    module is loaded by now (after the window, the reference and the
    metrics' readers)."""
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"modules loaded that the port must not load: {found}")
    for n in notes:
        print(n, file=sys.stderr)
    if card:
        print(f"card: {card}", file=sys.stderr)
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
