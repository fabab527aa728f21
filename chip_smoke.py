#!/usr/bin/env python3
"""Smoke test of mpc_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Run from the root of a checkout, on a machine with one CUDA card.  Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``mpc_tpu_torch/csrc`` (nvcc);
3. every kernel against its plain torch version on the card, at the shapes
   the main path gives it (inputs captured in a steady closed-loop period
   with the input bounds active: warm x, z and y, some lanes already
   frozen; the 8x8/Hp=15 lanes also tiled to B=4096), each of x, z and y
   held to its own bar, with both times (CUDA events, median of 25 runs)
   and the kernel's device time (profiler, and CUDA events around the
   launch alone); 3b. both kernels on every lane
   layout, and the sweep on QPs wider than its block (n=300);
4. QPs beyond a block's shared memory (n=64, m=1024): the sweep in float32
   and float64 and the GI solve in float64 run in the layout the wrappers
   pick for them (the sweep's staged, GI's split) and hold to their plain
   versions;
5. a small float64 fleet on the card against the same fleet on the CPU
   (the plain path, which the CPU tests hold to the JAX reference);
6. THE MAIN PATH: the headline fleet — 256 randomized 2x2 CSTR-like LinMPC
   controllers (Hp=10, Hc=2, soft y and hard u/Δu bounds) x 16 replicas,
   B=4096 lanes, float32, ADMM — in closed loop with true plants, 4 rotating
   setpoint phases and measurement noise, through ``step`` and one
   ``multistep(K=4)``, with the kernel launch counts read around it;
7. one more period with the plain sweep on the card: every lane's u must
   agree with the kernel path to 1e-4;
8. the Goldfarb–Idnani kernel against its plain version on the card, on
   fresh copies of the same inputs, with both times: (a) float64 random QPs
   (n=6, m=24, B=4096) with dual warm starts and a slot cap of 3 that
   forces restarts, (b) the headline-GI and (c) the large-GI solve inputs,
   captured in a steady closed-loop period with the carried operator state;
9. a small float64 GI fleet on the card against the same fleet on the CPU;
10. THE GI MAIN PATHS, each in closed loop through ``step`` and one
   ``multistep(K=4)`` with the kernel launch counts read around it:
   headline-GI (the headline fleet with ``qp_solver="active_set"``,
   float32 data, float64 slots, 16 periods) and large-GI (32 distinct 8x8
   plants, Hp=15, Hc=4, ``gi_max_active=8``, x 128 replicas = 4096 lanes,
   float32 data and slots, 8 periods);
11. one more period of each with the plain GI solve on the card: every
   lane's u must agree with the kernel path to 1e-4;
12. THE SINGLE-CONTROLLER PATH, the README flow: ``sim(ctrl, 40, [5, 0])``
   of the README plant with ``ymax=[inf, 35]``, ADMM and GI, float64,
   ``device="cuda"``, against the same ``sim`` on the CPU (u and y to 1e-6),
   with the launch counts read around each run and the median ``moveinput``
   wall time over periods 5-40; then each kernel against its plain version
   on the B=1 inputs of one more period, with both times;
13. one full-width single controller (one 8x8 plant of phase 3's large
   configuration, Hp=15, Hc=4, KalmanFilter, float32), ADMM and GI, 20
   periods with a rotating setpoint on the card against the CPU, u to
   F32_TOL·(1 + max|u|), with the median ``moveinput`` time;
14. the uncached QP paths, per-lane P and A at B=1024 in float64, kernel
   against plain on the card with both times: ``solve_qp_batch`` (ADMM, x to
   1e-7·(1 + max|x|), equal iterations) and ``solve_qp_active`` without a
   cache at n=6 (Gauss–Jordan P⁻¹) and n=12 (Cholesky), x to
   1e-9·(1 + max|x|), equal flags;
15. the Ts-deadline policy: a Ts = 1 µs LinMPC with ``limit_solve_time``
   must clamp the iteration budget to its floor of 50 and flag a miss;
16-20. the SLMPC slice: bench.py's SLMPC fleet (the pendulum, B=4096,
   float32, GI), both kernels against their plain versions at its shape, a
   plain-GI period, 4 ADMM periods from rest, small float64 SLMPC fleets and
   the single swing-up card vs CPU, the UKF, the EKF and a BatchedKalman;
21. THE NONLINMPC SLICE'S MAIN PATH, bench.py's ``nonlin`` lane: a
   BatchedNonLinMPC of the pendulum (MultipleShooting, Hp=15, Hc=2, SQP with
   the KKT exit, the UKF at α=0.5; GI with float64 slots), B=4096, float32,
   2 warm and 2 timed windows of 8 periods from rest; ≥ 0.99 of the lanes
   converged by the per-lane KKT test, |u| ≤ 1.5; one more period counted
   (device launches and busy time under the profiler, host syncs by the
   sync-debug mode); the GI kernel against its plain version (n=2, m=72) on
   the first solve with warm rows on half the lanes, one plain-GI period,
   4 ADMM periods from rest with the sweep against its plain version;
22. the exact-Hessian A/B (the economic pendulum, SingleShooting, B=256,
   float32): Gauss–Newton and exact, 4 periods each, GI at n=2, m=102
   against its plain version;
23-26. small float64 NonLinMPC fleets (B=8, chunk 4) and the single
   swing-up (Hp=20, SingleShooting, 60 periods) card vs CPU with both
   backends, and a BatchedExplicitMPC (B=256) card vs CPU;
27. THE MHE SLICE'S MAIN PATH, bench.py's ``mhe`` lane: a BatchedMHE of the
   2x1 LinModel (He=10, x̂ within ±50, ``gi_max_active=8``), B=4096,
   float32 data, float64 GI slots, on true plant trajectories from seed 3:
   11 fill steps, one warm ``multistep(K=8)`` and 3 timed windows of 2
   dispatches; ≥ 0.99 of the lanes converged, one GI launch a period; one
   counted period; one period with the plain GI (x̂ to F32_TOL); then the
   1 %-NaN traffic (1 warm and 3 timed dispatches); the GI kernel against
   its plain version at shape (a) (n=44, m=104, 8 slots, one shared P⁻¹ and
   A) and (b) (the NaN variant: per-lane P⁻¹, the shared A through GI's A
   map);
28. bench.py's ``mhe_nonlin`` lane: the pendulum BatchedMHE (window GN-SQP,
   GI, EKF arrival covariance per lane), B=1024, float32, K=4: 11 fill
   steps, 1 warm and 3 timed windows of 2 dispatches, ≥ 0.99 converged, GN
   iterations and exit tests, one counted period, GI against plain at shape
   (c) (n=33, m=146, per-lane P and A);
29. small float64 BatchedMHE fleets (B=8, He=4: fast path, NaN variant,
   ``solver="general"`` with ADMM, a nonlinear fleet) card vs CPU, the ADMM
   sweep against its plain version at the general window (B=256, n=44,
   m=208, float32), and one MovingHorizonEstimator closed loop with a NaN
   window card vs CPU (both kernels on the single-stream path);
30. THE COMPILED-LOOP SLICE'S MAIN PATH, bench_scan.py's cell: the CSTR
   LinMPC (Ts = 2, uop = [20, 20], yop = [50, 30], Hp=10, Hc=2, 5 ≤ u ≤ 35,
   |Δu| ≤ 4, |y| ≤ 60) in ``CompiledClosedLoop(ctrl).run_fleet(512, 100,
   ry=[54, 30], y_noise=[0.1, 0.1], seed=0)``, float32, GI (float64 slots)
   and ADMM: 1 warm and 3 timed runs each with the launch counts read
   around them, the host noise draw timed apart, ≥ 0.99 of the B·N solves
   converged, the host syncs of a run (sync-debug mode) and its device
   launches and busy time (profiler); each kernel against its plain
   version on one call's inputs at this shape (one controller, B=512);
   then ``CompiledClosedLoopFleet`` of 128 random CSTR controllers
   (n_d = B, float64), both kernels against their plain versions at that
   shape;
31. ``CompiledSLLoop.run_fleet`` of tests/test_sim_compiled.py's SLMPC (the
   pendulum, Hp=20, GI), B=4096, N=40, float32: steps/s, ≥ 0.99
   converged, |u| ≤ 1.5;
32. ``CompiledNonLinLoop.run_fleet`` of bench.py's NonLinMPC (MS, the UKF at
   α=0.5, GI), B=1024, N=20 (depth cut), float32: steps/s, SQP iterations
   and exit tests, host syncs a step;
33. every compiled loop in float64 on the card against the CPU (run and
   run_fleet with both backends, the heterogeneous fleet, the SL run, the
   NonLin fleet, the MHE record with NaN dropouts, MHE → MPC), each within
   its solver's bar;
34. the embedded C export: tests/test_codegen.py's five controllers and the
   README controller with GI, built on the card, exported (``export_c``) and
   compiled with gcc; the C step against the controller's ``moveinput`` on
   the card over 15 noisy periods, at the reference tests' bars (2e-4 and
   5e-4 ADMM, 1e-9 the exact active set, 5e-3 the soft bound), with the C
   step's median time on the host CPU;
35. the native executor (``native/rt_executor.cpp``): the exported README
   GI controller for 500 periods of 1 ms — every step done, u bitwise equal
   to the ctypes-driven loop on the same inputs, the wall time within 10 %
   + 50 ms of 0.5 s, every step a budget overrun at a 1 ns budget — with
   the deadline misses, jitter and execution times of the host CPU;
36. the mesh and the chunks: (a) ``__graft_entry__.dryrun_multichip``'s
   four pipelines with a port API (BatchedLinMPC, CompiledClosedLoop
   .run_fleet in float32, BatchedNonLinMPC, BatchedMHE; B=8) on meshes of
   1, 2 and 4 shards over the visible cards (``["cuda:0"] * k`` on one
   card) against the unsharded objects (1e-6; 5e-5 for the float32 loop);
   (b) headline-GI (B=4096) unsharded and on 1, 2 and 4 shards, u within
   F32_TOL·(1 + max|u|) and every lane converged, with the period wall
   time, GI launches and solves/s of each; (c) large-ADMM (B=4096) with
   ``grouped_chunks`` 1 and 8, the same n_conv and u within
   F32_TOL·(1 + max|u|) on all but CHUNK_FLIPS lanes, with the period wall
   time, sweep launches and host syncs, the float32 spread of one period
   (kernel against plain sweep) beside it, and the same chunks in float64
   (B=256), every lane within 1e-9·(1 + max|u|);
37. THE STAGED AND SPLIT LAYOUTS' MAIN PATHS, QPs whose one-lane block
   exceeds the shared memory of an SM (the sweep's staged layout, GI's
   split one; each also timed in the global layout, the last resort, on the
   same captured inputs, with the same bits): (a) one 8x8 LinMPC of bench.py's plants at
   Hp=25, Hc=4, float64 (n=33, m=897), ``sim`` for 30 periods with GI (33
   slots) and ADMM on the card against the CPU (u to 1e-6, GI's iteration
   counts equal), the median ``moveinput``, each kernel against its plain
   version on one more period's inputs; (b) bench_horizon.py's fleet at
   Hp=60: 32 random 8x8 plants x 128 = 4096 lanes, float32 (n=33, m=2017),
   GI (``gi_max_active=12``) then ADMM, each kernel against its plain
   version on a steady period's inputs at B=256 (32 x 8), then 8 periods
   with the launch counts read around them, the converged share against
   0.99 (required for GI; ADMM's is reported: its 250-iteration budget
   stops lanes at this horizon in the reference too); (c)
   examples/mhe_estimation.py's MovingHorizonEstimator at He=40, float64
   (n=82, m=202, 82 slots), 50 periods card vs CPU (x̂ to 1e-9·(1 +
   max|x̂|)), the GI kernel against its plain version on one more window;
   (d) the global layout, and the split (GI) or staged (the sweep's lanes
   in step) layout with a third of A's rows in shared memory, forced on
   the captured inputs of headline-GI, large-GI, headline-ADMM and 8x8/
   Hp=15 ADMM: the resident layout's bits (max |Δ| = 0 on x, λ, the
   iterations and flags, and on x, z, y) and each layout's device time;
38. THE PER-LANE LAUNCHES (every lane its own QP matrices, n_d = B: the
   kernels' per-lane geometry, and GI's A map at the MHE NaN variant (b)),
   on the inputs the phases above captured (SLMPC and NonLinMPC GI and
   ADMM, the NonLinMPC A/B, (b), (c), the compiled-loop fleet, the README
   controller): each against the same launch with the global layout
   forced, which groups the lanes a lane a block as before and sums in the
   same order (max |Δ| = 0), with its device time and lanes per SM; (b)
   also against the call with A copied to every lane (the same bits).

The line before the last is the card's name and power limit, and before it
a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  Without a CUDA device, or without the package beside it, the
script fails and prints no result.
"""
import copy
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 1e-4      # kernel vs plain, float32: |Δ| ≤ F32_TOL·(1 + max|plain|)
                    # (the two sum over the m rows in different orders)
GI_F64_TOL = 1e-12  # GI kernel vs plain on float64 data: x to 1e-12·(1 + max|x|)
CHUNK_FLIPS = 4     # large-ADMM in f32: lanes whose u may move beyond F32_TOL
                    # when the batch layout changes (phase 36c)
GI_FLIPS = 4        # GI at the fleet shapes: lanes whose converged flag may
                    # differ (a near-tie in the f32 scan can change the pivot
                    # order; the optimum is unique, so x may not move)


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(), f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def median_ms(torch, fn, setup, n=25):
    """Median device time of ``fn`` over ``n`` runs (CUDA events), each run
    from a fresh ``setup()`` outside the timed window, after one warm-up."""
    setup()
    fn()
    events = []
    for _ in range(n):
        setup()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


ADMM_KERNELS = ("admm_warp_kernel", "admm_group_kernel", "admm_staged_kernel")
GI_KERNELS = ("gi_solve_kernel",)
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s (data sheet)
PEAK_FLOPS = {4: 67e12,    # float32 outside the tensor cores (data sheet)
              8: 34e12}    # float64 outside the tensor cores (data sheet)


WARM_CALLS = 2     # calls ahead of the timed ones in each profile (below)


def device_ms(torch, fn, setup, names, n=10, tries=3, launches=None):
    """Mean device time of one call of ``fn``: the durations of the
    profiler's kernel records whose name contains one of ``names`` in ``n``
    calls (each after a fresh ``setup()``, each in a range of its own),
    divided by ``n``.  Each profile starts with WARM_CALLS calls outside the
    count: late in a long run the profiler misses the first one or two
    kernel records of a profile.  A record belongs to the call whose range
    holds its launch (the runtime's launch event shares the record's id).
    A profile with another number of records in the timed calls is taken
    again, up to ``tries`` times, printing the calls without one; then it
    fails, unless ``launches`` (a callable giving the wrappers' launch
    count) shows one launch a call: the records kept are averaged."""
    from torch.profiler import ProfilerActivity, profile, record_function
    setup()
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    tag = "device_ms call "
    for _ in range(tries):
        n0 = launches() if launches else 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(-WARM_CALLS, n):
                setup()
                with record_function(f"{tag}{i}"):
                    fn()
            torch.cuda.synchronize()
        n_launch = launches() - n0 - WARM_CALLS if launches else None
        evs = prof.events()
        ks = [e for e in evs if e.device_type == cuda and any(k in e.name for k in names)]
        ranges = [(int(e.name[len(tag):]), e.time_range) for e in evs if e.name.startswith(tag)]
        call_of = {e.id: i for e in evs if e.device_type != cuda and "LaunchKernel" in e.name
                   for i, r in ranges if r.start <= e.time_range.start <= r.end}
        if call_of:
            ks = [e for e in ks if call_of.get(e.id, -1) >= 0]
            seen = {call_of[e.id] for e in ks}
            where = f"calls without a record: {[i for i in range(n) if i not in seen]}"
        else:
            ks = sorted(ks, key=lambda e: e.time_range.start)[-n:]
            where = "the records are not linked to the calls"
        if len(ks) == n:
            return sum(e.time_range.end - e.time_range.start for e in ks) / 1e3 / n
        print(f"profiler saw {len(ks)} records of {names} in {n} timed calls, {n_launch} "
              f"launches counted; {where}", flush=True)
    if n_launch == n and ks:
        print(f"profiler lost {n - len(ks)} of {n} records of {names} ({n} launches counted): "
              "the mean of the records kept", flush=True)
        return sum(e.time_range.end - e.time_range.start for e in ks) / 1e3 / len(ks)
    raise Fail(f"profiler saw {len(ks)} records of {names} in {n} calls, {tries} times "
               f"({n_launch} launches counted)")


LIB_SYMBOLS = {"admm_sweep": ("mpc_admm_sweep_f32", "mpc_admm_sweep_f64"),
               "gi_solve": ("mpc_gi_solve_f32_f64", "mpc_gi_solve_f32_f32",
                            "mpc_gi_solve_f64_f64")}
SLEEP_CYCLES = 2_000_000   # ~1 ms of a spinning kernel ahead of each launch


def launch_event_ms(torch, kernel, fn, setup, n=10):
    """Mean device time of ``kernel``'s launch in one call of ``fn``, by CUDA
    events recorded just before and after the library's launch function
    (no profiler): a spinning kernel queued ahead keeps the stream busy
    while the host queues the start event and the launch, so the events
    bracket the kernel alone."""
    from mpc_tpu_torch.ops import _build
    lib = _build.load_library()
    orig = {s: getattr(lib, s) for s in LIB_SYMBOLS[kernel]}
    evs = []

    def hooked(launch):
        def call(*a):
            torch.cuda._sleep(SLEEP_CYCLES)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            rc = launch(*a)
            e.record()
            evs.append((s, e))
            return rc
        return call
    try:
        for s, launch in orig.items():
            setattr(lib, s, hooked(launch))
        for _ in range(n):
            setup()
            fn()
        torch.cuda.synchronize()
    finally:
        for s, launch in orig.items():
            setattr(lib, s, launch)
    check(len(evs) == n, f"{kernel}: {len(evs)} launches in {n} calls")
    return statistics.mean(s.elapsed_time(e) for s, e in evs)


def bound(nbytes, flops, itemsize):
    """The least time the card could take (ms) and what sets it: the bytes
    over the memory rate or the operations over the peak rate of the type."""
    t_b, t_f = nbytes / HBM_BPS, flops / PEAK_FLOPS[itemsize]
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def admm_bound(torch, a, iters):
    """Bound of one sweep launch on these inputs: the active lanes read l,
    u, z, y, x, q, their rung's Minv and ρ (each distinct (controller, rung)
    pair once) and their controllers' A once, and write x, z, y; each does
    4mn + 2n² + 12m + 6n flops a sweep (the two products, Minv·rhs and the
    elementwise updates)."""
    on = a["active"]
    Ba = int(on.sum())
    n, m, s = a["x"].shape[1], a["z"].shape[1], a["x"].element_size()
    lc, rg = a["lane_ctrl"][on].long(), a["rung"][on].long()
    n_c = int(torch.unique(lc).numel())
    n_pair = int(torch.unique(lc * 1000 + rg).numel())
    nbytes = s * (n_c * m * n + n_pair * (n * n + m) + Ba * (2 * n + 4 * m)
                  + Ba * (n + 2 * m)) + Ba * 9
    flops = Ba * int(iters) * (4 * m * n + 2 * n * n + 12 * m + 6 * n)
    return bound(nbytes, flops, s)


def gi_distinct(torch, args):
    """The distinct P⁻¹ the lanes read (through ``lane_ctrl``), the distinct
    rows of A they read (through the A map where the call has one, else
    through ``lane_ctrl``) and the distinct A among those rows: a lane map
    that gives every lane a copy of one shared A reads that A many times."""
    Pinv, A, lc = args[:3]
    amap = args[16] if len(args) > 16 else lc
    n_p = int(torch.unique(lc).numel())
    n_r = int(torch.unique(amap).numel())
    return n_p, n_r, (1 if A.shape[0] == 1 or bool((A == A[:1]).all()) else n_r)


def gi_bound(torch, args, it):
    """Bound of one GI launch on these inputs: each distinct P⁻¹ and each
    distinct A read once; per lane q, l, u, the warm list and the operator
    state read, the state, x, λ, the count and the flag written; and per
    pivot the lane's ~2mn + 8m + 4n² + 4·ns·n + 5·ns² flops (the scan, the
    Gram products, the update of x and the rank-one update), over the
    pivots ``it`` this run took."""
    Pinv, A, lc, q, l = args[:5]
    B, n = q.shape
    m, ns = l.shape[1], args[6].shape[1]
    sd, ss = A.element_size(), Pinv.element_size()
    n_p, _, n_a = gi_distinct(torch, args)
    state = 2 * ns * 4 + ns + ns * ns * ss
    nbytes = (n_a * m * n * sd + n_p * n * n * ss
              + B * (n * sd + 2 * m * sd + state + 2 * ns * 4 + 8)
              + B * (state + (n + ns) * ss + 5))
    flops = int(it.sum()) * (2 * m * n + 8 * m + 4 * n * n + 4 * ns * n + 5 * ns * ns)
    return bound(nbytes, flops, sd)


def card_geometry(torch):
    """(shared-memory budget of a block, SMs) of the card, as the wrappers
    read them."""
    from mpc_tpu_torch.ops import _build
    props = torch.cuda.get_device_properties(0)
    return _build.launch_budget(props), props.multi_processor_count


def admm_geometry(torch, a, layout=None):
    """The launch geometry a sweep on these inputs takes (``layout`` None:
    the wrapper's choice)."""
    from mpc_tpu_torch.ops import admm_kernel
    n, m, s = a["x"].shape[1], a["z"].shape[1], a["x"].element_size()
    return admm_kernel.launch_geometry(a["lane_ctrl"], n, m, s, *card_geometry(torch), layout)


def gi_geometry(torch, args, layout=None):
    """The launch geometry a GI solve on these inputs takes."""
    from mpc_tpu_torch.ops import gi_kernel
    Pinv, A, lc, q, l = args[:5]
    return gi_kernel.launch_geometry(lc, q.shape[1], l.shape[1], args[6].shape[1],
                                     A.element_size(), Pinv.element_size(),
                                     *card_geometry(torch), layout,
                                     args[16] if len(args) > 16 else None)


def admm_residency(torch, ops, _build, a, layout=None):
    """Lanes resident per SM for a sweep launch on these inputs (the
    runtime's occupancy calculator at the launch's geometry and layout)."""
    s = a["x"].element_size()
    table, block_ctrl, warps, grouped, smem, layout = admm_geometry(torch, a, layout)
    own = block_ctrl is None
    blocks = _build.load_library().mpc_admm_blocks_per_sm(
        int(s == 8), _build.LAYOUT_CODE[layout], int(grouped), table.shape[1], 32 * warps, smem,
        int(own), a["x"].shape[1])
    return blocks * table.shape[1], dict(blocks_per_sm=blocks, lanes_per_block=table.shape[1],
                                         threads=32 * warps, grouped=grouped,
                                         smem_bytes=smem, layout=layout, per_lane=own)


def gi_residency(torch, _build, args, layout=None):
    Pinv, A = args[:2]
    table, block_ctrl, warps, smem, layout = gi_geometry(torch, args, layout)
    own = block_ctrl is None
    variant = {(4, 8): 0, (4, 4): 1, (8, 8): 2}[(A.element_size(), Pinv.element_size())]
    mode = 2 if own else int(len(args) > 16 and layout == "resident")
    blocks = _build.load_library().mpc_gi_blocks_per_sm(variant, _build.LAYOUT_CODE[layout],
                                                        warps, smem, mode)
    return blocks * warps, dict(blocks_per_sm=blocks, warps=warps,
                                lanes_per_block=table.shape[1], smem_bytes=smem,
                                layout=layout, per_lane=own,
                                a_map=len(args) > 16)


class _Captured(Exception):
    pass


Y_WARM = 1e-2      # a captured sweep must start from max|y| ≥ Y_WARM on its
                    # active lanes


class Capture:
    """Wraps an ADMM sweep: records the inputs of the first call that starts
    from a warm dual (max|y| ≥ Y_WARM on the active lanes) with the lockstep
    mask mixed (at least 5 % of the lanes already frozen), and stops the
    step there.
    Earlier calls run the wrapped sweep."""

    def __init__(self, sweep):
        self.sweep, self.args = sweep, None

    def __call__(self, *args):
        y, active = args[10], args[11]
        n_on = int(active.sum())
        if 0 < n_on <= 0.95 * active.numel() and y[active].abs().max().item() >= Y_WARM:
            self.args = [a.clone() if hasattr(a, "clone") else a for a in args]
            raise _Captured
        self.sweep(*args)


def steady_inputs(torch, fleet, ctrls, reps, periods=4):
    """Sweep inputs of a steady closed-loop period: ``periods`` periods from
    the fleet's current state, then the next one up to its capture.

    The setpoints are 5x the closed loop's usual ones, more than the bounded
    inputs reach: the input bounds then hold in steady state and the duals
    stay nonzero (at the usual setpoints no bound is active once the
    transient is over, and y is 0).  The fleet's state is restored
    afterwards."""
    loop = ClosedLoop(torch, ctrls, reps, fleet.device, fleet.dtype, ry_scale=5.0)
    snap = fleet.state
    try:
        for k in range(periods):
            u, _ = fleet.step(*loop.measure(k))
            loop.advance(u)
        args = capture_sweep(fleet, *loop.measure(periods))
    finally:
        fleet.state = snap
    check(args is not None, "no ADMM sweep of the steady period started from a "
          "warm dual with the lane mask mixed")
    return args


def capture_sweep(fleet, ym, ry):
    """The inputs of the sweep that ``Capture`` takes in the fleet's next
    period (``fleet.step(ym, ry)``), or None; the fleet's state is left as
    it was."""
    snap = fleet.state
    cap = Capture(fleet.sweep)
    try:
        fleet.sweep = cap
        fleet.step(ym, ry)
    except _Captured:
        pass
    finally:
        fleet.sweep = cap.sweep
        fleet.state = snap
    return cap.args


SWEEP_ARGS = ("Minvs", "A", "lane_ctrl", "rung", "q", "l", "u", "rhovs", "x",
              "z", "y", "active")
LANE_ARGS = ("lane_ctrl", "rung", "q", "l", "u", "x", "z", "y", "active")


def tile_lanes(args, k):
    """Sweep inputs with every lane repeated ``k`` times: the same
    controllers, each with k times as many lanes."""
    base = dict(zip(SWEEP_ARGS, args[:12]))
    return [base[a].repeat(k, *[1] * (base[a].dim() - 1)).contiguous() if a in LANE_ARGS
            else base[a] for a in SWEEP_ARGS] + list(args[12:])


def sweep_errors(torch, ops, name, args, at_floor=False):
    """Kernel and plain sweep on the same inputs, array by array.

    Each of x, z and y must agree to F32_TOL·(1 + its own max|plain|); the
    lanes masked off must come back bit-unchanged from both.  ``floor`` is
    the plain float32 sweep's distance to the same sweep in float64: the
    rounding noise the bar has to admit.

    ``at_floor``, for a float32 shape whose floor exceeds that bar (the
    8x8 fleet at Hp=60, where the ρ ladder's Minv reaches a condition
    number of ~7e3): each array of the kernel's float32 sweep must lie
    within floor + F32_TOL·(1 + max|f64|) of the float64 sweep — no
    farther than the plain float32 sweep lies from it — and the kernel run
    in float64 on the same inputs must agree with the plain float64 sweep
    to 1e-10·(1 + max|plain|), which checks its arithmetic at this
    shape.  The floor after one sweep is printed beside F32_TOL's bar: it
    shows whether fewer sweeps would bring the float32 check under that
    bar."""
    base = dict(zip(SWEEP_ARGS, args[:12]))
    iters, sigma, alpha = args[12:]
    runs = {}
    versions = [("kernel", ops.admm_sweep, None), ("plain", ops.admm_sweep_reference, None),
                ("f64", ops.admm_sweep_reference, torch.float64)]
    if at_floor:
        versions.append(("kernel f64", ops.admm_sweep, torch.float64))
    for label, fn, dt in versions:
        a = {k: (v.to(dt) if dt is not None and v.is_floating_point() else v.clone())
             for k, v in base.items()}
        fn(*(a[k] for k in SWEEP_ARGS), iters, sigma, alpha)
        runs[label] = a
    if at_floor:
        one = {}
        for label, dt in (("f32", None), ("f64", torch.float64)):
            a = {k: (v.to(dt) if dt is not None and v.is_floating_point() else v.clone())
                 for k, v in base.items()}
            ops.admm_sweep_reference(*(a[k] for k in SWEEP_ARGS), 1, sigma, alpha)
            one[label] = a
        print(f"{name}: after one sweep the plain float32 floor is "
              + ", ".join(f"{k} {(one['f32'][k].double() - one['f64'][k]).abs().max().item():.3e}"
                          f" (F32_TOL bar {F32_TOL * (1 + one['f32'][k].abs().max().item()):.3e})"
                          for k in ("x", "z", "y")), flush=True)
    off = ~base["active"]
    worst, parts = 0.0, []
    for k in ("x", "z", "y"):
        ker, pln, f64 = runs["kernel"][k], runs["plain"][k], runs["f64"][k]
        err = (ker - pln).abs().max().item()
        tol = F32_TOL * (1.0 + pln.abs().max().item())
        floor = (pln.double() - f64).abs().max().item()
        if at_floor:
            dist = (ker.double() - f64).abs().max().item()
            tol = floor + F32_TOL * (1.0 + f64.abs().max().item())
            check(np.isfinite(dist) and dist <= tol, f"{name}: the kernel's float32 sweep "
                  f"is {dist:.3e} from the float64 one on {k} > {tol:.3e}")
            e64 = (runs["kernel f64"][k] - f64).abs().max().item()
            tol64 = 1e-10 * (1.0 + f64.abs().max().item())
            check(np.isfinite(e64) and e64 <= tol64, f"{name}: kernel and plain sweep in "
                  f"float64 disagree on {k}: {e64:.3e} > {tol64:.3e}")
            parts.append(f"{k} {err:.3e} (kernel to float64 {dist:.3e}, tol {tol:.3e}, f32 "
                         f"floor {floor:.3e}; in float64 {e64:.3e}, tol {tol64:.3e})")
        else:
            check(np.isfinite(err) and err <= tol,
                  f"{name}: kernel and plain sweep disagree on {k}: {err:.3e} > {tol:.3e}")
            parts.append(f"{k} {err:.3e} (tol {tol:.3e}, f32 floor {floor:.3e})")
        for label in runs:
            check(torch.equal(runs[label][k][off], base[k][off].to(runs[label][k].dtype)),
                  f"{name}: the {label} sweep moved {k} of masked-off lanes")
        worst = max(worst, err)
    B = base["x"].shape[0]
    on = base["active"]
    warm = int((base["y"][on].abs().amax(1) >= Y_WARM).sum())
    print(f"kernel check {name}: {int(on.sum())}/{B} lanes active, {warm} of "
          f"them from |y| ≥ {Y_WARM:g} (max|y| {base['y'][on].abs().max().item():.3e}); "
          f"max |kernel - plain|: "
          + ", ".join(parts), flush=True)
    return worst


def kernel_vs_plain(torch, ops, name, args, at_floor=False):
    """Kernel and plain sweep on the same CUDA inputs: error and times."""
    names = SWEEP_ARGS
    base = dict(zip(names, args[:12]))
    iters, sigma, alpha = args[12:]
    err = sweep_errors(torch, ops, name, args, at_floor)
    torch.cuda.synchronize()

    def fresh():
        return {k: v.clone() for k, v in base.items()}

    holder = {}

    def setup():
        holder["a"] = fresh()

    def timed(fn):
        return lambda: fn(*(holder["a"][k] for k in names), iters, sigma, alpha)

    ms_k = median_ms(torch, timed(ops.admm_sweep), setup)
    ms_p = median_ms(torch, timed(ops.admm_sweep_reference), setup)
    ms_d = device_ms(torch, timed(ops.admm_sweep), setup, ADMM_KERNELS,
                     launches=lambda: ops.LAUNCHES["admm_sweep"])
    ms_e = launch_event_ms(torch, "admm_sweep", timed(ops.admm_sweep), setup)
    b_ms, b_by = admm_bound(torch, base, iters)
    B, n = base["x"].shape
    m = base["z"].shape[1]
    print(f"kernel time {name}: B={B} n={n} m={m} n_d={base['A'].shape[0]} "
          f"iters={iters} kernel {ms_d:.4f} ms device (profiler), {ms_e:.4f} ms by events "
          f"around the launch, {ms_k:.4f} ms call (CUDA events); plain {ms_p:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}), roofline share {b_ms / ms_d:.4f}", flush=True)
    return dict(err=err, ms=ms_d, event_ms=ms_e, call_ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, args=base, tail=(iters, sigma, alpha))


def pallas_test_batch(torch, dev):
    """The batch of tests/test_pallas_qp.py (n=4, m=8, B=128, 600 sweeps)."""
    rng = np.random.default_rng(0)
    n, m, B = 4, 8, 128
    H = rng.normal(size=(B, n, n)).astype(np.float32)
    P = H @ H.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    q = rng.normal(size=(B, n)).astype(np.float32)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    xf = (rng.normal(size=(B, n)) * 0.1).astype(np.float32)
    Ax = np.einsum("bmn,bn->bm", A, xf)
    l, u = (Ax - 0.2).astype(np.float32), (Ax + 0.6).astype(np.float32)
    rho = np.full((B, m), 0.1, np.float32)
    Minv = np.linalg.inv(P + 1e-6 * np.eye(n, dtype=np.float32)
                         + np.einsum("bmn,bm,bmk->bnk", A, rho, A)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=dev)
    x = torch.zeros(B, n, device=dev)
    z = torch.clamp(torch.zeros(B, m, device=dev), t(l), t(u))
    return [t(Minv[:, None]), t(A), torch.arange(B, dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev), t(q), t(l), t(u),
            t(rho[:, None]), x, z, torch.zeros(B, m, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev), 600, 1e-6, 1.6]


def large_controllers(mt, n, nio=8, Hp=15, Hc=4, seed=0, qp_solver="admm",
                      gi_max_active=None, kalman=False, **kw):
    """The 8x8 / Hp=15 configuration of bench.py (``_large_plant_controllers``),
    constructed by the port itself; ``qp_solver`` and ``gi_max_active`` pass
    through as bench.py passes them.  ``kalman`` puts a KalmanFilter in
    place of the default SteadyKalmanFilter; ``kw`` (dtype, device) goes to
    LinMPC."""
    rng = np.random.default_rng(seed)
    ctrls = []
    for _ in range(n):
        A = np.diag(rng.uniform(0.45, 0.8, nio))
        A += rng.normal(size=(nio, nio)) * 0.02
        A *= min(1.0, 0.85 / np.max(np.abs(np.linalg.eigvals(A))))
        Bu = rng.normal(size=(nio, nio)) * 0.5 + np.eye(nio)
        model = mt.LinModel(mt.ss(A, Bu, np.eye(nio), np.zeros((nio, nio)), 2.0), 2.0)
        c = mt.LinMPC(mt.KalmanFilter(model) if kalman else model, Hp=Hp, Hc=Hc,
                      Mwt=np.ones(nio), Nwt=np.full(nio, 1.0), Cwt=1e3,
                      qp_solver=qp_solver, gi_max_active=gi_max_active, **kw)
        c.setconstraint(umin=np.full(nio, -10.0), umax=np.full(nio, 10.0),
                        dumin=np.full(nio, -4.0), dumax=np.full(nio, 4.0),
                        ymin=np.full(nio, -60.0), ymax=np.full(nio, 60.0))
        ctrls.append(c)
    return ctrls


class ClosedLoop:
    """Per-lane true plants (lane = r·n_d + c) with 4 rotating setpoint and
    noise phases, as bench.py's closed-loop regime (bench.py:118-125,
    160-168, 189-206); ``ry_scale`` scales the setpoints."""

    def __init__(self, torch, ctrls, reps, dev, dtype, seed=1, ry_scale=1.0):
        st = lambda k: np.tile(np.stack([getattr(c.estim.model, k) for c in ctrls]),
                               (reps, 1, 1))
        t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=dev)
        self.torch = torch
        self.A, self.Bu, self.C = t(st("A")), t(st("Bu")), t(st("C"))
        B, ny = self.C.shape[0], self.C.shape[1]
        rng = np.random.default_rng(seed)
        ry0 = rng.normal(size=(B, ny)) * 2.0
        self.phases = [(t(rng.normal(size=(B, ny)) * 0.1),
                        t((ry0 + rng.normal(size=(B, ny)) * 0.2) * ry_scale))
                       for _ in range(4)]
        self.x = torch.zeros(B, self.A.shape[1], dtype=dtype, device=dev)

    def measure(self, k):
        noise, ry = self.phases[k % 4]
        return self.torch.einsum("bij,bj->bi", self.C, self.x) + noise, ry

    def advance(self, u):
        e = self.torch.einsum
        self.x = e("bij,bj->bi", self.A, self.x) + e("bij,bj->bi", self.Bu, u)


def small_fleet_check(torch, BatchedLinMPC, ctrls, label):
    """A small float64 fleet on the card (kernels) against the same fleet on
    the CPU (plain versions, which the CPU tests hold to the reference):
    5 closed-loop periods, u to 1e-6, equal n_conv."""
    fl = {d: BatchedLinMPC(ctrls, reps=2, device=d, dtype=torch.float64)
          for d in ("cuda", "cpu")}
    loops = {d: ClosedLoop(torch, ctrls, 2, d, torch.float64) for d in fl}
    B = fl["cpu"].B
    worst = 0.0
    for k in range(5):
        out = {}
        for d in fl:
            ym, ry = loops[d].measure(k)
            u, nc = fl[d].step(ym, ry)
            loops[d].advance(u)
            out[d] = (u.cpu(), int(nc))
        worst = max(worst, (out["cuda"][0] - out["cpu"][0]).abs().max().item())
        check(out["cuda"][1] == out["cpu"][1] == B,
              f"{label}: n_conv card {out['cuda'][1]} cpu {out['cpu'][1]}")
    check(worst < 1e-6, f"{label}: card vs CPU |Δu| {worst:.3e} ≥ 1e-6")
    print(f"{label} ({len(ctrls)}x2 lanes, 5 periods): card vs CPU max |du| "
          f"{worst:.3e} (bar 1e-6)", flush=True)


def drive(torch, ops, name, fleet, loop, n_step, K=4, conv_bar=0.99):
    """THE MAIN PATH of one fleet: a first period from rest, then — with the
    launch counts set to 0 — ``n_step`` closed-loop ``step`` periods and one
    ``multistep(K)``.  Fails on non-finite u or a last period below
    ``conv_bar``·B converged (None: reported only).  Returns the launch
    counts, the median solves/s and the last period's converged count."""
    B = fleet.B
    zero = torch.zeros(B, fleet.nym, device=fleet.device, dtype=fleet.dtype)
    u, _ = fleet.step(zero, torch.zeros(B, fleet.ny, device=fleet.device,
                                        dtype=fleet.dtype))
    loop.advance(u)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rates, finite = [], True
    for k in range(n_step):
        ym, ry = loop.measure(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, nc = fleet.step(ym, ry)
        n_conv = int(nc)
        dt = time.perf_counter() - t0
        it = fleet.last_iters.tolist()
        finite &= bool(torch.isfinite(u).all())
        loop.advance(u)
        rates.append(B / dt)
        print(f"{name} period {k:2d}: n_conv {n_conv}/{B} iters max {it[0]} mean {it[1]} "
              f"step {dt * 1e3:.2f} ms {B / dt:.0f} solves/s", flush=True)
    # K periods in one call: the plant state is measured once, the noise
    # and setpoint phases rotate
    meas = [loop.measure(n_step + i) for i in range(K)]
    ym_k = torch.stack([m_[0] for m_ in meas])
    ry_k = torch.stack([m_[1] for m_ in meas])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, NC = fleet.multistep(ym_k, ry_k)
    NC = NC.tolist()
    dt = time.perf_counter() - t0
    for i in range(K):
        finite &= bool(torch.isfinite(U[i]).all())
        loop.advance(U[i])
    n_conv = NC[-1]
    it = fleet.last_iters.tolist()
    print(f"{name} multistep K={K}: n_conv {NC} last iters max {it[0]} mean {it[1]} "
          f"{dt * 1e3:.2f} ms {K * B / dt:.0f} solves/s", flush=True)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    med = statistics.median(rates)
    print(f"{name} main path: {n_step + K} periods, kernel launches {launches}, "
          f"median {med:.0f} solves/s over the {n_step} step periods", flush=True)
    check(finite, f"{name} main path: non-finite u")
    check(conv_bar is None or n_conv >= conv_bar * B,
          f"{name} main path: last period n_conv {n_conv} < {conv_bar}·{B}")
    check(U.shape == (K, B, fleet.nu), f"{name}: multistep U has shape {tuple(U.shape)}")
    return launches, med, n_conv


def plain_period(torch, name, fleet, loop, attr, kernel_fn, plain_fn):
    """One more period from the same snapshot with the kernel and with the
    plain version on the card (kernel, plain, plain, kernel): every lane's
    u must agree to 1e-4."""
    snap = fleet.state
    ym, ry = loop.measure(10_000)
    res = {}
    for label in ("kernel", "plain", "plain", "kernel"):
        fleet.state = snap
        setattr(fleet, attr, kernel_fn if label == "kernel" else plain_fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, nc = fleet.step(ym, ry)
        nc = int(nc)
        res.setdefault(label, []).append((u, nc, time.perf_counter() - t0))
    setattr(fleet, attr, kernel_fn)
    B = fleet.B
    u_k, nc_k, _ = res["kernel"][0]
    u_p, nc_p, _ = res["plain"][0]
    check(bool(torch.isfinite(u_p).all()), f"{name}: plain version on the card: non-finite u")
    bad = ((u_k - u_p).abs().amax(1) > 1e-4).nonzero().flatten().tolist()
    t_k = statistics.mean(r[2] for r in res["kernel"])
    t_p = statistics.mean(r[2] for r in res["plain"])
    print(f"{name}, plain version on the card, same period: {B - len(bad)}/{B} lanes' "
          f"u agree with the kernel path to 1e-4 (max |du| "
          f"{(u_k - u_p).abs().max().item():.3e}); n_conv kernel {nc_k} plain {nc_p}; "
          f"step kernel {t_k * 1e3:.2f} ms ({B / t_k:.0f} solves/s) plain "
          f"{t_p * 1e3:.2f} ms ({B / t_p:.0f} solves/s)", flush=True)
    check(not bad, f"{name}: plain version on the card: lanes {bad[:20]} (of "
          f"{len(bad)}) disagree with the kernel path by more than 1e-4")


def _clone(args):
    return [a.clone() if hasattr(a, "clone") else a for a in args]


def gi_steady_inputs(torch, fleet, ctrls, reps, periods=4):
    """GI solve inputs of a steady closed-loop period: ``periods`` periods
    from the fleet's current state, then the inputs (carried operator state
    included) of the next one's solve.  The setpoints are 5x the usual ones
    so that bounds are active.  The fleet's state is restored afterwards."""
    loop = ClosedLoop(torch, ctrls, reps, fleet.device, fleet.dtype, ry_scale=5.0)
    snap = fleet.state
    try:
        for k in range(periods):
            u, _ = fleet.step(*loop.measure(k))
            loop.advance(u)
        return capture_gi(fleet, *loop.measure(periods))
    finally:
        fleet.state = snap


def capture_gi(fleet, ym, ry):
    """The inputs (carried operator state included) of the GI solve of the
    fleet's next period (``fleet.step(ym, ry)``); the fleet's state is left
    as it was."""
    snap = fleet.state
    inner, rec = fleet.gi, {}

    def capture(*args):
        rec["args"] = _clone(args)
        return inner(*args)
    try:
        fleet.gi = capture
        fleet.step(ym, ry)
    finally:
        fleet.gi = inner
        fleet.state = snap
    check("args" in rec, "no GI solve was captured")
    return rec["args"]


def gi_random_inputs(torch, ops, dev, B=4096, n=6, m=24, cap=3):
    """float64 random QPs of the tests/test_qp.py kind, one per lane, with
    dual warm starts — a cold solve's duals on a third of the lanes, the
    same plus junk on a third, junk alone on the rest — and a slot cap of 3
    below many lanes' active-set sizes, so warm rows overflow and spend the
    cold restart.  Returns the inputs of the capped solve."""
    rng = np.random.default_rng(0)
    H = rng.normal(size=(B, n, n))
    P = H @ H.transpose(0, 2, 1) + n * np.eye(n)
    A = rng.normal(size=(B, m, n))
    Ax = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.1)
    margin = rng.uniform(0.05, 1.0, size=(B, m))
    l = np.where(rng.random((B, m)) < 0.3, -1e20, Ax - margin)
    Pinv = np.linalg.inv(P)
    Pinv = Pinv @ (2.0 * np.eye(n) - P @ Pinv)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    prob = (t(P), t(rng.normal(size=(B, n))), t(A), t(l), t(Ax + margin))
    cache = dict(gic_Pinv=t(Pinv))
    cold = ops.solve_qp_active(*prob, cache=cache, solve=ops.gi_solve_reference)
    junk = t(rng.normal(size=(B, m)) * (rng.random((B, m)) < 0.2))
    part = (torch.arange(B, device=dev) % 3)[:, None]
    y0 = torch.where(part == 0, cold.y, torch.where(part == 1, cold.y + junk, junk))
    rec = {}

    def capture(*args):
        rec["args"] = _clone(args)
        return ops.gi_solve_reference(*args)
    ops.solve_qp_active(*prob, y0, cache=cache, max_active=cap, solve=capture)
    return rec["args"]


def gi_vs_plain(torch, ops, name, args, f64):
    """The GI kernel and its plain version on fresh copies of the same CUDA
    inputs: the bars, and both times (CUDA events, median of 25).

    float64 (``f64``): x to 1e-9·(1 + max|x|), iterations and converged
    flags equal on every lane.  Fleet shapes: the converged flag equal on
    all but GI_FLIPS lanes (listed with both iteration counts) and x to
    F32_TOL·(1 + max|x_plain|) where both converged."""
    runs = {}
    for label, fn in (("kernel", ops.gi_solve), ("plain", ops.gi_solve_reference)):
        a = _clone(args)
        x, lam, it, conv = fn(*a)
        runs[label] = dict(x=x, it=it, conv=conv, idx=a[6])
    torch.cuda.synchronize()
    k, p = runs["kernel"], runs["plain"]
    B, n = p["x"].shape
    m, ns = args[4].shape[1], args[6].shape[1]
    x_scale = 1.0 + p["x"].abs().max().item()
    flips = (k["conv"] != p["conv"]).nonzero().flatten().tolist()
    same_it = int((k["it"] == p["it"]).sum())
    entering = int(args[8].any(1).sum())
    warm_rows = int((args[12] > 0).sum())
    if f64:
        err = (k["x"] - p["x"]).abs().max().item()
        tol = GI_F64_TOL * x_scale
    else:
        both = k["conv"] & p["conv"]
        err = (k["x"] - p["x"])[both].abs().max().item() if bool(both.any()) else 0.0
        tol = F32_TOL * x_scale
    print(f"GI kernel check {name}: B={B} n={n} m={m} slots={ns} data "
          f"{args[1].dtype} slots {args[9].dtype}; {entering}/{B} lanes enter with "
          f">= 1 valid slot, {warm_rows}/{B} with >= 1 warm row; converged kernel {int(k['conv'].sum())} plain "
          f"{int(p['conv'].sum())}; equal iterations on {same_it}/{B} lanes "
          f"({same_it / B:.4f}), iterations max kernel {int(k['it'].max())} plain "
          f"{int(p['it'].max())}; equal active sets on "
          f"{int((k['idx'] == p['idx']).all(1).sum())}/{B}; max |x kernel - x plain| "
          f"{err:.3e} (tol {tol:.3e})", flush=True)
    if flips:
        print(f"  converged flag differs on lanes {flips}: iterations kernel "
              f"{k['it'][flips].tolist()} plain {p['it'][flips].tolist()}")
    check(np.isfinite(err) and err <= tol,
          f"{name}: GI kernel and plain disagree on x: {err:.3e} > {tol:.3e}")
    if f64:
        check(same_it == B, f"{name}: iterations differ on {B - same_it} lanes")
        check(not flips, f"{name}: converged differs on lanes {flips[:20]}")
    else:
        check(len(flips) <= GI_FLIPS, f"{name}: converged differs on {len(flips)} "
              f"lanes (at most {GI_FLIPS} allowed)")
    holder = {}

    def setup():
        holder["a"] = _clone(args)
    ms_k = median_ms(torch, lambda: ops.gi_solve(*holder["a"]), setup)
    ms_p = median_ms(torch, lambda: ops.gi_solve_reference(*holder["a"]), setup)
    ms_d = device_ms(torch, lambda: ops.gi_solve(*holder["a"]), setup, GI_KERNELS,
                     launches=lambda: ops.LAUNCHES["gi_solve"])
    ms_e = launch_event_ms(torch, "gi_solve", lambda: ops.gi_solve(*holder["a"]), setup)
    b_ms, b_by = gi_bound(torch, args, k["it"])
    print(f"GI kernel time {name}: kernel {ms_d:.4f} ms device (profiler), {ms_e:.4f} ms by "
          f"events around the launch, {ms_k:.4f} ms call (CUDA events); plain {ms_p:.4f} ms; "
          f"pivots mean {k['it'].float().mean().item():.2f}; bound {b_ms:.4f} ms ({b_by}), "
          f"roofline share {b_ms / ms_d:.4f}", flush=True)
    out = dict(err=err, ms=ms_d, event_ms=ms_e, call_ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
               bound_by=b_by, entering=entering, B=B, args=args)
    _, n_r, n_a = gi_distinct(torch, args)
    if n_a < n_r:
        # the copies of one A that the lane map makes the kernel read: not
        # work the function needs, so not in the bound
        dup = (n_r - n_a) * m * n * args[1].element_size()
        out.update(copied_A_bytes=dup, copied_A_ms=dup / HBM_BPS * 1e3)
        print(f"GI {name}: {n_r} lanes read {n_r - n_a} copies of one A, {dup / 1e6:.2f} MB, "
              f"{out['copied_A_ms']:.4f} ms at the memory rate (outside the bound)", flush=True)
    return out


def layouts(torch, dev, B=1024, seed=0):
    """The lane → controller maps beyond the tiled fleet: one shared
    controller (n_d = 1), one controller per lane (n_d = B, the uncached
    solves), ragged groups of 1 to 40 lanes in shuffled order (group sizes
    that are no multiple of a block's width) and a single lane (B = 1)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 41, size=64)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), B) + 1]
    ragged = np.repeat(np.arange(sizes.size), sizes)[:B]
    rng.shuffle(ragged)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return {"n_d=1": i32(np.zeros(B)), "n_d=B": i32(np.arange(B)),
            "ragged": i32(ragged), "B=1": i32([0])}


def layout_sweep_inputs(torch, dev, lc, n, m, dtype, n_lad=9, seed=0):
    """Sweep inputs on a per-controller ρ ladder, a random rung per lane,
    a warm start and a fifth of the lanes frozen (10 sweeps)."""
    rng = np.random.default_rng(seed)
    lcn = lc.cpu().numpy()
    B, n_d = lcn.size, int(lcn.max()) + 1
    H = rng.normal(size=(n_d, n, n))
    A = rng.normal(size=(n_d, m, n))
    rhovs = (0.1 * np.logspace(-2, 2, n_lad))[None, :, None] * np.ones((n_d, 1, m))
    Minvs = np.linalg.inv((H @ H.transpose(0, 2, 1) + n * np.eye(n))[:, None]
                          + np.einsum("dmn,dkm,dmj->dknj", A, rhovs, A))
    x = rng.normal(size=(B, n)) * 0.1
    Ax = np.einsum("bmn,bn->bm", A[lcn], x)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    return [t(Minvs), t(A), lc, torch.tensor(rng.integers(0, n_lad, B), dtype=torch.int32,
                                             device=dev),
            t(rng.normal(size=(B, n))), t(Ax - 0.2), t(Ax + 0.6), t(rhovs), t(x), t(Ax),
            t(rng.normal(size=(B, m)) * 0.5),
            torch.tensor(rng.random(B) >= 0.2, device=dev), 10, 1e-6, 1.6]


def gi_layout_inputs(torch, ops, dev, lc, n=6, m=24, cap=3, seed=0, **kw):
    """float64 GI solve inputs of gi_random_inputs' kind with P and A per
    controller of ``lc`` (bounds per lane, around its controller's rows) and
    junk dual warm starts on half the lanes (``kw``: more ``solve_qp_active``
    options)."""
    rng = np.random.default_rng(seed)
    lcn = lc.cpu().numpy()
    B, n_d = lcn.size, int(lcn.max()) + 1
    H = rng.normal(size=(n_d, n, n))
    P = H @ H.transpose(0, 2, 1) + n * np.eye(n)
    A = rng.normal(size=(n_d, m, n))
    Ax = np.einsum("bmn,bn->bm", A[lcn], rng.normal(size=(B, n)) * 0.1)
    margin = rng.uniform(0.05, 1.0, size=(B, m))
    l = np.where(rng.random((B, m)) < 0.3, -1e20, Ax - margin)
    Pinv = np.linalg.inv(P)
    Pinv = Pinv @ (2.0 * np.eye(n) - P @ Pinv)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    y0 = t(rng.normal(size=(B, m)) * (rng.random((B, 1)) < 0.5))
    rec = {}

    def capture(*args):
        rec["args"] = _clone(args)
        return ops.gi_solve_reference(*args)
    ops.solve_qp_active(t(P), t(rng.normal(size=(B, n))), t(A), t(l), t(Ax + margin), y0,
                        lane_ctrl=lc, cache=dict(gic_Pinv=t(Pinv)), max_active=cap,
                        solve=capture, **kw)
    return rec["args"]


def sweep_layout_check(torch, ops, dev, lname, lc, n, m, dt, warp_lanes):
    """The sweep kernel against its plain version on ``layout_sweep_inputs``
    for the lane map ``lc``, with ``admm_kernel.WARP_LANES_PER_SM`` set to
    ``warp_lanes`` for the call: x, z, y to F32_TOL·(1 + max|plain|) in
    float32 and 1e-10 in float64, frozen lanes bit-unchanged.  Returns the
    largest error."""
    from mpc_tpu_torch.ops import admm_kernel
    default = admm_kernel.WARP_LANES_PER_SM
    variant = "warp a lane" if n <= 32 and warp_lanes == 0 else "lanes in step"
    admm_kernel.WARP_LANES_PER_SM = warp_lanes
    args = layout_sweep_inputs(torch, dev, lc, n, m, dt)
    base = dict(zip(SWEEP_ARGS, args[:12]))
    runs = {}
    try:
        for label, fn in (("kernel", ops.admm_sweep), ("plain", ops.admm_sweep_reference)):
            a = {k: v.clone() for k, v in base.items()}
            fn(*(a[k] for k in SWEEP_ARGS), *args[12:])
            runs[label] = a
        torch.cuda.synchronize()
    finally:
        admm_kernel.WARP_LANES_PER_SM = default
    off = ~base["active"]
    errs = []
    for k in ("x", "z", "y"):
        ker, pln = runs["kernel"][k], runs["plain"][k]
        err = (ker - pln).abs().max().item()
        tol = (F32_TOL * (1.0 + pln.abs().max().item())
               if dt == torch.float32 else 1e-10)
        check(np.isfinite(err) and err <= tol, f"sweep layout {lname} n={n} m={m} "
              f"{dt}: {k} differs by {err:.3e} > {tol:.3e}")
        for label in runs:
            check(torch.equal(runs[label][k][off], base[k][off]),
                  f"sweep layout {lname} n={n}: the {label} sweep moved frozen {k}")
        errs.append(err)
    print(f"sweep layout {lname}: B={lc.numel()} n_d={int(lc.max()) + 1} n={n} "
          f"m={m} {dt} ({variant}): {int(base['active'].sum())} lanes active, frozen lanes "
          f"unchanged, max |kernel - plain| x/z/y "
          + " ".join(f"{e:.3e}" for e in errs), flush=True)
    return max(errs)


def layout_phase(torch, ops, dev):
    """3b: each kernel against its plain version on every lane layout of
    ``layouts``: the sweep at the headline (n=5, m=101) shape in float32
    and float64, each in both variants (a warp a lane and the lanes in step,
    forced through ``admm_kernel.WARP_LANES_PER_SM``), and at the 8x8/Hp=15
    (n=33, m=577) shape in float32 (F32_TOL·(1 + max|plain|) on each of x,
    z, y; 1e-10 in float64), frozen lanes bit-unchanged; then QPs wider than
    the lanes-in-step block's 256 threads (n=300, m=20, one controller, B=1
    and B=2112: one lane and two lanes a block) in both types; the GI
    solve on float64 random QPs (n=6, m=24, cap 3): equal flags, iterations
    and active sets, x to 1e-12·(1 + max|x|)."""
    from mpc_tpu_torch.ops import admm_kernel
    worst = {"admm_sweep": 0.0, "gi_solve": 0.0}
    default = admm_kernel.WARP_LANES_PER_SM
    i32 = lambda k: torch.zeros(k, dtype=torch.int32, device=dev)
    for lname, lc in (("wide B=1", i32(1)), ("wide n_d=1", i32(2112))):
        for dt in (torch.float32, torch.float64):
            worst["admm_sweep"] = max(worst["admm_sweep"], sweep_layout_check(
                torch, ops, dev, lname, lc, 300, 20, dt, default))
    for lname, lc in layouts(torch, dev).items():
        for n, m, dt, warp_lanes in ((5, 101, torch.float32, 0), (5, 101, torch.float32, 10**9),
                                     (33, 577, torch.float32, default),
                                     (5, 101, torch.float64, 0), (5, 101, torch.float64, 10**9)):
            worst["admm_sweep"] = max(worst["admm_sweep"], sweep_layout_check(
                torch, ops, dev, lname, lc, n, m, dt, warp_lanes))
        if lname == "n_d=B":
            continue          # the GI random_f64 case is this layout at B=4096
        args = gi_layout_inputs(torch, ops, dev, lc)
        out = {}
        for label, fn in (("kernel", ops.gi_solve), ("plain", ops.gi_solve_reference)):
            a = _clone(args)
            x, _, it, conv = fn(*a)
            out[label] = (x, it, conv, a[6])
        torch.cuda.synchronize()
        (xk, itk, ck, ik), (xp, itp, cp, ip) = out["kernel"], out["plain"]
        err = (xk - xp).abs().max().item()
        tol = 1e-12 * (1.0 + xp.abs().max().item())
        B = lc.numel()
        print(f"GI layout {lname}: B={B} n_d={int(lc.max()) + 1} f64 n=6 m=24 cap 3: "
              f"converged {int(ck.sum())}/{B}, equal flags {int((ck == cp).sum())}, "
              f"iterations {int((itk == itp).sum())}, active sets "
              f"{int((ik == ip).all(1).sum())}; max |x kernel - x plain| {err:.3e} "
              f"(tol {tol:.3e})", flush=True)
        check(torch.equal(ck, cp) and torch.equal(itk, itp) and torch.equal(ik, ip),
              f"GI layout {lname}: flags, iterations or active sets differ")
        check(np.isfinite(err) and err <= tol, f"GI layout {lname}: x differs by {err:.3e}")
        worst["gi_solve"] = max(worst["gi_solve"], err)
    return worst


SOLVERS = (("admm", "admm_sweep", "sweep"), ("active_set", "gi_solve", "gi"))


def readme_controller(mt, qp_solver, device):
    """README.md:9-21: the delayed two-output plant, LinMPC, y2 ≤ 35."""
    G = mt.tf_matrix([[mt.tf(2, [10, 1]) * mt.delay(20)], [mt.tf(10, [4, 1])]])
    ctrl = mt.LinMPC(mt.LinModel(G, 1.0), Mwt=[1, 0], Nwt=[0.1],
                     qp_solver=qp_solver, device=device)
    return ctrl.setconstraint(ymax=[np.inf, 35])


class Timed:
    """Replaces a controller's ``moveinput`` with a wrapper that records the
    host wall time of every call (a call ends in the copy of u to the
    host)."""

    def __init__(self, ctrl):
        self.fn, self.times = ctrl.moveinput, []
        ctrl.moveinput = self

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        u = self.fn(*args, **kw)
        self.times.append(time.perf_counter() - t0)
        return u


def single_kernel_inputs(ops, ctrl, key, ym, ry):
    """The inputs of the first kernel call of one more period of a single
    controller (a batch of one lane): its step runs with the kernel wrapped
    (``key`` is the step's ``sweep`` or ``gi`` argument)."""
    inner = ops.admm_sweep if key == "sweep" else ops.gi_solve
    rec = {}

    def capture(*args):
        rec.setdefault("args", _clone(args))
        return inner(*args)
    step = ctrl._step
    ctrl._step = functools.partial(step, **{key: capture})
    try:
        ctrl.preparestate(ym)
        ctrl.moveinput(ry)
    finally:
        ctrl._step = step
    check("args" in rec, f"no {key} call was captured")
    return rec["args"]


def readme_phase(torch, mt, ops, dev):
    """Phase 12.  Returns the launch counts of the two card runs, the
    per-backend median moveinput times and the B=1 kernel checks."""
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    out = {}
    for qp_solver, kernel, key in SOLVERS:
        ref = mt.sim(readme_controller(mt, qp_solver, "cpu"), 40, [5, 0])
        ctrl = readme_controller(mt, qp_solver, dev)
        timer = Timed(ctrl)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = mt.sim(ctrl, 40, [5, 0])
        run = dict(ops.LAUNCHES)
        for k in launches:
            launches[k] += run[k]
        check(res.U_data.shape == (40, 1) and np.isfinite(res.U_data).all()
              and np.isfinite(res.Y_data).all(),
              f"README {qp_solver}: non-finite or misshapen results")
        err = max(np.abs(res.U_data - ref.U_data).max(),
                  np.abs(res.Y_data - ref.Y_data).max())
        y = res.Y_data
        med = statistics.median(timer.times[5:])
        print(f"README sim {qp_solver} f64 on the card: kernel launches {run}; "
              f"card vs CPU max |du|, |dy| {err:.3e} (bar 1e-6); y1 end {y[-1, 0]:.6f}, "
              f"max y2 {y[:, 1].max():.6f}; moveinput median {med * 1e3:.3f} ms "
              f"(periods 5-40; min {min(timer.times[5:]) * 1e3:.3f} max "
              f"{max(timer.times[5:]) * 1e3:.3f}), solve_time of the last "
              f"{ctrl.getinfo()['solve_time'] * 1e3:.3f} ms", flush=True)
        check(run[kernel] >= 40, f"README {qp_solver}: the {kernel} kernel was "
              f"launched {run[kernel]} times in 40 periods")
        check(err < 1e-6, f"README {qp_solver}: card vs CPU {err:.3e} ≥ 1e-6")
        check(abs(y[-1, 0] - 5.0) < 1e-2 and y[:, 1].max() <= 35.0 + 1e-4,
              f"README {qp_solver}: y1 ends at {y[-1, 0]}, max y2 {y[:, 1].max()}")
        args = single_kernel_inputs(ops, ctrl, key, res.Y_data[-1], [5, 0])
        if key == "sweep":
            chk = kernel_vs_plain(torch, ops, "README B=1", args)
        else:
            chk = gi_vs_plain(torch, ops, "README B=1", args, True)
        out[qp_solver] = dict(chk, moveinput_ms=med * 1e3)
    return launches, out


def full_width_phase(torch, mt, ops, dev, periods=20):
    """Phase 13: one 8x8/Hp=15/Hc=4 controller with a KalmanFilter in
    float32, card and CPU side by side on one plant (driven by the CPU
    controller's u), the setpoint rotating every 5 periods."""
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    rng = np.random.default_rng(2)
    phases = [rng.normal(size=8) * 4.0 for _ in range(4)]
    for qp_solver, kernel, _ in SOLVERS:
        ctrls = [large_controllers(mt, 1, qp_solver=qp_solver, kalman=True,
                                   dtype=torch.float32, device=d)[0]
                 for d in (dev, "cpu")]
        plant = copy.deepcopy(ctrls[1].estim.model)
        timer = Timed(ctrls[0])
        worst, n_conv = 0.0, [0, 0]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(periods):
            ry = phases[(k // 5) % 4]
            ym = plant.evaloutput()
            us = []
            for i, c in enumerate(ctrls):
                c.preparestate(ym)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    us.append(c.moveinput(ry))
                n_conv[i] += bool(c.getinfo()["converged"])
            check(np.isfinite(us[0]).all(), f"8x8 {qp_solver}: non-finite u")
            err = np.abs(us[0] - us[1]).max()
            tol = F32_TOL * (1.0 + np.abs(us[1]).max())
            check(err <= tol, f"8x8 {qp_solver} period {k}: card vs CPU |du| "
                  f"{err:.3e} > {tol:.3e}")
            worst = max(worst, err / tol)
            plant.updatestate(us[1])
            for c, u in zip(ctrls, us):
                c.updatestate(u, ym)
        run = dict(ops.LAUNCHES)
        for k in launches:
            launches[k] += run[k]
        c = ctrls[0]
        print(f"8x8 single controller {qp_solver} f32 (QP n={c.n_qp} "
              f"m={c.A_stack.shape[0]}), {periods} periods: kernel launches {run}; "
              f"converged card {n_conv[0]} CPU {n_conv[1]}; card vs CPU worst "
              f"|du|/bar {worst:.3e}; moveinput median "
              f"{statistics.median(timer.times) * 1e3:.3f} ms", flush=True)
        check(run[kernel] >= periods, f"8x8 {qp_solver}: the {kernel} kernel was "
              f"launched {run[kernel]} times")
    return launches


def random_qps(torch, dev, B, n, m, n_eq=0, seed=0):
    """B float64 QPs of the tests/test_qp.py kind (one-sided rows, the first
    ``n_eq`` rows equalities), per-lane P and A, on the card."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(B, n, n))
    P = H @ H.transpose(0, 2, 1) + n * np.eye(n)
    A = rng.normal(size=(B, m, n))
    Ax = np.einsum("bmn,bn->bm", A, rng.normal(size=(B, n)) * 0.1)
    margin = rng.uniform(0.05, 1.0, size=(B, m))
    l = np.where(rng.random((B, m)) < 0.3, -1e20, Ax - margin)
    u = Ax + margin
    l[:, :n_eq] = u[:, :n_eq] = Ax[:, :n_eq]
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    return [t(P), t(rng.normal(size=(B, n))), t(A), t(l), t(u)]


def uncached_phase(torch, ops, dev, B=1024):
    """Phase 14.  The kernel-path call of each solve runs with the launch
    counts at 0; returns their sum and the checks."""
    from mpc_tpu_torch.ops.qp import solve_qp_batch
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    out = {}
    cases = (("admm", 6, 10, 2), ("gi n=6", 6, 24, 0), ("gi n=12", 12, 30, 0))
    for name, n, m, n_eq in cases:
        prob = random_qps(torch, dev, B, n, m, n_eq, seed=n)
        if name == "admm":
            fns = [functools.partial(solve_qp_batch, *prob, sweep=sw)
                   for sw in (ops.admm_sweep, ops.admm_sweep_reference)]
            bar = 1e-7
        else:
            fns = [functools.partial(ops.solve_qp_active, *prob, solve=fn)
                   for fn in (ops.gi_solve, ops.gi_solve_reference)]
            bar = 1e-9
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        k = fns[0]()
        torch.cuda.synchronize()
        run = dict(ops.LAUNCHES)
        for key in launches:
            launches[key] += run[key]
        p = fns[1]()
        x_scale = 1.0 + p.x.abs().max().item()
        err = (k.x - p.x).abs().max().item()
        same_it = int((k.iters == p.iters).sum())
        ms_k = median_ms(torch, fns[0], lambda: None, n=5)
        ms_p = median_ms(torch, fns[1], lambda: None, n=5)
        print(f"uncached {name}: B={B} n={n} m={m} float64, kernel launches {run}; "
              f"converged kernel {int(k.converged.sum())} plain {int(p.converged.sum())}; "
              f"equal iterations on {same_it}/{B} lanes (max {int(p.iters.max())}); "
              f"max |x kernel - x plain| {err:.3e} (tol {bar * x_scale:.3e}); solve "
              f"kernel {ms_k:.3f} ms plain {ms_p:.3f} ms", flush=True)
        check(sum(run.values()) > 0, f"uncached {name}: no kernel was launched")
        check(bool(p.converged.all()), f"uncached {name}: plain path left lanes unconverged")
        check(torch.equal(k.converged, p.converged), f"uncached {name}: converged flags differ")
        check(np.isfinite(err) and err <= bar * x_scale,
              f"uncached {name}: x differs by {err:.3e}")
        if name == "admm":
            check(same_it == B, f"uncached {name}: iterations differ on {B - same_it} lanes")
        out[name] = dict(err=err, ms=ms_k, plain_ms=ms_p)
    return launches, out


def deadline_phase(torch, mt, ops, dev):
    """Phase 15 (tests/test_deadline.py:44-71): Ts = 1 µs, 4 periods."""
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    for qp_solver, kernel, _ in SOLVERS:
        G = mt.ss(np.diag([0.6, 0.5, 0.7, 0.4]), np.eye(4), np.eye(4),
                  np.zeros((4, 4)), 1e-6)
        c = mt.LinMPC(mt.LinModel(G, 1e-6), Hp=10, Hc=4, Mwt=np.ones(4),
                      Nwt=np.full(4, 0.1), Cwt=1e3, limit_solve_time=True,
                      qp_solver=qp_solver, device=dev)
        c.setconstraint(umin=np.full(4, -0.3), umax=np.full(4, 0.3),
                        ymin=np.full(4, -0.2), ymax=np.full(4, 0.2))
        ry = np.full(4, 5.0)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(4):
            c.preparestate(np.full(4, 0.1 * k))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                u = c.moveinput(-ry if k % 2 else ry)
            c.updatestate(u, np.full(4, 0.1 * k))
        run = dict(ops.LAUNCHES)
        for k in launches:
            launches[k] += run[k]
        info = c.getinfo()
        print(f"deadline {qp_solver}: Ts 1 µs, kernel launches {run}; iter_budget "
              f"{info['iter_budget']}, iters {info['iters']}, deadline_miss "
              f"{info['deadline_miss']}, solve_time {info['solve_time'] * 1e3:.3f} ms",
              flush=True)
        check(np.isfinite(u).all(), f"deadline {qp_solver}: non-finite u")
        check(run[kernel] > 0, f"deadline {qp_solver}: the {kernel} kernel was never launched")
        check(info["iter_budget"] == 50, f"deadline {qp_solver}: budget "
              f"{info['iter_budget']} ≠ 50")
        check(info["deadline_miss"] is True, f"deadline {qp_solver}: no deadline miss")
    return launches


# --- the nonlinear-plant slice: SLMPC, the EKF and UKF, BatchedKalman ---------
PEND_P = (9.8, 0.4, 1.2, 0.3)
SL_BENCH = dict(Hp=15, Hc=2, Mwt=[0.5], Nwt=[2.5], sigmaQ=[0.1, 1.0], sigmaR=[5.0],
                sigmaQint_ym=[0.1])
SL_K = 8            # periods a window (bench.py's K periods a dispatch)


def pendulum(torch, mt, device):
    """bench.py's pendulum (bench.py:888-895): NonLinModel, RK4, Ts = 0.1 s,
    y the angle in degrees."""
    def f(x, u, d, par):
        g, L, K, m = par
        return torch.stack([x[1], -g / L * torch.sin(x[0]) - K / m * x[1]
                            + u[0] / (m * L ** 2)])

    h = lambda x, d, par: torch.stack([x[0] * 180 / torch.pi])
    return mt.NonLinModel(f, h, 0.1, 1, 2, 1, p=PEND_P, solver=mt.RungeKutta(4),
                          device=device)


def slmpc(torch, mt, device, qp_solver="active_set", dtype=None, **kw):
    """bench.py's SLMPC (bench.py:896-899), |u| ≤ 1.5."""
    c = mt.SLMPC(pendulum(torch, mt, device), qp_solver=qp_solver, dtype=dtype,
                 device=device, **{**SL_BENCH, **kw})
    return c.setconstraint(umin=[-1.5], umax=[1.5])


class SLMPCFleet:
    """An SLMPC fleet of B lanes (bench.py:879-953): ``step(ym, ry)`` runs
    one period of ``make_fleet_step`` and returns ``(u, n_conv)``;
    ``state`` is the fleet's state dict.  ``gi`` and ``sweep`` are the
    per-lane solve and the ADMM sweep its QP calls, as BatchedLinMPC's
    attributes of those names (checks swap in the plain versions): a period
    passes them to the controller module's ``solve_qp_active`` and
    ``solve_qp``."""

    def __init__(self, torch, ctrl, B):
        from mpc_tpu_torch import ops
        self.B = B
        self.state = ctrl.fleet_state(B)
        self.bounds = ctrl.bounds()
        self.d = torch.zeros(B, 0, dtype=ctrl.dtype, device=ctrl.device)
        self.gi, self.sweep = ops.gi_solve, ops.admm_sweep
        self._step = ctrl.make_fleet_step(B, chunk=256)

    def step(self, ym, ry):
        from mpc_tpu_torch.controllers import slmpc as module
        solvers = module.solve_qp_active, module.solve_qp
        module.solve_qp_active = functools.partial(solvers[0], solve=self.gi)
        module.solve_qp = functools.partial(solvers[1], sweep=self.sweep)
        try:
            u, conv, self.state = self._step(self.state, ym, ry, self.d, self.bounds)
        finally:
            module.solve_qp_active, module.solve_qp = solvers
        return u, conv.sum()


class PendulumLoop:
    """The true pendulums of a fleet, stepped on the device by the model's
    RK4 ``_fd`` under ``torch.func.vmap``, from rest; measurement noise
    N(0, 1)° per lane from a seeded generator, and the setpoint phases 180 /
    170 / 175 / 180° (bench.py:903-909), window w's period i in phase
    (w + i) mod 4 as bench.py's K-period dispatches cycle them."""

    def __init__(self, torch, model, B, dev, dtype, seed=4):
        from torch.func import vmap
        rng = np.random.default_rng(seed)
        t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
        self.phases = [(t(rng.normal(size=(B, 1))), t(np.full((B, 1), deg)))
                       for deg in (180.0, 170.0, 175.0, 180.0)]
        p, d = model.p, torch.zeros(0, dtype=dtype, device=dev)
        self.f = vmap(lambda x, u: model._fd(x, u, d, p))
        self.h = vmap(lambda x: model._h_user(x, d, p))
        self.x = torch.zeros(B, 2, dtype=dtype, device=dev)

    def measure(self, k):
        noise, ry = self.phases[(k // SL_K + k % SL_K) % 4]
        return self.h(self.x) + noise, ry

    def advance(self, u):
        self.x = self.f(self.x, u)


def slmpc_phase(torch, mt, ops, _build, dev, B=4096, warm=2, timed=2):
    """THE SLICE'S MAIN PATH and its kernel checks: bench.py's SLMPC fleet
    at B=4096 in float32 (GI with float64 slots), 2 warm windows of SL_K
    periods, then ``timed`` windows with the launch counts read around
    them; the GI kernel against its plain version on the inputs of the
    last warm window's first solve with warm rows on half the lanes or
    more; one period with the plain GI
    solve; then 4 periods of a fleet with ``qp_solver="admm"`` swinging its
    pendulums up from rest, where u saturates at ±1.5, and the sweep against
    its plain version on the next period's inputs, taken by the ``Capture``
    rule (warm duals, lane mask mixed).  Returns the launch counts and the
    checks."""
    t0 = time.perf_counter()
    ctrl = slmpc(torch, mt, dev, dtype=torch.float32)
    fleet = SLMPCFleet(torch, ctrl, B)
    loop = PendulumLoop(torch, ctrl.model, B, dev, torch.float32)
    print(f"SLMPC fleet: B={B}, QP n={ctrl.nZt} m={ctrl.n_rows}, per-lane P and A, "
          f"float32 data, float64 GI slots; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the GI solve held against its plain version below is the first of the
    # last warm window in which half the lanes or more enter with warm rows
    # (the previous period's duals on active bounds)
    gi_args = None
    for k in range(warm * SL_K):
        if gi_args is None and k >= (warm - 1) * SL_K:
            args = capture_gi(fleet, *loop.measure(k))
            if int((args[12] > 0).sum()) >= B // 2:
                gi_args = args
        u, nc = fleet.step(*loop.measure(k))
        loop.advance(u)
    check(gi_args is not None, "SLMPC: no GI solve of the last warm window had warm "
          "rows on half the lanes")
    k = warm * SL_K
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times, finite, umax = [], True, 0.0
    for _ in range(timed * SL_K):
        ym, ry = loop.measure(k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        u, nc = fleet.step(ym, ry)
        n_conv = int(nc)
        times.append(time.perf_counter() - t1)
        finite &= bool(torch.isfinite(u).all())
        umax = max(umax, u.abs().max().item())
        loop.advance(u)
        k += 1
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    n_per = timed * SL_K
    med = statistics.median(times)
    gi_pp = launches["gi_solve"] / n_per
    print(f"SLMPC main path: {n_per} periods, kernel launches {launches} "
          f"({gi_pp:g} GI a period); period median {med * 1e3:.2f} ms (min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), {B / med:.0f} solves/s; "
          f"last period converged {n_conv}/{B}, max |u| {umax:.4f}; angle mean "
          f"{loop.x[:, 0].mean().item() * 180 / np.pi:.2f} deg", flush=True)
    check(finite, "SLMPC main path: non-finite u")
    check(n_conv >= 0.99 * B, f"SLMPC main path: last period converged {n_conv} < 0.99·{B}")
    check(umax <= 1.5 + 1e-5, f"SLMPC main path: max |u| {umax} > 1.5")
    check(launches["gi_solve"] == n_per, f"SLMPC main path: {launches['gi_solve']} GI "
          f"launches in {n_per} periods (one a period expected)")
    # the GI kernel against its plain version
    gi_chk = gi_vs_plain(torch, ops, "SLMPC", gi_args, False)
    gi_chk["lanes_per_sm"], geo = gi_residency(torch, _build, gi_args)
    print(f"residency gi SLMPC: {gi_chk['lanes_per_sm']} lanes per SM ({geo})", flush=True)
    gi_chk.update(launches=launches["gi_solve"], per_period=gi_pp, period_ms=med * 1e3,
                  solves_per_s=B / med)
    # one period with the plain GI solve, from the same state
    plain_period(torch, "SLMPC", fleet, loop, "gi", ops.gi_solve, ops.gi_solve_reference)
    # ADMM: the swing-up from rest.  The sweep held against its plain
    # version is the first that Capture takes in its first 4 periods (u
    # saturates, the solves start from the last period's duals); then the
    # 4 periods again from rest, counted
    actrl = slmpc(torch, mt, dev, qp_solver="admm", dtype=torch.float32)
    afleet = SLMPCFleet(torch, actrl, B)
    aloop = PendulumLoop(torch, actrl.model, B, dev, torch.float32)
    rest = afleet.state, aloop.x
    aargs = None
    for k in range(4):
        aargs = capture_sweep(afleet, *aloop.measure(k))
        if aargs is not None:
            break
        u, _ = afleet.step(*aloop.measure(k))
        aloop.advance(u)
    check(aargs is not None, "SLMPC ADMM: no sweep of the swing-up's first 4 periods "
          "started from a warm dual with the lane mask mixed")
    afleet.state, aloop.x = rest
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    umax = 0.0
    for k in range(4):
        u, nc = afleet.step(*aloop.measure(k))
        n_conv = int(nc)
        check(bool(torch.isfinite(u).all()), "SLMPC ADMM: non-finite u")
        umax = max(umax, u.abs().max().item())
        aloop.advance(u)
    torch.cuda.synchronize()
    alaunch = dict(ops.LAUNCHES)
    print(f"SLMPC ADMM: 4 periods from rest, kernel launches {alaunch} "
          f"({alaunch['admm_sweep'] / 4:g} sweeps a period); last period converged "
          f"{n_conv}/{B} ({n_conv / B:.4f}), max |u| {umax:.4f}", flush=True)
    check(alaunch["admm_sweep"] > 0, "SLMPC ADMM: the sweep kernel was never launched")
    check(umax >= 1.5 - 1e-5, f"SLMPC ADMM: max |u| {umax} never reached the bound 1.5")
    on = aargs[11]
    warm_lanes = int((aargs[10][on].abs().amax(1) >= Y_WARM).sum())
    check(warm_lanes >= 0.5 * int(on.sum()), f"SLMPC ADMM: only {warm_lanes} of the "
          f"{int(on.sum())} active lanes of the captured sweep start from |y| ≥ {Y_WARM:g}")
    admm_chk = kernel_vs_plain(torch, ops, "SLMPC ADMM", aargs)
    admm_chk["lanes_per_sm"], geo = admm_residency(torch, ops, _build, admm_chk["args"])
    print(f"residency admm SLMPC: {admm_chk['lanes_per_sm']} lanes per SM ({geo})", flush=True)
    admm_chk.update(launches=alaunch["admm_sweep"], per_period=alaunch["admm_sweep"] / 4)
    return {"gi_solve": launches["gi_solve"], "admm_sweep": alaunch["admm_sweep"]}, \
        gi_chk, admm_chk


def small_slmpc_fleets(torch, mt, ops, dev, B=8, periods=20):
    """Small float64 SLMPC fleets (B=8, chunk 4), GI and ADMM, on the card
    against the same fleets on the CPU: both get the measurements of the
    CPU fleet's plants; equal converged flags, and u within
    1e-9·(1 + max|u|) with GI, 1e-8·(1 + max|u|) with ADMM (both sides run
    the same float64 algorithm, but the card and the CPU sum in other
    orders and ADMM's polish amplifies the difference: 2.6e-9 measured on
    an H100)."""
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    for qp_solver, bar in (("active_set", 1e-9), ("admm", 1e-8)):
        steps, states = {}, {}
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            c = slmpc(torch, mt, d, qp_solver=qp_solver)
            steps[name] = (c.make_fleet_step(B, chunk=4), c.bounds(),
                           torch.zeros(B, 0, dtype=torch.float64, device=d))
            states[name] = c.fleet_state(B)
        loop = PendulumLoop(torch, pendulum(torch, mt, "cpu"), B, "cpu", torch.float64)
        loop.x[:, 0] = torch.linspace(-0.3, 0.3, B, dtype=torch.float64)
        worst = 0.0
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(periods):
            ym, ry = loop.measure(k)
            out = {}
            for name, (step, bd, d0) in steps.items():
                dv = d0.device
                u, conv, states[name] = step(states[name], ym.to(dv), ry.to(dv), d0, bd)
                out[name] = (u.cpu(), conv.cpu())
            err = (out["card"][0] - out["cpu"][0]).abs().max().item()
            tol = bar * (1.0 + out["cpu"][0].abs().max().item())
            check(err <= tol, f"small SLMPC {qp_solver} period {k}: card vs CPU |du| "
                  f"{err:.3e} > {tol:.3e}")
            check(torch.equal(out["card"][1], out["cpu"][1]),
                  f"small SLMPC {qp_solver} period {k}: converged flags differ")
            worst = max(worst, err)
            loop.advance(out["cpu"][0])
        run = dict(ops.LAUNCHES)
        for key in launches:
            launches[key] += run[key]
        print(f"small SLMPC fleet {qp_solver} f64 (B={B}, chunk 4), {periods} periods: "
              f"kernel launches {run}; card vs CPU max |du| {worst:.3e} (bar {bar:g}·(1 + "
              f"max|u|))", flush=True)
    return launches


def single_slmpc_phase(torch, mt, ops, dev, periods=40):
    """SLMPC.moveinput_closed: the pendulum swing-up (Hp=20, float64, GI and
    ADMM; tests/test_slmpc.py:94-116) on the card against the CPU on the
    same plant: u within 1e-6; the median moveinput_closed time."""
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    out = {}
    for qp_solver, kernel, _ in SOLVERS:
        ctrls = {d: slmpc(torch, mt, d, qp_solver=qp_solver, Hp=20) for d in (dev, "cpu")}
        plant = pendulum(torch, mt, "cpu")
        times, worst = [], 0.0
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(periods):
            y = plant.evaloutput()
            t0 = time.perf_counter()
            u_c, conv_c = ctrls[dev].moveinput_closed(y, [180.0])
            times.append(time.perf_counter() - t0)
            u_h, conv_h = ctrls["cpu"].moveinput_closed(y, [180.0])
            worst = max(worst, float(np.abs(u_c - u_h).max()))
            check(conv_c == conv_h, f"single SLMPC {qp_solver} period {k}: converged differs")
            plant.updatestate(u_h)
        run = dict(ops.LAUNCHES)
        for key in launches:
            launches[key] += run[key]
        med = statistics.median(times[5:])
        angle = plant.evaloutput()[0]
        print(f"single SLMPC {qp_solver} f64 swing-up (Hp=20), {periods} periods: kernel "
              f"launches {run}; card vs CPU max |du| {worst:.3e} (bar 1e-6); final angle "
              f"{angle:.3f} deg; moveinput_closed median {med * 1e3:.3f} ms (periods 5-40)",
              flush=True)
        check(worst < 1e-6, f"single SLMPC {qp_solver}: card vs CPU |du| {worst:.3e}")
        check(run[kernel] >= periods, f"single SLMPC {qp_solver}: the {kernel} kernel "
              f"was launched {run[kernel]} times in {periods} periods")
        check(abs(angle - 180.0) < 2.0, f"single SLMPC {qp_solver}: ends at {angle} deg")
        out[qp_solver] = med * 1e3
    return launches, out


def estimator_phase(torch, mt, dev, periods=20, B=4096):
    """A UKF and an EKF on the pendulum (float64) and a BatchedKalman of
    KalmanFilters (B=4096, float32), card against CPU for 20 periods on the
    same measurements: x̂ within 1e-8·(1 + max|x̂|) (EKF), 1e-6·(1 + max|x̂|)
    (UKF, whose weights scale as 1/α²) and 1e-4·(1 + max|x̂|) (the float32
    fleet)."""
    rng = np.random.default_rng(6)
    for kind, bar in (("UnscentedKalmanFilter", 1e-6), ("ExtendedKalmanFilter", 1e-8)):
        ests = [getattr(mt, kind)(pendulum(torch, mt, "cpu"), nint_ym=[1],
                                  sigmaQ=[0.1, 0.5], sigmaR=[2.0], device=d)
                for d in (dev, "cpu")]
        worst = 0.0
        for _ in range(periods):
            y, u = rng.normal(size=1) * 20, rng.normal(size=1) * 0.5
            for e in ests:
                e.preparestate(y)
                e.updatestate(u, y)
            scale = 1.0 + np.abs(ests[1].x0_hat).max()
            worst = max(worst, np.abs(ests[0].x0_hat - ests[1].x0_hat).max() / scale)
        print(f"{kind} (pendulum, f64), {periods} periods: card vs CPU max |dx|/(1+|x|) "
              f"{worst:.3e} (bar {bar:g})", flush=True)
        check(worst <= bar, f"{kind}: card vs CPU {worst:.3e} > {bar:g}")
    kfs = large_controllers(mt, 4, kalman=True, device="cpu")
    from mpc_tpu_torch.parallel import BatchedKalman
    fleets = [BatchedKalman([c.estim for c in kfs], dtype=torch.float32, reps=B // 4,
                            device=d) for d in (dev, "cpu")]
    worst = 0.0
    for _ in range(periods):
        ym = torch.tensor(rng.normal(size=(B, 8)), dtype=torch.float32)
        u = torch.tensor(rng.normal(size=(B, 8)), dtype=torch.float32)
        x = [f.step(ym.to(f.device), u.to(f.device)).cpu() for f in fleets]
        worst = max(worst, ((x[0] - x[1]).abs().max() / (1 + x[1].abs().max())).item())
    torch.cuda.synchronize()
    print(f"BatchedKalman (KF, 8x8 plants, B={B}, f32), {periods} periods: card vs CPU "
          f"max |dx|/(1+|x|) {worst:.3e} (bar 1e-4)", flush=True)
    check(worst <= 1e-4, f"BatchedKalman: card vs CPU {worst:.3e} > 1e-4")


NL_BENCH = dict(Hp=15, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf, sqp_iters=15,
                kkt_tol=1e-3, kkt_feas_tol=1e-4)   # bench.py:655-658
NL_FEAS, NL_KKT = 1e-4, 1e-3   # the per-lane KKT test of bench.py:718


def nonlin_ctrl(torch, mt, device, qp_solver="active_set", alpha=0.5, **kw):
    """bench.py's NonLinMPC (bench.py:633-659): the pendulum, the UKF at
    α = 0.5, MultipleShooting, Hp = 15, Hc = 2, sqp_iters = 15, the KKT exit
    at 1e-3 / 1e-4, |u| ≤ 1.5."""
    est = mt.UnscentedKalmanFilter(pendulum(torch, mt, device), sigmaQ=[0.1, 1.0],
                                   sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1],
                                   alpha=alpha, device=device)
    kw = {**NL_BENCH, "transcription": mt.MultipleShooting(), **kw}
    c = mt.NonLinMPC(est, qp_solver=qp_solver, device=device, **kw)
    return c.setconstraint(umin=[-1.5], umax=[1.5])


class NonLinFleet:
    """A BatchedNonLinMPC of B lanes: ``step(ym, ry)`` returns ``(u,
    n_conv)`` by the per-lane KKT test; ``gi`` and ``sweep`` are the
    per-lane solve and the sweep its QPs call (checks swap in the plain
    versions, or recorders), passed to the controller module's solvers."""

    def __init__(self, torch, ctrl, B, dtype, chunk=None):
        from mpc_tpu_torch import ops
        from mpc_tpu_torch.parallel import BatchedNonLinMPC
        self.fleet = BatchedNonLinMPC(ctrl, B, dtype=dtype, chunk=chunk)
        self.B = B
        self.gi, self.sweep = ops.gi_solve, ops.admm_sweep

    @property
    def state(self):
        return self.fleet.state

    @state.setter
    def state(self, st):
        self.fleet.state = st

    def step(self, ym, ry):
        from mpc_tpu_torch.controllers import nonlinmpc as module
        solvers = module.solve_qp_active, module.solve_qp
        module.solve_qp_active = functools.partial(solvers[0], solve=self.gi)
        module.solve_qp = functools.partial(solvers[1], sweep=self.sweep)
        try:
            u, _ = self.fleet.step(ym, ry)
        finally:
            module.solve_qp_active, module.solve_qp = solvers
        kkt = self.fleet.last_kkt
        return u, ((kkt[:, 0] < NL_FEAS) & (kkt[:, 1] < NL_KKT)).sum()


class Recorder:
    """Wraps a kernel wrapper: keeps the inputs of the first call that
    ``want(args)`` accepts, and runs every call through the wrapper."""

    def __init__(self, fn, want):
        self.fn, self.want, self.args, self.first = fn, want, None, None

    def __call__(self, *args):
        if self.first is None:
            self.first = _clone(args)
        if self.args is None and self.want(args):
            self.args = _clone(args)
        return self.fn(*args)


def gi_warm_half(args):
    """A GI solve with warm rows on half its lanes or more."""
    return int((args[12] > 0).sum()) >= args[3].shape[0] // 2


def sweep_warm_mixed(args):
    """The sweep rule of ``Capture``: warm duals, lane mask mixed."""
    y, active = args[10], args[11]
    n_on = int(active.sum())
    return 0 < n_on <= 0.95 * active.numel() and y[active].abs().max().item() >= Y_WARM


def period_profile(torch, fn):
    """One call of ``fn`` under the profiler: the device kernels and copies
    it launched and their summed device time (ms), and the host syncs it
    made (``torch.cuda`` sync-debug warnings)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(r.message) for r in rec)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ev = [e for e in prof.events() if e.device_type == cuda]
    busy = sum(e.time_range.end - e.time_range.start for e in dev_ev) / 1e3
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()), reverse=True)[:3]
    return len(dev_ev), busy, syncs, host


def nonlin_phase(torch, mt, ops, _build, dev, B=4096, warm=2, timed=2):
    """THIS SLICE'S MAIN PATH: bench.py's ``nonlin`` lane — the pendulum
    BatchedNonLinMPC (SQP + UKF per lane, GI with float64 slots), B = 4096,
    float32 — from rest, 2 warm and ``timed`` timed windows of SL_K
    periods; then the GI kernel against its plain version on the first
    solve of the warm windows with warm rows on half the lanes or more, one
    period with the plain GI solve, and ≤ 4 ADMM periods from rest with the
    sweep against its plain version on the first sweep the ``Capture`` rule
    would take.  Fails below 0.99 converged by the per-lane KKT test, for
    max |u| > 1.5, or when the GI kernel was never launched."""
    from mpc_tpu_torch.controllers import nonlinmpc as NL
    t0 = time.perf_counter()
    ctrl = nonlin_ctrl(torch, mt, dev)
    fleet = NonLinFleet(torch, ctrl, B, torch.float32)
    loop = PendulumLoop(torch, ctrl.estim.model, B, dev, torch.float32)
    print(f"NonLinMPC fleet: B={B}, nZ̃={ctrl.nZt}, reduced QP n={ctrl.nZt - ctrl.estim.nx_hat * ctrl.Hp} "
          f"m={ctrl._n_dual()}, float32 data, float64 GI slots; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rec = Recorder(ops.gi_solve, gi_warm_half)
    fleet.gi = rec
    for k in range(warm * SL_K):
        u, nc = fleet.step(*loop.measure(k))
        loop.advance(u)
    fleet.gi = ops.gi_solve
    check(rec.args is not None, "NonLinMPC: no GI solve of the warm windows had warm "
          "rows on half the lanes")
    k = warm * SL_K
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    NL.COUNTS["sqp_exit_tests"] = 0
    times, finite, umax, its = [], True, 0.0, []
    for _ in range(timed * SL_K):
        ym, ry = loop.measure(k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        u, nc = fleet.step(ym, ry)
        n_conv = int(nc)
        times.append(time.perf_counter() - t1)
        its.append(fleet.fleet.last_iters.tolist())
        finite &= bool(torch.isfinite(u).all())
        umax = max(umax, u.abs().max().item())
        loop.advance(u)
        k += 1
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    n_per = timed * SL_K
    exits = NL.COUNTS["sqp_exit_tests"]
    med = statistics.median(times)
    stat = fleet.fleet.last_kkt[:, 1].double().cpu().numpy()
    it_max = max(i[0] for i in its)
    it_mean = statistics.mean(i[1] for i in its)
    print(f"NonLinMPC main path: {n_per} periods, kernel launches {launches} "
          f"({launches['gi_solve'] / n_per:g} GI a period, {exits / n_per:g} SQP exit tests "
          f"a period); period median {med * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}), {B / med:.0f} solves/s; SQP iterations max {it_max}, "
          f"mean of the periods' [sum // B] {it_mean:.2f}; last period converged "
          f"{n_conv}/{B} ({n_conv / B:.4f}) by stat < {NL_KKT:g} and viol < {NL_FEAS:g}, "
          f"stat p99 {np.percentile(stat, 99):.3e} max {stat.max():.3e}; max |u| {umax:.4f}; "
          f"angle mean {loop.x[:, 0].mean().item() * 180 / np.pi:.2f} deg", flush=True)
    check(finite, "NonLinMPC main path: non-finite u")
    check(n_conv >= 0.99 * B, f"NonLinMPC main path: last period converged {n_conv} < 0.99·{B}")
    check(umax <= 1.5 + 1e-5, f"NonLinMPC main path: max |u| {umax} > 1.5")
    check(launches["gi_solve"] > 0, "NonLinMPC main path: the GI kernel was never launched")
    # one more period counted: host syncs, device launches and busy time
    snap, x_snap = fleet.state, loop.x
    ym, ry = loop.measure(k)

    def one():
        fleet.state = snap
        fleet.step(ym, ry)
    n_dev, busy, syncs, host = period_profile(torch, one)
    prof = dict(device_launches=n_dev, device_busy_ms=busy, host_syncs=syncs,
                idle_share=1.0 - busy / (med * 1e3), sqp_exit_tests=exits / n_per)
    print(f"NonLinMPC period profile: {n_dev} device launches (kernels and copies), device "
          f"busy {busy:.3f} ms, idle share {prof['idle_share']:.4f} of the unprofiled median; "
          f"{syncs} host syncs (sync-debug warnings); largest host self times {host}",
          flush=True)
    fleet.state, loop.x = snap, x_snap
    gi_chk = gi_vs_plain(torch, ops, "NonLinMPC", rec.args, False)
    gi_chk["lanes_per_sm"], geo = gi_residency(torch, _build, rec.args)
    print(f"residency gi NonLinMPC: {gi_chk['lanes_per_sm']} lanes per SM ({geo})", flush=True)
    gi_chk.update(launches=launches["gi_solve"], per_period=launches["gi_solve"] / n_per,
                  period_ms=med * 1e3, solves_per_s=B / med, prof=prof)
    plain_period(torch, "NonLinMPC", fleet, loop, "gi", ops.gi_solve, ops.gi_solve_reference)
    # ADMM: the swing-up from rest (u saturates, the QPs start from the
    # last SQP iteration's duals); ≤ 4 periods
    actrl = nonlin_ctrl(torch, mt, dev, qp_solver="admm")
    afleet = NonLinFleet(torch, actrl, B, torch.float32)
    aloop = PendulumLoop(torch, actrl.estim.model, B, dev, torch.float32)
    arec = Recorder(ops.admm_sweep, sweep_warm_mixed)
    afleet.sweep = arec
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    umax = 0.0
    t1 = time.perf_counter()
    for k in range(4):
        u, nc = afleet.step(*aloop.measure(k))
        n_conv = int(nc)
        check(bool(torch.isfinite(u).all()), "NonLinMPC ADMM: non-finite u")
        umax = max(umax, u.abs().max().item())
        aloop.advance(u)
    torch.cuda.synchronize()
    alaunch = dict(ops.LAUNCHES)
    print(f"NonLinMPC ADMM: 4 periods from rest in {time.perf_counter() - t1:.1f} s, kernel "
          f"launches {alaunch} ({alaunch['admm_sweep'] / 4:g} sweeps a period); last period "
          f"converged {n_conv}/{B}, max |u| {umax:.4f}", flush=True)
    check(alaunch["admm_sweep"] > 0, "NonLinMPC ADMM: the sweep kernel was never launched")
    check(arec.args is not None, "NonLinMPC ADMM: no sweep of the 4 periods started from a "
          "warm dual with the lane mask mixed")
    admm_chk = kernel_vs_plain(torch, ops, "NonLinMPC ADMM", arec.args)
    admm_chk["lanes_per_sm"], geo = admm_residency(torch, ops, _build, admm_chk["args"])
    print(f"residency admm NonLinMPC: {admm_chk['lanes_per_sm']} lanes per SM ({geo})",
          flush=True)
    admm_chk.update(launches=alaunch["admm_sweep"], per_period=alaunch["admm_sweep"] / 4)
    return {"gi_solve": launches["gi_solve"], "admm_sweep": alaunch["admm_sweep"]}, \
        gi_chk, admm_chk


def exact_hessian_phase(torch, mt, ops, _build, dev, B=256, periods=4):
    """bench.py:739-781: the economic pendulum (h the angle and the rate,
    JE the mean electrical power, Ewt = 3.5e3, SingleShooting) as a B = 256
    float32 fleet with the Gauss–Newton and with the exact Lagrangian
    Hessian, ``periods`` timed periods each after one warm period; the GI
    kernel against its plain version on one of its solves (n = 2, m = 102)."""
    def f(x, u, d, par):
        g, L, K, m = par
        return torch.stack([x[1], -g / L * torch.sin(x[0]) - K / m * x[1]
                            + u[0] / (m * L ** 2)])
    h2 = lambda x, d, par: torch.stack([x[0] * 180 / torch.pi, x[1] * 180 / torch.pi])

    def JE(Ue, Ye, De, p_, eps_):
        omega = Ye[1::2][1:] * torch.pi / 180
        return 0.1 * torch.sum(torch.abs(Ue[1:] * omega) + 0.01 * (Ue[1:] * omega) ** 2)
    rng = np.random.default_rng(5)
    out, launches, chk = {}, 0, None
    for hess in ("gauss_newton", "exact"):
        pend = mt.NonLinModel(f, h2, 0.1, 1, 2, 2, p=PEND_P, solver=mt.RungeKutta(4),
                              device=dev)
        est = mt.UnscentedKalmanFilter(pend, sigmaQ=[0.1, 1.0], sigmaR=[5.0, 5.0],
                                       nint_ym=[1, 0], sigmaQint_ym=[0.1], alpha=0.5,
                                       device=dev)
        c = mt.NonLinMPC(est, Hp=15, Hc=2, Mwt=[0.5, 0.0], Nwt=[2.5], Cwt=np.inf,
                         Ewt=3.5e3, JE=JE, sqp_iters=15, qp_solver="active_set",
                         hessian=hess, device=dev)
        c.setconstraint(umin=[-1.5], umax=[1.5])
        fl = NonLinFleet(torch, c, B, torch.float32)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        seq = [(t(rng.normal(size=(B, 2)) * 5.0), t(np.tile([deg, 0.0], (B, 1))))
               for deg in (180.0, 170.0, 175.0, 180.0)]
        rec = Recorder(ops.gi_solve, gi_warm_half)
        if chk is None:
            fl.gi = rec
        fl.step(*seq[0])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for k in range(periods):
            u, _ = fl.step(*seq[k % 4])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / periods
        launches += ops.LAUNCHES["gi_solve"]
        it = fl.fleet.last_iters.tolist()
        check(bool(torch.isfinite(u).all()), f"exact-Hessian A/B {hess}: non-finite u")
        fl.gi = ops.gi_solve
        out[hess] = dict(step_ms=dt * 1e3, solves_per_s=B / dt, sqp_iters_max=it[0],
                         sqp_iters_mean=it[1])
        print(f"exact-Hessian A/B {hess} (B={B}, f32, SS, n={c.nZt} m={c._n_dual()}): step "
              f"{dt * 1e3:.2f} ms ({B / dt:.0f} solves/s), last SQP iterations max {it[0]} "
              f"mean {it[1]}, GI launches {ops.LAUNCHES['gi_solve']}", flush=True)
        if chk is None:
            # the first solve with warm rows on half the lanes, else the first
            args = rec.args if rec.args is not None else rec.first
            chk = gi_vs_plain(torch, ops, "NonLinMPC exact-Hessian A/B", args, False)
            chk["lanes_per_sm"], geo = gi_residency(torch, _build, args)
            print(f"residency gi NonLinMPC A/B: {chk['lanes_per_sm']} lanes per SM ({geo})",
                  flush=True)
    chk.update(launches=launches, per_period=launches / (2 * periods), ab=out)
    return launches, chk


def small_nonlin_fleets(torch, mt, ops, dev, B=8, periods=20):
    """Small float64 NonLinMPC fleets (B = 8, chunk 4; the bench controller),
    GI and ADMM, on the card against the same fleets on the CPU, on the CPU
    fleet's plants: u within 1e-6·(1 + max|u|).  Both sides run the same
    float64 SQP, but an exit or line-search test that sits on round-off
    (the KKT exit at 1e-3, a merit tie at a converged iterate) can stop one
    side an iteration later, and u then differs by that last step: 1.3e-8
    at most on an H100, where the SLMPC phase's 1e-9 bar failed."""
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    for qp_solver, bar in (("active_set", 1e-6), ("admm", 1e-6)):
        fleets = {name: NonLinFleet(torch, nonlin_ctrl(torch, mt, d, qp_solver=qp_solver), B,
                                    torch.float64, chunk=4)
                  for name, d in (("card", dev), ("cpu", torch.device("cpu")))}
        loop = PendulumLoop(torch, pendulum(torch, mt, "cpu"), B, "cpu", torch.float64)
        loop.x[:, 0] = torch.linspace(-0.3, 0.3, B, dtype=torch.float64)
        worst, same_it = 0.0, 0
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(periods):
            ym, ry = loop.measure(k)
            out = {}
            for name, fl in fleets.items():
                dv = fl.fleet.device
                u, nc = fl.step(ym.to(dv), ry.to(dv))
                out[name] = (u.cpu(), int(nc), fl.fleet.last_iters.tolist())
            err = (out["card"][0] - out["cpu"][0]).abs().max().item()
            tol = bar * (1.0 + out["cpu"][0].abs().max().item())
            check(err <= tol, f"small NonLinMPC {qp_solver} period {k}: card vs CPU |du| "
                  f"{err:.3e} > {tol:.3e}")
            same_it += out["card"][2] == out["cpu"][2]
            worst = max(worst, err)
            loop.advance(out["cpu"][0])
        run = dict(ops.LAUNCHES)
        for key in launches:
            launches[key] += run[key]
        print(f"small NonLinMPC fleet {qp_solver} f64 (B={B}, chunk 4), {periods} periods: "
              f"kernel launches {run}; card vs CPU max |du| {worst:.3e} (bar {bar:g}·(1 + "
              f"max|u|)); equal SQP iteration [max, mean] in {same_it}/{periods} periods",
              flush=True)
    return launches


def single_nonlin_phase(torch, mt, ops, dev, periods=60):
    """NonLinMPC.moveinput: the swing-up of tests/test_nonlinmpc.py:52-63
    (the UKF at its defaults, Hp = 20, SingleShooting, float64) with both
    backends, on the card against the CPU on the same plant: u within 1e-6;
    the median moveinput over periods 5-60."""
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    out = {}
    for qp_solver, kernel, _ in SOLVERS:
        ctrls = {}
        for d in (dev, "cpu"):
            est = mt.UnscentedKalmanFilter(pendulum(torch, mt, d), sigmaQ=[0.1, 1.0],
                                           sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1],
                                           device=d)
            ctrls[d] = mt.NonLinMPC(est, Hp=20, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf,
                                    qp_solver=qp_solver, device=d)
            ctrls[d].setconstraint(umin=[-1.5], umax=[1.5])
        plant = pendulum(torch, mt, "cpu")
        times, worst = [], 0.0
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(periods):
            y = plant.evaloutput()
            us = {}
            for d, c in ctrls.items():
                t0 = time.perf_counter()
                c.preparestate(y)
                us[d] = c.moveinput([180.0])
                if d == dev:
                    times.append(time.perf_counter() - t0)
                c.updatestate(us[d], y)
            worst = max(worst, float(np.abs(us[dev] - us["cpu"]).max()))
            plant.updatestate(us["cpu"])
        run = dict(ops.LAUNCHES)
        for key in launches:
            launches[key] += run[key]
        med = statistics.median(times[5:])
        angle = plant.evaloutput()[0]
        print(f"single NonLinMPC {qp_solver} f64 swing-up (Hp=20, SS), {periods} periods: "
              f"kernel launches {run}; card vs CPU max |du| {worst:.3e} (bar 1e-6); final "
              f"angle {angle:.3f} deg; preparestate+moveinput median {med * 1e3:.3f} ms "
              f"(periods 5-{periods})", flush=True)
        check(worst < 1e-6, f"single NonLinMPC {qp_solver}: card vs CPU |du| {worst:.3e}")
        check(run[kernel] >= periods, f"single NonLinMPC {qp_solver}: the {kernel} kernel "
              f"was launched {run[kernel]} times in {periods} periods")
        check(abs(angle - 180.0) < 2.0, f"single NonLinMPC {qp_solver}: ends at {angle} deg")
        out[qp_solver] = med * 1e3
    return launches, out


def explicit_phase(torch, mt, dev, B=256, periods=10):
    """A BatchedExplicitMPC of 64 distinct 2x2 plants x 4 (B = 256, float64,
    SteadyKalmanFilter feedback) on the card against the CPU: u within
    1e-9·(1 + max|u|)."""
    from mpc_tpu_torch.parallel import BatchedExplicitMPC
    ctrls = []
    for seed in range(64):
        g = np.random.default_rng(seed).uniform(0.8, 1.6, size=4) * [1.9, 1.9, -0.74, 0.74]
        G = mt.tf_matrix([[mt.tf(g[0], [18, 1]), mt.tf(g[1], [18, 1])],
                          [mt.tf(g[2], [8, 1]), mt.tf(g[3], [8, 1])]])
        ctrls.append(mt.ExplicitMPC(mt.LinModel(G, 2.0), Hp=8, Hc=2, Mwt=[1, 1],
                                    Nwt=[0.1, 0.1], device="cpu"))
    fleets = [BatchedExplicitMPC(ctrls, reps=B // 64, device=d) for d in (dev, "cpu")]
    rng = np.random.default_rng(8)
    worst = 0.0
    for _ in range(periods):
        ym, ry = rng.normal(size=(B, 2)) * 0.5, rng.normal(size=(B, 2)) * 1.5
        u = [f.step(ym, ry).cpu() for f in fleets]
        worst = max(worst, ((u[0] - u[1]).abs().max() / (1 + u[1].abs().max())).item())
    print(f"BatchedExplicitMPC (64 2x2 plants x 4, B={B}, f64), {periods} periods: card vs "
          f"CPU max |du|/(1+|u|) {worst:.3e} (bar 1e-9)", flush=True)
    check(worst <= 1e-9, f"BatchedExplicitMPC: card vs CPU {worst:.3e} > 1e-9")


MHE_K, MHE_NL_K = 8, 4     # periods a dispatch (bench.py:805, :966)


def mhe_fleet(torch, mt, dev, B, He=10, dtype=None, bound=50.0, **kw):
    """bench.py's ``mhe`` lane fleet (bench.py:794-803): BatchedMHE of the
    2x1 LinModel, He = 10, σQ = 0.1, σR = 0.2, x̂ within ±``bound`` (50)."""
    from mpc_tpu_torch.parallel import BatchedMHE
    m = mt.LinModel(mt.tf_matrix([[mt.tf(3, [10, 1])], [mt.tf(-1, [4, 1])]]), 1.0)
    t = mt.MovingHorizonEstimator(m, He=He, sigmaQ=[0.1] * m.nx, sigmaR=[0.2, 0.2],
                                  device=dev)
    t.setconstraint(xhatmin=np.full(t.nx_hat, -bound), xhatmax=np.full(t.nx_hat, bound))
    return BatchedMHE(t, B, dtype=dtype, **kw), m


def mhe_trajectories(m, B, n, seed=3):
    """bench.py:804-824: true 2x1 plants driven by 4 persistent random
    inputs and process noise, ym = C x + N(0, 0.2²); host NumPy."""
    rng = np.random.default_rng(seed)
    A_p, Bu_p, C_p = np.asarray(m.A), np.asarray(m.Bu), np.asarray(m.C)
    x_true = np.zeros((B, m.nx))
    u_seq = 0.5 * rng.standard_normal((4, B, 1))
    ys, us = [], []
    for k in range(n):
        u_k = u_seq[k % 4]
        ys.append(x_true @ C_p.T + rng.normal(size=(B, 2)) * 0.2)
        us.append(u_k)
        x_true = x_true @ A_p.T + u_k @ Bu_p.T + rng.normal(size=(B, m.nx)) * 0.05
    return ys, us, rng


def pendulum_trajectories(B, n, seed=5):
    """bench.py:988-1016: true pendulums (host NumPy RK4) under 4 persistent
    random torques, ym = angle in degrees + N(0, 2²)."""
    rng = np.random.default_rng(seed)
    g_, L_, Kp_, m_ = PEND_P
    Ts = 0.1

    def f_np(x, u):
        return np.stack([x[:, 1], -g_ / L_ * np.sin(x[:, 0]) - Kp_ / m_ * x[:, 1]
                         + u[:, 0] / (m_ * L_ ** 2)], axis=1)
    x_true = np.zeros((B, 2))
    u_seq = 0.5 * rng.standard_normal((4, B, 1))
    ys, us = [], []
    for k in range(n):
        u_k = u_seq[k % 4]
        ys.append(x_true[:, :1] * 180 / np.pi + rng.normal(size=(B, 1)) * 2.0)
        us.append(u_k)
        k1 = f_np(x_true, u_k)
        k2 = f_np(x_true + 0.5 * Ts * k1, u_k)
        k3 = f_np(x_true + 0.5 * Ts * k2, u_k)
        k4 = f_np(x_true + Ts * k3, u_k)
        x_true = x_true + Ts / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return ys, us


def fleet_snapshot(fleet):
    """An MHE fleet's state: the device dict (never written in place) and
    the host mirrors."""
    return (fleet.state, fleet.Nk, fleet.P_arr.copy(), fleet.invP_arr.copy(),
            fleet._nan_guard)


def fleet_restore(fleet, snap):
    (fleet.state, fleet.Nk, P, invP, fleet._nan_guard) = snap
    fleet.P_arr, fleet.invP_arr = P.copy(), invP.copy()


def mhe_windows(torch, fleet, dispatch, kk, K, n_win=3, n_disp=2, after=None):
    """bench.py's timing: ``n_win`` hard-synced windows of ``n_disp``
    K-period dispatches from period ``kk``; returns (median seconds a
    period, next kk, the stacked estimates of the last dispatch)."""
    win = []
    for _ in range(n_win):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n_disp):
            X = dispatch(kk)
            kk += K
            if after is not None:
                after()
        torch.cuda.synchronize()
        win.append((time.perf_counter() - t1) / (n_disp * K))
    return statistics.median(win), kk, X


def mhe_phase(torch, mt, ops, _build, dev, B=4096, He=10, K=MHE_K):
    """THE MHE SLICE'S MAIN PATH, bench.py's ``mhe`` lane (bench.py:786-876):
    the 2x1 BatchedMHE (He = 10, x̂ within ±50, ``gi_max_active=8``), B =
    4096, float32 data and float64 GI slots; 11 fill steps, one warm
    ``multistep(K=8)`` and 3 timed windows of 2 dispatches; one counted
    period; one period with the plain GI solve; then the 1 %-NaN traffic
    (one dropout period a dispatch on 1 % of the lanes): 1 warm and 3 timed
    dispatches.  The GI kernel against its plain version on a solve of the
    warm dispatch (shape (a): n = 44, m = 104, 8 slots, one shared P⁻¹ and
    A) and of the NaN warm dispatch (shape (b): per-lane P⁻¹, the shared A
    through the A map), and at
    shape (a) on a solve with warm rows on half the lanes (the same fleet
    with x̂ within ±0.5, where bounds bind).  Fails
    below 0.99 of the lanes converged or without a GI launch a period."""
    t0 = time.perf_counter()
    fleet, m = mhe_fleet(torch, mt, dev, B, He, dtype=torch.float32, gi_max_active=8)
    n_total = He + 1 + (1 + 3 * 2 + 4) * K + 2
    ys, us, rng = mhe_trajectories(m, B, n_total)
    print(f"MHE fleet (mhe lane): B={B}, He={He}, nx̂={fleet.t.nx_hat}, fast-path QP n="
          f"{fleet.t.nZt} m={fleet._m_rows}, 8 slots, float32 data, float64 slots; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for k in range(He + 1):
        fleet.step(ys[k], u_prev=(us[k - 1] if k else None))
    dispatch = lambda kk, Y=None: fleet.multistep(np.stack(ys[kk:kk + K]) if Y is None else Y,
                                                  np.stack(us[kk - 1:kk - 1 + K]))
    kk = He + 1
    rec = Recorder(ops.gi_solve, gi_warm_half)
    fleet.gi = rec
    dispatch(kk)
    kk += K
    fleet.gi = ops.gi_solve
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    med, kk, X = mhe_windows(torch, fleet, dispatch, kk, K)
    launches = dict(ops.LAUNCHES)
    n_per = 3 * 2 * K
    n_ok = int(fleet.last_ok.sum())
    print(f"MHE main path: {n_per} periods in 6 dispatches of K={K}, kernel launches {launches} "
          f"({launches['gi_solve'] / n_per:g} GI a period); period median {med * 1e3:.3f} ms, "
          f"{B / med:.0f} solves/s; last period converged {n_ok}/{B} ({n_ok / B:.4f}), pivots "
          f"max {int(fleet.last_pivots)}", flush=True)
    check(bool(torch.isfinite(X).all()), "MHE main path: non-finite x̂")
    check(n_ok >= 0.99 * B, f"MHE main path: converged {n_ok} < 0.99·{B}")
    check(launches["gi_solve"] >= n_per, f"MHE main path: {launches['gi_solve']} GI "
          f"launches in {n_per} periods")
    # one more period counted, then the same period with the plain GI
    snap = fleet_snapshot(fleet)
    one = lambda: (fleet_restore(fleet, snap), fleet.step(ys[kk], us[kk - 1]))
    n_dev, busy, syncs, host = period_profile(torch, one)
    prof = dict(device_launches=n_dev, device_busy_ms=busy, host_syncs=syncs,
                idle_share=1.0 - busy / (med * 1e3))
    print(f"MHE period profile: {n_dev} device launches (kernels and copies), device busy "
          f"{busy:.3f} ms, idle share {prof['idle_share']:.4f} of the dispatched median; "
          f"{syncs} host syncs; largest host self times {host}", flush=True)
    res = {}
    for label in ("kernel", "plain", "plain", "kernel"):
        fleet_restore(fleet, snap)
        fleet.gi = ops.gi_solve if label == "kernel" else ops.gi_solve_reference
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x = fleet.step(ys[kk], us[kk - 1])
        torch.cuda.synchronize()
        res.setdefault(label, []).append((x, time.perf_counter() - t1))
    fleet.gi = ops.gi_solve
    x_k, x_p = res["kernel"][0][0], res["plain"][0][0]
    err = (x_k - x_p).abs().max().item()
    tol = F32_TOL * (1.0 + x_p.abs().max().item())
    t_k = statistics.mean(r[1] for r in res["kernel"])
    t_p = statistics.mean(r[1] for r in res["plain"])
    print(f"MHE, plain GI on the card, same period: max |x̂ kernel - x̂ plain| {err:.3e} (tol "
          f"{tol:.3e}); step kernel {t_k * 1e3:.2f} ms plain {t_p * 1e3:.2f} ms", flush=True)
    check(err <= tol, f"MHE: plain GI period disagrees with the kernel path: {err:.3e}")
    fleet_restore(fleet, snap)
    # 1 %-NaN traffic (bench.py:852-872): one dropout period a dispatch
    nan_lanes = rng.choice(B, max(1, B // 100), replace=False)

    def nan_dispatch(kk):
        Y = np.stack(ys[kk:kk + K]).copy()
        Y[0, nan_lanes, 0] = np.nan
        return dispatch(kk, Y)
    rec_b = Recorder(ops.gi_solve, lambda a: a[0].shape[0] > 1)    # per-lane P⁻¹
    fleet.gi = rec_b
    nan_dispatch(kk)
    kk += K
    fleet.gi = ops.gi_solve
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    med_nan, kk, X = mhe_windows(torch, fleet, nan_dispatch, kk, K, n_win=1, n_disp=3)
    nan_launches = dict(ops.LAUNCHES)
    n_ok_nan = int(fleet.last_ok.sum())
    print(f"MHE 1 %-NaN traffic ({len(nan_lanes)} lanes drop one measurement a dispatch): 3 "
          f"dispatches of K={K}, kernel launches {nan_launches}; period {med_nan * 1e3:.3f} ms, "
          f"{B / med_nan:.0f} solves/s ({med_nan / med:.3f}x a clean period); converged "
          f"{n_ok_nan}/{B}",
          flush=True)
    check(bool(torch.isfinite(X).all()), "MHE NaN traffic: non-finite x̂")
    check(n_ok_nan >= 0.99 * B, f"MHE NaN traffic: converged {n_ok_nan} < 0.99·{B}")
    check(rec_b.args is not None, "MHE NaN traffic: no per-lane GI solve was recorded")
    # the lane's ±50 bounds never bind, so its solves start cold: the same
    # shape with x̂ within ±0.5 gives warm rows, pivots and slot overflows
    wfleet, _ = mhe_fleet(torch, mt, dev, B, He, dtype=torch.float32, bound=0.5,
                          gi_max_active=8)
    rec_w = Recorder(ops.gi_solve, gi_warm_half)
    wfleet.gi = rec_w
    for k in range(He + 6):
        wfleet.step(ys[k], u_prev=(us[k - 1] if k else None))
        if rec_w.args is not None:
            break
    check(rec_w.args is not None, "MHE at ±0.5: no GI solve had warm rows on half the lanes")
    del wfleet
    out = {}
    for key, name, args in (("a", "MHE fast path (a)", rec.args or rec.first),
                            ("a warm", "MHE fast path (a), x̂ within ±0.5", rec_w.args),
                            ("b", "MHE NaN variant (b)", rec_b.args)):
        chk = gi_vs_plain(torch, ops, name, args, False)
        chk["lanes_per_sm"], geo = gi_residency(torch, _build, args)
        print(f"residency gi {name}: {chk['lanes_per_sm']} lanes per SM ({geo})", flush=True)
        out[key] = chk
    out["a"].update(launches=launches["gi_solve"], per_period=launches["gi_solve"] / n_per,
                    period_ms=med * 1e3, solves_per_s=B / med, prof=prof, converged=n_ok / B)
    out["b"].update(launches=nan_launches["gi_solve"],
                    per_period=nan_launches["gi_solve"] / (3 * K), period_ms=med_nan * 1e3,
                    solves_per_s=B / med_nan, converged=n_ok_nan / B)
    return launches["gi_solve"] + nan_launches["gi_solve"], out


def mhe_nonlin_phase(torch, mt, ops, _build, dev, B=1024, He=10, K=MHE_NL_K):
    """bench.py's ``mhe_nonlin`` lane (bench.py:956-1044): the pendulum MHE
    (the window GN-SQP, GI, an ExtendedKalmanFilter covestim for the
    per-lane arrival covariance, x̂ bounds), B = 1024, float32; 11 fill
    steps, one warm ``multistep(K=4)``, 3 timed windows of 2 dispatches,
    one counted period; the GI kernel against its plain version on a solve
    of the warm dispatch (shape (c): n = 33, m = 146, per-lane P and A).
    Fails below 0.99 of the lanes converged or without a GI launch a
    period."""
    from mpc_tpu_torch.estimators import mhe as MHE
    from mpc_tpu_torch.parallel import BatchedMHE
    t0 = time.perf_counter()
    kw = dict(sigmaQ=[0.1, 1.0], sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1], device=dev)
    pend = pendulum(torch, mt, dev)
    t = mt.MovingHorizonEstimator(pend, He=He, covestim=mt.ExtendedKalmanFilter(pend, **kw),
                                  qp_solver="active_set", **kw)
    t.setconstraint(xhatmin=[-2 * np.pi, -50.0, -50.0], xhatmax=[2 * np.pi, 50.0, 50.0])
    fleet = BatchedMHE(t, B, dtype=torch.float32)
    ys, us = pendulum_trajectories(B, He + 1 + (3 * 2 + 1) * K + 2)
    print(f"nonlinear MHE fleet (mhe_nonlin lane): B={B}, He={He}, window QP n={t.nZt} m="
          f"{2 * t.nx_hat + 4 * He * t.nx_hat + 2 * He * t.nym}, float32 data, float64 slots; "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for k in range(He + 1):
        fleet.step(ys[k], u_prev=(us[k - 1] if k else None))
    dispatch = lambda kk: fleet.multistep(np.stack(ys[kk:kk + K]), np.stack(us[kk - 1:kk - 1 + K]))
    kk = He + 1
    rec = Recorder(ops.gi_solve, gi_warm_half)
    fleet.gi = rec
    dispatch(kk)
    kk += K
    fleet.gi = ops.gi_solve
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    MHE.COUNTS["gn_exit_tests"] = 0
    its = []
    med, kk, X = mhe_windows(torch, fleet, dispatch, kk, K,
                             after=lambda: its.append(fleet.last_iters.tolist()))
    launches = dict(ops.LAUNCHES)
    n_per = 3 * 2 * K
    exits = MHE.COUNTS["gn_exit_tests"]
    n_ok = int(fleet.last_ok.sum())
    it_max, it_mean = max(i[0] for i in its), statistics.mean(i[1] for i in its)
    print(f"nonlinear MHE main path: {n_per} periods in 6 dispatches of K={K}, kernel launches "
          f"{launches} ({launches['gi_solve'] / n_per:g} GI, {exits / n_per:g} GN exit tests a "
          f"period); period median {med * 1e3:.2f} ms, {B / med:.0f} solves/s; GN iterations "
          f"max {it_max}, mean of the dispatches' last [sum // B] {it_mean:.2f}; last period "
          f"converged {n_ok}/{B} ({n_ok / B:.4f})", flush=True)
    check(bool(torch.isfinite(X).all()), "nonlinear MHE: non-finite x̂")
    check(n_ok >= 0.99 * B, f"nonlinear MHE: converged {n_ok} < 0.99·{B}")
    check(launches["gi_solve"] >= n_per, f"nonlinear MHE: {launches['gi_solve']} GI launches "
          f"in {n_per} periods")
    snap = fleet_snapshot(fleet)
    one = lambda: (fleet_restore(fleet, snap), fleet.step(ys[kk], us[kk - 1]))
    n_dev, busy, syncs, host = period_profile(torch, one)
    prof = dict(device_launches=n_dev, device_busy_ms=busy, host_syncs=syncs,
                idle_share=1.0 - busy / (med * 1e3), gn_exit_tests=exits / n_per)
    print(f"nonlinear MHE period profile: {n_dev} device launches (kernels and copies), device "
          f"busy {busy:.3f} ms, idle share {prof['idle_share']:.4f} of the dispatched median; "
          f"{syncs} host syncs; largest host self times {host}", flush=True)
    fleet_restore(fleet, snap)
    chk = gi_vs_plain(torch, ops, "MHE nonlin (c)", rec.args or rec.first, False)
    chk["lanes_per_sm"], geo = gi_residency(torch, _build, rec.args or rec.first)
    print(f"residency gi MHE nonlin: {chk['lanes_per_sm']} lanes per SM ({geo})", flush=True)
    chk.update(launches=launches["gi_solve"], per_period=launches["gi_solve"] / n_per,
               period_ms=med * 1e3, solves_per_s=B / med, prof=prof, converged=n_ok / B,
               gn_iters=[it_max, it_mean])
    return launches["gi_solve"], chk


def per_lane_inputs(torch, mt, ops, dev, B=4096):
    """The inputs of the per-lane launches (every lane its own QP
    matrices), captured as the phases above capture them, for
    ``profile_kernels.py``: ``{name: (kernel, args)}``.  The nonlin lane's sweep (B=4096, n=2, m=72, f32; the first
    of 4 ADMM periods from rest with warm duals and the mask mixed) and GI
    solve (n=2, m=72; the first with warm rows on half the lanes), the
    mhe_nonlin lane's GI solve (shape (c), B=1024, n=33, m=146), the mhe
    lane's NaN variant (shape (b), B=4096, n=44, m=104, per-lane P⁻¹ and
    the shared A), the SLMPC fleet's GI solve and sweep (n=3, m=65, as
    ``slmpc_phase`` takes them) and the GI solve of a
    ``CompiledClosedLoopFleet`` of 128 controllers (n_d = B, float64, the
    first call with carried slots); ``B`` cuts the batches (a quarter of it
    at (c), 128 lanes for the compiled fleet)."""
    out = {}
    for qp_solver, kernel, want in (("admm", ops.admm_sweep, sweep_warm_mixed),
                                    ("active_set", ops.gi_solve, gi_warm_half)):
        ctrl = nonlin_ctrl(torch, mt, dev, qp_solver=qp_solver)
        fleet = NonLinFleet(torch, ctrl, B, torch.float32)
        loop = PendulumLoop(torch, ctrl.estim.model, B, dev, torch.float32)
        rec = Recorder(kernel, want)
        setattr(fleet, "sweep" if qp_solver == "admm" else "gi", rec)
        for k in range(4 if qp_solver == "admm" else 2 * SL_K):
            u, _ = fleet.step(*loop.measure(k))
            loop.advance(u)
            if rec.args is not None:
                break
        check(rec.args is not None, f"per-lane inputs: no NonLinMPC {qp_solver} call taken")
        name = "sweep NonLinMPC n=2 m=72" if qp_solver == "admm" else "gi nonlin n=2 m=72"
        out[name] = ("sweep" if qp_solver == "admm" else "gi", rec.args)
        del fleet
    kw = dict(sigmaQ=[0.1, 1.0], sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1], device=dev)
    pend = pendulum(torch, mt, dev)
    t = mt.MovingHorizonEstimator(pend, He=10, covestim=mt.ExtendedKalmanFilter(pend, **kw),
                                  qp_solver="active_set", **kw)
    t.setconstraint(xhatmin=[-2 * np.pi, -50.0, -50.0], xhatmax=[2 * np.pi, 50.0, 50.0])
    from mpc_tpu_torch.parallel import BatchedMHE
    fleet = BatchedMHE(t, B // 4, dtype=torch.float32)
    ys, us = pendulum_trajectories(B // 4, 11 + MHE_NL_K)
    for k in range(11):
        fleet.step(ys[k], u_prev=(us[k - 1] if k else None))
    rec = Recorder(ops.gi_solve, gi_warm_half)
    fleet.gi = rec
    fleet.multistep(np.stack(ys[11:11 + MHE_NL_K]), np.stack(us[10:10 + MHE_NL_K]))
    out["gi (c) mhe_nonlin n=33 m=146"] = ("gi", rec.args or rec.first)
    del fleet
    fleet, m = mhe_fleet(torch, mt, dev, B, 10, dtype=torch.float32, gi_max_active=8)
    ys, us, rng = mhe_trajectories(m, B, 11 + MHE_K)
    for k in range(11):
        fleet.step(ys[k], u_prev=(us[k - 1] if k else None))
    rec = Recorder(ops.gi_solve, lambda a: a[0].shape[0] > 1)
    fleet.gi = rec
    Y = np.stack(ys[11:11 + MHE_K]).copy()
    Y[0, rng.choice(B, max(1, B // 100), replace=False), 0] = np.nan
    fleet.multistep(Y, np.stack(us[10:10 + MHE_K]))
    check(rec.args is not None, "per-lane inputs: no NaN-variant GI solve taken")
    out["gi (b) mhe NaN n=44 m=104"] = ("gi", rec.args)
    del fleet
    ctrl = slmpc(torch, mt, dev, dtype=torch.float32)
    fleet = SLMPCFleet(torch, ctrl, B)
    loop = PendulumLoop(torch, ctrl.model, B, dev, torch.float32)
    for k in range(2 * SL_K):
        args = capture_gi(fleet, *loop.measure(k)) if k >= SL_K else None
        if args is not None and int((args[12] > 0).sum()) >= B // 2:
            out["gi SLMPC n=3 m=65"] = ("gi", args)
            break
        u, _ = fleet.step(*loop.measure(k))
        loop.advance(u)
    check("gi SLMPC n=3 m=65" in out, "per-lane inputs: no SLMPC GI solve with warm rows")
    actrl = slmpc(torch, mt, dev, qp_solver="admm", dtype=torch.float32)
    fleet = SLMPCFleet(torch, actrl, B)
    loop = PendulumLoop(torch, actrl.model, B, dev, torch.float32)
    for k in range(4):
        aargs = capture_sweep(fleet, *loop.measure(k))
        if aargs is not None:
            out["sweep SLMPC n=3 m=65"] = ("sweep", aargs)
            break
        u, _ = fleet.step(*loop.measure(k))
        loop.advance(u)
    check("sweep SLMPC n=3 m=65" in out, "per-lane inputs: no SLMPC sweep taken")
    del fleet
    from mpc_tpu_torch import sim_compiled as sc
    from mpc_tpu_torch.parallel import random_cstr_controllers
    cfleet = sc.CompiledClosedLoopFleet(random_cstr_controllers(
        min(B, 128), Hp=10, Hc=2, seed=0, qp_solver="active_set", device=dev))
    rec = Recorder(cfleet.gi, gi_warm_slots)
    cfleet.gi = rec
    cfleet.run(12, ry=[5.0, 1.0], y_noise=[0.1, 0.1], seed=0)
    out["gi CompiledClosedLoopFleet n_d=B=128 f64"] = ("gi", rec.args or rec.first)
    return out


def small_mhe_checks(torch, mt, ops, _build, dev, B=8, He=4, periods=10):
    """Small float64 checks of the card against the CPU: BatchedMHE fleets
    (B = 8, He = 4) on the fast path, through a NaN (the per-lane variant),
    with ``solver="general"`` (ADMM) and a nonlinear fleet (the pendulum,
    EKF covestim, GI), x̂ within 1e-9·(1 + max|x̂|) (GI) or 1e-8 (ADMM) and
    1e-7 on the nonlinear fleet: the merit decrease of a Gauss–Newton
    loop's last step can lie at round-off, and its line search then takes
    or rejects that step (below the exit's tolerance) on round-off, with
    equal iteration counts (tests/test_torch_batch_mhe.py); the GN
    iteration counts [max, sum // B] card vs CPU are printed a period; the
    ADMM sweep against its plain version on a call of a general-window
    fleet at the bench's shape (B = 256, n = 44, m = 208, float32; x̂
    within ±0.3 so that bounds are active: the first sweep from warm duals
    with the lane mask mixed); and one MovingHorizonEstimator (default ADMM
    general solver) in closed loop with a NaN window, so that both kernels
    run on the single-stream path."""
    from mpc_tpu_torch.parallel import BatchedMHE
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    cpu = torch.device("cpu")

    def lin(d, **kw):
        e = mt.MovingHorizonEstimator(mt.LinModel(mt.tf(3, [10, 1]), 1.0), He=He, device=d,
                                      **kw)
        return e.setconstraint(xhatmin=[-0.5, -0.5], xhatmax=[0.5, 0.5])

    def pend(d):
        kw = dict(sigmaQ=[0.1, 1.0], sigmaR=[0.5], nint_ym=[1], sigmaQint_ym=[0.1], device=d)
        p = pendulum(torch, mt, d)
        e = mt.MovingHorizonEstimator(p, He=He, covestim=mt.ExtendedKalmanFilter(p, **kw),
                                      qp_solver="active_set", **kw)
        return e.setconstraint(xhatmin=[-0.3, -5.0, -5.0], xhatmax=[0.3, 5.0, 5.0])
    cases = (("fast", lin, {}, (), 1e-9, 0.5), ("NaN variant", lin, {}, ((4, 1),), 1e-9, 0.5),
             ("general ADMM", lin, dict(solver="general"), ((4, 1),), 1e-8, 0.5),
             ("nonlinear", pend, {}, ((4, 0),), 1e-7, 10.0))
    for name, make, kw, nans, bar, scale in cases:
        fleets = [BatchedMHE(make(d), B, **kw) for d in (dev, cpu)]
        rng = np.random.default_rng(2)
        u, worst, worst_rel, its = None, 0.0, 0.0, []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(periods):
            ym = rng.normal(size=(B, 1)) * scale
            for kk, lane in nans:
                if kk == k:
                    ym[lane, 0] = np.nan
            x = [f.step(ym, u).cpu() for f in fleets]
            err = (x[0] - x[1]).abs().max().item()
            tol = bar * (1.0 + x[1].abs().max().item())
            check(err <= tol, f"small MHE fleet {name} period {k}: card vs CPU {err:.3e} > "
                  f"{tol:.3e}")
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / (1.0 + x[1].abs().max().item()))
            if not fleets[0]._lin:
                its.append([f.last_iters.tolist() for f in fleets])
            u = rng.normal(size=(B, 1)) * 0.2
        run = dict(ops.LAUNCHES)
        for key in launches:
            launches[key] += run[key]
        gn = (f"; GN iterations [max, sum // B] card, CPU {its}, equal in "
              f"{sum(a == b for a, b in its)}/{len(its)} periods" if its else "")
        print(f"small MHE fleet {name} f64 (B={B}, He={He}), {periods} periods: kernel launches "
              f"{run}; card vs CPU max |dx̂| {worst:.3e}, relative {worst_rel:.3e} (bar "
              f"{bar:g}·(1 + max|x̂|)){gn}", flush=True)
        check(sum(run.values()) > 0, f"small MHE fleet {name}: no kernel was launched")
    # the sweep at the general window of the bench's model
    gfleet, m = mhe_fleet(torch, mt, dev, 256, dtype=torch.float32, bound=0.3,
                          solver="general")
    ys, us, _ = mhe_trajectories(m, 256, 14, seed=4)
    rec = Recorder(ops.admm_sweep, sweep_warm_mixed)
    for k in range(13):
        if k == 11:
            gfleet.sweep = rec
        gfleet.step(ys[k], u_prev=(us[k - 1] if k else None))
    gfleet.sweep = ops.admm_sweep
    check(rec.args is not None, "MHE general window: no sweep started from warm duals "
          "with the lane mask mixed")
    admm_chk = kernel_vs_plain(torch, ops, "MHE general window", rec.args)
    admm_chk["lanes_per_sm"], geo = admm_residency(torch, ops, _build, admm_chk["args"])
    print(f"residency admm MHE general window: {admm_chk['lanes_per_sm']} lanes per SM ({geo})",
          flush=True)
    # the single estimator: the fast path (GI) on clean windows, the general
    # solver (ADMM) on windows holding the NaN
    ests = [lin(d, nint_ym=[1]) for d in (dev, cpu)]
    rng = np.random.default_rng(3)
    worst = {"GI": 0.0, "ADMM": 0.0}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for k in range(12):
        ym = rng.normal(size=1) * 0.5 + 1.0
        if k == 5:
            ym[0] = np.nan
        x = [e.preparestate(ym) for e in ests]
        route = "ADMM" if np.isnan(ests[1].Y0m_win[:ests[1].Nk]).any() else "GI"
        err = float(np.abs(x[0] - x[1]).max())
        bar = 1e-9 if route == "GI" else 1e-8
        check(err <= bar * (1.0 + np.abs(x[1]).max()), f"single MHE period {k} ({route}): "
              f"card vs CPU {err:.3e}")
        worst[route] = max(worst[route], err)
        u = rng.normal(size=1) * 0.3
        for e in ests:
            e.updatestate(u, ym)
    run = dict(ops.LAUNCHES)
    for key in launches:
        launches[key] += run[key]
    print(f"single MHE f64 (He={He}, default ADMM general solver, NaN at period 5), 12 "
          f"periods: kernel launches {run}; card vs CPU max |dx̂| GI windows {worst['GI']:.3e} "
          f"(bar 1e-9), ADMM windows {worst['ADMM']:.3e} (bar 1e-8)", flush=True)
    check(run["gi_solve"] > 0 and run["admm_sweep"] > 0,
          f"single MHE: kernel launches {run}, both kernels must run")
    return launches, admm_chk


# --- 30-33. the compiled closed loops (mpc_tpu_torch/sim_compiled.py) -------
SCAN_B, SCAN_N = 512, 100       # bench_scan.py's CompiledClosedLoop.run_fleet(512, 100)
SCAN_KW = dict(ry=[54.0, 30.0], y_noise=[0.1, 0.1], seed=0)


def scan_ctrl(torch, mt, qp_solver, device, dtype=None):
    """bench_scan.py's CSTR controller: the 2x2 CSTR LinModel (Ts = 2,
    uop = [20, 20], yop = [50, 30]), LinMPC(Hp=10, Hc=2, Mwt=[1, 1],
    Nwt=[0.1, 0.1]), 5 ≤ u ≤ 35, |Δu| ≤ 4, |y| ≤ 60."""
    G = np.array([[mt.tf(1.90, [18, 1]), mt.tf(1.90, [18, 1])],
                  [mt.tf(-0.74, [8, 1]), mt.tf(0.74, [8, 1])]], dtype=object)
    model = mt.LinModel(G, 2.0)
    model.setop(uop=[20, 20], yop=[50, 30])
    c = mt.LinMPC(model, Hp=10, Hc=2, Mwt=[1, 1], Nwt=[0.1, 0.1], qp_solver=qp_solver,
                  dtype=dtype, device=device)
    return c.setconstraint(umin=[5, 5], umax=[35, 35], dumin=[-4, -4], dumax=[4, 4],
                           ymin=[-60, -60], ymax=[60, 60])


def warm_dual(args):
    """A sweep that starts from max|y| ≥ Y_WARM on its active lanes."""
    y, active = args[10], args[11]
    return bool(active.any()) and y[active].abs().max().item() >= Y_WARM


def gi_warm_slots(args):
    """A GI solve that 5 % of its lanes or more enter with a valid slot of
    the carried operator state (an active input bound)."""
    return int(args[8].any(1).sum()) >= 0.05 * args[3].shape[0]


def loop_kernel_check(torch, ops, name, loop, attr, run, n_calls):
    """The kernel against its plain version on the inputs of one call the
    loop makes in ``run()`` (``attr`` "gi" or "sweep"): the first call from
    warm duals (the sweep) or with carried slots on 5 % of the lanes (GI) —
    the input bounds bind in the setpoint step's transient — else the call
    after the first ``n_calls``."""
    inner, got = getattr(loop, attr), {"n": 0}
    warm = warm_dual if attr == "sweep" else gi_warm_slots

    def wrapped(*args):
        if "warm" not in got and warm(args):
            got["warm"] = _clone(args)
        if "nth" not in got and got["n"] >= n_calls:
            got["nth"] = _clone(args)
        got["n"] += 1
        return inner(*args)
    setattr(loop, attr, wrapped)
    try:
        run()
    finally:
        setattr(loop, attr, inner)
    args = got.get("warm", got.get("nth"))
    check(args is not None, f"{name}: no {attr} call was captured")
    print(f"{name}: {attr} inputs of {'the first warm call' if 'warm' in got else n_calls} "
          f"of {got['n']} calls", flush=True)
    if attr == "sweep":
        return kernel_vs_plain(torch, ops, name, args)
    return gi_vs_plain(torch, ops, name, args, args[1].dtype == torch.float64)


def loop_syncs(torch, fn, n_steps):
    """Host syncs of one call of ``fn``, a run of ``n_steps`` steps (the
    sync-debug mode), and its device launches and busy time (the profiler),
    each also a step; the run's one upload and one download are 2 of the
    syncs, the rest are the steps'."""
    n_dev, busy, syncs, host = period_profile(torch, fn)
    return dict(syncs=syncs, syncs_per_step=(syncs - 2) / n_steps, device_launches=n_dev,
                launches_per_step=n_dev / n_steps, busy_ms=busy,
                busy_per_step=busy / n_steps, host_top=host)


def scan_phase(torch, mt, ops, _build, dev):
    """THIS SLICE'S MAIN PATH, bench_scan.py's cell: the CSTR LinMPC
    ``CompiledClosedLoop(ctrl).run_fleet(512, 100, ry=[54, 30],
    y_noise=[0.1, 0.1], seed=0)`` in float32 with GI (float64 slots) and with
    ADMM; 1 warm and 3 timed runs each, the launch counts set to 0 just
    before the timed runs and read just after; the noise drawn on the host
    timed apart; one run under the sync-debug mode and one under the
    profiler (a run of 20 steps); then each kernel against its plain version
    on the inputs of one call (``loop_kernel_check``).  Fails below 0.99
    converged over all B·N solves, outside 5 ≤ u ≤ 35, or when the loop's
    kernel was never launched (``run_fleet(mesh=...)`` is phase 36a's)."""
    from mpc_tpu_torch import sim_compiled as sc
    noise = []
    for _ in range(3):
        t0 = time.perf_counter()
        sc._fleet_noise(SCAN_B, SCAN_N, 0, 2, 2, 2, np.array([0.1, 0.1]), np.zeros(2),
                        np.zeros(2), 0)
        noise.append(time.perf_counter() - t0)
    noise_s = statistics.median(noise)
    out = {}
    for qp, kernel, attr in (("active_set", "gi_solve", "gi"), ("admm", "admm_sweep", "sweep")):
        loop = sc.CompiledClosedLoop(scan_ctrl(torch, mt, qp, dev, torch.float32))
        call = lambda: loop.run_fleet(SCAN_B, SCAN_N, **SCAN_KW)
        call()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fl = call()          # ends in the copy of the outputs to the host
            walls.append(time.perf_counter() - t0)
        launches = dict(ops.LAUNCHES)
        check(launches[kernel] > 0, f"scan-CSTR {qp}: the {kernel} kernel was never launched")
        conv = float(fl["conv"].mean())
        U = fl["U"]
        check(conv >= 0.99, f"scan-CSTR {qp}: converged share {conv:.4f} < 0.99")
        check(np.isfinite(U).all() and U.min() >= 5 - 1e-3 and U.max() <= 35 + 1e-3,
              f"scan-CSTR {qp}: u outside [5, 35] ({U.min():.4f}, {U.max():.4f})")
        wall = statistics.median(walls)
        prof = loop_syncs(torch, lambda: loop.run_fleet(SCAN_B, 20, **SCAN_KW), 20)
        idle = 1.0 - prof["busy_per_step"] * SCAN_N / (wall * 1e3)
        step_ms = (wall - noise_s) / SCAN_N * 1e3     # the loop alone, a step
        idle_loop = 1.0 - prof["busy_per_step"] / step_ms
        per_step = launches[kernel] / (3 * SCAN_N)
        print(f"scan-CSTR {qp} (B={SCAN_B}, N={SCAN_N}, f32): run median {wall * 1e3:.1f} ms "
              f"({SCAN_B * SCAN_N / wall:.0f} controlled steps/s; runs "
              f"{[round(w * 1e3, 1) for w in walls]} ms), of which the host noise draw "
              f"{noise_s * 1e3:.1f} ms ({SCAN_B * SCAN_N / (wall - noise_s):.0f} steps/s "
              f"without it); converged {conv:.4f} of B·N; y1 at the end "
              f"{float(fl['Y'][:, -1, 0].mean()):.3f}; {kernel} launches {launches[kernel]} in 3 "
              f"runs = {per_step:.2f} a step; host syncs in a run {prof['syncs']} "
              f"({prof['syncs_per_step']:.2f} a step besides the upload and the download); "
              f"device launches {prof['launches_per_step']:.1f} and busy "
              f"{prof['busy_per_step']:.3f} ms a step (a profiled run of 20 steps); the loop "
              f"{step_ms:.3f} ms a step; idle share of a run {idle:.4f}, of the loop alone "
              f"{idle_loop:.4f}; host top {prof['host_top']}", flush=True)
        short = lambda: loop.run_fleet(SCAN_B, 12, **SCAN_KW)
        calls = 10 if attr == "gi" else 10 * max(1, round(per_step))
        chk = loop_kernel_check(torch, ops, f"scan-CSTR {qp} B={SCAN_B}", loop, attr, short,
                                calls)
        out[qp] = dict(chk, launches=launches[kernel], per_period=per_step, wall_ms=wall * 1e3,
                       steps_per_s=SCAN_B * SCAN_N / wall, noise_ms=noise_s * 1e3, conv=conv,
                       syncs_per_step=prof["syncs_per_step"], idle_share=idle,
                       idle_loop=idle_loop, step_ms=step_ms,
                       launches_all=launches)
    return out


def sweep_dims(c):
    return f"n={c['args']['x'].shape[1]} m={c['args']['z'].shape[1]}"


def gi_dims(c):
    a = c["args"]
    return f"n={a[3].shape[1]} m={a[4].shape[1]} {a[6].shape[1]} slots"


def hetero_phase(torch, mt, ops, dev, B=128, N=20):
    """``CompiledClosedLoopFleet`` of B random CSTR controllers (the
    headline's, seed 0; n_d = B, float64 as the reference's fleet), GI and
    ADMM, N periods, with each kernel against its plain version on the
    inputs of one call (``loop_kernel_check``)."""
    from mpc_tpu_torch import sim_compiled as sc
    from mpc_tpu_torch.parallel import random_cstr_controllers
    out = {}
    for qp, kernel, attr in (("active_set", "gi_solve", "gi"), ("admm", "admm_sweep", "sweep")):
        fleet = sc.CompiledClosedLoopFleet(random_cstr_controllers(B, Hp=10, Hc=2, seed=0,
                                                                   qp_solver=qp, device=dev))
        call = lambda n: fleet.run(n, ry=[5.0, 1.0], y_noise=[0.1, 0.1], seed=0)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fl = call(N)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        check(launches[kernel] > 0, f"fleet {qp}: the {kernel} kernel was never launched")
        conv = float(fl["conv"].mean())
        check(conv >= 0.99, f"fleet {qp}: converged share {conv:.4f} < 0.99")
        per_step = launches[kernel] / N
        print(f"CompiledClosedLoopFleet {qp} (B=n_d={B}, N={N}, f64): {wall * 1e3:.1f} ms "
              f"({B * N / wall:.0f} steps/s), converged {conv:.4f}, {kernel} "
              f"{per_step:.2f} a step", flush=True)
        calls = 10 if attr == "gi" else 10 * max(1, round(per_step))
        chk = loop_kernel_check(torch, ops, f"fleet {qp} B=n_d={B} f64", fleet, attr,
                                lambda: call(12), calls)
        out[qp] = dict(chk, launches=launches[kernel], per_period=per_step)
    return out


SL_LOOP = dict(Hp=20, nint_ym=[1])   # tests/test_sim_compiled.py's SLMPC (:67-98)


def sl_loop_phase(torch, mt, ops, dev, B=4096, N=40):
    """``CompiledSLLoop.run_fleet`` of the reference test's SLMPC, B = 4096,
    N = 40, float32 (GI, float64 slots), from rest with y noise 1°: 1 warm
    run of 2 steps, 1 counted run.  Fails below 0.99 converged or for
    |u| > 1.5."""
    from mpc_tpu_torch import sim_compiled as sc
    loop = sc.CompiledSLLoop(slmpc(torch, mt, dev, dtype=torch.float32, **SL_LOOP))
    kw = dict(ry=[180.0], y_noise=[1.0], seed=0)
    loop.run_fleet(B, 2, **kw)
    t0 = time.perf_counter()
    sc._fleet_noise(B, N, 0, 1, 1, 2, np.ones(1), np.zeros(1), np.zeros(2), 0)
    noise_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fl = loop.run_fleet(B, N, **kw)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["gi_solve"] > 0, "SL loop: the GI kernel was never launched")
    conv = float(fl["conv"].mean())
    umax = float(np.abs(fl["U"]).max())
    check(conv >= 0.99, f"SL loop: converged share {conv:.4f} < 0.99")
    check(np.isfinite(fl["U"]).all() and umax <= 1.5 + 1e-5, f"SL loop: max |u| {umax}")
    print(f"CompiledSLLoop.run_fleet (B={B}, N={N}, f32, GI): {wall * 1e3:.1f} ms "
          f"({B * N / wall:.0f} controlled steps/s; the host noise draw {noise_s * 1e3:.1f} "
          f"ms of it, {B * N / (wall - noise_s):.0f} steps/s without it; the loop "
          f"{(wall - noise_s) / N * 1e3:.2f} ms a step), converged {conv:.4f}, max |u| "
          f"{umax:.4f}, y at the end "
          f"{float(fl['Y'][:, -1, 0].mean()):.2f}°, GI launches {launches['gi_solve']} "
          f"({launches['gi_solve'] / N:.2f} a step)", flush=True)
    return launches


def nl_loop_phase(torch, mt, ops, dev, B=1024, N=20):
    """``CompiledNonLinLoop.run_fleet`` of bench.py's NonLinMPC (the
    pendulum, MultipleShooting, the UKF at α = 0.5, GI), B = 1024, N = 20
    (the depth cut to keep the phase short), float32, from rest with y
    noise 1°: 1 warm run of 2 steps, 1 counted run (SQP exit tests, lane
    iterations), 1 run of 2 steps under the sync-debug mode and the
    profiler."""
    from mpc_tpu_torch import sim_compiled as sc
    from mpc_tpu_torch.controllers import nonlinmpc as NL
    loop = sc.CompiledNonLinLoop(nonlin_ctrl(torch, mt, dev, dtype=torch.float32))
    kw = dict(ry=[180.0], y_noise=[1.0], seed=0)
    loop.run_fleet(B, 2, **kw)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    n0 = NL.COUNTS["sqp_exit_tests"]
    t0 = time.perf_counter()
    fl = loop.run_fleet(B, N, **kw)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    exits = NL.COUNTS["sqp_exit_tests"] - n0
    check(launches["gi_solve"] > 0, "NonLin loop: the GI kernel was never launched")
    umax = float(np.abs(fl["U"]).max())
    check(np.isfinite(fl["U"]).all() and umax <= 1.5 + 1e-5, f"NonLin loop: max |u| {umax}")
    its = loop.last_iters
    prof = loop_syncs(torch, lambda: loop.run_fleet(B, 2, **kw), 2)
    print(f"CompiledNonLinLoop.run_fleet (B={B}, N={N}, f32, GI): {wall * 1e3:.1f} ms "
          f"({B * N / wall:.0f} controlled steps/s, {wall / N * 1e3:.1f} ms a step); SQP "
          f"iterations a lane-step max {its.max()}, mean {its.mean():.2f}; {exits / N:.2f} exit "
          f"tests and {launches['gi_solve'] / N:.2f} GI launches a step; host syncs "
          f"{prof['syncs_per_step']:.2f} a step besides the upload and the download; device "
          f"launches {prof['launches_per_step']:.0f} a step, busy {prof['busy_per_step']:.2f} ms a "
          f"step (idle share {1 - prof['busy_per_step'] / (wall / N * 1e3):.4f}); max |u| "
          f"{umax:.4f}, y at the end "
          f"{float(fl['Y'][:, -1, 0].mean()):.2f}°", flush=True)
    return launches


def compiled_card_vs_cpu(torch, mt, ops, dev):
    """Phase 33: each compiled loop in float64 on the card (the kernels) and
    on the CPU (the plain versions, which the CPU tests hold to mpc_tpu):
    every returned array within its solver's bar ·(1 + max|·|) — GI 1e-9,
    ADMM 1e-8, SL-GI 1e-9, NonLin 1e-6 (an SQP exit test on round-off),
    MHE 1e-9 (GI windows) — with the loop's kernel launched on the card."""
    from mpc_tpu_torch import sim_compiled as sc
    from mpc_tpu_torch.parallel import random_cstr_controllers

    def cstr(d, qp):
        return scan_ctrl(torch, mt, qp, d)

    noise = dict(ry=[54.0, 30.0], y_noise=[0.1, 0.1], u_noise=[0.05, 0.05], seed=7)

    def mhe(d):
        e = mt.MovingHorizonEstimator(mt.LinModel(mt.tf(3, [10, 1]), 1.0), He=5,
                                      qp_solver="active_set", device=d)
        e.setconstraint(xhatmin=[-0.5, -0.5], xhatmax=[0.5, 0.5])
        rng = np.random.default_rng(3)
        Ym, U = rng.normal(size=(60, 1)), rng.normal(size=(60, 1)) * 0.2
        Ym[[7, 23, 24]] = np.nan
        return sc.CompiledMHELoop(e).run(Ym, U)

    def mhe_mpc(d):
        m = lambda: mt.LinModel(mt.tf(3, [10, 1]), 1.0)
        e = mt.MovingHorizonEstimator(m(), He=5, device=d)
        e.initstate(np.zeros(1), np.zeros(1))
        c = mt.LinMPC(mt.ManualEstimator(m()), Hp=10, Hc=2, device=d)
        return vars(sc.CompiledMHEMPCLoop(e, c).run(40, ry=[4.0], y_noise=[0.1], seed=3))

    cases = {
        "run ADMM": (lambda d: vars(sc.CompiledClosedLoop(cstr(d, "admm")).run(30, **noise)),
                     1e-8, "admm_sweep"),
        "run GI": (lambda d: vars(sc.CompiledClosedLoop(cstr(d, "active_set")).run(30, **noise)),
                   1e-9, "gi_solve"),
        "run_fleet ADMM": (lambda d: sc.CompiledClosedLoop(cstr(d, "admm")).run_fleet(
            8, 30, **noise), 1e-8, "admm_sweep"),
        "run_fleet GI": (lambda d: sc.CompiledClosedLoop(cstr(d, "active_set")).run_fleet(
            8, 30, **noise), 1e-9, "gi_solve"),
        "CompiledClosedLoopFleet ADMM": (lambda d: sc.CompiledClosedLoopFleet(
            random_cstr_controllers(8, Hp=10, Hc=2, seed=1, device=d)).run(
            30, ry=[5.0, 1.0], y_noise=[0.1, 0.1], seed=2), 1e-8, "admm_sweep"),
        "SL run": (lambda d: vars(sc.CompiledSLLoop(slmpc(torch, mt, d, **SL_LOOP)).run(
            40, ry=[180.0], y_noise=[1.0], seed=1)), 1e-9, "gi_solve"),
        "NonLin run_fleet": (lambda d: sc.CompiledNonLinLoop(nonlin_ctrl(torch, mt, d)).run_fleet(
            2, 12, ry=[180.0], y_noise=[1.0], seed=4), 1e-6, "gi_solve"),
        "MHE (GI windows, NaN dropouts)": (mhe, 1e-9, "gi_solve"),
        "MHE+MPC (ADMM)": (mhe_mpc, 1e-8, "admm_sweep"),
    }
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    cpu = torch.device("cpu")
    for name, (make, bar, kernel) in cases.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        card = make(dev)
        torch.cuda.synchronize()
        run = dict(ops.LAUNCHES)
        check(run[kernel] > 0, f"compiled {name}: the {kernel} kernel was never launched")
        for k in launches:
            launches[k] += run[k]
        ref = make(cpu)
        worst = 0.0
        for k, v in ref.items():
            if not isinstance(v, np.ndarray) or v.dtype == object:
                continue
            a, b = np.asarray(card[k], float), np.asarray(v, float)
            check(a.shape == b.shape and np.array_equal(np.isfinite(a), np.isfinite(b)),
                  f"compiled {name}: {k} shapes or finite entries differ")
            err = float(np.max(np.abs(np.nan_to_num(a - b)), initial=0.0))
            tol = bar * (1 + float(np.max(np.abs(np.nan_to_num(b)), initial=0.0)))
            check(err <= tol, f"compiled {name}: card vs CPU |d{k}| {err:.3e} > {tol:.3e}")
            worst = max(worst, err / tol * bar)
        print(f"compiled {name} f64: card vs CPU worst {worst:.3e} relative (bar {bar:g}); "
              f"launches {run}", flush=True)
    return launches


# --- phases 34-36: the embedded C export, the native executor, the mesh ----
EXPORT_STEPS = 15
RT_STEPS, RT_PERIOD = 500, 1e-3


class CStep:
    """One compiled controller (``mpc_tpu_torch.codegen``) driven through
    ctypes: ``step(ym, ry, d) -> u`` on its own ``<name>_state_t``."""

    def __init__(self, lib, name, ctrl, solver):
        import ctypes
        self.ct, self.lib, self.name = ctypes, lib, name
        self.nu, m = ctrl.estim.model.nu, ctrl.A_stack.shape[0]
        fields = [("xhat", ctypes.c_double * ctrl.estim.nx_hat),
                  ("lastu0", ctypes.c_double * self.nu), ("z", ctypes.c_double * ctrl.nZt)]
        fields += [("zd", ctypes.c_double * m)] if solver == "admm" else []
        fields += [("yd", ctypes.c_double * m)]
        self.State = type("State", (ctypes.Structure,), {"_fields_": fields})
        self.st = self.fresh()
        self.fn = getattr(lib, f"{name}_step")

    def fresh(self):
        st = self.State()
        getattr(self.lib, f"{self.name}_init")(self.ct.byref(st))
        return st

    def step(self, ym, ry, d=()):
        ct = self.ct
        arr = lambda v: (ct.c_double * max(len(v), 1))(*v)
        u = (ct.c_double * self.nu)()
        a = (arr(list(ym)), arr(list(ry)), arr(list(d)))
        t0 = time.perf_counter()
        self.fn(ct.byref(self.st), *a, u)
        return np.array(u[:]), time.perf_counter() - t0


def export_controllers(mt, dev):
    """tests/test_codegen.py's controllers and the README controller with
    GI, on ``dev``: ``name: (controller, export solver, ry, d, ym mean,
    ym noise, bar on |u_C − u_moveinput|)`` (the reference tests' bars)."""
    def siso():
        m = mt.LinModel(mt.tf(3, [10, 1]), 1.0)
        m.setop(uop=[2.0], yop=[5.0])
        c = mt.LinMPC(m, Hp=10, Hc=2, Cwt=1e5, device=dev)
        return c.setconstraint(umin=[-10], umax=[10], dumax=[3], dumin=[-3], ymax=[9.0],
                               ymin=[0.0])

    def mimo_d():
        G = np.array([[mt.tf(1.9, [18, 1])] * 3,
                      [mt.tf(-0.74, [8, 1]), mt.tf(0.74, [8, 1]), mt.tf(-0.74, [8, 1])]],
                     dtype=object)
        c = mt.LinMPC(mt.LinModel(G, 2.0, i_d=[2]), Hp=8, Hc=2, Cwt=1e5, device=dev)
        return c.setconstraint(umax=[4.0, 4.0], umin=[-4.0, -4.0])

    def luenberger():
        m = mt.LinModel(mt.tf(3, [10, 1]), 1.0)
        c = mt.LinMPC(mt.Luenberger(m, nint_ym=[1], poles=[0.4, 0.45]), Hp=10, Hc=2,
                      device=dev)
        return c.setconstraint(umax=[2.0])

    def soft():
        c = mt.LinMPC(mt.LinModel(mt.tf(3, [10, 1]), 1.0), Hp=8, Hc=2, Cwt=1e2, device=dev)
        return c.setconstraint(umin=[-0.5], umax=[0.5], c_umin=[1.0], c_umax=[1.0],
                               ymin=[2.0])

    return {
        "siso ADMM": (siso(), "admm", [7.0], (), [5.0], 0.3, 2e-4),
        "mimo_d ADMM": (mimo_d(), "admm", [1.0, -0.5], (0.3,), [0.0, 0.0], 0.5, 5e-4),
        "luenberger ADMM": (luenberger(), "admm", [2.5], (), [1.0], 0.3, 2e-4),
        "siso active set": (siso(), "active_set", [7.0], (), [5.0], 0.3, 1e-9),
        "soft ADMM": (soft(), "admm", [3.0], (), [0.0], 0.1, 5e-3),
        "README GI": (readme_controller(mt, "active_set", dev), "active_set", [5.0, 0.0], (),
                      [0.0, 0.0], 0.5, 1e-9),
    }


def export_phase(torch, mt, ops, dev):
    """Phase 34: each controller of ``export_controllers`` built on the
    card, exported (``export_c`` reads its host params) and compiled with
    gcc; the C step and the controller's ``moveinput`` on the card (which
    launches the GI or ADMM kernel) over the same noisy measurements, u to
    the reference test's bar every period.  Returns the launch counts and
    the README GI controller's compiled step for phase 35."""
    from mpc_tpu_torch.codegen import compile_and_load, export_c
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    keep = None
    for i, (name, (ctrl, solver, ry, d, mean, noise, bar)) in enumerate(
            export_controllers(mt, dev).items()):
        t0 = time.perf_counter()
        lname = f"smoke{i}"
        src = export_c(ctrl, name=lname, solver=solver)
        cstep = CStep(compile_and_load(src, name=lname), lname, ctrl, solver)
        build_s = time.perf_counter() - t0
        rng = np.random.default_rng(3 + i)
        ny = ctrl.estim.model.ny
        worst, times = 0.0, []
        dd = [np.asarray(d)] if d else []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for k in range(EXPORT_STEPS):
            y = np.asarray(mean, float) + rng.normal(size=ny) * noise
            ctrl.preparestate(y, *dd)
            u = ctrl.moveinput(ry, *dd)
            ctrl.updatestate(u, y, *dd)
            uc, dt = cstep.step(y, ry, d)
            times.append(dt)
            worst = max(worst, float(np.max(np.abs(uc - u))))
        torch.cuda.synchronize()
        run = dict(ops.LAUNCHES)
        for k in launches:
            launches[k] += run[k]
        kernel = "gi_solve" if ctrl.qp_solver == "active_set" else "admm_sweep"
        print(f"export {name} ({solver} export, {ctrl.qp_solver} controller, m="
              f"{ctrl.A_stack.shape[0]}, {len(src) / 1e3:.0f} kB of C, export + gcc "
              f"{build_s:.2f} s): worst |u_C - u_moveinput| {worst:.3e} (bar {bar:g}) over "
              f"{EXPORT_STEPS} periods; C step median {statistics.median(times) * 1e6:.1f} us "
              f"on the host CPU (ctypes call included); card launches {run}", flush=True)
        check(run[kernel] >= EXPORT_STEPS, f"export {name}: moveinput launched {kernel} "
              f"{run[kernel]} times in {EXPORT_STEPS} periods")
        check(worst < bar, f"export {name}: |u_C - u_moveinput| {worst:.3e} ≥ {bar:g}")
        if name == "README GI":
            keep = (cstep, ctrl)
    return launches, keep


def rt_phase(readme_gi):
    """Phase 35: the exported README GI controller under the native
    executor, 500 periods of 1 ms on the host CPU: every step done, u
    bitwise equal to phase 34's ctypes loop (``CStep``) on the same
    inputs from a fresh state, the wall time within 10 % + 50 ms of 0.5 s,
    and every step a budget overrun at a 1 ns budget."""
    from mpc_tpu_torch.native import build_executor, rt_run_exported
    cstep, ctrl = readme_gi
    t0 = time.perf_counter()
    build_executor()
    build_s = time.perf_counter() - t0
    nym, ny, nd, nu = ctrl.estim.nym, ctrl.estim.model.ny, ctrl.estim.model.nd, ctrl.estim.model.nu
    rng = np.random.default_rng(11)
    ym = rng.normal(size=(RT_STEPS, nym)) * 0.5
    ry = np.tile([5.0, 0.0], (RT_STEPS, 1))
    cstep.st = cstep.fresh()
    U_ref = np.stack([cstep.step(ym[k], ry[k])[0] for k in range(RT_STEPS)])
    t0 = time.perf_counter()
    U, stats = rt_run_exported(cstep.lib, cstep.name, cstep.fresh(), ym, ry, None, RT_PERIOD,
                               nym, ny, nd, nu)
    wall = time.perf_counter() - t0
    s = stats.asdict()
    _, tight = rt_run_exported(cstep.lib, cstep.name, cstep.fresh(), ym, ry, None, RT_PERIOD,
                               nym, ny, nd, nu, budget_s=1e-9)
    target = RT_STEPS * RT_PERIOD
    print(f"native executor (host CPU of the card machine; g++ build {build_s:.2f} s): "
          f"{s['steps_done']} steps of {RT_PERIOD * 1e3:g} ms in {wall:.4f} s (target "
          f"{target:g} s); deadline misses {s['deadline_misses']}; jitter max "
          f"{s['max_jitter_ns'] / 1e3:.1f} us mean {s['mean_jitter_ns'] / 1e3:.2f} us; exec "
          f"max {s['max_exec_ns'] / 1e3:.1f} us mean {s['mean_exec_ns'] / 1e3:.2f} us; "
          f"u bitwise equal to the ctypes loop: {np.array_equal(U, U_ref)}; 1 ns budget "
          f"overruns {tight.budget_overruns}/{RT_STEPS}", flush=True)
    check(s["steps_done"] == RT_STEPS, f"executor: {s['steps_done']} steps done of {RT_STEPS}")
    check(np.array_equal(U, U_ref), "executor: u differs from the ctypes-driven loop")
    check(abs(wall - target) <= 0.1 * target + 0.05,
          f"executor: {RT_STEPS} periods took {wall:.4f} s, not {target:g} s ± 10 % + 50 ms")
    check(tight.budget_overruns == RT_STEPS, f"executor: 1 ns budget gave "
          f"{tight.budget_overruns} overruns of {RT_STEPS} steps")
    return dict(s, wall_s=wall)


def mesh_devices_k(torch, k):
    """A mesh of ``k`` shards over the visible cards: ``["cuda:0"] * k`` on
    one card, the cards in turn when there are more."""
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(k)]


def count_syncs(torch, fn):
    """Host syncs of one call of ``fn`` (the sync-debug mode's warnings)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(r.message) for r in rec)


def dryrun_pipelines(torch, mt, ops, dev):
    """Phase 36a: ``__graft_entry__.dryrun_multichip``'s four pipelines with
    a port API (B = 8), on meshes of 1, 2 and 4 shards, each against the
    unsharded object at the reference's bars (1e-6; 5e-5 for the float32
    compiled loop)."""
    from mpc_tpu_torch import sim_compiled as sc
    from mpc_tpu_torch.parallel import (BatchedLinMPC, BatchedMHE, BatchedNonLinMPC,
                                        random_cstr_controllers)
    B = 8
    nm = mt.NonLinModel(lambda x, u, d, p: 0.5 * x + u, lambda x, d, p: 2.0 * x, 1.0, 1, 1, 1,
                        solver=None, device=dev)
    lm = mt.LinModel(mt.ss(0.6, 1.0, 1.0, 0.0, 1.0), 1.0)
    rng = np.random.default_rng(0)
    ym_mhe = rng.normal(size=(4, B, 1)) * 0.3

    def lin(mesh):
        f = BatchedLinMPC(random_cstr_controllers(B, Hp=5, Hc=2, seed=0, device=dev),
                          dtype=torch.float32, device=None if mesh else dev, mesh=mesh)
        u, nc = f.step(np.zeros((B, 2), np.float32), np.ones((B, 2), np.float32))
        check(int(nc) == B, f"mesh LinMPC fleet: {int(nc)}/{B} converged")
        return u.cpu().numpy()

    def loop(mesh):
        c = random_cstr_controllers(1, Hp=5, Hc=2, seed=1, device=dev, dtype=torch.float32)[0]
        return sc.CompiledClosedLoop(c).run_fleet(B, 3, ry=[5.0, 1.0], y_noise=[0.05, 0.05],
                                                  seed=0, mesh=mesh)["U"]

    def nonlin(mesh):
        t = mt.NonLinMPC(nm, Hp=4, Hc=2, sqp_iters=4, alpha=0.5, device=dev)
        u, _ = BatchedNonLinMPC(t, B, dtype=torch.float32, mesh=mesh).step(
            np.zeros((B, 1), np.float32), np.linspace(0.5, 1.5, B)[:, None].astype(np.float32))
        return u.cpu().numpy()

    def mhe(mesh):
        f = BatchedMHE(mt.MovingHorizonEstimator(lm, He=3, device=dev), B, mesh=mesh)
        for k in range(4):
            x = f.step(ym_mhe[k], u_prev=np.zeros((B, 1)))
        return x.cpu().numpy()

    launches = dict.fromkeys(ops.LAUNCHES, 0)
    worst = {}
    for name, fn, bar in (("BatchedLinMPC", lin, 1e-6), ("CompiledClosedLoop.run_fleet f32",
                                                          loop, 5e-5),
                          ("BatchedNonLinMPC", nonlin, 1e-6), ("BatchedMHE", mhe, 1e-6)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ref = fn(None)
        for k in (1, 2, 4):
            got = fn(mesh_devices_k(torch, k))
            err = float(np.max(np.abs(got - ref)))
            worst[(name, k)] = err
            check(np.all(np.isfinite(got)) and err <= bar,
                  f"mesh {name} k={k}: |sharded - unsharded| {err:.3e} > {bar:g}")
        torch.cuda.synchronize()
        for kk, v in ops.LAUNCHES.items():
            launches[kk] += v
        print(f"mesh {name} (B={B}) on 1, 2, 4 shards of {mesh_devices_k(torch, 4)}: max "
              f"|sharded - unsharded| {[worst[(name, k)] for k in (1, 2, 4)]} (bar {bar:g}); "
              f"launches {dict(ops.LAUNCHES)}", flush=True)
    check(launches["gi_solve"] > 0 and launches["admm_sweep"] > 0,
          f"mesh pipelines: a kernel was never launched ({launches})")
    return launches


def headline_mesh_phase(torch, ops, dev, periods=8, n_d=256, reps=16):
    """Phase 36b: the headline-GI fleet (256 distinct x 16 = 4096 lanes,
    float32, float64 slots) unsharded and on 1, 2 and 4 shards, in one
    closed loop driven by the unsharded fleet's u: every period each sharded
    u within F32_TOL·(1 + max|u|) of the unsharded one and every lane
    converged; the period wall time (median of ``periods`` after one warm
    period), GI launches a period and solves/s for each k."""
    from mpc_tpu_torch.parallel import BatchedLinMPC, random_cstr_controllers
    cs = random_cstr_controllers(n_d, Hp=10, Hc=2, seed=0, qp_solver="active_set",
                                 device=dev)
    kw = dict(reps=reps, dtype=torch.float32)
    fleets = {0: BatchedLinMPC(cs, device=dev, **kw)}
    for k in (1, 2, 4):
        fleets[k] = BatchedLinMPC(cs, mesh=mesh_devices_k(torch, k), **kw)
    loop = ClosedLoop(torch, cs, reps, dev, torch.float32)
    B = fleets[0].B
    walls = {k: [] for k in fleets}
    launches = {k: 0 for k in fleets}
    worst = {k: 0.0 for k in fleets}
    for p in range(periods + 1):
        ym, ry = loop.measure(p)
        outs = {}
        for k, f in fleets.items():
            torch.cuda.synchronize()
            n0 = ops.LAUNCHES["gi_solve"]
            t0 = time.perf_counter()
            u, nc = f.step(ym, ry)
            nc = int(nc)
            dt = time.perf_counter() - t0
            launches[k] += ops.LAUNCHES["gi_solve"] - n0
            if p:
                walls[k].append(dt)
            outs[k] = u
            check(nc == B, f"headline-GI mesh k={k}: {nc}/{B} converged in period {p}")
        for k in (1, 2, 4):
            err = float((outs[k] - outs[0]).abs().max())
            worst[k] = max(worst[k], err)
            check(err <= F32_TOL * (1 + float(outs[0].abs().max())),
                  f"headline-GI mesh k={k}: |sharded - unsharded| {err:.3e} in period {p}")
        loop.advance(outs[0])
    out = {}
    for k in fleets:
        med = statistics.median(walls[k])
        out[k] = dict(period_ms=med * 1e3, solves_per_s=B / med,
                      gi_launches_per_period=launches[k] / (periods + 1), err=worst[k])
    label = {0: "unsharded", 1: "k=1", 2: "k=2", 4: "k=4"}
    print(f"headline-GI on a mesh (B={B}, f32, f64 slots, "
          f"{periods} periods after 1 warm): " + "; ".join(
              f"{label[k]} period median {v['period_ms']:.3f} ms, {v['solves_per_s']:.0f} "
              f"solves/s, {v['gi_launches_per_period']:g} GI launches a period, max |du| vs "
              f"unsharded {v['err']:.3e}" for k, v in out.items()), flush=True)
    return {"gi_solve": sum(launches.values()), "admm_sweep": 0}, out


def f32_spread(torch, fleet, ops, ym, ry):
    """Lanes whose u moves beyond F32_TOL·(1 + max|u|) when the same period
    of ``fleet`` (an ADMM fleet, from one snapshot) runs with the plain
    sweep instead of the kernel: the float32 spread that exists without
    any change of batch layout.  The fleet's state is restored."""
    snap = fleet.state
    u_k, _ = fleet.step(ym, ry)
    fleet.state, fleet.sweep = snap, ops.admm_sweep_reference
    u_p, _ = fleet.step(ym, ry)
    fleet.state, fleet.sweep = snap, ops.admm_sweep
    du = (u_k - u_p).abs().amax(1)
    return int((du > F32_TOL * (1 + float(u_p.abs().max()))).sum()), float(du.max())


def large_chunks_phase(torch, mt, ops, dev, periods=4, n_d=32, reps=128, f64_reps=8):
    """Phase 36c: large-ADMM (32 distinct 8x8 plants, Hp=15, Hc=4, x 128 =
    4096 lanes, float32) with ``grouped_chunks`` 1 and 8, ``periods``
    closed-loop periods each from the same start after one warm period: the
    same converged count, and u within F32_TOL·(1 + max|u|) on all but at
    most CHUNK_FLIPS lanes; the period wall time, the sweep launches and
    host syncs a period.  In float32 a lane's ADMM answer depends on the
    launch's batch layout (8 chunks launch 512 lanes, whose sums the
    kernel and the plain version alike order otherwise), so the f32 spread
    of one period, kernel against plain at one layout, is printed beside
    it; the chunking itself is held in float64 (x ``f64_reps``, 2 periods),
    every lane within 1e-9·(1 + max|u|)."""
    from mpc_tpu_torch.parallel import BatchedLinMPC
    cs = large_controllers(mt, n_d, device=dev)
    launches = 0
    for dt, rp, n_per in ((torch.float64, f64_reps, 2), (torch.float32, reps, periods)):
        fleets = {n: BatchedLinMPC(cs, reps=rp, device=dev, dtype=dt, grouped_chunks=n)
                  for n in (1, 8)}
        B = fleets[1].B
        loop = ClosedLoop(torch, cs, rp, dev, dt)
        stats = {n: dict(walls=[], launches=0, syncs=0) for n in fleets}
        worst, flips = 0.0, 0
        for p in range(n_per + 1):
            ym, ry = loop.measure(p)
            outs = {}
            for n, f in fleets.items():
                n0 = ops.LAUNCHES["admm_sweep"]
                t0 = time.perf_counter()
                (u, nc), syncs = count_syncs(torch, lambda: f.step(ym, ry))
                dt_s = time.perf_counter() - t0
                outs[n] = (u, int(nc))
                stats[n]["launches"] += ops.LAUNCHES["admm_sweep"] - n0
                if p:
                    stats[n]["walls"].append(dt_s)
                    stats[n]["syncs"] += syncs
            du = (outs[8][0] - outs[1][0]).abs().amax(1)
            bar = (1e-9 if dt == torch.float64 else F32_TOL) * (1 + float(outs[1][0].abs().max()))
            over = int((du > bar).sum())
            worst, flips = max(worst, float(du.max())), max(flips, over)
            check(bool(torch.isfinite(outs[8][0]).all()) and outs[8][1] == outs[1][1]
                  and outs[1][1] >= 0.99 * B,
                  f"large-ADMM {dt} grouped_chunks=8: n_conv {outs[8][1]} against "
                  f"{outs[1][1]} of {B} in period {p}")
            check(over <= (0 if dt == torch.float64 else CHUNK_FLIPS),
                  f"large-ADMM {dt} grouped_chunks=8: {over} lanes beyond {bar:.3e} of 1 chunk "
                  f"(max |du| {float(du.max()):.3e}) in period {p}")
            loop.advance(outs[1][0])
        launches += sum(s["launches"] for s in stats.values())
        if dt == torch.float64:
            print(f"large-ADMM grouped_chunks f64 (B={B}, 2 periods after 1 warm): max |du| "
                  f"8 chunks vs 1 {worst:.3e} (bar 1e-9·(1 + max|u|)); n_conv {outs[1][1]}",
                  flush=True)
            continue
        spread = f32_spread(torch, fleets[1], ops, *loop.measure(n_per + 1))
        out = {n: dict(period_ms=statistics.median(s["walls"]) * 1e3,
                       sweep_launches_per_period=s["launches"] / (n_per + 1),
                       host_syncs_per_period=s["syncs"] / n_per,
                       n_conv_last=outs[n][1]) for n, s in stats.items()}
        print(f"large-ADMM grouped_chunks (B={B}, f32, {n_per} periods after 1 warm, timed "
              f"with the sync-debug mode on): " + "; ".join(
                  f"{n} chunk(s) period median {v['period_ms']:.2f} ms, "
                  f"{v['sweep_launches_per_period']:g} sweep launches and "
                  f"{v['host_syncs_per_period']:g} host syncs a period, last n_conv "
                  f"{v['n_conv_last']}" for n, v in out.items())
              + f"; max |du| 8 chunks vs 1 {worst:.3e}, at most {flips} lanes beyond F32_TOL "
              f"a period; f32 spread of one period, kernel vs plain sweep unchunked: "
              f"{spread[0]} lanes beyond F32_TOL, max |du| {spread[1]:.3e}", flush=True)
    return {"admm_sweep": launches, "gi_solve": 0}, dict(out, flips=flips, worst=worst,
                                                         spread=spread)


def mesh_phase(torch, mt, ops, dev, small=False):
    """Phase 36: the mesh and the chunks (36a-c); returns the launch counts.
    ``small`` cuts 36b and 36c to B=64 for a rehearsal on the CPU."""
    launches = dryrun_pipelines(torch, mt, ops, dev)
    head_l, head = headline_mesh_phase(torch, ops, dev, **(dict(n_d=16, reps=4) if small else {}))
    large_l, large = large_chunks_phase(torch, mt, ops, dev,
                                        **(dict(n_d=8, reps=8) if small else {}))
    for k in launches:
        launches[k] += head_l[k] + large_l[k]
    return launches, head, large


# --- 4 and 37. QPs beyond a block's shared memory: the global layout ---------
BIG_HP = 25            # 37a: the 8x8 controller at Hp=25 (n=33, m=897 in float64)
FLEET_HP = 60          # 37b: bench_horizon.py's 8x8 fleet with MPC_HORIZONS=60
MHE_HE = 40            # 37c: examples/mhe_estimation.py's estimator at He=40
MHE_GI_TOL = 1e-9      # x̂ card vs CPU with GI: 1e-9·(1 + max|x̂|) (PERF.md §2)


def beyond_smem_phase(torch, ops, dev):
    """Phase 4: QPs of n=64, m=1024, whose one-lane block fits no SM's
    shared memory, solve on the card in the layout the wrappers pick for
    them (not the resident one: the staged sweep, the split GI) and hold to the
    plain versions: the sweep in float32 and float64 (B=2, one controller,
    10 sweeps: x, z, y to F32_TOL·(1 + max|plain|), 1e-10 in float64, the
    frozen lane bit-unchanged) and the GI solve in float64 (B=64, 4
    controllers, junk dual warm starts on half the lanes: equal flags,
    iterations and active sets, x to 1e-9·(1 + max|x|), the float64 bar of
    tests/test_torch_cuda.py: over the ~250 rank-one updates of Ginv that
    the junk costs here the kernel's and the plain version's sums, taken in
    other orders, part by ~1e-11; the cap is 600 pivots).  Returns the
    largest errors."""
    from mpc_tpu_torch.ops import admm_kernel
    n, m = 64, 1024
    zi = lambda k: torch.zeros(k, dtype=torch.int32, device=dev)
    worst = {}
    for dt in (torch.float32, torch.float64):
        a = dict(zip(SWEEP_ARGS, layout_sweep_inputs(torch, dev, zi(2), n, m, dt)))
        check(admm_geometry(torch, a)[-1] != "resident", "n=64, m=1024 sweep: the resident "
              "layout")
        worst["admm_sweep"] = max(worst.get("admm_sweep", 0.0), sweep_layout_check(
            torch, ops, dev, "beyond shared memory", zi(2), n, m, dt,
            admm_kernel.WARP_LANES_PER_SM))
    lc = (torch.arange(64, device=dev) % 4).to(torch.int32)
    args = gi_layout_inputs(torch, ops, dev, lc, n=n, m=m, cap=None, max_pivots=600)
    layout = gi_geometry(torch, args)[-1]
    check(layout != "resident", "n=64, m=1024 GI: the resident layout")
    out = {}
    for label, fn in (("kernel", ops.gi_solve), ("plain", ops.gi_solve_reference)):
        a = _clone(args)
        x, _, it, conv = fn(*a)
        out[label] = (x, it, conv, a[6])
    torch.cuda.synchronize()
    (xk, itk, ck, ik), (xp, itp, cp, ip) = out["kernel"], out["plain"]
    err = (xk - xp).abs().max().item()
    tol = 1e-9 * (1.0 + xp.abs().max().item())
    print(f"GI beyond shared memory: B=64 n_d=4 f64 n={n} m={m} slots={n} ({layout} layout): "
          f"converged {int(ck.sum())}/64, equal flags {int((ck == cp).sum())}, iterations "
          f"{int((itk == itp).sum())} (max {int(itp.max())}), active sets "
          f"{int((ik == ip).all(1).sum())}; max |x kernel - x plain| {err:.3e} (tol {tol:.3e})",
          flush=True)
    check(torch.equal(ck, cp) and torch.equal(itk, itp) and torch.equal(ik, ip),
          "GI beyond shared memory: flags, iterations or active sets differ")
    check(np.isfinite(err) and err <= tol, f"GI beyond shared memory: x differs by {err:.3e}")
    worst["gi_solve"] = err
    return worst


def layout_rows(torch, args, kernel, layout=None):
    """A's rows a staged (sweep) or split (GI) launch on these inputs keeps
    in shared memory (None in the other layouts)."""
    from mpc_tpu_torch.ops import admm_kernel, gi_kernel
    budget = card_geometry(torch)[0]
    if kernel == "gi_solve":
        table, _, warps, _, got = gi_geometry(torch, args, layout)
        if got != "split":
            return None
        Pinv, A, _, q, l = args[:5]
        return gi_kernel.split_plan(q.shape[1], l.shape[1], args[6].shape[1], A.element_size(),
                                    Pinv.element_size(), warps, budget,
                                    layout[1] if isinstance(layout, tuple) else None)[0]
    table, *_, got = admm_geometry(torch, args, layout)
    if got != "staged":
        return None
    n, m, s = args["x"].shape[1], args["z"].shape[1], args["x"].element_size()
    return admm_kernel.staged_plan(n, m, s, table.shape[1], budget,
                                   layout[1] if isinstance(layout, tuple) else None)[0]


def kernel_runs(torch, ops, kernel, chk, layouts):
    """The kernel on fresh copies of a check's captured inputs in each of
    ``layouts``: its outputs (x, λ, the iterations, flags and operator state
    for GI; x, z, y for the sweep)."""
    args, runs = chk["args"], {}
    for lay in layouts:
        if kernel == "gi_solve":
            a = _clone(args)
            runs[str(lay)] = (*ops.gi_solve(*a, _layout=lay), *a[6:10])
        else:
            a = {k: v.clone() for k, v in args.items()}
            ops.admm_sweep(*(a[k] for k in SWEEP_ARGS), *chk["tail"], _layout=lay)
            runs[str(lay)] = [a[k] for k in ("x", "z", "y")]
    torch.cuda.synchronize()
    return runs


def max_diff(r, g):
    """Largest |Δ| between two runs' outputs (counts of unequal entries for
    the integer and flag outputs)."""
    return max((a.double() - b.double()).abs().max().item() if a.is_floating_point()
               else float((a != b).sum()) for a, b in zip(r, g))


def layout_ms(torch, ops, kernel, chk, layout):
    """Device time of one launch on a check's captured inputs in ``layout``."""
    args, holder = chk["args"], {}
    if kernel == "gi_solve":
        def setup():
            holder["a"] = _clone(args)

        def fn():
            ops.gi_solve(*holder["a"], _layout=layout)
        names = GI_KERNELS
    else:
        def setup():
            holder["a"] = {k: v.clone() for k, v in args.items()}

        def fn():
            ops.admm_sweep(*(holder["a"][k] for k in SWEEP_ARGS), *chk["tail"], _layout=layout)
        names = ADMM_KERNELS
    return device_ms(torch, fn, setup, names, launches=lambda: ops.LAUNCHES[kernel])


def versus_global(torch, ops, _build, name, kernel, chk):
    """The layout the wrapper picks at a shape beyond the resident layout
    (the staged sweep, the split GI) against the global layout, the last resort,
    forced on the same captured inputs: the same bits (max |Δ| = 0), the
    global layout's device time and lanes per SM, the picked layout's
    resident rows of A, and the time of the copy of A the wrapper makes for
    it each launch (the sweep's rows padded to 16 bytes, GI's rows past the
    resident ones column-major)."""
    import torch.nn.functional as F
    from mpc_tpu_torch.ops import admm_kernel
    gi = kernel == "gi_solve"
    args = chk["args"]
    runs = kernel_runs(torch, ops, kernel, chk, (None, "global"))
    diff = max_diff(runs["None"], runs["global"])
    ms = layout_ms(torch, ops, kernel, chk, "global")
    layout = (gi_geometry(torch, args) if gi else admm_geometry(torch, args))[-1]
    lanes_g = (gi_residency(torch, _build, args, "global") if gi
               else admm_residency(torch, ops, _build, args, "global"))[0]
    rows = layout_rows(torch, args, kernel)
    A = args[1] if gi else args["A"]
    m, n = A.shape[1:]
    if gi and rows is not None and rows < m:
        copy = lambda: A[:, rows:, :].transpose(1, 2).contiguous()
    elif not gi and rows is not None:
        pad = admm_kernel.row_stride(n, A.element_size()) - n
        copy = lambda: F.pad(A, (0, pad))
    else:
        copy = None
    copy_ms = median_ms(torch, copy, lambda: None) if copy else 0.0
    print(f"{name}: {layout} layout {chk['ms']:.4f} ms (+ its copy of A {copy_ms:.4f} ms; "
          f"{rows} of {m} rows resident) against the global layout {ms:.4f} ms "
          f"({ms / chk['ms']:.2f}x, {lanes_g} lanes per SM); max |{layout} - global| {diff}",
          flush=True)
    check(diff == 0.0, f"{name}: the {layout} layout differs from the global one: {diff}")
    return dict(global_ms=ms, global_max_diff=diff, global_lanes_per_sm=lanes_g, rows=rows,
                copy_ms=copy_ms)


def per_lane_phase(torch, ops, _build, cases):
    """The per-lane launches (every lane its own QP matrices: the kernels'
    per-lane geometry, and GI's A map at the MHE NaN variant (b)) on the
    inputs the phases above captured, each against the same launch with the
    global layout forced, which groups the lanes as before (a lane a block)
    and sums in the same order: max |Δ| = 0 over every output, with the
    global layout's device time and lanes per SM.  With an A map, also
    against the call without it, A copied to every lane (the fleet's call
    before the map): the same bits, and that call's device time."""
    out = {}
    for name, (kernel, chk) in cases.items():
        gi = kernel == "gi_solve"
        args = chk["args"]
        geo = gi_geometry(torch, args) if gi else admm_geometry(torch, args)
        a_map = gi and len(args) > 16
        if geo[1] is not None and not a_map:
            continue
        runs = kernel_runs(torch, ops, kernel, chk, (None, "global"))
        rec = dict(global_max_diff=max_diff(runs["None"], runs["global"]),
                   global_ms=layout_ms(torch, ops, kernel, chk, "global"),
                   global_lanes_per_sm=(gi_residency(torch, _build, args, "global") if gi else
                                        admm_residency(torch, ops, _build, args, "global"))[0])
        if a_map:
            a = list(args)
            a[1] = a[1].index_select(0, a.pop(16)).contiguous()
            copied = {"args": a}
            rec["copied_A_max_diff"] = max_diff(
                runs["None"], kernel_runs(torch, ops, kernel, copied, (None,))["None"])
            rec["copied_A_call_ms"] = layout_ms(torch, ops, kernel, copied, None)
        print(f"per-lane {name}: {chk['ms']:.4f} ms ({'per-lane geometry' if geo[1] is None else 'A map'}"
              f", {chk.get('lanes_per_sm')} lanes per SM) against the global layout "
              f"{rec['global_ms']:.4f} ms ({rec['global_lanes_per_sm']} lanes per SM), max |Δ| "
              f"{rec['global_max_diff']}" + (f"; against A copied to every lane "
                                             f"{rec['copied_A_call_ms']:.4f} ms, max |Δ| "
                                             f"{rec['copied_A_max_diff']}" if a_map else ""),
              flush=True)
        check(rec["global_max_diff"] == 0.0,
              f"per-lane {name}: the per-lane launch differs from the global layout")
        check(rec.get("copied_A_max_diff", 0.0) == 0.0,
              f"per-lane {name}: the A map differs from A copied to every lane")
        chk.update(rec)
        out[name] = rec
    return out


class Counted(Timed):
    """``Timed`` that also records the QP iterations of every period."""

    def __init__(self, ctrl):
        super().__init__(ctrl)
        self.ctrl, self.iters = ctrl, []

    def __call__(self, *args, **kw):
        u = super().__call__(*args, **kw)
        self.iters.append(int(self.ctrl.getinfo()["iters"]))
        return u


def big_single_phase(torch, mt, ops, _build, dev, periods=30):
    """37a: one 8x8 LinMPC of bench.py's plants at Hp=BIG_HP, Hc=4, float64
    (n=33, m=897: the global layout of both kernels), in ``sim`` for
    ``periods`` periods to a setpoint that saturates inputs, with GI (33
    slots) and with ADMM, on the card against the same ``sim`` on the CPU:
    u to 1e-6, GI's iteration counts equal in every period; the median
    ``moveinput``; then each kernel against its plain version on one more
    period's inputs, with both times."""
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    ry = np.random.default_rng(2).normal(size=8) * 4.0
    out = {}
    for qp_solver, kernel, key in SOLVERS:
        ctrls = {d: large_controllers(mt, 1, Hp=BIG_HP, qp_solver=qp_solver,
                                      dtype=torch.float64, device=d)[0] for d in ("cpu", dev)}
        counts = {d: Counted(c) for d, c in ctrls.items()}
        ref = mt.sim(ctrls["cpu"], periods, ry)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = mt.sim(ctrls[dev], periods, ry)
        run = dict(ops.LAUNCHES)
        for k in launches:
            launches[k] += run[k]
        c = ctrls[dev]
        err = float(np.abs(res.U_data - ref.U_data).max())
        same_it = counts[dev].iters == counts["cpu"].iters
        med = statistics.median(counts[dev].times[5:])
        name = f"8x8/Hp={BIG_HP} single {qp_solver}"
        print(f"{name} f64 (QP n={c.n_qp} m={c.A_stack.shape[0]}), {periods} periods: kernel "
              f"launches {run}; card vs CPU max |du| {err:.3e} (bar 1e-6); QP iterations card "
              f"{counts[dev].iters} CPU {counts['cpu'].iters}; max |u| "
              f"{np.abs(res.U_data).max():.4f}; moveinput median {med * 1e3:.3f} ms (periods "
              f"5-{periods})", flush=True)
        check(np.isfinite(res.U_data).all() and err < 1e-6,
              f"{name}: card vs CPU |du| {err:.3e} ≥ 1e-6")
        check(kernel != "gi_solve" or same_it, f"{name}: iteration counts differ")
        check(run[kernel] >= periods, f"{name}: the {kernel} kernel was launched "
              f"{run[kernel]} times in {periods} periods")
        args = single_kernel_inputs(ops, c, key, res.Y_data[-1], ry)
        chk = (gi_vs_plain(torch, ops, name, args, True) if key == "gi"
               else kernel_vs_plain(torch, ops, name, args))
        chk.update(versus_global(torch, ops, _build, name, kernel, chk))
        chk.update(moveinput_ms=med * 1e3, launches=run[kernel],
                   per_period=run[kernel] / periods)
        out[qp_solver] = chk
    return launches, out


def big_fleet_phase(torch, mt, ops, _build, dev, n_d=32, reps=128, check_reps=8):
    """37b: bench_horizon.py's fleet at Hp=FLEET_HP: n_d random 8x8 plants
    (Hc=4) x ``reps``, float32 (n=33, m=2017: the global layout), GI with
    ``gi_max_active=12`` (float64 slots), then ADMM.  Each kernel is held to
    its plain version on a steady period's inputs twice: at
    bench_horizon.py's batch (n_d x ``check_reps``) and on the fleet itself
    (n_d x ``reps``), whose launch geometry the main path runs (on an H100
    GI 16 warps a block, the sweep two lanes a block in step); the times,
    bound and residency of the main path's row come from the latter.  The sweep is checked
    at its float32 floor (``sweep_errors``) and, at the fleet's lane map
    and shape, on ``layout_sweep_inputs`` to F32_TOL·(1 + max|plain|) in
    float32 and 1e-10 in float64.  Then the fleet's closed loop (``drive``:
    4 periods and one multistep(4), the launch counts read around them).
    GI must keep ≥ 0.99 of the lanes converged; ADMM's share is reported
    against the same limit (the reference's f32 ADMM at this horizon stops
    lanes at the 250-iteration budget too: bench_horizon.py's
    docstring)."""
    from mpc_tpu_torch.ops import admm_kernel
    from mpc_tpu_torch.parallel import BatchedLinMPC
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    out = {}
    for qp_solver, kernel, attr in (("active_set", "gi_solve", "gi"), ("admm", "admm_sweep",
                                                                        "sweep")):
        gi = kernel == "gi_solve"
        name = f"8x8 fleet Hp={FLEET_HP} {'GI' if gi else 'ADMM'}"
        t0 = time.perf_counter()
        cs = large_controllers(mt, n_d, Hp=FLEET_HP, qp_solver=qp_solver,
                               gi_max_active=12 if gi else None, device="cpu")
        small = BatchedLinMPC(cs, reps=check_reps, device=dev, dtype=torch.float32)
        print(f"{name}: {n_d} distinct, QP n={small.n_qp} m={small.params['A_stack'].shape[1]}, "
              f"controllers built in {time.perf_counter() - t0:.1f} s", flush=True)
        if gi:
            chk_small = gi_vs_plain(torch, ops, f"{name} B={small.B}",
                                    gi_steady_inputs(torch, small, cs, check_reps), False)
        else:
            chk_small = kernel_vs_plain(torch, ops, f"{name} B={small.B}",
                                        steady_inputs(torch, small, cs, check_reps),
                                        at_floor=True)
        chk_small.update(versus_global(torch, ops, _build, f"{name} B={small.B}", kernel,
                                       chk_small))
        del small
        fleet = BatchedLinMPC(cs, reps=reps, device=dev, dtype=torch.float32)
        B = fleet.B
        if gi:
            args = gi_steady_inputs(torch, fleet, cs, reps)
            table, _, warps, _, layout = gi_geometry(torch, args)
            print(f"{name} B={B}: launch geometry {layout}, {table.shape[0]} blocks of "
                  f"{table.shape[1]} lanes, {warps} warps a block, "
                  f"{layout_rows(torch, args, kernel)} rows of A resident", flush=True)
            chk = gi_vs_plain(torch, ops, f"{name} B={B}", args, False)
        else:
            args = steady_inputs(torch, fleet, cs, reps)
            a = dict(zip(SWEEP_ARGS, args[:12]))
            table, _, warps, grouped, _, layout = admm_geometry(torch, a)
            print(f"{name} B={B}: launch geometry {layout}, {table.shape[0]} blocks of "
                  f"{table.shape[1]} lanes ({'in step' if grouped else 'a warp a lane'}), "
                  f"{layout_rows(torch, a, kernel)} rows of A resident", flush=True)
            chk = kernel_vs_plain(torch, ops, f"{name} B={B}", args, at_floor=True)
            n, m = a["x"].shape[1], a["z"].shape[1]
            chk["err_synthetic"] = max(
                sweep_layout_check(torch, ops, dev, f"fleet Hp={FLEET_HP} lane map",
                                   a["lane_ctrl"], n, m, dt, admm_kernel.WARP_LANES_PER_SM)
                for dt in (torch.float32, torch.float64))
        chk.update(versus_global(torch, ops, _build, f"{name} B={B}", kernel, chk))
        chk["check_small"] = chk_small
        loop = ClosedLoop(torch, cs, reps, dev, torch.float32)
        run, med, n_conv = drive(torch, ops, name, fleet, loop, 4,
                                 conv_bar=0.99 if gi else None)
        for k in launches:
            launches[k] += run[k]
        check(run[kernel] > 0, f"{name}: the {kernel} kernel was never launched")
        share = n_conv / B
        print(f"{name}: B={B}, converged share of the last period {share:.4f} (limit 0.99), "
              f"median {med:.0f} solves/s (a period {B / med * 1e3:.2f} ms), "
              f"{run[kernel] / 8:g} {kernel} launches a period", flush=True)
        chk.update(launches=run[kernel], per_period=run[kernel] / 8, conv_share=share,
                   solves_per_s=med, period_ms=B / med * 1e3)
        out[qp_solver] = chk
        del fleet
    return launches, out


def big_mhe_phase(torch, mt, ops, _build, dev, periods=50):
    """37c: examples/mhe_estimation.py's MovingHorizonEstimator (tf(3, [10,
    1]), ``nint_ym=[1]``, x̂ ≥ 0) at He=MHE_HE, float64 (n=82, m=202, 82
    slots: the global layout), ``periods`` periods of the plant's response
    to u = 1 with an unmeasured output step at period 20 and noise, on the
    card against the CPU: x̂ to MHE_GI_TOL·(1 + max|x̂|) after every
    ``preparestate`` and ``updatestate``; then the GI kernel against its
    plain version on the last window's solve."""
    from mpc_tpu_torch.estimators import mhe_fast
    ests = {}
    for d in ("cpu", dev):
        e = mt.MovingHorizonEstimator(mt.LinModel(mt.tf(3, [10, 1]), 1.0), He=MHE_HE,
                                      sigmaQ=[0.1], sigmaR=[0.5], nint_ym=[1], device=d)
        ests[d] = e.setconstraint(xhatmin=[0.0] + [-np.inf] * (e.nx_hat - 1))
    plant = mt.LinModel(mt.tf(3, [10, 1]), 1.0)
    rng = np.random.default_rng(0)
    worst = 0.0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times = []
    for k in range(periods):
        y = plant.evaloutput() + (0.8 if k >= 20 else 0.0) + 0.05 * rng.normal(1)
        for step in ("preparestate", "updatestate"):
            a = (y,) if step == "preparestate" else ([1.0], y)
            x_cpu = np.asarray(getattr(ests["cpu"], step)(*a))
            t0 = time.perf_counter()
            x_dev = np.asarray(getattr(ests[dev], step)(*a))
            if step == "preparestate":
                times.append(time.perf_counter() - t0)
            err = float(np.abs(x_dev - x_cpu).max() / (1.0 + np.abs(x_cpu).max()))
            check(np.isfinite(x_dev).all() and err <= MHE_GI_TOL,
                  f"MHE He={MHE_HE} period {k} {step}: card vs CPU {err:.3e}")
            worst = max(worst, err)
        plant.updatestate([1.0])
    run = dict(ops.LAUNCHES)
    med = statistics.median(times[MHE_HE:])
    print(f"MHE He={MHE_HE} f64 (QP n={ests[dev].nx_hat * (MHE_HE + 1)}), {periods} periods: "
          f"kernel launches {run}; card vs CPU max |dx̂| / (1 + max|x̂|) {worst:.3e} (bar "
          f"{MHE_GI_TOL:g}); preparestate median {med * 1e3:.3f} ms over the full windows",
          flush=True)
    check(run["gi_solve"] >= periods, f"MHE He={MHE_HE}: {run['gi_solve']} GI launches in "
          f"{periods} periods")
    # the GI kernel against its plain version on one more window's solve
    rec = {}
    inner = mhe_fast.solve_qp_active

    def capture(*args):
        rec.setdefault("args", _clone(args))
        return ops.gi_solve(*args)
    mhe_fast.solve_qp_active = functools.partial(inner, solve=capture)
    try:
        ests[dev].preparestate(plant.evaloutput() + 0.8)
    finally:
        mhe_fast.solve_qp_active = inner
    check("args" in rec, f"MHE He={MHE_HE}: no GI solve was captured")
    chk = gi_vs_plain(torch, ops, f"MHE He={MHE_HE} B=1", rec["args"], True)
    chk.update(versus_global(torch, ops, _build, f"MHE He={MHE_HE} B=1", "gi_solve", chk))
    chk.update(launches=run["gi_solve"], per_period=run["gi_solve"] / periods,
               preparestate_ms=med * 1e3, err_x=worst)
    return run, chk


def layout_equivalence_phase(torch, ops, cases):
    """37d: the global layout and the split (GI) or staged (the sweep's
    lanes in step; not a warp a lane) layout with a third of A's rows in
    shared memory, the rest streamed or read column-major, forced on
    captured inputs of shapes the resident layout takes (``cases``: name →
    (kernel, check)), against the resident one: the same bits of x, λ, the
    iteration counts and flags (GI) or of x, z and y (the sweep), and each
    layout's device time."""
    out = {}
    for name, (kernel, chk) in cases.items():
        args, gi = chk["args"], kernel == "gi_solve"
        m = (args[4] if gi else args["z"]).shape[1]
        new = "split" if gi else "staged"
        in_step = gi or admm_geometry(torch, args)[3]
        layouts = ["resident", "global"] + ([(new, m // 3)] if in_step else [])
        runs = kernel_runs(torch, ops, kernel, chk, layouts)
        diff = {str(lay): max_diff(runs["resident"], runs[str(lay)]) for lay in layouts[1:]}
        ms = {str(lay): layout_ms(torch, ops, kernel, chk, lay) for lay in layouts[1:]}
        if gi:
            geo = f"{gi_geometry(torch, args, 'global')[2]} warps a block"
        else:
            geo = admm_geometry(torch, args, "global")
            geo = f"{geo[0].shape[1]} lanes a block{' in step' if geo[3] else ''}"
        new_key = str((new, m // 3))
        print(f"layouts {name} ({geo}): max |resident - other| {diff}; device ms resident "
              f"{chk['ms']:.4f}, global {ms['global']:.4f} ({ms['global'] / chk['ms']:.2f}x)"
              + (f", {new} with {m // 3} of {m} rows resident {ms[new_key]:.4f} "
                 f"({ms[new_key] / chk['ms']:.2f}x)" if in_step else f", no {new} layout"),
              flush=True)
        check(all(d == 0.0 for d in diff.values()), f"layouts {name}: a layout differs from "
              f"the resident one: {diff}")
        out[name] = dict(resident_ms=chk["ms"], global_ms=ms["global"],
                         max_diff=max(diff.values()), geometry=geo,
                         **({f"{new}_ms": ms[new_key], f"{new}_rows": m // 3} if in_step
                            else {}))
    return out


def main():
    try:
        import torch
    except ImportError as err:
        raise Fail(f"torch is not importable: {err}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: "
          "this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import mpc_tpu_torch as mt
        from mpc_tpu_torch import ops
        from mpc_tpu_torch.ops import _build
        from mpc_tpu_torch.parallel import BatchedLinMPC, random_cstr_controllers
    except ImportError as err:
        raise Fail(f"mpc_tpu_torch is not importable beside this script: {err}")
    check("jax" not in sys.modules, "mpc_tpu_torch imported jax")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t_start = time.perf_counter()

    # --- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.last_build['seconds']:.2f} s)")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # --- 5. small float64 fleet: card (kernel) vs CPU (plain) ------------
    small_fleet_check(torch, BatchedLinMPC, random_cstr_controllers(4, Hp=10, Hc=2, seed=0),
                      "small f64 fleet")

    # --- the fleets of the main path, and their sweep inputs ------------
    t0 = time.perf_counter()
    ctrls = random_cstr_controllers(256, Hp=10, Hc=2, seed=0)
    fleet = BatchedLinMPC(ctrls, reps=16, device=dev, dtype=torch.float32)
    B = fleet.B
    check(B == 4096, f"headline fleet has {B} lanes")
    print(f"headline fleet: {len(ctrls)} distinct x 16 reps = {B} lanes, "
          f"QP n={fleet.n_qp} m={fleet.params['A_stack'].shape[1]}, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    # sweep inputs of a steady period (warm x, z and y; some lanes frozen);
    # the headline fleet is back at rest afterwards
    head_args = steady_inputs(torch, fleet, ctrls, 16)
    loop = ClosedLoop(torch, ctrls, 16, dev, torch.float32)
    large = large_controllers(mt, 16)
    lfleet = BatchedLinMPC(large, reps=16, device=dev, dtype=torch.float32)
    large_args = steady_inputs(torch, lfleet, large, 16)
    del lfleet

    # --- 3. kernel vs plain on the card ----------------------------------
    checks = {
        "pallas_test_batch": kernel_vs_plain(torch, ops, "pallas_test_batch",
                                             pallas_test_batch(torch, dev)),
        "headline": kernel_vs_plain(torch, ops, "headline", head_args),
        "large_8x8_hp15": kernel_vs_plain(torch, ops, "large_8x8_hp15", large_args),
        # the same lanes x16 (B=4096): the lanes-in-step variant's shared A
        # reads, two lanes a block
        "large_8x8_hp15_B4096": kernel_vs_plain(torch, ops, "large_8x8_hp15_B4096",
                                                tile_lanes(large_args, 16)),
    }

    # --- 3b. every lane layout, kernel vs plain ----------------------------
    layout_worst = layout_phase(torch, ops, dev)

    # --- 4. QPs beyond a block's shared memory: the global layout ----------
    beyond_worst = beyond_smem_phase(torch, ops, dev)

    # --- 6. the ADMM main path -------------------------------------------
    admm_launches, _, _ = drive(torch, ops, "headline-ADMM", fleet, loop, 12)
    per_period = {"headline-ADMM": admm_launches["admm_sweep"] / 16}
    path_launches = {"headline-ADMM": admm_launches["admm_sweep"]}
    check(admm_launches["admm_sweep"] > 0,
          "headline-ADMM main path: the ADMM kernel was never launched")

    # --- 7. the same period with the plain sweep on the card --------------
    plain_period(torch, "headline-ADMM", fleet, loop, "sweep", ops.admm_sweep,
                 ops.admm_sweep_reference)
    del fleet

    # --- 8a. the GI kernel vs plain: float64 random QPs ---------------------
    gi_checks = {"random_f64": gi_vs_plain(torch, ops, "random_f64",
                                           gi_random_inputs(torch, ops, dev), True)}

    # --- 9. small float64 GI fleet: card (kernel) vs CPU (plain) ------------
    small_fleet_check(torch, BatchedLinMPC,
                      random_cstr_controllers(4, Hp=10, Hc=2, seed=0,
                                              qp_solver="active_set"),
                      "small f64 GI fleet")

    # --- 8b-11. the GI main paths ------------------------------------------
    gi_launches = 0
    gi_paths = (
        ("headline-GI", lambda: random_cstr_controllers(256, Hp=10, Hc=2, seed=0,
                                                        qp_solver="active_set"),
         16, None, 12),
        ("large-GI", lambda: large_controllers(mt, 32, qp_solver="active_set",
                                               gi_max_active=8),
         128, torch.float32, 4),
    )
    for name, make, reps, slots, n_step in gi_paths:
        t0 = time.perf_counter()
        cs = make()
        gfleet = BatchedLinMPC(cs, reps=reps, device=dev, dtype=torch.float32,
                               gi_slot_dtype=slots)
        check(gfleet.B == 4096, f"{name} fleet has {gfleet.B} lanes")
        print(f"{name} fleet: {len(cs)} distinct x {reps} reps = {gfleet.B} lanes, "
              f"QP n={gfleet.n_qp} m={gfleet.params['A_stack'].shape[1]} "
              f"slots={gfleet.gi_slots} ({gfleet.gi_slot_dtype}), built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        chk = gi_vs_plain(torch, ops, name, gi_steady_inputs(torch, gfleet, cs, reps),
                          False)
        check(chk["entering"] >= 0.05 * chk["B"], f"{name}: only {chk['entering']} "
              "lanes enter the captured solve with a valid slot (< 5 %)")
        gi_checks[name] = chk
        gloop = ClosedLoop(torch, cs, reps, dev, torch.float32)
        launches, _, _ = drive(torch, ops, name, gfleet, gloop, n_step)
        check(launches["gi_solve"] > 0, f"{name} main path: the GI kernel was never launched")
        gi_launches += launches["gi_solve"]
        path_launches[name] = launches["gi_solve"]
        per_period[name] = launches["gi_solve"] / (n_step + 4)
        plain_period(torch, name, gfleet, gloop, "gi", ops.gi_solve, ops.gi_solve_reference)
        del gfleet

    # --- 12-15. the single-controller path and the uncached solves ---------
    single = {}
    for phase, fn in (("README", lambda: readme_phase(torch, mt, ops, dev)),
                      ("8x8", lambda: (full_width_phase(torch, mt, ops, dev), None)),
                      ("uncached", lambda: uncached_phase(torch, ops, dev)),
                      ("deadline", lambda: (deadline_phase(torch, mt, ops, dev), None))):
        run, single[phase] = fn()
        path_launches[phase] = run
        admm_launches["admm_sweep"] += run["admm_sweep"]
        gi_launches += run["gi_solve"]
    readme, unc = single["README"], single["uncached"]
    print(f"single-README: moveinput median ADMM {readme['admm']['moveinput_ms']:.3f} ms, "
          f"GI {readme['active_set']['moveinput_ms']:.3f} ms (float64, B=1)", flush=True)

    # --- 16-20. the nonlinear-plant slice: the SLMPC fleet (THE SLICE'S MAIN
    # PATH) with both kernels against their plain versions at its shape,
    # small fleets and the single controller card vs CPU, the estimators
    sl_launches, sl_gi, sl_admm = slmpc_phase(torch, mt, ops, _build, dev)
    for phase, fn in (("SLMPC small fleets", lambda: (small_slmpc_fleets(torch, mt, ops, dev),
                                                       None)),
                      ("SLMPC single", lambda: single_slmpc_phase(torch, mt, ops, dev))):
        run, single[phase] = fn()
        for k in run:
            sl_launches[k] += run[k]
    admm_launches["admm_sweep"] += sl_launches["admm_sweep"]
    gi_launches += sl_launches["gi_solve"]
    estimator_phase(torch, mt, dev)

    # --- 21-26. the NonLinMPC slice: the nonlin lane (THIS SLICE'S MAIN
    # PATH) with both kernels against their plain versions at its shapes,
    # the exact-Hessian A/B, small fleets and the single controller card vs
    # CPU, an ExplicitMPC fleet
    nl_launches, nl_gi, nl_admm = nonlin_phase(torch, mt, ops, _build, dev)
    ab_launches, nl_ab = exact_hessian_phase(torch, mt, ops, _build, dev)
    nl_launches["gi_solve"] += ab_launches
    for phase, fn in (("NonLinMPC small fleets",
                       lambda: (small_nonlin_fleets(torch, mt, ops, dev), None)),
                      ("NonLinMPC single", lambda: single_nonlin_phase(torch, mt, ops, dev))):
        run, single[phase] = fn()
        for k in run:
            nl_launches[k] += run[k]
    admm_launches["admm_sweep"] += nl_launches["admm_sweep"]
    gi_launches += nl_launches["gi_solve"]
    explicit_phase(torch, mt, dev)

    # --- 27-29. the MHE slice: the mhe lane (THIS SLICE'S MAIN PATH) with the
    # GI kernel against its plain version at shapes (a) and (b), the
    # mhe_nonlin lane (shape (c)), small f64 fleets and the single estimator
    # card vs CPU, the sweep at the general window
    mhe_launches, mhe_gi = mhe_phase(torch, mt, ops, _build, dev)
    nlm_launches, mhe_nl = mhe_nonlin_phase(torch, mt, ops, _build, dev)
    small_mhe, mhe_admm = small_mhe_checks(torch, mt, ops, _build, dev)
    gi_launches += mhe_launches + nlm_launches + small_mhe["gi_solve"]
    admm_launches["admm_sweep"] += small_mhe["admm_sweep"]
    for key, c in (("mhe", mhe_gi["a"]), ("mhe 1 %-NaN", mhe_gi["b"]),
                   ("mhe_nonlin", mhe_nl)):
        extra = (f", {c['prof']['host_syncs']} host syncs and {c['prof']['device_launches']} "
                 f"device launches a period, idle share {c['prof']['idle_share']:.4f}"
                 if "prof" in c else "")
        print(f"MHE {key}: period median {c['period_ms']:.3f} ms ({c['solves_per_s']:.0f} "
              f"solves/s), converged {c['converged']:.4f}, {c['per_period']:g} GI launches a "
              f"period{extra}", flush=True)
    print(f"NonLinMPC: fleet period median {nl_gi['period_ms']:.2f} ms "
          f"({nl_gi['solves_per_s']:.0f} solves/s, B=4096, f32, GI), {nl_gi['per_period']:g} "
          f"GI launches, {nl_gi['prof']['sqp_exit_tests']:g} SQP exit tests, "
          f"{nl_gi['prof']['host_syncs']} host syncs and {nl_gi['prof']['device_launches']} "
          f"device launches a period, idle share {nl_gi['prof']['idle_share']:.4f}; "
          f"exact-Hessian A/B {json.dumps(nl_ab['ab'])}; single controller median GI "
          f"{single['NonLinMPC single']['active_set']:.3f} ms, ADMM "
          f"{single['NonLinMPC single']['admm']:.3f} ms (f64)", flush=True)
    print(f"SLMPC: fleet period median {sl_gi['period_ms']:.2f} ms "
          f"({sl_gi['solves_per_s']:.0f} solves/s, B=4096, f32, GI); single controller "
          f"moveinput_closed median GI {single['SLMPC single']['active_set']:.3f} ms, ADMM "
          f"{single['SLMPC single']['admm']:.3f} ms (f64)", flush=True)

    # --- 30-33. the compiled closed loops: bench_scan.py's cell (THIS SLICE'S
    # MAIN PATH) with both kernels against their plain versions at its
    # shape, the heterogeneous fleet's shape, the SL and NonLin loops, and
    # every loop card vs CPU in float64
    t_cl = time.perf_counter()
    scan = scan_phase(torch, mt, ops, _build, dev)
    hetero = hetero_phase(torch, mt, ops, dev)
    loop_runs = [scan["active_set"]["launches_all"], scan["admm"]["launches_all"],
                 {"gi_solve": hetero["active_set"]["launches"], "admm_sweep": 0},
                 {"admm_sweep": hetero["admm"]["launches"], "gi_solve": 0},
                 sl_loop_phase(torch, mt, ops, dev), nl_loop_phase(torch, mt, ops, dev),
                 compiled_card_vs_cpu(torch, mt, ops, dev)]
    for run in loop_runs:
        admm_launches["admm_sweep"] += run["admm_sweep"]
        gi_launches += run["gi_solve"]
    print(f"compiled loops (phases 30-33): {time.perf_counter() - t_cl:.1f} s; scan-CSTR "
          f"GI {scan['active_set']['steps_per_s']:.0f} and ADMM "
          f"{scan['admm']['steps_per_s']:.0f} controlled steps/s (B={SCAN_B}, N={SCAN_N}, "
          f"f32)", flush=True)

    # --- 34-36. the embedded C export, the native executor, the mesh and the
    # chunks: each drives the kernels on the card through the port's API
    t_x = time.perf_counter()
    exp_launches, readme_gi = export_phase(torch, mt, ops, dev)
    rt_phase(readme_gi)
    mesh_launches, head_mesh, large_chunks = mesh_phase(torch, mt, ops, dev)
    for run in (exp_launches, mesh_launches):
        admm_launches["admm_sweep"] += run["admm_sweep"]
        gi_launches += run["gi_solve"]
    print(f"phases 34-36: {time.perf_counter() - t_x:.1f} s; headline-GI on a mesh "
          f"{json.dumps(head_mesh)}; large-ADMM grouped_chunks {json.dumps(large_chunks)}",
          flush=True)

    # --- 37. QPs beyond a block's shared memory (THIS SLICE'S MAIN PATHS): the
    # 8x8 controller at Hp=25, the 8x8 fleet at Hp=60 and the MHE at He=40 in
    # the global layout of both kernels, then the global layout forced at
    # the resident shapes
    t_g = time.perf_counter()
    big_launches, big = big_single_phase(torch, mt, ops, _build, dev)
    fl_launches, big_fleet = big_fleet_phase(torch, mt, ops, _build, dev)
    mhe_big_launches, mhe_big = big_mhe_phase(torch, mt, ops, _build, dev)
    for run in (big_launches, fl_launches, mhe_big_launches):
        admm_launches["admm_sweep"] += run["admm_sweep"]
        gi_launches += run["gi_solve"]
    equiv = layout_equivalence_phase(torch, ops, {
        "headline-GI": ("gi_solve", gi_checks["headline-GI"]),
        "large-GI": ("gi_solve", gi_checks["large-GI"]),
        "headline-ADMM": ("admm_sweep", checks["headline"]),
        "8x8/Hp=15 ADMM": ("admm_sweep", checks["large_8x8_hp15"]),
        "8x8/Hp=15 ADMM B=4096": ("admm_sweep", checks["large_8x8_hp15_B4096"])})
    print(f"phase 37: {time.perf_counter() - t_g:.1f} s; 8x8/Hp={BIG_HP} moveinput median GI "
          f"{big['active_set']['moveinput_ms']:.3f} ms, ADMM {big['admm']['moveinput_ms']:.3f} "
          f"ms (f64); 8x8 fleet Hp={FLEET_HP} converged GI "
          f"{big_fleet['active_set']['conv_share']:.4f}, ADMM "
          f"{big_fleet['admm']['conv_share']:.4f} (limit 0.99), period median GI "
          f"{big_fleet['active_set']['period_ms']:.2f} ms, ADMM "
          f"{big_fleet['admm']['period_ms']:.2f} ms; MHE He={MHE_HE} preparestate "
          f"median {mhe_big['preparestate_ms']:.3f} ms; layouts {json.dumps(equiv)}",
          flush=True)

    # --- the per-lane launches against the geometry they replace -----------
    t_p = time.perf_counter()
    per_lane = per_lane_phase(torch, ops, _build, {
        "SLMPC GI": ("gi_solve", sl_gi), "SLMPC ADMM": ("admm_sweep", sl_admm),
        "NonLinMPC GI": ("gi_solve", nl_gi), "NonLinMPC ADMM": ("admm_sweep", nl_admm),
        "NonLinMPC A/B GI": ("gi_solve", nl_ab), "MHE GI NaN (b)": ("gi_solve", mhe_gi["b"]),
        "MHE nonlin GI (c)": ("gi_solve", mhe_nl), "fleet GI": ("gi_solve", hetero["active_set"]),
        "README GI": ("gi_solve", readme["active_set"])})
    print(f"per-lane launches: {time.perf_counter() - t_p:.1f} s; {json.dumps(per_lane)}",
          flush=True)

    # --- the kernels line: times, bounds and residency at every shape ------
    head, hgi, lgi = checks["headline"], gi_checks["headline-GI"], gi_checks["large-GI"]
    res = {"admm headline": admm_residency(torch, ops, _build, head["args"]),
           "admm 8x8": admm_residency(torch, ops, _build, checks["large_8x8_hp15"]["args"]),
           "admm 8x8 B=4096": admm_residency(torch, ops, _build,
                                             checks["large_8x8_hp15_B4096"]["args"]),
           "admm pallas_test_batch": admm_residency(torch, ops, _build,
                                                    checks["pallas_test_batch"]["args"]),
           "admm README": admm_residency(torch, ops, _build, readme["admm"]["args"]),
           "gi headline-GI": gi_residency(torch, _build, hgi["args"]),
           "gi large-GI": gi_residency(torch, _build, lgi["args"]),
           "gi random_f64": gi_residency(torch, _build, gi_checks["random_f64"]["args"]),
           "gi README": gi_residency(torch, _build, readme["active_set"]["args"]),
           "admm scan": admm_residency(torch, ops, _build, scan["admm"]["args"]),
           "admm fleet": admm_residency(torch, ops, _build, hetero["admm"]["args"]),
           "gi scan": gi_residency(torch, _build, scan["active_set"]["args"]),
           "gi fleet": gi_residency(torch, _build, hetero["active_set"]["args"]),
           "gi 8x8/Hp=25": gi_residency(torch, _build, big["active_set"]["args"]),
           "admm 8x8/Hp=25": admm_residency(torch, ops, _build, big["admm"]["args"]),
           "gi fleet Hp=60": gi_residency(torch, _build, big_fleet["active_set"]["args"]),
           "admm fleet Hp=60": admm_residency(torch, ops, _build, big_fleet["admm"]["args"]),
           "gi fleet Hp=60 B=256": gi_residency(
               torch, _build, big_fleet["active_set"]["check_small"]["args"]),
           "admm fleet Hp=60 B=256": admm_residency(
               torch, ops, _build, big_fleet["admm"]["check_small"]["args"]),
           "gi MHE He=40": gi_residency(torch, _build, mhe_big["args"])}
    for k, (lanes, geo) in res.items():
        print(f"residency {k}: {lanes} lanes per SM ({geo})", flush=True)
    per_period.update({"SLMPC GI": sl_gi["per_period"], "SLMPC ADMM": sl_admm["per_period"],
                       "NonLinMPC GI": nl_gi["per_period"],
                       "NonLinMPC ADMM": nl_admm["per_period"],
                       "MHE GI (a)": mhe_gi["a"]["per_period"],
                       "MHE GI NaN (b)": mhe_gi["b"]["per_period"],
                       "MHE nonlin GI (c)": mhe_nl["per_period"],
                       "README ADMM": path_launches["README"]["admm_sweep"] / 40,
                       "README GI": path_launches["README"]["gi_solve"] / 40,
                       "scan-CSTR GI": scan["active_set"]["per_period"],
                       "scan-CSTR ADMM": scan["admm"]["per_period"],
                       "fleet GI": hetero["active_set"]["per_period"],
                       "fleet ADMM": hetero["admm"]["per_period"]})
    print(f"launches per period: {per_period}", flush=True)
    shares = {k: c["bound_ms"] / c["ms"] for k, c in
              list(checks.items()) + list(gi_checks.items())
              + [("SLMPC GI", sl_gi), ("SLMPC ADMM", sl_admm), ("NonLinMPC GI", nl_gi),
                 ("NonLinMPC A/B GI", nl_ab), ("NonLinMPC ADMM", nl_admm),
                 ("MHE GI (a)", mhe_gi["a"]), ("MHE GI (a) warm", mhe_gi["a warm"]),
                 ("MHE GI NaN (b)", mhe_gi["b"]),
                 ("MHE nonlin GI (c)", mhe_nl), ("MHE general ADMM", mhe_admm),
                 ("scan-CSTR GI", scan["active_set"]), ("scan-CSTR ADMM", scan["admm"]),
                 ("fleet GI", hetero["active_set"]), ("fleet ADMM", hetero["admm"])]}
    print(f"roofline shares: {json.dumps(shares)}", flush=True)

    def shape(name, c, launches, lpp, lanes):
        """One shape of a kernel: its check's numbers, the layout it takes
        and, where a main path runs it at this shape, that path's launches
        (0 for a check only)."""
        args = c["args"]
        layout = (admm_geometry(torch, args) if isinstance(args, dict)
                  else gi_geometry(torch, args))[-1]
        return {"shape": name, "layout": layout, "launches": launches, "max_abs_err": c["err"],
                "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": None,
                "roofline_share": c["bound_ms"] / c["ms"], "launches_per_period": lpp,
                "resident_lanes_per_sm": lanes, "event_ms": c["event_ms"],
                **{k: c[k] for k in ("copied_A_bytes", "copied_A_ms", "rows", "copy_ms",
                                     "global_ms", "global_max_diff", "global_lanes_per_sm",
                                     "copied_A_call_ms", "copied_A_max_diff",
                                     "conv_share", "period_ms") if k in c}}

    admm_shapes = [
        shape("headline-ADMM B=4096 n=5 m=101 f32", head, path_launches["headline-ADMM"],
              per_period["headline-ADMM"], res["admm headline"][0]),
        shape("SLMPC B=4096 n=3 m=65 f32, per-lane ladder", sl_admm, sl_admm["launches"],
              sl_admm["per_period"], sl_admm["lanes_per_sm"]),
        shape("NonLinMPC B=4096 n=2 m=72 f32, per-lane ladder (nonlin lane, ADMM)", nl_admm,
              nl_admm["launches"], nl_admm["per_period"], nl_admm["lanes_per_sm"]),
        shape("README B=1 n=3 m=233 f64", readme["admm"], path_launches["README"]["admm_sweep"],
              per_period["README ADMM"], res["admm README"][0]),
        shape("MHE general window B=256 n=44 m=208 f32, per-lane ladder (check)", mhe_admm,
              0, None, mhe_admm["lanes_per_sm"]),
        shape("8x8/Hp=15 B=256 n=33 m=577 f32 (check)", checks["large_8x8_hp15"], 0, None,
              res["admm 8x8"][0]),
        shape("8x8/Hp=15 B=4096 (check)", checks["large_8x8_hp15_B4096"], 0, None,
              res["admm 8x8 B=4096"][0]),
        shape("tests/test_pallas_qp.py B=128 n=4 m=8 (check)", checks["pallas_test_batch"],
              0, None, res["admm pallas_test_batch"][0]),
        shape(f"scan-CSTR run_fleet B={SCAN_B} {sweep_dims(scan['admm'])} f32, one controller "
              "(compiled loop, this slice's main path)", scan["admm"], scan["admm"]["launches"],
              scan["admm"]["per_period"], res["admm scan"][0]),
        shape(f"CompiledClosedLoopFleet B=n_d=128 {sweep_dims(hetero['admm'])} f64 (compiled "
              "loop)", hetero["admm"], hetero["admm"]["launches"], hetero["admm"]["per_period"],
              res["admm fleet"][0]),
        shape(f"8x8/Hp={BIG_HP} single B=1 {sweep_dims(big['admm'])} f64 (37a)", big["admm"],
              big["admm"]["launches"], big["admm"]["per_period"], res["admm 8x8/Hp=25"][0]),
        shape(f"8x8 fleet Hp={FLEET_HP} B=4096 {sweep_dims(big_fleet['admm'])} f32 (37b, the "
              "fleet's own inputs)", big_fleet["admm"], big_fleet["admm"]["launches"],
              big_fleet["admm"]["per_period"], res["admm fleet Hp=60"][0]),
        shape(f"8x8 fleet Hp={FLEET_HP} B=256 {sweep_dims(big_fleet['admm'])} f32 (37b check at "
              "bench_horizon.py's batch)", big_fleet["admm"]["check_small"], 0, None,
              res["admm fleet Hp=60 B=256"][0])]
    gi_shapes = [
        shape("headline-GI B=4096 n=5 m=101 f32/f64", hgi, path_launches["headline-GI"],
              per_period["headline-GI"], res["gi headline-GI"][0]),
        shape("SLMPC B=4096 n=3 m=65 f32/f64, per-lane P and A", sl_gi, sl_gi["launches"],
              sl_gi["per_period"], sl_gi["lanes_per_sm"]),
        shape("NonLinMPC B=4096 n=2 m=72 f32/f64, per-lane P and A (nonlin lane)", nl_gi,
              nl_gi["launches"], nl_gi["per_period"], nl_gi["lanes_per_sm"]),
        shape("NonLinMPC exact-Hessian A/B B=256 n=2 m=102 f32/f64", nl_ab, nl_ab["launches"],
              nl_ab["per_period"], nl_ab["lanes_per_sm"]),
        shape("MHE fast path B=4096 n=44 m=104 8 slots f32/f64, shared P⁻¹ and A (mhe lane)",
              mhe_gi["a"], mhe_gi["a"]["launches"], mhe_gi["a"]["per_period"],
              mhe_gi["a"]["lanes_per_sm"]),
        shape("MHE NaN variant B=4096 n=44 m=104 8 slots f32/f64, per-lane P⁻¹, shared A "
              "(mhe lane, 1 % NaN)", mhe_gi["b"], mhe_gi["b"]["launches"],
              mhe_gi["b"]["per_period"], mhe_gi["b"]["lanes_per_sm"]),
        shape("MHE fast path at x̂ within ±0.5, B=4096 n=44 m=104 8 slots f32/f64, warm "
              "rows (check)", mhe_gi["a warm"], 0, None, mhe_gi["a warm"]["lanes_per_sm"]),
        shape("MHE nonlin B=1024 n=33 m=146 f32/f64, per-lane P and A (mhe_nonlin lane)",
              mhe_nl, mhe_nl["launches"], mhe_nl["per_period"], mhe_nl["lanes_per_sm"]),
        shape("large-GI B=4096 n=33 m=577 f32/f32", lgi, path_launches["large-GI"],
              per_period["large-GI"], res["gi large-GI"][0]),
        shape("README B=1 n=3 m=233 f64", readme["active_set"],
              path_launches["README"]["gi_solve"], per_period["README GI"],
              res["gi README"][0]),
        shape("random f64 B=4096 n=6 m=24 cap 3 (check)", gi_checks["random_f64"], 0, None,
              res["gi random_f64"][0]),
        shape(f"scan-CSTR run_fleet B={SCAN_B} {gi_dims(scan['active_set'])} f32/f64, one "
              "controller (compiled loop, this slice's main path)", scan["active_set"],
              scan["active_set"]["launches"], scan["active_set"]["per_period"],
              res["gi scan"][0]),
        shape(f"CompiledClosedLoopFleet B=n_d=128 {gi_dims(hetero['active_set'])} f64 "
              "(compiled loop)", hetero["active_set"], hetero["active_set"]["launches"],
              hetero["active_set"]["per_period"], res["gi fleet"][0]),
        shape(f"8x8/Hp={BIG_HP} single B=1 {gi_dims(big['active_set'])} f64 (37a)",
              big["active_set"], big["active_set"]["launches"],
              big["active_set"]["per_period"], res["gi 8x8/Hp=25"][0]),
        shape(f"8x8 fleet Hp={FLEET_HP} B=4096 {gi_dims(big_fleet['active_set'])} f32/f64 (37b, "
              "the fleet's own inputs)", big_fleet["active_set"],
              big_fleet["active_set"]["launches"], big_fleet["active_set"]["per_period"],
              res["gi fleet Hp=60"][0]),
        shape(f"8x8 fleet Hp={FLEET_HP} B=256 {gi_dims(big_fleet['active_set'])} f32/f64 (37b "
              "check at bench_horizon.py's batch)", big_fleet["active_set"]["check_small"], 0,
              None, res["gi fleet Hp=60 B=256"][0]),
        shape(f"MHE He={MHE_HE} B=1 {gi_dims(mhe_big)} f64 (37c)", mhe_big, mhe_big["launches"],
              mhe_big["per_period"], res["gi MHE He=40"][0])]

    def entry(name, source, replaces, launches, shapes, extra_err):
        c = shapes[0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches,
                "max_abs_err": max([sh["max_abs_err"] for sh in shapes] + extra_err),
                "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": None,
                "roofline_share": c["roofline_share"], "event_ms": c["event_ms"],
                "launches_per_period": c["launches_per_period"],
                "resident_lanes_per_sm": c["resident_lanes_per_sm"], "shapes": shapes}
    print(json.dumps({"kernels": [
        entry("admm_sweep", "mpc_tpu_torch/csrc/admm_sweep.cu",
              "mpc_tpu/ops/pallas_qp.py:31", admm_launches["admm_sweep"], admm_shapes,
              [unc["admm"]["err"], layout_worst["admm_sweep"], beyond_worst["admm_sweep"],
               big_fleet["admm"]["err_synthetic"]]),
        entry("gi_solve", "mpc_tpu_torch/csrc/gi_solve.cu",
              "docs/pallas_gi_experiment.py:84 + mpc_tpu/ops/qp_active.py:407", gi_launches,
              gi_shapes, [unc["gi n=6"]["err"], unc["gi n=12"]["err"],
                          layout_worst["gi_solve"], beyond_worst["gi_solve"]])],
        "layouts": equiv}))
    print(f"total {time.perf_counter() - t_start:.1f} s after the card check")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Fail as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        sys.exit(1)
