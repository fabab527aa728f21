#!/usr/bin/env python3
"""Tunings and cuts of the staged sweep and the split GI solve at the 8x8
fleet's Hp=60 shape.

    python3 profile_layouts.py [--out FILE.json]

Run from the root of a checkout, on a machine with one CUDA card.  The
inputs are those of ``chip_smoke.py``'s phase 37b: bench_horizon.py's fleet
at Hp=60 (32 random 8x8 plants x 128 = 4096 lanes, float32, n=33, m=2017),
a steady period's GI solve (12 slots, float64 slots) and ADMM sweep (10
sweeps).  GI: the split layout at ``gi_kernel.SPLIT_WARPS`` 16, 12 and 8
against the global layout.  The sweep: the staged layout over a grid of
(lanes a block, tile rows, stages) against the global layout; then copies of
``admm_sweep.cu`` with one part of the staged kernel cut out, built into
``build/layout_cuts/`` and timed in turn (their results are wrong: they
show where the time goes): without the streamed loads, without phase A's
products, without phase B, without both.  Every tuning's outputs must equal
the global layout's bit for bit.  Each time is ``chip_smoke.device_ms``
(the profiler's kernel records, mean of 10 calls).  The card's name and
power limit are printed last.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# (lanes a block, tile rows, stages) of the staged layout
STAGED_GRID = ((4, 256, 2), (4, 224, 3), (4, 128, 2), (4, 128, 4), (2, 256, 2), (2, 256, 3),
               (1, 256, 2))
GI_WARPS = (16, 12, 8)
# cuts of admm_staged_kernel: name → [(text, replacement)]
NO_LOADS = ("    if (g < total) {\n      const int r0 = rows",
            "    if (false) {\n      const int r0 = rows")
NO_A = ("      if (sweep) {\n        const T* ar", "      if (false) {\n        const T* ar")
NO_B = ("    if (!splits) return;\n", "    return;\n")
CUTS = {"no streamed loads": [NO_LOADS], "no phase A products": [NO_A], "no phase B": [NO_B],
        "no phase A products, no phase B": [NO_A, NO_B]}


def bits_equal(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_layouts.py needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import ops
    from mpc_tpu_torch.ops import _build, admm_kernel as ak, gi_kernel as gk
    from mpc_tpu_torch.parallel import BatchedLinMPC
    dev = torch.device("cuda")
    _build.load_library()
    out = {"gi": {}, "admm": {}, "admm_cuts": {}}

    ctrls = cs.large_controllers(mt, 32, Hp=60, qp_solver="active_set", gi_max_active=12,
                                 device="cpu")
    fleet = BatchedLinMPC(ctrls, reps=128, device=dev, dtype=torch.float32)
    chk = {"args": cs.gi_steady_inputs(torch, fleet, ctrls, 128)}
    del fleet
    ref = cs.kernel_runs(torch, ops, "gi_solve", chk, ("global",))["global"]
    runs = [("global", None)] + [(None, w) for w in GI_WARPS]
    for layout, warps in runs:
        if warps:
            gk.SPLIT_WARPS = warps
        got = cs.kernel_runs(torch, ops, "gi_solve", chk, (layout,))[str(layout)]
        ms = cs.layout_ms(torch, ops, "gi_solve", chk, layout)
        key = "global" if layout else f"split, {warps} warps"
        out["gi"][key] = dict(ms=ms, rows=cs.layout_rows(torch, chk["args"], "gi_solve", layout),
                              same_bits=bits_equal(ref, got))
        print(f"GI {key}: {json.dumps(out['gi'][key])}", flush=True)
    gk.SPLIT_WARPS = GI_WARPS[0]

    ctrls = cs.large_controllers(mt, 32, Hp=60, qp_solver="admm", device="cpu")
    fleet = BatchedLinMPC(ctrls, reps=128, device=dev, dtype=torch.float32)
    args = cs.steady_inputs(torch, fleet, ctrls, 128)
    del fleet
    chk = {"args": dict(zip(cs.SWEEP_ARGS, args[:12])), "tail": args[12:]}
    ref = cs.kernel_runs(torch, ops, "admm_sweep", chk, ("global",))["global"]
    ms = cs.layout_ms(torch, ops, "admm_sweep", chk, "global")
    out["admm"]["global"] = dict(ms=ms)
    print(f"sweep global: {ms:.4f} ms", flush=True)
    default = (ak.STAGED_LANES, ak.STAGED_TILE_ROWS, ak.STAGED_STAGES)
    for cfg in STAGED_GRID:
        ak.STAGED_LANES, ak.STAGED_TILE_ROWS, ak.STAGED_STAGES = cfg
        got = cs.kernel_runs(torch, ops, "admm_sweep", chk, (None,))["None"]
        ms = cs.layout_ms(torch, ops, "admm_sweep", chk, None)
        table = cs.admm_geometry(torch, chk["args"])[0]
        plan = ak.staged_plan(33, 2017, 4, table.shape[1], cs.card_geometry(torch)[0])
        key = f"staged, {table.shape[1]} lanes, tile {plan[1]}, {plan[2]} stages"
        out["admm"][key] = dict(ms=ms, rows=plan[0], smem=plan[3],
                                same_bits=bits_equal(ref, got))
        print(f"sweep {key}: {json.dumps(out['admm'][key])}", flush=True)
    ak.STAGED_LANES, ak.STAGED_TILE_ROWS, ak.STAGED_STAGES = default

    # the cuts: one library each, built in parallel, swapped in for the sweep
    src = open(os.path.join(ROOT, "mpc_tpu_torch", "csrc", "admm_sweep.cu")).read()
    cut_dir = os.path.join(ROOT, "build", "layout_cuts")
    os.makedirs(cut_dir, exist_ok=True)
    procs = {}
    for i, (name, reps) in enumerate(CUTS.items()):
        s = src
        for a, b in reps:
            if s.count(a) != 1:
                sys.exit(f"cut {name!r}: the text to cut is not in admm_sweep.cu once")
            s = s.replace(a, b)
        cu = os.path.join(cut_dir, f"cut{i}.cu")
        open(cu, "w").write(s)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    real = _build.load_library()
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"cut {name!r} did not build:\n{log}")
    try:
        for name, (so, _) in [("none", (None, None))] + list(procs.items()):
            lib = real
            if so:
                lib = ctypes.CDLL(so)
                for fn in ("mpc_admm_sweep_f32", "mpc_admm_sweep_f64"):
                    getattr(lib, fn).argtypes = getattr(real, fn).argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _build._lib = lib
            ms = cs.layout_ms(torch, ops, "admm_sweep", chk, None)
            out["admm_cuts"][name] = ms
            print(f"sweep staged, cut {name}: {ms:.4f} ms", flush=True)
    finally:
        _build._lib = real
    card = cs.card_line()
    out["card"] = card
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        json.dump(out, open(opts.out, "w"), indent=1)
    print(card)


if __name__ == "__main__":
    main()
