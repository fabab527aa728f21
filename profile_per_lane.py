#!/usr/bin/env python3
"""Where a per-lane launch's time goes: both kernels with parts of their
work cut out, at the shapes where every lane owns its QP matrices.

    python3 profile_per_lane.py [--out FILE.json]

Run from the root of a checkout, on a machine with one CUDA card.  The
inputs are ``chip_smoke.per_lane_inputs``: the nonlin lane's ADMM sweep
(B=4096, n=2, m=72, f32, 10 sweeps) and GI solve (n=2, m=72), the
mhe_nonlin lane's GI solve (shape (c), B=1024, n=33, m=146, 33 slots), the
mhe lane's NaN variant (shape (b), B=4096, n=44, m=104, 8 slots), the SLMPC
fleet's GI solve and sweep (n=3, m=65) and a compiled-loop fleet's GI
solve (n_d = B = 128, float64).  The
sources under ``mpc_tpu_torch/csrc`` are built again with ``-DMPC_CUT=k``
into ``build/per_lane_cuts/`` (one nvcc a source and cut, all started
together), each library swapped in for the wrapper's in turn: 1 an empty
kernel at the same grid, 2 the loads only, 3 the loads and GI's row norms
(the sweep has none), 4 the loads and one sweep or one pivot; the whole
kernel is timed first and last.  The cut kernels' results are wrong: they
show where the time goes.  Each time is ``chip_smoke.device_ms`` (the
profiler's kernel records, mean of 10 calls).  The card's name and power
limit are printed last.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CUTS = {1: "empty kernel", 2: "loads only", 3: "loads and row norms",
        4: "loads and one sweep or pivot"}
SOURCES = {"sweep": "admm_sweep.cu", "gi": "gi_solve.cu"}


def build_cuts(_build):
    """``{(kernel, cut): path of the library}``, built in parallel."""
    out_dir = os.path.join(ROOT, "build", "per_lane_cuts")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for kernel, src in SOURCES.items():
        for cut in CUTS:
            if kernel == "sweep" and cut == 3:
                continue
            so = os.path.join(out_dir, f"{kernel}_cut{cut}.so")
            procs[(kernel, cut)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, f"-DMPC_CUT={cut}", "-shared", "-o", so,
                 str(_build.CSRC / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"cut {key} did not build:\n{log}")
        libs[key] = so
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_per_lane.py needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import ops
    from mpc_tpu_torch.ops import _build
    dev = torch.device("cuda")
    real = _build.load_library()
    out = {"ptxas": [ln.strip() for ln in _build.last_build["log"].splitlines()
                     if "registers" in ln or "Compiling entry" in ln or "spill" in ln]}
    libs = build_cuts(_build)
    cases = cs.per_lane_inputs(torch, mt, ops, dev)
    for name, (kernel, args) in cases.items():
        h = {}
        setup = lambda: h.update(a=cs._clone(args))
        if kernel == "sweep":
            fn, names, wrapper = lambda: ops.admm_sweep(*h["a"]), cs.ADMM_KERNELS, "admm_sweep"
            base = dict(zip(cs.SWEEP_ARGS, args[:12]))
            bound = cs.admm_bound(torch, base, args[12])
            lanes = cs.admm_residency(torch, ops, _build, base)
        else:
            fn, names, wrapper = lambda: ops.gi_solve(*h["a"]), cs.GI_KERNELS, "gi_solve"
            it = ops.gi_solve(*cs._clone(args))[2]
            bound = cs.gi_bound(torch, args, it)
            lanes = cs.gi_residency(torch, _build, args)
        count = lambda: ops.LAUNCHES[wrapper]
        res = {"whole kernel": [cs.device_ms(torch, fn, setup, names, launches=count)]}
        for cut, label in CUTS.items():
            if (kernel, cut) not in libs:
                continue
            lib = ctypes.CDLL(libs[(kernel, cut)])
            for sym in cs.LIB_SYMBOLS[wrapper]:
                getattr(lib, sym).argtypes = getattr(real, sym).argtypes
                getattr(lib, sym).restype = ctypes.c_int
            _build._lib = lib
            try:
                res[label] = cs.device_ms(torch, fn, setup, names, launches=count)
            finally:
                _build._lib = real
        res["whole kernel"].append(cs.device_ms(torch, fn, setup, names, launches=count))
        res.update(bound_ms=bound[0], bound_by=bound[1], lanes_per_sm=lanes[0],
                   geometry=lanes[1])
        if kernel == "gi":
            res.update(pivots_mean=it.float().mean().item(), pivots_max=int(it.max()))
        out[name] = res
        print(name, json.dumps(res), flush=True)
    card = cs.card_line()
    out["card"] = card
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        json.dump(out, open(opts.out, "w"), indent=1)
    print(card)


if __name__ == "__main__":
    main()
