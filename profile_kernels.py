#!/usr/bin/env python3
"""Device time of the two CUDA kernels against another checkout's.

    python3 profile_kernels.py PARENT_DIR [--out FILE.json]

Run from the root of a checkout, on a machine with one CUDA card.
``PARENT_DIR`` is the root of another checkout of this repository (an
earlier commit, unpacked with ``git archive`` into the gitignored
``build/``).  Its ``mpc_tpu_torch`` is imported under another name, builds
its own kernels into ``PARENT_DIR/build/`` and is called through its own
wrappers on the same inputs as this checkout's.  A sweep wrapper without a
``rung`` argument (one that takes per-lane Minv and ρ) gets them gathered
off the ladder in the set-up, outside the timed calls.

The inputs are captured at the shapes of ``chip_smoke.py``'s main paths,
with its helpers: the ADMM sweep (10 sweeps) at headline-ADMM (B=4096, n=5,
m=101, f32), 8x8/Hp=15 (B=256, n=33, m=577, f32) and the same lanes tiled
to B=4096, and the README plant at B=1 (n=3, m=233, f64); the GI solve at
headline-GI, large-GI, float64 random QPs (B=4096, n=6, m=24, cap 3) and
the README plant at B=1; then the launches where every lane owns its QP
matrices (``chip_smoke.per_lane_inputs``): the nonlin lane's sweep and GI
solve (B=4096, n=2, m=72), the mhe_nonlin lane's GI solve (B=1024, n=33,
m=146), the mhe lane's NaN variant (B=4096, n=44, m=104), whose call with
an A map reaches a parent without one with A copied to every lane, as that
parent's fleet made it (the copy made in the set-up), the SLMPC fleet's GI
solve and sweep (B=4096, n=3, m=65) and a compiled-loop fleet's GI solve
(n_d = B = 128, float64).  Each kernel
is timed by ``chip_smoke.device_ms`` (the profiler's kernel records, mean
of 10 calls) in turns, parent, this, this, parent, and the two outputs are
compared.  At 8x8/Hp=15, B=4096 the
sweep is also timed at one and two lanes a block (``admm_kernel.GROUP``) in
turns 1, 2, 2, 1, the NaN variant's GI at 32 and 16 lanes a block
(``gi_kernel.LANES_PER_BLOCK``) in turns 32, 16, 16, 32, and the nonlin
lane's per-lane sweep at 16, 4 and 1 lanes a block
(``admm_kernel.PER_LANE_WARPS``) in turns 16, 4, 1, 1, 4, 16.  Beside each time: the bound, the roofline
share and the lanes resident per SM (``chip_smoke.py``'s helpers).  The
card's name and power limit are printed last.
"""
import argparse
import importlib
import importlib.util
import inspect
import json
import os
import sys

from chip_smoke import (ADMM_KERNELS, GI_KERNELS, ROOT, SWEEP_ARGS, _clone, admm_bound,
                        admm_residency, card_line, device_ms, gi_bound, gi_random_inputs,
                        gi_residency, gi_steady_inputs, large_controllers, per_lane_inputs,
                        readme_controller, single_kernel_inputs, steady_inputs, tile_lanes)

PARENT = "parent_mpc_tpu_torch"
SWEEP_NAMES = ("admm_",)      # the sweep kernels' names, in this checkout and before


def import_parent(root):
    """The other checkout's package and its ``ops``, under another name."""
    pkg = os.path.join(os.path.abspath(root), "mpc_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        PARENT, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(PARENT + ".ops")


def parent_sweep(pops, a):
    """A call of the parent's sweep on this sweep's arguments ``a``."""
    if "rung" in inspect.signature(pops.admm_sweep).parameters:
        return lambda: pops.admm_sweep(*a)
    Minvs, A, lc, rung, q, l, u, rhovs, x, z, y, active, iters, sigma, alpha = a
    li, ri = lc.long(), rung.long()
    Minv, rho = Minvs[li, ri].contiguous(), rhovs[li, ri].contiguous()
    return lambda: pops.admm_sweep(Minv, A, lc, q, l, u, rho, x, z, y, active, iters,
                                   sigma, alpha)


def in_turns(torch, calls, names, order):
    """``{label: [ms, ...]}``: each ``calls[label] = (setup, fn)`` timed by
    ``device_ms`` in the order of ``order``."""
    out = {}
    for label in order:
        setup, fn = calls[label]
        out.setdefault(label, []).append(device_ms(torch, fn, setup, names))
    return out


def sweep_case(torch, ops, _build, pops, args):
    h = {}
    calls = {"new": (lambda: h.update(a=_clone(args)), lambda: ops.admm_sweep(*h["a"])),
             "parent": (lambda: h.update(call=parent_sweep(pops, _clone(args))),
                        lambda: h["call"]())}
    res = in_turns(torch, calls, SWEEP_NAMES, ("parent", "new", "new", "parent"))
    a, b = _clone(args), _clone(args)
    ops.admm_sweep(*a)
    parent_sweep(pops, b)()
    torch.cuda.synchronize()
    res["max_abs_diff_x_z_y"] = [(a[k] - b[k]).abs().max().item() for k in (8, 9, 10)]
    base = dict(zip(SWEEP_ARGS, args[:12]))
    res["bound_ms"], res["bound_by"] = admm_bound(torch, base, args[12])
    res["roofline_share"] = res["bound_ms"] / min(res["new"])
    res["resident_lanes_per_sm"], res["geometry"] = admm_residency(torch, ops, _build, base)
    return res


def group_widths(torch, ops, args, widths=(1, 2), knob="GROUP"):
    """The sweep at each of ``widths`` lanes a block (``admm_kernel``'s
    ``knob``: the lanes in step, or the per-lane geometry's warps), in
    turns."""
    from mpc_tpu_torch.ops import admm_kernel
    default, h = getattr(admm_kernel, knob), {}

    def at(w):
        def setup():
            setattr(admm_kernel, knob, w)
            h["a"] = _clone(args)
        return setup, lambda: ops.admm_sweep(*h["a"])
    try:
        return in_turns(torch, {w: at(w) for w in widths}, ADMM_KERNELS,
                        list(widths) + list(reversed(widths)))
    finally:
        setattr(admm_kernel, knob, default)


def parent_gi_args(pops, args):
    """This GI call's arguments for the parent: with an A map its parent may
    not take, A copied to every lane and the map dropped."""
    if len(args) <= 16 or "a_ctrl" in inspect.signature(pops.gi_solve).parameters:
        return args
    a = list(args[:16])
    a[1] = args[1].index_select(0, args[16]).contiguous()
    return a


def gi_widths(torch, ops, args, widths):
    """GI at each of ``widths`` lanes a block (``gi_kernel.LANES_PER_BLOCK``),
    in turns."""
    from mpc_tpu_torch.ops import gi_kernel
    default, h = gi_kernel.LANES_PER_BLOCK, {}

    def at(w):
        def setup():
            gi_kernel.LANES_PER_BLOCK = w
            h["a"] = _clone(args)
        return setup, lambda: ops.gi_solve(*h["a"])
    try:
        return in_turns(torch, {w: at(w) for w in widths}, GI_KERNELS,
                        list(widths) + list(reversed(widths)))
    finally:
        gi_kernel.LANES_PER_BLOCK = default


def gi_case(torch, ops, _build, pops, args):
    h = {}
    pargs = parent_gi_args(pops, args)
    calls = {"new": (lambda: h.update(a=_clone(args)), lambda: ops.gi_solve(*h["a"])),
             "parent": (lambda: h.update(a=_clone(pargs)), lambda: pops.gi_solve(*h["a"]))}
    res = in_turns(torch, calls, GI_KERNELS, ("parent", "new", "new", "parent"))
    xk, _, itk, ck = ops.gi_solve(*_clone(args))
    xp, _, itp, cp = pops.gi_solve(*_clone(pargs))
    torch.cuda.synchronize()
    res["pivots_mean"] = itk.float().mean().item()
    res["pivots_max"] = int(itk.max())
    res["equal_iterations"] = int((itk == itp).sum())
    res["equal_flags"] = int((ck == cp).sum())
    res["max_abs_diff_x"] = (xk - xp).abs().max().item()
    res["bound_ms"], res["bound_by"] = gi_bound(torch, args, itk)
    res["roofline_share"] = res["bound_ms"] / min(res["new"])
    res["resident_lanes_per_sm"], res["geometry"] = gi_residency(torch, _build, args)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="root of another checkout of this repository")
    ap.add_argument("--out", help="write the results to this JSON file too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_kernels: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import ops
    from mpc_tpu_torch.ops import _build
    from mpc_tpu_torch.parallel import BatchedLinMPC, random_cstr_controllers
    dev = torch.device("cuda")
    _build.load_library()
    out = {"ptxas_new": [ln.strip() for ln in _build.last_build["log"].splitlines()
                         if "registers" in ln]}
    pops = import_parent(args.parent)
    pbuild = importlib.import_module(PARENT + ".ops._build")
    pbuild.load_library()
    out["ptxas_parent"] = [ln.strip() for ln in pbuild.last_build["log"].splitlines()
                           if "registers" in ln]

    # the inputs, captured as chip_smoke.py captures them
    cases = {}
    ctrls = random_cstr_controllers(256, Hp=10, Hc=2, seed=0)
    fleet = BatchedLinMPC(ctrls, reps=16, device=dev, dtype=torch.float32)
    cases["sweep headline-ADMM"] = ("sweep", steady_inputs(torch, fleet, ctrls, 16))
    del fleet
    large = large_controllers(mt, 16)
    lfleet = BatchedLinMPC(large, reps=16, device=dev, dtype=torch.float32)
    cases["sweep 8x8 B=256"] = ("sweep", steady_inputs(torch, lfleet, large, 16))
    cases["sweep 8x8 B=4096"] = ("sweep", tile_lanes(cases["sweep 8x8 B=256"][1], 16))
    del lfleet
    for name, make, reps, slots in (
            ("gi headline-GI", lambda: random_cstr_controllers(
                256, Hp=10, Hc=2, seed=0, qp_solver="active_set"), 16, None),
            ("gi large-GI", lambda: large_controllers(
                mt, 32, qp_solver="active_set", gi_max_active=8), 128, torch.float32)):
        cs = make()
        gf = BatchedLinMPC(cs, reps=reps, device=dev, dtype=torch.float32,
                           gi_slot_dtype=slots)
        cases[name] = ("gi", gi_steady_inputs(torch, gf, cs, reps))
        del gf
    cases["gi random f64"] = ("gi", gi_random_inputs(torch, ops, dev))
    for qp_solver, key in (("admm", "sweep"), ("active_set", "gi")):
        ctrl = readme_controller(mt, qp_solver, dev)
        res = mt.sim(ctrl, 10, [5, 0])
        cases[f"{key} README B=1"] = (key, single_kernel_inputs(
            ops, ctrl, key, res.Y_data[-1], [5, 0]))
    cases.update(per_lane_inputs(torch, mt, ops, dev))

    for name, (kind, a) in cases.items():
        r = (sweep_case if kind == "sweep" else gi_case)(torch, ops, _build, pops, a)
        out[name] = r
        print(name, json.dumps(r), flush=True)
    out["sweep 8x8 B=4096 lanes a block"] = group_widths(torch, ops, cases["sweep 8x8 B=4096"][1])
    print("sweep 8x8 B=4096 lanes a block", json.dumps(out["sweep 8x8 B=4096 lanes a block"]),
          flush=True)
    key = "gi (b) mhe NaN lanes a block"
    out[key] = gi_widths(torch, ops, cases["gi (b) mhe NaN n=44 m=104"][1], (32, 16))
    print(key, json.dumps(out[key]), flush=True)
    key = "sweep NonLinMPC n=2 m=72 per-lane warps a block"
    out[key] = group_widths(torch, ops, cases["sweep NonLinMPC n=2 m=72"][1], (16, 4, 1),
                            "PER_LANE_WARPS")
    print(key, json.dumps(out[key]), flush=True)
    out["card"] = card_line()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
