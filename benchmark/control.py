"""Readings of a cell's correctness check: the program's and its control's.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

runs the cell once per seed, at its own size and load, in one process, and
prints per seed the largest gap of the port's u to the float64 reference
(the program's reading) and of the reference computed in TF32 (the
control's reading) to the same reference, as one JSON line each.  The
limits in the cells' files are set between the two.  The benchmark's own
runs do not run the control.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, notes, _ = harness.run(args.workload, seed, args.seconds, bool(args.trace),
                                       "cuda", t0, control=True)
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=result["correct"],
                              checks={k: v["value"] for k, v in result["checks"].items()},
                              control=result["control"], notes=notes,
                              metrics={k: v["value"] for k, v in result["metrics"].items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
