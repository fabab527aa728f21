"""Run one cell of the benchmark of ``mpc_tpu_torch`` on an NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's notes and, last, each
number the correctness check compared beside its limit on standard error,
and one JSON result line as the last line of standard output; its
``attempted`` and ``failed`` count the lane-periods of the cell file's
``counted_periods`` periods after warm-up, the same in every run.  Exits
with a non-zero code and prints no result when there is no card (or fewer
than the cell needs), when the check fails to run, or when ``jax``,
``jaxlib``, ``flax`` or ``mpc_tpu`` is loaded once the window has closed.
The port's kernels build into ``build/`` inside the checkout; PyTorch's
extension and Triton caches are pointed there too.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    import torch
    from benchmark import harness, registry
    chips = registry.cell_entry(registry.benchmark_spec(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card, or fewer than the {chips} this cell needs", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, notes, lines = harness.run(args.workload, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T0)
    harness.emit(result, notes, lines, harness.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
