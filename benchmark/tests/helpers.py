"""Small sizes of the cells for runs on the CPU (``small/<cell>.json``),
and the numbers a run's notes give."""
import re
import time
import warnings
from pathlib import Path

import torch

from benchmark import harness, registry

SMALL_DIR = Path(__file__).resolve().parent / "small"


def small(workload):
    """``(cell, config)``: the entries laid over the cell file and the
    configuration to cut ``workload`` to its CPU test size, from
    ``small/<workload>.json``."""
    path = SMALL_DIR / f"{workload}.json"
    if not path.exists():
        raise FileNotFoundError(f"cell {workload!r} has no CPU test size: add "
                                f"{path.relative_to(registry.ROOT)}")
    sizes = registry.load_json(path)
    return sizes["cell"], sizes["config"]


def small_run(workload, seed=2**31 + 7, seconds=0.5, trace=False, cell=None, **kw):
    """One run of ``workload`` on the CPU at a test size, with the entries of
    ``cell`` laid over its cell file's."""
    torch.set_num_threads(2)
    cell_override, cfg = small(workload)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return harness.run(workload, seed, seconds, trace, "cpu", time.perf_counter(),
                           cell_override={**cell_override, **(cell or {})},
                           config_override=cfg, **kw)


def lanes(notes):
    """The run's B, from its first note."""
    return int(re.search(r"B=(\d+)", notes[0]).group(1))


def counted_note(notes):
    """The four numbers of the note on the counted periods: the counted
    periods, the periods run past the timed window, the timed periods beyond
    the counted ones, and the unconverged lane-periods in those."""
    ln = next(n for n in notes if n.startswith("counted: "))
    return tuple(int(x) for x in re.search(
        r"^counted: (\d+) periods .*; (\d+) periods run past the timed window; "
        r"(\d+) timed periods beyond the counted ones, with (\d+) unconverged", ln).groups())
