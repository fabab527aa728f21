"""Small sizes of the cells for runs on the CPU, and the numbers a run's
notes give."""
import re
import time
import warnings

import torch

from benchmark import harness

SMALL = {
    "cstr-gi": (dict(reps=2, check_lanes_per_controller=2, counted_periods=8),
                dict(n_distinct=6)),
    "cstr-admm": (dict(reps=2, check_lanes_per_controller=2, counted_periods=8),
                  dict(n_distinct=6)),
    # 32 counted periods: at 24 lanes the pendulums' u spread apart, so that
    # half the batch given the mean of the rest fails the check, only after
    # ~29 periods, however fast the CPU runs them
    "pendulum-sl-gi": (dict(lanes=24, check_lanes=12, counted_periods=32), None),
}


def small_run(workload, seed=2**31 + 7, seconds=0.5, trace=False, cell=None, **kw):
    """One run of ``workload`` on the CPU at a test size, with the entries of
    ``cell`` laid over its cell file's."""
    torch.set_num_threads(2)
    cell_override, cfg = SMALL[workload]
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
