"""Small sizes of the cells for runs on the CPU."""
import time
import warnings

import torch

from benchmark import harness

SMALL = {
    "cstr-gi": (dict(reps=2, check_lanes_per_controller=2), dict(n_distinct=6)),
    "cstr-admm": (dict(reps=2, check_lanes_per_controller=2), dict(n_distinct=6)),
    "pendulum-sl-gi": (dict(lanes=24, check_lanes=12), None),
}


def small_run(workload, seed=2**31 + 7, seconds=0.5, trace=False, **kw):
    """One run of ``workload`` on the CPU at a test size."""
    torch.set_num_threads(2)
    cell, cfg = SMALL[workload]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return harness.run(workload, seed, seconds, trace, "cpu", time.perf_counter(),
                           cell_override=cell, config_override=cfg, **kw)
