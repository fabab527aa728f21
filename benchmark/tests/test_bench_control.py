"""The correctness check fails where it must, at a test size on the CPU.

The control: the reference computed in TF32 in the port's place has to
come out as not correct against each cell's limits.  The faults: the
timed path broken underneath a run that skips the harness's look for a
card — a step that returns its state unchanged, half of the batch left out
with the mean of the rest in its place, and an answer altered where it is
produced (the LinMPC step's u, the SLMPC step's QP solution) — each has to
make ``correct`` false.  Every cell of BENCHMARK.json runs them; the faults
that reach inside a step are its kind's, in ``faults/<kind>.py``.  (The cells
run on one card, so there is no exchange between cards to leave out.)"""
import importlib

import pytest

from benchmark import registry

from .helpers import small_run

SPEC = registry.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_bench_control_fails_and_the_program_passes(workload):
    result, _, _ = small_run(workload, seconds=1.0, control=True)
    limit = result["checks"]["u_gap"]["limit"]
    assert result["correct"] is True
    assert result["control"]["program_u_gap"] <= limit < result["control"]["u_gap"]


def planted(workload):
    """``faults/<kind>.py`` of the cell's configuration kind."""
    kind = registry.config_file(SPEC, registry.cell_entry(SPEC, workload)["config"])["kind"]
    return importlib.import_module(f"benchmark.tests.faults.{kind}")


def half_batch(cell):
    step = cell.step

    def half(*a):
        u, n_conv = step(*a)
        u = u.clone()
        u[u.shape[0] // 2:] = u[:u.shape[0] // 2].mean(0)
        return u, n_conv
    cell.step = half


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer"])
def test_bench_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    faults = planted(workload)
    breaks = {"state_unchanged": faults.state_unchanged, "half_batch": half_batch,
              "altered_answer": lambda c: faults.altered_answer(c, monkeypatch)}[fault]
    result, _, _ = small_run(workload, seconds=1.0, fault=breaks)
    assert result["correct"] is False, result["checks"]
