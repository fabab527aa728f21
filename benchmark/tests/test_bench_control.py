"""The correctness check fails where it must, at a test size on the CPU.

The control: the reference computed in TF32 in the port's place has to
come out as not correct against each cell's limits.  The faults: the
timed path broken underneath a run that skips the harness's look for a
card — a step that returns its state unchanged, half of the batch left out
with the mean of the rest in its place, and an answer altered where it is
produced (the LinMPC step's u, the SLMPC step's QP solution) — each has to
make ``correct`` false.  (The cells
run on one card, so there is no exchange between cards to leave out.)"""
import functools

import pytest

from .helpers import small_run

CELLS = ["cstr-gi", "cstr-admm", "pendulum-sl-gi"]


@pytest.mark.parametrize("workload", CELLS)
def test_bench_control_fails_and_the_program_passes(workload):
    result, _, _ = small_run(workload, seconds=1.0, control=True)
    limit = result["checks"]["u_gap"]["limit"]
    assert result["correct"] is True
    assert result["control"]["program_u_gap"] <= limit < result["control"]["u_gap"]


def state_unchanged(cell):
    if hasattr(cell, "fleet"):
        step = cell.fleet.step

        def frozen(*a, **k):
            before = cell.fleet.state
            out = step(*a, **k)
            cell.fleet.state = before
            return out
        cell.fleet.step = frozen
    else:
        cell.fleet_step = functools.partial(lambda inner, st, *a: (*inner(st, *a)[:2], st),
                                            cell.fleet_step)


def half_batch(cell):
    step = cell.step

    def half(*a):
        u, n_conv = step(*a)
        u = u.clone()
        u[u.shape[0] // 2:] = u[:u.shape[0] // 2].mean(0)
        return u, n_conv
    cell.step = half


def altered_answer(cell, monkeypatch):
    def alter(sol):
        x = sol.x.clone()
        x[::3, 0] += 1.0
        return sol._replace(x=x)
    if hasattr(cell, "fleet"):
        raw = cell.fleet._step_raw

        def wrong(*a, **k):
            u, *rest = raw(*a, **k)
            u = u.clone()
            u[::3, 0] += 1.0
            return (u, *rest)
        cell.fleet._step_raw = wrong
    else:
        import mpc_tpu_torch.controllers.slmpc as slmpc
        solve = slmpc.solve_qp_active
        monkeypatch.setattr(slmpc, "solve_qp_active", lambda *a, **k: alter(solve(*a, **k)))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer"])
def test_bench_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    breaks = {"state_unchanged": state_unchanged, "half_batch": half_batch,
              "altered_answer": lambda c: altered_answer(c, monkeypatch)}[fault]
    result, _, _ = small_run(workload, seconds=1.0, fault=breaks)
    assert result["correct"] is False, result["checks"]
