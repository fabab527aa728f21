"""The result line counts the same lane-periods in every run of a seed: B
times the cell file's ``counted_periods`` periods after warm-up, however
many periods the timed window held.  On the CPU at a test size."""
import re
import time

import pytest

from benchmark import registry

from .helpers import counted_note, lanes, small, small_run

SPEC = registry.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
PENDULUM = "pendulum-sl-gi"


def warmup(workload):
    traffic = registry.traffic_file(registry.cell_entry(SPEC, workload)["traffic"])
    return int(traffic.get("warmup_periods", 3))


def periods_in_window(notes):
    return int(re.search(r"(\d+) periods in the window", notes[0]).group(1))


def wrap_step(cell, after, calls=None):
    """Hand the i-th call's answer of ``cell.step`` through
    ``after(i, u, n_conv)``; ``calls`` gets each call's start on the host
    clock."""
    step = cell.step
    calls = [] if calls is None else calls

    def wrapped(*a):
        calls.append(time.perf_counter())
        return after(len(calls) - 1, *step(*a))
    cell.step = wrapped


def sleeping(s):
    def after(i, u, n_conv):
        time.sleep(s)
        return u, n_conv
    return lambda cell: wrap_step(cell, after)


@pytest.mark.parametrize("workload", CELLS)
def test_bench_a_slow_run_counts_what_a_fast_one_counts(workload):
    n = small(workload)[0]["counted_periods"]
    fast, fast_notes, _ = small_run(workload, seconds=1.0)
    slow, slow_notes, _ = small_run(workload, seconds=1.0, fault=sleeping(0.3))
    assert counted_note(slow_notes)[1] > 0
    assert periods_in_window(fast_notes) > periods_in_window(slow_notes)
    for r, notes in ((fast, fast_notes), (slow, slow_notes)):
        assert r["correct"] is True
        assert r["attempted"] == lanes(notes) * n
    assert slow["failed"] == fast["failed"]
    if workload == PENDULUM:
        assert fast["failed"] > 0           # the swing-up's unconverged lanes are counted


def test_bench_periods_past_the_window_are_checked_but_not_timed(monkeypatch):
    n, warm = 8, warmup(PENDULUM)
    ctxs, calls = [], []
    reader = registry.metric_reader

    def recording_reader(name):
        read = reader(name)

        def recorded(ctx):
            ctxs.append(ctx)
            return read(ctx)
        return recorded
    monkeypatch.setattr(registry, "metric_reader", recording_reader)

    def slow_and_wrong_at_the_last_counted_period(cell):
        def after(i, u, n_conv):
            time.sleep(0.3)
            return (u + 2.0 if i == warm + n - 1 else u), n_conv
        wrap_step(cell, after, calls)

    result, notes, _ = small_run(PENDULUM, seconds=1.0, cell=dict(counted_periods=n),
                                 fault=slow_and_wrong_at_the_last_counted_period)
    ctx = ctxs[0]
    n_win = ctx["n_window"]
    assert n_win < n and counted_note(notes)[:3] == (n, n - n_win, 0)
    assert f"{warm + n} periods recorded" in notes[0] and len(calls) == warm + n
    # the window closed before the first period past it, and the extra periods
    # add no samples and no time to its readings
    assert len(ctx["period_ms"]) == n_win and len(ctx["cycle_s"]) == n_win - 1
    assert ctx["window_s"] < calls[warm + n_win] - calls[warm - 1]
    rate = result["metrics"]["lane_periods_per_s"]["value"]
    assert rate == lanes(notes) * n_win / ctx["window_s"]
    # the altered u of the last counted period, past the window, is caught
    assert result["correct"] is False
    assert result["checks"]["u_gap"]["value"] > result["checks"]["u_gap"]["limit"]


def test_bench_lanes_failing_after_the_counted_periods_show_but_are_not_counted():
    n, warm = 8, warmup(PENDULUM)

    def late_failures(cell):
        half = cell.B // 2
        wrap_step(cell, lambda i, u, n_conv: (u, n_conv - half if i >= warm + n else n_conv))

    base, base_notes, _ = small_run(PENDULUM, seconds=1.0, cell=dict(counted_periods=n))
    late, late_notes, _ = small_run(PENDULUM, seconds=1.0, cell=dict(counted_periods=n),
                                    fault=late_failures)
    assert late["failed"] == base["failed"] and late["attempted"] == base["attempted"]
    _, _, over, over_failed = counted_note(late_notes)
    assert over > 0 and over_failed >= over * (lanes(late_notes) // 2)
    assert counted_note(base_notes)[3] < over_failed
    share = late["checks"]["unconverged_share"]
    assert base["checks"]["unconverged_share"]["value"] < share["limit"] < share["value"]
    assert base["correct"] is True and late["correct"] is False


@pytest.mark.parametrize("path", sorted((registry.HERE / "workloads").glob("*.json")),
                         ids=lambda p: p.stem)
def test_bench_every_cell_file_states_its_counted_periods(path):
    cell = registry.load_json(path)
    c = cell["counted_periods"]
    assert type(c) is int and 0 < c < cell["max_periods"]
    # warm-up, the counted periods and the traced stretch fit the record
    assert warmup(path.stem) + c + cell["stretch_periods"] <= cell["max_periods"]
