"""The readers of the QP build's two counters (``fleet_step.grouped_products``
and ``fleet_step.lane_copy_mb``): on a synthetic record, on a port that keeps
none, their entries in the spec, and small traced runs of the cells on the
CPU."""
import sys

import pytest

from benchmark import registry
from benchmark.tests.helpers import small_run
from mpc_tpu_torch.utils import trace

# the QP build's counters: products taken a GEMM a controller, lane copies' MB
COUNTED = ["fleet_step.grouped_products", "fleet_step.lane_copy_mb"]


def _steps(n, **counts):
    """``n`` traced steps, each with the counters ``counts``."""
    return [dict(step=j, host_syncs=0, launches={}, spans=[], items={}, **counts)
            for j in range(n)]


@pytest.fixture
def record(monkeypatch):
    def use(steps):
        monkeypatch.setattr(trace, "steps", lambda: steps)
    return use


def test_the_build_counters_readers(record):
    # 5 steps recorded, a stretch of the last 3 (steps 2, 3, 4)
    steps = _steps(5, grouped_products=19)
    for j, st in enumerate(steps):
        st["lane_copy_bytes"] = (700 + j) * 10**6
    record(steps)
    read = lambda name: registry.metric_reader(name)(dict(stretch_periods=3))
    assert read("fleet_step.grouped_products") == pytest.approx(19.0)
    assert read("fleet_step.lane_copy_mb") == pytest.approx(703.0)
    # the parent's record: steps without the counters
    record(_steps(5))
    assert read("fleet_step.grouped_products") is None
    assert read("fleet_step.lane_copy_mb") is None
    # fewer traced steps than the stretch, or an untraced run
    record(_steps(2, grouped_products=19, lane_copy_bytes=1))
    assert read("fleet_step.grouped_products") is None
    assert registry.metric_reader("fleet_step.lane_copy_mb")(dict()) is None


def test_the_build_counters_readers_without_the_module(monkeypatch):
    # a port without mpc_tpu_torch.utils.trace: the import fails, None
    monkeypatch.setitem(sys.modules, "mpc_tpu_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["mpc_tpu_torch.utils"], "trace")
    for name in COUNTED:
        assert registry.metric_reader(name)(dict(stretch_periods=2)) is None, name


def test_the_build_counters_are_in_the_spec_for_the_cstr_cells():
    by = {m["name"]: m for m in registry.benchmark_spec()["per_layer"]}
    for name, better, layer in zip(COUNTED, ("higher", "lower"), ("QP build", "fleet step")):
        m = by[name]
        assert (m["source"], m["moves"], m["better"], m["layer"]) == (
            "program_counter", "lane_periods_per_s", better, layer)
        assert m["workloads"] == ["cstr-gi", "cstr-admm"]


@pytest.mark.parametrize("workload", ["cstr-gi", "cstr-admm", "pendulum-sl-gi"])
def test_a_small_traced_run_reports_the_build_counters(workload):
    trace.clear()
    result, _, _ = small_run(workload, trace=True)
    assert result["correct"]
    got = result["metrics"]
    if workload == "pendulum-sl-gi":
        # SLMPC builds its own QP on an identity map: neither counter
        assert not set(COUNTED) & set(got)
    else:
        # every product of the build grouped, the copies left in MB
        assert got["fleet_step.grouped_products"]["value"] >= 15
        assert got["fleet_step.grouped_products"]["unit"] == "count"
        assert got["fleet_step.lane_copy_mb"]["value"] > 0
        assert got["fleet_step.lane_copy_mb"]["unit"] == "MB"
    # the untraced run reports neither
    trace.clear()
    result, _, _ = small_run(workload)
    assert not set(COUNTED) & set(result["metrics"])
