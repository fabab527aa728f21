"""The readers of the port's spans and counters (``benchmark/spans.py`` and
the ten metrics that use it): on a synthetic record, on a port that keeps
none, and on small traced runs of the cells on the CPU, where the port
records host times and counters but no stream times."""
import sys

import pytest

from benchmark import registry
from benchmark.tests.helpers import small_run
from mpc_tpu_torch.utils import trace

HOST = {"estimator.host_ms": ("estimator.correct", "estimator.predict"),
        "linearize.host_ms": ("linearize",), "qp_build.host_ms": ("qp.build",),
        "qp_solve.host_ms": ("qp.solve",)}
STREAM = {k.replace("host_ms", "stream_ms"): v for k, v in HOST.items()}
NEW = sorted(HOST) + sorted(STREAM) + ["fleet_step.host_syncs", "slmpc.gi_pivots_max"]


def _span(name, host, stream):
    return dict(name=name, parent=None if name == "fleet.step" else "fleet.step",
                host_ms=host, stream_ms=stream)


def _steps(n, linearize=True, stream=True):
    """``n`` steps whose numbers say which span and step they are."""
    out = []
    for j in range(n):
        names = ["estimator.correct"] + (["linearize"] if linearize else []) + [
            "qp.build", "qp.solve", "estimator.predict", "fleet.step"]
        spans = [_span(nm, 1.0 + i + 10 * j, (2.0 + i + 10 * j) if stream else None)
                 for i, nm in enumerate(names)]
        out.append(dict(step=j, host_syncs=j, launches={}, spans=spans,
                        items={"gi_pivots_max": 3 + j} if linearize else {}))
    return out


@pytest.fixture
def record(monkeypatch):
    def use(steps):
        monkeypatch.setattr(trace, "steps", lambda: steps)
    return use


def test_readers_on_a_synthetic_record(record):
    # 5 steps recorded, a stretch of the last 3 (steps 2, 3, 4)
    record(_steps(5))
    ctx = dict(stretch_periods=3)
    read = lambda name: registry.metric_reader(name)(ctx)
    # a span's host time is 1 + its index + 10 × its step; stream time 1 more
    assert read("estimator.host_ms") == pytest.approx((1 + 5) + 2 * 30)
    assert read("estimator.stream_ms") == pytest.approx((2 + 6) + 2 * 30)
    assert read("linearize.host_ms") == pytest.approx(2 + 30)
    assert read("qp_build.host_ms") == pytest.approx(3 + 30)
    assert read("qp_solve.stream_ms") == pytest.approx(5 + 30)
    assert read("fleet_step.host_syncs") == pytest.approx(3.0)
    assert read("slmpc.gi_pivots_max") == pytest.approx(6.0)


def test_readers_find_nothing_where_the_record_lacks_it(record):
    record(_steps(4, linearize=False, stream=False))
    ctx = dict(stretch_periods=4)
    read = lambda name: registry.metric_reader(name)(ctx)
    for name in ("linearize.host_ms", "linearize.stream_ms", "slmpc.gi_pivots_max",
                 *STREAM):
        assert read(name) is None, name
    assert read("qp_build.host_ms") == pytest.approx(2 + 15)
    # fewer traced steps than the stretch, or an untraced run
    assert registry.metric_reader("qp_build.host_ms")(dict(stretch_periods=5)) is None
    assert registry.metric_reader("qp_build.host_ms")(dict()) is None


def test_readers_of_a_port_without_the_record(monkeypatch):
    # a port without mpc_tpu_torch.utils.trace, as the parent of this
    # metric's first commit has: the import fails, the reader gives None
    monkeypatch.setitem(sys.modules, "mpc_tpu_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["mpc_tpu_torch.utils"], "trace")
    for name in NEW:
        assert registry.metric_reader(name)(dict(stretch_periods=2)) is None, name


def test_every_new_metric_is_in_the_spec_for_the_cells_that_record_it():
    spec = registry.benchmark_spec()
    by = {m["name"]: m for m in spec["per_layer"]}
    pend = ["pendulum-sl-gi"]
    for name in NEW:
        m = by[name]
        assert m["moves"] == "lane_periods_per_s" and m["better"] == "lower"
        slmpc_only = name.startswith(("linearize.", "slmpc."))
        assert m["workloads"] == (pend if slmpc_only else ["cstr-gi", "pendulum-sl-gi",
                                                           "cstr-admm"])


@pytest.mark.parametrize("workload", ["cstr-gi", "cstr-admm", "pendulum-sl-gi"])
def test_a_small_traced_run_reports_the_spans(workload):
    trace.clear()
    result, notes, lines = small_run(workload, trace=True)
    assert result["correct"]
    got = result["metrics"]
    pend = workload == "pendulum-sl-gi"
    for name in ("estimator.host_ms", "qp_build.host_ms", "qp_solve.host_ms"):
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
    # the CPU has no stream: no stream times
    assert not any(n.endswith(".stream_ms") for n in got)
    assert ("linearize.host_ms" in got) == pend and ("slmpc.gi_pivots_max" in got) == pend
    syncs = got["fleet_step.host_syncs"]["value"]
    if workload == "cstr-gi":
        assert syncs == 0
    elif pend:
        assert syncs == 2 and got["slmpc.gi_pivots_max"]["value"] >= 1
    else:
        assert syncs >= 1 + 1 + 4       # a sweep, the loop's last test, the polish
    # the untraced run reports none of them
    trace.clear()
    result, _, _ = small_run(workload)
    assert not set(NEW) & set(result["metrics"])
