"""The result line and the check lines of a run, on the CPU at a test size,
and the entry's refusals."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, registry

from .helpers import lanes, small, small_run

SPEC = registry.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_bench_result_line_schema(workload, trace, capsys):
    result, notes, lines = small_run(workload, trace=trace)
    harness.emit(result, notes, lines)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True
    assert last["attempted"] == lanes(notes) * small(workload)[0]["counted_periods"]
    assert 0 <= last["failed"] <= last["attempted"]
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"]: m for m in registry.cell_metrics(SPEC, workload, trace)}
    for name, m in last["metrics"].items():
        assert name in names and m["unit"] == names[name]["unit"]
        assert isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(last["metrics"]) == set(names)
    tail = err.strip().splitlines()[-len(last["checks"]):]
    for line, (name, c) in zip(tail, last["checks"].items()):
        assert line.startswith(f"check {name}: ") and f"(limit {c['limit']!r})" in line


def test_bench_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, str(registry.HERE / "run.py"), "--workload", "cstr-gi",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=registry.ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_bench_run_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cstr-gi",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_bench_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cstr-gi",
                        "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=registry.ROOT, timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
