"""The registry finds every configuration, cell, traffic mix and metric
of BENCHMARK.json by its name, and picks each cell's metrics."""
import json

import pytest

from benchmark import registry

SPEC = registry.benchmark_spec()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_bench_every_cell_resolves_to_its_files(cell):
    entry = registry.cell_entry(SPEC, cell)
    cfg = registry.config_file(SPEC, entry["config"])
    assert (registry.HERE / "kinds" / f"{cfg['kind']}.py").exists()
    registry.kind_module(cfg["kind"]).Cell
    assert "limits" in registry.cell_file(cell)
    assert "phases" in registry.traffic_file(entry["traffic"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_bench_every_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric))


def test_bench_configs_files_are_under_paths_and_distinct():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in SPEC["paths"])
        json.loads((registry.ROOT / f).read_text())


def test_bench_cell_metrics_follow_workloads_and_moves():
    spec = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
            "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "b"},
                          {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in registry.cell_metrics(spec, "x", False)] == ["a", "b"]
    assert [m["name"] for m in registry.cell_metrics(spec, "y", False)] == ["a"]
    assert [m["name"] for m in registry.cell_metrics(spec, "x", True)] == ["p", "q"]
    assert [m["name"] for m in registry.cell_metrics(spec, "y", True)] == ["p", "r"]


def test_bench_a_new_metric_file_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new.metric.py").write_text("def read(ctx):\n    return 7\n")
    monkeypatch.setattr(registry, "HERE", tmp_path)
    assert registry.metric_reader("new.metric")({}) == 7
