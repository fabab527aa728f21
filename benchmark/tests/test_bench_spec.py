"""BENCHMARK.json keeps to the limits its checker holds it to: names,
units, lengths, keys, bounds, and the files it names."""
import importlib
import re

import pytest

from benchmark import registry

from .helpers import small

SPEC = registry.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_bench_spec_top_level_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    assert all(line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert (registry.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_bench_spec_entries():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
    cfgs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in cfgs
        assert w["chips"] == 1 and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in SPEC["workloads"]} == cfgs
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))


def test_bench_every_cell_reports_setup_another_e2e_metric_and_a_layer_metric():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in registry.cell_metrics(SPEC, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.cell_metrics(SPEC, w["name"], True)


def test_bench_every_cell_brings_its_test_size_and_every_kind_its_faults():
    """Beside its configuration, cell, traffic, kind module and metric
    readers, a new cell brings ``tests/small/<cell>.json`` and, where its
    kind is new, ``tests/faults/<kind>.py``."""
    tests = registry.HERE / "tests"
    kinds = sorted({registry.config_file(SPEC, c["name"])["kind"] for c in SPEC["configs"]})
    need = ([tests / "small" / f"{w['name']}.json" for w in SPEC["workloads"]]
            + [tests / "faults" / f"{k}.py" for k in kinds])
    missing = [str(p.relative_to(registry.ROOT)) for p in need if not p.exists()]
    assert not missing, f"add {missing}"
    for w in SPEC["workloads"]:
        cell, cfg = small(w["name"])
        assert "counted_periods" in cell and (cfg is None or isinstance(cfg, dict))
    for k in kinds:
        faults = importlib.import_module(f"benchmark.tests.faults.{k}")
        assert callable(faults.state_unchanged) and callable(faults.altered_answer)


def test_bench_a_cell_without_a_test_size_names_the_missing_file():
    with pytest.raises(FileNotFoundError, match=r"benchmark/tests/small/no-such-cell\.json"):
        small("no-such-cell")
