"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

A configuration is ``configs/<name>.json``, or the configuration another
one ``extends`` with the keys it sets; its ``kind`` names the module
``kinds/<kind>.py`` that builds the plants, drives the port and holds the
plain reference.  A cell is ``workloads/<name>.json``, a traffic mix
``traffic/<name>.json`` and a metric's reader ``metrics/<name>.py`` (a
function ``read(ctx)`` that returns a number, or None where it finds nothing
to read).  Adding any of them adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark_spec(root=ROOT):
    """The parsed ``BENCHMARK.json`` at the root of the checkout."""
    return load_json(Path(root) / "BENCHMARK.json")


def cell_entry(spec, name):
    """The ``workloads`` entry of BENCHMARK.json named ``name``."""
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_entry(spec, name):
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def config_file(spec, name, root=ROOT):
    """The configuration as it is run: its file, as ``BENCHMARK.json`` names
    it, over the configuration that the file ``extends`` (by its name)."""
    cfg = load_json(Path(root) / config_entry(spec, name)["file"])
    if "extends" in cfg:
        base = config_file(spec, cfg["extends"], root)
        cfg = {**base, **{k: v for k, v in cfg.items() if k != "extends"}}
    return cfg


def cell_file(name):
    return load_json(HERE / "workloads" / f"{name}.json")


def traffic_file(name):
    return load_json(HERE / "traffic" / f"{name}.json")


def kind_module(kind):
    """The module that builds and checks a configuration of this kind."""
    return importlib.import_module(f"benchmark.kinds.{kind}")


def metric_reader(name):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec, cell, trace):
    """The metrics a cell reports: its end-to-end metrics with ``trace``
    0, its per-layer metrics with ``trace`` 1.  A metric with a
    ``workloads`` list belongs to those cells; one without it to every cell
    that reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
