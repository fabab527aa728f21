"""Nothing the benchmark's entry loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``mpc_tpu`` (``mpc_tpu_torch`` is another name)."""
import importlib.util
import json
import subprocess
import sys

import pytest

from benchmark import harness, registry

from .helpers import small_run

PROBE = r"""
import json, sys, time, warnings
sys.path.insert(0, sys.argv[1])
import torch
from benchmark import harness, registry
from benchmark.tests.helpers import small_run
for wl in [w["name"] for w in registry.benchmark_spec()["workloads"]]:
    small_run(wl, seconds=0.2, trace=True)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_bench_entry_loads_no_jax():
    r = subprocess.run([sys.executable, "-c", PROBE, str(registry.ROOT)], capture_output=True,
                       text=True, timeout=600, cwd=registry.ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "mpc_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_bench_forbidden_names_are_compared_whole():
    names = {m.split(".")[0] for m in ("mpc_tpu_torch.ops", "jaxtyping", "mpc_tpu2")}
    assert not names & set(harness.FORBIDDEN)
    assert {"jax"} & {m.split(".")[0] for m in ("jax.numpy",)}


def test_bench_a_reader_that_loads_jax_stops_the_result(tmp_path, monkeypatch, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text('"""A stand-in for jax."""\n')
    stub = tmp_path / "stub.py"
    stub.write_text("import jax  # noqa: F401\n\n\ndef read(ctx):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setitem(sys.modules, "jax", None)      # undone last: jax is unloaded again
    monkeypatch.delitem(sys.modules, "jax")
    real = registry.metric_reader

    def reader(name):
        if name != "setup_s":
            return real(name)
        spec = importlib.util.spec_from_file_location("benchmark.metrics.stub", stub)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    monkeypatch.setattr(registry, "metric_reader", reader)
    result, notes, lines = small_run("cstr-gi", seconds=0.2)
    assert "jax" in sys.modules
    with pytest.raises(RuntimeError, match="jax"):
        harness.emit(result, notes, lines)
    assert capsys.readouterr().out == ""
