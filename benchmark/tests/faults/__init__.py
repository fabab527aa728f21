"""Faults planted under a run, one module per kind of configuration
(``kinds/<kind>.py``): ``state_unchanged(cell)`` makes the step return its
state as it found it, and ``altered_answer(cell, monkeypatch)`` alters an
answer where the step produces it.  ``test_bench_control.py`` picks the
module by the cell's configuration ``kind``."""
