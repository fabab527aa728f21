"""Faults planted in a LinMPC fleet cell, under its ``BatchedLinMPC``."""


def state_unchanged(cell):
    step = cell.fleet.step

    def frozen(*a, **k):
        before = cell.fleet.state
        out = step(*a, **k)
        cell.fleet.state = before
        return out
    cell.fleet.step = frozen


def altered_answer(cell, monkeypatch):
    """The step's u, on every third lane."""
    raw = cell.fleet._step_raw

    def wrong(*a, **k):
        u, *rest = raw(*a, **k)
        u = u.clone()
        u[::3, 0] += 1.0
        return (u, *rest)
    cell.fleet._step_raw = wrong
