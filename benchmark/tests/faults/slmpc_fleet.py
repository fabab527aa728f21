"""Faults planted in an SLMPC fleet cell, under its fleet step."""
import functools


def state_unchanged(cell):
    cell.fleet_step = functools.partial(lambda inner, st, *a: (*inner(st, *a)[:2], st),
                                        cell.fleet_step)


def altered_answer(cell, monkeypatch):
    """The QP solution, on every third lane."""
    def alter(sol):
        x = sol.x.clone()
        x[::3, 0] += 1.0
        return sol._replace(x=x)
    import mpc_tpu_torch.controllers.slmpc as slmpc
    solve = slmpc.solve_qp_active
    monkeypatch.setattr(slmpc, "solve_qp_active", lambda *a, **k: alter(solve(*a, **k)))
