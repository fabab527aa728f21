"""Spans and counters in the port's fleet steps (``mpc_tpu_torch.utils.trace``).

Three fleets: the CSTR LinMPC fleet on GI and on ADMM (``BatchedLinMPC``)
and the SLMPC pendulum fleet (``make_fleet_step``), float32 as the
benchmark runs them.  On the CPU: without a profiler a span is the shared
no-op and nothing is recorded; under a CPU ``torch.profiler`` the spans of
each period nest under one ``fleet.step`` as host operations, not user
annotations; the answers and the ATen operations of a step are the same
traced and untraced; the ADMM step's host syncs are its sweeps and the
loop's last test, with the polish's four; a CSTR step takes every product
of its QP build one GEMM a controller (``grouped_products``) and copies to
the lanes only the estimator's matrices and the solve's H and A
(``lane_copy_bytes``).

The ``cuda`` tests need an NVIDIA card and skip elsewhere: the synchronising
calls of one step of each benchmark cell's fleet (PyTorch's sync debug
mode) equal the step's ``host_syncs``, and a traced step records on the card
the same device operations as an untraced one and no span.  This file
imports no JAX: on the card, ``python -m pytest --noconftest
tests/test_torch_trace.py``.
"""
import contextlib
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import mpc_tpu_torch as mt
import mpc_tpu_torch.controllers.slmpc as port_slmpc
from mpc_tpu_torch import ops
from mpc_tpu_torch.ops.admm_kernel import admm_sweep
from mpc_tpu_torch.parallel import BatchedLinMPC, random_cstr_controllers
from mpc_tpu_torch.utils import trace

torch.set_num_threads(1)
CPU = torch.device("cpu")
LINMPC_SPANS = ["estimator.correct", "qp.build", "qp.solve", "estimator.predict", "fleet.step"]
SLMPC_SPANS = ["estimator.correct", "linearize", "qp.build", "qp.solve", "estimator.predict",
               "fleet.step"]
# the ADMM polish's syncs a step: two rounds, each uploading its bound and
# inverting its KKT matrix (torch.linalg.inv checks the result on the host)
POLISH_SYNCS = 4


class Fleet:
    """A fleet and its inputs: ``period(k)`` runs period k and returns
    ``(u, n_conv)``; ``state()`` the per-lane state."""

    def __init__(self, kind, device=CPU, sweep=admm_sweep, B=12, seed=0):
        self.kind, self.device = kind, device
        g = torch.Generator().manual_seed(seed)
        if kind == "slmpc":
            self.ctrl = pendulum_slmpc(device)
            self.B = B
            self.step = self.ctrl.make_fleet_step(B)
            self.st = self.ctrl.fleet_state(B)
            self.bounds = self.ctrl.bounds()
            self.d = torch.zeros(B, 0, dtype=torch.float32, device=device)
            ym = 180.0 * torch.rand(8, B, 1, generator=g)
            ry = 180.0 * torch.ones(8, B, 1)
        else:
            qp = "active_set" if kind == "gi" else "admm"
            ctrls = random_cstr_controllers(3, seed=1, qp_solver=qp, device=device,
                                            dtype=torch.float32)
            self.fleet = BatchedLinMPC(ctrls, reps=B // 3, dtype=torch.float32, device=device,
                                       gi_slot_dtype=torch.float64, sweep=sweep)
            self.B = B
            ym = 8.0 * torch.randn(8, B, 2, generator=g)
            ry = torch.tensor([6.0, -6.0]).expand(8, B, 2)
        self.ym, self.ry = (t.to(device, torch.float32) for t in (ym, ry))

    def period(self, k):
        if self.kind == "slmpc":
            u, conv, self.st = self.step(self.st, self.ym[k], self.ry[k], self.d, self.bounds)
            return u, conv.sum()
        return self.fleet.step(self.ym[k], self.ry[k])

    def state(self):
        if self.kind == "slmpc":
            return dict(self.st)
        st = dict(self.fleet._parts[0].state)
        qs = st.pop("qp_state")
        return {**st, **({} if qs is None else qs)}


def pendulum_slmpc(device):
    """The upstream pendulum under SLMPC with hard input bounds (the
    benchmark's configuration at Hp = 10), float32, GI."""
    par = (9.8, 0.4, 1.2, 0.3)

    def f(x, u, d, p):
        return torch.stack([x[1], -p[0] / p[1] * torch.sin(x[0]) - p[2] / p[3] * x[1]
                            + u[0] / (p[3] * p[1] ** 2)])

    def h(x, d, p):
        return torch.stack([x[0] * 180 / torch.pi])
    model = mt.NonLinModel(f, h, 0.1, 1, 2, 1, p=par, solver=mt.RungeKutta(4), device=device)
    c = mt.SLMPC(model, Hp=10, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=None, sigmaQ=[0.1, 1.0],
                 sigmaR=[5.0], nint_ym=[1], sigmaQint_ym=[0.1], qp_solver="active_set",
                 dtype=torch.float32, device=device)
    return c.setconstraint(umin=[-1.5], umax=[1.5])


def spans_of(kind):
    return SLMPC_SPANS if kind == "slmpc" else LINMPC_SPANS


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


KINDS = ["gi", "admm", "slmpc"]


@pytest.fixture(autouse=True)
def _empty_record():
    trace.clear()
    yield
    trace.clear()


def test_span_without_a_profiler_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    offs = {id(trace.span(n)) for n in SLMPC_SPANS} | {id(trace.span(trace.ROOT, CPU))}
    assert offs == {id(trace._OFF)}
    with trace.span(trace.ROOT, CPU) as s:
        assert s is trace._OFF
        trace.keep_max("x", torch.ones(3))
    assert trace.steps() == [] and trace.RECORD.open is None


@pytest.mark.parametrize("kind", KINDS)
def test_untraced_periods_record_nothing_and_make_no_event(kind, monkeypatch):
    fl = Fleet(kind)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event in an untraced step")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    for k in range(3):
        fl.period(k)
    assert trace.steps() == [] and trace.RECORD.stack == []


@pytest.mark.parametrize("kind", KINDS)
def test_spans_nest_under_one_fleet_step_a_period(kind):
    fl = Fleet(kind)
    fl.period(0)
    with cpu_profile() as prof:
        for k in range(1, 4):
            fl.period(k)
    names = set(spans_of(kind))
    evs = [e for e in prof.events() if e.name in names]
    assert {e.name for e in evs} == names
    assert not any(e.is_user_annotation for e in evs)
    roots = [e for e in evs if e.name == trace.ROOT]
    assert len(roots) == 3
    for e in evs:
        if e.name != trace.ROOT:
            inside = [r for r in roots if r.time_range.start <= e.time_range.start
                      and e.time_range.end <= r.time_range.end]
            assert len(inside) == 1, e.name
    steps = trace.steps()
    assert len(steps) == 3
    assert [s["step"] for s in steps] == sorted({s["step"] for s in steps})
    for s in steps:
        assert [p["name"] for p in s["spans"]] == spans_of(kind)
        parents = {p["name"]: p["parent"] for p in s["spans"]}
        assert parents.pop(trace.ROOT) is None
        assert set(parents.values()) == {trace.ROOT}
        host = {p["name"]: p["host_ms"] for p in s["spans"]}
        assert all(v > 0 for v in host.values())
        assert sum(v for n, v in host.items() if n != trace.ROOT) <= host[trace.ROOT]
        assert all(p["stream_ms"] is None for p in s["spans"])


@pytest.mark.parametrize("kind", KINDS)
def test_answers_are_the_same_bits_traced_and_untraced(kind):
    plain, traced = Fleet(kind), Fleet(kind)
    for k in range(5):
        u0, n0 = plain.period(k)
        with cpu_profile():
            u1, n1 = traced.period(k)
        assert torch.equal(u0, u1) and torch.equal(n0, n1)
        s0, s1 = plain.state(), traced.state()
        assert s0.keys() == s1.keys()
        for key in s0:
            assert torch.equal(s0[key], s1[key]), key
    assert len(trace.steps()) == 5


class _Ops(TorchDispatchMode):
    """The ATen operations dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", KINDS)
def test_a_traced_step_dispatches_the_untraced_steps_operations(kind):
    plain, traced = Fleet(kind), Fleet(kind)
    for k in range(2):
        plain.period(k)
        traced.period(k)
    with _Ops() as a:
        plain.period(2)
    with cpu_profile(), _Ops() as b:
        traced.period(2)
    assert a.ops == b.ops and a.ops


def test_admm_host_syncs_are_its_sweeps_and_the_loops_last_test():
    calls = []

    def sweep(*args):
        calls.append(1)
        return admm_sweep(*args)
    fl = Fleet("admm", sweep=sweep)
    per = []
    for k in range(6):
        n0, c0 = trace.COUNTS["host_syncs"], len(calls)
        if k < 3:
            fl.period(k)
        else:
            with cpu_profile():
                fl.period(k)
        per.append((trace.COUNTS["host_syncs"] - n0, len(calls) - c0))
    for syncs, sweeps in per:
        assert sweeps >= 1
        assert syncs == sweeps + 1 + POLISH_SYNCS
    assert [s["host_syncs"] for s in trace.steps()] == [s for s, _ in per[3:]]


@pytest.mark.parametrize("kind, syncs", [("gi", 0), ("slmpc", 2)])
def test_host_syncs_of_the_gi_steps(kind, syncs):
    """The CSTR GI step reads nothing on the host; the SLMPC step uploads
    its measured-output index twice (indexing by a host list)."""
    fl = Fleet(kind)
    with cpu_profile():
        for k in range(3):
            fl.period(k)
    assert [s["host_syncs"] for s in trace.steps()] == [syncs] * 3


def test_slmpc_keeps_its_gi_pivots_in_traced_steps_only(monkeypatch):
    seen = []
    solve = port_slmpc.solve_qp_active

    def spy(*a, **k):
        sol = solve(*a, **k)
        seen.append(int(sol.iters.max()))
        return sol
    monkeypatch.setattr(port_slmpc, "solve_qp_active", spy)
    fl = Fleet("slmpc")
    fl.period(0)
    with cpu_profile():
        for k in range(1, 5):
            fl.period(k)
    fl.period(5)
    got = [s["items"]["gi_pivots_max"] for s in trace.steps()]
    assert got == seen[1:5] and max(got) > 0


# the products of the CSTR fleet's build (nd = 0, no custom constraints,
# SingleShooting): Ks, Ps, K, V, Tu, M_Hp, E_t, L_Hp, Pu_t, M_Hpᵀ, L_Hpᵀ, kx,
# vx, KS, VS (the last two of zero rows)
CSTR_BUILD_PRODUCTS = 15


@pytest.mark.parametrize("kind", ["gi", "admm"])
def test_counters_of_the_grouped_build_and_the_remaining_copies(kind):
    """A traced CSTR step takes every product of its build on the grouped
    path and copies only the estimator's matrices and the solve's H and A
    to the lanes (ADMM twice: its setup and its z and objective products);
    an untraced step moves the counters alike and records nothing."""
    fl = Fleet(kind)
    p, ep, B = fl.fleet.params, fl.fleet.eparams, fl.B
    per_lane = lambda *ts: sum(t[0].numel() for t in ts)
    est = per_lane(*(ep[k] for k in ("Cm_hat", "K_hat", "A_hat", "Bu_hat")))
    qp = per_lane(p["H"], p["A_stack"]) * (1 if kind == "gi" else 2)
    want = dict(grouped_products=CSTR_BUILD_PRODUCTS, lane_copy_bytes=B * 4 * (est + qp))
    untraced = []
    for k in range(4):
        n0 = dict(trace.COUNTS)
        with cpu_profile() if k >= 2 else contextlib.nullcontext():
            fl.period(k)
        if k < 2:
            untraced.append({c: trace.COUNTS[c] - n0[c] for c in want})
            assert trace.steps() == []
    assert untraced == [want] * 2
    assert [{c: s[c] for c in want} for s in trace.steps()] == [want] * 2


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


SMALL_CELLS = {"cstr-gi": {"reps": 16}, "cstr-admm": {"reps": 16},
               "pendulum-sl-gi": {"lanes": 4096, "check_lanes": 64}}


def _cell(name, dev):
    """A benchmark cell's fleet and world at a small B."""
    from benchmark import registry
    spec = registry.benchmark_spec()
    entry = registry.cell_entry(spec, name)
    cfg = registry.config_file(spec, entry["config"])
    cell = {**registry.cell_file(name), **SMALL_CELLS[name]}
    kind = registry.kind_module(cfg["kind"])
    return kind.Cell(cfg, cell, registry.traffic_file(entry["traffic"]), 2147490001, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL_CELLS))
def test_sync_census_equals_host_syncs(name):
    dev = _card()
    cell = _cell(name, dev)
    for k in range(8):
        ym, ry, d = cell.measure(k)
        torch.cuda.synchronize()
        traced = k == 7
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()):
            n0, launches = trace.COUNTS["host_syncs"], ops.LAUNCHES["admm_sweep"]
            if k >= 4:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    u, n = cell.step(ym, ry, d)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = trace.COUNTS["host_syncs"] - n0
        census = sum("synchronizing" in str(x.message) for x in w)
        if k >= 4:
            assert syncs == census, k
        if name == "cstr-admm" and k >= 4:
            # the loop's test once a sweep launch and once more, the polish's
            assert syncs == ops.LAUNCHES["admm_sweep"] - launches + 1 + POLISH_SYNCS
        cell.advance(u)
    assert trace.steps()[-1]["host_syncs"] == census


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL_CELLS))
def test_traced_step_adds_no_device_record(name, monkeypatch):
    dev = _card()
    cell = _cell(name, dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    names = []
    for k in range(6):
        ym, ry, d = cell.measure(k)
        if k >= 4:
            with monkeypatch.context() as m:
                if k == 4:          # the spans off: the program without them
                    m.setattr(trace, "_profiling", lambda: False)
                with profile(activities=acts) as prof:
                    u, n = cell.step(ym, ry, d)
                    torch.cuda.synchronize()
            names.append({e.name for e in prof.events() if e.device_type == cuda})
        else:
            u, n = cell.step(ym, ry, d)
        cell.advance(u)
    assert names[0] == names[1]
    assert not names[1] & set(SLMPC_SPANS)
    step = trace.steps()[-1]
    assert all(p["stream_ms"] is not None and p["stream_ms"] > 0 for p in step["spans"])
