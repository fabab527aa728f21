"""The CUDA kernels on the card: kernel ≡ plain version, and the fleet path.

Needs an NVIDIA GPU; every test skips where ``torch.cuda.is_available()``
is False.  This file imports no JAX, so it also runs on a machine without
it: ``python -m pytest --noconftest tests/test_torch_cuda.py`` (the repo's
conftest imports jax for the reference tests).
"""
import functools

import numpy as np
import pytest
import torch

from mpc_tpu_torch.ops import admm_kernel
from mpc_tpu_torch.ops.admm_kernel import (LAUNCHES, admm_sweep,
                                           admm_sweep_reference)
from mpc_tpu_torch.ops.gi_kernel import gi_solve, gi_solve_reference
from mpc_tpu_torch.ops.qp import solve_qp
from mpc_tpu_torch.ops.qp_active import build_gi_cache, solve_qp_active
from mpc_tpu_torch.parallel import BatchedLinMPC, random_cstr_controllers

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


LAYOUTS = {
    # lane → controller maps the port produces
    "tiled": lambda: torch.arange(32, dtype=torch.int32) % 8,
    "shared": lambda: torch.zeros(19, dtype=torch.int32),
    "n_d=B": lambda: torch.arange(24, dtype=torch.int32),
    "B=1": lambda: torch.zeros(1, dtype=torch.int32),
    "ragged": lambda: torch.tensor([0] * 3 + [1] * 21 + [2] * 9 + [3], dtype=torch.int32),
}


def _problem(dev, dtype, n=5, m=101, lane_ctrl=None, n_lad=3, seed=0):
    """Sweep inputs on a per-controller ρ ladder of ``n_lad`` rungs, a rung
    per lane, a warm start (x, z and y as a previous block leaves them, y
    nonzero) and a fifth of the lanes frozen."""
    g = torch.Generator().manual_seed(seed)
    lane_ctrl = LAYOUTS["tiled"]() if lane_ctrl is None else lane_ctrl
    B, n_d = lane_ctrl.numel(), int(lane_ctrl.max()) + 1
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    A = r(n_d, m, n)
    H = r(n_d, n, n)
    rhovs = (0.1 * 2.0 ** (torch.arange(n_lad, dtype=torch.float64) - 1))[None, :, None] \
        * torch.ones(n_d, 1, m, dtype=torch.float64)
    M = (H @ H.transpose(1, 2) + n * torch.eye(n, dtype=torch.float64))[:, None] \
        + A.transpose(1, 2)[:, None] @ (rhovs[..., None] * A[:, None])
    Al = A[lane_ctrl.long()]
    x = r(B, n) * 0.1
    Ax = (Al @ x[..., None])[..., 0]
    args = dict(Minvs=torch.linalg.inv(M), A=A, lane_ctrl=lane_ctrl,
                rung=torch.randint(0, n_lad, (B,), generator=g, dtype=torch.int32),
                q=r(B, n), l=Ax - 0.2, u=Ax + 0.6, rhovs=rhovs, x=x,
                z=Ax, y=r(B, m) * 0.5,
                active=torch.arange(B) % 5 != 3)
    return {k: (v.to(dev, dtype) if v.is_floating_point() else v.to(dev)).contiguous()
            for k, v in args.items()}


SWEEP = ("Minvs", "A", "lane_ctrl", "rung", "q", "l", "u", "rhovs", "x", "z",
         "y", "active")


def _sweep_check(dev, dtype, tol, rel=True, layout=None, **kw):
    """Kernel (in ``layout``, None: the wrapper's choice) and plain sweep,
    40 sweeps: x, z and y each to tol·(1 + its max|plain|) (``rel``) or to
    tol."""
    a = _problem(dev, dtype, **kw)
    b = {k: v.clone() for k, v in a.items()}
    n0 = LAUNCHES["admm_sweep"]
    admm_sweep(*(a[k] for k in SWEEP), 40, 1e-6, 1.6, _layout=layout)
    admm_sweep_reference(*(b[k] for k in SWEEP), 40, 1e-6, 1.6)
    torch.cuda.synchronize()
    assert LAUNCHES["admm_sweep"] == n0 + 1
    for k in ("x", "z", "y"):
        err = (a[k] - b[k]).abs().max().item()
        assert err < tol * ((1.0 + b[k].abs().max().item()) if rel else 1.0), (k, err)
    off, start = ~a["active"], _problem(dev, dtype, **kw)
    for k in ("x", "z", "y"):
        assert torch.equal(a[k][off], start[k][off]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.float64, 1e-10)])
def test_kernel_matches_plain_on_card(dtype, tol):
    _sweep_check(_card(), dtype, tol, rel=False)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,warp_lanes", [(5, 101, 0), (5, 101, 10**9), (33, 150, 0)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_kernel_layouts_match_plain_on_card(layout, n, m, warp_lanes, monkeypatch):
    """Both variants (a warp a lane, forced for n ≤ 32 by
    ``WARP_LANES_PER_SM`` = 0; the lanes in step, forced by a huge one and
    always for n > 32) on every lane layout: f32 to 1e-4·(1 + max|plain|),
    f64 to 1e-10, frozen lanes bit-unchanged."""
    dev = _card()
    monkeypatch.setattr(admm_kernel, "WARP_LANES_PER_SM", warp_lanes)
    lc = LAYOUTS[layout]()
    _sweep_check(dev, torch.float32, 1e-4, n=n, m=m, lane_ctrl=lc)
    _sweep_check(dev, torch.float64, 1e-10, rel=False, n=n, m=m, lane_ctrl=lc)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32, 2112])
def test_kernel_wider_than_the_block_matches_plain_on_card(B):
    """n=300 > 256 threads of the lanes-in-step block (one row class of
    Aᵀv, several columns a thread), m=20, one controller shared by B lanes:
    1, 32 and 2112 lanes (a lane a block, and two a block on a card of
    132 SMs); f32 to 1e-4·(1 + max|plain|), f64 to 1e-10, frozen lanes
    bit-unchanged."""
    dev = _card()
    lc = torch.zeros(B, dtype=torch.int32)
    _sweep_check(dev, torch.float32, 1e-4, n=300, m=20, lane_ctrl=lc)
    _sweep_check(dev, torch.float64, 1e-10, rel=False, n=300, m=20, lane_ctrl=lc)


@pytest.mark.cuda
def test_fleet_step_kernel_path_matches_plain_path_on_card():
    dev = _card()
    ctrls = random_cstr_controllers(8, seed=0)
    fleets = [BatchedLinMPC(ctrls, reps=4, device=dev, dtype=torch.float32,
                            sweep=sw)
              for sw in (admm_sweep, admm_sweep_reference)]
    rng = np.random.default_rng(0)
    for k in range(3):
        ym = rng.normal(size=(32, 2)) * 0.5
        ry = rng.normal(size=(32, 2))
        (u_k, nc_k), (u_p, nc_p) = (f.step(ym, ry) for f in fleets)
        assert torch.isfinite(u_k).all()
        assert (u_k - u_p).abs().max().item() < 1e-3
        assert abs(int(nc_k) - int(nc_p)) <= 1


def _gi_problem(dev, dtype, n=6, m=24, B=256, seed=0, lane_ctrl=None):
    """Random QPs of the tests/test_qp.py kind, one per lane (or one per
    controller of ``lane_ctrl``, bounds per lane), with warm duals (some
    junk) so the warm loop inserts and drops."""
    rng = np.random.default_rng(seed)
    lc = np.arange(B) if lane_ctrl is None else lane_ctrl.cpu().numpy()
    n_d = int(lc.max()) + 1
    H = rng.normal(size=(n_d, n, n))
    P = H @ H.transpose(0, 2, 1) + n * np.eye(n)
    A = rng.normal(size=(n_d, m, n))
    Ax = np.einsum("bmn,bn->bm", A[lc], rng.normal(size=(B, n)) * 0.1)
    margin = rng.uniform(0.05, 1.0, size=(B, m))
    l = np.where(rng.random((B, m)) < 0.3, -1e20, Ax - margin)
    Pinv = np.stack([build_gi_cache(p, None)["gic_Pinv"] for p in P])
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    return dict(P=t(P), q=t(rng.normal(size=(B, n))), A=t(A), l=t(l),
                u=t(Ax + margin), y0=t(rng.normal(size=(B, m)) * (rng.random((B, 1)) < 0.5)),
                cache=dict(gic_Pinv=t(Pinv)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,slots,cap", [(torch.float64, None, None),
                                             (torch.float32, torch.float32, 3)])
def test_gi_kernel_matches_plain_on_card(dtype, slots, cap):
    dev = _card()
    a = _gi_problem(dev, dtype)
    n0 = LAUNCHES["gi_solve"]
    out = {}
    for fn in (gi_solve, gi_solve_reference):
        out[fn] = solve_qp_active(a["P"], a["q"], a["A"], a["l"], a["u"], a["y0"],
                                  cache=a["cache"], max_active=cap,
                                  slot_dtype=slots, solve=fn)
    torch.cuda.synchronize()
    assert LAUNCHES["gi_solve"] == n0 + 1
    k, p = out[gi_solve], out[gi_solve_reference]
    assert torch.equal(k.converged, p.converged)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    x_scale = 1.0 + p.x.abs().max().item()
    if dtype == torch.float64:
        assert torch.equal(k.iters, p.iters)
        assert torch.equal(k.gi_state["gis_idx"], p.gi_state["gis_idx"])
    both = k.converged & p.converged
    assert (k.x - p.x)[both].abs().max().item() < tol * x_scale


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gi_kernel_layouts_match_plain_on_card(layout):
    """The GI kernel on every lane layout (lanes of one controller share a
    block, one warp each) against the plain solve in float64: equal flags,
    iterations and active sets, x to 1e-12·(1 + max|x|)."""
    dev = _card()
    lc = LAYOUTS[layout]().to(dev)
    a = _gi_problem(dev, torch.float64, B=lc.numel(), seed=5, lane_ctrl=lc)
    k, p = (solve_qp_active(a["P"], a["q"], a["A"], a["l"], a["u"], a["y0"],
                            lane_ctrl=lc, cache=a["cache"], max_active=3, solve=fn)
            for fn in (gi_solve, gi_solve_reference))
    assert torch.equal(k.converged, p.converged)
    assert torch.equal(k.iters, p.iters)
    assert torch.equal(k.gi_state["gis_idx"], p.gi_state["gis_idx"])
    assert (k.x - p.x).abs().max().item() < 1e-12 * (1.0 + p.x.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("qp_solver,kernel", [("admm", "admm_sweep"),
                                              ("active_set", "gi_solve")])
def test_readme_sim_on_card_matches_cpu(qp_solver, kernel):
    """The README flow (README.md:9-21) in float64 with ``device="cuda"``
    against the same ``sim`` on the CPU (the plain versions): u and y to
    1e-6, and every period's QP through the kernel."""
    import mpc_tpu_torch as mt
    dev = _card()
    G = mt.tf_matrix([[mt.tf(2, [10, 1]) * mt.delay(20)], [mt.tf(10, [4, 1])]])
    res = {}
    for d in (dev, "cpu"):
        ctrl = mt.LinMPC(mt.LinModel(G, 1.0), Mwt=[1, 0], Nwt=[0.1],
                         qp_solver=qp_solver, device=d)
        ctrl.setconstraint(ymax=[np.inf, 35])
        n0 = LAUNCHES[kernel]
        res[d] = mt.sim(ctrl, 40, [5, 0])
        if d is dev:
            assert LAUNCHES[kernel] >= n0 + 40
    for k in ("U_data", "Y_data"):
        assert np.max(np.abs(getattr(res[dev], k) - getattr(res["cpu"], k))) < 1e-6, k


@pytest.mark.cuda
@pytest.mark.parametrize("solver,n,m", [("admm", 5, 12), ("gi", 6, 24),
                                        ("gi", 12, 30)])
def test_uncached_batch_kernel_matches_plain_on_card(solver, n, m):
    """Uncached solves with per-lane P and A (each lane its own controller):
    ``solve_qp_batch`` with the ADMM kernel against the plain sweep, and
    ``solve_qp_active`` without a cache (Gauss–Jordan at n ≤ 8, Cholesky
    above) with the GI kernel against the plain solve, on the card in
    float64.  x to 1e-7·(1 + max|x|) for ADMM and 1e-9·(1 + max|x|) for GI,
    equal iterations and flags."""
    from mpc_tpu_torch.ops.qp import solve_qp_batch
    dev = _card()
    a = _gi_problem(dev, torch.float64, n=n, m=m, B=512, seed=3)
    prob = [a[k] for k in ("P", "q", "A", "l", "u")]
    if solver == "admm":
        k, p = (solve_qp_batch(*prob, sweep=sw) for sw in (admm_sweep, admm_sweep_reference))
        tol = 1e-7
    else:
        k, p = (solve_qp_active(*prob, a["y0"], solve=fn)
                for fn in (gi_solve, gi_solve_reference))
        tol = 1e-9
    assert bool(p.converged.all())
    assert torch.equal(k.converged, p.converged)
    assert torch.equal(k.iters, p.iters)
    assert (k.x - p.x).abs().max().item() < tol * (1.0 + p.x.abs().max().item())


def _slmpc_fleet(dev, qp_solver, B=256, periods=6):
    """bench.py's SLMPC (pendulum, Hp=15, Hc=2; QP n=3, m=65 with per-lane
    P and A) as a float32 fleet of B lanes, stepped ``periods`` periods from
    rest with its true pendulums; returns the controller, the state and the
    next period's inputs."""
    import mpc_tpu_torch as mt
    from torch.func import vmap

    def f(x, u, d, par):
        return torch.stack([x[1], -24.5 * torch.sin(x[0]) - 4.0 * x[1] + u[0] / 0.048])
    model = mt.NonLinModel(f, lambda x, d, par: torch.stack([x[0] * 180 / torch.pi]),
                           0.1, 1, 2, 1, device=dev)
    c = mt.SLMPC(model, Hp=15, Hc=2, Mwt=[0.5], Nwt=[2.5], sigmaQ=[0.1, 1.0],
                 sigmaR=[5.0], sigmaQint_ym=[0.1], qp_solver=qp_solver,
                 dtype=torch.float32, device=dev)
    c.setconstraint(umin=[-1.5], umax=[1.5])
    step = c.make_fleet_step(B)
    st, d = c.fleet_state(B), torch.zeros(B, 0, device=dev)
    plant = vmap(lambda x, u: model._fd(x, u, d[0], None))
    x = torch.zeros(B, 2, device=dev)
    ry = torch.full((B, 1), 180.0, device=dev)
    for _ in range(periods):
        u, _, st = step(st, x[:, :1] * 180 / np.pi, ry, d, c.bounds())
        x = plant(x, u)
    return c, st, (x[:, :1] * 180 / np.pi, ry, d, c.bounds())


@pytest.mark.cuda
@pytest.mark.parametrize("qp_solver,kernel", [("active_set", "gi_solve"),
                                              ("admm", "admm_sweep")])
def test_slmpc_fleet_kernel_matches_plain_on_card(qp_solver, kernel, monkeypatch):
    """The SLMPC fleet's period on the card with the kernel and with its
    plain version (passed to the controller module's QP call) from the same
    state: every lane's u to 1e-4, the converged flags equal on all but 4
    lanes (a near-tie in the float32 scan may order GI's pivots otherwise),
    the kernel launched (GI once a period)."""
    from mpc_tpu_torch.controllers import slmpc as module
    dev = _card()
    c, st, args = _slmpc_fleet(dev, qp_solver)
    step = c.make_fleet_step(256)
    n0 = LAUNCHES[kernel]
    out = []
    for fn in ((gi_solve, gi_solve_reference) if kernel == "gi_solve"
               else (admm_sweep, admm_sweep_reference)):
        if kernel == "gi_solve":
            monkeypatch.setattr(module, "solve_qp_active",
                                functools.partial(solve_qp_active, solve=fn))
        else:
            monkeypatch.setattr(module, "solve_qp", functools.partial(solve_qp, sweep=fn))
        out.append(step(dict(st), *args))
    torch.cuda.synchronize()
    n = LAUNCHES[kernel] - n0
    (u_k, c_k, _), (u_p, c_p, _) = out
    assert n == 1 if kernel == "gi_solve" else n > 0
    assert torch.isfinite(u_k).all()
    assert (u_k - u_p).abs().max().item() < 1e-4
    assert int((c_k != c_p).sum()) <= 4


def _nonlin_fleet(dev, qp_solver, B=256, dtype=torch.float32, Hp=15):
    """bench.py's NonLinMPC fleet (the pendulum, MultipleShooting, the KKT
    exit, the UKF at α = 0.5) on ``dev``, B lanes from rest."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch.parallel import BatchedNonLinMPC

    def f(x, u, d, par):
        g, L, K, m = par
        return torch.stack([x[1], -g / L * torch.sin(x[0]) - K / m * x[1]
                            + u[0] / (m * L ** 2)])
    h = lambda x, d, par: torch.stack([x[0] * 180 / torch.pi])
    model = mt.NonLinModel(f, h, 0.1, 1, 2, 1, p=(9.8, 0.4, 1.2, 0.3), device=dev)
    est = mt.UnscentedKalmanFilter(model, sigmaQ=[0.1, 1.0], sigmaR=[5.0], nint_ym=[1],
                                   sigmaQint_ym=[0.1], alpha=0.5, device=dev)
    c = mt.NonLinMPC(est, Hp=Hp, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf, sqp_iters=15,
                     qp_solver=qp_solver, transcription=mt.MultipleShooting(),
                     kkt_tol=1e-3, kkt_feas_tol=1e-4, device=dev)
    c.setconstraint(umin=[-1.5], umax=[1.5])
    return BatchedNonLinMPC(c, B, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("qp_solver,kernel", [("active_set", "gi_solve"),
                                              ("admm", "admm_sweep")])
def test_nonlin_fleet_kernel_matches_plain_on_card(qp_solver, kernel, monkeypatch):
    """Two periods of the NonLinMPC fleet (n = 2, m = 72 reduced QPs) on the
    card with the kernel and with its plain version from the same state:
    every lane's u to 1e-4 and the kernel launched."""
    from mpc_tpu_torch.controllers import nonlinmpc as module
    dev = _card()
    fl = _nonlin_fleet(dev, qp_solver)
    st0 = fl.state
    ym = torch.zeros(fl.B, 1, device=dev)
    ry = torch.full((fl.B, 1), 180.0, device=dev)
    n0 = LAUNCHES[kernel]
    out = []
    for fn in ((gi_solve, gi_solve_reference) if kernel == "gi_solve"
               else (admm_sweep, admm_sweep_reference)):
        if kernel == "gi_solve":
            monkeypatch.setattr(module, "solve_qp_active",
                                functools.partial(solve_qp_active, solve=fn))
        else:
            monkeypatch.setattr(module, "solve_qp", functools.partial(solve_qp, sweep=fn))
        fl.state = st0
        for _ in range(2):
            u, _ = fl.step(ym, ry)
        out.append(u)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] > n0
    assert torch.isfinite(out[0]).all()
    assert (out[0] - out[1]).abs().max().item() < 1e-4


@pytest.mark.cuda
def test_nonlin_fleet_on_card_matches_cpu():
    """A float64 B=8 NonLinMPC fleet (GI) on the card and on the CPU, 4
    periods: u within 1e-6·(1 + max|u|) (see chip_smoke.py's small fleets)."""
    dev = _card()
    fleets = [_nonlin_fleet(d, "active_set", B=8, dtype=torch.float64, Hp=8)
              for d in (dev, torch.device("cpu"))]
    rng = np.random.default_rng(0)
    for _ in range(4):
        ym = torch.tensor(rng.normal(size=(8, 1)) * 5.0)
        ry = torch.full((8, 1), 90.0, dtype=torch.float64)
        u = [f.step(ym.to(f.device), ry.to(f.device))[0].cpu() for f in fleets]
        assert (u[0] - u[1]).abs().max().item() <= 1e-6 * (1 + u[1].abs().max().item())


def _mhe(dev, He=4, bound=0.5, **kw):
    import mpc_tpu_torch as mt
    e = mt.MovingHorizonEstimator(mt.LinModel(mt.tf(3, [10, 1]), 1.0), He=He, device=dev, **kw)
    return e.setconstraint(xhatmin=[-bound, -bound], xhatmax=[bound, bound])


@pytest.mark.cuda
@pytest.mark.parametrize("nan", [False, True])
def test_mhe_fleet_kernel_matches_plain_on_card(nan):
    """A float32 BatchedMHE (B = 64) on the card, 8 periods from the same
    state with the GI kernel and its plain version, on the fast path and
    through a dropout (the per-lane NaN variant): x̂ to 1e-4·(1 + max|x̂|)
    and the kernel launched."""
    from mpc_tpu_torch.parallel import BatchedMHE
    dev = _card()
    out = []
    n0 = LAUNCHES["gi_solve"]
    for fn in (gi_solve, gi_solve_reference):
        fl = BatchedMHE(_mhe(dev), 64, dtype=torch.float32, gi_max_active=4)
        fl.gi = fn
        rng = np.random.default_rng(0)
        u = None
        for k in range(8):
            ym = rng.normal(size=(64, 1))
            if nan and k == 5:
                ym[::7, 0] = np.nan
            x = fl.step(ym, u)
            u = rng.normal(size=(64, 1)) * 0.2
        out.append(x)
    torch.cuda.synchronize()
    assert LAUNCHES["gi_solve"] > n0
    assert torch.isfinite(out[0]).all()
    assert (out[0] - out[1]).abs().max().item() <= 1e-4 * (1 + out[1].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["auto", "general"])
def test_mhe_fleet_on_card_matches_cpu(solver):
    """A float64 BatchedMHE (B = 8) on the card and on the CPU, 8 periods
    with a dropout: x̂ within 1e-9 (GI fast path) or 1e-8 (the general
    solver, ADMM)·(1 + max|x̂|)."""
    from mpc_tpu_torch.parallel import BatchedMHE
    dev = _card()
    fleets = [BatchedMHE(_mhe(d), 8, solver=solver) for d in (dev, torch.device("cpu"))]
    bar = 1e-9 if solver == "auto" else 1e-8
    rng = np.random.default_rng(1)
    u = None
    for k in range(8):
        ym = rng.normal(size=(8, 1))
        if k == 4:
            ym[3, 0] = np.nan
        x = [f.step(ym, u).cpu() for f in fleets]
        assert (x[0] - x[1]).abs().max().item() <= bar * (1 + x[1].abs().max().item()), k
        u = rng.normal(size=(8, 1)) * 0.2


@pytest.mark.cuda
def test_single_mhe_on_card_matches_cpu():
    """One MovingHorizonEstimator (default ADMM general solver) on the card
    and on the CPU, 10 periods with a NaN window: both kernels launched,
    x̂ within 1e-8·(1 + max|x̂|)."""
    dev = _card()
    ests = [_mhe(d, nint_ym=[1]) for d in (dev, torch.device("cpu"))]
    n0 = dict(LAUNCHES)
    rng = np.random.default_rng(2)
    for k in range(10):
        ym = rng.normal(size=1) * 0.5 + 1.0
        if k == 4:
            ym[0] = np.nan
        x = [e.preparestate(ym) for e in ests]
        assert np.abs(x[0] - x[1]).max() <= 1e-8 * (1 + np.abs(x[1]).max()), k
        u = rng.normal(size=1) * 0.3
        for e in ests:
            e.updatestate(u, ym)
    torch.cuda.synchronize()
    assert LAUNCHES["gi_solve"] > n0["gi_solve"] and LAUNCHES["admm_sweep"] > n0["admm_sweep"]


def _compiled_cases():
    """The compiled loops of ``mpc_tpu_torch.sim_compiled`` at their
    smallest size, each a function of the device returning its arrays
    (float64), with the bar of its solver."""
    import mpc_tpu_torch as mt
    from mpc_tpu_torch import sim_compiled as sc

    def cstr(dev, qp):
        G = mt.tf_matrix([[mt.tf(1.90, [18, 1]), mt.tf(1.90, [18, 1])],
                          [mt.tf(-0.74, [8, 1]), mt.tf(0.74, [8, 1])]])
        c = mt.LinMPC(mt.LinModel(G, 2.0), Hp=10, Hc=2, Mwt=[1, 1], Nwt=[0.1, 0.1],
                      qp_solver=qp, device=dev)
        return c.setconstraint(umin=[-20, -20], umax=[20, 20])

    def pend(dev):
        f = lambda x, u, d, p: torch.stack([x[1], -24.5 * torch.sin(x[0]) - 4 * x[1]
                                            + u[0] / 0.048])
        h = lambda x, d, p: torch.stack([x[0] * 180 / torch.pi])
        return mt.NonLinModel(f, h, 0.1, 1, 2, 1, device=dev)

    def sl(dev):
        c = mt.SLMPC(pend(dev), Hp=15, Hc=2, Mwt=[0.5], Nwt=[2.5], sigmaQ=[0.1, 1.0],
                     sigmaR=[5.0], sigmaQint_ym=[0.1], qp_solver="active_set", device=dev)
        return c.setconstraint(umin=[-1.5], umax=[1.5])

    def nl(dev):
        e = mt.UnscentedKalmanFilter(pend(dev), sigmaQ=[0.1, 1.0], sigmaR=[5.0], nint_ym=[1],
                                     sigmaQint_ym=[0.1], alpha=0.5, device=dev)
        c = mt.NonLinMPC(e, Hp=10, Hc=2, Mwt=[0.5], Nwt=[2.5], Cwt=np.inf,
                         qp_solver="active_set", transcription=mt.MultipleShooting(),
                         device=dev)
        return c.setconstraint(umin=[-1.5], umax=[1.5])

    def mhe(dev):
        e = mt.MovingHorizonEstimator(mt.LinModel(mt.tf(3, [10, 1]), 1.0), He=4, device=dev)
        rng = np.random.default_rng(3)
        Ym, U = rng.normal(size=(12, 1)) * 0.5, rng.normal(size=(12, 1)) * 0.2
        Ym[5] = np.nan
        return sc.CompiledMHELoop(e).run(Ym, U)

    def mhe_mpc(dev):
        m = lambda: mt.LinModel(mt.tf(3, [10, 1]), 1.0)
        e = mt.MovingHorizonEstimator(m(), He=5, device=dev)
        e.initstate(np.zeros(1), np.zeros(1))
        c = mt.LinMPC(mt.ManualEstimator(m()), Hp=10, Hc=2, device=dev)
        return vars(sc.CompiledMHEMPCLoop(e, c).run(10, ry=[4.0], y_noise=[0.1], seed=3))

    def fleet(dev):
        from mpc_tpu_torch.parallel import random_cstr_controllers as rc
        return sc.CompiledClosedLoopFleet(rc(4, Hp=8, Hc=2, seed=5, device=dev)).run(
            10, ry=[5, 1], y_noise=[0.05, 0.05], seed=2)

    noise = dict(ry=[5, 1], y_noise=[0.1, 0.2], u_noise=[0.05, 0.05], seed=7)
    return {
        "run ADMM": (lambda d: vars(sc.CompiledClosedLoop(cstr(d, "admm")).run(10, **noise)),
                     1e-8, "admm_sweep"),
        "run GI": (lambda d: vars(sc.CompiledClosedLoop(cstr(d, "active_set")).run(10, **noise)),
                   1e-9, "gi_solve"),
        "run_fleet ADMM": (lambda d: sc.CompiledClosedLoop(cstr(d, "admm")).run_fleet(
            4, 8, **noise), 1e-8, "admm_sweep"),
        "run_fleet GI": (lambda d: sc.CompiledClosedLoop(cstr(d, "active_set")).run_fleet(
            4, 8, **noise), 1e-9, "gi_solve"),
        "fleet": (fleet, 1e-8, "admm_sweep"),
        "SL run": (lambda d: vars(sc.CompiledSLLoop(sl(d)).run(10, ry=[180.0])), 1e-9,
                   "gi_solve"),
        "NonLin run_fleet": (lambda d: sc.CompiledNonLinLoop(nl(d)).run_fleet(
            2, 4, ry=[180.0], y_noise=[2.0], seed=4), 1e-6, "gi_solve"),
        "MHE": (mhe, 1e-9, "admm_sweep"),
        "MHE+MPC": (mhe_mpc, 1e-8, "admm_sweep"),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["run ADMM", "run GI", "run_fleet ADMM", "run_fleet GI",
                                  "fleet", "SL run", "NonLin run_fleet", "MHE", "MHE+MPC"])
def test_compiled_loop_on_card_matches_cpu(name):
    """Each compiled loop in float64 on the card (the kernels) and on the
    CPU (the plain versions): every returned array within its solver's bar
    ·(1 + max|·|), the kernel launched on the card."""
    dev = _card()
    make, bar, kernel = _compiled_cases()[name]
    n0 = LAUNCHES[kernel]
    card = make(dev)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] > n0
    cpu = make(torch.device("cpu"))
    for k, v in cpu.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            a, b = np.asarray(card[k], float), np.asarray(v, float)
            assert np.all(np.isfinite(a) == np.isfinite(b)), k
            err = np.max(np.abs(np.nan_to_num(a - b)), initial=0.0)
            assert err <= bar * (1 + np.max(np.abs(np.nan_to_num(b)), initial=0.0)), k


def _export_case(dev, solver):
    """tests/test_codegen.py's SISO controller (ADMM export) or the README
    controller (GI in both the export and the controller) on ``dev``."""
    import mpc_tpu_torch as mt
    if solver == "admm":
        m = mt.LinModel(mt.tf(3, [10, 1]), 1.0)
        m.setop(uop=[2.0], yop=[5.0])
        c = mt.LinMPC(m, Hp=10, Hc=2, Cwt=1e5, device=dev)
        c.setconstraint(umin=[-10], umax=[10], dumax=[3], dumin=[-3], ymax=[9.0], ymin=[0.0])
        return c, [7.0], 2e-4, "admm_sweep"
    G = mt.tf_matrix([[mt.tf(2, [10, 1]) * mt.delay(20)], [mt.tf(10, [4, 1])]])
    c = mt.LinMPC(mt.LinModel(G, 1.0), Mwt=[1, 0], Nwt=[0.1], qp_solver="active_set",
                  device=dev)
    c.setconstraint(ymax=[np.inf, 35])
    return c, [5.0, 0.0], 1e-9, "gi_solve"


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["admm", "active_set"])
def test_export_of_a_card_controller_matches_moveinput(solver):
    """``export_c`` of a ``device="cuda"`` controller (read from its host
    params) against its own ``moveinput`` on the card, over 15 noisy
    periods, at the bar of the reference's test of that controller."""
    import ctypes
    import shutil
    from mpc_tpu_torch.codegen import compile_and_load, export_c
    dev = _card()
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    ctrl, ry, bar, kernel = _export_case(dev, solver)
    lib = compile_and_load(export_c(ctrl, name="cx", solver=solver), name="cx")
    m = ctrl.A_stack.shape[0]
    fields = [("xhat", ctypes.c_double * ctrl.estim.nx_hat),
              ("lastu0", ctypes.c_double * ctrl.estim.model.nu),
              ("z", ctypes.c_double * ctrl.nZt)]
    fields += [("zd", ctypes.c_double * m)] if solver == "admm" else []
    st = type("State", (ctypes.Structure,), {"_fields_": fields + [("yd", ctypes.c_double * m)]})()
    lib.cx_init(ctypes.byref(st))
    nu, ny = ctrl.estim.model.nu, ctrl.estim.model.ny
    u_c, rng, n0 = (ctypes.c_double * nu)(), np.random.default_rng(3), LAUNCHES[kernel]
    for k in range(15):
        y = np.full(ny, 5.0 if solver == "admm" else 0.0) + rng.normal(size=ny) * 0.3
        ctrl.preparestate(y)
        u = ctrl.moveinput(ry)
        ctrl.updatestate(u, y)
        lib.cx_step(ctypes.byref(st), (ctypes.c_double * ny)(*y),
                    (ctypes.c_double * ny)(*ry), (ctypes.c_double * 1)(), u_c)
        assert np.max(np.abs(np.array(u_c[:]) - u)) < bar, k
    assert LAUNCHES[kernel] > n0


@pytest.mark.cuda
def test_two_shard_headline_fleet_matches_unsharded():
    """The headline-GI fleet's controllers (16 distinct × 8 replicas,
    float32, float64 slots) on a mesh of two shards of the card against the
    unsharded fleet: u within 1e-4·(1 + max|u|), the same converged count."""
    dev = _card()
    ctrls = random_cstr_controllers(16, Hp=10, Hc=2, seed=0, qp_solver="active_set",
                                    device="cpu")
    kw = dict(reps=8, dtype=torch.float32, device=dev)
    sharded = BatchedLinMPC(ctrls, mesh=["cuda:0", "cuda:0"], **kw)
    plain = BatchedLinMPC(ctrls, **kw)
    rng = np.random.default_rng(0)
    for k in range(4):
        ym, ry = rng.normal(size=(128, 2)), 2.0 + rng.normal(size=(128, 2))
        (us, ns), (up, np_) = sharded.step(ym, ry), plain.step(ym, ry)
        err = float((us - up).abs().max())
        assert err <= 1e-4 * (1.0 + float(up.abs().max())), (k, err)
        assert int(ns) == int(np_) == 128


def _gi_args(a, lane_ctrl, cap, slots):
    """The per-lane solve's arguments of ``solve_qp_active`` on ``a``."""
    rec = {}

    def capture(*args):
        rec["args"] = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        return gi_solve_reference(*args)
    solve_qp_active(a["P"], a["q"], a["A"], a["l"], a["u"], a["y0"], lane_ctrl=lane_ctrl,
                    cache=a["cache"], max_active=cap, slot_dtype=slots, solve=capture)
    return rec["args"]


# lanes of 8 controllers, 132 each: on an H100 (132 SMs) the sweep puts two
# lanes a block in step at n > 32 (B // (2·SMs) ≥ 2) and a GI block up to 8
# warps; ragged groups put one lane a block
WIDE = lambda: torch.arange(1056, dtype=torch.int32) % 8


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", ["ragged", "wide"])
@pytest.mark.parametrize("dtype,slots,cap", [(torch.float64, None, None),
                                             (torch.float32, None, 12),
                                             (torch.float32, torch.float32, 8)])
def test_gi_global_layout_returns_the_resident_bits(dtype, slots, cap, lanes):
    """At a shape both layouts take (n=33, odd, so A's rows are padded in
    shared memory and not in device memory; m=150; ragged groups or 1,056
    lanes of 8 controllers, warm duals), the global layout returns the
    resident one's x, λ, iteration counts, flags and operator state to the
    last bit."""
    dev = _card()
    lc = (LAYOUTS["ragged"]() if lanes == "ragged" else WIDE()).to(dev)
    a = _gi_problem(dev, dtype, n=33, m=150, B=lc.numel(), seed=3, lane_ctrl=lc)
    args = _gi_args(a, lc, cap, slots)
    out = {}
    for layout in ("resident", "global"):
        c = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        out[layout] = (*gi_solve(*c, _layout=layout), *c[6:10])
    torch.cuda.synchronize()
    for r, g in zip(out["resident"], out["global"]):
        assert torch.equal(r, g)


def _lanes_a_block(dev, lc, n, m, s, layout):
    """Lanes a block of a sweep launch on the card."""
    props = torch.cuda.get_device_properties(dev)
    table = admm_kernel.launch_geometry(lc.to(dev), n, m, s,
                                        props.shared_memory_per_block_optin,
                                        props.multi_processor_count, layout)[0]
    return table.shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,warp_lanes,lanes", [(5, 101, 0, "ragged"),
                                                  (5, 101, 10**9, "ragged"),
                                                  (33, 150, 0, "ragged"),
                                                  (33, 150, 0, "wide")])
def test_sweep_global_layout_returns_the_resident_bits(dtype, n, m, warp_lanes, lanes,
                                                       monkeypatch):
    """Both sweep variants (a warp a lane and the lanes in step, one and two
    lanes a block) on ragged groups or 1,056 lanes of 8 controllers: the
    global layout returns the resident one's x, z and y to the last bit."""
    dev = _card()
    monkeypatch.setattr(admm_kernel, "WARP_LANES_PER_SM", warp_lanes)
    lc = LAYOUTS["ragged"]() if lanes == "ragged" else WIDE()
    if lanes == "wide":
        s = 4 if dtype == torch.float32 else 8
        assert [_lanes_a_block(dev, lc, n, m, s, lay) for lay in ("resident", "global")] \
            == [2, 2]
    a = _problem(dev, dtype, n=n, m=m, lane_ctrl=lc)
    out = {}
    for layout in ("resident", "global"):
        b = {k: v.clone() for k, v in a.items()}
        admm_sweep(*(b[k] for k in SWEEP), 40, 1e-6, 1.6, _layout=layout)
        out[layout] = b
    torch.cuda.synchronize()
    for k in ("x", "z", "y"):
        assert torch.equal(out["resident"][k], out["global"][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(64, 1024), (5, 12000)])
def test_sweep_beyond_shared_memory_matches_plain_on_card(n, m):
    """One lane's block of n=64, m=1024 (the lanes in step) or n=5, m=12000
    (a warp a lane: the batch is too small for it, but the lanes in step do
    not fit either) exceeds the shared memory of a block in float32 and
    float64: the sweep runs in the staged layout (in step, where the lanes
    fit: all but n=5, m=12000 in float64) or the global one and holds to
    the plain version as at the resident shapes."""
    dev = _card()
    lc = LAYOUTS["tiled"]()
    props = torch.cuda.get_device_properties(dev)
    for dt, s in ((torch.float32, 4), (torch.float64, 8)):
        *_, layout = admm_kernel.launch_geometry(
            lc.to(dev), n, m, s, props.shared_memory_per_block_optin,
            props.multi_processor_count)
        assert layout == ("global" if (m, s) == (12000, 8) else "staged")
    _sweep_check(dev, torch.float32, 1e-4, n=n, m=m, lane_ctrl=lc)
    _sweep_check(dev, torch.float64, 1e-10, rel=False, n=n, m=m, lane_ctrl=lc)


@pytest.mark.cuda
def test_sweep_two_lanes_a_block_global_matches_plain_on_card():
    """The lanes in step two a block (1,056 lanes of 8 controllers, n=33,
    m=150) forced to the global layout hold to the plain sweep with the bars
    of test_kernel_layouts_match_plain_on_card: f32 to 1e-4·(1 + max|plain|),
    f64 to 1e-10, frozen lanes bit-unchanged."""
    dev = _card()
    lc = WIDE()
    for dt, s in ((torch.float32, 4), (torch.float64, 8)):
        assert _lanes_a_block(dev, lc, 33, 150, s, "global") == 2
    _sweep_check(dev, torch.float32, 1e-4, n=33, m=150, lane_ctrl=lc, layout="global")
    _sweep_check(dev, torch.float64, 1e-10, rel=False, n=33, m=150, lane_ctrl=lc,
                 layout="global")


@pytest.mark.cuda
def test_gi_beyond_shared_memory_matches_plain_on_card():
    """n=64, m=1024 in float64 (one warp's block needs 654,080 bytes of
    shared memory): the GI kernel runs in the split layout and holds to the
    plain solve: equal flags, iterations and active sets, x to
    1e-9·(1 + max|x|), the float64 bar of test_gi_kernel_matches_plain_on_card
    (the junk in the warm duals costs up to ~250 rank-one updates of Ginv
    here, whose sums the two take in other orders), with a cap of 600
    pivots."""
    dev = _card()
    lc = (torch.arange(64, dtype=torch.int32) % 4).to(dev)
    a = _gi_problem(dev, torch.float64, n=64, m=1024, B=64, seed=7, lane_ctrl=lc)
    n0 = LAUNCHES["gi_solve"]
    k, p = (solve_qp_active(a["P"], a["q"], a["A"], a["l"], a["u"], a["y0"],
                            lane_ctrl=lc, cache=a["cache"], max_pivots=600, solve=fn)
            for fn in (gi_solve, gi_solve_reference))
    torch.cuda.synchronize()
    assert LAUNCHES["gi_solve"] == n0 + 1
    assert bool(p.converged.all())
    assert torch.equal(k.converged, p.converged)
    assert torch.equal(k.iters, p.iters)
    assert torch.equal(k.gi_state["gis_idx"], p.gi_state["gis_idx"])
    assert (k.x - p.x).abs().max().item() < 1e-9 * (1.0 + p.x.abs().max().item())


# --- the staged sweep and the split GI: the resident and global bits -------
# A cut resident-row count (``_layout=(name, rows)``) makes the streamed (or
# column-major) rows run at shapes the resident layout takes: 0 rows, a cut
# that leaves a partial last tile, and all of A.
@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 50, 150])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,warp_lanes,lanes,stages", [(5, 10**9, "ragged", 2),
                                                        (33, 0, "ragged", 2),
                                                        (33, 0, "wide", 2),
                                                        (33, 0, "wide", 3)])
def test_sweep_staged_layout_returns_the_resident_bits(dtype, n, warp_lanes, lanes, stages,
                                                       rows, monkeypatch):
    """The lanes in step (n=5 or 33, m=150; ragged groups or 1,056 lanes of
    8 controllers; a ring of two or three stages) in the staged layout with
    0, 50 or all 150 of A's rows in shared memory: the resident layout's x,
    z and y to the last bit, and the global layout's."""
    dev = _card()
    monkeypatch.setattr(admm_kernel, "WARP_LANES_PER_SM", warp_lanes)
    monkeypatch.setattr(admm_kernel, "STAGED_STAGES", stages)
    lc = LAYOUTS["ragged"]() if lanes == "ragged" else WIDE()
    a = _problem(dev, dtype, n=n, m=150, lane_ctrl=lc)
    out = {}
    for layout in ("resident", ("staged", rows), "global"):
        b = {k: v.clone() for k, v in a.items()}
        admm_sweep(*(b[k] for k in SWEEP), 40, 1e-6, 1.6, _layout=layout)
        out[str(layout)] = b
    torch.cuda.synchronize()
    for k in ("x", "z", "y"):
        for layout in out:
            assert torch.equal(out["resident"][k], out[layout][k]), (k, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 57, 150])
@pytest.mark.parametrize("lanes", ["ragged", "wide"])
@pytest.mark.parametrize("dtype,slots,cap", [(torch.float64, None, None),
                                             (torch.float32, None, 12),
                                             (torch.float32, torch.float32, 8)])
def test_gi_split_layout_returns_the_resident_bits(dtype, slots, cap, lanes, rows):
    """The GI kernel (n=33, m=150, warm duals; ragged groups or 1,056 lanes
    of 8 controllers) in the split layout with 0, 57 or all 150 of A's rows
    in shared memory, the others read from the column-major copy: the
    resident layout's x, λ, iteration counts, flags and operator state to
    the last bit, and the global layout's."""
    dev = _card()
    lc = (LAYOUTS["ragged"]() if lanes == "ragged" else WIDE()).to(dev)
    a = _gi_problem(dev, dtype, n=33, m=150, B=lc.numel(), seed=3, lane_ctrl=lc)
    args = _gi_args(a, lc, cap, slots)
    out = {}
    for layout in ("resident", ("split", rows), "global"):
        c = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        out[str(layout)] = (*gi_solve(*c, _layout=layout), *c[6:10])
    torch.cuda.synchronize()
    for layout in out:
        for r, g in zip(out["resident"], out[layout]):
            assert torch.equal(r, g), layout


# the 8x8 fleet's QP at Hp=60 (n=33, m=2017), 32 controllers
FLEET60 = lambda B: torch.arange(B, dtype=torch.int32) % 32


@pytest.mark.cuda
def test_sweep_staged_at_the_hp60_shape_gives_the_global_bits():
    """At n=33, m=2017 (A beyond a block's shared memory; in float32 four
    lanes a staged block at B=4096) the wrapper takes the staged layout, which
    returns the global layout's x, z and y to the last bit in float32 and
    float64, and holds to the plain sweep: float64 to 1e-10."""
    dev = _card()
    props = torch.cuda.get_device_properties(dev)
    for dt, s in ((torch.float32, 4), (torch.float64, 8)):
        a = _problem(dev, dt, n=33, m=2017, lane_ctrl=FLEET60(4096), seed=4)
        table, *_, layout = admm_kernel.launch_geometry(
            a["lane_ctrl"], 33, 2017, s, props.shared_memory_per_block_optin,
            props.multi_processor_count)
        assert layout == "staged" and (s == 8 or table.shape[1] == 4)
        out = {}
        for lay in (None, "global"):
            b = {k: v.clone() for k, v in a.items()}
            admm_sweep(*(b[k] for k in SWEEP), 10, 1e-6, 1.6, _layout=lay)
            out[lay] = b
        torch.cuda.synchronize()
        for k in ("x", "z", "y"):
            assert torch.equal(out[None][k], out["global"][k]), (dt, k)
    _sweep_check(dev, torch.float64, 1e-10, rel=False, n=33, m=2017, lane_ctrl=FLEET60(256))


@pytest.mark.cuda
def test_gi_split_at_the_hp60_shape_gives_the_global_bits():
    """At n=33, m=2017 (f32 data, f64 slots, 12 slots, 512 lanes of 32
    controllers) the wrapper takes the split layout, which returns the
    global layout's bits, and holds to the plain solve with the bars of
    chip_smoke.py's fleet shapes: the converged flag equal on all but 4
    lanes (a near-tie in the float32 scan, summed in another order, can
    change the pivot order), x to 1e-4·(1 + max|x|) where both converged."""
    dev = _card()
    lc = FLEET60(512).to(dev)
    a = _gi_problem(dev, torch.float32, n=33, m=2017, B=512, seed=6, lane_ctrl=lc)
    a["l"] -= 2.0      # wider bounds: a few active rows, within the 12 slots
    a["u"] += 2.0
    args = _gi_args(a, lc, 12, None)
    props = torch.cuda.get_device_properties(dev)
    from mpc_tpu_torch.ops import gi_kernel
    *_, layout = gi_kernel.launch_geometry(lc, 33, 2017, 12, 4, 8,
                                           props.shared_memory_per_block_optin,
                                           props.multi_processor_count)
    assert layout == "split"
    out = {}
    for lay in (None, "global"):
        c = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        out[lay] = (*gi_solve(*c, _layout=lay), *c[6:10])
    c = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
    x, _, it, conv = gi_solve_reference(*c)
    torch.cuda.synchronize()
    for r, g in zip(out[None], out["global"]):
        assert torch.equal(r, g)
    assert int((out[None][3] != conv).sum()) <= 4
    both = conv & out[None][3]
    assert int(both.sum()) >= 256
    assert (out[None][0] - x)[both].abs().max().item() < 1e-4 * (1.0 + x.abs().max().item())


def _geometry(kernel, *args, **kw):
    """The launch geometry a wrapper takes on the card for these sizes."""
    from mpc_tpu_torch.ops import gi_kernel
    props = torch.cuda.get_device_properties(0)
    mod = gi_kernel if kernel == "gi" else admm_kernel
    return mod.launch_geometry(*args, min(232448, props.shared_memory_per_block_optin),
                               props.multi_processor_count, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,B,dtype,slots,cap", [(2, 72, 4096, torch.float32, None, None),
                                                   (33, 146, 300, torch.float32, None, None),
                                                   (6, 24, 700, torch.float64, None, 3),
                                                   (5, 40, 1, torch.float64, None, None)])
@pytest.mark.parametrize("order", ["identity", "permuted"])
def test_gi_per_lane_geometry_returns_the_global_bits(n, m, B, dtype, slots, cap, order):
    """Every lane its own P and A (n_d = B, through the identity map or a
    permutation): the wrapper takes the per-lane geometry (each warp its
    lane's own P⁻¹, A and row norms, one load group) and returns the bits of
    the global layout, which groups the lanes a lane a block as before, and
    of the split layout with a third of A's rows resident; x within 1e-9
    (float64) or 1e-4 (float32) of the plain solve."""
    from mpc_tpu_torch.utils.lanes import identity_lanes
    dev = _card()
    lc = (identity_lanes(B, dev) if order == "identity"
          else torch.randperm(B, generator=torch.Generator().manual_seed(1)).to(
              dev, torch.int32))
    a = _gi_problem(dev, dtype, n=n, m=m, B=B, seed=7, lane_ctrl=lc)
    args = _gi_args(a, lc, cap, slots)
    s_d, s_s = args[1].element_size(), args[0].element_size()
    assert _geometry("gi", lc, n, m, args[6].shape[1], s_d, s_s)[1] is None
    out = {}
    for layout in (None, "global", ("split", m // 3)):
        c = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        out[str(layout)] = (*gi_solve(*c, _layout=layout), *c[6:10])
    p = gi_solve_reference(*[t.clone() if isinstance(t, torch.Tensor) else t for t in args])
    torch.cuda.synchronize()
    for other in ("global", str(("split", m // 3))):
        for r, g in zip(out["None"], out[other]):
            assert torch.equal(r, g), other
    k = out["None"]
    both = k[3] & p[3]
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    assert (k[0] - p[0])[both].abs().max().item() <= tol * (1.0 + p[0].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,slots", [(torch.float32, None), (torch.float64, None),
                                         (torch.float32, torch.float32)])
@pytest.mark.parametrize("n_a", [1, 3])
def test_gi_a_map_returns_the_copied_a_bits(dtype, slots, n_a):
    """P⁻¹ a lane and A through its own map (the MHE NaN variant's shape,
    n=44, m=104, 8 slots, B=600; one shared A or three): the A map returns
    the bits of the same call with A copied to every lane (the per-lane
    geometry) and of the global and split layouts with the map; x within
    1e-9 (float64) or 1e-4 (float32) of the plain solve with the map."""
    dev = _card()
    B, n, m = 600, 44, 104
    a = _gi_problem(dev, dtype, n=n, m=m, B=B, seed=11)
    ac = (torch.arange(B, device=dev, dtype=torch.int32) * 7) % n_a
    A_shared = a["A"][:n_a].contiguous()
    # bounds about a point of the lane's own A
    g = torch.Generator().manual_seed(3)
    x0 = (torch.randn(B, n, generator=g, dtype=torch.float64) * 0.1).to(dev, dtype)
    Ax = (A_shared[ac.long()] @ x0[..., None])[..., 0]
    a["l"] = torch.where(a["l"] < -1e19, a["l"], Ax - 2.0)
    a["u"] = Ax + 2.5
    rec = {}

    def capture(*args):
        rec["args"] = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        return gi_solve_reference(*args)
    solve_qp_active(a["P"], a["q"], A_shared, a["l"], a["u"], a["y0"], a_ctrl=ac,
                    cache=a["cache"], max_active=8, slot_dtype=slots, solve=capture)
    args = rec["args"]
    assert len(args) == 17 and _geometry("gi", args[2], n, m, 8, args[1].element_size(),
                                         args[0].element_size(), a_ctrl=ac)[1] is not None
    out = {}
    for layout in (None, "global", ("split", 40)):
        c = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        out[str(layout)] = (*gi_solve(*c, _layout=layout), *c[6:10])
    c = [t.clone() if isinstance(t, torch.Tensor) else t for t in args[:16]]
    c[1] = A_shared.index_select(0, ac).contiguous()
    out["copied"] = (*gi_solve(*c), *c[6:10])
    p = gi_solve_reference(*[t.clone() if isinstance(t, torch.Tensor) else t for t in args])
    torch.cuda.synchronize()
    for other in ("global", str(("split", 40)), "copied"):
        for r, g_ in zip(out["None"], out[other]):
            assert torch.equal(r, g_), other
    k = out["None"]
    both = k[3] & p[3]
    assert int(both.sum()) >= B // 2
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    assert (k[0] - p[0])[both].abs().max().item() <= tol * (1.0 + p[0].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,B", [(2, 72, 4096), (3, 65, 2112), (8, 40, 1400)])
def test_sweep_per_lane_geometry_returns_the_global_bits(dtype, n, m, B):
    """Every lane its own controller (n_d = B) with a batch that puts a warp
    on each lane: the sweep takes the per-lane geometry (each warp its
    lane's own A, one load group, the partial sums read together) and
    returns the bits of the global layout, which groups the lanes a lane a
    block as before; x, z and y within 1e-4 (float32) or 1e-9 (float64) of
    the plain sweep, relative to their largest entries."""
    from mpc_tpu_torch.utils.lanes import identity_lanes
    dev = _card()
    lc = identity_lanes(B, dev)
    assert _geometry("sweep", lc, n, m, dtype.itemsize)[1] is None
    a = _problem(dev, dtype, n=n, m=m, lane_ctrl=lc.cpu())
    a["lane_ctrl"] = lc
    out = {}
    for layout in (None, "global", "plain"):
        b = {k: v.clone() for k, v in a.items()}
        fn = admm_sweep_reference if layout == "plain" else functools.partial(
            admm_sweep, _layout=layout)
        fn(*(b[k] for k in SWEEP), 40, 1e-6, 1.6)
        out[str(layout)] = b
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-9
    for k in ("x", "z", "y"):
        assert torch.equal(out["None"][k], out["global"][k]), k
        p = out["plain"][k]
        assert (out["None"][k] - p).abs().max().item() <= tol * (1.0 + p.abs().max().item()), k
