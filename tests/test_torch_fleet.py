"""The port's serving fleet against mpc_tpu.parallel.BatchedLinMPC.

Both fleets start from the same parameters (the reference controllers'
params dicts go through ``BatchedLinMPC.from_params``) and run closed loops
in the bench.py regime: every lane steps its true plant, measurement noise
and setpoints rotate through 4 phases.  In float64 the bar is the repo's own
fleet ≡ single-controller bar (tests/test_batch.py): u to 1e-6, the same
converged counts, the same iteration statistics.  Every fleet kind runs
twice: with the ADMM backend and with the Goldfarb–Idnani backend
(``qp_solver="active_set"``, whose per-lane solve and cross-period operator
carry the port runs through ``ops/gi_kernel.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpc_tpu
from mpc_tpu.parallel import BatchedLinMPC as RefFleet
from mpc_tpu.parallel import estimator_params, random_cstr_controllers
import mpc_tpu_torch
from mpc_tpu_torch.parallel import BatchedLinMPC

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _ms_controllers(pkg, n, qp_solver="admm"):
    ctrls = []
    for c in random_cstr_controllers(n, seed=3):
        m = c.estim.model
        model = pkg.LinModel(m.A, m.Bu, m.C, m.Bd, m.Dd, m.Ts)
        mc = pkg.LinMPC(model, Hp=10, Hc=2, Mwt=[1.0, 1.0], Nwt=[0.1, 0.1],
                        transcription=pkg.MultipleShooting(),
                        qp_solver=qp_solver)
        mc.setconstraint(umin=[-10.0, -10.0], umax=[10.0, 10.0],
                         dumin=[-4.0, -4.0], dumax=[4.0, 4.0],
                         ymin=[-60.0, -60.0], ymax=[60.0, 60.0])
        ctrls.append(mc)
    return ctrls


def _both(ctrls, reps, dtype, share_params=False):
    """The reference fleet and the port's, built from the same params (a GI
    fleet carries float64 slots in both: the reference runs under x64)."""
    ref = RefFleet(ctrls, reps=reps, share_params=share_params,
                   dtype=jnp.float32 if dtype == torch.float32 else None)
    ep = estimator_params(ctrls)
    eps = [{k: v[i] for k, v in ep.items()} for i in range(len(ctrls))]
    port = BatchedLinMPC.from_params([c.params for c in ctrls], eps,
                                     reps=reps, share_params=share_params,
                                     dtype=dtype,
                                     gi_max_active=ctrls[0].gi_max_active,
                                     device=CPU)
    return ref, port


class _Loop:
    """True plants, rotating setpoints, measurement noise and measured
    disturbances (bench.py: 118-125, 160-168, 189-206), one copy of the
    plant state per fleet."""

    def __init__(self, ctrls, reps, seed=1):
        st = lambda k: np.concatenate([np.stack([getattr(c.estim.model, k)
                                                 for c in ctrls])] * reps)
        self.A, self.Bu, self.Bd, self.C = st("A"), st("Bu"), st("Bd"), st("C")
        B, ny, nd = self.C.shape[0], self.C.shape[1], self.Bd.shape[2]
        rng = np.random.default_rng(seed)
        ry0 = rng.normal(size=(B, ny)) * 2.0
        self.phases = [(rng.normal(size=(B, ny)) * 0.1,
                        ry0 + rng.normal(size=(B, ny)) * 0.2,
                        rng.normal(size=(B, nd)) * 0.5)
                       for _ in range(4)]
        self.x = np.zeros((B, self.A.shape[1]))

    def inputs(self, k, x):
        noise, ry, d = self.phases[k % 4]
        return np.einsum("bij,bj->bi", self.C, x) + noise, ry, d

    def advance(self, x, u, d):
        e = np.einsum
        return (e("bij,bj->bi", self.A, x) + e("bij,bj->bi", self.Bu, u)
                + e("bij,bj->bi", self.Bd, d))


def _run_both(ref, port, loop, K, np_dt):
    xr, xp = loop.x.copy(), loop.x.copy()
    out = []
    for k in range(K):
        ym_r, ry, d = loop.inputs(k, xr)
        ym_p, _, _ = loop.inputs(k, xp)
        ry, d = ry.astype(np_dt), d.astype(np_dt)
        d_in = d if d.shape[1] else None
        u_r, nc_r = ref.step(jnp.asarray(ym_r.astype(np_dt)), jnp.asarray(ry),
                             None if d_in is None else jnp.asarray(d_in))
        u_p, nc_p = port.step(ym_p.astype(np_dt), ry, d_in)
        u_r, u_p = np.asarray(u_r, np.float64), u_p.double().numpy()
        out.append((u_r, u_p, int(nc_r), int(nc_p),
                    np.asarray(ref.last_iters), port.last_iters.numpy()))
        xr, xp = loop.advance(xr, u_r, d), loop.advance(xp, u_p, d)
    return out


def _disturbance_controllers(n, qp_solver="admm"):
    """Measured disturbance (nd = 1), hard constraints (Cwt = inf)."""
    ctrls = []
    for a in np.linspace(1.0, 0.9, n):
        model = mpc_tpu.LinModel(np.array([[0.9, 0.1], [0.0, 0.8]]) * a,
                                 np.array([[0.5], [1.0]]), np.eye(2),
                                 np.array([[0.2], [0.0]]),
                                 np.array([[0.0], [0.1]]), 0.5)
        c = mpc_tpu.LinMPC(model, Hp=8, Hc=3, Mwt=[1.0, 0.5], Nwt=[0.2],
                           Lwt=[0.05], Cwt=np.inf, qp_solver=qp_solver)
        c.setconstraint(umin=[-2.0], umax=[2.0], dumin=[-0.5], dumax=[0.5])
        ctrls.append(c)
    return ctrls


def _fleets(qp):
    return {
        "cstr_grouped": lambda: (random_cstr_controllers(4, seed=0, qp_solver=qp),
                                 2, False),
        "multiple_shooting": lambda: (_ms_controllers(mpc_tpu, 2, qp), 2, False),
        "shared_params": lambda: (random_cstr_controllers(1, seed=2, qp_solver=qp),
                                  4, True),
        "disturbance_hard": lambda: (_disturbance_controllers(2, qp), 2, False),
    }


# the ADMM fleets under their own names, the GI fleets as gi_<name>
FLEETS = {**_fleets("admm"),
          **{f"gi_{k}": v for k, v in _fleets("active_set").items()}}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_f64_closed_loop_matches_reference(name):
    ctrls, reps, share = FLEETS[name]()
    ref, port = _both(ctrls, reps, torch.float64, share_params=share)
    loop = _Loop(ctrls, reps)
    for u_r, u_p, nc_r, nc_p, it_r, it_p in _run_both(ref, port, loop, 5,
                                                      np.float64):
        assert nc_r == nc_p == port.B
        assert np.max(np.abs(u_r - u_p)) < 1e-6
        assert np.array_equal(it_r, it_p)


def test_f32_closed_loop_matches_reference():
    """float32 fleets: the two packages sum in different orders, which moves
    the f32 plateau exit and the polish's active-set detection slightly;
    the bar on u is 1e-3 (about 1e-4 of the ±10 input range)."""
    ctrls = random_cstr_controllers(4, seed=0)
    ref, port = _both(ctrls, 2, torch.float32)
    for u_r, u_p, nc_r, nc_p, *_ in _run_both(ref, port, _Loop(ctrls, 2), 6,
                                              np.float32):
        assert nc_r == nc_p
        assert np.all(np.isfinite(u_p))
        assert np.max(np.abs(u_r - u_p)) < 1e-3


def test_f32_gi_closed_loop_matches_reference():
    """float32 GI fleets with float64 slots (the reference's mixed mode
    under x64, the port's default): u to 1e-3, the same converged counts."""
    ctrls = random_cstr_controllers(4, seed=0, qp_solver="active_set")
    ref, port = _both(ctrls, 2, torch.float32)
    assert port.gi_slot_dtype == torch.float64
    assert port.state["qp_state"]["gis_Ginv"].dtype == np.float64
    for u_r, u_p, nc_r, nc_p, *_ in _run_both(ref, port, _Loop(ctrls, 2), 6,
                                              np.float32):
        assert nc_r == nc_p == port.B
        assert np.all(np.isfinite(u_p))
        assert np.max(np.abs(u_r - u_p)) < 1e-3


def test_gi_fleet_serving_stability():
    """The port's counterpart of tests/test_batch.py:157-191: a 40-step
    rotating-setpoint float32 GI fleet on stiff 4x4 plants (B=128) stays
    fully converged with a bounded worst-lane pivot count."""
    rng = np.random.default_rng(0)
    ctrls = []
    for _ in range(4):
        A = np.diag(rng.uniform(0.45, 0.8, 4)) + rng.normal(size=(4, 4)) * 0.02
        A *= min(1.0, 0.85 / np.max(np.abs(np.linalg.eigvals(A))))
        model = mpc_tpu_torch.LinModel(mpc_tpu_torch.ss(
            A, np.eye(4) + 0.5 * rng.normal(size=(4, 4)), np.eye(4),
            np.zeros((4, 4)), 2.0), 2.0)
        c = mpc_tpu_torch.LinMPC(model, Hp=10, Hc=3, Mwt=np.ones(4),
                                 Nwt=np.ones(4), Cwt=1e3, qp_solver="active_set",
                                 device=CPU)
        c.setconstraint(umin=np.full(4, -10.0), umax=np.full(4, 10.0),
                        dumin=np.full(4, -4.0), dumax=np.full(4, 4.0),
                        ymin=np.full(4, -60.0), ymax=np.full(4, 60.0))
        ctrls.append(c)
    B = 128
    bat = BatchedLinMPC(ctrls, dtype=torch.float32, reps=B // 4, device=CPU)
    ym0 = rng.normal(size=(B, 4)) * 0.5
    ry0 = rng.normal(size=(B, 4)) * 2.0
    seq = [(ym0 + rng.normal(size=(B, 4)) * 0.1, ry0 + rng.normal(size=(B, 4)) * 0.2)
           for _ in range(4)]
    worst = 0
    for k in range(40):
        u, nc = bat.step(*seq[k % 4])
        worst = max(worst, int(bat.last_iters[0]))
        assert int(nc) == B, (k, int(nc))
    assert worst < 60, worst


def test_gi_cap_matches_uncapped():
    """tests/test_batch.py:218-239: a gi_max_active=3 fleet reproduces the
    uncapped one while the lanes' active sets fit the cap."""
    fleets = [BatchedLinMPC(mpc_tpu_torch.parallel.random_cstr_controllers(
        4, Hp=8, Hc=2, seed=4, qp_solver="active_set", gi_max_active=cap,
        device=CPU), device=CPU)
        for cap in (None, 3)]
    assert [f.gi_slots for f in fleets] == [fleets[0].n_qp, 3]
    rng = np.random.default_rng(2)
    for k in range(4):
        ym = rng.normal(size=(4, 2)) * 0.5
        ry = rng.normal(size=(4, 2))
        (ua, na), (ub, nb) = (f.step(ym, ry) for f in fleets)
        assert int(na) == 4 and int(nb) == 4, k
        assert torch.allclose(ua, ub, rtol=0, atol=1e-7), k


def test_multistep_equals_repeated_steps():
    ctrls = mpc_tpu_torch.parallel.random_cstr_controllers(3, seed=4, device=CPU)
    a = BatchedLinMPC(ctrls, reps=2, device=CPU)
    b = BatchedLinMPC(ctrls, reps=2, device=CPU)
    rng = np.random.default_rng(0)
    ym = rng.normal(size=(3, a.B, 2)) * 0.5
    ry = rng.normal(size=(3, a.B, 2))
    U, NC = a.multistep(ym, ry)
    for k in range(3):
        u, nc = b.step(ym[k], ry[k])
        assert torch.equal(U[k], u) and int(NC[k]) == int(nc)
    assert torch.equal(a.last_iters, b.last_iters)
    sa, sb = a.state, b.state
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k


def test_public_lane_order_is_replica_major():
    """Lane r·n_d + c is replica r of controller c: a grouped fleet's lanes
    equal, replica by replica, a reps=1 fleet fed that replica's inputs."""
    ctrls = mpc_tpu_torch.parallel.random_cstr_controllers(3, seed=5, device=CPU)
    n_d, reps = 3, 2
    grouped = BatchedLinMPC(ctrls, reps=reps, device=CPU)
    assert grouped.lane_ctrl.tolist() == [0, 1, 2, 0, 1, 2]
    rng = np.random.default_rng(1)
    ym = rng.normal(size=(n_d * reps, 2))
    ry = rng.normal(size=(n_d * reps, 2))
    u, _ = grouped.step(ym, ry)
    for r in range(reps):
        lanes = slice(r * n_d, (r + 1) * n_d)
        u1, _ = BatchedLinMPC(ctrls, device=CPU).step(ym[lanes], ry[lanes])
        assert torch.allclose(u[lanes], u1, rtol=0, atol=1e-12), r


def _round_trip(qp_solver):
    """Two reference periods, the reference's whole state (``qp_state``
    included) through the port's setter, then one more period of each."""
    ctrls = random_cstr_controllers(2, seed=6, qp_solver=qp_solver)
    ref, port = _both(ctrls, 2, torch.float64)
    loop = _Loop(ctrls, 2)
    x = loop.x
    for k in range(2):
        ym, ry, d = loop.inputs(k, x)
        u, _ = ref.step(jnp.asarray(ym), jnp.asarray(ry))
        x = loop.advance(x, np.asarray(u), d)
    host = lambda v: (None if v is None else {g: np.asarray(a) for g, a in v.items()}
                      if isinstance(v, dict) else np.asarray(v))
    port.state = {k: host(v) for k, v in ref.state.items()}
    ym, ry, _ = loop.inputs(2, x)
    u_r, _ = ref.step(jnp.asarray(ym), jnp.asarray(ry))
    u_p, _ = port.step(ym, ry)
    assert np.max(np.abs(np.asarray(u_r) - u_p.numpy())) < 1e-6
    return ref, port


def test_state_round_trip_continues_reference_run():
    """Reference state copied into the port through the ``state`` setter:
    the next step agrees, and the getter returns NumPy copies."""
    _, port = _round_trip("admm")
    st = port.state
    assert set(st) == {"x0_hat", "lastu0", "Z_tilde", "y_dual", "rho_rung",
                       "qp_state"}
    assert st["rho_rung"].dtype == np.int32 and st["qp_state"] is None
    st["x0_hat"][:] = 1e3            # a copy: the fleet is untouched
    assert np.abs(port.state["x0_hat"]).max() < 1e3
    with pytest.raises(ValueError, match="shape"):
        port.state = {"lastu0": np.zeros((1, 2))}
    with pytest.raises(ValueError, match="ADMM"):
        port.state = {"qp_state": {}}


def test_gi_state_round_trip_continues_reference_run():
    """The same with GI fleets: the carried operator state (idx, side,
    vmask, Ginv) crosses packages, and the next period's state agrees."""
    ref, port = _round_trip("active_set")
    qr, qp = ref.state["qp_state"], port.state["qp_state"]
    for k in ("gis_idx", "gis_side", "gis_vmask"):
        assert np.array_equal(np.asarray(qr[k]), qp[k]), k
    assert np.max(np.abs(np.asarray(qr["gis_Ginv"]) - qp["gis_Ginv"])) < 1e-9
    with pytest.raises(ValueError, match="gis_"):
        port.state = {"qp_state": None}


@pytest.mark.parametrize("option", ["mesh", "grouped_chunks",
                                    "limit_solve_time"])
def test_unported_options_raise(option):
    """Every option of the reference's fleet is ported: mesh and
    grouped_chunks build a fleet that steps as the plain one (their parity
    cases are tests/test_torch_mesh.py); limit_solve_time (its parity cases
    are tests/test_torch_deadline.py) builds a fleet with the deadline
    bookkeeping at rest."""
    ctrls = mpc_tpu_torch.parallel.random_cstr_controllers(2, seed=0, device=CPU)
    if option == "limit_solve_time":
        fleet = BatchedLinMPC(ctrls, limit_solve_time=True, device=CPU)
        assert fleet.limit_solve_time and fleet.Ts == 2.0
        assert fleet.last_step_time is None and fleet.deadline_miss_count == 0
        return
    kw = dict(mesh=[CPU, "cpu"]) if option == "mesh" else dict(grouped_chunks=2)
    fleet = BatchedLinMPC(ctrls, reps=2, device=CPU, **kw)
    plain = BatchedLinMPC(ctrls, reps=2, device=CPU)
    rng = np.random.default_rng(0)
    for _ in range(3):
        ym, ry = rng.normal(size=(4, 2)), rng.normal(size=(4, 2))
        (u, nc), (u0, nc0) = fleet.step(ym, ry), plain.step(ym, ry)
        assert torch.allclose(u, u0, rtol=0, atol=1e-12) and int(nc) == int(nc0) == 4


# ------------------------------------ the QP build over a tiled lane map
def _port_controller(a, qp, ms, nd, nw):
    """A port LinMPC of a 2×1 plant (× ``a``) with ``nd`` measured
    disturbances and ``nw`` custom constraint rows, soft output bounds."""
    model = mpc_tpu_torch.LinModel(np.array([[0.9, 0.1], [0.0, 0.8]]) * a,
                                   np.array([[0.5], [1.0]]), np.eye(2),
                                   np.array([[0.2], [0.0]])[:, :nd],
                                   np.array([[0.0], [0.1]])[:, :nd], 0.5)
    custom = dict(Wy=[[1.0, -1.0]], Wu=[[0.5]], Wr=[[0.2, 0.0]]) if nw else {}
    if nw and nd:
        custom["Wd"] = [[0.3]]
    c = mpc_tpu_torch.LinMPC(model, Hp=8, Hc=3, Mwt=[1.0, 0.5], Nwt=[0.2], Lwt=[0.05],
                             qp_solver=qp, device=CPU,
                             transcription=(mpc_tpu_torch.MultipleShooting() if ms
                                            else mpc_tpu_torch.SingleShooting()), **custom)
    c.setconstraint(umin=[-2.0], umax=[2.0], dumin=[-0.5], dumax=[0.5],
                    ymin=[-3.0, -3.0], ymax=[3.0, 3.0],
                    **(dict(wmin=[-1.5], wmax=[1.5]) if nw else {}))
    return c


def _close(a, b, rtol):
    """``a`` equals ``b`` to ``rtol`` of b's largest finite entry; entries
    at ±2e18 (a row's missing bound) alike in both."""
    big = b.abs() >= 1e17
    assert torch.equal(big, a.abs() >= 1e17)
    a, b = a[~big], b[~big]
    scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
    torch.testing.assert_close(a, b, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("share", [False, True], ids=["grouped", "share_params"])
@pytest.mark.parametrize("nw", [0, 1], ids=["nw0", "nw1"])
@pytest.mark.parametrize("nd", [0, 1], ids=["nd0", "nd1"])
@pytest.mark.parametrize("ms", [False, True], ids=["SS", "MS"])
@pytest.mark.parametrize("qp", ["active_set", "admm"], ids=["gi", "admm"])
def test_build_on_a_tiled_map_equals_the_lane_order_build(qp, ms, nd, nw, share, dtype, rtol,
                                                          monkeypatch):
    """``_build_step`` over the fleet's tiled map (one GEMM a controller over
    its lanes) against the same lanes through an unregistered copy of the
    map (a per-lane copy and a gemv a product): the QP data handed to the
    solver and the step's u, Z̃, F and objective."""
    import mpc_tpu_torch.controllers.linmpc as port_linmpc
    from mpc_tpu_torch.utils import lanes
    ctrls = [_port_controller(a, qp, ms, nd, nw) for a in ([1.0] if share else [1.0, 0.95, 0.9])]
    fleet = BatchedLinMPC(ctrls, reps=5 if share else 4, share_params=share, dtype=dtype,
                          device=CPU)
    part = fleet._parts[0]
    lc = part.lane_ctrl
    assert lanes.tiling(lc) == ((1, 5) if share else (3, 4))
    seen = []
    for name in ("solve_qp", "solve_qp_active"):
        solve = getattr(port_linmpc, name)

        def spy(P, q, A, l, u, *args, _solve=solve, **kw):
            seen.append((q, l, u))
            return _solve(P, q, A, l, u, *args, **kw)
        monkeypatch.setattr(port_linmpc, name, spy)
    B, Hp, st = fleet.B, fleet.Hp, part.state
    g = torch.Generator().manual_seed(7)
    rnd = lambda n, s: (s * torch.randn(B, n, generator=g, dtype=torch.float64)).to(dtype)
    # x̂, last u, d, D̂, R̂y, R̂u, x̂s, ŷs: inputs whose QPs converge on every lane
    args = (part.params, rnd(st["x0_hat"].shape[1], 0.3), rnd(1, 0.3), rnd(nd, 0.3),
            rnd(nd * Hp, 0.3), rnd(2 * Hp, 0.5), rnd(Hp, 0.3),
            rnd(part.params["Ks"].shape[2], 0.1), rnd(2, 0.1),
            st["Z_tilde"], st["y_dual"], st["rho_rung"])
    kw = dict(qp_state=st["qp_state"], gi=fleet.gi, ry=rnd(2, 0.5), y_now=rnd(2, 0.3))
    counts = mpc_tpu_torch.utils.trace.COUNTS
    n0 = counts["grouped_products"]
    grouped = fleet._step_raw(*args, lc, **kw)
    n1 = counts["grouped_products"]
    plain = fleet._step_raw(*args, lc.clone(), **kw)
    assert n1 - n0 >= 15 and counts["grouped_products"] == n1
    assert len(seen) == 2
    for a, b in zip(seen[0], seen[1]):
        _close(a, b, rtol)
    # u, Z̃, F, objective, each lane's QP converged on both (a lane at the
    # iteration cap would stop at another iterate for any change of rounding)
    assert grouped[3].all() and plain[3].all()
    for i in (0, 1, 4, 5):
        _close(grouped[i], plain[i], rtol)


@pytest.mark.parametrize("option", ["mesh", "grouped_chunks", "tiled"])
def test_shards_and_chunks_keep_the_lane_order_build(option):
    """A ``mesh=`` shard's and a ``grouped_chunks`` part's lane maps are not
    tiled maps: their builds take no grouped product (their parity cases are
    tests/test_torch_mesh.py); the one-part fleet's build takes all of them."""
    from mpc_tpu_torch.utils import lanes, trace
    ctrls = mpc_tpu_torch.parallel.random_cstr_controllers(4, seed=0, device=CPU)
    kw = {"mesh": dict(mesh=[CPU, "cpu"]), "grouped_chunks": dict(grouped_chunks=2),
          "tiled": {}}[option]
    fleet = BatchedLinMPC(ctrls, reps=2, device=CPU, **kw)
    tiled = [lanes.tiling(p.lane_ctrl) for p in fleet._parts]
    assert tiled == ([(4, 2)] if option == "tiled" else [None, None])
    n0 = trace.COUNTS["grouped_products"]
    rng = np.random.default_rng(0)
    fleet.step(rng.normal(size=(8, 2)), rng.normal(size=(8, 2)))
    assert (trace.COUNTS["grouped_products"] > n0) == (option == "tiled")
