"""The plain reference: its exact QP solve, its condensed QPs and Kalman
gains against hand-built answers, and its closed loop against the port
run in float64 on the CPU."""
import warnings

import numpy as np
import scipy.linalg as sla
import torch

from benchmark import qp_ref, registry
from benchmark.kinds import linmpc_fleet, slmpc_fleet

SPEC = registry.benchmark_spec()
CSTR = registry.config_file(SPEC, "cstr-fleet")
PEND = registry.config_file(SPEC, "pendulum-sl")
f64 = torch.float64


def test_bench_qp_box_problem_has_the_clipped_answer():
    g = torch.Generator().manual_seed(1)
    L, n = 16, 4
    p = torch.rand(L, n, generator=g, dtype=f64) + 0.5
    q = torch.randn(L, n, generator=g, dtype=f64) * 3
    lo, hi = -torch.rand(L, n, generator=g, dtype=f64), torch.rand(L, n, generator=g, dtype=f64)
    eye = torch.eye(n, dtype=f64)
    G = torch.cat([eye, -eye]).expand(L, 2 * n, n)
    x, kkt = qp_ref.solve(torch.diag_embed(p), q, G, torch.cat([hi, -lo], -1))
    assert torch.allclose(x, torch.clamp(-q / p, lo, hi), atol=1e-10)
    assert float(kkt.max()) < 1e-9


def test_bench_qp_one_halfspace_is_a_projection():
    a = torch.tensor([[[1.0, 2.0, -2.0]]], dtype=f64)
    x, _ = qp_ref.solve(torch.eye(3, dtype=f64)[None], torch.zeros(1, 3, dtype=f64), a,
                        torch.tensor([[-3.0]], dtype=f64))
    assert torch.allclose(x[0], -3.0 * a[0, 0] / 9.0, atol=1e-12)


def test_bench_cholesky_pieces_match_torch():
    g = torch.Generator().manual_seed(2)
    R = torch.randn(8, 5, 5, generator=g, dtype=f64)
    M = R @ R.mT + torch.eye(5, dtype=f64)
    L = qp_ref.cholesky(M)
    assert torch.allclose(L, torch.linalg.cholesky(M), atol=1e-12)
    b = torch.randn(8, 5, generator=g, dtype=f64)
    assert torch.allclose(qp_ref.cholesky_solve(L, b), torch.linalg.solve(M, b), atol=1e-10)


def one_plant(seed=3):
    G, T = linmpc_fleet.draw_plants({**CSTR, "n_distinct": 1}, seed)
    return G[0], T[0]


def test_bench_cstr_plant_keeps_each_entrys_gain():
    g, t = one_plant()
    A, Bu, Bd, C, Dd = linmpc_fleet.discrete_plant(CSTR, g, t)
    dc = C @ np.linalg.solve(np.eye(A.shape[0]) - A, np.hstack([Bu, Bd])) + np.hstack(
        [np.zeros_like(Bu[:2, :]), Dd])
    assert np.allclose(dc, g, rtol=1e-12)


def test_bench_cstr_condensed_qp_by_hand():
    g, t = one_plant()
    m = linmpc_fleet.controller_matrices(CSTR, g, t)
    Ah, Bu, Ch = m["Ah"], m["Buh"], m["Ch"]
    ny, nu = Ch.shape[0], Bu.shape[1]
    E = m["E"]
    assert np.allclose(E[:ny, :nu], Ch @ Bu)
    assert np.allclose(E[:ny, nu:], 0)
    assert np.allclose(E[ny:2 * ny, :nu], Ch @ (Ah @ Bu + Bu))
    assert np.allclose(E[ny:2 * ny, nu:], Ch @ Bu)
    for j in range(CSTR["Hp"]):
        assert np.allclose(m["Kx"][j * ny:(j + 1) * ny], Ch @ np.linalg.matrix_power(Ah, j + 1))
    Mw = np.diag(np.tile(CSTR["Mwt"], CSTR["Hp"]))
    Nw = np.diag(np.tile(CSTR["Nwt"], CSTR["Hc"]))
    assert np.allclose(m["H"][:-1, :-1], 2 * (E.T @ Mw @ E + Nw))
    assert m["H"][-1, -1] == 2 * CSTR["Cwt"]
    # the gain is the filter's: P solves the DARE, K = P Cᵀ (C P Cᵀ + R)⁻¹
    Q = np.diag(np.r_[np.full(6, 1 / 6), np.ones(2)] ** 2)
    P = sla.solve_discrete_are(Ah.T, Ch.T, Q, np.eye(2))
    assert np.allclose(m["K"], P @ Ch.T @ np.linalg.inv(Ch @ P @ Ch.T + np.eye(2)))


def test_bench_pendulum_step_jacobian_is_rk4s():
    f, _ = slmpc_fleet.pendulum(PEND)
    fd = slmpc_fleet.rk4(f, PEND["Ts"])
    x = torch.tensor([[0.3, -1.0], [3.0, 0.5]], dtype=f64)
    u = torch.tensor([[0.7], [-1.2]], dtype=f64)
    xn, J = slmpc_fleet.rk4_jac(slmpc_fleet.pendulum_jac(PEND), PEND["Ts"])(x, u)
    for b in range(2):
        Jx, Ju = torch.autograd.functional.jacobian(fd, (x[b], u[b]))
        assert torch.allclose(J[b, :, :2], Jx, atol=1e-12)
        assert torch.allclose(J[b, :, 2:], Ju, atol=1e-12)
        assert torch.allclose(xn[b], fd(x[b], u[b]))


def test_bench_pendulum_condensed_by_hand():
    ref = slmpc_fleet.Reference(PEND, "cpu")
    g = torch.Generator().manual_seed(4)
    Ah = torch.randn(2, 3, 3, generator=g, dtype=f64) * 0.5
    Bh = torch.randn(2, 3, 1, generator=g, dtype=f64)
    Ch = torch.randn(2, 1, 3, generator=g, dtype=f64)
    dx, faff = torch.randn(2, 3, generator=g, dtype=f64), torch.randn(2, 3, generator=g, dtype=f64)
    yx = torch.randn(2, 1, generator=g, dtype=f64)
    E, F = ref.condensed(Ah, Bh, Ch, dx, faff, yx)
    CB = (Ch @ Bh)[:, 0, 0]
    assert torch.allclose(E[:, 0, 0], CB) and torch.allclose(E[:, 0, 1], 0 * CB)
    assert torch.allclose(E[:, 1, 0], (Ch @ (Ah @ Bh + Bh))[:, 0, 0])
    assert torch.allclose(E[:, 1, 1], CB)
    x1 = (Ah @ dx[..., None])[..., 0] + faff
    x2 = (Ah @ x1[..., None])[..., 0] + faff
    assert torch.allclose(F[:, 0], (Ch @ x1[..., None])[:, 0, 0] + yx[:, 0])
    assert torch.allclose(F[:, 1], (Ch @ x2[..., None])[:, 0, 0] + yx[:, 0])


def closed_loop(kind, cfg, cell, periods):
    """The port in float64 on the CPU in closed loop with the world, and
    the reference over the record of its checked lanes."""
    torch.set_num_threads(2)
    tr = registry.traffic_file({"linmpc_fleet": "cstr-steps",
                                "slmpc_fleet": "pendulum-steps"}[cfg["kind"]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c = kind.Cell({**cfg, "dtype": "float64"}, cell, tr, 2**33 + 5, torch.device("cpu"))
        rec = {n: [] for n in ("ym", "ry", "d", "u")}
        for k in range(periods):
            ym, ry, d = c.measure(k)
            u, _ = c.step(ym, ry, d)
            for n, v in zip(rec, (ym, ry, d, u)):
                rec[n].append(v.index_select(0, c.check_lanes))
            c.advance(u)
    u_ref, kkt = c.reference(torch.device("cpu")).run(
        *(torch.stack(rec[n]) for n in ("ym", "ry", "d")))
    return float((torch.stack(rec["u"]) - u_ref).abs().max()), float(kkt.max())


def test_bench_cstr_reference_follows_the_port_in_float64():
    gap, kkt = closed_loop(linmpc_fleet, {**CSTR, "n_distinct": 3},
                           dict(reps=2, check_lanes_per_controller=2), 40)
    assert gap < 1e-9 and kkt < 1e-12


def test_bench_pendulum_reference_follows_the_port_in_float64():
    gap, kkt = closed_loop(slmpc_fleet, PEND, dict(lanes=6,
                                                     check_lanes=4), 40)
    # the port adds 1e-9·I to its Hessian; the reference solves the QP as stated
    assert gap < 1e-7 and kkt < 1e-10
