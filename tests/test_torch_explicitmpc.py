"""The port's ExplicitMPC and BatchedExplicitMPC against mpc_tpu's.

Both packages build the controllers from the same transfer functions and
get the same seeded measurements; the port runs in float64 on the CPU.
Bars: u, Z̃ and the getinfo arrays to 1e-9·(1 + max|·|) (the same analytic
solve with the same Newton-refined host inverse).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.parallel import BatchedExplicitMPC as RefFleet
from mpc_tpu_torch.parallel import BatchedExplicitMPC
from test_torch_nonlin import CPU, close

torch.set_num_threads(1)


def rel(a, b, tol=1e-9):
    a, b = np.asarray(a, float), np.asarray(b, float)
    close(a, b, tol * (1.0 + np.max(np.abs(b), initial=0.0)))


def two_by_two(pkg, seed):
    """tests/test_batch.py:333-346: a randomized 2x2 plant."""
    g = np.random.default_rng(seed).uniform(0.8, 1.6, size=4) * [1.9, 1.9, -0.74, 0.74]
    G = pkg.tf_matrix([[pkg.tf(g[0], [18, 1]), pkg.tf(g[1], [18, 1])],
                       [pkg.tf(g[2], [8, 1]), pkg.tf(g[3], [8, 1])]])
    return pkg.LinModel(G, 2.0)


def explicit(pkg, model, **kw):
    return pkg.ExplicitMPC(model, **kw, **({} if pkg is mr else {"device": CPU}))


def yop10(pkg):
    m = pkg.LinModel(pkg.tf(5, [2, 1]), 3.0)
    m.setop(yop=[10.0])
    return m


@pytest.mark.parametrize("case", ["2x2", "internal_model", "disturbance"])
def test_closed_loop_matches_reference(case):
    """test_linmpc.py:41-53 (2x2 plant), test_reference_parity.py:419-431
    (InternalModel, offset-free) and a measured disturbance."""
    if case == "2x2":
        make = lambda pkg: explicit(pkg, two_by_two(pkg, 0), Hp=15, Hc=3, Mwt=[1, 1],
                                    Nwt=[0.1, 0.1])
        ry, d = [1.0, -0.5], None
    elif case == "internal_model":
        make = lambda pkg: explicit(pkg, pkg.InternalModel(yop10(pkg)))
        ry, d = [15.0], None
    else:
        def make(pkg):
            G = pkg.tf_matrix([[pkg.tf(3, [10, 1]), pkg.tf(1, [5, 1])]])
            return explicit(pkg, pkg.LinModel(G, 1.0, i_d=[1]), Hp=10, Hc=2)
        ry, d = [2.0], [0.5]
    cr, cp = make(mr), make(mt)
    rng = np.random.default_rng(1)
    for k in range(8):
        y = rng.normal(size=len(ry)) + (10.0 if case == "internal_model" else 0.0)
        for c in (cr, cp):
            c.preparestate(y, d)
        ur, up = cr.moveinput(ry, d), cp.moveinput(ry, d)
        rel(ur, up)
        ir, ip = cr.getinfo(), cp.getinfo()
        for key in ("DeltaU", "U", "Yhat", "J", "xhat", "yhat"):
            rel(ir[key], ip[key])
        for c in (cr, cp):
            c.updatestate(ur, y, d)
    rel(cr.Z_tilde, cp.Z_tilde)


def test_moves_getinfo_and_setmodel():
    """test_reference_parity.py:400-418 and the weight and model swaps."""
    e = explicit(mt, yop10(mt), Nwt=[0], Hp=1000, Hc=1)
    e.preparestate([10.0])
    np.testing.assert_allclose(e.moveinput([15.0]), [1.0], atol=1e-2)
    u = e([15.0], lastu=[-1.0])
    np.testing.assert_allclose(u, [1.0], atol=1e-2)
    np.testing.assert_allclose(e.getinfo()["u"], u, atol=1e-9)
    e3 = explicit(mt, yop10(mt), Mwt=[0], Nwt=[0], Lwt=[1])
    e3.preparestate([10.0])
    np.testing.assert_allclose(e3.moveinput([0.0], R_hat_u=np.full(e3.Hp, 12.0)), [12.0],
                               atol=1e-2)
    cs = {}
    for pkg in (mr, mt):
        c = explicit(pkg, pkg.LinModel(pkg.tf(3, [10, 1]), 1.0), Hp=10, Hc=2)
        c.setmodel(Mwt=[3.0], Nwt=[0.5])
        c.setmodel(pkg.LinModel(pkg.tf(2, [5, 1]), 1.0))
        c.preparestate([0.3])
        cs[pkg] = c.moveinput([1.0])
    rel(cs[mr], cs[mt])
    with pytest.raises(NotImplementedError):
        e.setconstraint(umax=[1.0])
    with pytest.raises(ValueError):
        explicit(mt, yop10(mt), Hp=0, Hc=1)
    with pytest.raises(TypeError, match="LinModel"):
        mt.ExplicitMPC(mt.NonLinModel(lambda x, u, d, p: x + u, lambda x, d, p: x, 1.0,
                                      1, 1, 1, solver=None, device=CPU), device=CPU)
    assert "ExplicitMPC controller" in repr(e)


def test_fleet_matches_reference_and_singles():
    """tests/test_batch.py:328-367: 3 distinct plants x 2 replicas, lane
    r·n_d + c ≡ controller c driven alone and ≡ the reference's fleet."""
    n_d, reps = 3, 2
    mk = lambda pkg: [explicit(pkg, two_by_two(pkg, s), Hp=8, Hc=2, Mwt=[1, 1],
                               Nwt=[0.1, 0.1]) for s in range(n_d)]
    ref = RefFleet(mk(mr), reps=reps)
    bat = BatchedExplicitMPC(mk(mt), reps=reps, device=CPU)
    singles = {(r, c): mk(mt)[c] for r in range(reps) for c in range(n_d)}
    rng = np.random.default_rng(7)
    for k in range(4):
        ym = rng.normal(size=(bat.B, 2)) * 0.5
        ry = rng.normal(size=(bat.B, 2)) * 1.5
        u_b = bat.step(ym, ry).numpy()
        rel(np.asarray(ref.step(jnp.asarray(ym), jnp.asarray(ry))), u_b)
        for (r, c), s in singles.items():
            lane = r * n_d + c
            s.preparestate(ym[lane])
            u_s = s.moveinput(ry[lane])
            s.updatestate(u_s, ym[lane])
            rel(u_s, u_b[lane])


def test_fleet_options():
    ctrls = [explicit(mt, two_by_two(mt, 0), Hp=8, Hc=2),
             explicit(mt, two_by_two(mt, 1), Hp=6, Hc=2)]
    with pytest.raises(ValueError, match="homogeneous"):
        BatchedExplicitMPC(ctrls, device=CPU)
    f32 = BatchedExplicitMPC(ctrls[:1], reps=4, dtype=torch.float32, device=CPU)
    u = f32.step(np.zeros((4, 2)), np.ones((4, 2)))
    assert u.dtype == torch.float32 and u.shape == (4, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            BatchedExplicitMPC(ctrls[:1])
