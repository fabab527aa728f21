"""QPs beyond a kernel block's shared memory: the port against mpc_tpu.

Each QP here is one that neither Hopper kernel can hold in the shared
memory of one block (232,448 bytes on an H100), so on the card both take
their staged (sweep) or split (GI) layout; the reference, whose solvers are
XLA loops, has no
such limit.  The same controllers and inputs, made from a seed with numpy,
go through ``mpc_tpu`` in float64 (the suite's x64) and through
``mpc_tpu_torch`` on ``device="cpu"`` (the kernels' plain versions):

* one 8x8 LinMPC of bench.py's ``_large_plant_controllers`` at Hp=20
  (n=33, m=737; GI with 33 slots needs 247,888 bytes, ADMM 232,864) in
  ``sim`` for 10 periods, with GI and with ADMM: u to 1e-6 and the QP
  iteration count of every period equal;
* a ``BatchedLinMPC`` of 2 such controllers x 2 replicas in closed loop,
  GI and ADMM: u to 1e-6;
* examples/mhe_estimation.py's ``MovingHorizonEstimator`` (tf(3, [10, 1]),
  ``nint_ym=[1]``, x̂ ≥ 0) at He=40 (n=82, m=202, 82 slots: 307,600 bytes)
  for 45 periods: x̂ to 1e-9·(1 + max|x̂|), the MHE GI bar of PERF.md §2.

The kernels themselves at these shapes are held to their plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py (phase 37).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.parallel import BatchedLinMPC as RefFleet
from mpc_tpu.parallel import estimator_params
from mpc_tpu_torch.ops import admm_kernel, gi_kernel
from mpc_tpu_torch.ops._build import HOPPER_SMEM_OPTIN
from mpc_tpu_torch.parallel import BatchedLinMPC

torch.set_num_threads(1)

CPU = torch.device("cpu")
U_TOL = 1e-6      # u, as the port's LinMPC and fleet parity tests
X_TOL = 1e-9      # MHE x̂ with GI: 1e-9·(1 + max|x̂|)


def large_controller(pkg, qp_solver, Hp=20, seed=0, gi_max_active=None):
    """bench.py::_large_plant_controllers' first plant: a stable 8x8 MIMO
    plant, Hc=4, soft y bounds (Cwt=1e3), hard u and Δu bounds."""
    nio = 8
    rng = np.random.default_rng(seed)
    A = np.diag(rng.uniform(0.45, 0.8, nio)) + rng.normal(size=(nio, nio)) * 0.02
    A *= min(1.0, 0.85 / np.max(np.abs(np.linalg.eigvals(A))))
    Bu = rng.normal(size=(nio, nio)) * 0.5 + np.eye(nio)
    model = pkg.LinModel(pkg.ss(A, Bu, np.eye(nio), np.zeros((nio, nio)), 2.0), 2.0)
    kw = {"device": CPU} if pkg is mt else {}
    c = pkg.LinMPC(model, Hp=Hp, Hc=4, Mwt=np.ones(nio), Nwt=np.full(nio, 1.0),
                   Cwt=1e3, qp_solver=qp_solver, gi_max_active=gi_max_active, **kw)
    c.setconstraint(umin=np.full(nio, -10.0), umax=np.full(nio, 10.0),
                    dumin=np.full(nio, -4.0), dumax=np.full(nio, 4.0),
                    ymin=np.full(nio, -60.0), ymax=np.full(nio, 60.0))
    return c


def test_the_shapes_exceed_a_block():
    """Neither kernel's one-lane block of these QPs fits the budget."""
    c = large_controller(mt, "active_set")
    n, m = c.n_qp, c.A_stack.shape[0]
    assert (n, m) == (33, 737)
    assert gi_kernel.smem_bytes(n, m, 33, 8, 8) == 247888 > HOPPER_SMEM_OPTIN
    assert admm_kernel.smem_bytes(n, m, 8, 1, True) == 232864 > HOPPER_SMEM_OPTIN
    assert gi_kernel.smem_bytes(82, 202, 82, 8, 8) == 307600 > HOPPER_SMEM_OPTIN


@pytest.mark.parametrize("qp_solver", ["active_set", "admm"])
def test_sim_of_an_8x8_hp20_controller_matches_reference(qp_solver):
    """``sim`` of one controller, 10 periods to a setpoint that saturates
    some inputs: u to 1e-6 and the QP iterations of every period equal."""
    ry = np.random.default_rng(2).normal(size=8) * 4.0
    runs = {}
    for pkg in (mr, mt):
        c = large_controller(pkg, qp_solver)
        iters, move = [], c.moveinput

        def counted(*a, _move=move, _c=c, _iters=iters, **kw):
            u = _move(*a, **kw)
            _iters.append(int(_c.getinfo()["iters"]))
            return u
        c.moveinput = counted
        res = pkg.sim(c, 10, ry)
        runs[pkg] = (np.asarray(res.U_data), iters)
    (u_r, it_r), (u_p, it_p) = runs[mr], runs[mt]
    assert u_p.shape == u_r.shape == (10, 8)
    assert np.abs(u_p - u_r).max() < U_TOL
    assert np.abs(u_r).max() > 9.9          # an input bound is active
    assert it_p == it_r and len(it_p) == 10


@pytest.mark.parametrize("qp_solver", ["active_set", "admm"])
def test_fleet_of_8x8_hp20_controllers_matches_reference(qp_solver):
    """A BatchedLinMPC of 2 controllers x 2 replicas (B=4, float64) from the
    reference controllers' params, 6 closed-loop periods with true plants,
    rotating setpoints and measurement noise: u to 1e-6 and the same
    converged count."""
    ctrls = [large_controller(mr, qp_solver, seed=s) for s in (0, 1)]
    ref = RefFleet(ctrls, reps=2)
    ep = estimator_params(ctrls)
    eps = [{k: v[i] for k, v in ep.items()} for i in range(len(ctrls))]
    port = BatchedLinMPC.from_params([c.params for c in ctrls], eps, reps=2,
                                     dtype=torch.float64,
                                     gi_max_active=ctrls[0].gi_max_active, device=CPU)
    A = np.stack([c.estim.model.A for c in ctrls] * 2)
    Bu = np.stack([c.estim.model.Bu for c in ctrls] * 2)
    rng = np.random.default_rng(3)
    phases = [(rng.normal(size=(4, 8)) * 0.1, rng.normal(size=(4, 8)) * 4.0)
              for _ in range(3)]
    xr = xp = np.zeros((4, 8))
    for k in range(6):
        noise, ry = phases[k % 3]
        u_r, nc_r = ref.step(jnp.asarray(xr + noise), jnp.asarray(ry))
        u_p, nc_p = port.step(xp + noise, ry)
        u_r, u_p = np.asarray(u_r), u_p.numpy()
        assert np.abs(u_p - u_r).max() < U_TOL, k
        assert int(nc_p) == int(nc_r) == 4, k
        xr = np.einsum("bij,bj->bi", A, xr) + np.einsum("bij,bj->bi", Bu, u_r)
        xp = np.einsum("bij,bj->bi", A, xp) + np.einsum("bij,bj->bi", Bu, u_p)


def test_mhe_he40_matches_reference():
    """examples/mhe_estimation.py's estimator at He=40, 45 periods (the
    window fills at period 40) of the plant's response to u = 1 with an
    unmeasured output step at period 20 and noise: x̂ after every
    ``preparestate`` and ``updatestate`` to 1e-9·(1 + max|x̂|)."""
    est = {}
    for pkg in (mr, mt):
        model = pkg.LinModel(pkg.tf(3, [10, 1]), 1.0)
        kw = {"device": CPU} if pkg is mt else {}
        e = pkg.MovingHorizonEstimator(model, He=40, sigmaQ=[0.1], sigmaR=[0.5],
                                       nint_ym=[1], **kw)
        e.setconstraint(xhatmin=[0.0] + [-np.inf] * (e.nx_hat - 1))
        est[pkg] = e
    plant = mr.LinModel(mr.tf(3, [10, 1]), 1.0)
    rng = np.random.default_rng(0)
    rel = lambda a, b: np.abs(a - b).max() / (1.0 + np.abs(b).max())
    for k in range(45):
        y = plant.evaloutput() + (0.8 if k >= 20 else 0.0) + 0.05 * rng.normal(1)
        xr, xp = est[mr].preparestate(y), est[mt].preparestate(y)
        assert rel(np.asarray(xp), np.asarray(xr)) < X_TOL, ("preparestate", k)
        xr, xp = est[mr].updatestate([1.0], y), est[mt].updatestate([1.0], y)
        assert rel(np.asarray(xp), np.asarray(xr)) < X_TOL, ("updatestate", k)
        plant.updatestate([1.0])
    assert est[mt].nx_hat * 41 == 82
