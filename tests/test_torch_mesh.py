"""The port's lane sharding (``mesh=``) and ``grouped_chunks`` against mpc_tpu.

Every sharded case builds the ``mpc_tpu`` object on a 4-device JAX CPU mesh
(tests/conftest.py provides 8 virtual devices) and the port's with
``mesh=["cpu"] * 4`` (a repeated device: four shards, one after another on
the CPU) from the same arguments, and runs both on the same inputs.  Bars:
those of the unsharded parity tests of each object (u to 1e-6 for the
linear fleet with equal converged counts and iteration statistics; 1e-8
(GI) for the NonLinMPC fleet; 1e-9 for the MHE fast path; 1e-9 (GI) and
1e-6 (ADMM) for the compiled loops, 1e-7 for the SL loop), and the port's
sharded run against its own unsharded run to 1e-12·(1 + max|·|).  The
``grouped_chunks`` cases hold a chunked fleet to the reference's chunked
fleet and to the port with one chunk.  This is the counterpart of
``__graft_entry__.dryrun_multichip``'s four pipelines that have a port
API (the SLMPC fleet step takes no mesh in either package).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu import sim_compiled as rs
from mpc_tpu.parallel import BatchedLinMPC as RefFleet
from mpc_tpu.parallel import BatchedMHE as RefMHE
from mpc_tpu.parallel import BatchedNonLinMPC as RefNonLin
from mpc_tpu.parallel import estimator_params, random_cstr_controllers
from mpc_tpu_torch import sim_compiled as ps
from mpc_tpu_torch.parallel import BatchedLinMPC, BatchedMHE, BatchedNonLinMPC
from mpc_tpu_torch.parallel.mesh import LaneShards, mesh_devices

from test_torch_batch_mhe import siso
from test_torch_batch_nonlin import bench
from test_torch_sim_compiled import mk
from test_torch_sim_compiled_nonlin import slmpc

torch.set_num_threads(1)
CPU = torch.device("cpu")
PORT_MESH = ["cpu"] * 4


@pytest.fixture(scope="module")
def ref_mesh():
    return Mesh(np.array(jax.devices()[:4]), ("batch",))


def rel(a, b, tol, what=""):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape, what
    err = np.max(np.abs(a - b), initial=0.0)
    assert err <= tol * (1.0 + np.max(np.abs(b), initial=0.0)), (what, err)


def port_fleet(ctrls, reps, share, **kw):
    ep = estimator_params(ctrls)
    eps = [{k: v[i] for k, v in ep.items()} for i in range(len(ctrls))]
    return BatchedLinMPC.from_params([c.params for c in ctrls], eps, reps=reps,
                                     share_params=share, device=CPU,
                                     gi_max_active=ctrls[0].gi_max_active, **kw)


def lin_inputs(B, K, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(K, B, 2)) * 0.5, 2.0 + rng.normal(size=(K, B, 2))


def lin_layout(layout, qp):
    if layout == "distinct":
        return random_cstr_controllers(4, seed=0, qp_solver=qp), 2, False
    return random_cstr_controllers(1, seed=2, qp_solver=qp), 8, True


def drive_lin(ref, fleets, ym, ry, K_multi=3):
    """``step`` over the first periods, one ``multistep`` over the last
    ``K_multi``: u, n_conv and last_iters of the reference and each fleet."""
    outs = []
    n = len(ym) - K_multi
    for k in range(n):
        ur, nr = ref.step(jnp.asarray(ym[k]), jnp.asarray(ry[k]))
        outs.append([(np.asarray(ur), int(nr), np.asarray(ref.last_iters))]
                    + [tuple(x.numpy() if torch.is_tensor(x) else x
                             for x in (*f.step(ym[k], ry[k]), f.last_iters)) for f in fleets])
    Ur, Nr = ref.multistep(ym[n:], ry[n:])
    row = [(np.asarray(Ur), np.asarray(Nr), np.asarray(ref.last_iters))]
    for f in fleets:
        U, N = f.multistep(ym[n:], ry[n:])
        row.append((U.numpy(), N.numpy(), f.last_iters.numpy()))
    outs.append(row)
    return outs


@pytest.mark.parametrize("layout", ["distinct", "shared"])
@pytest.mark.parametrize("qp", ["admm", "active_set"])
def test_linmpc_fleet_matches_sharded_reference(ref_mesh, qp, layout):
    ctrls, reps, share = lin_layout(layout, qp)
    ref = RefFleet(ctrls, reps=reps, share_params=share, mesh=ref_mesh)
    sharded = port_fleet(ctrls, reps, share, mesh=PORT_MESH)
    plain = port_fleet(ctrls, reps, share)
    assert sharded.device == CPU and len(sharded._parts) == 4
    ym, ry = lin_inputs(sharded.B, 6)
    for (ur, nr, ir), (us, ns, is_), (up, np_, ip) in drive_lin(ref, [sharded, plain], ym, ry):
        rel(us, ur, 1e-6)
        assert np.array_equal(np.asarray(ns), np.asarray(nr))
        assert np.array_equal(is_, ir)
        rel(us, up, 1e-12)
        assert np.array_equal(ns, np_) and np.array_equal(is_, ip)
    st_s, st_p = sharded.state, plain.state
    for k in ("x0_hat", "Z_tilde", "y_dual", "rho_rung"):
        rel(st_s[k], st_p[k], 1e-12, k)


def test_shards_that_read_a_wrapped_range_of_configurations():
    """Shards whose lanes read configurations out of order (lanes 3..5 of
    4 distinct × 3 replicas read 3, 0, 1) gather only those, through their
    own lane map, and step as the unsharded fleet; the state round-trips."""
    ctrls = mt.parallel.random_cstr_controllers(4, seed=0, device=CPU)
    sharded = BatchedLinMPC(ctrls, reps=3, device=CPU, mesh=PORT_MESH)
    plain = BatchedLinMPC(ctrls, reps=3, device=CPU)
    part = sharded._parts[1]
    assert part.params["H"].shape[0] == 3 and part.lane_ctrl.tolist() == [2, 0, 1]
    ym, ry = lin_inputs(12, 3, seed=4)
    for k in range(3):
        (us, ns), (up, np_) = sharded.step(ym[k], ry[k]), plain.step(ym[k], ry[k])
        rel(us, up, 1e-12)
        assert int(ns) == int(np_)
    sharded.state = plain.state
    (us, _), (up, _) = sharded.step(ym[0], ry[0]), plain.step(ym[0], ry[0])
    rel(us, up, 1e-12)


@pytest.mark.parametrize("layout", ["distinct", "shared"])
@pytest.mark.parametrize("qp", ["admm", "active_set"])
def test_grouped_chunks_match_reference(qp, layout):
    """grouped_chunks=2 on 4 distinct × 2 replicas, and on a shared fleet
    of 8 lanes: the reference's chunked fleet and the port with one chunk
    give the same answers; with ADMM the chunks are separate solves."""
    ctrls, reps, share = lin_layout(layout, qp)
    ref = RefFleet(ctrls, reps=reps, share_params=share, grouped_chunks=2)
    chunked = port_fleet(ctrls, reps, share, grouped_chunks=2)
    plain = port_fleet(ctrls, reps, share)
    assert len(chunked._parts) == (2 if qp == "admm" else 1)
    ym, ry = lin_inputs(chunked.B, 6, seed=2)
    for (ur, nr, ir), (uc, nc, ic), (up, np_, ip) in drive_lin(ref, [chunked, plain], ym, ry):
        rel(uc, ur, 1e-6)
        assert np.array_equal(np.asarray(nc), np.asarray(nr))
        assert np.array_equal(ic, ir)
        rel(uc, up, 1e-12)
        assert np.array_equal(nc, np_) and np.array_equal(ic, ip)


def test_nonlin_fleet_matches_sharded_reference(ref_mesh):
    B, K = 4, 4
    fr = RefNonLin(bench(mr, Hp=6), B, mesh=ref_mesh)
    fs = BatchedNonLinMPC(bench(mt, Hp=6), B, mesh=PORT_MESH)
    fp = BatchedNonLinMPC(bench(mt, Hp=6), B)
    rng = np.random.default_rng(0)
    ym = (np.linspace(-20, 20, B)[None, :, None] + rng.normal(size=(K, B, 1)))
    ry = np.full((K, B, 1), 180.0)
    for k in range(2):
        ur, Jr = fr.step(jnp.asarray(ym[k]), jnp.asarray(ry[k]))
        (us, Js), (up, Jp) = fs.step(ym[k], ry[k]), fp.step(ym[k], ry[k])
        rel(us, ur, 1e-8)
        rel(Js, Jr, 1e-8)
        rel(fs.last_kkt, fr.last_kkt, 1e-8)
        assert np.array_equal(fs.last_iters.numpy(), np.asarray(fr.last_iters))
        rel(us, up, 1e-12)
        assert torch.equal(fs.last_iters, fp.last_iters)
    Us, _ = fs.multistep(ym[2:], ry[2:])
    Up, _ = fp.multistep(ym[2:], ry[2:])
    rel(Us, Up, 1e-12)
    for key in ("x0_hat", "P_hat", "Z_tilde"):
        rel(fs.state[key], fp.state[key], 1e-12, key)


@pytest.mark.parametrize("mode", ["step", "multistep"])
def test_mhe_fleet_matches_sharded_reference(ref_mesh, mode):
    B, N = 4, 6
    fr = RefMHE(siso(mr, He=3), B, mesh=ref_mesh)
    fs = BatchedMHE(siso(mt, He=3), B, mesh=PORT_MESH)
    fp = BatchedMHE(siso(mt, He=3), B)
    rng = np.random.default_rng(5)
    ym = rng.normal(size=(N, B, 1)) * 0.3
    u = rng.normal(size=(N, B, 1)) * 0.2
    if mode == "step":
        for k in range(N):
            xr, xs, xp = (f.step(ym[k], u[k]) for f in (fr, fs, fp))
            rel(xs.numpy(), np.asarray(xr), 1e-9, k)
            rel(xs.numpy(), xp.numpy(), 1e-12, k)
            assert np.array_equal(fs.last_ok.numpy(), np.asarray(fr.last_ok))
            assert int(fs.last_pivots) == int(fp.last_pivots)
    else:
        Xr, Xs, Xp = (f.multistep(ym, u) for f in (fr, fs, fp))
        rel(Xs.numpy(), np.asarray(Xr), 1e-9)
        rel(Xs.numpy(), Xp.numpy(), 1e-12)
    assert fs.Nk == fp.Nk == 3
    rel(fs.state["Z"].numpy(), fp.state["Z"].numpy(), 1e-12)


@pytest.mark.parametrize("qp", ["admm", "active_set"])
def test_compiled_loop_run_fleet_matches_sharded_reference(ref_mesh, qp):
    kw = dict(ry=[5.0, 1.0], y_noise=[0.1, 0.1], seed=0)
    ref = rs.CompiledClosedLoop(mk(mr, qp_solver=qp)).run_fleet(8, 6, mesh=ref_mesh, **kw)
    loop = ps.CompiledClosedLoop(mk(mt, qp_solver=qp))
    sharded = loop.run_fleet(8, 6, mesh=PORT_MESH, **kw)
    plain = loop.run_fleet(8, 6, **kw)
    tol = 1e-9 if qp == "active_set" else 1e-6
    for k in ("Y", "U", "Y_est", "X", "X_hat"):
        rel(sharded[k], ref[k], tol, k)
        rel(sharded[k], plain[k], 1e-12, k)
    assert np.array_equal(sharded["conv"], np.asarray(ref["conv"]))


def test_sl_loop_run_fleet_matches_sharded_reference(ref_mesh):
    kw = dict(ry=[170.0], y_noise=[0.5], seed=1)
    ref = rs.CompiledSLLoop(slmpc(mr)).run_fleet(4, 5, mesh=ref_mesh, **kw)
    loop = ps.CompiledSLLoop(slmpc(mt))
    sharded = loop.run_fleet(4, 5, mesh=PORT_MESH, **kw)
    plain = loop.run_fleet(4, 5, **kw)
    for k in ("Y", "U", "X", "X_hat"):
        rel(sharded[k], ref[k], 1e-7, k)
        rel(sharded[k], plain[k], 1e-12, k)
    assert np.array_equal(sharded["conv"], np.asarray(ref["conv"]))


@pytest.mark.parametrize("case", ["entry", "not_a_sequence", "uneven", "grouped_chunks",
                                  "gi_chunks"])
def test_mesh_errors(case):
    ctrls = mt.parallel.random_cstr_controllers(2, seed=0, device=CPU)
    if case == "entry":
        with pytest.raises(TypeError, match="mesh entries"):
            BatchedLinMPC(ctrls, reps=2, device=CPU, mesh=["cpu", 0])
    elif case == "not_a_sequence":
        for bad in (object(), "cpu", []):
            with pytest.raises(TypeError, match="mesh"):
                mesh_devices(bad)
    elif case == "uneven":
        with pytest.raises(ValueError, match="evenly"):
            BatchedLinMPC(ctrls, reps=3, device=CPU, mesh=["cpu"] * 4)
    elif case == "grouped_chunks":
        with pytest.raises(ValueError, match="grouped_chunks"):
            BatchedLinMPC(ctrls, reps=2, device=CPU, mesh=["cpu"] * 2, grouped_chunks=2)
    else:
        with pytest.raises(ValueError, match="gi_chunks"):
            BatchedMHE(siso(mt), 4, mesh=["cpu"] * 2, gi_chunks=2)


def test_lane_shards_split_gather_psum():
    """Contiguous shards; a view on the same device, the host array's own
    slices for a NumPy input; gather is the inverse of split; psum sums on
    mesh[0]."""
    sh = LaneShards(["cpu", CPU], 6)
    x = torch.arange(12.0).reshape(6, 2)
    parts = sh.split(x)
    assert [p.shape[0] for p in parts] == [3, 3]
    assert parts[1].data_ptr() == x[3:].data_ptr()
    assert torch.equal(sh.gather(parts), x)
    y = torch.arange(12.0).reshape(2, 6)
    assert torch.equal(sh.gather(sh.split(y, 1), 1), y)
    h = np.arange(6.0)
    assert all(isinstance(p, np.ndarray) and p.base is h for p in sh.split(h))
    assert int(sh.psum([torch.tensor(2), torch.tensor(3)])) == 5
    made = sh.per_device(lambda d: object())
    assert made[0] is made[1]          # one call for the repeated device
