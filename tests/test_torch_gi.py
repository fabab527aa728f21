"""The port's Goldfarb–Idnani solve against mpc_tpu.ops.qp_active.

Same inputs, made from a seed with numpy, go through
``jax.vmap(mpc_tpu.ops.qp_active.solve_qp_active)`` (float64 under the
suite's x64) and through the port's batched ``solve_qp_active``, whose
per-lane solve takes its plain version on CPU tensors.  Both get the same
``build_gi_cache`` inverse.  Bars in float64: x to 1e-9, the same iteration
counts, the same ``converged`` and the same operator state (idx, side and
vmask equal, Ginv to 1e-9).  The CUDA kernel itself is checked by
tests/test_torch_cuda.py and chip_smoke.py on the GPU.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mpc_tpu.ops.qp_active import build_gi_cache as jax_build_gi_cache
from mpc_tpu.ops.qp_active import solve_qp_active as jax_solve_qp_active
from mpc_tpu_torch.ops._build import HOPPER_SMEM_OPTIN
from mpc_tpu_torch.ops.gi_kernel import (gi_solve, gi_solve_reference,
                                         launch_geometry, smem_bytes,
                                         split_bytes, split_plan,
                                         violation_scan_reference,
                                         workspace_bytes)
from mpc_tpu_torch.ops.qp_active import (build_gi_cache, gi_state_init,
                                         solve_qp_active)

torch.set_num_threads(1)

BIG = 1e20


def random_qp(rng, n, m):
    """tests/test_qp.py::random_qp (no equality rows)."""
    H = rng.normal(size=(n, n))
    P = H @ H.T + n * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    x_feas = rng.normal(size=n) * 0.1
    margin = rng.uniform(0.05, 1.0, size=m)
    Ax = A @ x_feas
    one_sided = rng.random(m) < 0.3
    return P, q, A, np.where(one_sided, -BIG, Ax - margin), Ax + margin


def _stack(probs):
    return [np.stack(z) for z in zip(*probs)]


def _caches(P):
    c = [build_gi_cache(p, None)["gic_Pinv"] for p in P]
    ref = jax_build_gi_cache(P[0], None)["gic_Pinv"]
    assert np.array_equal(np.asarray(ref), c[0])
    return np.stack(c)


def _solve_both(P, q, A, l, u, y0=None, state0=None, iter_budget=None,
                max_active=None, lane_ctrl=None, dtype=np.float64,
                slot_dtype=None, cached=True):
    """Reference (vmapped, per-lane copies) and port (stacked per
    controller, read through lane_ctrl) on the same numpy inputs; with
    ``cached=False`` both compute P⁻¹ in the solve."""
    Pinv = _caches(P)
    lc = np.arange(q.shape[0]) if lane_ctrl is None else np.asarray(lane_ctrl)
    per_lane = lambda a: jnp.asarray(a[lc].astype(dtype))
    lane = lambda a: jnp.asarray(np.asarray(a).astype(dtype))
    kw = dict(iter_budget=iter_budget, max_active=max_active)

    def one(P_, q_, A_, l_, u_, Pinv_, y0_, s0_):
        return jax_solve_qp_active(P_, q_, A_, l_, u_, y0_,
                                   cache=dict(gic_Pinv=Pinv_) if cached else None,
                                   state0=s0_, **kw)

    args = [per_lane(P), lane(q), per_lane(A), lane(l), lane(u),
            jnp.asarray(Pinv[lc])]
    in_axes = [0] * 6
    for extra in (y0, state0):
        if extra is None:
            args.append(None)
            in_axes.append(None)
        else:
            args.append(lane(extra) if not isinstance(extra, dict) else
                        {k: jnp.asarray(v) for k, v in extra.items()})
            in_axes.append(0)
    ref = jax.vmap(one, in_axes=in_axes)(*args)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    t = lambda a: torch.tensor(np.asarray(a)).to(tdt)
    got = solve_qp_active(
        t(P), t(q), t(A), t(l), t(u),
        None if y0 is None else t(y0), lane_ctrl=torch.tensor(lc, dtype=torch.int32)
        if lane_ctrl is not None else None,
        cache=dict(gic_Pinv=torch.tensor(Pinv)) if cached else None,
        state0=None if state0 is None else {k: torch.tensor(np.asarray(v))
                                             for k, v in state0.items()},
        slot_dtype=slot_dtype, **kw)
    return ref, got


def _assert_same(ref, got, tol=1e-9):
    assert np.array_equal(np.asarray(ref.iters), got.iters.numpy())
    assert np.array_equal(np.asarray(ref.converged), got.converged.numpy())
    x_r = np.asarray(ref.x, np.float64)
    assert np.max(np.abs(x_r - got.x.double().numpy())) < tol
    for k in ("gis_idx", "gis_side", "gis_vmask"):
        assert np.array_equal(np.asarray(ref.gi_state[k]),
                              got.gi_state[k].numpy()), k
    G_r = np.asarray(ref.gi_state["gis_Ginv"])
    assert G_r.dtype == got.gi_state["gis_Ginv"].numpy().dtype
    assert np.max(np.abs(G_r - got.gi_state["gis_Ginv"].numpy())) < tol


@pytest.mark.parametrize("seed,n,m", [(17, 4, 12), (18, 8, 29), (19, 2, 3),
                                      (20, 6, 24)])
def test_random_qps_match_reference(seed, n, m):
    """The tests/test_qp.py random-QP batches, one QP per lane, cold."""
    rng = np.random.default_rng(seed)
    P, q, A, l, u = _stack([random_qp(rng, n, m) for _ in range(8)])
    ref, got = _solve_both(P, q, A, l, u)
    assert np.asarray(ref.converged).all()
    _assert_same(ref, got)
    assert np.max(np.abs(np.asarray(ref.y) - got.y.numpy())) < 1e-9
    assert np.max(np.abs(np.asarray(ref.obj) - got.obj.numpy())) < 1e-9
    assert (got.rung == 4).all()


@pytest.mark.parametrize("seed,n,m,dtype,warm", [
    (50, 6, 24, np.float64, False), (51, 8, 29, np.float64, True),
    (52, 10, 24, np.float64, False), (53, 12, 30, np.float64, True),
    (54, 4, 10, np.float32, False), (55, 12, 30, np.float32, False)],
    ids=["gj-n6", "gj-n8-warm", "chol-n10", "chol-n12-warm", "gj-n4-f32",
         "chol-n12-f32"])
def test_uncached_matches_reference(seed, n, m, dtype, warm):
    """No cache: P⁻¹ in the solve, by unrolled Gauss–Jordan in the slot
    dtype for n ≤ 8 and by a Cholesky solve in the data dtype, cast to the
    slot dtype, above.  float64: x to 1e-9, the same pivots (iterations),
    flags and operator state.  float32 data (f64 slots, the reference's
    mixed mode): the same iterations and flags, x to 1e-5·(1 + max|x|)."""
    rng = np.random.default_rng(seed)
    P, q, A, l, u = _stack([random_qp(rng, n, m) for _ in range(8)])
    y0 = None
    if warm:
        cold, _ = _solve_both(P, q, A, l, u, cached=False)
        y0 = np.asarray(cold.y) + 0.3 * rng.normal(size=l.shape) * (rng.random(l.shape) < 0.2)
    ref, got = _solve_both(P, q, A, l, u, y0=y0, dtype=dtype, cached=False)
    assert np.asarray(ref.converged).all()
    if dtype == np.float64:
        _assert_same(ref, got)
        return
    x_r = np.asarray(ref.x, np.float64)
    assert np.array_equal(np.asarray(ref.converged), got.converged.numpy())
    assert np.array_equal(np.asarray(ref.iters), got.iters.numpy())
    assert np.max(np.abs(x_r - got.x.double().numpy())) < 1e-5 * (1 + np.abs(x_r).max())


def test_unconstrained_and_shared_controller():
    """Loose bounds give the unconstrained minimum; a batch of right-hand
    sides on ONE controller (lane_ctrl all 0) matches the vmapped solve."""
    rng = np.random.default_rng(29)
    n, m, B = 4, 7, 8
    P, q, A, l, u = random_qp(rng, n, m)
    loose = _solve_both(P[None], q[None], A[None], np.full((1, m), -BIG),
                        np.full((1, m), BIG))
    _assert_same(*loose)
    assert np.allclose(loose[1].x[0].numpy(), -np.linalg.solve(P, q), atol=1e-10)
    qs = rng.normal(size=(B, n))
    ref, got = _solve_both(P[None], qs, A[None], np.tile(l, (B, 1)),
                           np.tile(u, (B, 1)), lane_ctrl=np.zeros(B, int))
    _assert_same(ref, got)


def test_dual_warm_start_and_junk_duals():
    """y0 from a cold solve (the warm loop inserts the active rows, jumps to
    the KKT point) and junk y0 (wrong-sign drops, then pivots)."""
    rng = np.random.default_rng(31)
    P, q, A, l, u = _stack([random_qp(rng, 5, 20) for _ in range(6)])
    cold, _ = _solve_both(P, q, A, l, u)
    y_cold = np.asarray(cold.y)
    y_junk = rng.normal(size=y_cold.shape)
    y_tie = np.where(np.abs(y_cold) > 0, 1.0, 0.0) * np.sign(y_cold)  # tied |y0|
    for y0 in (y_cold, y_junk, y_tie):
        ref, got = _solve_both(P, q, A, l, u, y0=y0)
        assert np.asarray(ref.converged).all()
        _assert_same(ref, got)


def _cap_problem(rng, n, m, n_up, shift):
    M = rng.normal(size=(n, n))
    P = M @ M.T + n * np.eye(n)
    q = rng.normal(size=n) * 2
    A = rng.normal(size=(m, n))
    c = A @ np.linalg.solve(P, -q)
    l = c - np.abs(rng.normal(size=m)) - shift
    u = c + np.abs(rng.normal(size=m)) + shift
    u[:n_up] = c[:n_up] - 0.3
    l[:n_up] = u[:n_up] - 5.0
    return P, q, A, l, u


@pytest.mark.parametrize("cap", [None, 8, 3, 2, 1])
def test_max_active_cap_exact_and_too_tight(cap):
    """tests/test_qp.py:244-279: exact while the active set fits the cap,
    converged=False (after the one-shot restart) when it overflows."""
    rng = np.random.default_rng(11)
    P, q, A, l, u = _stack([_cap_problem(rng, 10, 24, k, 0.05)
                            for k in (1, 2, 3, 3)])
    ref, got = _solve_both(P, q, A, l, u, max_active=cap)
    _assert_same(ref, got)
    assert got.gi_state["gis_Ginv"].shape[1:] == (cap or 10, cap or 10)
    if cap == 1:
        assert not got.converged.all()


def test_warm_start_pollution_overflow_and_restart():
    """tests/test_qp.py:281-320: stale y0 rows fill a cap of 2, the first
    overflow spends the cold restart and the solve still converges; a
    genuinely over-cap active set reports converged=False."""
    rng = np.random.default_rng(7)
    P, q, A, l, u = _stack([_cap_problem(rng, 8, 20, 1, 1.0),
                            _cap_problem(rng, 8, 20, 4, 1.0)])
    y0 = np.zeros((2, 20))
    y0[:, 5], y0[:, 9] = 3.0, 2.5
    ref, got = _solve_both(P, q, A, l, u, y0=y0, max_active=2)
    _assert_same(ref, got)
    assert got.converged.tolist() == [True, False]


def test_infeasible_qp_certificate():
    """x₀ ≥ 1 and x₀ ≤ −1 (two rows): the dual ray certifies infeasibility
    after the restart, in both packages at the same iteration."""
    rng = np.random.default_rng(3)
    probs = []
    for _ in range(3):
        P, q, A, l, u = random_qp(rng, 4, 6)
        A[0] = A[1] = np.eye(4)[0]
        l[0], u[0] = 1.0, BIG
        l[1], u[1] = -BIG, -1.0
        probs.append((P, q, A, l, u))
    ref, got = _solve_both(*_stack(probs))
    _assert_same(ref, got)
    assert not got.converged.any()
    assert (got.iters < 150).all()          # the certificate, not the cap


def test_state_carry_over_five_periods():
    """The receding-horizon pattern: P and A fixed, q and the bounds move,
    state0 is the previous solution's gi_state — five solves in a row."""
    rng = np.random.default_rng(41)
    P, q, A, l, u = _stack([random_qp(rng, 6, 18) for _ in range(6)])
    state = None
    for k in range(5):
        qk = q + 0.3 * rng.normal(size=q.shape)
        shift = 0.05 * rng.normal(size=l.shape)
        ref, got = _solve_both(P, qk, A, l + shift, u + shift, state0=state,
                               max_active=4)
        _assert_same(ref, got)
        state = {k_: np.asarray(v) for k_, v in ref.gi_state.items()}


@pytest.mark.parametrize("budget", [1, 2, 3])
def test_iter_budget_stops_both_at_the_same_pivot(budget):
    rng = np.random.default_rng(43)
    P, q, A, l, u = _stack([random_qp(rng, 6, 24) for _ in range(6)])
    ref, got = _solve_both(P, q, A, l, u, iter_budget=budget)
    _assert_same(ref, got)
    assert int(got.iters.max()) == budget
    # a per-lane budget stops each lane at min(its budget, its own solve)
    per = np.roll(np.array([1, 2, 3, 150, 2, 1], np.int32), budget)
    t = lambda a: torch.tensor(a)
    solve = partial(solve_qp_active, t(P), t(q), t(A), t(l), t(u),
                    cache=dict(gic_Pinv=t(_caches(P))))
    free, capped = solve(), solve(iter_budget=t(per))
    assert np.array_equal(capped.iters.numpy(),
                          np.minimum(per, free.iters.numpy()))


def test_f32_data_f64_slots_matches_mixed_reference():
    """tests/test_qp.py:225-242 in float32 data: the reference under x64
    runs its mixed mode (f32 scan, f64 slots), the port's default slot
    dtype is float64.  The same iterations, converged flags and operator
    state (Ginv to 1e-9); x, returned in float32, to 1e-5·(1 + max|x|)."""
    rng = np.random.default_rng(3)
    probs = []
    for _ in range(8):
        n, m = 4, 10
        M = rng.normal(size=(n, n))
        A = rng.normal(size=(m, n))
        probs.append((M @ M.T + np.eye(n), rng.normal(size=n), A,
                      np.full(m, -0.5), np.full(m, 0.5)))
    P, q, A, l, u = _stack(probs)
    ref, got = _solve_both(P, q, A, l, u, dtype=np.float32)
    assert got.x.dtype == torch.float32
    assert got.gi_state["gis_Ginv"].dtype == torch.float64
    x_r = np.asarray(ref.x, np.float64)
    assert np.array_equal(np.asarray(ref.converged), got.converged.numpy())
    assert np.asarray(ref.converged).all()
    assert np.max(np.abs(x_r - got.x.double().numpy())) < 1e-5 * (1 + np.abs(x_r).max())
    assert np.array_equal(np.asarray(ref.iters), got.iters.numpy())
    for k in ("gis_idx", "gis_side", "gis_vmask"):
        assert np.array_equal(np.asarray(ref.gi_state[k]), got.gi_state[k].numpy()), k
    assert np.max(np.abs(np.asarray(ref.gi_state["gis_Ginv"])
                         - got.gi_state["gis_Ginv"].numpy())) < 1e-9


def test_pure_f32_slots_match_x64_free_reference():
    """float32 slots against the reference in a pure-f32 session
    (``jax.enable_x64(False)``: its slot dtype is then float32)."""
    rng = np.random.default_rng(5)
    P, q, A, l, u = _stack([random_qp(rng, 5, 16) for _ in range(6)])
    l = np.maximum(l, -1e18)        # ±BIG in f32 range
    with jax.enable_x64(False):
        ref, got = _solve_both(P, q, A, l, u, dtype=np.float32,
                               slot_dtype=torch.float32)
        assert np.asarray(ref.gi_state["gis_Ginv"]).dtype == np.float32
    assert got.gi_state["gis_Ginv"].dtype == torch.float32
    x_r = np.asarray(ref.x, np.float64)
    assert np.array_equal(np.asarray(ref.converged), got.converged.numpy())
    assert np.array_equal(np.asarray(ref.iters), got.iters.numpy())
    assert np.max(np.abs(x_r - got.x.double().numpy())) < 1e-4 * (1 + np.abs(x_r).max())


def test_plain_scan_matches_interpret_mode_kmv():
    """The port's scan phase against the Pallas ``kmv`` kernel in interpret
    mode, with its lane-major BlockSpecs, at B=128, m=256, n=9."""
    B, m, n, LANE, MT = 128, 256, 9, 128, 128
    rng = np.random.default_rng(0)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    x = rng.normal(size=(B, n)).astype(np.float32)

    # the body of kmv, restated verbatim from docs/pallas_gi_experiment.py:84-90
    # (it is defined inside main() there and cannot be imported)
    def kmv(a_ref, x_ref, o_ref):
        a = a_ref[:]
        xv = x_ref[:]
        acc = jnp.zeros((a.shape[0], a.shape[2]), jnp.float32)
        for j in range(n):                         # static unroll (Mosaic)
            acc = acc + a[:, j, :] * xv[j, :]
        o_ref[:] = acc

    with jax.enable_x64(False):
        out = pl.pallas_call(
            kmv, grid=(m // MT, B // LANE),
            in_specs=[pl.BlockSpec((MT, n, LANE), lambda i, b: (i, 0, b),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((n, LANE), lambda i, b: (0, b),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((MT, LANE), lambda i, b: (i, b),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((m, B), jnp.float32),
            interpret=True,
        )(jnp.asarray(np.moveaxis(A, 0, -1).copy()), jnp.asarray(x.T.copy()))
    Ax_pal = np.asarray(out).T
    l = np.full((B, m), -1.0, np.float32)
    u = np.full((B, m), 1.0, np.float32)
    l[:, ::7] = -1e20
    t = torch.from_numpy
    rn = torch.linalg.vector_norm(t(A), dim=2)
    Ax, vl, vu, score = violation_scan_reference(t(A), t(x), t(l), t(u), rn)
    assert np.max(np.abs(Ax.numpy() - Ax_pal)) < 1e-5
    # the ranking the scan hands to the pivot step
    v = np.maximum(np.where(l > -1e18, l - Ax_pal, -np.inf), Ax_pal - u)
    sc = np.maximum(rn.numpy() * np.linalg.norm(x, axis=1)[:, None], 1.0)
    assert np.max(np.abs(score.numpy() - v / sc)) < 1e-5
    assert torch.isneginf(vl[:, ::7]).all()


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(47)
    P, q, A, l, u = _stack([random_qp(rng, 5, 12) for _ in range(4)])
    t = lambda a: torch.tensor(a)
    outs = []
    for fn in (gi_solve, gi_solve_reference):
        outs.append(solve_qp_active(t(P), t(q), t(A), t(l), t(u),
                                    cache=dict(gic_Pinv=t(_caches(P))), solve=fn))
    for a, b in zip(outs[0][:5], outs[1][:5]):
        assert torch.equal(a, b)


def test_state_init_and_argument_checks():
    st = gi_state_init(3, 2, torch.float32)
    assert st["gis_Ginv"].shape == (2, 3, 3) and st["gis_Ginv"].dtype == torch.float32
    assert st["gis_vmask"].dtype == torch.bool and not st["gis_vmask"].any()
    rng = np.random.default_rng(1)
    P, q, A, l, u = _stack([random_qp(rng, 4, 6) for _ in range(2)])
    t = lambda a: torch.tensor(a)
    c = dict(gic_Pinv=t(_caches(P)))
    # no cache: the in-solve P⁻¹ gives the cached solve's answer
    unc = solve_qp_active(t(P), t(q), t(A), t(l), t(u), cache=None)
    cac = solve_qp_active(t(P), t(q), t(A), t(l), t(u), cache=c)
    assert torch.equal(unc.iters, cac.iters)
    assert (unc.x - cac.x).abs().max().item() < 1e-9
    with pytest.raises(TypeError, match="slot"):
        solve_qp_active(t(P), t(q), t(A), t(l), t(u), cache=c,
                        slot_dtype=torch.float32)
    with pytest.raises(ValueError, match="max_active"):
        solve_qp_active(t(P), t(q), t(A), t(l), t(u), cache=c, max_active=0)


def test_size_guard_uses_the_hopper_budget():
    """The shared-memory budget picks the kernel's layout and refuses
    nothing: the headline-GI and large-GI shapes fit a block, n=64, m=1024
    in float64 does not, and the plain version solves such QPs to their KKT
    conditions: feasible, stationary and with duals of the right sign on
    the active rows only, each to 1e-9 of its scale."""
    assert smem_bytes(5, 101, 5, 4, 8) <= HOPPER_SMEM_OPTIN
    assert smem_bytes(33, 577, 8, 4, 4) <= HOPPER_SMEM_OPTIN // 2
    assert smem_bytes(64, 1024, 64, 8, 8) > HOPPER_SMEM_OPTIN
    rng = np.random.default_rng(11)
    P, q, A, l, u = _stack([random_qp(rng, 64, 1024) for _ in range(2)])
    t = lambda a: torch.tensor(a)
    for fn in (gi_solve, gi_solve_reference):
        r = solve_qp_active(t(P), t(q), t(A), t(l), t(u), solve=fn)
        x, y = r.x.numpy(), r.y.numpy()
        Ax = np.einsum("bmn,bn->bm", A, x)
        scale = 1.0 + np.abs(q).max() + np.abs(y).max()
        assert bool(r.converged.all())
        assert np.all(Ax >= l - 1e-9) and np.all(Ax <= u + 1e-9)
        grad = np.einsum("bij,bj->bi", P, x) + q + np.einsum("bmn,bm->bn", A, y)
        assert np.abs(grad).max() < 1e-9 * scale
        assert np.all(np.where(y > 0, np.abs(Ax - u), 0.0) < 1e-9)
        assert np.all(np.where(y < 0, np.abs(Ax - l), 0.0) < 1e-9)


a16 = lambda b: (b + 15) // 16 * 16


def _hand_slice(n, m, ns, data, slot, lu):
    """One lane's slice of gi_solve.cu, part by part: Ginv, five n-vectors
    and six ns-vectors in the slot dtype; x padded to 16 bytes, (l and u),
    the slot table in the data dtype; idx, side, vmask as 4-byte ints."""
    return (a16(slot * (ns * ns + 5 * n + 6 * ns))
            + a16(data * (a16(data * n) // data + (2 * m if lu else 0) + ns * n)) + a16(12 * ns))


@pytest.mark.parametrize("n,m,ns,data,slot,reps,layout,resident_geometry", [
    (5, 101, 5, 4, 8, 16, "resident", (256, 16, 16, 30224)),       # headline-GI
    (33, 577, 8, 4, 4, 128, "resident", (128, 32, 16, 202416)),    # large-GI
    (33, 897, 33, 8, 8, 1, "split", None),        # 37a: 8x8 LinMPC, Hp=25, float64
    (33, 2017, 12, 4, 8, 128, "split", None),     # 37b: the 8x8 fleet at Hp=60
    (82, 202, 82, 8, 8, 1, "split", None),        # 37c: MHE He=40, float64
    (128, 256, 128, 8, 8, 1, "global", None),     # P⁻¹ and one warp's Ginv: global only
])
def test_launch_geometry_picks_the_layout_by_size(n, m, ns, data, slot, reps, layout,
                                                  resident_geometry):
    """The resident layout while one warp's block fits 232,448 bytes, else
    the split one while one warp's split block does (P⁻¹, the row norms and
    the warp's state but l and u), else the global one; a split launch asks
    for its plan's shared memory (A's leading rows filling the rest), a
    global one for none and as many warps as the table is wide; the
    resident geometry is what it was before the split layout came (blocks,
    lanes a block, warps, shared memory)."""
    n_d = 4096 // reps if reps > 1 else 1
    lc = torch.arange(n_d * reps, dtype=torch.int32) % n_d
    table, block_ctrl, warps, smem, got = launch_geometry(
        lc, n, m, ns, data, slot, HOPPER_SMEM_OPTIN, 132)
    assert got == layout
    fits = smem_bytes(n, m, ns, data, slot) <= HOPPER_SMEM_OPTIN
    split = split_plan(n, m, ns, data, slot, 1, HOPPER_SMEM_OPTIN) is not None
    assert fits == (layout == "resident")
    assert (not fits and split) == (layout == "split")
    if layout == "resident":
        assert (*table.shape, warps, smem) == resident_geometry
    elif layout == "split":
        assert warps == min(table.shape[1], 16)
        rows, want = split_plan(n, m, ns, data, slot, warps, HOPPER_SMEM_OPTIN)
        assert smem == want == split_bytes(n, m, ns, data, slot, warps, rows)
        assert 0 < rows < m and smem <= HOPPER_SMEM_OPTIN - 256
    else:
        assert (warps, smem) == (min(table.shape[1], 16), 0)
    forced = launch_geometry(lc, n, m, ns, data, slot, HOPPER_SMEM_OPTIN, 132, "global")
    assert forced[2:] == (min(table.shape[1], 16), 0, "global")


@pytest.mark.parametrize("n,m,ns,data,slot", [(33, 2017, 12, 4, 8), (33, 897, 33, 8, 8),
                                              (82, 202, 82, 8, 8), (5, 101, 5, 4, 4)])
def test_new_layout_bytes_are_the_kernels_carve_up(n, m, ns, data, slot):
    """``smem_bytes``, ``split_bytes`` and ``workspace_bytes`` count what
    gi_solve.cu lays out: P⁻¹, A's rows padded to 16 bytes (all of them, or
    the split layout's leading ones) and the row norms, then a slice a warp,
    which holds l and u in the resident layout only; the global workspace is
    each block's row norms and a slice without l and u a lane.  At the
    Hp=60 fleet's shape 16 warps leave room for 948 of 2,017 rows, and every
    split block the wrapper plans stays within 232,448 bytes."""
    lda = a16(data * n) // data
    ctrl = lambda rows: a16(slot * n * n) + data * rows * lda + a16(data * m)
    for warps in (1, 2, 16):
        assert smem_bytes(n, m, ns, data, slot, warps) == ctrl(m) + warps * _hand_slice(
            n, m, ns, data, slot, True)
        for rows in (0, 5, m // 3):
            assert split_bytes(n, m, ns, data, slot, warps, rows) == ctrl(rows) + warps * \
                _hand_slice(n, m, ns, data, slot, False)
        plan = split_plan(n, m, ns, data, slot, warps, HOPPER_SMEM_OPTIN)
        if plan is not None:
            assert plan[1] == split_bytes(n, m, ns, data, slot, warps, plan[0])
            assert plan[1] <= HOPPER_SMEM_OPTIN - 256
            assert plan[0] == m or split_bytes(n, m, ns, data, slot, warps,
                                               plan[0] + 1) > HOPPER_SMEM_OPTIN - 256
    assert workspace_bytes(n, m, ns, data, slot, 100, 7) == 7 * a16(data * m) + 100 * \
        _hand_slice(n, m, ns, data, slot, False)
    if (n, m) == (33, 2017):
        assert _hand_slice(n, m, ns, data, slot, False) == 4928
        assert split_plan(n, m, ns, data, slot, 16, HOPPER_SMEM_OPTIN)[0] == 948


def test_plain_solve_ignores_the_layout():
    """The plain version has no budget: every ``_layout`` the kernel takes,
    with or without a resident-row count, gives the same solve on CPU
    tensors; a name GI has no layout of is refused."""
    rng = np.random.default_rng(53)
    P, q, A, l, u = _stack([random_qp(rng, 5, 12) for _ in range(3)])
    t = lambda a: torch.tensor(a)
    c = dict(gic_Pinv=t(_caches(P)))
    ref = solve_qp_active(t(P), t(q), t(A), t(l), t(u), cache=c, solve=gi_solve_reference)
    for layout in ("resident", "split", ("split", 0), ("split", 4), "global"):
        fn = partial(gi_solve, _layout=layout)
        got = solve_qp_active(t(P), t(q), t(A), t(l), t(u), cache=c, solve=fn)
        for a, b in zip(ref[:5], got[:5]):
            assert torch.equal(a, b), layout
    for bad in ("staged", ("resident", 2), ("split", -3)):
        with pytest.raises(ValueError, match="_layout"):
            solve_qp_active(t(P), t(q), t(A), t(l), t(u), cache=c,
                            solve=partial(gi_solve, _layout=bad))
