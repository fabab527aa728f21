"""Per-lane QPs (every lane its own P and A, n_d = B) in the port.

* GI's A map: ``gi_solve_reference`` and ``solve_qp_active`` read A through
  ``a_ctrl`` and P⁻¹ through ``lane_ctrl``; against the same call with A
  copied per lane (bit for bit) and against ``mpc_tpu``'s vmapped
  ``solve_qp_active`` on per-lane copies of P and A (float64: x to 1e-9,
  the same iterations, flags and operator state, as tests/test_torch_gi.py).
* ``BatchedMHE``'s NaN variant passes the one shared A with its A map and
  keeps no per-lane copy of it; its estimates equal ``mpc_tpu``'s at the
  bars of tests/test_torch_batch_mhe.py.
* The identity lane map (``utils/lanes.py::identity_lanes``): one tensor a
  (B, device), no gather through it, grouped without a host sync, and
  the uncached solvers hand the kernels the same map on every call.
* The launch geometry: both kernels take their per-lane geometry at
  n_d = B and the grouping by controller otherwise, with the shared memory
  the sources lay out.
The CUDA kernels themselves are checked by tests/test_torch_cuda.py and
chip_smoke.py on the GPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.ops.qp_active import solve_qp_active as jax_solve_qp_active
from mpc_tpu.parallel import BatchedMHE as RefFleet
from mpc_tpu_torch.ops import qp as qp_mod
from mpc_tpu_torch.ops.gi_kernel import gi_solve, gi_solve_reference
from mpc_tpu_torch.ops.qp import solve_qp
from mpc_tpu_torch.ops.qp_active import build_gi_cache, gi_state_init, solve_qp_active
from mpc_tpu_torch.parallel import BatchedMHE
from mpc_tpu_torch.utils import lanes as lanes_mod
from mpc_tpu_torch.utils.lanes import identity_lanes, is_identity, lane_blocks, take
from test_torch_gi import random_qp

torch.set_num_threads(1)


def _per_lane_problems(seed, B, n, m, n_a):
    """B random QPs sharing ``n_a`` distinct A (lane b reads A[b % n_a])
    with a P each, and a lane order that is not the identity."""
    rng = np.random.default_rng(seed)
    As = [random_qp(rng, n, m)[2] for _ in range(n_a)]
    a_ctrl = rng.permutation(np.arange(B) % n_a)
    probs = []
    for b in range(B):
        P, q, _, l, u = random_qp(rng, n, m)
        # the bounds around a feasible point of the lane's own A
        x_f = rng.normal(size=n) * 0.1
        Ax = As[a_ctrl[b]] @ x_f
        margin = rng.uniform(0.05, 1.0, size=m)
        l = np.where(l < -1e19, l, Ax - margin)
        probs.append((P, q, l, Ax + margin))
    P, q, l, u = [np.stack(z) for z in zip(*probs)]
    return P, q, np.stack(As), l, u, a_ctrl, rng


def _gi_args(Pinv, A, lane_ctrl, q, l, u, ns, warm=False):
    B = q.shape[0]
    idx, side, vmask, Ginv = gi_state_init(ns, B, Pinv.dtype).values()
    z = torch.zeros(B, ns, dtype=torch.int32)
    return [Pinv, A, lane_ctrl, q, l, u, idx, side, vmask, Ginv, z, z.clone(),
            torch.zeros(B, dtype=torch.int32), warm,
            torch.full((B,), 150, dtype=torch.int32), 1e-9]


@pytest.mark.parametrize("seed,n,m,n_a,data", [(3, 4, 12, 2, torch.float64),
                                               (4, 6, 20, 3, torch.float64),
                                               (5, 5, 16, 1, torch.float32)])
def test_a_map_equals_a_copied_per_lane(seed, n, m, n_a, data):
    """``gi_solve_reference`` with A through its own map (n_a distinct A,
    P⁻¹ a lane through a permuted ``lane_ctrl``) returns, bit for bit, what
    the same call returns with A copied to every lane and read through
    ``lane_ctrl``; the wrapper on CPU tensors is that plain version."""
    B = 8
    P, q, A, l, u, a_ctrl, rng = _per_lane_problems(seed, B, n, m, n_a)
    perm = rng.permutation(B)
    Pinv = torch.tensor(np.stack([build_gi_cache(p, None)["gic_Pinv"] for p in P]))[perm]
    lc = torch.tensor(np.argsort(perm), dtype=torch.int32)          # lane b → its own P⁻¹
    ac = torch.tensor(a_ctrl, dtype=torch.int32)
    t = lambda a: torch.tensor(a).to(data)
    A_t = t(A)
    A_copied = A_t[ac.long()][perm]                                 # per P⁻¹ row, like Pinv
    mapped = _gi_args(Pinv, A_t, lc, t(q), t(l), t(u), n)
    copied = _gi_args(Pinv, A_copied, lc, t(q), t(l), t(u), n)
    got = gi_solve_reference(*mapped, ac)
    ref = gi_solve_reference(*copied)
    via_wrapper = gi_solve(*_gi_args(Pinv, A_t, lc, t(q), t(l), t(u), n), ac)
    for a, b, c in zip(got, ref, via_wrapper):
        assert torch.equal(a, b) and torch.equal(a, c)
    for k in range(6, 10):
        assert torch.equal(mapped[k], copied[k])
    assert bool(got[3].all())


@pytest.mark.parametrize("seed,n,m,n_a,warm", [(11, 4, 12, 2, False), (12, 6, 24, 3, True),
                                               (13, 8, 29, 1, False)])
def test_a_map_matches_reference(seed, n, m, n_a, warm):
    """``solve_qp_active(..., lane_ctrl=, a_ctrl=)`` with P a lane read
    through a permuted map and A through a map of its own that differs from
    it, against ``jax.vmap(mpc_tpu.ops.qp_active.solve_qp_active)`` on the
    per-lane copies: float64, x and y to 1e-9, the same iterations, flags
    and operator state."""
    B = 8
    P, q, A, l, u, a_ctrl, rng = _per_lane_problems(seed, B, n, m, n_a)
    perm = rng.permutation(B)                      # P stored in another order
    lc = np.argsort(perm)
    assert not np.array_equal(lc, a_ctrl)
    Pinv = np.stack([build_gi_cache(p, None)["gic_Pinv"] for p in P])
    y0 = None
    if warm:
        cold = solve_qp_active(torch.tensor(P), torch.tensor(q), torch.tensor(A[a_ctrl]),
                               torch.tensor(l), torch.tensor(u),
                               cache=dict(gic_Pinv=torch.tensor(Pinv)))
        y0 = cold.y.numpy() + 0.3 * rng.normal(size=l.shape) * (rng.random(l.shape) < 0.2)

    def one(P_, q_, A_, l_, u_, Pinv_, y0_):
        return jax_solve_qp_active(P_, q_, A_, l_, u_, y0_, cache=dict(gic_Pinv=Pinv_))
    j = jnp.asarray
    ref = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, None if y0 is None else 0))(
        j(P), j(q), j(A[a_ctrl]), j(l), j(u), j(Pinv), None if y0 is None else j(y0))
    t = torch.tensor
    got = solve_qp_active(t(P[perm]), t(q), t(A), t(l), t(u), None if y0 is None else t(y0),
                          lane_ctrl=t(lc, dtype=torch.int32),
                          a_ctrl=t(a_ctrl, dtype=torch.int32),
                          cache=dict(gic_Pinv=t(Pinv[perm])))
    assert np.asarray(ref.converged).all()
    assert np.array_equal(np.asarray(ref.iters), got.iters.numpy())
    assert np.array_equal(np.asarray(ref.converged), got.converged.numpy())
    for name in ("x", "y", "z", "obj"):
        r = np.asarray(getattr(ref, name), np.float64)
        assert np.max(np.abs(r - getattr(got, name).numpy())) < 1e-9, name
    for k in ("gis_idx", "gis_side", "gis_vmask"):
        assert np.array_equal(np.asarray(ref.gi_state[k]), got.gi_state[k].numpy()), k
    assert np.max(np.abs(np.asarray(ref.gi_state["gis_Ginv"])
                         - got.gi_state["gis_Ginv"].numpy())) < 1e-9


def test_a_map_argument_checks():
    """The A map has the lane count and is int32; P⁻¹ is then stacked over
    ``lane_ctrl``'s controllers, not A's."""
    P, q, A, l, u, a_ctrl, _ = _per_lane_problems(21, 4, 3, 6, 2)
    Pinv = torch.tensor(np.stack([build_gi_cache(p, None)["gic_Pinv"] for p in P]))
    t = torch.tensor
    args = _gi_args(Pinv, t(A), identity_lanes(4, "cpu"), t(q), t(l), t(u), 3)
    with pytest.raises(ValueError, match="a_ctrl"):
        gi_solve_reference(*args, t(a_ctrl[:3], dtype=torch.int32))
    with pytest.raises(TypeError, match="a_ctrl"):
        gi_solve_reference(*args, t(a_ctrl))
    with pytest.raises(ValueError, match="Pinv"):
        gi_solve_reference(*args)             # without the map A has 2 rows, P⁻¹ 4


def _mhe(pkg, He=4, **kw):
    """bench.py's ``mhe`` lane estimator (the 2x1 LinModel), x̂ within ±0.3
    so that bounds bind."""
    m = pkg.LinModel(pkg.tf_matrix([[pkg.tf(3, [10, 1])], [pkg.tf(-1, [4, 1])]]), 1.0)
    e = pkg.MovingHorizonEstimator(m, He=He, sigmaQ=[0.1] * m.nx, sigmaR=[0.2, 0.2], **kw)
    e.setconstraint(xhatmin=[-0.3] * e.nx_hat, xhatmax=[0.3] * e.nx_hat)
    return e


def test_mhe_nan_variant_reads_one_shared_a():
    """The 1 %-NaN route of ``BatchedMHE`` (bench.py's ``mhe`` lane at
    B=6): every NaN-variant GI solve gets the one shared A (n_a = 1) with
    an all-zeros A map and a P⁻¹ a lane through the identity map, and the
    fleet holds no per-lane copy of A; x̂, the converged flags and the NaN
    guard equal ``mpc_tpu``'s every period (x̂ to 1e-9·(1 + max|x̂|))."""
    B = 6
    fr = RefFleet(_mhe(mr), B)
    fp = BatchedMHE(_mhe(mt, device="cpu"), B)
    assert fp._fast and fp._nan_fast_ok
    seen = []

    def spy(*args):
        seen.append((args[0].shape[0], args[1].shape[0], args[2], args[16:]))
        return gi_solve(*args)
    fp.gi = spy
    rng = np.random.default_rng(7)
    u = None
    for k in range(9):
        ym = rng.normal(size=(B, 2)) * 0.3
        if k in (5, 6):
            ym[k - 3, k - 5] = np.nan
        xr, xp = np.asarray(fr.step(ym, u)), fp.step(ym, u).numpy()
        err = np.max(np.abs(xp - xr))
        assert err <= 1e-9 * (1.0 + np.max(np.abs(xr))), (k, err)
        assert np.array_equal(fp.last_ok.numpy(), np.asarray(fr.last_ok)), k
        assert fp._nan_guard == fr._nan_guard, k
        u = rng.normal(size=(B, 1)) * 0.2
    nan_calls = [s for s in seen if s[0] == B]
    assert nan_calls and len(nan_calls) < len(seen)
    for n_p, n_a, lc, extra in nan_calls:
        assert n_a == 1 and is_identity(lc) and len(extra) == 1
        assert torch.equal(extra[0], torch.zeros(B, dtype=torch.int32))
    assert not any(torch.is_tensor(v) and v.dim() == 3 and v.shape[0] == B
                   and v.shape[1] == fp._m_rows for v in vars(fp).values())


def test_identity_lanes_are_one_tensor_and_never_gathered():
    """One identity map a (B, device); ``take`` returns the data itself
    through it, and gathers through any other map, even an equal one."""
    a = identity_lanes(5, "cpu")
    assert identity_lanes(5, torch.device("cpu")) is a
    assert a.dtype == torch.int32 and torch.equal(a, torch.arange(5, dtype=torch.int32))
    assert identity_lanes(6, "cpu") is not a and is_identity(identity_lanes(6, "cpu"))
    M = torch.randn(5, 3, 2)
    assert take(M, a) is M and take(M, None) is M
    other = torch.arange(5, dtype=torch.int32)
    assert not is_identity(other)
    got = take(M, other)
    assert got is not M and torch.equal(got, M)


def test_identity_grouping_needs_no_host_sync(monkeypatch):
    """``lane_blocks`` on an identity map builds its one-lane blocks on the
    map's device from the map itself (no copy to the host, no sort); a
    second call is the cached result."""
    lc = identity_lanes(9, "cpu")

    def no_host(*a, **k):
        raise AssertionError("the identity map went through the host grouping")
    monkeypatch.setattr(torch, "unique_consecutive", no_host)
    monkeypatch.setattr(torch, "sort", no_host)
    table, ctrl = lane_blocks(lc, 16)
    assert table.shape == (9, 1) and table.data_ptr() == lc.data_ptr() and ctrl is lc
    assert lane_blocks(lc, 16)[0] is table


def test_uncached_solvers_pass_one_identity_map():
    """The uncached ADMM solve and the GI solve without ``lane_ctrl`` hand
    their kernels the one identity map of the batch on every call, so the
    kernels' lane grouping (cached per map) is built once; a caller's own
    identity map is kept and the per-lane P and A are not gathered."""
    rng = np.random.default_rng(31)
    P, q, A, l, u = [torch.tensor(np.stack(z)) for z in
                     zip(*[random_qp(rng, 4, 10) for _ in range(6)])]
    maps = []

    def sweep(*a):
        maps.append(a[2])
        return qp_mod.admm_sweep(*a)

    def solve(*a):
        maps.append(a[2])
        return gi_solve(*a)
    for _ in range(2):
        solve_qp(P, q, A, l, u, sweep=sweep, max_iter=30)
        solve_qp(P, q, A, l, u, lane_ctrl=identity_lanes(6, "cpu"), sweep=sweep, max_iter=30)
        solve_qp_active(P, q, A, l, u, solve=solve)
    assert len(maps) >= 6 and all(m is identity_lanes(6, "cpu") for m in maps)
    # a caller's identity map: P and A reach the sweep as they were given
    seen = []
    solve_qp(P, q, A, l, u, lane_ctrl=identity_lanes(6, "cpu"), scaling=0,
             sweep=lambda *a: seen.append(a[1]) or qp_mod.admm_sweep(*a), max_iter=10)
    assert seen and all(s.data_ptr() == A.data_ptr() for s in seen)


def test_lane_blocks_cache_is_hit_on_the_second_call(monkeypatch):
    """A fleet's own map is grouped once: the host grouping runs on the
    first ``lane_blocks`` call only."""
    calls = []
    real = torch.unique_consecutive

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(torch, "unique_consecutive", counted)
    lc = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)
    first = lane_blocks(lc, 4)
    assert lane_blocks(lc, 4) is first and len(calls) == 1
    assert first[0].shape == (6, 1)
    assert lanes_mod._BLOCKS[lc][(4, lc._version)] is first



def _a16(b):
    return (b + 15) // 16 * 16


def _gi_slice(n, m, ns, ds, ss, lu=True):
    """A warp's slice as gi_solve.cu::warp_bytes lays it out."""
    lda = _a16(ds * n) // ds
    return (_a16(ss * (ns * ns + 5 * n + 6 * ns)) + _a16(ds * (lda + (2 * m if lu else 0) + ns * n))
            + _a16(4 * 3 * ns))


# (B, n, m, slots, data, slot): the per-lane rows of PERF.md §6 — nonlin-GI,
# (c) mhe-nonlin-GI, the NonLinMPC A/B, SLMPC-GI, the compiled-loop fleet
# (n_d = B = 128, float64), the README controller (B = 1)
GI_SHAPES = [(4096, 2, 72, 2, 4, 8), (1024, 33, 146, 33, 4, 8), (256, 2, 102, 2, 4, 8),
             (4096, 3, 65, 3, 4, 8), (128, 5, 101, 5, 8, 8), (1, 3, 233, 3, 8, 8)]


@pytest.mark.parametrize("B,n,m,ns,ds,ss", GI_SHAPES)
def test_gi_geometry_is_per_lane_at_n_d_equal_b(B, n, m, ns, ds, ss):
    """At n_d = B the GI wrapper takes the per-lane geometry on an H100's
    132 SMs and 232,448 bytes: ⌈B/132⌉ warps a block (a power of two, at
    most 16, as many as fit), one lane a warp in lane order, no block
    controller, each warp's area its lane's P⁻¹, A with rows padded to 16
    bytes, the row norms and the slice (gi_solve.cu::own_bytes); a tiled
    map of the same size (n_d < B) keeps the grouping by controller."""
    from mpc_tpu_torch.ops import gi_kernel as gk
    lda = _a16(ds * n) // ds
    area = _a16(ss * n * n) + ds * m * lda + _a16(ds * m) + _gi_slice(n, m, ns, ds, ss)
    assert gk.own_bytes(n, m, ns, ds, ss) == area
    table, block_ctrl, warps, smem, layout = gk.launch_geometry(
        identity_lanes(B, "cpu"), n, m, ns, ds, ss, 232448, 132)
    want = min(16, 1 << max(0, -(-B // 132) - 1).bit_length())
    while want > 1 and want * area > 232448:
        want -= 1
    assert (block_ctrl, warps, smem, layout) == (None, want, want * area, "resident")
    assert table.shape == (-(-B // want), want)
    assert torch.equal(table.flatten()[:B], torch.arange(B, dtype=torch.int32))
    assert bool((table.flatten()[B:] == -1).all())
    # a permuted map of distinct controllers is per lane too; a tiled one is not
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(0)).to(torch.int32)
    assert gk.launch_geometry(perm, n, m, ns, ds, ss, 232448, 132)[1] is None
    if B >= 4:
        tiled = torch.arange(B, dtype=torch.int32) % (B // 4)
        t2, bc2, w2, s2, lay2 = gk.launch_geometry(tiled, n, m, ns, ds, ss, 232448, 132)
        assert bc2 is not None
        assert all(torch.equal(a, b) for a, b in zip((t2, bc2), lane_blocks(tiled, want)))
        assert s2 == gk.smem_bytes(n, m, ns, ds, ss, w2)
    if (B, n, m) == (1024, 33, 146):
        assert (area, warps) == (48032, 4)         # 4 lanes an SM, as a lane a block


def test_gi_geometry_of_the_a_map():
    """The MHE NaN variant's shape (B=4096, n=44, m=104, 8 slots, float32
    data, float64 slots) with the A map (every lane controller 0 of A, its
    own P⁻¹): the lanes grouped by A's controller (32 lanes a
    block), the shared A once a block (18,720 bytes with its row norms),
    each warp's P⁻¹ at the head of its slice (20,656 bytes a warp), so 10
    warps a block where a lane a block held 39,376 bytes; the split layout
    with the map keeps P⁻¹ out of the block's part."""
    from mpc_tpu_torch.ops import gi_kernel as gk
    B, n, m, ns = 4096, 44, 104, 8
    ac = torch.zeros(B, dtype=torch.int32)
    lc = identity_lanes(B, "cpu")
    table, block_ctrl, warps, smem, layout = gk.launch_geometry(lc, n, m, ns, 4, 8, 232448, 132,
                                                                None, ac)
    assert (table.shape, warps, layout) == ((128, 32), 10, "resident")
    assert torch.equal(block_ctrl, torch.zeros(128, dtype=torch.int32))
    per_warp = _a16(8 * n * n) + _gi_slice(n, m, ns, 4, 8)
    shared = 4 * m * n + _a16(4 * m)
    assert (shared, per_warp) == (18720, 20656)
    assert smem == gk.smem_bytes(n, m, ns, 4, 8, 10, pw=True) == shared + 10 * per_warp
    assert gk.smem_bytes(n, m, ns, 4, 8) == gk.own_bytes(n, m, ns, 4, 8) == 39376
    assert gk.split_bytes(n, m, ns, 4, 8, 2, 5, pw=True) == \
        4 * 5 * n + _a16(4 * m) + 2 * _gi_slice(n, m, ns, 4, 8, lu=False)
    # without the map the same lanes (the identity) are per lane
    assert gk.launch_geometry(lc, n, m, ns, 4, 8, 232448, 132)[1] is None
    g = gk.launch_geometry(lc, n, m, ns, 4, 8, 232448, 132, "global", ac)
    assert g[3:] == (0, "global") and g[1] is not None


@pytest.mark.parametrize("B,n,m,s,per_lane", [(4096, 2, 72, 4, True), (4096, 3, 65, 4, True),
                                              (2112, 8, 40, 8, True), (256, 44, 208, 4, False),
                                              (128, 5, 101, 8, False)])
def test_sweep_geometry_is_per_lane_at_n_d_equal_b(B, n, m, s, per_lane):
    """The sweep's per-lane geometry where a warp takes a lane (n ≤ 32 and
    at least 8 lanes an SM) and n_d = B: ⌈B/132⌉ warps a block (a power of
    two, at most 16), each warp's area its lane's A (unpadded) and its slice
    (admm_sweep.cu::own_area); the lanes in step (n > 32 or a small batch:
    the MHE general window, the compiled-loop fleet) keep a lane a block."""
    from mpc_tpu_torch.ops import admm_kernel as ak
    area = _a16(s * m * n) + _a16(s * (5 * m + n * n + 2 * n + (32 // n) * n))
    assert ak.own_bytes(n, m, s) == area
    table, block_ctrl, warps, grouped, smem, layout = ak.launch_geometry(
        identity_lanes(B, "cpu"), n, m, s, 232448, 132)
    if not per_lane:
        assert block_ctrl is not None and grouped and table.shape == (B, 1)
        return
    want = min(16, 1 << max(0, -(-B // 132) - 1).bit_length())
    assert (block_ctrl, warps, grouped, smem, layout) == (None, want, False, want * area,
                                                          "resident")
    assert table.shape == (-(-B // want), want)
    tiled = torch.arange(B, dtype=torch.int32) % (B // 8)
    assert ak.launch_geometry(tiled, n, m, s, 232448, 132)[1] is not None
    g = ak.launch_geometry(identity_lanes(B, "cpu"), n, m, s, 232448, 132, "global")
    assert g[1] is not None and g[0].shape == (B, 1) and g[-1] == "global"
