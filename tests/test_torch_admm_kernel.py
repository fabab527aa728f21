"""The port's ADMM sweep (plain version) against the Pallas kernel it replaces.

The Pallas kernel runs in interpret mode, as tests/test_pallas_qp.py runs it
on the CPU; the port's wrapper takes its plain torch version for CPU
tensors.  The CUDA kernel itself is checked by tests/test_torch_cuda.py and
chip_smoke.py on the GPU.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mpc_tpu.ops.pallas_qp import _admm_kernel
from mpc_tpu_torch.ops._build import HOPPER_SMEM_OPTIN
from mpc_tpu_torch.ops.admm_kernel import (admm_batch, admm_sweep,
                                           admm_sweep_reference,
                                           launch_geometry, smem_bytes,
                                           staged_bytes, staged_plan,
                                           workspace_bytes)

torch.set_num_threads(1)


def _random_batch(rng, n, m, B):
    """The batch of tests/test_pallas_qp.py (batch-leading, f32)."""
    H = rng.normal(size=(B, n, n)).astype(np.float32)
    P = H @ H.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    q = rng.normal(size=(B, n)).astype(np.float32)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    xf = (rng.normal(size=(B, n)) * 0.1).astype(np.float32)
    Ax = np.einsum("bmn,bn->bm", A, xf)
    l = (Ax - 0.2).astype(np.float32)
    u = (Ax + 0.6).astype(np.float32)
    rho = np.full((B, m), 0.1, np.float32)
    Minv = np.linalg.inv(
        P + 1e-6 * np.eye(n, dtype=np.float32)
        + np.einsum("bmn,bm,bmk->bnk", A, rho, A)).astype(np.float32)
    return P, q, A, l, u, rho, Minv


def test_plain_admm_batch_matches_interpret_pallas():
    """Same batch, same 600 sweeps: the two sum in different orders, so
    the bar is 1e-5 absolute in f32."""
    rng = np.random.default_rng(0)
    n, m, B = 4, 8, 128
    _, q, A, l, u, rho, Minv = _random_batch(rng, n, m, B)
    x0 = np.zeros((B, n), np.float32)
    lm = lambda a: np.moveaxis(a, 0, -1)
    kernel = partial(_admm_kernel, iters=600, sigma=1e-6, alpha=1.6)
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((n, B), jnp.float32),
        interpret=True,
    )(*(jnp.asarray(lm(a)) for a in (Minv, A, q, l, u, rho, x0)))
    x_pal = np.asarray(out)
    x_port = admm_batch(*(torch.from_numpy(lm(a).copy())
                          for a in (Minv, A, q, l, u, rho, x0)),
                        iters=600, sigma=1e-6, alpha=1.6).numpy()
    assert x_port.shape == (n, B) and x_port.dtype == np.float32
    assert np.max(np.abs(x_port - x_pal)) < 1e-5


def _sweep_inputs(seed, n_d=3, reps=4, n=5, m=12, n_lad=3, dtype=torch.float64):
    """Sweep inputs with a per-controller ρ ladder of ``n_lad`` rungs (ρ and
    Minv of rung k at ρ = 0.1·2^(k−1)) and a rung per lane."""
    rng = np.random.default_rng(seed)
    B = n_d * reps
    P, q, A, l, u, _, _ = _random_batch(rng, n, m, B)
    t = lambda a: torch.tensor(a, dtype=dtype)
    lane_ctrl = torch.arange(B, dtype=torch.int32) % n_d
    rhovs = 0.1 * 2.0 ** (np.arange(n_lad) - 1.0)[None, :, None] * np.ones((n_d, 1, m))
    Minvs = np.linalg.inv(
        P[:n_d, None] + 1e-6 * np.eye(n)
        + np.einsum("dmn,dkm,dmj->dknj", A[:n_d], rhovs, A[:n_d]))
    A_d = t(A[:n_d])
    z = torch.clamp(torch.einsum("bmn,bn->bm", A_d[lane_ctrl.long()],
                                 t(q) * 0.1), t(l), t(u))
    return dict(Minvs=t(Minvs), A=A_d, lane_ctrl=lane_ctrl,
                rung=torch.tensor(rng.integers(0, n_lad, B), dtype=torch.int32),
                q=t(q), l=t(l), u=t(u), rhovs=t(rhovs), x=t(q) * 0.1, z=z,
                y=t(rng.normal(size=(B, m)) * 0.01))


ORDER = ("Minvs", "A", "lane_ctrl", "rung", "q", "l", "u", "rhovs", "x", "z",
         "y")


def test_inactive_lanes_stay_bit_unchanged():
    """The lockstep freeze: a lane whose flag is off keeps x, z, y exactly;
    active lanes move exactly as in an all-active sweep."""
    a = _sweep_inputs(1)
    B = a["x"].shape[0]
    active = torch.tensor([i % 3 != 1 for i in range(B)])
    before = {k: a[k].clone() for k in ("x", "z", "y")}
    full = dict(a, **{k: a[k].clone() for k in ("x", "z", "y")})
    admm_sweep_reference(*(a[k] for k in ORDER), active, 10, 1e-6, 1.6)
    admm_sweep_reference(*(full[k] for k in ORDER),
                         torch.ones(B, dtype=torch.bool), 10, 1e-6, 1.6)
    for k in ("x", "z", "y"):
        assert torch.equal(a[k][~active], before[k][~active]), k
        assert torch.equal(a[k][active], full[k][active]), k
        assert not torch.equal(a[k][active], before[k][active]), k


def test_lane_ctrl_reads_each_lanes_controller():
    """A stacked over distinct controllers and read through lane_ctrl equals
    the sweep on per-lane copies of A and of the ladders."""
    a = _sweep_inputs(2)
    B = a["x"].shape[0]
    lc = a["lane_ctrl"].long()
    per_lane = dict(a, A=a["A"][lc].clone(), Minvs=a["Minvs"][lc].clone(),
                    rhovs=a["rhovs"][lc].clone(),
                    lane_ctrl=torch.arange(B, dtype=torch.int32),
                    x=a["x"].clone(), z=a["z"].clone(), y=a["y"].clone())
    on = torch.ones(B, dtype=torch.bool)
    for d in (a, per_lane):
        admm_sweep(*(d[k] for k in ORDER), on, 7, 1e-6, 1.6)
    for k in ("x", "z", "y"):
        assert torch.allclose(a[k], per_lane[k], rtol=0, atol=1e-14), k


@pytest.mark.parametrize("n_d,reps,n_lad", [(3, 4, 3), (1, 6, 9), (5, 1, 1)])
def test_ladder_read_by_rung_matches_gathered_form(n_d, reps, n_lad):
    """The sweep reading Minv and ρ off the ladder by (lane_ctrl, rung)
    equals, to the last bit, the same sweep on the per-lane Minv and ρ that
    the solver used to gather before every launch (a one-rung ladder per
    lane): the tiled fleet, a shared controller, one lane per controller."""
    _assert_ladder_equals_gathered(_sweep_inputs(4, n_d=n_d, reps=reps, n_lad=n_lad))


def _assert_ladder_equals_gathered(a):
    B = a["x"].shape[0]
    lc, rg = a["lane_ctrl"].long(), a["rung"].long()
    gathered = dict(a, Minvs=a["Minvs"][lc, rg][:, None].contiguous(),
                    rhovs=a["rhovs"][lc, rg][:, None].contiguous(),
                    A=a["A"][lc].contiguous(),
                    lane_ctrl=torch.arange(B, dtype=torch.int32),
                    rung=torch.zeros(B, dtype=torch.int32),
                    x=a["x"].clone(), z=a["z"].clone(), y=a["y"].clone())
    active = torch.arange(B) % 4 != 2
    for d in (a, gathered):
        admm_sweep_reference(*(d[k] for k in ORDER), active, 10, 1e-6, 1.6)
    for k in ("x", "z", "y"):
        assert torch.equal(a[k], gathered[k]), k


@pytest.mark.parametrize("itemsize", [4, 8])
def test_qps_wider_than_the_block_fit_the_layout(itemsize):
    """n > 256, more columns than the lanes-in-step block has threads: the
    kernel splits Aᵀ(ρz − y) into one row class, each thread summing
    several columns, so the layout holds lanes·n partial sums (at n ≤ 256,
    up to 16 row classes).  n=300, m=20 fits the budget in float32 and
    float64, and the plain sweep there reads the ladder as the gathered
    form does, to the last bit."""
    s, a16 = itemsize, lambda b: (b + 15) // 16 * 16
    lane = a16(s * (6 * 20 + 4 * 300))
    for lanes in (1, 2):
        assert smem_bytes(300, 20, s, lanes, True) == (
            a16(s * 300 * 20) + lanes * lane + a16(s * lanes * 300))
    assert smem_bytes(300, 20, s) <= HOPPER_SMEM_OPTIN
    assert smem_bytes(33, 577, s, 2, True) == (
        a16(s * 33 * 577) + 2 * a16(s * (6 * 577 + 4 * 33)) + a16(s * 7 * 2 * 33))
    assert smem_bytes(5, 101, s, 2, True) == (
        a16(s * 5 * 101) + 2 * a16(s * (6 * 101 + 4 * 5)) + a16(s * 16 * 2 * 5))
    dtype = torch.float32 if s == 4 else torch.float64
    _assert_ladder_equals_gathered(_sweep_inputs(6, n_d=2, reps=3, n=300, m=20,
                                                 dtype=dtype))


def test_size_guard_uses_the_hopper_budget():
    """The shared-memory budget of 232,448 bytes picks the kernel's layout
    and refuses nothing: the headline and the 8x8/Hp=15 shapes fit in f32,
    n=64/m=1024 does not, and the sweep (plain version) runs it as the
    same sweeps written out in NumPy float64 do, to 1e-12."""
    assert smem_bytes(5, 101, 4) <= HOPPER_SMEM_OPTIN
    assert smem_bytes(33, 897, 4) <= HOPPER_SMEM_OPTIN
    assert smem_bytes(64, 1024, 4, 1, True) > HOPPER_SMEM_OPTIN
    a = _sweep_inputs(9, n_d=2, reps=2, n=64, m=1024)
    on = torch.ones(4, dtype=torch.bool)
    ref = {k: a[k].numpy().copy() for k in ("x", "z", "y")}
    lc, rg = a["lane_ctrl"].long(), a["rung"].long()
    M, rho = a["Minvs"][lc, rg].numpy(), a["rhovs"][lc, rg].numpy()
    A, q, l, u = a["A"][lc].numpy(), a["q"].numpy(), a["l"].numpy(), a["u"].numpy()
    admm_sweep(*(a[k] for k in ORDER), on, 3, 1e-6, 1.6)
    x, z, y = ref["x"], ref["z"], ref["y"]
    for _ in range(3):
        rhs = 1e-6 * x - q + np.einsum("bmn,bm->bn", A, rho * z - y)
        xt = np.einsum("bij,bj->bi", M, rhs)
        zp = 1.6 * np.einsum("bmn,bn->bm", A, xt) + (1 - 1.6) * z
        zn = np.clip(zp + y / rho, l, u)
        y = y + rho * (zp - zn)
        x, z = 1.6 * xt + (1 - 1.6) * x, zn
    for k, want in (("x", x), ("z", z), ("y", y)):
        assert np.abs(a[k].numpy() - want).max() < 1e-12 * (1 + np.abs(want).max()), k


a16 = lambda b: (b + 15) // 16 * 16


@pytest.mark.parametrize("n,m,itemsize,n_d,reps,grouped,layout,resident_geometry", [
    (5, 101, 4, 256, 16, False, "resident", (256, 16, 16, 38640)),   # headline-ADMM
    (33, 577, 4, 32, 8, True, "resident", (256, 1, 8, 91488)),       # 8x8/Hp=15
    (33, 897, 8, 1, 1, True, "staged", None),     # 37a: 8x8 LinMPC, Hp=25, float64
    (33, 2017, 4, 32, 128, True, "staged", None),  # 37b: the 8x8 fleet at Hp=60
    (33, 2017, 4, 32, 8, True, "staged", None),    # the same at B=256
    (64, 1024, 4, 1, 2, True, "staged", None),
    (5, 12000, 4, 1, 32, True, "staged", None),    # a small batch: the lanes in step
    (5, 40000, 4, 1, 32, False, "global", None),   # neither variant's lane fits
    (300, 600, 8, 1, 2, True, "global", None),     # n > 256: no staged layout
])
def test_launch_geometry_picks_the_layout_by_size(n, m, itemsize, n_d, reps, grouped, layout,
                                                  resident_geometry):
    """The resident layout while one lane's block of the variant fits the
    budget, else the staged one for the lanes in step while one lane's
    staged block fits, else the global one; the variant does not depend on
    the layout (so they sum in one order); a staged launch asks for its
    plan's shared memory, a global one for none, and the resident geometry
    is what it was before the staged layout came (blocks, lanes a block,
    warps, shared memory)."""
    B = n_d * reps
    lc = torch.arange(B, dtype=torch.int32) % n_d
    table, _, warps, g, smem, got = launch_geometry(lc, n, m, itemsize, HOPPER_SMEM_OPTIN, 132)
    assert (g, got) == (grouped, layout)
    fits = smem_bytes(n, m, itemsize, 1, g) <= HOPPER_SMEM_OPTIN
    staged = staged_plan(n, m, itemsize, 1, HOPPER_SMEM_OPTIN) is not None
    assert fits == (layout == "resident")
    assert (not fits and g and staged) == (layout == "staged")
    blocks, width = table.shape
    if layout == "resident":
        assert (blocks, width, warps, smem) == resident_geometry
    elif layout == "staged":
        rows, tile, stages, want = staged_plan(n, m, itemsize, width, HOPPER_SMEM_OPTIN)
        assert smem == want == staged_bytes(n, m, itemsize, width, rows, tile)
        assert want <= HOPPER_SMEM_OPTIN - 256
        assert 0 <= rows < m and 64 <= tile <= min(256, m - rows) and stages == 2
        assert width <= min(4, max(1, B // 264)) or width == 1
    else:
        assert smem == 0
    forced = launch_geometry(lc, n, m, itemsize, HOPPER_SMEM_OPTIN, 132, "global")
    assert forced[2:4] == (warps, g) and forced[4:] == (0, "global")
    assert not g or forced[0].shape[1] <= 2
    if layout == "resident":
        assert forced[0].shape == table.shape


@pytest.mark.parametrize("itemsize", [4, 8])
def test_new_layout_bytes_are_the_kernels_carve_up(itemsize):
    """``staged_bytes`` and ``workspace_bytes`` count what admm_sweep.cu
    lays out, part by part (each rounded up to 16 bytes): a staged block is
    per lane z, y (m each) and x, q, rhs (n each), the lanes' ρz − y (m)
    and x̃ (n), the parts·lanes·n Aᵀv partial sums, then the resident chunk
    and the ring's chunks, each A's rows padded to 16 bytes and the lanes'
    l, u, ρ of those rows; the
    global layout's workspace is per block and lane z, y (and ρz − y, x, q,
    rhs, x̃ in step; Minv, rhs, x̃, the partial sums a warp a lane), l, u and
    ρ being read in place.  Every staged block the wrapper plans stays
    within 232,448 bytes."""
    s = itemsize
    for n, m, lanes in ((33, 2017, 4), (33, 2017, 1), (33, 897, 1), (64, 1024, 2),
                        (5, 150, 2)):
        parts = min(max(1, 256 // n), 16)
        lda = a16(s * n) // s
        chunk = lambda r: a16(s * r * lda) + a16(s * 3 * lanes * r)
        for rows in (0, 7, m // 2):
            tile = min(256, m - rows)
            want = (lanes * a16(s * (2 * m + 3 * n)) + a16(s * m * lanes) + a16(s * n * lanes)
                    + a16(s * parts * lanes * n) + chunk(rows) + 2 * chunk(tile))
            assert staged_bytes(n, m, s, lanes, rows) == want
        plan = staged_plan(n, m, s, lanes, HOPPER_SMEM_OPTIN)
        if plan is not None:
            rows, tile = plan[:2]
            assert plan[3] == staged_bytes(n, m, s, lanes, rows, tile) <= HOPPER_SMEM_OPTIN - 256
            assert tile == min(256, m - rows) or tile >= 64
            assert rows == m or (
                staged_bytes(n, m, s, lanes, rows + 1, tile) > HOPPER_SMEM_OPTIN - 256)
        assert workspace_bytes(n, m, s, lanes, True, 3) == 3 * (
            lanes * a16(s * (3 * m + 4 * n)) + a16(s * parts * lanes * n))
    assert workspace_bytes(5, 101, s, 16, False, 2) == 2 * 16 * a16(
        s * (2 * 101 + 25 + 10 + 6 * 5))
    # the Hp=60 fleet in float32: four lanes of 16,544 bytes, their ρz − y
    # and x̃, two chunks of 256 rows of 192 bytes, and the leading rows the
    # rest leaves room for
    rows, tile, stages, smem = staged_plan(33, 2017, 4, 4, HOPPER_SMEM_OPTIN)
    assert (tile, stages) == (256, 2)
    assert smem == (4 * 16544 + 32272 + 528 + 3696 + a16(rows * 144) + a16(rows * 48)
                    + 2 * 49152)
    assert 150 < rows < 170


def test_plain_sweep_ignores_the_layout():
    """The plain version has no budget: every ``_layout`` the kernel takes,
    with or without a resident-row count, runs the same sweep on CPU
    tensors; a name the sweep has no layout of is refused."""
    a = _sweep_inputs(12)
    on = torch.ones(a["x"].shape[0], dtype=torch.bool)
    ref = {k: v.clone() for k, v in a.items()}
    admm_sweep_reference(*(ref[k] for k in ORDER), on, 7, 1e-6, 1.6)
    for layout in ("resident", "staged", ("staged", 0), ("staged", 5), "global"):
        b = {k: v.clone() for k, v in a.items()}
        admm_sweep(*(b[k] for k in ORDER), on, 7, 1e-6, 1.6, _layout=layout)
        for k in ("x", "z", "y"):
            assert torch.equal(b[k], ref[k]), (layout, k)
    for bad in ("split", ("global", 3), ("staged", -1)):
        with pytest.raises(ValueError, match="_layout"):
            admm_sweep(*(a[k] for k in ORDER), on, 1, 1e-6, 1.6, _layout=bad)


def test_sweep_rejects_bad_arguments():
    a = _sweep_inputs(3)
    B = a["x"].shape[0]
    args = [a[k] for k in ORDER]
    on = torch.ones(B, dtype=torch.bool)
    with pytest.raises(TypeError, match="active"):
        admm_sweep(*args, torch.ones(B, dtype=torch.int32), 1, 1e-6, 1.6)
    with pytest.raises(ValueError, match="Minvs"):
        admm_sweep(args[0][:, :, :2], *args[1:], on, 1, 1e-6, 1.6)
    with pytest.raises(ValueError, match="rhovs"):
        admm_sweep(*args[:7], args[7][:, :1], *args[8:], on, 1, 1e-6, 1.6)
    with pytest.raises(TypeError, match="lane_ctrl"):
        admm_sweep(args[0], args[1], args[2].long(), *args[3:], on, 1, 1e-6, 1.6)
    with pytest.raises(TypeError, match="rung"):
        admm_sweep(*args[:3], args[3].long(), *args[4:], on, 1, 1e-6, 1.6)


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(tmp_path, monkeypatch):
    """The library is rebuilt when a source hash changes, and a machine
    without nvcc gets an error, never a silent plain path."""
    from mpc_tpu_torch.ops import _build
    assert [p.name for p in _build._sources()] == ["admm_sweep.cu", "gi_solve.cu"]
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 64
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
