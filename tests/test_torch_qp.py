"""The port's batched cached ADMM solve against mpc_tpu.ops.qp.solve_qp.

Random QPs of the tests/test_qp.py kind (equality and one-sided rows), each
with its own solver cache; the reference solves them under jit+vmap in
float64, the port as one batch.  Bars: x to 1e-7, the same ``converged``,
the same iteration counts and final ρ-ladder rungs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_tpu.ops.qp import build_solver_cache as jax_build_cache
from mpc_tpu.ops.qp import solve_qp as jax_solve_qp
from mpc_tpu_torch.ops.qp import build_solver_cache, solve_qp

torch.set_num_threads(1)

BIG = 1e20


def random_qp(rng, n, m, n_eq=0):
    H = rng.normal(size=(n, n))
    P = H @ H.T + n * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    x_feas = rng.normal(size=n) * 0.1
    margin = rng.uniform(0.05, 1.0, size=m)
    Ax = A @ x_feas
    l = Ax - margin
    u = Ax + margin
    one_sided = rng.random(m) < 0.3
    l = np.where(one_sided, -BIG, l)
    for i in range(n_eq):
        l[i] = u[i] = Ax[i]
    return P, q, A, l, u


def _batch(seed, B, n, m, n_eq, warm):
    rng = np.random.default_rng(seed)
    probs = [random_qp(rng, n, m, n_eq) for _ in range(B)]
    P, q, A, l, u = (np.stack(z) for z in zip(*probs))
    caches = [build_solver_cache(P[i], A[i], (u[i] - l[i]) < 1e-12,
                                 (u[i] >= 1e18) & (l[i] <= -1e18))
              for i in range(B)]
    ref = jax_build_cache(P[0], A[0], (u[0] - l[0]) < 1e-12,
                          (u[0] >= 1e18) & (l[0] <= -1e18))
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), np.asarray(caches[0][k])), k
    cache = {k: np.stack([np.asarray(c[k]) for c in caches]) for k in caches[0]}
    x0 = rng.normal(size=(B, n)) * 0.1 if warm else None
    y0 = rng.normal(size=(B, m)) * 0.01 if warm else None
    rung0 = rng.integers(0, 9, size=B).astype(np.int32) if warm else None
    return P, q, A, l, u, cache, x0, y0, rung0


def _solve_both(P, q, A, l, u, cache, x0, y0, rung0):
    keys = ("qpc_D", "qpc_E", "qpc_c", "qpc_eq", "qpc_loose", "qpc_rhovs",
            "qpc_Minvs")

    def one(P, q, A, l, u, c, x0, y0, r0):
        return jax_solve_qp(P, q, A, l, u, x0, y0, cache=c, rung0=r0)

    B = q.shape[0]
    jc = {k: jnp.asarray(cache[k]) for k in keys}
    jx0 = jnp.asarray(x0) if x0 is not None else jnp.zeros_like(jnp.asarray(q))
    jy0 = jnp.asarray(y0) if y0 is not None else jnp.zeros_like(jnp.asarray(l))
    jr0 = (jnp.asarray(rung0) if rung0 is not None
           else jnp.full(B, 4, jnp.int32))
    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (P, q, A, l, u)),
                                 jc, jx0, jy0, jr0)
    t = lambda a: torch.tensor(np.asarray(a))
    got = solve_qp(t(P), t(q), t(A), t(l), t(u), x0=t(jx0), y0=t(jy0),
                   rung0=t(jr0), cache={k: t(cache[k]) for k in keys})
    return ref, got


@pytest.mark.parametrize("seed,warm", [(0, False), (1, False), (2, True),
                                       (3, True)])
def test_cached_solve_matches_reference(seed, warm):
    ref, got = _solve_both(*_batch(seed, B=6, n=6, m=10, n_eq=2, warm=warm))
    assert np.array_equal(np.asarray(ref.converged), got.converged.numpy())
    assert np.asarray(ref.converged).all()
    assert np.array_equal(np.asarray(ref.iters), got.iters.numpy())
    assert np.array_equal(np.asarray(ref.rung), got.rung.numpy())
    assert np.max(np.abs(np.asarray(ref.x) - got.x.numpy())) < 1e-7
    assert np.max(np.abs(np.asarray(ref.obj) - got.obj.numpy())) < 1e-7


def test_polish_with_tied_scores_matches_reference():
    """m > n + 8, so the polish gathers k = n + 8 of m rows: most rows are
    inactive with an activity score of exactly 0, and ``top_k``/``topk`` may
    break those ties differently.  Such rows enter the KKT with act = 0, so
    the answer is the same."""
    n, m = 3, 24
    P, q, A, l, u, cache, x0, y0, rung0 = _batch(5, B=5, n=n, m=m, n_eq=0,
                                                 warm=False)
    ref, got = _solve_both(P, q, A, l, u, cache, x0, y0, rung0)
    x = np.asarray(ref.x)
    Ax = np.einsum("bmn,bn->bm", A, x)
    n_active = ((np.abs(Ax - u) < 1e-6) | (np.abs(Ax - l) < 1e-6)).sum(1)
    assert np.all(n_active < n + 8 - 1), n_active   # ≥ 2 zero-score rows tie
    assert np.array_equal(np.asarray(ref.converged), got.converged.numpy())
    assert np.array_equal(np.asarray(ref.iters), got.iters.numpy())
    assert np.max(np.abs(x - got.x.numpy())) < 1e-7


def test_uncached_path_and_wrong_penalties_raise():
    """The uncached path no longer raises (its parity cases are below);
    a cache built for other penalties still does."""
    P, q, A, l, u, cache, *_ = _batch(0, B=2, n=4, m=6, n_eq=0, warm=False)
    t = torch.from_numpy
    c = {k: t(np.asarray(v)) for k, v in cache.items()}
    cached = solve_qp(t(P), t(q), t(A), t(l), t(u), cache=c)
    uncached = solve_qp(t(P), t(q), t(A), t(l), t(u))
    assert uncached.converged.all()
    assert (uncached.x - cached.x).abs().max().item() < 1e-7
    with pytest.raises(ValueError, match="penalties"):
        solve_qp(t(P), t(q), t(A), t(l), t(u), cache=c, rho=0.2)


# --- the uncached path: in-solve Ruiz scaling and ρ ladder --------------------
def _one_qp(case):
    """The single QPs of tests/test_qp.py, in the reference's call form."""
    if case.startswith("random"):
        return random_qp(np.random.default_rng(int(case[-1])), 6, 10, n_eq=2)
    if case == "unconstrained_zero_row":
        P, q, *_ = random_qp(np.random.default_rng(7), 5, 1)
        return P, q, np.zeros((1, 5)), np.array([-BIG]), np.array([BIG])
    if case == "equality_only":
        return (np.eye(2), np.array([-1.0, -1.0]), np.array([[1.0, 1.0]]),
                np.array([1.0]), np.array([1.0]))
    if case == "active_box":
        return (np.eye(2), np.array([-10.0, 0.0]), np.array([[1.0, 0.0]]),
                np.array([-BIG]), np.array([2.0]))
    if case == "flat_row":
        rng = np.random.default_rng(0)
        M = rng.normal(size=(4, 4))
        A = rng.normal(size=(6, 4))
        A[2] = 0.0
        return (M @ M.T + np.eye(4), rng.normal(size=4), A, np.full(6, -5.0),
                np.full(6, 5.0))
    if case == "no_rows":
        P, q, *_ = random_qp(np.random.default_rng(3), 4, 1)
        return P, q, np.zeros((0, 4)), np.zeros(0), np.zeros(0)
    return random_qp(np.random.default_rng(11), 8, 14)     # warm_start, n_lad


UNCACHED = [("random_0", {}), ("random_1", {}), ("random_2", {}),
            ("random_3", {}), ("unconstrained_zero_row", {}),
            ("equality_only", {}), ("active_box", {}), ("flat_row", {}),
            ("no_rows", {}), ("warm_start", {"warm": True}),
            ("n_lad_3", {"n_lad": 3}), ("n_lad_5_unscaled", {"n_lad": 5, "scaling": 0}),
            ("budget", {"iter_budget": 20})]


@pytest.mark.parametrize("case,kw", UNCACHED, ids=[c for c, _ in UNCACHED])
def test_uncached_solve_matches_reference(case, kw):
    """One unbatched QP without a cache, the reference's call form
    (tests/test_qp.py, tests/test_deadline.py): x to 1e-7, the same
    iteration count, converged flag and final rung.  ``n_lad < 5`` is the
    ladder with a half-span of one decade."""
    kw = dict(kw)
    P, q, A, l, u = _one_qp(case)
    x0 = y0 = None
    if kw.pop("warm", False):
        s1 = jax_solve_qp(*map(jnp.asarray, (P, q, A, l, u)))
        x0, y0 = np.asarray(s1.x), np.asarray(s1.y)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.tensor(np.asarray(a))
    ref = jax_solve_qp(*map(j, (P, q, A, l, u, x0, y0)), **kw)
    got = solve_qp(*map(t, (P, q, A, l, u, x0, y0)), **kw)
    assert got.x.shape == (q.shape[0],) and got.iters.dim() == 0
    assert bool(got.converged) == bool(ref.converged)
    assert int(got.iters) == int(ref.iters)
    assert np.max(np.abs(np.asarray(ref.x) - got.x.numpy())) < 1e-7
    assert abs(float(ref.obj) - float(got.obj)) < 1e-7 * (1 + abs(float(ref.obj)))
    if ref.rung is not None:
        assert int(got.rung) == int(ref.rung)


def test_uncached_float32_flat_row():
    """tests/test_qp.py::test_qp_zero_constraint_row in float32: finite, the
    same converged flag and iterations as the reference's f32 solve, x to
    1e-4·(1 + max|x|)."""
    P, q, A, l, u = _one_qp("flat_row")
    ref = jax_solve_qp(*(jnp.asarray(a, jnp.float32) for a in (P, q, A, l, u)))
    got = solve_qp(*(torch.tensor(a, dtype=torch.float32) for a in (P, q, A, l, u)))
    x = np.asarray(ref.x)
    assert torch.isfinite(got.x).all()
    assert bool(got.converged) == bool(ref.converged)
    assert np.max(np.abs(x - got.x.numpy())) < 1e-4 * (1 + np.abs(x).max())


@pytest.mark.parametrize("warm", [False, True])
def test_uncached_batch_matches_reference(warm):
    """solve_qp_batch (tests/test_qp.py::test_batched_vmap): a leading lane
    axis on every argument, per-lane P and A; the reference vmaps the same
    solve.  x to 1e-7, the same iterations, converged flags and rungs."""
    from mpc_tpu.ops.qp import solve_qp_batch as jax_batch
    from mpc_tpu_torch.ops.qp import solve_qp_batch
    P, q, A, l, u, _, x0, y0, _ = _batch(5, B=16, n=5, m=8, n_eq=1, warm=warm)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.tensor(a)
    ref = jax_batch(*map(j, (P, q, A, l, u, x0, y0)))
    got = solve_qp_batch(*map(t, (P, q, A, l, u, x0, y0)))
    assert got.x.shape == (16, 5)
    assert np.asarray(ref.converged).all()
    assert np.array_equal(np.asarray(ref.converged), got.converged.numpy())
    assert np.array_equal(np.asarray(ref.iters), got.iters.numpy())
    assert np.array_equal(np.asarray(ref.rung), got.rung.numpy())
    assert np.max(np.abs(np.asarray(ref.x) - got.x.numpy())) < 1e-7
