"""The port's MHE window matrices and fast-path pieces against
``mpc_tpu.estimators.mhe_fast``.

Both packages get the same estimator configuration and the same seed-made
inputs.  Bars: the host NumPy builds (prediction matrices, constraint rows,
the step QP) identical to the reference's bit for bit (the same float64
operations on the same augmented matrices); the assembler and the float64
NaN downdate to 1e-12·(1 + max|·|) (the same algebra in another summation
order); the float32 downdate to 1e-4·(1 + max|·|) (float32 rounding of a
chain of He·nym rank-one updates and a Newton step); the dual shifts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu_torch as mt
from mpc_tpu.estimators import mhe_fast as rf
from mpc_tpu_torch.estimators import mhe_fast as pf

torch.set_num_threads(1)
CPU = torch.device("cpu")

# (He, direct, Cwt, nd): filter and predictor forms, hard and soft bounds,
# with and without a measured disturbance
CONFIGS = [(4, True, np.inf, 0), (3, False, np.inf, 0), (4, True, 1e4, 0),
           (3, True, np.inf, 1), (2, False, 1e3, 1)]


def estimators(He, direct, Cwt, nd):
    """The same MHE in both packages (2 outputs, an integrator each when
    nd = 0; a 3-input plant with one measured disturbance otherwise)."""
    out = []
    for pkg in (mr, mt):
        if nd:
            G = pkg.tf_matrix([[pkg.tf(1.9, [18, 1]), pkg.tf(1.9, [18, 1])],
                               [pkg.tf(-0.74, [8, 1]), pkg.tf(0.74, [8, 1])]])
            m = pkg.LinModel(G, 2.0, i_d=[1])
            m.setop(uop=[10], yop=[50, 30], dop=[20])
            kw = dict(nint_ym=0)
        else:
            m = pkg.LinModel(pkg.tf_matrix([[pkg.tf(3, [10, 1])], [pkg.tf(-1, [4, 1])]]), 1.0)
            kw = {}
        e = pkg.MovingHorizonEstimator(m, He=He, direct=direct, Cwt=Cwt,
                                       **kw, **({} if pkg is mr else {"device": CPU}))
        e.setconstraint(xhatmin=np.full(e.nx_hat, -3.0), xhatmax=np.full(e.nx_hat, 3.0))
        if np.isfinite(Cwt):
            e.setconstraint(c_xhatmin=np.linspace(0.5, 1.5, e.nx_hat),
                            c_vhatmax=np.full(e.nym, 2.0))
        out.append(e)
    return out


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: f"He{c[0]}-d{int(c[1])}-C{c[2]:g}-nd{c[3]}")
def pair(request):
    er, ep = estimators(*request.param)
    return er, ep, rf.build_pred_mats(er), pf.build_pred_mats(ep)


def rel(a, b, tol):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    err = np.max(np.abs(a - b), initial=0.0)
    assert err <= tol * (1.0 + np.max(np.abs(b), initial=0.0)), err


def test_prediction_matrices_identical(pair):
    er, ep, mr_, mp_ = pair
    assert set(mr_) == set(mp_)
    for k, v in mr_.items():
        assert np.array_equal(np.asarray(v), np.asarray(mp_[k])), k


def test_rows_and_step_qp_identical(pair):
    er, ep, mr_, mp_ = pair
    args = (er.C_xmin, er.C_xmax, er.C_wmin, er.C_wmax, er.C_vmin, er.C_vmax)
    assert np.array_equal(rf.build_rows(mr_, *args), pf.build_rows(mp_, *args))
    rng = np.random.default_rng(0)
    for Nk in range(1, er.He + 1):
        mask_w = (np.arange(er.He) < Nk).astype(float)
        H = rng.normal(size=(er.nx_hat, er.nx_hat))
        invP = H @ H.T + np.eye(er.nx_hat)
        for a, b in zip(rf.build_step_qp(mr_, mask_w, invP, er.invQ, er.invR, er.Cwt),
                        pf.build_step_qp(mp_, mask_w, invP, ep.invQ, ep.invR, ep.Cwt)):
            assert np.array_equal(a, b)


def window_data(er, B, seed, nan=False):
    """Random window data of B lanes (numpy f64), the mhe_fast argument
    order, with NaN measurements on some lanes when ``nan``."""
    rng = np.random.default_rng(seed)
    He, nx, nym, nu, nd = er.He, er.nx_hat, er.nym, er.model.nu, er.model.nd
    Y = rng.normal(size=(B, He, nym))
    if nan:
        Y[rng.random((B, He, nym)) < 0.2] = np.nan
    H = rng.normal(size=(nx, nx))
    return dict(U0=rng.normal(size=(B, He, nu)), D0=rng.normal(size=(B, He + 1, nd)),
                Y0m=Y, x_prior=rng.normal(size=(B, nx)), invP=H @ H.T + np.eye(nx))


def consts(er, mats, dt):
    c = dict(Su=mats["Su"], Sd=mats["Sd"], s1=mats["s1"], Cm=mats["Cm"], Ddm=mats["Ddm"],
             Gy=mats["Gy"], invR=er.invR, Xmin=er.X_min, Xmax=er.X_max, Wmin=er.W_min,
             Wmax=er.W_max, Vmin=er.V_min, Vmax=er.V_max)
    return c, {k: torch.as_tensor(np.asarray(v, float), dtype=dt) for k, v in c.items()}


@pytest.mark.parametrize("Nk_off,nan", [(0, False), (1, False), (0, True)])
def test_assembler_matches_reference(pair, Nk_off, nan):
    """q, l, u, c_x and r over 5 lanes, full and growing windows, with the
    per-element NaN mask."""
    er, ep, mr_, mp_ = pair
    d = window_data(er, 5, seed=Nk_off + 3 * nan, nan=nan)
    mask_w = (np.arange(er.He) < er.He - Nk_off).astype(float)
    mask_v = (mask_w[None, :, None] * np.isfinite(d["Y0m"])) if nan else None
    Y = np.nan_to_num(d["Y0m"])
    c_np, c_t = consts(er, mr_, torch.float64)
    asm_r = rf.make_assembler(mr_)
    if nan:
        ref = jax.vmap(lambda U, D, Yl, xp, mv: asm_r(c_np, U, D, Yl, xp, jnp.asarray(mask_w),
                                                      jnp.asarray(d["invP"]), mask_v=mv))(
            d["U0"], d["D0"], Y, d["x_prior"], mask_v)
    else:
        ref = jax.vmap(lambda U, D, Yl, xp: asm_r(c_np, U, D, Yl, xp, jnp.asarray(mask_w),
                                                  jnp.asarray(d["invP"])))(
            d["U0"], d["D0"], Y, d["x_prior"])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    out = pf.make_assembler(mp_)(c_t, t(d["U0"]), t(d["D0"]), t(Y), t(d["x_prior"]),
                                 t(mask_w), t(d["invP"]),
                                 mask_v=None if mask_v is None else t(mask_v))
    for a, b in zip(ref, out):
        rel(b.numpy(), np.asarray(a), 1e-12)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-4)])
def test_nan_downdate_matches_reference(pair, dtype, tol):
    """Per-lane H̃ and H̃⁻¹ after removing NaN'd V rows (6 lanes, a random
    fifth of the rows removed), f64 and f32 (the f32 Newton step)."""
    er, ep, mr_, mp_ = pair
    P, Pinv = pf.build_step_qp(mp_, np.ones(er.He), np.eye(er.nx_hat), ep.invQ,
                               ep.invR, ep.Cwt)
    rng = np.random.default_rng(11)
    w = (2.0 * np.diag(er.invR))[None, None, :] * (rng.random((6, er.He, er.nym)) < 0.2)
    w = w.reshape(6, -1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax.vmap(rf.make_nan_downdate(mr_), in_axes=(None, None, 0))(
        jnp.asarray(P, jd), jnp.asarray(Pinv, jd), jnp.asarray(w, jd))
    out = pf.make_nan_downdate(mp_)(torch.as_tensor(P, dtype=td), torch.as_tensor(Pinv, dtype=td),
                                    torch.as_tensor(w, dtype=td))
    for a, b in zip(ref, out):
        assert b.dtype == td
        rel(b.numpy(), np.asarray(a), tol)
    # the downdated inverse is the inverse of the downdated H̃
    rel(out[1].double().numpy() @ out[0].double().numpy(),
        np.broadcast_to(np.eye(P.shape[0]), out[0].shape), 1e3 * tol)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_shift_warm_duals_matches_reference(pair, kind):
    """The slot shift on (B, m) duals: moving, not moving and a per-lane
    flag, as NumPy arrays and as tensors."""
    er, ep, mr_, mp_ = pair
    m = pf.build_rows(mp_, ep.C_xmin, ep.C_xmax, ep.C_wmin, ep.C_wmax, ep.C_vmin,
                      ep.C_vmax).shape[0]
    y = np.random.default_rng(5).normal(size=(4, m))
    conv = (lambda a: torch.as_tensor(a)) if kind == "tensor" else (lambda a: a)
    for moving in (True, False, np.array([True, False, True, False])[:, None]):
        ref = np.asarray(rf.shift_warm_duals(mr_, y, moving))
        out = pf.shift_warm_duals(mp_, conv(y), conv(moving) if isinstance(moving, np.ndarray)
                                  else moving)
        assert torch.is_tensor(out) == (kind == "tensor")
        assert np.array_equal(np.asarray(out), ref)
