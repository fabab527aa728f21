"""The port's BatchedKalman against mpc_tpu.parallel.BatchedKalman.

SteadyKalmanFilter and KalmanFilter fleets of distinct plants (one with a
measured disturbance), one lane per estimator or ``reps`` replicas of each
(public lane order ``lane = r·n_d + c``), fed the same seed-made
measurements, inputs and disturbances.  Bar: x̂ to 1e-12 in float64 (P̂ too
for the KF), and a float32 fleet to 1e-4·(1 + |x̂|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_tpu as mr
import mpc_tpu.parallel
import mpc_tpu_torch as mt
import mpc_tpu_torch.parallel

torch.set_num_threads(1)
CPU = torch.device("cpu")


def estimators(pkg, kind, nd, n=3):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        A = np.diag(rng.uniform(0.5, 0.9, 2)) + rng.normal(size=(2, 2)) * 0.05
        Bd = rng.normal(size=(2, nd)) * 0.3
        model = pkg.LinModel(A, rng.normal(size=(2, 2)), np.eye(2), Bd,
                             np.zeros((2, nd)), 1.0)
        model.setop(uop=rng.normal(size=2), yop=rng.normal(size=2),
                    dop=rng.normal(size=nd))
        est = getattr(pkg, kind)(model, nint_ym=[1, 1])
        est.setstate(rng.normal(size=est.nx_hat))
        out.append(est)
    return out


@pytest.mark.parametrize("kind,reps,nd", [("SteadyKalmanFilter", 1, 0),
                                          ("SteadyKalmanFilter", 3, 1),
                                          ("KalmanFilter", 1, 1),
                                          ("KalmanFilter", 4, 0)])
def test_fleet_matches_reference(kind, reps, nd):
    ref = mpc_tpu.parallel.BatchedKalman(estimators(mr, kind, nd), reps=reps)
    port = mpc_tpu_torch.parallel.BatchedKalman(estimators(mt, kind, nd), reps=reps,
                                                device=CPU)
    assert port.B == ref.B == 3 * reps
    rng = np.random.default_rng(3)
    for k in range(25):
        ym, u = rng.normal(size=(port.B, 2)), rng.normal(size=(port.B, 2))
        d = rng.normal(size=(port.B, nd)) if nd else None
        xr = ref.step(jnp.asarray(ym), jnp.asarray(u), None if d is None else jnp.asarray(d))
        xp = port.step(ym, u, d)
        assert xp.dtype == torch.float64
        assert np.max(np.abs(np.asarray(xr) - xp.numpy())) < 1e-12, k
    for key, v in ref.state.items():
        assert np.max(np.abs(np.asarray(v) - port.state[key].numpy())) < 1e-12, key


def test_grouped_lanes_follow_their_estimator():
    """Lane r·n_d + c runs estimator c: with the same inputs on every
    replica, every replica returns the same estimates."""
    port = mpc_tpu_torch.parallel.BatchedKalman(estimators(mt, "KalmanFilter", 0),
                                                reps=2, device=CPU)
    ym = np.tile(np.random.default_rng(0).normal(size=(3, 2)), (2, 1))
    x = port.step(ym, np.zeros((6, 2)))
    assert torch.equal(x[:3], x[3:])


def test_float32_fleet():
    ref = mpc_tpu.parallel.BatchedKalman(estimators(mr, "KalmanFilter", 1), reps=2,
                                         dtype=np.float32)
    port = mpc_tpu_torch.parallel.BatchedKalman(estimators(mt, "KalmanFilter", 1),
                                                reps=2, dtype=torch.float32, device=CPU)
    rng = np.random.default_rng(4)
    for _ in range(15):
        ym, u, d = (rng.normal(size=(6, w)).astype(np.float32) for w in (2, 2, 1))
        xr = np.asarray(ref.step(jnp.asarray(ym), jnp.asarray(u), jnp.asarray(d)))
        xp = port.step(ym, u, d)
        assert xp.dtype == torch.float32
        assert np.max(np.abs(xr - xp.numpy())) < 1e-4 * (1 + np.abs(xr).max())


def test_rejects_other_estimators():
    m = mt.LinModel(mt.tf(2, [10, 1]), 1.0)
    with pytest.raises(TypeError, match="supports"):
        mpc_tpu_torch.parallel.BatchedKalman([mt.Luenberger(m)], device=CPU)
    with pytest.raises(TypeError, match="mixed"):
        mpc_tpu_torch.parallel.BatchedKalman(
            [mt.KalmanFilter(m), mt.SteadyKalmanFilter(m)], device=CPU)
    fleet = mpc_tpu_torch.parallel.BatchedKalman([mt.KalmanFilter(m)], device=CPU)
    with pytest.raises(ValueError, match="shape"):
        fleet.step(np.zeros((2, 1)), np.zeros((1, 1)))
