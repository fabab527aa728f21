"""The port's NumPy construction code reproduces the reference's data.

For each configuration both packages build the controller from scratch;
every ``LinMPC.params`` entry (prediction matrices, bounds, Hessian, row
stack, elimination matrices, ADMM solver cache) and every stacked
estimator entry must agree to 1e-12.
"""
import numpy as np
import pytest
import torch

import mpc_tpu
import mpc_tpu.parallel
import mpc_tpu_torch
import mpc_tpu_torch.parallel

torch.set_num_threads(1)

CPU = torch.device("cpu")


def LinMPC(pkg, *args, **kw):
    """``pkg.LinMPC``, the port's asked for the CPU (its default is the GPU)."""
    return pkg.LinMPC(*args, **kw, **({"device": CPU} if pkg is mpc_tpu_torch else {}))


def _cstr(pkg):
    return pkg.parallel.random_cstr_controllers(
        4, Hp=10, Hc=2, seed=0, **({"device": CPU} if pkg is mpc_tpu_torch else {}))


def _multiple_shooting(pkg):
    G = pkg.tf_matrix([[pkg.tf(1.9, [18.0, 1]), pkg.tf(1.5, [14.0, 1])],
                       [pkg.tf(-0.74, [8.0, 1]), pkg.tf(0.9, [9.0, 1])]])
    c = LinMPC(pkg, pkg.LinModel(G, 2.0), Hp=10, Hc=2, Mwt=[1.0, 1.0],
               Nwt=[0.1, 0.1], transcription=pkg.MultipleShooting())
    c.setconstraint(umin=[-10.0, -10.0], umax=[10.0, 10.0],
                    dumin=[-4.0, -4.0], dumax=[4.0, 4.0],
                    ymin=[-60.0, -60.0], ymax=[60.0, 60.0])
    return [c]


def _delayed_readme_plant(pkg):
    G = pkg.tf_matrix([[pkg.tf(2, [10, 1]) * pkg.delay(20)],
                       [pkg.tf(10, [4, 1])]])
    c = LinMPC(pkg, pkg.LinModel(G, 1.0), Mwt=[1, 0], Nwt=[0.1])
    c.setconstraint(ymax=[np.inf, 35])
    return [c]


def _disturbance_hard_soft_custom(pkg):
    """Measured disturbance, hard constraints (Cwt=inf) on one controller,
    softness weights and a custom linear constraint on the other."""
    A = np.array([[0.9, 0.1], [0.0, 0.8]])
    Bu = np.array([[0.5], [1.0]])
    C = np.array([[1.0, 0.0], [0.0, 1.0]])
    Bd = np.array([[0.2], [0.0]])
    Dd = np.array([[0.0], [0.1]])
    model = pkg.LinModel(A, Bu, C, Bd, Dd, 0.5)
    hard = LinMPC(pkg, model, Hp=8, Hc=3, Mwt=[1.0, 0.5], Nwt=[0.2],
                  Lwt=[0.05], Cwt=np.inf)
    hard.setconstraint(umin=[-2.0], umax=[2.0], xhatmin=[-5.0] * 4)
    soft = LinMPC(pkg, model, Hp=8, Hc=3, Wy=[[1.0, -1.0]])
    soft.setconstraint(c_ymin=[0.5, 0.5], c_umax=[0.1], ymin=[-3.0, -3.0],
                       wmax=[1.5])
    return [hard, soft]


CONFIGS = {"cstr": _cstr, "multiple_shooting": _multiple_shooting,
           "delayed_plant": _delayed_readme_plant,
           "disturbance_custom": _disturbance_hard_soft_custom}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_match_reference(name):
    ref = CONFIGS[name](mpc_tpu)
    port = CONFIGS[name](mpc_tpu_torch)
    for a, b in zip(ref, port):
        assert a.params.keys() == b.params.keys()
        for k in a.params:
            x, y = np.asarray(a.params[k]), np.asarray(b.params[k])
            assert x.shape == y.shape and x.dtype == y.dtype, k
            assert np.allclose(x, y, rtol=0, atol=1e-12), k
        assert (a.nZt, a.n_ineq, a.n_eq, a.n_qp) == (b.nZt, b.n_ineq,
                                                     b.n_eq, b.n_qp)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_estimator_params_match_reference(name):
    ref = mpc_tpu.parallel.estimator_params(CONFIGS[name](mpc_tpu))
    port = mpc_tpu_torch.parallel.estimator_params(CONFIGS[name](mpc_tpu_torch))
    assert ref.keys() == port.keys()
    for k in ref:
        assert ref[k].shape == port[k].shape, k
        assert np.allclose(ref[k], port[k], rtol=0, atol=1e-12), k


def _gi_controllers(pkg, transcription, gi_max_active):
    c = LinMPC(pkg, pkg.LinModel(pkg.tf_matrix(
        [[pkg.tf(1.9, [18.0, 1]), pkg.tf(1.5, [14.0, 1])],
         [pkg.tf(-0.74, [8.0, 1]), pkg.tf(0.9, [9.0, 1])]]), 2.0),
        Hp=10, Hc=2, Mwt=[1.0, 1.0], Nwt=[0.1, 0.1],
        transcription=getattr(pkg, transcription)(), qp_solver="active_set",
        gi_max_active=gi_max_active)
    c.setconstraint(umin=[-10.0, -10.0], umax=[10.0, 10.0],
                    dumin=[-4.0, -4.0], dumax=[4.0, 4.0],
                    ymin=[-60.0, -60.0], ymax=[60.0, 60.0])
    return c


@pytest.mark.parametrize("transcription,cap", [("SingleShooting", None),
                                               ("SingleShooting", 3),
                                               ("MultipleShooting", None),
                                               ("MultipleShooting", 2)])
def test_gi_params_match_reference(transcription, cap):
    """qp_solver="active_set": the same params (the GI cache gic_Pinv in
    place of the ADMM cache, on the reduced (H_r, A_r) under
    MultipleShooting elimination) and the same slot count."""
    a = _gi_controllers(mpc_tpu, transcription, cap)
    b = _gi_controllers(mpc_tpu_torch, transcription, cap)
    assert a.params.keys() == b.params.keys()
    assert "gic_Pinv" in b.params and "qpc_Minvs" not in b.params
    for k in a.params:
        x, y = np.asarray(a.params[k]), np.asarray(b.params[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert np.allclose(x, y, rtol=0, atol=1e-12), k
    assert (a.gi_slots, a.gi_max_active, a.n_qp) == (b.gi_slots, b.gi_max_active,
                                                     b.n_qp)
    assert "Goldfarb–Idnani" in repr(b)
