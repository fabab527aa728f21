"""Randomized benchmark scenarios (BASELINE.json config 3).

Builds batches of LinMPC controllers on randomized 2×2 CSTR-like plants
(mirroring the reference's CSTR benchmark case study,
benchmark/3_bench_predictive_control.jl:166-215) with input/output bounds, so
thousands of condensed QPs solve in lockstep.
"""
from __future__ import annotations

import numpy as np

from ..controllers import LinMPC
from ..models import LinModel
from ..utils.lti import tf


def random_cstr_controllers(n, Hp=10, Hc=2, seed=0, qp_solver="admm",
                            gi_max_active=None, device=None, dtype=None):
    """``n`` LinMPC controllers on randomized first-order-MIMO plants
    (``qp_solver``, the GI slot cap ``gi_max_active``, ``device``, the
    GPU by default, and the step's ``dtype`` pass through to ``LinMPC``, as
    bench.py's large-plant constructor passes them)."""
    rng = np.random.default_rng(seed)
    ctrls = []
    for _ in range(n):
        g = rng.uniform(0.5, 2.0, size=4) * np.array([1.9, 1.9, -0.74, 0.74])
        tau = rng.uniform(0.6, 1.4, size=4) * np.array([18.0, 18.0, 8.0, 8.0])
        G = np.array([[tf(g[0], [tau[0], 1]), tf(g[1], [tau[1], 1])],
                      [tf(g[2], [tau[2], 1]), tf(g[3], [tau[3], 1])]],
                     dtype=object)
        model = LinModel(G, 2.0)
        c = LinMPC(model, Hp=Hp, Hc=Hc, Mwt=[1.0, 1.0], Nwt=[0.1, 0.1],
                   Cwt=1e5, qp_solver=qp_solver, gi_max_active=gi_max_active,
                   device=device, dtype=dtype)
        c.setconstraint(umin=[-10.0, -10.0], umax=[10.0, 10.0],
                        dumax=[4.0, 4.0], dumin=[-4.0, -4.0],
                        ymin=[-60.0, -60.0], ymax=[60.0, 60.0])
        ctrls.append(c)
    return ctrls
