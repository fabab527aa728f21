"""ManualEstimator (counterpart of ``mpc_tpu/estimators/manual.py``;
reference src/estimator/manual.jl).

No-op estimator: the user supplies x̂ through ``setstate`` each period, to
wire in an external estimator (manual.jl:99-128).
"""
from __future__ import annotations

from .base import StateEstimator


class ManualEstimator(StateEstimator):
    def __init__(self, model, i_ym=None, nint_u=0, nint_ym=None, direct=False):
        # the reference hardcodes direct=false (manual.jl:37): setstate is the
        # "correction", so no preparestate gate applies
        self._init_common(model, i_ym, nint_u, nint_ym, direct)

    def _correct(self, y0m, d0):
        return None

    def _predict(self, u0, d0):
        return None  # update_estimate! is a no-op (manual.jl:152)
