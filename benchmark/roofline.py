"""The least time the card could take for a kernel's work.

Copied from ``chip_smoke.py`` (``bound``, ``gi_bound``, ``admm_bound``), with
the shapes taken from the cell's QP as the benchmark's reference builds it
(its variables ``n``, its finite constraint rows ``m``, its count of
distinct controllers), never from a kernel's launch geometry or layout, so
a share reads the same work whatever implements the kernel.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W limit):
3.35 TB/s of HBM3, 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside
the tensor cores.
"""
from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def bound_s(nbytes, flops, itemsize):
    """``(seconds, what)``: the larger of the bytes over the memory rate
    and the operations over the peak rate of the type."""
    t_b, t_f = nbytes / HBM_BPS, flops / PEAK_FLOPS[itemsize]
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def gi_bound_s(*, lanes, n, m, slots, n_p, n_a, data_size, slot_size, pivots):
    """One GI launch over ``lanes`` lanes: each distinct P⁻¹ (``n_p``) and
    A (``n_a``) read once; per lane q, l, u, the warm list and the operator
    state read, the state, x, λ, the count and the flag written; per pivot
    ~2mn + 8m + 4n² + 4·ns·n + 5·ns² flops.  ``pivots`` is the launch's sum
    over its lanes (0 where the program does not report it: the bound is
    then the bytes' alone, a lower bound)."""
    ns = slots
    state = 2 * ns * 4 + ns + ns * ns * slot_size
    nbytes = (n_a * m * n * data_size + n_p * n * n * slot_size
              + lanes * (n * data_size + 2 * m * data_size + state + 2 * ns * 4 + 8)
              + lanes * (state + (n + ns) * slot_size + 5))
    flops = pivots * (2 * m * n + 8 * m + 4 * n * n + 4 * ns * n + 5 * ns * ns)
    return bound_s(nbytes, flops, data_size)


def admm_bound_s(*, sweeps, lane_launches, n, m, n_c, data_size):
    """A period's sweep launches together: each distinct controller's A, one
    M⁻¹ and one ρ read once (the first launch, in which every lane is
    active, reads them all); each active lane of a launch (``lane_launches``
    in all: lanes times launches) reads x, q, l, u, z, y, writes x, z, y,
    and reads its controller, rung and flag (9 B); each lane's sweep
    (``sweeps`` in all) does 4mn + 2n² + 12m + 6n flops."""
    s = data_size
    nbytes = (s * n_c * (m * n + n * n + m)
              + lane_launches * (s * (2 * n + 4 * m) + s * (n + 2 * m) + 9))
    flops = sweeps * (4 * m * n + 2 * n * n + 12 * m + 6 * n)
    return bound_s(nbytes, flops, data_size)
