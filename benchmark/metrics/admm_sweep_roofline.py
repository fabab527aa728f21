"""The ADMM sweep kernel's share of its roofline over the profiled stretch:
the sum of each period's bound (``roofline.admm_bound_s`` on the cell's QP
shapes, the period's sweeps summed over the lanes and its launches) over
the sum of the device time of the ``admm_*_kernel`` records.  A lower
bound on the work: each controller's A and M⁻¹ once a period.  Nothing
where the stretch launched none."""

KERNELS = ("admm_warp_kernel", "admm_group_kernel", "admm_staged_kernel")


def read(ctx):
    if ctx["kernel"] != "admm_sweep":
        return None
    t = sum(e - s for name, s, e in ctx["trace"]["device"]
            if any(k in name for k in KERNELS)) / 1e6
    launches = ctx["profiled_launches"]["admm_sweep"]
    bound = sum(ctx["bound_s"](p, n) for n, p in zip(launches, ctx["profiled_pivots"]))
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
