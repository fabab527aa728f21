"""The GI kernel's share of its roofline over the profiled stretch: the sum
of each launch's bound (``roofline.gi_bound_s`` on the cell's QP shapes and
the period's pivots) over the sum of the device time of the
``gi_solve_kernel`` records.  Nothing where the stretch launched none."""


def read(ctx):
    if ctx["kernel"] != "gi_solve":
        return None
    t = sum(e - s for name, s, e in ctx["trace"]["device"] if "gi_solve_kernel" in name) / 1e6
    launches = ctx["profiled_launches"]["gi_solve"]
    bound = sum(ctx["bound_s"](p, n) for n, p in zip(launches, ctx["profiled_pivots"]))
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
