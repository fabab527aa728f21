"""The slowest lane's GI pivots a period (``BatchedLinMPC.last_iters[0]``),
mean over the cell's steady stretch; nothing where the step reports none
or the cell solves with ADMM."""
import statistics


def read(ctx):
    if ctx["iters_max"] is None or ctx["kernel"] != "gi_solve":
        return None
    return statistics.fmean(ctx["iters_max"])
