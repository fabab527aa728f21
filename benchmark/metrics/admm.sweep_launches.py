"""``admm_sweep`` kernel launches a period (``ops.LAUNCHES`` after
``reset_launch_counts()``), mean over the cell's steady stretch: the ADMM
outer loop's blocks until its slowest lane converges."""
import statistics


def read(ctx):
    if ctx["kernel"] != "admm_sweep":
        return None
    return statistics.fmean(ctx["launches"]["admm_sweep"])
