"""95th percentile of the wall time of every period in the window, from the
measurement handed to the fleet until u and the converged count are on
the host (host clock)."""
import statistics


def read(ctx):
    return statistics.quantiles(ctx["period_ms"], n=20)[18]
