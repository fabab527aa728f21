"""95th percentile of the wall time of every period in the window, as
``period_ms_p95`` reads it, for a cell whose card idles through more than
half of its traced window: there the host paces the period, so its tail
swings with the host's speed and is a layer's number, not an end-to-end
one."""
import statistics


def read(ctx):
    return statistics.quantiles(ctx["period_ms"], n=20)[18]
