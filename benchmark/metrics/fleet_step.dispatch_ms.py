"""Host milliseconds from the call into the fleet step to its return (the
host's dispatch; the device may still be working), mean over the cell's
steady stretch: the last ``stretch_periods`` periods of the window."""
import statistics


def read(ctx):
    return statistics.fmean(ctx["dispatch_ms"])
