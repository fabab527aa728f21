"""Host syncs a period inside the fleet step: the port's counter
``host_syncs`` (each read of a device value, blocking upload or library
call that checks its result on the host in the step's path), its change
over each traced step, mean over the traced stretch."""
from benchmark import spans


def read(ctx):
    return spans.counter(ctx, lambda s: s["host_syncs"])
