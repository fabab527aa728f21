"""Megabytes (1e6 bytes) a period of per-lane copies of per-controller
matrices in the fleet step: the port's counter ``lane_copy_bytes`` (each
copy's bytes from its shapes), its change over each traced step, mean over
the traced stretch; nothing where the port keeps no such counter."""
from benchmark import spans


def read(ctx):
    return spans.counter(ctx, lambda s: None if s.get("lane_copy_bytes") is None
                         else s["lane_copy_bytes"] / 1e6)
