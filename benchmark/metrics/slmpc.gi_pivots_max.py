"""The slowest lane's GI pivots a period in the SLMPC step: the largest of
the solve's per-lane iterations, which the port keeps in traced steps
(``gi_pivots_max``), mean over the traced stretch."""
from benchmark import spans


def read(ctx):
    return spans.counter(ctx, lambda s: s["items"].get("gi_pivots_max"))
