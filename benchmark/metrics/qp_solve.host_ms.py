"""Host milliseconds a period in the QP solve (the port's span
``qp.solve``: GI or the ADMM outer loop with its host syncs, and the
equality elimination around it), mean over the traced stretch."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, ("qp.solve",), "host_ms")
