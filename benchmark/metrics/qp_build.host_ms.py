"""Host milliseconds a period building the condensed QP (the port's span
``qp.build``: F, q̃, H where it changes, the rows and bounds, the warm
start's shift), mean over the traced stretch."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, ("qp.build",), "host_ms")
