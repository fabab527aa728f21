"""Host milliseconds a period in the SLMPC step's linearization at the
corrected estimate (the port's span ``linearize``: the Jacobians and the
augmented Â, B̂u, Ĉ), mean over the traced stretch."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, ("linearize",), "host_ms")
