"""Stream milliseconds a period building the condensed QP (the port's span
``qp.build``, its timing events on the stream), mean over the traced
stretch; nothing off a CUDA stream."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, ("qp.build",), "stream_ms")
