"""Stream milliseconds a period in the QP solve (the port's span
``qp.solve``, its timing events on the stream), mean over the traced
stretch; nothing off a CUDA stream."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, ("qp.solve",), "stream_ms")
