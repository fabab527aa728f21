"""Stream milliseconds a period in the SLMPC step's linearization (the
port's span ``linearize``, its timing events on the stream), mean over the
traced stretch; nothing off a CUDA stream."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, ("linearize",), "stream_ms")
