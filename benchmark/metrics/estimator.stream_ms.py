"""Stream milliseconds a period in the estimator: from the stream reaching
the entry event of the port's spans ``estimator.correct`` and
``estimator.predict`` to it passing their exit events (their device work
and the card's waits for their host dispatch), mean over the traced
stretch; nothing off a CUDA stream."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, ("estimator.correct", "estimator.predict"), "stream_ms")
