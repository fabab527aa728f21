"""Host milliseconds a period in the estimator: the port's spans
``estimator.correct`` and ``estimator.predict`` (``time.perf_counter_ns``
at their edges, under the profiler), mean over the traced stretch."""
from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, ("estimator.correct", "estimator.predict"), "host_ms")
