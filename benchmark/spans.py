"""The port's own record of its traced steps, as the per-layer readers of
spans and counters take it: ``mpc_tpu_torch.utils.trace.steps()``.

The port records a step only while a ``torch.profiler`` profile records,
so in a run with ``--trace 1`` the record holds the traced stretch's
periods, one step each; a reader takes the last ``stretch_periods`` of
them.  A program without that module, or a record without the value, gives
nothing (None).
"""
from __future__ import annotations

import statistics


def stretch(ctx):
    """The traced stretch's steps, oldest first, or None."""
    n = ctx.get("stretch_periods")
    if not n:
        return None
    try:
        from mpc_tpu_torch.utils import trace
    except ImportError:             # a port that keeps no record
        return None
    steps = trace.steps()
    return steps[-n:] if len(steps) >= n else None


def span_ms(ctx, names, field):
    """Mean over the stretch's periods of a period's ``field`` (``host_ms``
    or ``stream_ms``) summed over its spans named in ``names``; None where
    a period has none of them or a span lacks the field."""
    steps = stretch(ctx)
    if steps is None:
        return None
    per = []
    for s in steps:
        vals = [p[field] for p in s["spans"] if p["name"] in names]
        if not vals or any(v is None for v in vals):
            return None
        per.append(sum(vals))
    return statistics.fmean(per)


def counter(ctx, get):
    """Mean over the stretch's periods of ``get(step)``; None where a period
    lacks it."""
    steps = stretch(ctx)
    if steps is None:
        return None
    vals = [get(s) for s in steps]
    return None if any(v is None for v in vals) else statistics.fmean(vals)
