"""Spans and counters inside the fleet steps, on the profiler's clock.

A span names one layer of one period of a fleet step:

=====================  ====================================================
``fleet.step``         the period, the root: one a period, every public
                       entry that runs a step opens it
``estimator.correct``  the estimator's correction
``linearize``          SLMPC only: the Jacobians at the corrected estimate
                       and the augmented Â, B̂u, Ĉ
``qp.build``           the condensed QP of the period: F, q̃, H (SLMPC),
                       the rows and their bounds, the warm start's shift
``qp.solve``           the QP solve (GI or ADMM, with the equality
                       elimination around it)
``estimator.predict``  the estimator's prediction
=====================  ====================================================

Spans are on only while a ``torch.profiler`` profile is recording
(``torch.autograd._profiler_enabled()``).  Otherwise ``span`` costs that
one check and returns a shared no-op: no allocation, no device operation,
no CUDA event.  When it is on, a span

- opens a host range of its name on the profiler's clock, recorded as an
  ordinary host operation (``cpu_op``), not as a user annotation: Kineto
  mirrors user annotations onto the device timeline, where they would read
  as device work;
- appends its step, name, parent and host start and end
  (``time.perf_counter_ns``) to the record;
- on a CUDA step, records a timing event on the stream that was current as
  the step opened, at its entry and at its exit (none while the stream
  captures a CUDA graph), never synchronised during the step.

``steps()`` synchronises once and returns one entry a traced step; a span's
stream time runs from the stream reaching its entry event to the stream
passing its exit event: the layer's device work and the card's waits for
its host dispatch.  ``clear()`` empties the record.

Counters are host integers, always on (``COUNTS``): ``host_syncs`` counts
each expression in a step's path that makes the host wait for the device
(a read of a device value, a blocking upload, a library call that checks
its result on the host), each wrapped in ``synced``; ``lane_copy_bytes``
the bytes of per-lane copies of per-controller matrices and
``grouped_products`` the products taken one GEMM a controller over its
lanes (``utils/lanes.py``).  The plain versions of the kernels, which
stand in for them on the CPU, are not counted: the count is what the step
makes on the card.  A traced step's entry keeps each counter's change over
the step, under the counter's name, and a snapshot of ``ops.LAUNCHES`` at
its end.  ``keep_max`` keeps a device tensor of a traced step whose largest
element ``steps()`` reports; an untraced step keeps nothing and gains no
kernel.
"""
from __future__ import annotations

import time

import torch

# a host range that Kineto keeps off the device timeline (a user annotation
# from torch.profiler.record_function would be mirrored onto it)
from torch._C._profiler import _RecordFunctionFast as _HostRange

ROOT = "fleet.step"
COUNTS = {"host_syncs": 0, "lane_copy_bytes": 0, "grouped_products": 0}

_profiling = torch.autograd._profiler_enabled


def synced(value):
    """``value``, counted as one host sync: wraps an expression of a step's
    path that makes the host wait for the device."""
    COUNTS["host_syncs"] += 1
    return value


class _Off:
    """The shared span of an untraced step."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Record:
    """The traced steps: the one open now, and those closed since the last
    ``clear``, oldest first."""

    def __init__(self):
        self.open = None            # the open step's entry
        self.stack = []             # the open spans' names, outermost first
        self.done = []
        self.next_id = 0

    def clear(self):
        self.open, self.stack, self.done = None, [], []


RECORD = Record()


class _Span:
    __slots__ = ("name", "device", "host", "t0", "e0", "root", "parent")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        rec = RECORD
        self.host = _HostRange(self.name)
        self.host.__enter__()
        self.root = self.name == ROOT and rec.open is None
        if self.root:
            dev = None if self.device is None else torch.device(self.device)
            cuda = dev if dev is not None and dev.type == "cuda" else None
            rec.open = dict(step=rec.next_id, spans=[], items={}, cuda=cuda,
                            stream=_stream(cuda), counts0=dict(COUNTS))
            rec.next_id += 1
        self.parent = rec.stack[-1] if rec.stack else None
        rec.stack.append(self.name)
        self.e0 = _event(rec.open)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = RECORD
        step = rec.open
        if step is not None:
            step["spans"].append(dict(name=self.name, parent=self.parent, host_ns=(self.t0, t1),
                                      events=(self.e0, _event(step))))
        rec.stack.pop()
        if self.root and step is not None:
            from ..ops._build import LAUNCHES
            counts0 = step.pop("counts0")
            step.update({k: v - counts0[k] for k, v in COUNTS.items()})
            step["launches"] = dict(LAUNCHES)
            rec.done.append(step)
            rec.open = None
        self.host.__exit__(None, None, None)
        return False


def _stream(cuda):
    """The current stream of the step's card, taken as the step opens; None
    off a card and while the stream captures a CUDA graph."""
    if cuda is None or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream(cuda)


def _event(step):
    """A timing event recorded now on the step's stream; None where the
    step has none."""
    if step is None or step["stream"] is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(step["stream"])
    return ev


def span(name, device=None):
    """The span ``name`` as a context manager.  The root (``fleet.step``)
    takes the step's ``device``; the others run on the open step's."""
    if not _profiling():
        return _OFF
    return _Span(name, device)


def keep_max(name, t):
    """Keep the device tensor ``t`` in the traced step open now, reported by
    ``steps()`` as its largest element; nothing in an untraced step."""
    if RECORD.open is not None:
        RECORD.open["items"][name] = t


def steps():
    """One entry a traced step since the last ``clear``, oldest first:
    ``step`` (its id), each counter's change over it under the counter's
    name (``host_syncs``, ...), ``launches`` (``ops.LAUNCHES`` at its end),
    ``items`` (each ``keep_max`` value) and ``spans``, each with its
    ``name``, ``parent``, ``host_ms`` and ``stream_ms`` (None where the step
    ran on no CUDA stream).  Synchronises once with each step's card."""
    done = RECORD.done
    for dev in {s["cuda"] for s in done if s["cuda"] is not None and "resolved" not in s}:
        torch.cuda.synchronize(dev)
    out = []
    for s in done:
        if "resolved" not in s:
            s["resolved"] = dict(
                step=s["step"], **{k: s[k] for k in COUNTS}, launches=s["launches"],
                items={k: int(v.max()) for k, v in s["items"].items()},
                spans=[dict(name=p["name"], parent=p["parent"],
                            host_ms=(p["host_ns"][1] - p["host_ns"][0]) / 1e6,
                            stream_ms=_stream_ms(*p["events"])) for p in s["spans"]])
            s["spans"] = s["items"] = None
        out.append(s["resolved"])
    return out


def _stream_ms(e0, e1):
    return None if e0 is None or e1 is None else e0.elapsed_time(e1)


def clear():
    """Empty the record."""
    RECORD.clear()
