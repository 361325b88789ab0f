"""Named spans and counters inside the planner and the executor.

``span(name)`` marks one layer of a call (``plan.predict``,
``execute.dispatch``, …) as the profiler range ``repro_torch.<name>``,
only while a profiler records (``torch.profiler.profile``, or
``torch.autograd.profiler.emit_nvtx``, where the ranges become NVTX
ranges); otherwise it is one shared no-op context, and a call pays one
check a span.  The range is a plain ``RecordFunction`` (not a user
annotation), so the profiler puts it on the host's timeline only: the
device's timeline keeps the kernels alone, as without the program's
spans.

While a profiler records, each span is also kept here as ``(name,
start_ns, end_ns, parent)`` on the profiler's clock (the host's real-time
clock, which the profiler puts the device's kernels on too), ``parent``
being the index of the span that was open around it on the same thread,
or -1.  ``spans()`` returns them, so a traced window can be split by the
program's layers without the profiler's raw events; ``clear_spans()``
starts a new record.  At most ``MAX_SPANS`` are kept.

``count(name, n)`` adds to a process-wide counter, always on;
``counters()`` returns a copy.  The counters are ``plan.rows`` (rows
planned, once per ``plan_spgemm``) and ``replan.rows`` (rows of each unit
that re-planning re-runs, once per re-run).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import torch

PREFIX = "repro_torch."
MAX_SPANS = 1 << 18

_OFF = contextlib.nullcontext()
_enabled = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_counters: collections.Counter = collections.Counter()
_spans: list = []
_generation = 0            # of the span record, one a clear_spans()
_open = threading.local()   # each thread's open spans


class _Span:
    """A profiler range that is also kept in the span record."""

    __slots__ = ("name", "rf", "index", "generation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.rf.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        with _lock:
            self.generation = _generation
            self.index = len(_spans) if len(_spans) < MAX_SPANS else -1
            if self.index >= 0:
                _spans.append([self.name, time.time_ns(), None,
                               outer.index if outer is not None
                               and outer.generation == _generation else -1])
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _open.stack.pop()
        end = time.time_ns()
        with _lock:
            if self.index >= 0 and self.generation == _generation:
                _spans[self.index][2] = end
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """The range ``repro_torch.<name>`` while a profiler records, else a
    shared no-op context."""
    return _Span(name) if _enabled() else _OFF


def spanned(name: str):
    """Decorates a function to run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] += int(n)


def counters() -> dict:
    """A copy of every counter."""
    with _lock:
        return dict(_counters)


def spans() -> list:
    """The spans kept while a profiler recorded, in the order they opened:
    ``(name, start_ns, end_ns, parent)``; a span still open has no end
    (None)."""
    with _lock:
        return [tuple(s) for s in _spans]


def clear_spans() -> None:
    """Forgets the kept spans; spans open now are not kept when they
    close."""
    global _generation
    with _lock:
        _spans.clear()
        _generation += 1
