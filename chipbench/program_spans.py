"""The program's own spans beside the device trace.

While a profiler records, the program keeps each of its spans
(``repro_torch.core.tracing.spans()``: ``plan``, ``plan.predict``,
``execute``, ``execute.readback``, …) on the profiler's clock, the clock of
:class:`chipbench.trace.Trace`.  This module reads them as
``(name, start_s, end_s, parent)`` and answers what the per-layer readers
of the program's layers ask of a trace: the device's busy time inside a
span, the operations that started inside one, and the window's idle time
labelled by the benchmark's span and the program's innermost span.

A program without the record (an older version) gives None, and the
readers that need it return None in turn."""
from __future__ import annotations

import bisect
import heapq


def load() -> list | None:
    """The program's closed spans in seconds, ``(name, start_s, end_s,
    parent)``, in the order they opened; None where the program keeps no
    span record or kept no span."""
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    kept = [(n, s * 1e-9, None if e is None else e * 1e-9, p)
            for n, s, e, p in tracing.spans()]
    return kept or None


def counters() -> dict | None:
    """The program's counters, None where it keeps none."""
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    return tracing.counters()


def top(spans: list, name: str) -> list:
    """The closed spans ``name`` that no other span holds."""
    return [s for s in spans if s[0] == name and s[3] == -1
            and s[2] is not None]


def root_of(spans: list, i: int) -> int:
    """The index of the outermost span around span ``i``."""
    while spans[i][3] != -1:
        i = spans[i][3]
    return i


class Busy:
    """The device's busy time inside any interval, from the union of the
    trace's operations, in O(log n) a question."""

    def __init__(self, trace):
        merged: list = []
        for _, s, e in trace.device_ops:        # ordered by start
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [m[0] for m in merged]
        self.ends = [m[1] for m in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + (e - s))

    def __call__(self, lo: float, hi: float) -> float:
        i0 = bisect.bisect_right(self.ends, lo)
        i1 = bisect.bisect_left(self.starts, hi)
        if i1 <= i0:
            return 0.0
        out = self.cum[i1] - self.cum[i0]
        out -= max(0.0, lo - self.starts[i0])
        out -= max(0.0, self.ends[i1 - 1] - hi)
        return out


def idle_ms(trace, spans: list) -> list:
    """Each span's length less the device's busy time inside it (ms)."""
    busy = Busy(trace)
    return [1e3 * ((e - s) - busy(s, e)) for _, s, e, _ in spans]


def ops_starting_in(trace, intervals: list) -> list:
    """The device operations that started inside any of ``intervals``
    (``(start, end)`` pairs), each once."""
    ops = trace.device_ops                      # ordered by start
    starts = [o[1] for o in ops]
    picked: set = set()
    for s, e in intervals:
        picked.update(range(bisect.bisect_left(starts, s),
                            bisect.bisect_right(starts, e)))
    return [ops[i] for i in sorted(picked)]


def innermost(intervals: list, times: list) -> list:
    """For each time (ascending), the name of the interval ``(name, start,
    end)`` open at it with the latest start, or None."""
    order = sorted(intervals, key=lambda x: x[1])
    heap: list = []
    out, k = [], 0
    for t in times:
        while k < len(order) and order[k][1] <= t:
            n, s, e = order[k][:3]
            heapq.heappush(heap, (-s, k, n, e))
            k += 1
        while heap and heap[0][3] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def idle_split(trace, spans: list) -> dict:
    """The window's idle seconds by the benchmark span open at each gap's
    middle (``outside`` where none was), as :func:`chipbench.trace.
    breakdown` labels them, and within each gap by the program's innermost
    span open at each instant: ``<benchmark span>/<program span>``, or the
    benchmark span's name alone where no program span was open.  Summed by
    the part before ``/`` they are the breakdown's idle time by benchmark
    span."""
    lo, hi = trace.window
    gaps, edge = [], lo
    busy = Busy(trace)
    for s, e in [(s, e) for s, e in zip(busy.starts, busy.ends)
                 if e > lo and s < hi] + [(hi, hi)]:
        s, e = max(s, lo), min(e, hi)
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    bench = innermost(trace.spans, [0.5 * (a + b) for a, b in gaps])
    # the program's innermost span is constant between two consecutive
    # span boundaries
    closed = [s for s in spans if s[2] is not None]
    cuts = sorted({t for s in closed for t in s[1:3]})
    inner = innermost(closed, [0.5 * (a + b) for a, b in zip(cuts,
                                                             cuts[1:])])
    out: dict = {}

    def add(label, seconds):
        if seconds > 0:
            out[label] = out.get(label, 0.0) + seconds

    for (a, b), n in zip(gaps, bench):
        n = n or "outside"
        t = a
        k = bisect.bisect_right(cuts, t) - 1   # t lies in [cuts[k], cuts[k+1])
        while t < b:
            if k < 0:
                nxt, p = (cuts[0] if cuts else b), None
            elif k + 1 < len(cuts):
                nxt, p = cuts[k + 1], inner[k]
            else:
                nxt, p = b, None
            end = min(nxt, b)
            add(n + "/" + p if p else n, end - t)
            t = end
            k += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
