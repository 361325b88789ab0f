"""The profiler's record of a traced window, as plain intervals.

The benchmark opens its own spans (``chipbench.<name>``, through
``torch.profiler.record_function``) around its calls into each layer of
the program.  After a traced window the profiler's events are reduced to
two lists on one clock (seconds): the device's operations (kernels, copies
and fills) and the benchmark's spans.  The layer metrics read only these
lists, so they can be checked on a synthetic trace."""
from __future__ import annotations

import contextlib
import types
from typing import NamedTuple

import torch

PREFIX = "chipbench."


class Trace(NamedTuple):
    device_ops: list   # (name, start_s, end_s), ordered by start
    spans: list        # (name, start_s, end_s) of the benchmark's spans
    window: tuple      # (start_s, end_s) of the traced window


def span(name: str):
    """The benchmark's span ``chipbench.<name>`` (a profiler range)."""
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the body when ``enabled``; yields a holder whose ``trace``
    is the :class:`Trace` once the body has ended (None when not traced)."""
    holder = types.SimpleNamespace(trace=None)
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with span("window"):
            yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    holder.trace = from_kineto(prof.profiler.kineto_results.events())


def from_kineto(events) -> Trace:
    """A :class:`Trace` from the profiler's raw events."""
    ops, spans, window = [], [], None
    for e in events:
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and not e.name().startswith(PREFIX):
            # kernels, copies and fills; the profiler also mirrors each of
            # the benchmark's spans onto the device's timeline, under the
            # span's own name, and those are not device work
            ops.append((e.name(), start, end))
        elif not dev and e.name().startswith(PREFIX):
            name = e.name()[len(PREFIX):]
            if name == "window":
                window = (start, end)
            else:
                spans.append((name, start, end))
    ops.sort(key=lambda o: o[1])
    spans.sort(key=lambda s: s[1])
    return Trace(ops, spans, window)


def union(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    disjoint ordered intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(trace: Trace, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` in which some device operation ran."""
    return sum(e - s for s, e in union(
        ((s, e) for _, s, e in trace.device_ops), lo, hi))


def spans_named(trace: Trace, name: str) -> list:
    return [(s, e) for n, s, e in trace.spans if n == name]


def ops_within(trace: Trace, lo: float, hi: float) -> list:
    """Device operations that started inside ``[lo, hi]``."""
    return [o for o in trace.device_ops if lo <= o[1] <= hi]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time in the window (summed
    by name), and the idle time in the window summed by the benchmark span
    open at each gap's middle (``outside`` where none was)."""
    lo, hi = trace.window
    by_name: dict = {}
    for n, s, e in trace.device_ops:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle: dict = {}
    edge = lo
    for s, e in union(((s, e) for _, s, e in trace.device_ops), lo, hi) + [
            [hi, hi]]:
        if s > edge:
            mid = 0.5 * (edge + s)
            open_ = [(ss, n) for n, ss, ee in trace.spans if ss <= mid <= ee]
            label = max(open_)[1] if open_ else "outside"
            idle[label] = idle.get(label, 0.0) + (s - edge)
        edge = max(edge, e)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[n[:120], v] for n, v in ops],
                idle_gaps=[[n, v] for n, v in gaps])
