"""The planner's and the executor's spans and counters
(``repro_torch.core.tracing``), on the CPU with the kernels' plain
versions: each span once per ``plan_spgemm`` or ``execute``, nested as the
layers are, on a whole-B and a 2-panel plan; no profiler range at all
while no profiler records; the same C bit for bit with the profiler on and
off; ``replan.rows`` equal to the rows of the units that re-planning
re-ran, ``plan.rows`` growing by M a plan."""
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import plan as plan_mod
from repro_torch.core import tracing
from repro_torch.sparse import random as sprand

torch.set_num_threads(1)

PLAN_SPANS = ("plan.validate", "plan.bin", "plan.flop", "plan.upload",
              "plan.predict", "plan.alloc")
EXEC_SPANS = ("execute.operands", "execute.dispatch", "execute.readback",
              "execute.replan")
LAYOUTS = {"whole": 0, "panels": 2}


def _pair():
    a = sprand.power_law(300, 300, 5, 1.5, seed=21)
    return a, sprand.power_law(300, 300, 4, 1.6, seed=22)


def _run(n_panels, safety=1.3, policy=None):
    a, b = _pair()
    p = plan_mod.plan_spgemm(
        a, b, safety=safety, n_panels=n_panels, device="cpu",
        sample_rows=np.random.default_rng(2).integers(0, a.nrows, 40),
        retry_policy=policy or plan_mod.RetryPolicy())
    out = plan_mod.execute(p, a, b, cache=plan_mod.PlanCache())
    return p, out


def _profiled(n_panels, **kw):
    tracing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p, out = _run(n_panels, **kw)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(tracing.PREFIX)]
    return p, out, names, tracing.spans()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_span_once_and_nested(layout):
    _, _, names, kept = _profiled(LAYOUTS[layout])
    plan_spans = PLAN_SPANS + (("plan.panels",) if LAYOUTS[layout] else ())
    want = ("plan",) + plan_spans + ("execute",) + EXEC_SPANS
    # the profiler's ranges: each span once
    assert sorted(names) == sorted(tracing.PREFIX + n for n in want)
    # the kept record: the same spans, each inside its parent
    assert sorted(s[0] for s in kept) == sorted(want)
    by_name = {s[0]: s for s in kept}
    for name, start, end, parent in kept:
        assert end is not None and start <= end
        top = name.split(".")[0]
        if name == top:
            assert parent == -1
        else:
            outer = kept[parent]
            assert outer[0] == top
            assert outer[1] <= start and end <= outer[2]
    # the layers run in the order of the table
    starts = [by_name[n][1] for n in want]
    assert starts == sorted(starts)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_no_profiler_range_without_a_profiler(layout, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tracing.clear_spans()
    assert tracing.span("plan") is tracing.span("execute")
    _run(LAYOUTS[layout])
    assert tracing.spans() == []


def _csr(p, out):
    c = plan_mod.reassemble(p, out, on_overflow="ignore")
    return (np.asarray(c.rpt), np.asarray(c.col), np.asarray(c.val))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("safety", [0.0, 1.3])
def test_output_is_the_same_with_the_profiler_on(layout, safety):
    off = _csr(*_run(LAYOUTS[layout], safety=safety))
    p, out, _, _ = _profiled(LAYOUTS[layout], safety=safety)
    on = _csr(p, out)
    for x, y in zip(off, on):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rounds", [4, 0], ids=["ladder", "exact_only"])
def test_replan_rows_counts_the_rows_rerun(layout, rounds):
    before = tracing.counters().get("replan.rows", 0)
    p, _ = _run(LAYOUTS[layout], safety=0.0,
                policy=plan_mod.RetryPolicy(rounds=rounds))
    units = p.retry_events + p.degradations
    # every bucket starts at 8 slots; without rounds the exact fallback
    # re-runs each short unit once
    assert p.retry_events if rounds else (p.degradations
                                          and not p.retry_events)
    rows = sum(p.binning.buckets[u["bucket"]].n_rows for u in units)
    assert tracing.counters()["replan.rows"] - before == rows


@pytest.mark.parametrize("layout", LAYOUTS)
def test_replan_rows_stays_without_overflow(layout):
    before = tracing.counters().get("replan.rows", 0)
    p, out = _run(LAYOUTS[layout], safety=8.0)
    assert not p.retry_events and not p.degradations
    assert int(out.overflow) == 0
    assert tracing.counters().get("replan.rows", 0) == before


def test_plan_rows_grows_by_m_a_plan():
    a, b = _pair()
    before = tracing.counters().get("plan.rows", 0)
    for k in (1, 2):
        plan_mod.plan_spgemm(a, b, device="cpu")
        assert tracing.counters()["plan.rows"] - before == k * a.nrows


def test_counters_lose_no_update_across_threads():
    name, n, per = "test.threads", 16, 2000
    before = tracing.counters().get(name, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [tracing.count(name) for _ in range(per)])
            for _ in range(n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.counters()[name] - before == n * per


def test_span_record_is_bounded_and_cleared(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 2)
    tracing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a"):
            with tracing.span("a.b"):
                with tracing.span("a.b.c"):      # past the bound: not kept
                    pass
            with tracing.span("a.d"):
                tracing.clear_spans()            # open when cleared
            with tracing.span("e"):
                pass
    kept = tracing.spans()
    assert [s[0] for s in kept] == ["e"]
    assert kept[0][3] == -1 and kept[0][2] is not None
