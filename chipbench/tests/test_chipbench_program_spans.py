"""The program's spans beside the device trace: the trace's reduction and
the existing readers are the same with the program's events as without
them; the arithmetic of the readers of the program's spans and counters
and their None cases; the idle time split by program span."""
import random
import types

import numpy as np
import pytest
import torch

from chipbench import driver
from chipbench import program_spans as ps
from chipbench import trace as tr
from chipbench.layer_metrics import find

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
OLD_READERS = ["launches_per_call", "numeric_roofline", "call_mfu",
               "idle_pct", "predict_dev_ms", "plan_ms", "replan_rows_pct"]


def event(name, start_s, end_s, dev=CPU):
    ns = int(round(start_s * 1e9))
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: ns,
        duration_ns=lambda: int(round(end_s * 1e9)) - ns,
        device_type=lambda: dev)


# the benchmark's window, a plan and a call, their device mirrors, the
# runtime calls and the kernels they launched
BENCH_EVENTS = [
    event("chipbench.window", 0.0, 10.0),
    event("chipbench.plan", 1.0, 3.0),
    event("chipbench.call", 4.0, 8.0),
    event("chipbench.plan", 1.5, 2.6, CUDA),
    event("chipbench.call", 4.2, 7.9, CUDA),
    event("cudaLaunchKernel", 1.4, 1.41),
    event("void esc_symbolic_kernel<0>", 1.5, 1.6, CUDA),
    event("Memcpy DtoH (Device -> Pageable)", 2.5, 2.6, CUDA),
    event("cudaLaunchKernel", 4.1, 4.11),
    event("void esc_numeric_warp_kernel<32>", 4.2, 5.0, CUDA),
    event("void bin_numeric_kernel", 5.5, 7.5, CUDA),
    event("Memcpy DtoH (Device -> Pageable)", 7.8, 7.9, CUDA),
]
# the program's ranges are on the host's timeline only
PROGRAM_EVENTS = [
    event("repro_torch.plan", 1.05, 2.95),
    event("repro_torch.plan.bin", 1.1, 1.3),
    event("repro_torch.plan.predict", 1.35, 2.7),
    event("repro_torch.execute", 4.05, 7.95),
    event("repro_torch.execute.dispatch", 4.1, 4.3),
    event("repro_torch.execute.readback", 4.3, 7.9),
]
# the same spans as the program keeps them: (name, start, end, parent)
SPANS = [("plan", 1.05, 2.95, -1), ("plan.bin", 1.1, 1.3, 0),
         ("plan.predict", 1.35, 2.7, 0), ("execute", 4.05, 7.95, -1),
         ("execute.dispatch", 4.1, 4.3, 3),
         ("execute.readback", 4.3, 7.9, 3)]


def ctx(trace, **kw):
    c = driver.Context(trace=trace, call_bounds=[0.25])
    for k, v in kw.items():
        setattr(c, k, v)
    return c


@pytest.fixture
def program(monkeypatch):
    """The program's span record and counters, as given."""
    def give(spans=SPANS, counters=None):
        monkeypatch.setattr(ps, "load", lambda: spans)
        monkeypatch.setattr(ps, "counters", lambda: counters)
    give()
    return give


def test_the_program_events_leave_the_trace_as_it_was():
    without = tr.from_kineto(BENCH_EVENTS)
    mixed = BENCH_EVENTS[:6] + PROGRAM_EVENTS + BENCH_EVENTS[6:]
    with_ = tr.from_kineto(mixed)
    assert with_ == without
    assert [o[0] for o in with_.device_ops] == [
        "void esc_symbolic_kernel<0>", "Memcpy DtoH (Device -> Pageable)",
        "void esc_numeric_warp_kernel<32>", "void bin_numeric_kernel",
        "Memcpy DtoH (Device -> Pageable)"]
    for name in OLD_READERS:
        kw = dict(plan_ms=[2.0], replan=(1, 4))
        assert (find(name).read(ctx(with_, **kw))
                == find(name).read(ctx(without, **kw))), name
    assert tr.breakdown(with_) == tr.breakdown(without)


TRACE = tr.from_kineto(BENCH_EVENTS)


def test_exec_idle_ms(program):
    # execute: 3.9 s long, busy 0.8 + 2.0 + 0.1 s inside
    assert find("exec_idle_ms").read(ctx(TRACE)) == pytest.approx(1e3)


def test_plan_idle_ms(program):
    # plan: 1.9 s long, busy 0.1 + 0.1 s inside
    assert find("plan_idle_ms").read(ctx(TRACE)) == pytest.approx(1.7e3)
    program(SPANS + [("plan", 8.0, 9.0, -1), ("plan", 9.0, 9.5, -1)])
    # the median of 1.7, 1.0 and 0.5 s
    assert find("plan_idle_ms").read(ctx(TRACE)) == pytest.approx(1e3)


def test_predictor_dev_ms(program):
    # the kernel and the read-back start inside plan.predict: 0.2 s
    assert find("predictor_dev_ms").read(ctx(TRACE)) == pytest.approx(200.0)
    # a second plan without a predict span halves the mean; a nested plan
    # (a template's) adds to its outer plan's
    program(SPANS + [("plan", 8.0, 9.0, -1)])
    assert find("predictor_dev_ms").read(ctx(TRACE)) == pytest.approx(100.0)
    program(SPANS + [("plan", 0.5, 1.0, 0)])
    assert find("predictor_dev_ms").read(ctx(TRACE)) == pytest.approx(200.0)


def test_rerun_rows_pct(program):
    program(counters={"plan.rows": 400, "replan.rows": 100})
    assert find("rerun_rows_pct").read(ctx(TRACE)) == 25.0
    program(counters={"plan.rows": 400})
    assert find("rerun_rows_pct").read(ctx(TRACE)) == 0.0


NEW_READERS = ["exec_idle_ms", "plan_idle_ms", "predictor_dev_ms",
               "rerun_rows_pct"]


@pytest.mark.parametrize("name", NEW_READERS)
@pytest.mark.parametrize("case", ["no_program_record", "no_trace",
                                  "no_spans_of_its_layer"])
def test_a_new_reader_with_nothing_to_read_returns_none(name, case,
                                                        program):
    if case == "no_program_record":
        program(spans=None, counters=None)
        assert find(name).read(ctx(TRACE)) is None
    elif case == "no_trace":
        program(counters={})
        assert find(name).read(driver.Context()) is None
    else:
        program(spans=[("other", 1.0, 2.0, -1)],
                counters={"plan.rows": 0, "replan.rows": 3})
        assert find(name).read(ctx(TRACE)) is None


def test_idle_split_labels_and_sums():
    split = ps.idle_split(TRACE, SPANS)
    # a gap takes the benchmark span open at its middle (as in the
    # breakdown), and each of its instants the program's innermost span:
    # 0–1.5 s is outside the benchmark's spans at its middle, and holds
    # plan.bin's 0.2 s, plan's 0.05 + 0.05 s and plan.predict's 0.15 s
    assert split == pytest.approx({
        "outside": 1.05 + 1.1 + 2.05,
        "plan/plan.predict": 0.9,
        "call/execute.readback": 0.5 + 0.3,
        "outside/plan": 0.05 + 0.05 + 0.25,
        "outside/plan.predict": 0.15 + 0.1,
        "outside/plan.bin": 0.2,
        "outside/execute.dispatch": 0.1,
        "outside/execute": 0.05 + 0.05})
    by_prefix: dict = {}
    for k, v in split.items():
        by_prefix[k.split("/")[0]] = by_prefix.get(k.split("/")[0], 0) + v
    want = dict(tr.breakdown(TRACE)["idle_gaps"])
    assert by_prefix.keys() == want.keys()
    for k in want:
        assert by_prefix[k] == pytest.approx(want[k], abs=1e-12)


@pytest.mark.parametrize("seed", range(5))
def test_busy_and_split_match_the_trace_module_on_random_traces(seed):
    rng = random.Random(seed)
    ops = sorted(((f"k{i % 3}", s, s + rng.uniform(0, 0.3))
                  for i, s in enumerate(rng.uniform(0, 10) for _ in range(
                      200))), key=lambda o: o[1])
    spans = []
    for k in range(20):
        s = k * 0.5 + rng.uniform(0, 0.1)
        spans.append(("call" if k % 2 else "plan", s, s + 0.4))
    trace = tr.Trace(ops, spans, (0.0, 10.0))
    busy = ps.Busy(trace)
    for _ in range(50):
        lo = rng.uniform(-1, 11)
        hi = lo + rng.uniform(0, 3)
        assert busy(lo, hi) == pytest.approx(tr.busy(trace, lo, hi),
                                             abs=1e-9)
    split = ps.idle_split(trace, [("execute", s + 0.05, e - 0.05, -1)
                                  for n, s, e in spans if n == "call"])
    by_prefix: dict = {}
    for k, v in split.items():
        by_prefix[k.split("/")[0]] = by_prefix.get(k.split("/")[0], 0) + v
    for k, v in tr.breakdown(trace, top=100)["idle_gaps"]:
        assert by_prefix[k] == pytest.approx(v, abs=1e-9)


def test_innermost_takes_the_latest_open_start():
    spans = [("a", 0.0, 10.0), ("b", 1.0, 5.0), ("c", 2.0, 3.0),
             ("d", 4.0, 6.0)]
    assert ps.innermost(spans, [0.5, 2.5, 3.5, 4.5, 5.5, 7.0, 11.0]) == [
        "a", "c", "b", "d", "d", "a", None]


def test_the_program_record_is_read_on_the_profilers_clock():
    """A plan and an execute of the program under the profiler: the spans
    the benchmark reads are the profiler's own ranges, to the microsecond."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import tracing
    from repro_torch.sparse import random as sprand
    a = sprand.power_law(200, 200, 4, 1.5, seed=3)
    tracing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p = plan_mod.plan_spgemm(a, a, device="cpu",
                                 retry_policy=plan_mod.RetryPolicy())
        plan_mod.execute(p, a, a, cache=plan_mod.PlanCache())
    spans = ps.load()
    ranges = {e.name()[len(tracing.PREFIX):]: e
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(tracing.PREFIX)}
    assert sorted(s[0] for s in spans) == sorted(ranges)
    for name, s, e, _ in spans:
        r = ranges[name]
        assert abs(s - r.start_ns() * 1e-9) < 1e-4
        assert abs(e - (r.start_ns() + r.duration_ns()) * 1e-9) < 1e-4
    assert [s[0] for s in ps.top(spans, "plan")] == ["plan"]
    assert [s[0] for s in ps.top(spans, "execute")] == ["execute"]
    # no device work on the CPU: every span is idle throughout
    trace = tr.Trace([], [], (spans[0][1], spans[-1][2]))
    got = find("exec_idle_ms").read(ctx(trace))
    length = [e - s for n, s, e, _ in spans if n == "execute"][0]
    assert got == pytest.approx(1e3 * length)
    tracing.clear_spans()


@pytest.mark.cuda
def test_program_spans_on_the_card_leave_the_device_timeline(cuda_device):
    """On the card the program's ranges add no device-timeline event, so
    the trace's device operations are the kernels, copies and fills."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import plan as plan_mod
    from repro_torch.sparse import random as sprand
    a = sprand.power_law(2000, 2000, 8, 1.5, seed=3)
    p = plan_mod.plan_spgemm(a, a, device=cuda_device, use_kernel=True,
                             retry_policy=plan_mod.RetryPolicy())
    plan_mod.execute(p, a, a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p = plan_mod.plan_spgemm(a, a, device=cuda_device, use_kernel=True,
                                 retry_policy=plan_mod.RetryPolicy())
        plan_mod.execute(p, a, a)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    dev = [e.name() for e in events if e.device_type() != CPU]
    host = [e.name() for e in events if e.device_type() == CPU]
    assert dev and not [n for n in dev if n.startswith("repro_torch.")]
    assert "repro_torch.plan.predict" in host
    assert np.isfinite(p.predicted_nnz)
