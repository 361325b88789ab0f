"""The per-layer metrics' arithmetic on a synthetic trace."""
import pytest

from chipbench import driver
from chipbench import trace as tr
from chipbench.layer_metrics import find

# a window of 10 s: two calls, each 2 s long with 1 s of device work in 3
# operations (two of them overlapping), and one plan span with predictor
# kernels inside and one numeric kernel outside
TRACE = tr.Trace(
    device_ops=sorted([
        ("void esc_numeric_warp_kernel<1>", 1.0, 1.5),
        ("Memcpy HtoD", 1.4, 1.6),
        ("void bin_numeric_kernel", 2.5, 2.9),
        ("void esc_numeric_warp_kernel<1>", 5.0, 5.5),
        ("Memset", 5.5, 5.6),
        ("void esc_numeric_warp_kernel<1>", 6.0, 6.4),
        ("void esc_symbolic_kernel<0>", 8.1, 8.2),
        ("void bitmask_symbolic_kernel<1, 2>", 8.3, 8.35),
        ("void esc_numeric_warp_kernel<1>", 8.6, 8.7),
    ], key=lambda o: o[1]),
    spans=[("call", 1.0, 3.0), ("call", 5.0, 7.0), ("plan", 8.0, 8.5)],
    window=(0.0, 10.0))


def ctx(**kw):
    c = driver.Context(trace=TRACE, call_bounds=[0.25, 0.25])
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def test_trace_arithmetic():
    assert tr.busy(TRACE, 1.0, 3.0) == pytest.approx(1.0)
    assert tr.busy(TRACE, 0.0, 10.0) == pytest.approx(2.25)
    assert tr.union([(0, 1), (0.5, 2), (3, 4)], 0.5, 3.5) == [[0.5, 2],
                                                              [3, 3.5]]
    b = tr.breakdown(TRACE)
    assert b["device_ops"][0] == ["void esc_numeric_warp_kernel<1>",
                                  pytest.approx(1.5)]
    idle = dict(b["idle_gaps"])
    # gaps are named by the span open at their middle
    assert idle["call"] == pytest.approx(0.9 + 0.4)
    assert idle["plan"] == pytest.approx(0.5 - 0.15)
    assert sum(idle.values()) == pytest.approx(10.0 - 2.25)


def test_launches_per_call():
    assert find("launches_per_call").read(ctx()) == 3.0


def test_numeric_roofline():
    assert find("numeric_roofline").read(ctx()) == pytest.approx(25.0)


def test_call_mfu():
    assert find("call_mfu").read(ctx()) == pytest.approx(12.5)


def test_idle_pct():
    assert find("idle_pct").read(ctx()) == pytest.approx(77.5)


def test_predict_dev_ms():
    assert find("predict_dev_ms").read(ctx()) == pytest.approx(150.0)


def test_plan_ms_and_replan_rows_pct():
    assert find("plan_ms").read(ctx(plan_ms=[3.0, 1.0, 2.0])) == 2.0
    assert find("replan_rows_pct").read(ctx(replan=(3, 200))) == 1.5


@pytest.mark.parametrize("name", ["launches_per_call", "numeric_roofline",
                                  "call_mfu", "idle_pct", "predict_dev_ms",
                                  "plan_ms", "replan_rows_pct"])
def test_a_reader_with_nothing_to_read_returns_none(name):
    assert find(name).read(driver.Context()) is None
    assert find(name).read(driver.Context(trace=tr.Trace(
        [], [], (0.0, 1.0)))) is None
