"""The SpGEMM service (``serve/``) in the port against the JAX package.

* ``admission.estimate`` / ``estimate_cost`` / ``planned_bytes`` and the
  ``MemoryBudget`` ledger give JAX's numbers on the same plans (whole-B,
  ``pop_quant``, panels, a grown template), analytic and under a profile.
* The property suites of ``tests/test_queueing.py`` and the admission
  monotonicity pins hold for the port's copies.
* The lifecycle, batching, shedding, deadline, budget, requeue, breaker and
  straggler-recovery cases of ``tests/test_service.py`` run through both
  packages' services with one script (one ``FakeClock`` where the case has
  one): every request ends in the same state with the same history, error
  class, error context (the plan-key hash aside) and ``stats``
  (estimate, degradations, recoveries, retries), each service with the
  same counters, and every result has JAX's ``rpt``/``col`` and ``val``
  within rtol 1e-5 — through the plain versions and the kernel wrappers'
  CPU path.
* Repeat traffic builds no executor.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal CI image — deterministic tests must still run
    from hypothesis_shim import given, settings, st

from repro.core import faults as jfaults
from repro.core import plan as jplan_mod
from repro.core import profiles as jprofiles
from repro.serve import admission as jadmission
from repro.serve import spgemm_service as jsvc
from repro.sparse import random as sprand
from repro_torch.core import faults as tfaults
from repro_torch.core import plan as tplan_mod
from repro_torch.core.mesh import make_mesh
from repro_torch.core import profiles as tprofiles
from repro_torch.core.errors import AdmissionRejectedError
from repro_torch.serve import admission as tadmission
from repro_torch.serve import spgemm_service as tsvc
from repro_torch.serve.queueing import BoundedQueue
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

VAL_RTOL = 1e-5

FAMILIES = [
    ("er", sprand.erdos_renyi(250, 250, 4, seed=25),
     sprand.erdos_renyi(250, 250, 3, seed=26)),
    ("pl", sprand.power_law(300, 300, 5, 1.5, seed=21),
     sprand.power_law(300, 300, 4, 1.6, seed=22)),
    ("rmat", sprand.rmat(250, 250, 1250, seed=31),
     sprand.rmat(250, 250, 1000, seed=32)),
    ("band", sprand.banded(250, 250, 10, 14, seed=23),
     sprand.banded(250, 250, 8, 12, seed=24)),
    ("fem", sprand.banded(160, 160, 40, 30, seed=51),
     sprand.banded(160, 160, 32, 28, seed=52)),
]


@pytest.fixture(autouse=True)
def _cold_profiles():
    jprofiles.clear()
    tprofiles.clear()
    yield
    jprofiles.clear()
    tprofiles.clear()


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _nan(m):
    val = m.val.copy()
    val[len(val) // 2] = np.nan
    return type(m)(m.rpt, m.col, val, m.shape)


_NAN = _nan(sprand.erdos_renyi(50, 50, 3, seed=7))


def _rows(jm, n=40):
    return np.random.default_rng(2).integers(0, jm.nrows, n)


# --------------------------------------------------------------------------- #
# admission
# --------------------------------------------------------------------------- #
PLAN_VARIANTS = [("plain", {}), ("pop_quant", dict(pop_quant=True)),
                 ("panels", dict(n_panels=2))]


@functools.lru_cache(maxsize=None)
def _jax_plan(family, variant):
    _, a, b = next(f for f in FAMILIES if f[0] == family)
    pkw = dict(PLAN_VARIANTS)[variant]
    return jplan_mod.plan_spgemm(a, b, sample_rows=_rows(a), **pkw)


@pytest.mark.parametrize("variant", [v for v, _ in PLAN_VARIANTS])
@pytest.mark.parametrize("family", [f for f, _, _ in FAMILIES])
def test_admission_prices_match_jax(family, variant):
    jp = _jax_plan(family, variant)
    _, a, b = next(f for f in FAMILIES if f[0] == family)
    tp = tplan_mod.plan_spgemm(_host(a), _host(b), sample_rows=_rows(a),
                               device="cpu", **dict(PLAN_VARIANTS)[variant])
    assert tadmission.planned_bytes(tp) == jadmission.planned_bytes(jp) > 0
    kw = lambda p: dict(nnz_a=p.cap_a, nnz_b=p.cap_b,      # noqa: E731
                        nrows_b=p.shape_b[0], safety=p.safety,
                        n_panels=p.n_panels)
    for prof in (None, dict(flops=1e6, bytes_per_s=2e6)):
        if prof is not None:
            doc = dict(version=1, device_kind="cpu", cells=[], **prof)
            jprofiles.set_active(jprofiles.RouteProfile.from_json(doc))
            tprofiles.set_active(tprofiles.RouteProfile.from_json(doc))
        want = jadmission.estimate(jp.shape_a[0], jp.structure, jp.flopr,
                                   jp.compression_ratio, **kw(jp))
        got = tadmission.estimate(tp.shape_a[0], tp.structure, tp.flopr,
                                  tp.compression_ratio, **kw(tp))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        cost = tadmission.estimate_cost(tp)
        assert dataclasses.asdict(cost) == dataclasses.asdict(
            jadmission.estimate_cost(jp))
        assert cost.capacity_bytes >= tadmission.planned_bytes(tp)
        assert cost.stats() == jadmission.estimate_cost(jp).stats()
        jprofiles.clear()
        tprofiles.clear()
    assert tadmission.capacity_bound_rows(tp.structure, tp.flopr, 1.3) \
        == jadmission.capacity_bound_rows(jp.structure, jp.flopr, 1.3)


def test_estimate_cost_covers_template_growth_like_jax():
    """A template grown by a denser sibling inflates a replanned member's
    capacities; both packages price it at the planned bytes."""
    fams = dict((f, (a, b)) for f, a, b in FAMILIES)
    small = fams["pl"]
    big = (sprand.power_law(300, 300, 9, 1.3, seed=91),
           sprand.power_law(300, 300, 8, 1.4, seed=92))
    got = {}
    for name, mod, adm, host, kw in (
            ("jax", jplan_mod, jadmission, lambda m: m, {}),
            ("port", tplan_mod, tadmission, _host, dict(device="cpu"))):
        reg = mod.TemplateRegistry()
        for a, b in (small, big, small):
            p = mod.plan_spgemm(host(a), host(b), template="auto",
                                registry=reg, sample_rows=_rows(a), **kw)
        est = adm.estimate_cost(p)
        assert est.capacity_bytes >= adm.planned_bytes(p)
        assert est.total_bytes == est.capacity_bytes + est.operand_bytes
        got[name] = (dataclasses.asdict(est), adm.planned_bytes(p))
    assert got["port"] == got["jax"]


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


PRICE_VARIANTS = [("whole", {}), ("panels", dict(n_panels=2)),
                  ("dist", dict(shards=4)),
                  ("dist_panels", dict(shards=4, n_panels=2))]


@pytest.mark.parametrize("variant", [v for v, _ in PRICE_VARIANTS])
@pytest.mark.parametrize("family", [f for f, _, _ in FAMILIES])
def test_device_price_covers_what_execute_returns(family, variant):
    """The port's price of its device allocation (``admission.
    device_price``) is at or above the bytes of the tensors ``execute``
    returns plus the operands at their padded capacities — whole-B, with
    panels, and on a mesh (four CPU devices, per device) — and on a CPU
    plan admission still reserves JAX's price."""
    _, a, b = next(f for f in FAMILIES if f[0] == family)
    a, b = _host(a), _host(b)
    kw = dict(dict(PRICE_VARIANTS)[variant])
    shards = kw.pop("shards", 0)
    if shards:
        kw["mesh"] = make_mesh((shards,), ("data",), devices=["cpu"] * shards)
    for use_kernel in (False, True):
        p = tplan_mod.plan_spgemm(a, b, sample_rows=_rows(a), device="cpu",
                                  use_kernel=use_kernel, **kw)
        out = tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
        operands = (tadmission._csr_bytes(a.nrows, p.cap_a)
                    + tadmission._csr_bytes(b.nrows, p.cap_b))
        price = tadmission.device_price(p)
        assert price["total"] >= _tensor_bytes(tuple(out)) + operands
        assert price["total"] == max(d["total"] for d in price["devices"])
        if shards:
            assert [d["shards"] for d in price["devices"]] == [[0, 1, 2, 3]]
        est = tadmission.estimate_cost(p)
        assert type(est) is tadmission.CostEstimate
        assert est.reserve_bytes == est.total_bytes
        assert est.reserved_by == "jax_estimate"
        budget = tadmission.MemoryBudget(est.total_bytes)
        budget.reserve(est)
        assert budget.remaining == 0


def test_a_device_estimate_reserves_the_larger_price():
    """A CUDA plan's estimate carries the device price: admission reserves
    the larger of it and JAX's, and ``stats()`` says which set it."""
    base = dict(flop=0, predicted_nnz=0.0, compression_ratio=1.0,
                operand_bytes=0, capacity_bytes=100, total_bytes=100,
                est_seconds=0.0)
    lo = tadmission.DeviceCostEstimate(**base, device_bytes=60)
    hi = tadmission.DeviceCostEstimate(**base, device_bytes=250)
    assert (lo.reserve_bytes, lo.reserved_by) == (100, "jax_estimate")
    assert (hi.reserve_bytes, hi.reserved_by) == (250, "device_price")
    assert hi.stats()["reserve_bytes"] == 250
    assert hi.stats()["reserved_by"] == "device_price"
    budget = tadmission.MemoryBudget(300)
    budget.reserve(hi)
    assert budget.remaining == 50 and not budget.fits_now(lo)
    budget.release(hi)
    assert budget.remaining == 300


def test_memory_budget_ledger_matches_jax():
    def flat(adm, n):
        return adm.CostEstimate(flop=0, predicted_nnz=0.0,
                                compression_ratio=1.0, operand_bytes=0,
                                capacity_bytes=n, total_bytes=n,
                                est_seconds=0.0)

    trace = {}
    for name, adm in (("jax", jadmission), ("port", tadmission)):
        b = adm.MemoryBudget(1000)
        est = flat(adm, 400)
        log = [b.fits_ever(est), b.fits_now(est)]
        b.reserve(est)
        b.reserve(est)
        log += [b.remaining, b.fits_now(est), b.fits_ever(est),
                b.fits_ever(flat(adm, 1001))]
        try:
            b.reserve(est)
        except ValueError as e:
            log += [type(e).__name__, dict(e.context)]
        for _ in range(3):
            b.release(est)
        log += [b.stats()]
        try:
            adm.MemoryBudget(0)
        except ValueError as e:
            log += [type(e).__name__]
        trace[name] = log
    assert trace["port"] == trace["jax"]
    assert trace["port"][6] == "AdmissionRejectedError"


def _estimate(structure, flopr, *, n_panels=0):
    return tadmission.estimate(
        len(structure), np.asarray(structure, dtype=np.float64),
        np.asarray(flopr, dtype=np.float64), 2.0, nnz_a=64, nnz_b=64,
        nrows_b=64, safety=1.3, n_panels=n_panels)


@settings(max_examples=40)
@given(st.lists(st.integers(0, 512), min_size=1, max_size=40),
       st.integers(1, 16), st.integers(1, 8), st.integers(1, 4))
def test_estimate_is_monotone(raw, num, den, panels):
    """``tests/test_admission.py``'s monotonicity pins on the port: more
    predicted structure, a higher FLOP bound or more panels never price
    cheaper."""
    structure = [x / 8.0 for x in raw]
    flopr = [4.0 * x + 8.0 for x in structure]
    scale = 1.0 + num / den
    lo = _estimate(structure, flopr)
    for hi in (_estimate([s * scale for s in structure],
                         [f * scale for f in flopr]),
               _estimate(structure, [f + num for f in flopr]),
               _estimate(structure, flopr, n_panels=panels + 1)):
        assert hi.capacity_bytes >= lo.capacity_bytes
        assert hi.total_bytes >= lo.total_bytes
        assert hi.est_seconds >= lo.est_seconds


# --------------------------------------------------------------------------- #
# the bounded queue: tests/test_queueing.py's properties on the port's copy
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(eq=False)
class Ticket:
    id: int
    deadline: float | None


def _tickets(codes):
    return [Ticket(i, None if c < 0 else float(c))
            for i, c in enumerate(codes)]


@given(st.lists(st.integers(-5, 20), min_size=0, max_size=32))
@settings(max_examples=60, deadline=None)
def test_expire_preserves_survivor_order(codes):
    reqs = _tickets(codes)
    q = BoundedQueue(64)
    for r in reqs:
        q.push(r)
    dead = q.expire(10.0)
    live = [q.pop() for _ in range(len(q))]
    assert live == [r for r in reqs if r.deadline is None or r.deadline > 10]
    assert dead == [r for r in reqs
                    if r.deadline is not None and r.deadline <= 10]
    assert q.expired == len(dead)


@given(st.lists(st.integers(-5, 20), min_size=1, max_size=32),
       st.lists(st.booleans(), min_size=1, max_size=8),
       st.integers(0, 15))
@settings(max_examples=60, deadline=None)
def test_gather_restore_round_trips_under_expiry(codes, takes, now_i):
    now = float(now_i)
    reqs = _tickets(codes)
    q = BoundedQueue(64)
    for r in reqs:
        q.push(r)
    batch, keep = [], []
    for take in takes:
        if not len(q):
            break
        r = q.pop()
        (batch if take else keep).append(r)
    dead = q.expire(now)
    q.restore_front(keep)
    out = [q.pop() for _ in range(len(q))]
    popped = {id(r) for r in batch} | {id(r) for r in keep}
    tail = [r for r in reqs if id(r) not in popped
            and not (r.deadline is not None and r.deadline <= now)]
    assert out == keep + tail
    assert all(id(r) not in {id(x) for x in out} for r in dead)
    q2 = BoundedQueue(64)
    for r in tail:
        q2.push(r)
    q2.restore(keep)
    assert [q2.pop() for _ in range(len(q2))] == tail + keep


@given(st.lists(st.integers(-5, 20), min_size=0, max_size=32))
@settings(max_examples=60, deadline=None)
def test_promote_earliest_is_stable_min_rotation(codes):
    reqs = _tickets(codes)
    q = BoundedQueue(64)
    for r in reqs:
        q.push(r)
    q.promote_earliest()
    q.promote_earliest()
    out = [q.pop() for _ in range(len(q))]
    with_dl = [r for r in reqs if r.deadline is not None]
    if not with_dl:
        assert out == reqs
    else:
        best = min(with_dl, key=lambda r: r.deadline)
        assert out[0] is best and out[1:] == [r for r in reqs
                                              if r is not best]


def test_full_queue_sheds_typed_and_requeues_never_shed():
    q = BoundedQueue(2)
    q.push(Ticket(0, None))
    q.push(Ticket(1, None))
    with pytest.raises(AdmissionRejectedError) as exc:
        q.push(Ticket(2, None))
    assert exc.value.context == dict(reason="queue_full", request=2,
                                     observed=2, planned=2)
    q.push_front(Ticket(3, None))        # one transient slot over capacity
    assert len(q) == 3 and q.stats() == dict(depth=3, capacity=2, shed=1,
                                             expired=0)
    with pytest.raises(ValueError):
        BoundedQueue(0)


# --------------------------------------------------------------------------- #
# the service: one script through both packages
# --------------------------------------------------------------------------- #
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FuseClock(FakeClock):
    """Jumps by ``jump`` on the Nth next read (``tests/test_service.py``)."""

    def __init__(self):
        super().__init__()
        self._fuse = None

    def arm(self, after_calls: int, jump: float) -> None:
        self._fuse = [int(after_calls), float(jump)]

    def __call__(self) -> float:
        if self._fuse is not None:
            self._fuse[0] -= 1
            if self._fuse[0] == 0:
                self.t += self._fuse[1]
                self._fuse = None
        return self.t


class Env:
    """One package's service, planner, faults and operands."""

    def __init__(self, pkg: str, use_kernel: bool = False):
        self.pkg = pkg
        if pkg == "jax":
            self.svc, self.plan, self.faults = jsvc, jplan_mod, jfaults
            self.profiles, host, self.extra = jprofiles, (lambda m: m), {}
        else:
            self.svc, self.plan, self.faults = tsvc, tplan_mod, tfaults
            self.profiles, host = tprofiles, _host
            self.extra = dict(device="cpu", use_kernel=use_kernel)
        self.fams = [(host(a), host(b)) for _, a, b in FAMILIES]
        self.nan = host(_NAN)

    def service(self, clock=None, **cfg):
        kw = dict(self.extra, **cfg)
        return self.svc.SpgemmService(self.svc.ServiceConfig(**kw),
                                      **({} if clock is None
                                         else dict(clock=clock)))


# each scenario: env → (requests, services, per-step terminal ids, fake
# clock?) — tests/test_service.py's cases, in its order
def _lifecycle(env):
    a, b = env.fams[0]
    svc = env.service()
    req = svc.submit(a, b)
    svc.drain()
    return [req], [svc], [], False


def _result_xor_error(env):
    a, b = env.fams[0]
    svc = env.service(queue_capacity=1)
    reqs = [svc.submit(a, b), svc.submit(a, b), svc.submit(env.nan, env.nan)]
    svc.drain()
    return reqs, [svc], [], False


def _batch_one_wave(env):
    a, b = env.fams[0]
    svc = env.service(max_batch=8)
    reqs = [svc.submit(a, b) for _ in range(5)]
    steps = [[r.id for r in svc.step()]]
    return reqs, [svc], steps, False


def _gather_stops_when_full(env):
    a, b = env.fams[0]
    svc = env.service(max_batch=3, queue_capacity=64)
    reqs = [svc.submit(a, b) for _ in range(10)]
    steps = [[r.id for r in svc.step()], [r.id for r in svc._queue._q]]
    svc.drain()
    return reqs, [svc], steps, False


def _mixed_shapes(env):
    (a0, b0), (a4, b4) = env.fams[0], env.fams[4]
    svc = env.service(max_batch=8)
    reqs = [svc.submit(a0, b0), svc.submit(a4, b4), svc.submit(a0, b0)]
    steps = [[r.id for r in svc.step()]]
    svc.drain()
    return reqs, [svc], steps, False


def _queue_full_sheds(env):
    a, b = env.fams[0]
    svc = env.service(queue_capacity=2)
    reqs = [svc.submit(a, b) for _ in range(5)]
    svc.drain()
    return reqs, [svc], [], False


def _deadline_expires(env):
    a, b = env.fams[0]
    clk = FakeClock()
    svc = env.service(clk)
    reqs = [svc.submit(a, b, deadline=5.0), svc.submit(a, b)]
    clk.advance(10.0)
    steps = [sorted(r.id for r in svc.drain())]
    return reqs, [svc], steps, True


def _default_deadline(env):
    a, b = env.fams[0]
    clk = FakeClock()
    svc = env.service(clk, default_deadline=3.0)
    req = svc.submit(a, b)
    clk.advance(4.0)
    svc.drain()
    return [req], [svc], [], True


def _nonpositive_deadline(env):
    a, b = env.fams[0]
    svc = env.service()
    reqs = [svc.submit(a, b, deadline=dl) for dl in (0.0, -1.0)]
    reqs.append(svc.submit(a, b, deadline=60.0))
    svc.drain()
    return reqs, [svc], [], False


def _unreachable_deadline(env):
    a, b = env.fams[0]
    clk = FakeClock()
    svc = env.service(clk)
    req = svc.submit(a, b, deadline=10.0)
    env.profiles.set_active(env.profiles.RouteProfile(
        version=env.profiles.PROFILE_VERSION, device_kind="test-slow",
        flops=1e3, bytes_per_s=1e3, cells=()))
    try:
        clk.advance(5.0)
        svc.drain()
    finally:
        env.profiles.clear()
    return [req], [svc], [], True


def _shortest_deadline_first(env):
    (a0, b0), (a4, b4) = env.fams[0], env.fams[4]
    svc = env.service(max_batch=1)
    reqs = [svc.submit(a0, b0, deadline=100.0), svc.submit(a4, b4),
            svc.submit(a4, b4, deadline=5.0)]
    steps = [[r.id for r in svc.step()], [r.id for r in svc.step()]]
    svc.drain()
    svc2 = env.service(max_batch=1)
    reqs += [svc2.submit(a0, b0), svc2.submit(a4, b4)]
    steps += [[r.id for r in svc2.step()], [r.id for r in svc2.step()]]
    return reqs, [svc, svc2], steps, False


def _budget_backpressure(env):
    a, b = env.fams[0]
    probe = env.service()
    r = probe.submit(a, b)
    probe.drain()
    svc = env.service(device_budget_bytes=int(r.estimate.total_bytes * 1.5),
                      max_batch=8)
    reqs = [svc.submit(a, b) for _ in range(4)]
    svc.drain()
    return [r] + reqs, [probe, svc], [], False


def _over_budget(env):
    a, b = env.fams[0]
    svc = env.service(device_budget_bytes=4096)
    req = svc.submit(a, b)
    svc.drain()
    return [req], [svc], [], False


def _requeue_then_degrade(env):
    a, b = env.fams[1]
    P = env.plan.RetryPolicy
    svc = env.service(
        retry_policy=P(rounds=0, exact_fallback=False, on_exhausted="raise"),
        escalated_policy=P(rounds=0, exact_fallback=True,
                           on_exhausted="raise"))
    req = svc.submit(a, b)
    with env.faults.inject(capacity_scale=0.1):
        svc.drain()
    return [req], [svc], [], False


def _requeue_then_fail(env):
    a, b = env.fams[1]
    hard = env.plan.RetryPolicy(rounds=0, exact_fallback=False,
                                on_exhausted="raise")
    svc = env.service(retry_policy=hard, escalated_policy=hard)
    req = svc.submit(a, b)
    with env.faults.inject(capacity_scale=0.05):
        svc.drain()
    return [req], [svc], [], False


def _breaker_trips_and_recovers(env):
    a, b = env.fams[0]
    clk = FakeClock()
    svc = env.service(clk, max_batch=1, breaker_threshold=2,
                      breaker_cooldown=10.0)
    reqs = []
    for _ in range(2):
        reqs.append(svc.submit(a, b))
        with env.faults.inject(fail_executor={"unit": "local"}):
            svc.step()
    reqs.append(svc.submit(a, b))           # fails fast: circuit open
    svc.step()
    steps = [svc.stats()["breakers"]]
    clk.advance(11.0)
    reqs.append(svc.submit(a, b))           # the half-open probe
    svc.step()
    reqs.append(svc.submit(a, b))
    svc.step()
    return reqs, [svc], steps, True


def _breaker_isolation(env):
    (a0, b0), (a4, b4) = env.fams[0], env.fams[4]
    svc = env.service(max_batch=1, breaker_threshold=1)
    dead = svc.submit(a0, b0)
    with env.faults.inject(fail_executor={"unit": "local"}):
        svc.step()
    other = svc.submit(a4, b4)
    svc.drain()
    return [dead, other], [svc], [], False


def _expired_probe_reopens(env):
    a, b = env.fams[0]
    clk = FuseClock()
    svc = env.service(clk, max_batch=1, breaker_threshold=1,
                      breaker_cooldown=10.0)
    reqs = [svc.submit(a, b)]
    with env.faults.inject(fail_executor={"unit": "local"}):
        svc.step()
    (br,) = svc._breakers.values()
    opened = br.opened_at
    clk.advance(11.0)
    reqs.append(svc.submit(a, b, deadline=2.0))
    clk.arm(2, 3.0)
    svc.step()
    steps = [[br.state, br.opened_at == opened]]
    reqs.append(svc.submit(a, b))
    svc.step()
    steps.append([br.state])
    return reqs, [svc], steps, True


def _straggler_degrades(env):
    a, b = env.fams[0]
    svc = env.service(dispatch_budget=env.plan.DispatchBudget(
        multiple=50.0, floor_s=5.0))
    warm = svc.submit(a, b)
    svc.drain()
    req = svc.submit(a, b)
    with env.faults.inject(delay_executor={"unit": "local"}, delay_s=30.0):
        svc.drain()
    return [warm, req], [svc], [], False


def _latency_excludes_rejected(env):
    a, b = env.fams[0]
    clk = FakeClock()
    svc = env.service(clk, queue_capacity=1)
    reqs = [svc.submit(a, b), svc.submit(a, b)]
    clk.advance(5.0)
    svc.drain()
    return reqs, [svc], [], True


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _lifecycle, _result_xor_error, _batch_one_wave, _gather_stops_when_full,
    _mixed_shapes, _queue_full_sheds, _deadline_expires, _default_deadline,
    _nonpositive_deadline, _unreachable_deadline, _shortest_deadline_first,
    _budget_backpressure, _over_budget, _requeue_then_degrade,
    _requeue_then_fail, _breaker_trips_and_recovers, _breaker_isolation,
    _expired_probe_reopens, _straggler_degrades, _latency_excludes_rejected)}

# the service counters compared across packages (latencies only under a
# fake clock; executor caches count differently: JAX traces, the port
# builds)
SERVICE_KEYS = ("submitted", "terminal", "in_flight", "requeues", "waves",
                "batched_requests", "faults_armed", "queue", "budget",
                "breakers")


def _summary(req):
    err = req.error
    ctx = ({k: v for k, v in err.context.items() if k != "plan_key"}
           if err is not None else None)
    return dict(
        id=req.id, state=req.state, history=[s for s, _ in req.history],
        error=type(err).__name__ if err is not None else None,
        context=ctx, cause=(type(err.__cause__).__name__
                            if err is not None and err.__cause__ is not None
                            else None),
        attempts=req.attempts, result=req.result is not None,
        stats={k: req.stats[k] for k in ("estimate", "degradations",
                                         "recoveries", "retries")
               if k in req.stats},
        first_error="first_error" in req.stats)


def _run(env, name):
    reqs, svcs, steps, fake = SCENARIOS[name](env)
    assert not env.faults.armed()
    keys = SERVICE_KEYS + (("latency", "terminal_latency") if fake else ())
    return dict(reqs=[_summary(r) for r in reqs],
                results=[r.result for r in reqs],
                svcs=[{k: s.stats()[k] for k in keys} for s in svcs],
                steps=steps)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    return _run(Env("jax"), name)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_script_matches_jax(name, use_kernel):
    want = _jax_run(name)
    got = _run(Env("port", use_kernel), name)
    assert got["reqs"] == want["reqs"]
    assert got["svcs"] == want["svcs"]
    assert got["steps"] == want["steps"]
    for c, jc in zip(got["results"], want["results"]):
        assert (c is None) == (jc is None)
        if c is None:
            continue
        np.testing.assert_array_equal(c.rpt, jc.rpt)
        np.testing.assert_array_equal(c.col, jc.col)
        np.testing.assert_allclose(c.val, jc.val, rtol=VAL_RTOL, atol=1e-5)
    # every ticket terminal; every script drains its queues
    assert all(r["state"] in tsvc.RequestState.TERMINAL
               for r in got["reqs"])
    assert all(s["in_flight"] == 0 and s["queue"]["depth"] == 0
               for s in got["svcs"])


def test_scripts_reach_every_outcome():
    """The scripts above cover each terminal state, each rejection reason
    and both recovery ledgers (checked on JAX's run, which the port's
    equals)."""
    runs = [_jax_run(n) for n in SCENARIOS]
    reqs = [r for run in runs for r in run["reqs"]]
    assert {r["state"] for r in reqs} == set(tsvc.RequestState.TERMINAL)
    reasons = {r["context"].get("reason") for r in reqs if r["context"]}
    assert {"queue_full", "nonpositive_deadline", "deadline_unreachable",
            "over_budget", "circuit_open"} <= reasons
    assert any(r["stats"].get("recoveries") for r in reqs)
    assert any(r["stats"].get("degradations") for r in reqs)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_repeat_traffic_builds_no_executor(use_kernel):
    env = Env("port", use_kernel)
    svc = env.service()
    for a, b in env.fams:
        svc.submit(a, b)
    svc.drain()
    builds = svc.stats()["plan_cache"]["traces"]
    reqs = [svc.submit(a, b) for a, b in env.fams for _ in range(3)]
    svc.drain()
    assert svc.stats()["plan_cache"]["traces"] == builds
    assert all(r.state == tsvc.RequestState.DONE for r in reqs)
    assert svc.stats()["templates"]["misses"] == len(env.fams)


@pytest.mark.parametrize("shards", [1, 4])
def test_a_mesh_routes_plans_through_the_distributed_path(shards):
    """``ServiceConfig(mesh=...)`` plans every request on the mesh.  On one
    shard, under ``lose_shard``, recovery has no survivor: every request
    ends FAILED with JAX's typed :class:`ShardFailureError` and context
    (``tests/test_service.py``'s class 7, a one-device JAX mesh
    in-process).  On four CPU shards the clean pass is DONE and the pass
    under ``lose_shard`` DEGRADED with its recovery ledger, each result
    bitwise equal to the clean one, and no breaker trips."""
    env = Env("port")
    mesh = make_mesh((shards,), ("data",), devices=["cpu"] * shards)
    svc = env.service(queue_capacity=16, breaker_cooldown=0.0, mesh=mesh)
    if shards == 1:
        import jax
        jenv = Env("jax")
        jsv = jenv.service(queue_capacity=16, breaker_cooldown=0.0,
                           mesh=jax.make_mesh((1,), ("data",)))
        got, want = [], []
        for e, sv, out in ((env, svc, got), (jenv, jsv, want)):
            reqs = [sv.submit(a, b) for a, b in e.fams]
            with e.faults.inject(lose_shard=0):
                sv.drain()
            out += [(r.state, type(r.error).__name__,
                     {k: v for k, v in r.error.context.items()
                      if k != "plan_key"}) for r in reqs]
        assert got == want
        assert {g[:2] for g in got} == {("FAILED", "ShardFailureError")}
        return
    warm = [svc.submit(a, b) for a, b in env.fams]
    svc.drain()
    reqs = [svc.submit(a, b) for a, b in env.fams]
    with tfaults.inject(lose_shard=2):
        svc.drain()
    assert [r.state for r in warm] == ["DONE"] * len(env.fams)
    assert [r.state for r in reqs] == ["DEGRADED"] * len(env.fams)
    for r, w in zip(reqs, warm):
        assert r.error is None and r.stats["recoveries"]
        assert r.stats["recoveries"][0]["kind"] == "wave_failed"
        np.testing.assert_array_equal(r.result.rpt, w.result.rpt)
        np.testing.assert_array_equal(r.result.col, w.result.col)
        np.testing.assert_array_equal(r.result.val.view(np.int32),
                                      w.result.val.view(np.int32))
    assert sum(b["trips"] for b in svc.stats()["breakers"]) == 0
    assert svc.stats()["queue"]["depth"] == 0