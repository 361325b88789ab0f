"""Fault injection and typed executor failures in the port against the JAX
package: the containment matrix of ``tests/test_faults.py`` run through
both.

Under every injected fault class (``core.faults``) on every family, the
port's ``plan_spgemm`` → ``execute`` → ``reassemble`` ends as JAX's does:
the same typed error (class and context, the plan-key hash aside) or the
same CSR (``rpt``/``col`` exactly, ``val`` within rtol 1e-5), which also
equals the dense oracle.  The fault hooks sit at JAX's call sites:
capacity starvation where every capacity is planned, sketch corruption
after the prediction, gather starvation on the panel operands, and executor
failure in :func:`repro_torch.core.plan._invoke_executor`, which every
dispatch goes through with JAX's unit names.  The straggler class
(``delay``) runs through the dispatch budget and single-device recovery:
JAX's recovery ledger and CSR.  The shard-loss class (``lose``) runs on a
mesh of CPU devices: on one shard recovery has no survivor and raises
JAX's typed error; on four the lost shard's rows re-home on the survivors,
bitwise equal to the no-fault run.  On the CPU ``use_kernel`` runs the
kernel wrappers' plain versions."""
import functools
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import plan as jplan_mod
from repro.sparse import random as sprand
from repro_torch.core import faults
from repro_torch.core import plan as tplan_mod
from repro_torch.core.mesh import make_mesh
from repro_torch.core.errors import (CapacityExhaustedError,
                                     OperandValidationError,
                                     ShardFailureError,
                                     SpgemmError, StragglerError)
from repro_torch.sparse.formats import CSR, spgemm_dense_oracle

torch.set_num_threads(1)

VAL_RTOL = 1e-5

FAMILIES = {
    "er": (sprand.erdos_renyi(250, 250, 4, seed=25),
           sprand.erdos_renyi(250, 250, 3, seed=26)),
    "pl": (sprand.power_law(300, 300, 5, 1.5, seed=21),
           sprand.power_law(300, 300, 4, 1.6, seed=22)),
    "rmat": (sprand.rmat(250, 250, 1250, seed=31),
             sprand.rmat(250, 250, 1000, seed=32)),
    "band": (sprand.banded(250, 250, 10, 14, seed=23),
             sprand.banded(250, 250, 8, 12, seed=24)),
    "fem": (sprand.banded(160, 160, 40, 30, seed=51),
            sprand.banded(160, 160, 32, 28, seed=52)),
}

# the straggler class's budget, built per package in _run: a floor far
# above a clean wave's time on a loaded host, far below the 30 s delay
WATCHDOG = "watchdog"

# (name, inject kwargs, plan kwargs, outcome) — tests/test_faults.py's
# matrix, the panel-wave executor failure added
FAULTS = [
    ("capacity", dict(capacity_scale=0.2), {}, "ok"),
    ("sketch", dict(sketch_scale=0.05), {}, "ok"),
    ("gather", dict(gather_scale=0.25), dict(n_panels=2), "raise"),
    ("executor", dict(fail_executor={"unit": "local"}), {}, "raise"),
    ("executor_panels", dict(fail_executor={"unit": "local-panels"}),
     dict(n_panels=2), "raise"),
    ("operand", None, {}, "raise"),
    # the watchdog fires and per-unit recovery replays the wave bitwise
    ("delay", dict(delay_executor={"unit": "local"}, delay_s=30.0),
     dict(dispatch_budget=WATCHDOG), "ok"),
]


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _rows(jm, n=40):
    return np.random.default_rng(2).integers(0, jm.nrows, n)


def _operands(family, fault):
    a, b = FAMILIES[family]
    if fault == "operand":
        bad = a.val.copy()
        bad[bad.size // 2] = np.nan
        a = type(a)(a.rpt, a.col, bad, a.shape)
    return a, b


def _run(mod, fmod, a, b, inj, pkw, cache=None, **kw):
    """One faulted plan → execute → reassemble: ("ok", CSR, plan) or
    ("raise", error, None)."""
    if pkw.get("dispatch_budget") == WATCHDOG:
        pkw = dict(pkw, dispatch_budget=mod.DispatchBudget(multiple=50.0,
                                                           floor_s=5.0))
    try:
        with fmod.inject(**(inj or {})):
            p = mod.plan_spgemm(a, b, safety=1.3, sample_rows=_rows(a),
                                retry_policy=mod.RetryPolicy(rounds=2),
                                **pkw, **kw)
            out = mod.execute(p, a, b, cache=cache or mod.PlanCache())
            return "ok", mod.reassemble(p, out), p
    except jplan_mod.SpgemmError as e:      # the JAX package's taxonomy
        return "raise", e, None
    except SpgemmError as e:
        return "raise", e, None


@functools.lru_cache(maxsize=None)
def _jax_cache(family):
    """One JAX plan cache a family: its faulted runs share the re-run
    buckets' compiled executors (an outcome does not depend on them)."""
    return jplan_mod.PlanCache()


@functools.lru_cache(maxsize=None)
def _jax_case(family, fault):
    _, inj, pkw, _ = next(f for f in FAULTS if f[0] == fault)
    a, b = _operands(family, fault)
    return _run(jplan_mod, jfaults, a, b, inj, pkw, cache=_jax_cache(family))


def _context(err):
    return {k: v for k, v in err.context.items() if k != "plan_key"}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("fault,inj,pkw,outcome", FAULTS,
                         ids=[f[0] for f in FAULTS])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_containment_matrix_matches_jax(family, fault, inj, pkw, outcome,
                                        use_kernel):
    jkind, jres, jp = _jax_case(family, fault)
    a, b = _operands(family, fault)
    kind, res, p = _run(tplan_mod, faults, _host(a), _host(b), inj, pkw,
                        use_kernel=use_kernel, device="cpu")
    assert not faults.armed()
    assert kind == jkind == outcome, (kind, res)
    if outcome == "raise":
        assert type(res).__name__ == type(jres).__name__
        assert isinstance(res, ValueError)
        assert set(res.context) == set(jres.context)
        assert _context(res) == _context(jres)
        if fault.startswith("executor"):
            assert isinstance(res, ShardFailureError)
            assert isinstance(res.__cause__, faults.InjectedFault)
        if fault == "operand":
            assert isinstance(res, OperandValidationError)
        if fault == "gather":
            assert isinstance(res, CapacityExhaustedError)
            assert res.context["observed"] > res.context["planned"]
        return
    np.testing.assert_array_equal(res.rpt, jres.rpt)
    np.testing.assert_array_equal(res.col, jres.col)
    np.testing.assert_allclose(res.val, jres.val, rtol=VAL_RTOL, atol=1e-5)
    np.testing.assert_allclose(res.to_dense(),
                               spgemm_dense_oracle(_host(a), _host(b)),
                               rtol=1e-4, atol=1e-4)
    assert p.stats()["degradations"] == p.degradations
    assert p.stats()["recoveries"] == p.recoveries == jp.recoveries
    if fault == "delay":
        assert p.recoveries[0] == dict(kind="wave_failed", unit="local",
                                       error="StragglerError")


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shard_loss_class(family, shards):
    """The shard-loss class (``lose``).  On a one-shard mesh every shard is
    the lost shard: recovery has no survivor, and the run raises JAX's
    :class:`ShardFailureError` with JAX's context (a one-device JAX mesh,
    in-process).  On four shards the lost shard's rows re-home on the
    survivors — each survivor's units run once — and the result equals the
    port's no-fault run bit for bit."""
    a, b = (_host(m) for m in FAMILIES[family])
    mesh = make_mesh((shards,), ("data",), devices=["cpu"] * shards)
    lost = 0 if shards == 1 else 2
    kind, res, p = _run(tplan_mod, faults, a, b, dict(lose_shard=lost),
                        dict(mesh=mesh), device="cpu")
    assert not faults.armed()
    if shards == 1:
        import jax
        jkind, jres, _ = _run(jplan_mod, jfaults, *FAMILIES[family],
                              dict(lose_shard=0),
                              dict(mesh=jax.make_mesh((1,), ("data",))),
                              cache=_jax_cache(family))
        assert kind == jkind == "raise", (kind, res)
        assert type(res).__name__ == type(jres).__name__ \
            == "ShardFailureError"
        assert _context(res) == _context(jres)
        assert isinstance(res.__cause__, ShardFailureError)
        return
    assert kind == "ok", res
    _, clean, _ = _run(tplan_mod, faults, a, b, None, dict(mesh=mesh),
                       device="cpu")
    np.testing.assert_array_equal(res.rpt, clean.rpt)
    np.testing.assert_array_equal(res.col, clean.col)
    np.testing.assert_array_equal(res.val.view(np.int32),
                                  clean.val.view(np.int32))
    np.testing.assert_allclose(res.to_dense(), spgemm_dense_oracle(a, b),
                               rtol=1e-4, atol=1e-4)
    kinds = [e["kind"] for e in p.recoveries]
    assert kinds[0] == "wave_failed" and "shard_lost" in kinds
    assert {e["shard"] for e in p.recoveries if e["kind"] == "shard_lost"} \
        == {lost}
    units = [(e["bucket"], e["shard"]) for e in p.recoveries
             if e["kind"] == "unit"]
    assert len(units) == len(set(units)) and lost not in {s for _, s in units}
    rehomes = [e for e in p.recoveries if e["kind"] == "rehome"]
    assert rehomes and {e["shard"] for e in rehomes} == {lost}
    assert {e["to"] for e in rehomes} <= {0, 1, 3}


# --------------------------------------------------------------------------- #
# tests/test_faults.py's pins, on the port
# --------------------------------------------------------------------------- #
def _reference(p, a, b):
    """An ample-capacity run on the same sample rows."""
    pa = tplan_mod.plan_spgemm(a, b, safety=64.0, sample_rows=p.sample_rows,
                               device="cpu")
    out = tplan_mod.execute(pa, a, b, cache=tplan_mod.PlanCache())
    assert int(out.overflow) == 0
    return tplan_mod.reassemble(pa, out)


def _assert_same(c, want, a, b):
    np.testing.assert_array_equal(c.rpt, want.rpt)
    np.testing.assert_array_equal(c.col, want.col)
    np.testing.assert_allclose(c.val, want.val, rtol=VAL_RTOL, atol=1e-5)
    np.testing.assert_allclose(c.to_dense(), spgemm_dense_oracle(a, b),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_panels", [0, 3])
def test_escalation_terminates_within_budget(n_panels):
    """Under uniform starvation the escalation runs at most ``rounds``
    ladder re-runs plus one exact-fallback re-run per unit."""
    a, b = (_host(m) for m in FAMILIES["pl"])
    policy = tplan_mod.RetryPolicy(rounds=2, growth=1.5)
    with faults.inject(capacity_scale=0.15):
        p = tplan_mod.plan_spgemm(a, b, safety=1.3, retry_policy=policy,
                                  n_panels=n_panels, device="cpu")
        out = tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
    assert int(out.overflow) == 0 and p.retries <= policy.rounds
    unit = (lambda e: (e["bucket"], e.get("panel")))
    ladder = Counter(unit(e) for e in p.retry_events)
    exact = Counter(unit(d) for d in p.degradations)
    assert ladder or exact
    for u in set(ladder) | set(exact):
        assert ladder[u] + exact[u] <= policy.rounds + 1, (u, ladder, exact)
        assert exact[u] <= 1
    assert p.stats()["degradations"] == p.degradations
    _assert_same(tplan_mod.reassemble(p, out), _reference(p, a, b), a, b)


@pytest.mark.parametrize("n_panels", [0, 2])
def test_exact_fallback_alone_closes_overflow(n_panels):
    a, b = (_host(m) for m in FAMILIES["band"])
    policy = tplan_mod.RetryPolicy(rounds=0, exact_fallback=True)
    with faults.inject(capacity_scale=0.2):
        p = tplan_mod.plan_spgemm(a, b, safety=1.3, retry_policy=policy,
                                  n_panels=n_panels, device="cpu")
        out = tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
    assert p.retries == 0 and not p.retry_events and p.degradations
    assert all(d["kind"] == "exact_symbolic" and d["new_cap"] >= d["need"]
               for d in p.degradations)
    assert all(("panel" in d) == bool(n_panels) for d in p.degradations)
    assert int(out.overflow) == 0
    _assert_same(tplan_mod.reassemble(p, out), _reference(p, a, b), a, b)


@pytest.mark.parametrize("n_panels", [0, 2])
def test_exhaustion_raises_typed_error(n_panels):
    a, b = (_host(m) for m in FAMILIES["er"])
    policy = tplan_mod.RetryPolicy(rounds=0, exact_fallback=False,
                                   on_exhausted="raise")
    with faults.inject(capacity_scale=0.1):
        p = tplan_mod.plan_spgemm(a, b, safety=1.3, retry_policy=policy,
                                  n_panels=n_panels, device="cpu")
        with pytest.raises(CapacityExhaustedError) as exc:
            tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
    assert exc.value.context["buckets"]
    assert exc.value.context["observed"] > 0


def test_executor_fault_wraps_cause():
    a, b = (_host(m) for m in FAMILIES["er"])
    with faults.inject(fail_executor={"unit": "local"}):
        p = tplan_mod.plan_spgemm(a, b, safety=1.3, device="cpu",
                                  retry_policy=tplan_mod.RetryPolicy())
        with pytest.raises(ShardFailureError) as exc:
            tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
    assert exc.value.context["unit"] == "local"
    assert isinstance(exc.value.__cause__, faults.InjectedFault)
    assert not isinstance(exc.value, StragglerError)


def test_a_failure_inside_the_executor_is_typed(monkeypatch):
    """A real failure in a dispatch (a kernel that does not launch) leaves
    the executor as a ShardFailureError naming the unit, chained to its
    cause; nothing retries it or runs another version instead."""
    a, b = (_host(m) for m in FAMILIES["band"])
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tplan_mod, "_run_bucket", broken)
    for n_panels, unit in ((0, "local"), (2, "local-panels")):
        p = tplan_mod.plan_spgemm(a, b, safety=1.3, device="cpu",
                                  n_panels=n_panels)
        with pytest.raises(ShardFailureError) as exc:
            tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
        assert exc.value.context == {"unit": unit}
        assert isinstance(exc.value.__cause__, RuntimeError)
    assert len(calls) == 2


@pytest.mark.parametrize("family", ["band", "er"])
def test_gather_starvation_names_panel(family):
    a, b = (_host(m) for m in FAMILIES[family])
    with faults.inject(gather_scale=0.25):
        p = tplan_mod.plan_spgemm(a, b, safety=1.3, n_panels=2,
                                  device="cpu")
        with pytest.raises(CapacityExhaustedError) as exc:
            tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
    ctx = exc.value.context
    assert "panel" in ctx and ctx["observed"] > ctx["planned"]


@pytest.mark.parametrize("n_panels", [0, 2])
def test_no_fault_armed_path_zero_builds(n_panels):
    """Arming RetryPolicy costs nothing on the happy path: no retries, no
    degradations, and a second execute through the same cache builds no
    executor."""
    a = _host(sprand.banded(300, 300, 8, 10, seed=3))
    cache = tplan_mod.PlanCache()
    p = tplan_mod.plan_spgemm(a, a, safety=2.0, n_panels=n_panels,
                              retry_policy=tplan_mod.RetryPolicy(),
                              device="cpu")
    out = tplan_mod.execute(p, a, a, cache=cache)
    assert p.retries == 0 and not p.retry_events and not p.degradations
    assert int(out.overflow) == 0
    builds = cache.stats()["traces"]
    assert builds == 1
    tplan_mod.execute(p, a, a, cache=cache)
    assert cache.stats()["traces"] == builds
    st = p.stats()
    assert st["retries"] == 0 and st["degradations"] == []
    assert st["validation"]["operands_validated"] == 2


@pytest.mark.parametrize("n_panels", [0, 2])
def test_dispatch_units_match_jax(monkeypatch, n_panels):
    """Every dispatch reaches the fault hook with JAX's unit info — the
    wave, each ladder re-run and each exact-fallback re-run — so a
    ``fail_executor`` filter picks the same dispatch in both packages."""
    a, b = FAMILIES["fem"]
    seen = {}
    for name, mod, fmod, host in (("jax", jplan_mod, jfaults, lambda m: m),
                                  ("port", tplan_mod, faults, _host)):
        log = seen.setdefault(name, [])
        real = fmod.check_executor
        monkeypatch.setattr(fmod, "check_executor",
                            lambda info, real=real, log=log:
                            (log.append(dict(info)), real(info))[1])
        kw = {} if name == "jax" else dict(device="cpu")
        for policy in (mod.RetryPolicy(rounds=1),
                       mod.RetryPolicy(rounds=0)):
            p = mod.plan_spgemm(host(a), host(b), safety=0.0,
                                sample_rows=_rows(a), n_panels=n_panels,
                                retry_policy=policy, **kw)
            mod.execute(p, host(a), host(b), cache=mod.PlanCache())
    assert seen["port"] == seen["jax"]
    units = {d["unit"] for d in seen["port"]}
    assert units == {"local-panels" if n_panels else "local", "bucket-retry",
                     "exact-fallback"}
    # the n-th matching dispatch fails, typed and named, in the port
    first = next(d for d in seen["port"] if d["unit"] == "exact-fallback")
    with faults.inject(fail_executor=first):
        p = tplan_mod.plan_spgemm(
            _host(a), _host(b), safety=0.0, sample_rows=_rows(a),
            n_panels=n_panels, retry_policy=tplan_mod.RetryPolicy(rounds=0),
            device="cpu")
        with pytest.raises(ShardFailureError) as exc:
            tplan_mod.execute(p, _host(a), _host(b),
                              cache=tplan_mod.PlanCache())
    assert exc.value.context == first


def test_capacity_hook_scales_every_planned_capacity():
    a, b = (_host(m) for m in FAMILIES["fem"])
    base = tplan_mod.plan_spgemm(a, b, safety=1.3, n_panels=2, device="cpu",
                                 sample_rows=_rows(a))
    with faults.inject(capacity_scale=0.5):
        p = tplan_mod.plan_spgemm(a, b, safety=1.3, n_panels=2,
                                  device="cpu", sample_rows=_rows(a))
    assert all(c < c0 for c, c0 in zip(p.alloc.bucket_capacities,
                                       base.alloc.bucket_capacities))
    assert (p.panel_caps <= base.panel_caps).all()
    assert (p.panel_caps < base.panel_caps).any()
    assert not faults.armed()


# --------------------------------------------------------------------------- #
# inject() re-entrancy: hooks restore no matter how the guarded block leaves
# --------------------------------------------------------------------------- #
def test_inject_unwinds_when_block_raises():
    assert not faults.armed()
    with pytest.raises(RuntimeError, match="boom"):
        with faults.inject(capacity_scale=0.5):
            assert faults.armed()
            raise RuntimeError("boom")
    assert not faults.armed()
    assert faults.scale_capacity(100) == 100


def test_inject_nested_raise_unwinds_in_order():
    with faults.inject(capacity_scale=0.5) as outer:
        with pytest.raises(ValueError):
            with faults.inject(capacity_scale=0.25):
                raise ValueError("inner")
        assert faults._STACK == [outer]
        assert faults.scale_capacity(100) == 50
    assert not faults.armed()


def test_inject_unwind_pops_by_identity_not_equality():
    with faults.inject(sketch_scale=0.5, seed=7) as outer:
        with faults.inject(sketch_scale=0.5, seed=7) as inner:
            assert faults._STACK == [outer, inner]
        assert len(faults._STACK) == 1
        assert faults._STACK[0] is outer
    assert not faults.armed()


def test_inject_tolerates_stack_perturbation():
    rogue = faults.inject(gather_scale=0.5)
    with faults.inject(capacity_scale=0.5):
        rogue.__enter__()
    assert len(faults._STACK) == 1
    assert faults.scale_capacity(100) == 100
    rogue.__exit__(None, None, None)
    assert not faults.armed()


def test_hooks_match_jax():
    """The copy's hooks give JAX's values: the scaled capacities, the
    corrupted sketch, the Nth-call executor fault and the straggler delay;
    the lost-shard hook, which nothing in the port fires yet, refuses to
    arm."""
    structure = np.random.default_rng(5).uniform(0, 9, 50)
    for fmod in (faults, jfaults):
        assert fmod.scale_capacity(64) == 64 and not fmod.armed()
    with faults.inject(capacity_scale=0.3, gather_scale=0.1,
                       sketch_scale=0.2, seed=4), \
            jfaults.inject(capacity_scale=0.3, gather_scale=0.1,
                           sketch_scale=0.2, seed=4):
        assert faults.scale_capacity(64) == jfaults.scale_capacity(64)
        assert faults.scale_gather_cap(7) == jfaults.scale_gather_cap(7) == 1
        got = faults.corrupt_sketch(structure, 10.0, 2.0)
        want = jfaults.corrupt_sketch(structure, 10.0, 2.0)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    with faults.inject(fail_executor={"bucket": 1}, on_call=2):
        faults.check_executor(dict(unit="bucket-retry", bucket=1))
        faults.check_executor(dict(unit="bucket-retry", bucket=0))
        with pytest.raises(faults.InjectedFault):
            faults.check_executor(dict(unit="exact-fallback", bucket=1))
        faults.check_executor(dict(unit="exact-fallback", bucket=1))
    def fires(check, info):
        try:
            check(info)
        except Exception:          # InjectedFault, each package its own
            return True
        return False

    infos = (dict(unit="dist"), dict(unit="dist-panels"),
             dict(unit="recover", bucket=0, shard=1),
             dict(unit="recover", bucket=0, shard=0), dict(unit="local"),
             dict(unit="bucket-retry", bucket=1))
    with faults.inject(lose_shard=1), jfaults.inject(lose_shard=1):
        got = [fires(faults.check_executor, i) for i in infos]
        assert got == [fires(jfaults.check_executor, i) for i in infos]
    assert got == [True, True, True, False, False, False]
    assert not faults.armed()
    infos = (dict(unit="dist"), dict(unit="local"),
             dict(unit="recover", bucket=2), dict(unit="dist", shard=1))
    assert [faults.executor_delay(i) for i in infos] == [0.0] * 4
    with faults.inject(delay_executor={"unit": "dist"}, delay_s=2.5), \
            jfaults.inject(delay_executor={"unit": "dist"}, delay_s=2.5):
        assert faults.armed()
        got = [faults.executor_delay(i) for i in infos]
        assert got == [jfaults.executor_delay(i) for i in infos]
        assert got == [2.5, 0.0, 0.0, 2.5]
        with faults.inject(delay_executor={}, delay_s=0.5):
            assert [faults.executor_delay(i) for i in infos] == [0.5] * 4
    assert not faults.armed()
