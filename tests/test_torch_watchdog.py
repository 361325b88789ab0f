"""The straggler watchdog (``plan.DispatchBudget``) and single-device
recovery (``core/recovery.py``) in the port against the JAX package.

* ``DispatchBudget.limit`` and the wave's priced seconds
  (``_plan_priced_seconds``) equal JAX's on whole-B, ``pop_quant`` and
  panel plans, analytic and under a measured profile.
* A ``delay_executor`` on the ``local`` or ``local-panels`` wave trips the
  watchdog in both packages; each replays the wave unit by unit and ends
  with JAX's recovery ledger (``wave_failed``, then one ``unit`` event a
  bucket or (bucket × panel) unit) and JAX's CSR (``rpt``/``col`` exactly,
  ``val`` within rtol 1e-5), and the port's result equals its own clean
  run bit for bit — plain, and through the kernel wrappers' CPU path.
* An executor's first dispatch, and a dispatch during which a kernel
  library was loaded, are exempt from the budget; the second is not.
  Injected delay always counts.
* A delay on every dispatch, recovery units included, exhausts each
  unit's attempts with JAX's typed error and the same dispatch sequence.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import plan as jplan_mod
from repro.core import profiles as jprofiles
from repro.sparse import random as sprand
from repro_torch.core import faults
from repro_torch.core import plan as tplan_mod
from repro_torch.core import profiles as tprofiles
from repro_torch.core.errors import ShardFailureError, StragglerError
from repro_torch.kernels import _build
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

VAL_RTOL = 1e-5
DELAY_S = 30.0

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

# (name, plan options, the wave's unit name)
VARIANTS = [
    ("whole", {}, "local"),
    ("pop_quant", dict(pop_quant=True), "local"),
    ("panels", dict(n_panels=2), "local-panels"),
    ("panels_pop_quant", dict(n_panels=3, pop_quant=True), "local-panels"),
]


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _rows(jm, n=40):
    return np.random.default_rng(2).integers(0, jm.nrows, n)


def _profile_doc():
    cells = [dict(route=r, width=w, span=s, rows=512,
                  numeric_s=k * w * 1e-8 + s * 1e-10, symbolic_s=2e-7)
             for r, k in (("esc", 3.0), ("spa", 1.0), ("bin", 2.0))
             for w in (4, 64, 1024) for s in (64, 4096)]
    return dict(version=1, device_kind="cpu", flops=2e8, bytes_per_s=4e8,
                cells=cells)


@pytest.fixture(autouse=True)
def _cold_profiles():
    jprofiles.clear()
    tprofiles.clear()
    yield
    jprofiles.clear()
    tprofiles.clear()


def _budget(mod, floor_s=5.0):
    # a floor far above a clean wave's time here, far below the injected
    # delay: only the delay trips it, however loaded the host is
    return mod.DispatchBudget(multiple=50.0, floor_s=floor_s)


# --------------------------------------------------------------------------- #
# pricing
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_priced(family, variant, profiled):
    _, pkw, _ = next(v for v in VARIANTS if v[0] == variant)
    a, b = FAMILIES[family]
    if profiled:
        jprofiles.set_active(jprofiles.RouteProfile.from_json(_profile_doc()))
    try:
        p = jplan_mod.plan_spgemm(a, b, safety=1.3, sample_rows=_rows(a),
                                  **pkw)
        priced = jplan_mod._plan_priced_seconds(p)
        units = [jplan_mod._unit_priced_seconds(
            jplan_mod._bucket_meta(bk, c), pop)
            for bk, c, pop in zip(p.binning.buckets,
                                  p.alloc.bucket_capacities,
                                  p.local_populations())]
    finally:
        jprofiles.clear()
    return priced, units, [bk.route for bk in p.binning.buckets]


@pytest.mark.parametrize("profiled", [False, True],
                         ids=["analytic", "measured"])
@pytest.mark.parametrize("variant", [v[0] for v in VARIANTS])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_priced_seconds_and_limit_match_jax(family, variant, profiled):
    want, want_units, want_routes = _jax_priced(family, variant, profiled)
    _, pkw, _ = next(v for v in VARIANTS if v[0] == variant)
    a, b = (_host(m) for m in FAMILIES[family])
    if profiled:
        tprofiles.set_active(tprofiles.RouteProfile.from_json(_profile_doc()))
    p = tplan_mod.plan_spgemm(a, b, safety=1.3, sample_rows=_rows(a),
                              device="cpu", **pkw)
    assert [bk.route for bk in p.binning.buckets] == want_routes
    got = tplan_mod._plan_priced_seconds(p)
    assert got == want and got > 0
    assert [tplan_mod._unit_priced_seconds(
        tplan_mod._bucket_meta(bk, c), pop)
        for bk, c, pop in zip(p.binning.buckets, p.alloc.bucket_capacities,
                              p.local_populations())] == want_units
    for mult, floor in ((10.0, 0.05), (50.0, 0.25), (1.0, 0.0),
                        (1e6, 1e-9)):
        assert tplan_mod.DispatchBudget(mult, floor).limit(got) \
            == jplan_mod.DispatchBudget(mult, floor).limit(want)
    assert tplan_mod.DispatchBudget().limit(-1.0) \
        == jplan_mod.DispatchBudget().limit(-1.0) == 0.05


# --------------------------------------------------------------------------- #
# straggler replay
# --------------------------------------------------------------------------- #
def _straggle(mod, fmod, a, b, pkw, unit, **kw):
    """Clean run, then a run with the wave delayed, through one cache: the
    two CSRs, the faulted plan's ledger and its stats' ledger."""
    p = mod.plan_spgemm(a, b, safety=1.3, sample_rows=_rows(a),
                        retry_policy=mod.RetryPolicy(rounds=2),
                        dispatch_budget=_budget(mod), **pkw, **kw)
    cache = mod.PlanCache()
    clean = mod.reassemble(p, mod.execute(p, a, b, cache=cache))
    assert p.recoveries == []
    with fmod.inject(delay_executor={"unit": unit}, delay_s=DELAY_S):
        out = mod.execute(p, a, b, cache=cache)
    assert not int(out.overflow)
    return clean, mod.reassemble(p, out), list(p.recoveries), \
        p.stats()["recoveries"]


@functools.lru_cache(maxsize=None)
def _jax_straggle(family, variant):
    _, pkw, unit = next(v for v in VARIANTS if v[0] == variant)
    a, b = FAMILIES[family]
    return _straggle(jplan_mod, jfaults, a, b, pkw, unit)


# the whole-B wave on every family is a row of the containment matrix
# (tests/test_torch_faults.py): here the panel wave on every family, and
# the quantized waves on a power-law and a banded family
REPLAYS = ([(f, "panels") for f in sorted(FAMILIES)]
           + [(f, v) for f in ("pl", "band")
              for v in ("whole", "pop_quant", "panels_pop_quant")])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family,variant", REPLAYS,
                         ids=[f"{f}-{v}" for f, v in REPLAYS])
def test_straggler_replay_matches_jax(family, variant, use_kernel):
    _, pkw, unit = next(v for v in VARIANTS if v[0] == variant)
    _, jres, jled, _ = _jax_straggle(family, variant)
    a, b = (_host(m) for m in FAMILIES[family])
    clean, res, led, st = _straggle(tplan_mod, faults, a, b, pkw, unit,
                                    use_kernel=use_kernel, device="cpu")
    assert not faults.armed()
    assert led == jled and st == led
    assert led[0] == dict(kind="wave_failed", unit=unit,
                          error="StragglerError")
    assert all(e["kind"] == "unit" and e["attempts"] == 1 for e in led[1:])
    # bit for bit the port's own clean run
    np.testing.assert_array_equal(res.rpt, clean.rpt)
    np.testing.assert_array_equal(res.col, clean.col)
    np.testing.assert_array_equal(res.val.view(np.int32),
                                  clean.val.view(np.int32))
    # and JAX's result
    np.testing.assert_array_equal(res.rpt, jres.rpt)
    np.testing.assert_array_equal(res.col, jres.col)
    np.testing.assert_allclose(res.val, jres.val, rtol=VAL_RTOL, atol=1e-5)


def test_replay_then_replans_like_the_wave():
    """Starved capacities under a straggling wave: the replayed result goes
    through the re-planning loop as the wave's would, with JAX's events."""
    a, b = FAMILIES["pl"]
    out = {}
    for name, mod, fmod, host, kw in (
            ("jax", jplan_mod, jfaults, lambda m: m, {}),
            ("port", tplan_mod, faults, _host, dict(device="cpu"))):
        A, B = host(a), host(b)
        with fmod.inject(capacity_scale=0.2, delay_executor={"unit": "local"},
                         delay_s=DELAY_S):
            p = mod.plan_spgemm(A, B, safety=1.3, sample_rows=_rows(a),
                                retry_policy=mod.RetryPolicy(rounds=2),
                                dispatch_budget=_budget(mod), **kw)
            c = mod.reassemble(p, mod.execute(p, A, B,
                                              cache=mod.PlanCache()))
        out[name] = (c, p.recoveries, p.retry_events, p.degradations)
    (tc, tled, tev, tdeg), (jc, jled, jev, jdeg) = out["port"], out["jax"]
    assert tled == jled and tled[0]["kind"] == "wave_failed"
    assert tev == jev and tev and tdeg == jdeg
    np.testing.assert_array_equal(tc.rpt, jc.rpt)
    np.testing.assert_array_equal(tc.col, jc.col)
    np.testing.assert_allclose(tc.val, jc.val, rtol=VAL_RTOL, atol=1e-5)


@pytest.mark.parametrize("n_panels", [0, 2])
def test_delay_on_recovery_units_exhausts_like_jax(monkeypatch, n_panels):
    """Every dispatch delayed: the wave straggles, and the first recovery
    unit straggles on each of its ``rounds + 1`` attempts, then raises the
    typed :class:`StragglerError` naming it — the same dispatches and the
    same error in both packages."""
    a, b = FAMILIES["band"]
    seen = {}
    for name, mod, fmod, host, kw in (
            ("jax", jplan_mod, jfaults, lambda m: m, {}),
            ("port", tplan_mod, faults, _host, dict(device="cpu"))):
        log = seen.setdefault(name, [])
        real = fmod.check_executor
        monkeypatch.setattr(fmod, "check_executor",
                            lambda info, real=real, log=log:
                            (log.append(dict(info)), real(info))[1])
        A, B = host(a), host(b)
        p = mod.plan_spgemm(A, B, safety=1.3, sample_rows=_rows(a),
                            n_panels=n_panels,
                            retry_policy=mod.RetryPolicy(rounds=1),
                            dispatch_budget=_budget(mod), **kw)
        with fmod.inject(delay_executor={}, delay_s=DELAY_S):
            with pytest.raises(ValueError) as exc:
                mod.execute(p, A, B, cache=mod.PlanCache())
        seen[name + "_err"] = exc.value
        seen[name + "_led"] = list(p.recoveries)
    assert seen["port"] == seen["jax"]
    unit = dict(unit="recover", bucket=0, **(dict(panel=0) if n_panels
                                             else {}))
    assert seen["port"][1:] == [unit, unit]          # rounds + 1 attempts
    terr, jerr = seen["port_err"], seen["jax_err"]
    assert type(terr).__name__ == type(jerr).__name__ == "StragglerError"
    assert isinstance(terr, StragglerError)
    assert set(terr.context) == set(jerr.context)
    assert {k: terr.context[k] for k in unit} == unit
    assert terr.context["planned"] == jerr.context["planned"]
    assert terr.context["observed"] >= DELAY_S
    assert seen["port_led"] == seen["jax_led"] == [dict(
        kind="wave_failed", unit="local-panels" if n_panels else "local",
        error="StragglerError")]


def test_executor_death_without_straggling_still_raises():
    a, b = (_host(m) for m in FAMILIES["er"])
    p = tplan_mod.plan_spgemm(a, b, safety=1.3, device="cpu",
                              dispatch_budget=_budget(tplan_mod))
    with faults.inject(fail_executor={"unit": "local"}):
        with pytest.raises(ShardFailureError) as exc:
            tplan_mod.execute(p, a, b, cache=tplan_mod.PlanCache())
    assert not isinstance(exc.value, StragglerError)
    assert exc.value.context == {"unit": "local"} and p.recoveries == []


# --------------------------------------------------------------------------- #
# the exemptions
# --------------------------------------------------------------------------- #
def _slow(seconds, load=False):
    def run():
        if load:
            _build.loads += 1           # as a library load inside the call
        torch.ones(1).add_(1)
        import time
        time.sleep(seconds)
        return "done"
    return run


def test_first_dispatch_is_exempt_and_the_second_is_not():
    budget = tplan_mod.DispatchBudget(multiple=1.0, floor_s=0.01)
    run = _slow(0.05)
    kw = dict(budget=budget, priced_s=0.0, device="cpu")
    assert tplan_mod._invoke_executor(run, dict(unit="local"), **kw) == "done"
    with pytest.raises(StragglerError) as exc:
        tplan_mod._invoke_executor(run, dict(unit="local"), **kw)
    assert exc.value.context["unit"] == "local"
    assert exc.value.context["observed"] >= 0.05
    assert exc.value.context["planned"] == 0.01
    # a dispatch during which a library was loaded is exempt too
    loader = _slow(0.05, load=True)
    tplan_mod._invoke_executor(loader, dict(unit="local"), **kw)
    tplan_mod._invoke_executor(loader, dict(unit="local"), **kw)
    # an unbudgeted dispatch counts as the executor's first
    other = _slow(0.05)
    tplan_mod._invoke_executor(other, dict(unit="local"))
    with pytest.raises(StragglerError):
        tplan_mod._invoke_executor(other, dict(unit="local"), **kw)


def test_injected_delay_counts_on_a_first_dispatch():
    budget = tplan_mod.DispatchBudget(multiple=1.0, floor_s=1.0)
    with faults.inject(delay_executor={"unit": "local"}, delay_s=2.0):
        with pytest.raises(StragglerError) as exc:
            tplan_mod._invoke_executor(_slow(0.0), dict(unit="local"),
                                       budget=budget, priced_s=0.0)
        assert exc.value.context["observed"] >= 2.0
        # another unit is not delayed
        tplan_mod._invoke_executor(_slow(0.0), dict(unit="recover"),
                                   budget=budget, priced_s=0.0)


def test_slow_executors_trip_from_their_second_dispatch(monkeypatch):
    """Through ``execute``: a real slow wave (every bucket sleeps) passes on
    its executor's first dispatch, straggles on the second and recovers
    through fresh per-bucket executors (their first dispatches), and on
    the third the recovery units straggle too and the typed error
    surfaces."""
    a, b = (_host(m) for m in FAMILIES["fem"])
    real = tplan_mod._run_bucket

    def slow(*args, **kw):
        import time
        time.sleep(0.03)
        return real(*args, **kw)

    monkeypatch.setattr(tplan_mod, "_run_bucket", slow)
    p = tplan_mod.plan_spgemm(a, b, safety=1.3, device="cpu",
                              retry_policy=tplan_mod.RetryPolicy(rounds=0),
                              dispatch_budget=tplan_mod.DispatchBudget(
                                  multiple=1.0, floor_s=0.01))
    cache = tplan_mod.PlanCache()
    clean = tplan_mod.reassemble(p, tplan_mod.execute(p, a, b, cache=cache))
    assert p.recoveries == []
    again = tplan_mod.reassemble(p, tplan_mod.execute(p, a, b, cache=cache))
    assert p.recoveries[0] == dict(kind="wave_failed", unit="local",
                                   error="StragglerError")
    assert [e["bucket"] for e in p.recoveries[1:]] == list(
        range(len(p.binning.buckets)))
    np.testing.assert_array_equal(again.val.view(np.int32),
                                  clean.val.view(np.int32))
    with pytest.raises(StragglerError) as exc:
        tplan_mod.execute(p, a, b, cache=cache)
    assert exc.value.context["unit"] == "recover"

