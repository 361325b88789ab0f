"""Re-planning on overflow in the port against the JAX package: the same
operands and sample rows through ``repro`` and ``repro_torch`` on the five
families of ``tests/test_replan.py``, planned at ``safety=0`` so every
bucket starts at the 8-slot floor and overflows, under the legacy
``retry_safety``, the default :class:`RetryPolicy`, a policy with no ladder
(the exact-symbolic fallback alone) and a ladder whose ceiling clamps every
bump; with ``use_kernel`` off and on (on the CPU the kernel wrappers run
their plain versions).  Retries, events, degradations, final capacities,
``col``, ``row_nnz``, ``overflow`` and the reassembled structure must equal
JAX's exactly, ``val`` within rtol 1e-5.  Also: the exhausted policy's typed
error, ``exact_row_counts`` per row on every route, and the executor build
counts of the fast path and of a one-bucket retry."""
import functools

import numpy as np
import pytest
import torch

from repro.core import plan as jplan_mod
from repro.core import predictor as jpredictor
from repro.core import csr as jcsr
from repro.sparse import random as sprand
from repro.sparse.formats import CSR as JCSR, spgemm_dense_oracle
from repro_torch.core import csr as tcsr
from repro_torch.core import plan as tplan_mod
from repro_torch.core import predictor as tpredictor
from repro_torch.core.errors import CapacityExhaustedError
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

VAL_RTOL = 1e-5
VAL_ATOL_REL = 1e-6


def _families():
    return {
        "er": (sprand.erdos_renyi(400, 400, 4, seed=25),
               sprand.erdos_renyi(400, 400, 3, seed=26)),
        "pl": (sprand.power_law(500, 500, 5, 1.5, seed=21),
               sprand.power_law(500, 500, 4, 1.6, seed=22)),
        "rmat": (sprand.rmat(400, 400, 2000, seed=31),
                 sprand.rmat(400, 400, 1600, seed=32)),
        "band": (sprand.banded(400, 400, 10, 14, seed=23),
                 sprand.banded(400, 400, 8, 12, seed=24)),
        "fem": (sprand.banded(300, 300, 40, 30, seed=51),
                sprand.banded(300, 300, 32, 28, seed=52)),
    }


FAMILIES = _families()
MODES = ("retry_safety", "policy", "rounds0", "ceiling")


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _rows(jm, n=40):
    return np.random.default_rng(2).integers(0, jm.nrows, n)


def _options(mod, mode):
    """The re-planning options of one mode, for either package."""
    return dict(
        retry_safety=dict(retry_safety=1.5),
        policy=dict(retry_policy=mod.RetryPolicy()),
        rounds0=dict(retry_policy=mod.RetryPolicy(rounds=0)),
        ceiling=dict(retry_policy=mod.RetryPolicy(rounds=1, max_capacity=8)),
    )[mode]


@functools.lru_cache(maxsize=None)
def _jax_run(family, mode):
    """JAX's plan → execute → reassemble (plain path) at safety 0, kept
    for both use_kernel settings of the port."""
    a, b = FAMILIES[family]
    cache = jplan_mod.PlanCache()
    p = jplan_mod.plan_spgemm(a, b, safety=0.0, sample_rows=_rows(a),
                              **_options(jplan_mod, mode))
    caps_before = tuple(p.alloc.bucket_capacities)
    out = jplan_mod.execute(p, a, b, cache=cache)
    c = jplan_mod.reassemble(p, out)
    return dict(p=p, caps_before=caps_before, col=np.asarray(out.col),
                val=np.asarray(out.val), row_nnz=np.asarray(out.row_nnz),
                overflow=int(out.overflow), c=c, traces=cache.stats())


def _assert_vals(got, want):
    vmax = np.abs(want).max(axis=1, keepdims=True) if want.size else want
    assert (np.abs(got - want) <= VAL_RTOL * np.abs(want)
            + VAL_ATOL_REL * vmax).all()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_replan_matches_jax(family, mode, use_kernel):
    a, b = FAMILIES[family]
    want = _jax_run(family, mode)
    jp = want["p"]
    cache = tplan_mod.PlanCache()
    tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=0.0,
                               sample_rows=_rows(a), use_kernel=use_kernel,
                               device="cpu", **_options(tplan_mod, mode))
    assert tuple(tp.alloc.bucket_capacities) == want["caps_before"]
    out = tplan_mod.execute(tp, _host(a), _host(b), cache=cache)
    # safety 0 starves some bucket on every family
    assert jp.retry_events or jp.degradations
    assert tp.retries == jp.retries
    assert tp.retry_events == jp.retry_events
    assert tp.degradations == jp.degradations
    assert tp.alloc.bucket_capacities == jp.alloc.bucket_capacities
    assert tp.stats()["degradations"] == jp.stats()["degradations"]
    if mode == "retry_safety":
        for k in ("retry_safety", "retries", "retry_events",
                  "final_capacities"):
            assert tp.stats()[k] == jp.stats()[k], k
    if mode in ("rounds0", "ceiling"):
        assert not tp.retry_events and tp.degradations
    np.testing.assert_array_equal(out.col.numpy(), want["col"])
    np.testing.assert_array_equal(out.row_nnz.numpy(), want["row_nnz"])
    assert int(out.overflow) == want["overflow"] == 0
    _assert_vals(out.val.numpy(), want["val"])
    # one build for the wave, one for each re-run bucket, as JAX traces
    assert cache.stats() == want["traces"]
    c = tplan_mod.reassemble(tp, out)
    np.testing.assert_array_equal(c.rpt, want["c"].rpt)
    np.testing.assert_array_equal(c.col, want["c"].col)
    np.testing.assert_allclose(c.val, want["c"].val, rtol=VAL_RTOL,
                               atol=1e-6)
    # the plan's capacities were bumped in place: a second execute
    # allocates right the first time
    out2 = tplan_mod.execute(tp, _host(a), _host(b), cache=cache)
    assert tp.retries == 0 and not tp.degradations
    assert int(out2.overflow) == 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_exhausted_policy_raises_like_jax(family):
    a, b = FAMILIES[family]
    errors = []
    for mod, pair in ((jplan_mod, (a, b)), (tplan_mod, (_host(a), _host(b)))):
        kw = dict(device="cpu") if mod is tplan_mod else {}
        p = mod.plan_spgemm(
            *pair, safety=0.0, sample_rows=_rows(a),
            retry_policy=mod.RetryPolicy(rounds=0, exact_fallback=False,
                                         on_exhausted="raise"), **kw)
        with pytest.raises(ValueError, match="exhausted") as exc:
            mod.execute(p, *pair, cache=mod.PlanCache())
        errors.append(exc.value)
    assert isinstance(errors[1], CapacityExhaustedError)
    for k in ("buckets", "observed", "planned"):
        assert errors[1].context[k] == errors[0].context[k], k
    assert errors[1].context["buckets"] and errors[1].context["observed"] > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_surfaced_overflow_when_the_legacy_ladder_has_no_rounds(family):
    a, b = FAMILIES[family]
    jp = jplan_mod.plan_spgemm(a, b, safety=0.0, sample_rows=_rows(a),
                               retry_safety=1.5, max_retries=0)
    jout = jplan_mod.execute(jp, a, b, cache=jplan_mod.PlanCache())
    tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=0.0,
                               sample_rows=_rows(a), retry_safety=1.5,
                               max_retries=0, device="cpu")
    tout = tplan_mod.execute(tp, _host(a), _host(b),
                             cache=tplan_mod.PlanCache())
    assert tp.retries == jp.retries == 0
    assert int(tout.overflow) == int(jout.overflow) > 0
    with pytest.raises(CapacityExhaustedError, match="overflow"):
        tplan_mod.reassemble(tp, tout)


@functools.lru_cache(maxsize=None)
def _jax_exact_counts(family, route):
    """JAX's exact_row_counts of every bucket of the plan on ``route``,
    kept for both use_kernel settings of the port."""
    a, b = FAMILIES[family]
    jp = jplan_mod.plan_spgemm(a, b, route=route, sample_rows=_rows(a))
    ja, jb = jcsr.to_device(a), jcsr.to_device(b)
    return [jpredictor.exact_row_counts(
        ja, jb, bk.rows, max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
        route=bk.route, span=bk.span) for bk in jp.binning.buckets]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("route", ["auto", "esc", "spa", "bin"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_exact_row_counts_match_jax(family, route, use_kernel):
    """Every bucket of the plan, at its bounds and on its route: the port's
    per-row counts equal JAX's and the exact structure."""
    a, b = FAMILIES[family]
    tp = tplan_mod.plan_spgemm(_host(a), _host(b), route=route,
                               sample_rows=_rows(a), device="cpu")
    ta = tcsr.to_device(_host(a), device="cpu")
    tb = tcsr.to_device(_host(b), device="cpu")
    nnz_rows = (spgemm_dense_oracle(_unit(a), _unit(b)) != 0).sum(axis=1)
    wants = _jax_exact_counts(family, route)
    assert len(wants) == len(tp.binning.buckets)
    for bk, want in zip(tp.binning.buckets, wants):
        got = tpredictor.exact_row_counts(
            ta, tb, bk.rows, max_deg_a=bk.deg_a, max_deg_b=bk.deg_b,
            route=bk.route, span=bk.span, use_kernel=use_kernel,
            row_flop=tp.flopr[bk.rows])
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, nnz_rows[bk.rows])


def _unit(m):
    """``m`` with every value 1, so no product cancels to zero."""
    return JCSR(rpt=m.rpt, col=m.col, val=np.ones_like(m.val), shape=m.shape)


def test_exact_row_counts_over_jax_chunks_and_narrow_bounds():
    """Rows past one of JAX's chunks (padded there with the last row, cut
    after), repeated rows and bounds below a row's degree (truncated
    gathers, as in JAX) give JAX's counts; no rows give an empty int64
    array."""
    a, b = FAMILIES["pl"]
    ja, jb = jcsr.to_device(a), jcsr.to_device(b)
    ta = tcsr.to_device(_host(a), device="cpu")
    tb = tcsr.to_device(_host(b), device="cpu")
    rows = np.random.default_rng(5).integers(0, a.nrows, 300)
    for kw in (dict(max_deg_a=4, max_deg_b=3, route="esc"),
               dict(max_deg_a=8, max_deg_b=8, route="spa", span=64),
               dict(max_deg_a=16, max_deg_b=16, route="bin", span=0)):
        want = jpredictor.exact_row_counts(ja, jb, rows, chunk=64, **kw)
        for use_kernel in (False, True):
            got = tpredictor.exact_row_counts(ta, tb, rows,
                                              use_kernel=use_kernel, **kw)
            np.testing.assert_array_equal(got, want)
    empty = tpredictor.exact_row_counts(ta, tb, [], max_deg_a=4, max_deg_b=4)
    assert empty.dtype == np.int64 and empty.size == 0


def _hub_matrix(m=400, hub_deg=60):
    """Low-degree bulk + one hub row: only the hub's bucket under-allocates
    at the 8-slot floor (as in tests/test_replan.py)."""
    rng = np.random.default_rng(7)
    r = np.arange(1, m)
    rows = np.repeat(r, 2)
    cols = np.stack([r, np.minimum(r + 1, m - 1)], axis=1).reshape(-1)
    hub_cols = rng.choice(np.arange(1, m), hub_deg, replace=False)
    rows = np.concatenate([np.zeros(hub_deg, np.int64), rows])
    cols = np.concatenate([hub_cols, cols])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return JCSR.from_coo(rows, cols, vals, (m, m))


BUILD_CASES = {"fast": (lambda: sprand.banded(300, 300, 8, 10, seed=3), 2.0),
               "hub": (_hub_matrix, 0.0)}


def _build_counts(mod, case, **kw):
    """The cache's counts after a first and a second execute of one plan
    armed with retry_safety, its retry events and the hub row's bucket."""
    m, safety = BUILD_CASES[case]
    m = m()
    pair = (m, m) if mod is jplan_mod else (_host(m), _host(m))
    cache = mod.PlanCache()
    p = mod.plan_spgemm(*pair, safety=safety, retry_safety=1.5,
                        sample_rows=_rows(m), **kw)
    out = mod.execute(p, *pair, cache=cache)
    first, events = dict(cache.stats()), list(p.retry_events)
    assert int(out.overflow) == 0
    mod.execute(p, *pair, cache=cache)
    assert p.retries == 0
    return first, dict(cache.stats()), events, int(p.binning.row_bucket[0])


_jax_build_counts = functools.lru_cache(maxsize=None)(
    lambda case: _build_counts(jplan_mod, case))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_build_counts_match_jax_traces(use_kernel):
    """No build on the armed fast path; one per re-run bucket signature
    when only the hub's bucket retries; the same counts as JAX's traces."""
    for case in BUILD_CASES:
        counts = [_jax_build_counts(case),
                  _build_counts(tplan_mod, case, device="cpu",
                                use_kernel=use_kernel)]
        assert counts[1] == counts[0]
        safety = BUILD_CASES[case][1]
        if safety:
            assert counts[1][0]["traces"] == counts[1][1]["traces"] == 1
        else:
            assert {e["bucket"] for e in counts[1][2]} == {counts[1][3]}
            assert counts[1][0]["traces"] == 1 + len(counts[1][2])
