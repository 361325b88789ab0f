"""Population quantization and plan templates in the port against the JAX
package: ``pop_quant=True`` plans (pow2-padded populations, degree bounds
and capacities; tables padded by repeating their last row) have JAX's key,
populations and row padding, and pad rows never count as overflow; members
of a family planned against a :class:`PlanTemplate`, or through
``template="auto"`` and a :class:`TemplateRegistry`, get JAX's growths,
keys, registry hits and misses and outputs, and share one executor once
the template has stopped growing.  A template bucket that a member leaves
empty launches a table of row 0, so the numeric kernels' FLOP bound is
row 0's.  The same operands and sample rows go through both packages;
``use_kernel`` runs the kernel wrappers' plain versions on the CPU."""
import functools
import types

import numpy as np
import pytest
import torch

from repro.core import plan as jplan_mod
from repro.sparse import random as sprand
from repro_torch.core import plan as tplan_mod
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

VAL_RTOL = 1e-5
VAL_ATOL_REL = 1e-6

PAIRS = {
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

# three same-shape members of one family each (seeds as tests/
# test_quantization_property.py draws them)
GENERATORS = {
    "er": lambda s: (sprand.erdos_renyi(400, 400, 4, seed=s),
                     sprand.erdos_renyi(400, 400, 3, seed=s + 50)),
    "pl": lambda s: (sprand.power_law(300, 300, 4, 1.5, seed=s),
                     sprand.power_law(300, 300, 4, 1.5, seed=s + 50)),
    "band": lambda s: (sprand.banded(300, 300, 8, 10, seed=s),
                       sprand.banded(300, 300, 8, 10, seed=s + 50)),
}


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _rows(jm, n=40):
    return np.random.default_rng(2).integers(0, jm.nrows, n)


def _strip(key):
    """A plan key without its ``use_kernel`` flag (index 3)."""
    return key[:3] + key[4:]


def _frozen(out):
    """A JAX output's arrays on the host, kept for both use_kernel
    settings of the port."""
    return types.SimpleNamespace(col=np.asarray(out.col),
                                 val=np.asarray(out.val),
                                 row_nnz=np.asarray(out.row_nnz),
                                 overflow=int(out.overflow))


def _assert_same_output(tout, jout, tc=None, jc=None):
    np.testing.assert_array_equal(tout.col.numpy(), np.asarray(jout.col))
    np.testing.assert_array_equal(tout.row_nnz.numpy(),
                                  np.asarray(jout.row_nnz))
    assert int(tout.overflow) == int(jout.overflow)
    w = np.asarray(jout.val)
    vmax = np.abs(w).max(axis=1, keepdims=True) if w.size else w
    assert (np.abs(tout.val.numpy() - w)
            <= VAL_RTOL * np.abs(w) + VAL_ATOL_REL * vmax).all()
    if tc is not None:
        np.testing.assert_array_equal(tc.rpt, jc.rpt)
        np.testing.assert_array_equal(tc.col, jc.col)
        np.testing.assert_allclose(tc.val, jc.val, rtol=VAL_RTOL, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_pop_quant(family):
    a, b = PAIRS[family]
    jp = jplan_mod.plan_spgemm(a, b, safety=2.0, pop_quant=True,
                               sample_rows=_rows(a))
    jout = jplan_mod.execute(jp, a, b, cache=jplan_mod.PlanCache())
    return jp, _frozen(jout), jplan_mod.reassemble(jp, jout)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", sorted(PAIRS))
def test_pop_quant_plan_matches_jax(family, use_kernel):
    a, b = PAIRS[family]
    jp, jout, jc = _jax_pop_quant(family)
    tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=2.0,
                               pop_quant=True, sample_rows=_rows(a),
                               use_kernel=use_kernel, device="cpu")
    assert _strip(tp.key) == _strip(jp.key)
    assert tp.key[4] is True
    assert tp.local_populations() == jp.local_populations()
    assert tp.stats()["row_padding"] == jp.stats()["row_padding"] <= 2.0
    assert tp.stats()["pop_quant"] is True
    # each launched table: the bucket's rows, then its last row repeated
    for bk, table, pop in zip(tp.binning.buckets, tp.host_tables(),
                              tp.local_populations()):
        assert table.size == pop
        np.testing.assert_array_equal(table[:bk.n_rows], bk.rows)
        assert (table[bk.n_rows:] == (bk.rows[-1] if bk.n_rows else 0)).all()
    tout = tplan_mod.execute(tp, _host(a), _host(b),
                             cache=tplan_mod.PlanCache())
    _assert_same_output(tout, jout, tplan_mod.reassemble(tp, tout), jc)


def test_pop_quant_overflow_ignores_pad_rows():
    """At the 8-slot floor without re-planning, the overflow counts real
    rows only: JAX's count, the rows' own excess — and not the padded
    tables' excess, which counts each bucket's last row once a pad row."""
    padded_differs = False
    for family, (a, b) in sorted(PAIRS.items()):
        jp = jplan_mod.plan_spgemm(a, b, safety=0.0, pop_quant=True,
                                   sample_rows=_rows(a))
        tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=0.0,
                                   pop_quant=True, sample_rows=_rows(a),
                                   device="cpu")
        jout = jplan_mod.execute(jp, a, b, cache=jplan_mod.PlanCache())
        tout = tplan_mod.execute(tp, _host(a), _host(b),
                                 cache=tplan_mod.PlanCache())
        _assert_same_output(tout, jout)
        n = tout.row_nnz.numpy().astype(np.int64)
        caps = tp.alloc.bucket_capacities
        real = sum(int(np.maximum(n[bk.rows] - cap, 0).sum())
                   for bk, cap in zip(tp.binning.buckets, caps))
        padded = sum(int(np.maximum(n[t] - cap, 0).sum())
                     for t, cap in zip(tp.host_tables(), caps))
        assert int(tout.overflow) == real > 0, family
        padded_differs |= padded != real
    assert padded_differs


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", ["pl", "rmat", "band"])
def test_pop_quant_replan_matches_jax(family, use_kernel):
    """Quantized plans re-plan too: padded tables re-run whole, their real
    rows spliced back, as in JAX."""
    a, b = PAIRS[family]
    jp, jc, jout, jcsr = _jax_pop_quant_replan(family)
    tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=0.0,
                               pop_quant=True,
                               retry_policy=tplan_mod.RetryPolicy(),
                               sample_rows=_rows(a), use_kernel=use_kernel,
                               device="cpu")
    tc = tplan_mod.PlanCache()
    tout = tplan_mod.execute(tp, _host(a), _host(b), cache=tc)
    assert tp.retries == jp.retries >= 1
    assert tp.retry_events == jp.retry_events
    assert tp.alloc.bucket_capacities == jp.alloc.bucket_capacities
    assert tc.stats() == jc
    _assert_same_output(tout, jout, tplan_mod.reassemble(tp, tout), jcsr)


@functools.lru_cache(maxsize=None)
def _jax_pop_quant_replan(family):
    a, b = PAIRS[family]
    jp = jplan_mod.plan_spgemm(a, b, safety=0.0, pop_quant=True,
                               retry_policy=jplan_mod.RetryPolicy(),
                               sample_rows=_rows(a))
    cache = jplan_mod.PlanCache()
    jout = jplan_mod.execute(jp, a, b, cache=cache)
    return jp, cache.stats(), _frozen(jout), jplan_mod.reassemble(jp, jout)


def _members(gen):
    return [gen(s) for s in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_template_members(family):
    """JAX's member sequence against one template (each member twice):
    the template's stats after each plan, each plan, its output and CSR,
    and the cache's stats at the end."""
    gen = GENERATORS[family]
    a0, b0 = gen(100)
    rows = _rows(a0)
    jt = jplan_mod.PlanTemplate.from_plan(
        jplan_mod.plan_spgemm(a0, b0, safety=1.3, pop_quant=True,
                              sample_rows=rows))
    seen = [jt.stats()]
    cache = jplan_mod.PlanCache()
    for a, b in _members(gen) * 2:
        jp = jplan_mod.plan_spgemm(a, b, safety=1.3, template=jt,
                                   sample_rows=rows)
        stats = jt.stats()
        jout = jplan_mod.execute(jp, a, b, cache=cache)
        seen.append((stats, jp, _frozen(jout),
                     jplan_mod.reassemble(jp, jout, on_overflow="ignore")))
    return seen, cache.stats()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", sorted(GENERATORS))
def test_template_members_match_jax(family, use_kernel):
    """A member sequence against one template: JAX's growths, keys,
    populations, capacities and outputs; then, after the last growth,
    re-planned members keep their key and the cache builds nothing."""
    gen = GENERATORS[family]
    a0, b0 = gen(100)
    rows = _rows(a0)
    (jt_stats, *runs), jcache = _jax_template_members(family)
    tt = tplan_mod.PlanTemplate.from_plan(
        tplan_mod.plan_spgemm(_host(a0), _host(b0), safety=1.3,
                              pop_quant=True, sample_rows=rows,
                              use_kernel=use_kernel, device="cpu"))
    assert tt.stats() == jt_stats
    tcache = tplan_mod.PlanCache()
    for (a, b), (stats, jp, jout, jc) in zip(_members(gen) * 2, runs):
        tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=1.3,
                                   template=tt, sample_rows=rows,
                                   use_kernel=use_kernel, device="cpu")
        assert tt.stats() == stats
        assert _strip(tp.key) == _strip(jp.key)
        assert tp.local_populations() == jp.local_populations()
        assert tp.stats()["row_padding"] == jp.stats()["row_padding"]
        tout = tplan_mod.execute(tp, _host(a), _host(b), cache=tcache)
        _assert_same_output(
            tout, jout, tplan_mod.reassemble(tp, tout, on_overflow="ignore"),
            jc)
    assert tcache.stats()["traces"] == jcache["traces"]
    # steady state: no growth, one key, no build
    g, t = tt.growths, tcache.stats()["traces"]
    keys = set()
    for a, b in _members(gen):
        tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=1.3,
                                   template=tt, sample_rows=rows,
                                   use_kernel=use_kernel, device="cpu")
        hits = tcache.hits
        tplan_mod.execute(tp, _host(a), _host(b), cache=tcache)
        assert tcache.hits == hits + 1
        keys.add(tp.key)
    assert tt.growths == g and tcache.stats()["traces"] == t
    assert len(keys) == 1


def _auto_members():
    return _members(GENERATORS["er"]) + _members(GENERATORS["band"])


@functools.lru_cache(maxsize=None)
def _jax_auto_registry():
    """JAX's ``template="auto"`` run over both families' members: the
    registry's stats after each plan, each plan and its output."""
    reg, cache = jplan_mod.TemplateRegistry(), jplan_mod.PlanCache()
    seen = []
    for a, b in _auto_members():
        jp = jplan_mod.plan_spgemm(a, b, safety=1.3, template="auto",
                                   registry=reg, sample_rows=_rows(a))
        seen.append((reg.stats(), jp,
                     _frozen(jplan_mod.execute(jp, a, b, cache=cache))))
    return seen


@pytest.mark.parametrize("use_kernel", [False, True])
def test_auto_template_registry_matches_jax(use_kernel):
    """``template="auto"``: the members of two families resolve to one
    template each (JAX's misses, hits and growths), and every member gives
    JAX's key and output; a re-planned member after the last growth keeps
    its key and builds nothing."""
    treg, tcache = tplan_mod.TemplateRegistry(), tplan_mod.PlanCache()
    members = _auto_members()
    for (a, b), (jstats, jp, jout) in zip(members, _jax_auto_registry()):
        tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=1.3,
                                   template="auto", registry=treg,
                                   sample_rows=_rows(a),
                                   use_kernel=use_kernel, device="cpu")
        assert treg.stats() == jstats
        assert _strip(tp.key) == _strip(jp.key)
        tout = tplan_mod.execute(tp, _host(a), _host(b), cache=tcache)
        _assert_same_output(tout, jout)
    assert treg.stats()["misses"] == 2 and treg.stats()["hits"] == 4
    t = tcache.stats()["traces"]
    for a, b in members:
        tp = tplan_mod.plan_spgemm(_host(a), _host(b), safety=1.3,
                                   template="auto", registry=treg,
                                   sample_rows=_rows(a),
                                   use_kernel=use_kernel, device="cpu")
        tplan_mod.execute(tp, _host(a), _host(b), cache=tcache)
    assert tcache.stats()["traces"] == t


EMPTY_CASE = (lambda: sprand.power_law(500, 500, 5, 1.5, seed=21),
              lambda: sprand.banded(500, 500, 6, 8, seed=3))


@functools.lru_cache(maxsize=None)
def _jax_empty_bucket():
    pl, band = (f() for f in EMPTY_CASE)
    rows = _rows(pl)
    jt = jplan_mod.PlanTemplate.from_plan(
        jplan_mod.plan_spgemm(pl, pl, pop_quant=True, sample_rows=rows))
    jp = jplan_mod.plan_spgemm(band, band, template=jt, sample_rows=rows)
    jout = jplan_mod.execute(jp, band, band, cache=jplan_mod.PlanCache())
    return jp, _frozen(jout), jplan_mod.reassemble(jp, jout)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_empty_template_bucket_launches_row_zero_at_its_flop(use_kernel):
    """A power-law template planned against a banded member leaves its wide
    buckets empty: each launches a table of row 0, whose FLOP is the
    bucket's bound (not 0), and the output is JAX's."""
    pl, band = (f() for f in EMPTY_CASE)
    rows = _rows(pl)
    jp, jout, jc = _jax_empty_bucket()
    tt = tplan_mod.PlanTemplate.from_plan(
        tplan_mod.plan_spgemm(_host(pl), _host(pl), pop_quant=True,
                              sample_rows=rows, device="cpu"))
    tp = tplan_mod.plan_spgemm(_host(band), _host(band), template=tt,
                               sample_rows=rows, use_kernel=use_kernel,
                               device="cpu")
    assert _strip(tp.key) == _strip(jp.key)
    empty = [i for i, bk in enumerate(tp.binning.buckets) if not bk.n_rows]
    assert empty
    for i in empty:
        table = tp.host_tables()[i]
        assert table.size == tp.local_populations()[i] and not table.any()
        assert tp.flop_bounds()[i] == int(tp.flopr[0]) > 0
    tout = tplan_mod.execute(tp, _host(band), _host(band),
                             cache=tplan_mod.PlanCache())
    _assert_same_output(tout, jout, tplan_mod.reassemble(tp, tout), jc)


def test_template_refusals_match_jax():
    a = sprand.banded(200, 200, 6, 8, seed=1)
    small = sprand.banded(100, 100, 6, 8, seed=2)
    tt = tplan_mod.PlanTemplate.from_plan(
        tplan_mod.plan_spgemm(_host(a), _host(a), safety=2.0, pop_quant=True,
                              device="cpu"))
    with pytest.raises(ValueError, match="shapes"):
        tplan_mod.plan_spgemm(_host(small), _host(small), template=tt,
                              device="cpu")
    with pytest.raises(ValueError, match="pop_quant"):
        tplan_mod.PlanTemplate.from_plan(tplan_mod.plan_spgemm(
            _host(a), _host(a), safety=2.0, device="cpu"))
    with pytest.raises(ValueError, match="template mode"):
        tplan_mod.plan_spgemm(_host(a), _host(a), template="bogus",
                              device="cpu")


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("family", ["pl", "band"])
def test_distributed_profile_growth_matches_jax(family, num_shards):
    """The per-mesh-size shard profile (``dist_profile``/``grow_dist``),
    grown by a seeded sequence of per-bucket rows and capacities: the same
    profiles and growth counts as JAX's (the first use seeds the profile
    without counting growth; each mesh size keeps its own)."""
    a, b = PAIRS[family]
    jt = jplan_mod.PlanTemplate.from_plan(_jax_pop_quant(family)[0])
    tt = tplan_mod.PlanTemplate.from_plan(tplan_mod.plan_spgemm(
        _host(a), _host(b), safety=2.0, pop_quant=True,
        sample_rows=_rows(a), device="cpu"))
    assert tt.growths == jt.growths
    nb = len(tt.sigs)
    rng = np.random.default_rng(7 + num_shards)
    for step in range(6):
        rows_pb = rng.integers(0, 40 * (step + 1), nb)
        caps = rng.integers(0, 30 * (step + 1), nb)
        shards = num_shards if step % 3 else 2 * num_shards
        got = tt.grow_dist(shards, rows_pb, caps)
        assert got == jt.grow_dist(shards, rows_pb, caps)
        assert tt.growths == jt.growths
        assert tt.dist_profile(shards) == jt.dist_profile(shards)
    assert tt.growths > 0
    assert tt.stats() == jt.stats()


def test_structural_sketch_matches_jax():
    a1 = sprand.erdos_renyi(300, 300, 4, seed=1)
    for m in (a1, sprand.erdos_renyi(300, 300, 4, seed=2),
              sprand.erdos_renyi(400, 400, 4, seed=1),
              sprand.erdos_renyi(300, 300, 24, seed=1)):
        assert (tplan_mod._structural_sketch(_host(m), _host(m))
                == jplan_mod._structural_sketch(m, m))
    reg = tplan_mod.TemplateRegistry()
    sentinel = object()
    reg.get_or_create(_host(a1), _host(a1), lambda: sentinel)
    a2 = _host(sprand.erdos_renyi(300, 300, 4, seed=2))
    assert reg.lookup(a2, a2) is sentinel
    assert tplan_mod.template_registry() is tplan_mod.template_registry()
