"""Column-partitioned B (``plan_spgemm(n_panels=...)``) in the port against
the JAX package, and the port's copy of ``core/partition.py``.

The same operands and sample rows go through ``repro`` and ``repro_torch``
on the small families of ``tests/test_panels.py``: panel edges, keys and
entry counts (quantized too), the per-panel degree and FLOP tables, the
per-(bucket, panel) capacities, and whole panel plans at 2, 3 and 4 panels
with ``use_kernel`` off and on (on the CPU the kernel wrappers run their
plain versions) — capacities, panel degree bounds, key, ``stats()``, every
(bucket × panel) block's ``col`` and ``row_nnz``, ``overflow`` and the
reassembled ``rpt``/``col`` exactly, ``val`` within rtol 1e-5.  Re-planning
per (bucket × panel) unit at ``safety=0`` gives JAX's events and
degradations, and builds as many executors as JAX traces.  The partition
tests are ``tests/test_partition.py``'s, run on the port's copy, with
``balanced_contiguous``'s imbalance held to ``>= 1 - 1e-12`` (its float sum
may land one ulp under 1.0)."""
import functools

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal CI image — deterministic tests must still run
    from hypothesis_shim import given, settings, st

from repro.core import binning as jbinning
from repro.core import partition as jpartition
from repro.core import plan as jplan_mod
from repro.core import predictor as jpredictor
from repro.sparse import random as sprand
from repro_torch.core import binning as tbinning
from repro_torch.core import oracle as toracle
from repro_torch.core import partition as tpartition
from repro_torch.core import plan as tplan_mod
from repro_torch.core import predictor as tpredictor
from repro_torch.core.errors import PlanMismatchError
from repro_torch.core.mesh import make_mesh
from repro_torch.sparse.formats import CSR, spgemm_dense_oracle

torch.set_num_threads(1)

VAL_RTOL = 1e-5
IMBALANCE_FLOOR = 1.0 - 1e-12

FAMILIES = {
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

# (family, n_panels, planning options): 2, 3 and 4 panels, and one
# quantized plan (pow2 edges, populations and capacities).  JAX compiles
# one program per plan, so the power-law family (the most buckets) runs
# through the table tests above only
PLANS = [
    ("er", 2, dict(safety=2.0)),
    ("rmat", 2, dict(safety=2.0)),
    ("band", 4, dict(safety=1.3)),
    ("fem", 3, dict(safety=2.0)),
    ("band", 2, dict(safety=1.3, pop_quant=True)),
]
# (family, n_panels, mode) planned at safety 0: every unit at the 8-slot
# floor, so the wave overflows and re-plans per (bucket × panel) unit
REPLANS = [("fem", 3, "retry_safety"), ("fem", 3, "rounds0"),
           ("band", 2, "retry_safety"), ("band", 2, "rounds0")]


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _rows(jm, n=40):
    return np.random.default_rng(2).integers(0, jm.nrows, n)


def _replan_options(mod, mode):
    return dict(retry_safety=dict(retry_safety=1.5),
                rounds0=dict(retry_policy=mod.RetryPolicy(rounds=0)))[mode]


@functools.lru_cache(maxsize=None)
def _jax_run(family, n_panels, opts):
    """JAX's panel plan → execute → reassemble (plain path), once for both
    use_kernel settings of the port."""
    a, b = FAMILIES[family]
    opts = dict(opts)
    if "mode" in opts:
        opts = dict(safety=0.0, **_replan_options(jplan_mod,
                                                  opts.pop("mode")))
    cache = jplan_mod.PlanCache()
    p = jplan_mod.plan_spgemm(a, b, n_panels=n_panels, sample_rows=_rows(a),
                              **opts)
    caps0 = np.asarray(p.panel_caps).copy()
    out = jplan_mod.execute(p, a, b, cache=cache)
    return dict(p=p, caps0=caps0, out=out, c=jplan_mod.reassemble(p, out),
                traces=cache.stats())


def _port_run(family, n_panels, opts, use_kernel):
    a, b = FAMILIES[family]
    opts = dict(opts)
    if "mode" in opts:
        opts = dict(safety=0.0, **_replan_options(tplan_mod,
                                                  opts.pop("mode")))
    cache = tplan_mod.PlanCache()
    p = tplan_mod.plan_spgemm(_host(a), _host(b), n_panels=n_panels,
                              sample_rows=_rows(a), use_kernel=use_kernel,
                              device="cpu", **opts)
    caps0 = p.panel_caps.copy()
    out = tplan_mod.execute(p, _host(a), _host(b), cache=cache)
    return p, caps0, out, cache


def _assert_blocks_match(tp, out, jp, jout):
    """Every (bucket × panel) block against JAX's, cut to the bucket's real
    rows (JAX keeps a padded table's pad rows in its blocks)."""
    assert len(out.cols) == len(jout.cols) == len(jp.binning.buckets)
    for i, bk in enumerate(jp.binning.buckets):
        for p in range(jp.n_panels):
            want_c = np.asarray(jout.cols[i][p])[:bk.n_rows]
            want_v = np.asarray(jout.vals[i][p])[:bk.n_rows]
            np.testing.assert_array_equal(out.cols[i][p].numpy(), want_c)
            np.testing.assert_array_equal(
                out.row_nnz[i][p].numpy(),
                np.asarray(jout.row_nnz[i][p])[:bk.n_rows])
            np.testing.assert_allclose(out.vals[i][p].numpy(), want_v,
                                       rtol=VAL_RTOL, atol=1e-6)
    assert int(out.overflow) == int(jout.overflow)


def _assert_csr_match(c, want):
    np.testing.assert_array_equal(c.rpt, want.rpt)
    np.testing.assert_array_equal(c.col, want.col)
    np.testing.assert_allclose(c.val, want.val, rtol=VAL_RTOL, atol=1e-6)


# --------------------------------------------------------------------------- #
# partition: tests/test_partition.py on the port's copy, and parity
# --------------------------------------------------------------------------- #
@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=0, max_value=200),
       st.integers(min_value=1, max_value=16),
       st.integers(min_value=0, max_value=3))
def test_balanced_contiguous_invariants(nrows, num_parts, mode):
    rng = np.random.default_rng(nrows * 31 + num_parts)
    if mode == 0:
        w = np.zeros(nrows)
    elif mode == 1:
        w = rng.random(nrows)
    else:
        w = rng.integers(0, 5, nrows).astype(float)
    part = tpartition.balanced_contiguous(w, num_parts)
    bounds = part.bounds
    assert bounds.shape == (num_parts + 1,)
    assert bounds[0] == 0 and bounds[-1] == nrows
    assert (np.diff(bounds) >= 0).all()
    np.testing.assert_allclose(part.part_weight.sum(), w.sum(),
                               rtol=1e-9, atol=1e-9)
    for s in range(num_parts):
        np.testing.assert_allclose(part.part_weight[s],
                                   w[bounds[s]:bounds[s + 1]].sum(),
                                   rtol=1e-9, atol=1e-9)
    assert part.imbalance >= IMBALANCE_FLOOR or w.sum() == 0
    # the copy is the JAX package's function: the same partition exactly
    want = jpartition.balanced_contiguous(w, num_parts)
    np.testing.assert_array_equal(bounds, want.bounds)
    np.testing.assert_array_equal(part.part_weight, want.part_weight)
    assert part.imbalance == want.imbalance


def test_balanced_contiguous_holds_r4_within_its_floor():
    """The case tests/test_partition.py fails on (R4): one part, random
    weights, imbalance one ulp under 1.0 — within the contract's floor."""
    w = np.random.default_rng(12 * 31 + 1).random(12)
    part = tpartition.balanced_contiguous(w, 1)
    assert IMBALANCE_FLOOR <= part.imbalance <= 1.0 + 1e-12


def test_balanced_contiguous_degenerate_pins():
    part = tpartition.balanced_contiguous(np.zeros(7), 3)
    assert part.bounds[-1] == 7 and part.imbalance == 1.0
    part = tpartition.balanced_contiguous(np.ones(2), 5)
    assert part.bounds[-1] == 2
    assert (np.diff(part.bounds) >= 0).all()
    assert int((np.diff(part.bounds) > 0).sum()) <= 2
    part = tpartition.balanced_contiguous(np.array([3.0]), 4)
    assert part.bounds[-1] == 1
    assert float(part.part_weight.sum()) == 3.0


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=1, max_value=120),
       st.integers(min_value=1, max_value=8),
       st.integers(min_value=1, max_value=40))
def test_static_row_assignment_pad_contract(nrows, num_parts, rows_per_part):
    rng = np.random.default_rng(nrows * 13 + num_parts * 7 + rows_per_part)
    part = tpartition.balanced_contiguous(rng.random(nrows), num_parts)
    table = tpartition.static_row_assignment(part, rows_per_part)
    assert table.shape == (num_parts, rows_per_part)
    for s in range(num_parts):
        lo, hi = int(part.bounds[s]), int(part.bounds[s + 1])
        n = hi - lo
        if n == 0:
            np.testing.assert_array_equal(table[s], 0)
            continue
        k = min(n, rows_per_part)
        np.testing.assert_array_equal(table[s, :k], np.arange(lo, lo + k))
        np.testing.assert_array_equal(table[s, k:], hi - 1)


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=0, max_value=150),
       st.integers(min_value=1, max_value=6))
def test_shard_slices_tile_the_row_list(nrows, num_parts):
    rng = np.random.default_rng(nrows * 17 + num_parts)
    rows = np.sort(rng.choice(max(nrows, 1), size=nrows // 2, replace=False)
                   ) if nrows else np.zeros(0, np.int64)
    part = tpartition.balanced_contiguous(rng.random(nrows), num_parts)
    lo, hi = tpartition.shard_slices(rows, part.bounds)
    assert (hi >= lo).all()
    pieces = [rows[lo[s]:hi[s]] for s in range(num_parts)]
    np.testing.assert_array_equal(np.concatenate([np.zeros(0, rows.dtype)]
                                                 + pieces), rows)
    for s, piece in enumerate(pieces):
        if piece.size:
            assert piece.min() >= part.bounds[s]
            assert piece.max() < part.bounds[s + 1]


def test_cost_weights_and_straggler_report_match_jax():
    a, b = FAMILIES["pl"]
    tw = tpartition.binned_cost_weights(tbinning.build_plan(_host(a),
                                                            _host(b)))
    jw = jpartition.binned_cost_weights(jbinning.build_plan(a, b))
    np.testing.assert_array_equal(tw, jw)
    flop = np.diff(a.rpt).astype(np.float64) ** 2
    args = [(f.balanced_contiguous(flop, 4), f.balanced_contiguous(tw, 4))
            for f in (tpartition, jpartition)]
    assert (tpartition.straggler_report(*args[0])
            == jpartition.straggler_report(*args[1]))


# --------------------------------------------------------------------------- #
# panel edges and the per-panel tables
# --------------------------------------------------------------------------- #
@given(st.integers(64, 1 << 14), st.integers(2, 8),
       st.integers(0, 1 << 14), st.integers(0, 1 << 14))
@settings(max_examples=60, deadline=None)
def test_quantized_edges_collide_iff_same_band(ncols, n_panels, e1, e2):
    g = tpartition.panel_grid(ncols, n_panels)
    assert g == jpartition.panel_grid(ncols, n_panels)
    e1, e2 = min(e1, max(0, ncols - g)), min(e2, max(0, ncols - g))
    q1 = tpartition.quantize_panel_edges(
        np.array([0] + [e1] * (n_panels - 1) + [ncols]), ncols)
    q2 = tpartition.quantize_panel_edges(
        np.array([0] + [e2] * (n_panels - 1) + [ncols]), ncols)
    same_band = (e1 + g // 2) // g == (e2 + g // 2) // g
    assert (q1[1] == q2[1]) == same_band
    assert abs(int(q1[1]) - e1) <= g // 2
    assert int(q1[1]) % g == 0


@given(st.integers(64, 1 << 14), st.lists(st.integers(0, 1 << 14),
                                          min_size=1, max_size=7))
@settings(max_examples=40, deadline=None)
def test_quantized_edges_preserve_monotonicity_and_endpoints(ncols, inner):
    edges = np.concatenate([[0], np.sort(np.clip(inner, 0, ncols)), [ncols]])
    q = tpartition.quantize_panel_edges(edges, ncols)
    assert q[0] == 0 and q[-1] == ncols
    assert (np.diff(q) >= 0).all()
    np.testing.assert_array_equal(
        q, jpartition.quantize_panel_edges(edges, ncols))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n_panels", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_column_panels_match_jax(family, n_panels, quantize):
    b = FAMILIES[family][1]
    got = tpartition.column_panels(_host(b), n_panels, quantize=quantize)
    want = jpartition.column_panels(b, n_panels, quantize=quantize)
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.panel_nnz, want.panel_nnz)
    assert got.key == want.key and got.n_panels == n_panels
    assert int(got.panel_nnz.sum()) == b.nnz
    pid = got.panel_of(b.col)
    for p in range(n_panels):
        sel = b.col[pid == p]
        if sel.size:
            assert got.edges[p] <= sel.min() and sel.max() < got.edges[p + 1]


def test_column_panels_refuses_no_panels():
    with pytest.raises(PlanMismatchError):
        tpartition.column_panels(_host(FAMILIES["er"][1]), 0)


def test_quantized_panel_edges_stable_across_seeds():
    keys = {tpartition.column_panels(
        _host(sprand.banded(600, 600, 12, 16, seed=s)), 4,
        quantize=True).key for s in (5, 7, 11)}
    assert len(keys) == 1


@pytest.mark.parametrize("n_panels", [2, 3, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_panel_tables_and_capacities_match_jax(family, n_panels):
    a, b = FAMILIES[family]
    edges = jpartition.column_panels(b, n_panels).edges
    tsl = tplan_mod._slice_panels(_host(b), edges)
    jsl = jplan_mod._slice_panels(b, edges)
    for t, j in zip(tsl, jsl):
        for x, y in zip(t, j):
            np.testing.assert_array_equal(x, y)
    tdb, tfl = tbinning.panel_row_tables(a.rpt, a.col, [s[0] for s in tsl])
    jdb, jfl = jbinning.panel_row_tables(a.rpt, a.col, [s[0] for s in jsl])
    np.testing.assert_array_equal(tdb, jdb)
    np.testing.assert_array_equal(tfl, jfl)
    # panels partition B's entries: the per-panel FLOP sums to the row's
    full, _ = toracle.flop_per_row(_host(a), _host(b))
    np.testing.assert_array_equal(tfl.sum(axis=0), full)
    # capacities per (bucket, shard, panel), and without panels
    structure = np.random.default_rng(3).uniform(0.2, 1.0, a.nrows) * full
    pstruct = tfl / 2.5
    bounds = np.array([0, a.nrows // 3, a.nrows])
    tplan = tbinning.build_plan(_host(a), _host(b))
    jplan = jbinning.build_plan(a, b)
    for kw in (dict(panel_structure=pstruct, panel_flopr=tfl), {}):
        for pow2 in (False, True):
            got = tpredictor.shard_bucket_capacities(
                tplan, structure, full, bounds, safety=1.3, pow2=pow2, **kw)
            want = jpredictor.shard_bucket_capacities(
                jplan, structure, full, bounds, safety=1.3, pow2=pow2, **kw)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


# --------------------------------------------------------------------------- #
# whole panel plans against JAX's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family,n_panels,opts", PLANS,
                         ids=[f"{f}-{n}-{'q' if o.get('pop_quant') else 'x'}"
                              for f, n, o in PLANS])
def test_panel_plan_matches_jax(family, n_panels, opts, use_kernel):
    want = _jax_run(family, n_panels, tuple(sorted(opts.items())))
    jp = want["p"]
    tp, _, out, cache = _port_run(family, n_panels, opts, use_kernel)
    np.testing.assert_array_equal(tp.panel_caps, jp.panel_caps)
    assert tp.panel_deg_b == jp.panel_deg_b
    assert tp._panel_caps_dev == jp._panel_caps_dev
    # the key's panel half and its buckets, and all but use_kernel
    assert tp.key[-2:] == jp.key[-2:]
    assert tp.key[:3] + tp.key[4:] == jp.key[:3] + jp.key[4:]
    ts, js = tp.stats(), jp.stats()
    for k in ("n_panels", "panel_edges", "panel_nnz", "bucket_capacities"):
        assert ts[k] == js[k], k
    _assert_blocks_match(tp, out, jp, want["out"])
    # one build for the wave, as JAX traces its panel executor once
    assert cache.stats() == want["traces"]
    c = tplan_mod.reassemble(tp, out)
    _assert_csr_match(c, want["c"])
    np.testing.assert_allclose(c.to_dense(),
                               spgemm_dense_oracle(_host(FAMILIES[family][0]),
                                                   _host(FAMILIES[family][1])),
                               rtol=1e-4, atol=1e-4)


def test_panel_plan_equals_the_unpanelled_plan():
    """A row's panel blocks, read in panel order, are its unpanelled row."""
    a, b = (_host(m) for m in FAMILIES["fem"])
    whole = tplan_mod.plan_spgemm(a, b, safety=2.0, sample_rows=_rows(a),
                                  device="cpu")
    want = tplan_mod.reassemble(whole, tplan_mod.execute(whole, a, b))
    for n_panels in (1, 2, 5):
        p = tplan_mod.plan_spgemm(a, b, safety=2.0, sample_rows=_rows(a),
                                  device="cpu", n_panels=n_panels)
        _assert_csr_match(tplan_mod.reassemble(p, tplan_mod.execute(p, a, b)),
                          want)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family,n_panels,mode", REPLANS)
def test_panel_replan_matches_jax(family, n_panels, mode, use_kernel):
    want = _jax_run(family, n_panels, (("mode", mode),))
    jp = want["p"]
    tp, caps0, out, cache = _port_run(family, n_panels, dict(mode=mode),
                                      use_kernel)
    np.testing.assert_array_equal(caps0, want["caps0"])
    assert jp.retry_events or jp.degradations
    assert tp.retries == jp.retries
    assert tp.retry_events == jp.retry_events
    assert tp.degradations == jp.degradations
    if mode == "rounds0":
        assert not tp.retry_events and tp.degradations
    else:
        assert all("panel" in e for e in tp.retry_events)
    np.testing.assert_array_equal(tp.panel_caps, jp.panel_caps)
    ts, js = tp.stats(), jp.stats()
    for k in ("retry_safety", "retries", "retry_events", "final_capacities",
              "degradations"):
        assert ts[k] == js[k], k
    _assert_blocks_match(tp, out, jp, want["out"])
    assert int(out.overflow) == 0
    # a build for the wave and one for each re-run unit's key, as JAX
    # traces them
    assert cache.stats() == want["traces"]
    _assert_csr_match(tplan_mod.reassemble(tp, out), want["c"])
    # the capacities were bumped in place: the plan runs right again
    out2 = tplan_mod.execute(tp, _host(FAMILIES[family][0]),
                             _host(FAMILIES[family][1]), cache=cache)
    assert tp.retries == 0 and not tp.degradations
    assert int(out2.overflow) == 0


def _revalue(m: CSR, seed: int) -> CSR:
    rng = np.random.default_rng(seed)
    return CSR(rpt=m.rpt.copy(), col=m.col.copy(),
               val=rng.standard_normal(m.nnz).astype(np.float32),
               shape=m.shape)


def test_panel_serving_pair_builds_no_new_executor():
    a = _host(sprand.banded(300, 300, 8, 12, seed=31))
    b = _host(sprand.banded(300, 300, 6, 10, seed=32))
    cache = tplan_mod.PlanCache()
    p1 = tplan_mod.plan_spgemm(a, b, safety=2.0, n_panels=2, device="cpu")
    tplan_mod.execute(p1, a, b, cache=cache)
    builds = cache.stats()["traces"]
    a2, b2 = _revalue(a, 41), _revalue(b, 42)
    p2 = tplan_mod.plan_spgemm(a2, b2, safety=2.0, n_panels=2, device="cpu")
    assert p2.key == p1.key
    out2 = tplan_mod.execute(p2, a2, b2, cache=cache)
    assert cache.stats()["traces"] == builds
    assert cache.stats()["hits"] == 1
    np.testing.assert_allclose(
        tplan_mod.reassemble(p2, out2).to_dense(),
        spgemm_dense_oracle(a2, b2), rtol=1e-4, atol=1e-4)
    # a revalued B of the planned structure passes the fingerprint check
    # and is gathered anew: the product follows its values
    out3 = tplan_mod.execute(p1, a, b2, cache=cache)
    assert p1.validation["fingerprint_checks"] == 1
    np.testing.assert_allclose(
        tplan_mod.reassemble(p1, out3).to_dense(),
        spgemm_dense_oracle(a, b2), rtol=1e-4, atol=1e-4)


def test_panel_operand_errors_match_jax():
    ja = sprand.banded(200, 200, 6, 8, seed=3)
    other = sprand.banded(200, 200, 7, 9, seed=4)
    jp = jplan_mod.plan_spgemm(ja, ja, safety=2.0, n_panels=2)
    tp = tplan_mod.plan_spgemm(_host(ja), _host(ja), safety=2.0, n_panels=2,
                               device="cpu")
    cases = ((lambda p, mod, h: mod.execute(p, h(ja), p.to_device(h(ja),
                                                                  "b"))),
             (lambda p, mod, h: mod.execute(p, h(ja), h(other))))
    for case in cases:
        with pytest.raises(jplan_mod.PlanMismatchError) as jerr:
            case(jp, jplan_mod, lambda m: m)
        with pytest.raises(PlanMismatchError) as terr:
            case(tp, tplan_mod, _host)
        assert str(terr.value).split(" [")[0] == str(jerr.value).split(
            " [")[0]
        tctx = {k: v for k, v in terr.value.context.items()
                if k != "plan_key"}
        jctx = {k: v for k, v in jerr.value.context.items()
                if k != "plan_key"}
        assert tctx == jctx
        assert set(terr.value.context) == set(jerr.value.context)
    assert tp.validation == jp.validation


def _moved(m: CSR, how: str) -> CSR:
    """``m`` with entries moved between rows, keeping its nnz and its
    multiset of columns (so the (nnz, col-sum) fingerprint): ``row`` moves
    one entry to a row that lacks its column, ``swap`` exchanges two
    equal-length rows of different columns (the row pointers stay)."""
    rows = [list(m.col[m.rpt[r]:m.rpt[r + 1]]) for r in range(m.nrows)]
    if how == "row":
        r1 = next(r for r in range(m.nrows) if rows[r])
        c = rows[r1][-1]
        r2 = next(r for r in range(m.nrows) if r != r1 and c not in rows[r])
        rows[r1].remove(c)
        rows[r2] = sorted(rows[r2] + [c])
    else:
        r1, r2 = next((r, s) for r in range(m.nrows)
                      for s in range(r + 1, m.nrows)
                      if len(rows[r]) == len(rows[s]) and rows[r] != rows[s])
        rows[r1], rows[r2] = rows[r2], rows[r1]
    rpt = np.zeros(m.nrows + 1, dtype=np.int64)
    np.cumsum([len(r) for r in rows], out=rpt[1:])
    out = CSR(rpt=rpt, col=np.concatenate(rows).astype(np.int32),
              val=m.val.copy(), shape=m.shape)
    assert out.nnz == m.nnz and sorted(out.col) == sorted(m.col)
    return out


@pytest.mark.parametrize("how", ["row", "swap"])
def test_panel_operand_with_moved_entries_is_refused(how):
    """B's entries moved between rows keep the JAX package's fingerprint;
    the port checks the structure itself and refuses the operand, typed,
    instead of pairing the new values with the planned entries."""
    a = _host(sprand.banded(200, 200, 6, 8, seed=3))
    b = _host(sprand.erdos_renyi(200, 200, 4, seed=5))
    p = tplan_mod.plan_spgemm(a, b, safety=2.0, n_panels=2, device="cpu")
    with pytest.raises(PlanMismatchError) as err:
        tplan_mod.execute(p, a, _moved(b, how), cache=tplan_mod.PlanCache())
    assert err.value.context["operand"] == "b"
    assert 0 <= err.value.context["row"] < b.nrows
    assert p.validation["fingerprint_checks"] == 1


@pytest.mark.parametrize("option,n_panels", [
    (dict(num_shards=4), 3), (dict(num_shards=2), 4), ("mesh", 3)])
def test_panels_must_divide_the_mesh(option, n_panels):
    """``tests/test_panels.py``'s pin: panels fold onto the mesh axis, so
    ``n_panels`` must divide its size — refused typed, as in JAX, with the
    same message."""
    a = _host(sprand.banded(100, 100, 4, 6, seed=1))
    if option == "mesh":
        option = dict(mesh=make_mesh((4,), ("data",), devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="divide") as err:
        tplan_mod.plan_spgemm(a, a, n_panels=n_panels, device="cpu",
                              **option)
    assert isinstance(err.value, PlanMismatchError)
    shards = option.get("num_shards", 4)
    with pytest.raises(ValueError, match="divide"):
        jplan_mod.plan_spgemm(sprand.banded(100, 100, 4, 6, seed=1),
                              sprand.banded(100, 100, 4, 6, seed=1),
                              n_panels=n_panels, num_shards=shards)