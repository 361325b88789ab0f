"""The binned predictor's one-launch kernels on the CPU: the FLOP kernel
over every row of a plan (``flop_rows_buckets``) and the fused ESC symbolic
kernel over every sampled row of a prediction's ESC buckets
(``fused_flop_symbolic_buckets``).

Their plain versions — what the wrappers run on CPU tensors — are held
against the JAX package's per-bucket loops: ``_binned_floprc``, whose
``flop_rows_pallas`` runs in interpret mode, and
``binned_symbolic_counts(use_kernel=True)``, whose fused ESC and bitmask
Pallas kernels do.  The host-side tables (the plan's row → bucket map and
bounds, cached per plan and device; the per-sample table and the launch's
workspace sizing from floprC) are pinned here too.  The kernels themselves
run only on a card (tests/test_torch_cuda.py)."""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binning as jbinning
from repro.core import csr as jcsr
from repro.core import predictor as jpred
from repro.kernels import ops as jops
from repro.sparse import random as jrand
from repro.sparse import suite as jsuite
from repro.sparse.formats import CSR as JCSR
from repro_torch import convert
from repro_torch.core import binning as tbinning
from repro_torch.core import oracle as toracle
from repro_torch.core import predictor as tpred
from repro_torch.kernels import _build
from repro_torch.kernels import flop_per_row as tflop_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spgemm_symbolic as tsym_k
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

FAMILIES = ("mini_er", "mini_pl", "mini_rmat", "mini_band", "mini_fem")
ROUTES = ("esc", "spa", "bin", "auto")
_MINI = dict(jsuite.mini_suite(scale=200))
# opt-in shared memory a block: H100 (227 KB) and the 48 KB default
SMEM_LIMITS = (232_448, 49_152)


def _case(jm, route="esc", samples=40, seed=0, rows=None, **plan_kw):
    """JAX and port operands, the JAX bucket plan carried across, and
    explicit sample rows (with replacement)."""
    cap = max(1, tbinning.ceil_pow2(jm.nnz))
    jd = jcsr.to_device(jm, capacity=cap)
    td = convert.csr_device_from_numpy(np.asarray(jd.rpt), np.asarray(jd.col),
                                       np.asarray(jd.val), jd.shape,
                                       device="cpu")
    jplan = jbinning.build_plan(jm, jm, route=route, **plan_kw)
    tplan = convert.binning_plan_from_numpy(
        [dict(rows=np.asarray(b.rows), deg_a=b.deg_a, deg_b=b.deg_b,
              block_rows=b.block_rows, route=b.route, tile_n=b.tile_n,
              n_tiles=b.n_tiles, span=b.span) for b in jplan.buckets],
        global_deg_a=jplan.global_deg_a, global_deg_b=jplan.global_deg_b)
    if rows is None:
        rows = np.random.default_rng(seed).integers(0, jm.nrows, samples)
    return jd, td, jplan, tplan, np.asarray(rows, dtype=np.int32)


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _assert_matches_jax(jm, route, rows=None, **plan_kw):
    """floprC, z* and f* of the port's one-launch path (plain versions on
    the CPU) equal JAX's per-bucket Pallas loops and the host oracle; the
    ESC samples' per-row FLOP equals JAX's fused kernel's, bucket by
    bucket.  Returns the port's plan, its tables and the sample rows."""
    jd, td, jplan, tplan, rows = _case(jm, route=route, rows=rows, **plan_kw)
    want = np.asarray(jpred._binned_floprc(jd, jd, jplan))
    tabs = tpred.plan_tables(tplan, "cpu")
    rnb = torch.diff(td.rpt)
    got = tflop_k.flop_rows_buckets(td, rnb, tabs.flop)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tflop_k.flop_rows_buckets_plain(td, rnb, tabs.flop).numpy(), want)
    np.testing.assert_array_equal(tpred._binned_floprc(td, td, tplan).numpy(),
                                  want)
    zj, fj = jpred.binned_symbolic_counts(jd, jd, jnp.asarray(rows), jplan,
                                          use_kernel=True)
    for floprc in (None, got):
        zt, ft = tpred.binned_symbolic_counts(
            td, td, torch.from_numpy(rows), tplan, use_kernel=True,
            floprc=floprc)
        assert zt.dtype == torch.int32 and ft.dtype == torch.int32
        assert (int(zt), int(ft)) == (int(zj), int(fj))
    host_floprc, _ = toracle.flop_per_row(_host(jm), _host(jm))
    if rows.size:
        assert int(zj) == toracle.exact_sampled_nnz(_host(jm), _host(jm),
                                                    rows.astype(np.int64))
        assert int(fj) == int(host_floprc[rows].sum())
    # the ESC samples alone: the new entry's plain version against JAX's
    # fused kernel over the same rows, one bucket at a time
    table = tpred.esc_sample_table(tplan, tabs, rows, want[rows], "cpu")
    esc = tabs.esc[tplan.row_bucket[rows]]
    if table is None:
        assert not esc.any()
        return tplan, tabs, rows
    z, f, flop = tsym_k.fused_flop_symbolic_buckets(td, td, table)
    assert flop.shape == (int(esc.sum()),)
    np.testing.assert_array_equal(flop.numpy(), want[rows[esc]])
    zb = fb = 0
    for bk, sub in zip(jplan.buckets, jplan.subset(rows)):
        if sub.size and bk.route == "esc":
            zs, fs, fl = jops.fused_flop_symbolic(
                jd, jd, jnp.asarray(sub), max_deg_a=bk.deg_a,
                max_deg_b=bk.deg_b)
            zb, fb = zb + int(zs), fb + int(fs)
            np.testing.assert_array_equal(np.asarray(fl), want[sub])
    assert (int(z), int(f)) == (zb, fb)
    return tplan, tabs, rows


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("family", FAMILIES)
def test_one_launch_plain_versions_match_jax(family, route):
    _assert_matches_jax(_MINI[family], route)


@pytest.mark.parametrize("route", ["esc", "auto"])
@pytest.mark.parametrize("family", FAMILIES)
def test_binned_predictions_match_jax_pallas_kernels(family, route):
    """The whole binned prediction (eq. 4) through the one-launch path
    equals JAX's through its per-bucket Pallas kernels, and the port's
    plain predictor, bit for bit."""
    jd, td, jplan, tplan, rows = _case(_MINI[family], route=route, seed=3)
    jp = jpred.proposed_predict_binned(jd, jd, jnp.asarray(rows), jplan,
                                       use_kernel=True)
    tp = tpred.proposed_predict_binned(td, td, torch.from_numpy(rows), tplan,
                                       use_kernel=True)
    plain = tpred.proposed_predict_binned(td, td, torch.from_numpy(rows),
                                          tplan)
    for what in ("sampled_nnz", "sampled_flop", "total_flop"):
        assert int(getattr(tp, what)) == int(getattr(jp, what)), what
    for what in tp._fields:
        assert torch.equal(getattr(tp, what), getattr(plain, what)), what
    np.testing.assert_array_max_ulp(tp.structure.numpy(),
                                    np.asarray(jp.structure), maxulp=1)


# --------------------------------------------------------------------------- #
# Edge cases
# --------------------------------------------------------------------------- #
def _with_empty_rows(seed=21):
    """A power-law square whose first 40 rows are empty."""
    m = jrand.power_law(120, 120, 4, 1.5, seed=seed)
    deg = np.diff(m.rpt)
    deg[:40] = 0
    rpt = np.concatenate([[0], np.cumsum(deg)]).astype(m.rpt.dtype)
    keep = np.concatenate([m.col[m.rpt[i]:m.rpt[i] + deg[i]]
                           for i in range(m.nrows)])
    return JCSR(rpt=rpt, col=keep.astype(m.col.dtype),
                val=np.ones(keep.size, dtype=np.float32), shape=m.shape)


@pytest.mark.parametrize("route", ROUTES)
def test_duplicate_sampled_rows_count_each_time(route):
    jm = _MINI["mini_pl"]
    hub = int(np.argmax(np.diff(jm.rpt)))
    rows = np.array([hub, hub, 3, 3, 3, hub, 7])
    _assert_matches_jax(jm, route, rows=rows)


@pytest.mark.parametrize("route", ROUTES)
def test_samples_only_on_empty_rows(route):
    jm = _with_empty_rows()
    tplan, _, rows = _assert_matches_jax(jm, route, rows=np.arange(0, 40, 3))
    td = convert.csr_device_from_numpy(jm.rpt, jm.col, jm.val, jm.shape,
                                       device="cpu")
    z, f = tpred.binned_symbolic_counts(td, td, torch.from_numpy(rows),
                                        tplan, use_kernel=True)
    assert (int(z), int(f)) == (0, 0)


@pytest.mark.parametrize("route", ROUTES)
def test_all_zero_a(route):
    b = jrand.erdos_renyi(60, 60, 3, seed=23)
    zero = JCSR(rpt=np.zeros(61, dtype=b.rpt.dtype),
                col=np.zeros(0, dtype=b.col.dtype),
                val=np.zeros(0, dtype=np.float32), shape=(60, 60))
    tplan, tabs, rows = _assert_matches_jax(zero, route,
                                            rows=np.array([0, 5, 5, 59]))
    assert not tabs.flop.wide.numel()


def test_no_sampled_row_in_an_esc_bucket():
    """An auto plan with ESC and SPA buckets, sampled only in SPA ones: no
    ESC table, and the totals still equal JAX's."""
    jm = _MINI["mini_band"]
    jd, td, jplan, tplan, _ = _case(jm, route="auto")
    spa_rows = np.concatenate([b.rows for b in tplan.buckets
                               if b.route == "spa"])
    assert spa_rows.size
    tplan, tabs, rows = _assert_matches_jax(jm, "auto", rows=spa_rows[:9])
    assert tpred.esc_sample_table(tplan, tabs, rows, np.ones(rows.size),
                                  "cpu") is None


def test_a_single_bucket():
    jm = jrand.erdos_renyi(200, 200, 4, seed=25)
    tplan, tabs, _ = _assert_matches_jax(jm, "esc", min_rows=10_000)
    assert len(tplan.buckets) == 1 and tabs.deg_a.shape == (1,)


@pytest.mark.parametrize("route", ["esc", "auto"])
def test_deg_align_8(route):
    tplan, tabs, _ = _assert_matches_jax(_MINI["mini_pl"], route,
                                         deg_align=8)
    assert all(d % 8 == 0 or d < 8 for d in tabs.deg_a.tolist())


@pytest.mark.parametrize("family", FAMILIES)
def test_a_flop_below_the_rows_products_changes_no_count(family):
    """floprC sizes the ESC workspaces only: a caller's floprC below the
    sampled rows' products (1 a row) leaves z* and f* equal to JAX's."""
    jm = _MINI[family]
    jd, td, jplan, tplan, rows = _case(jm, samples=60, seed=3)
    zj, fj = jpred.binned_symbolic_counts(jd, jd, jnp.asarray(rows), jplan,
                                          use_kernel=True)
    zt, ft = tpred.binned_symbolic_counts(
        td, td, torch.from_numpy(rows), tplan, use_kernel=True,
        floprc=torch.ones(jm.nrows, dtype=torch.int32))
    assert (int(zt), int(ft)) == (int(zj), int(fj))


# --------------------------------------------------------------------------- #
# Kernel 7 at the global bounds, on kernel 2's launch
# --------------------------------------------------------------------------- #
_GLOBAL_JAX = {}


def _global_case(family, trunc):
    """The global-pad kernel-7 case of a mini family: port operands, seed-7
    sample rows, the global bounds (B's rows read to fewer entries than its
    widest has with ``trunc``) and JAX's ``sampled_symbolic_pallas`` (z*,
    f*) in interpret mode, computed once per case."""
    jm = _MINI[family]
    jd, td, _, _, rows = _case(jm, samples=48, seed=7)
    da = int(np.diff(jm.rpt).max())
    db = da - max(1, da // 3) if trunc else da
    if (family, trunc) not in _GLOBAL_JAX:
        zj, fj = jops.sampled_symbolic(jd, jd, jnp.asarray(rows), da, db)
        _GLOBAL_JAX[family, trunc] = (int(zj), int(fj))
    return td, rows, da, db, _GLOBAL_JAX[family, trunc]


@pytest.mark.parametrize("trunc", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_global_pad_counts_match_jax_sampled_symbolic(family, trunc):
    """Kernel 7's wrapper as the global-pad predictor calls it (every
    sampled row at the global bounds, its FLOP as the hint, f* the gathered
    products) on CPU tensors, where it runs the plain version: equal to
    JAX's ``sampled_symbolic_pallas`` (interpret mode) with B's rows read
    whole and, with ``trunc``, to fewer entries than B's widest has; f*
    then falls below the FLOP that kernel 2's f* sums.  The card's warp or
    block choice is modelled in the next test and run in the card tests."""
    td, rows, da, db, (zj, fj) = _global_case(family, trunc)
    rnb = torch.diff(td.rpt)
    trows = torch.from_numpy(rows)
    flop = tflop_k.flop_rows(td, rnb, trows, max_deg_a=da)
    z, f = tops.sampled_symbolic(td, td, trows, da, db, row_flop=flop)
    assert (int(z), int(f)) == (int(zj), int(fj))
    zp, fp = tsym_k.sampled_symbolic_plain(td, td, trows, max_deg_a=da,
                                           max_deg_b=db)
    assert (int(zp), int(fp)) == (int(zj), int(fj))
    # kernel 2's own counts on the same rows: z* the same, f* the FLOP
    z2, f2, fl = tsym_k.fused_flop_symbolic_plain(td, td, trows,
                                                  max_deg_a=da, max_deg_b=db)
    assert int(z2) == int(z) and torch.equal(fl, flop)
    assert int(f2) == int(flop.sum()) >= int(f)
    if not trunc:
        assert int(f2) == int(f)


@pytest.mark.parametrize("hint", ["flop", "one", "huge"])
@pytest.mark.parametrize("trunc", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_global_pad_row_dispatch_model_matches_jax(family, trunc, hint):
    """A model of kernel 7's launch on the card: each sampled row takes a
    block when ``min(hint, DA·DB)`` passes a warp's keys (``SYM_WARP_MAX``,
    capped by ``DA·DB``), else a warp, and whichever it takes adds the
    row's z and gathered products once.  Counted so, over the rows' FLOP,
    a hint of 1 a row (every row a warp) and of 2^30 (every row a block
    where ``DA·DB`` passes a warp), z* and f* equal JAX's."""
    td, rows, da, db, want = _global_case(family, trunc)
    trows = torch.from_numpy(rows)
    flop = tflop_k.flop_rows(td, torch.diff(td.rpt), trows, max_deg_a=da)
    hints = dict(flop=flop, one=torch.ones_like(flop),
                 huge=torch.full_like(flop, 1 << 30))
    cap = da * db
    warp_keys = min(cap, _build.SYM_WARP_MAX)
    long = torch.clamp(hints[hint].long(), max=cap) > warp_keys
    if hint == "one":
        assert not bool(long.any())
    if hint == "huge":
        assert bool(long.all()) == (cap > _build.SYM_WARP_MAX)
    z = f = 0
    for sel in (long, ~long):
        zs, fs = tsym_k.sampled_symbolic_plain(td, td, trows[sel],
                                               max_deg_a=da, max_deg_b=db)
        z, f = z + int(zs), f + int(fs)
    assert (z, f) == want


# --------------------------------------------------------------------------- #
# Host-side tables
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("source, macro, value", [
    ("flop_rows", "FLOP_NARROW", tflop_k.FLOP_NARROW),
    ("esc_symbolic", "SYM_WARP_MAX", _build.SYM_WARP_MAX),
    ("esc_symbolic", "SYM_WARPS", _build.SYM_WARPS)])
def test_launch_constants_are_read_from_the_kernel_sources(source, macro,
                                                           value):
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert f"#define {macro} {value} " in text
    assert _build.source_define(source, macro) == value


def test_source_define_raises_for_a_macro_the_source_lacks():
    with pytest.raises(RuntimeError, match="defines no integer"):
        _build.source_define("flop_rows", "NO_SUCH_MACRO")
    with pytest.raises(RuntimeError, match="defines no integer"):
        _build.source_define("esc_symbolic", "SYM_THREADS")  # not a number


def test_flop_tables_list_the_rows_of_wide_buckets():
    row_bucket = np.array([2, 0, 1, 1, 2, 0, 2], dtype=np.int32)
    deg_a = np.array([3, 17, 16], dtype=np.int32)
    tabs = tflop_k.flop_tables(row_bucket, deg_a, "cpu")
    np.testing.assert_array_equal(tabs.row_bucket.numpy(), row_bucket)
    np.testing.assert_array_equal(tabs.deg_a.numpy(), deg_a)
    # only bucket 1's bound (17) is past FLOP_NARROW
    np.testing.assert_array_equal(tabs.wide.numpy(), [2, 3])
    # one upload: the three tables are views of one int32 tensor
    assert tabs.packed.dtype == torch.int32 and tabs.packed.is_contiguous()
    assert (tabs.n_rows, tabs.n_buckets) == (7, 3)
    assert tabs.packed.tolist() == [2, 0, 1, 1, 2, 0, 2, 3, 17, 16, 2, 3]


@pytest.mark.parametrize("family", FAMILIES)
def test_plan_tables_hold_the_plans_buckets(family):
    _, _, _, tplan, _ = _case(_MINI[family], route="auto")
    tabs = tpred.plan_tables(tplan, "cpu")
    np.testing.assert_array_equal(tabs.flop.row_bucket.numpy(),
                                  tplan.row_bucket)
    assert tabs.deg_a.tolist() == [b.deg_a for b in tplan.buckets]
    assert tabs.deg_b.tolist() == [b.deg_b for b in tplan.buckets]
    assert tabs.esc.tolist() == [b.route == "esc" for b in tplan.buckets]
    wide = [i for i in range(tplan.nrows)
            if tplan.buckets[tplan.row_bucket[i]].deg_a
            > tflop_k.FLOP_NARROW]
    assert tabs.flop.wide.tolist() == wide


def test_sample_table_orders_long_rows_first_and_sizes_by_flop():
    """Rows whose products (floprC, capped by the bucket's DA·DB) pass a
    warp's share go first, each to a block; the rest keep their order;
    ``out`` puts every row back in the caller's order."""
    rows = np.array([5, 9, 2, 9, 7])
    deg_a = np.array([4, 40, 2, 40, 30])
    deg_b = np.array([4, 30, 3, 30, 30])
    flop = np.array([10, 900, 500, 900, 257])
    t = tsym_k.sample_table(rows, deg_a, deg_b, flop, "cpu")
    # row 2's 500 FLOP is capped at its bucket's 2·3 products
    assert (t.n_long, t.short_bound, t.long_bound, t.max_deg_a_long) == \
        (3, 10, 900, 40)
    s, da, db, out = t.samples.tolist()
    assert s == [9, 9, 7, 5, 2] and out == [1, 3, 4, 0, 2]
    assert da == [40, 40, 30, 4, 2] and db == [30, 30, 30, 4, 3]
    assert t.samples.dtype == torch.int32 and t.samples.is_contiguous()


@pytest.mark.parametrize("limit", SMEM_LIMITS)
def test_symbolic_shape_sizes_workspaces_from_the_rows_products(limit):
    warp = _build.SYM_WARP_MAX
    # short rows only: a warp's keys are exactly the largest short bound
    s = _build.symbolic_shape(limit, 37, 0, 0, 0, 50_000)
    assert (s.warp_keys, s.long_blocks, s.slice_bytes) == (37, 0, 0)
    assert s.smem_bytes == _build.SYM_WARPS * (256 + _build.align16(4 * 37))
    # long rows that fit: keys or the column bitmask in shared memory
    s = _build.symbolic_shape(limit, warp, 3000, 200, 5, 50_000)
    table = 2 * _build.align16(4 * 201)
    assert s.smem_keys == max(3000, -(-50_000 // 32))
    assert s.slice_bytes == 0 and s.long_blocks == 5
    assert s.smem_bytes == max(table + 4 * s.smem_keys,
                               _build.SYM_WARPS * (256 + 4 * warp))
    assert s.smem_bytes + _build.STATIC_SMEM_RESERVE <= limit
    # a hub row past shared memory: only it needs the scratch slice
    s = _build.symbolic_shape(limit, warp, 800_000, 916, 3, 80_000)
    assert 0 < s.smem_keys < 800_000
    assert s.slice_bytes == _build.align16(4 * 800_000)
    assert s.smem_bytes + _build.STATIC_SMEM_RESERVE <= limit
    # a table too big for shared memory: table and keys in the slice
    s = _build.symbolic_shape(limit, 0, 90_000, 60_000, 2, 5_000)
    assert s.smem_keys == -1
    assert s.slice_bytes == _build.align16(2 * _build.align16(4 * 60_001)
                                           + 4 * 90_000)


def test_symbolic_shape_cuts_the_long_blocks_to_the_scratch_budget():
    s = _build.symbolic_shape(SMEM_LIMITS[0], 0, 10_000_000, 64, 300, 10**7)
    assert s.long_blocks * s.slice_bytes <= _build.SCRATCH_BYTES
    assert 1 <= s.long_blocks < 300


# --------------------------------------------------------------------------- #
# The plan-table cache
# --------------------------------------------------------------------------- #
def test_plan_tables_are_built_once_per_plan_and_device():
    _, _, _, tplan, _ = _case(_MINI["mini_pl"])
    first = tpred.plan_tables(tplan, "cpu")
    assert tpred.plan_tables(tplan, torch.device("cpu")) is first


def test_plan_tables_never_serve_another_plans_tables():
    """Two live plans get their own tables; a plan built after another died
    — even where it reuses the dead one's id — gets its own, and the dead
    plan's entry goes with it."""
    _, _, _, p1, _ = _case(_MINI["mini_pl"])
    _, _, _, p2, _ = _case(_MINI["mini_rmat"])
    t1, t2 = tpred.plan_tables(p1, "cpu"), tpred.plan_tables(p2, "cpu")
    np.testing.assert_array_equal(t1.flop.row_bucket.numpy(), p1.row_bucket)
    np.testing.assert_array_equal(t2.flop.row_bucket.numpy(), p2.row_bucket)
    for _ in range(20):
        key = id(p1)
        del p1, t1
        gc.collect()
        assert key not in tpred._PLAN_TABLES
        _, _, _, p1, _ = _case(_MINI["mini_band"], route="spa")
        t1 = tpred.plan_tables(p1, "cpu")
        np.testing.assert_array_equal(t1.flop.row_bucket.numpy(),
                                      p1.row_bucket)
        assert t1.esc.tolist() == [False] * len(p1.buckets)


def test_equal_plans_do_not_share_tables():
    """Plans are compared by identity, not by value: an equal copy has its
    own entry."""
    import dataclasses
    _, _, _, p1, _ = _case(_MINI["mini_er"])
    p2 = dataclasses.replace(p1)
    assert tpred.plan_tables(p1, "cpu") is not tpred.plan_tables(p2, "cpu")


# --------------------------------------------------------------------------- #
# Wrappers off the CPU
# --------------------------------------------------------------------------- #
def test_one_launch_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor that lies neither on the CPU nor on a CUDA card gets no
    plain fallback: the one-launch wrappers raise."""
    _, td, _, tplan, rows = _case(_MINI["mini_pl"])
    meta = lambda d: type(d)(rpt=d.rpt.to("meta"), col=d.col.to("meta"),
                             val=d.val.to("meta"), shape=d.shape)
    md = meta(td)
    tabs = tpred.plan_tables(tplan, "meta")
    with pytest.raises(RuntimeError):
        tflop_k.flop_rows_buckets(md, torch.diff(md.rpt), tabs.flop)
    with pytest.raises(RuntimeError):
        tops.flop_rows_buckets(md, md, tabs.flop)
    table = tsym_k.sample_table(rows, np.full(rows.size, 4),
                                np.full(rows.size, 4), np.full(rows.size, 9),
                                "meta")
    with pytest.raises(RuntimeError):
        tsym_k.fused_flop_symbolic_buckets(md, md, table)
    with pytest.raises(RuntimeError):
        tops.fused_flop_symbolic_buckets(md, md, table)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    _, td, _, tplan, rows = _case(_MINI["mini_rmat"])
    counters = (tflop_k.flop_rows_buckets, tsym_k.fused_flop_symbolic_buckets,
                tflop_k.flop_rows, tsym_k.fused_flop_symbolic)
    before = [k.launches for k in counters]
    tpred.proposed_predict_binned(td, td, torch.from_numpy(rows), tplan,
                                  use_kernel=True)
    assert [k.launches for k in counters] == before
