"""The binned predictor's one launch of the bitmask symbolic kernel
(kernel 4, ``fused_flop_symbolic_bitmask_buckets``) on the CPU.

Its plain version — what the wrapper runs on CPU tensors — is held against
the JAX package's per-bucket Pallas kernels in interpret mode
(``fused_flop_symbolic_bitmask_pallas`` and ``bitmask_symbolic_pallas``,
summed over the SPA and BIN buckets), and ``binned_symbolic_counts(
use_kernel=True)`` against JAX's binned predictor.  The host-side table
(order, long/short split, each sample's mask words and output slot) and the
launch's sizing are pinned here too.  The kernel itself runs only on a card
(tests/test_torch_cuda.py).  Every integer is held exactly."""
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
from repro_torch.kernels import accumulator as tacc_k
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

FAMILIES = ("mini_er", "mini_pl", "mini_rmat", "mini_band", "mini_fem")
_MINI = dict(jsuite.mini_suite(scale=200))
# opt-in shared memory a block: H100 (227 KB) and the 48 KB default
SMEM_LIMITS = (232_448, 49_152)


def _case(jm, route, rows=None, samples=40, seed=0):
    """JAX and port operands, the JAX bucket plan carried across, and
    explicit sample rows (with replacement)."""
    cap = max(1, tbinning.ceil_pow2(jm.nnz))
    jd = jcsr.to_device(jm, capacity=cap)
    td = convert.csr_device_from_numpy(np.asarray(jd.rpt), np.asarray(jd.col),
                                       np.asarray(jd.val), jd.shape,
                                       device="cpu")
    jplan = jbinning.build_plan(jm, jm, route=route)
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


def _assert_one_launch_matches_jax(jm, route, rows=None, binned=True):
    """The one-launch entry's plain version over the SPA and BIN samples
    equals JAX's fused and unfused bitmask Pallas kernels summed bucket by
    bucket, its FLOP per sample equals floprC at the samples in the
    caller's order, and (with ``binned``) the whole binned count equals
    JAX's binned predictor's.  Returns the port's plan, tables, rows and
    the table (None without SPA or BIN samples)."""
    jd, td, jplan, tplan, rows = _case(jm, route, rows=rows)
    tabs = tpred.plan_tables(tplan, "cpu")
    floprc = tpred._binned_floprc(td, td, tplan).numpy()
    table = tpred.bitmask_sample_table(tplan, tabs, rows, floprc[rows],
                                       jm.ncols, "cpu")
    on_bitmask = ~tabs.esc[tplan.row_bucket[rows]]
    if binned:
        zj, fj = jpred.binned_symbolic_counts(jd, jd, jnp.asarray(rows),
                                              jplan, use_kernel=True)
        zt, ft = tpred.binned_symbolic_counts(
            td, td, torch.from_numpy(rows), tplan, use_kernel=True,
            floprc=torch.from_numpy(floprc))
        assert zt.dtype == torch.int32 and ft.dtype == torch.int32
        assert (int(zt), int(ft)) == (int(zj), int(fj))
        if rows.size:
            host = _host(jm)
            assert int(zj) == toracle.exact_sampled_nnz(host, host, rows)
    if table is None:
        assert not on_bitmask.any()
        return tplan, tabs, rows, None
    z, f, flop = tacc_k.fused_flop_symbolic_bitmask_buckets(td, td, table)
    assert z.dtype == f.dtype == flop.dtype == torch.int32
    assert flop.shape == (int(on_bitmask.sum()),)
    np.testing.assert_array_equal(flop.numpy(), floprc[rows[on_bitmask]])
    zb = fb = 0
    for bk, sub in zip(jplan.buckets, jplan.subset(rows)):
        if sub.size and bk.route != "esc":
            zs, fs, fl = jops.fused_flop_symbolic_routed(
                jd, jd, jnp.asarray(sub), max_deg_a=bk.deg_a,
                max_deg_b=bk.deg_b, route=bk.route, span=bk.span)
            zu, fu = jops.bitmask_symbolic(jd, jd, jnp.asarray(sub),
                                           bk.deg_a, bk.deg_b, span=bk.span)
            assert (int(zu), int(fu)) == (int(zs), int(fs))
            np.testing.assert_array_equal(np.asarray(fl), floprc[sub])
            zb, fb = zb + int(zs), fb + int(fs)
    assert (int(z), int(f)) == (zb, fb)
    return tplan, tabs, rows, table


@pytest.mark.parametrize("route", ["spa", "bin", "auto"])
@pytest.mark.parametrize("family", FAMILIES)
def test_one_launch_plain_version_matches_jax(family, route):
    _assert_one_launch_matches_jax(_MINI[family], route)


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


@pytest.mark.parametrize("n_words", [1, 2, 0])
def test_a_span_narrower_than_the_extent_drops_the_columns_past_it(n_words):
    """A row's mask of ``n_words`` words (0: B's columns) counts only the
    columns whose relative lane lies below ``32·n_words``, as JAX's
    ``span`` does; the wide band makes every row's extent pass one and two
    words."""
    jm = jrand.banded(96, 96, 6, 40, seed=31)
    jd, td, _, _, rows = _case(jm, "spa", samples=24, seed=5)
    da = db = int(np.diff(jm.rpt).max())
    span = 32 * n_words
    zj, fj, flj = jops.fused_flop_symbolic_routed(
        jd, jd, jnp.asarray(rows), max_deg_a=da, max_deg_b=db, route="spa",
        span=span)
    flop = tacc_k.flop_rows_plain(td, torch.diff(td.rpt),
                                  torch.from_numpy(rows), max_deg_a=da)
    nw = tacc_k._n_words(jm.ncols, span)
    table = tacc_k.bitmask_table(rows, np.full(rows.size, da),
                                 np.full(rows.size, db),
                                 np.full(rows.size, nw), flop.numpy(), "cpu")
    z, f, fl = tacc_k.fused_flop_symbolic_bitmask_buckets(td, td, table)
    assert (int(z), int(f)) == (int(zj), int(fj))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(flj))
    exact = toracle.exact_sampled_nnz(_host(jm), _host(jm),
                                      rows.astype(np.int64))
    assert (int(z) < exact) == (n_words > 0)


@pytest.mark.parametrize("route", ["spa", "bin"])
def test_duplicate_sampled_rows_count_each_time(route):
    jm = _MINI["mini_pl"]
    hub = int(np.argmax(np.diff(jm.rpt)))
    rows = np.array([hub, hub, 3, 3, 3, hub, 7])
    _, _, rows, table = _assert_one_launch_matches_jax(jm, route, rows=rows)
    # every sample has its own slot, duplicates included
    assert sorted(table.samples[4].tolist()) == list(range(rows.size))


@pytest.mark.parametrize("route", ["spa", "bin"])
def test_samples_only_on_empty_rows(route):
    jm = _with_empty_rows()
    tplan, _, rows, table = _assert_one_launch_matches_jax(
        jm, route, rows=np.arange(0, 40, 3))
    td = convert.csr_device_from_numpy(jm.rpt, jm.col, jm.val, jm.shape,
                                       device="cpu")
    z, f, flop = tacc_k.fused_flop_symbolic_bitmask_buckets(td, td, table)
    assert (int(z), int(f)) == (0, 0) and not bool(flop.any())
    assert table.n_long == 0


@pytest.mark.parametrize("route", ["spa", "bin"])
def test_all_zero_a(route):
    b = jrand.erdos_renyi(60, 60, 3, seed=23)
    zero = JCSR(rpt=np.zeros(61, dtype=b.rpt.dtype),
                col=np.zeros(0, dtype=b.col.dtype),
                val=np.zeros(0, dtype=np.float32), shape=(60, 60))
    _, _, _, table = _assert_one_launch_matches_jax(
        zero, route, rows=np.array([0, 5, 5, 59]))
    assert table.n_long == 0 and table.samples.shape == (5, 4)


def test_a_plan_with_no_spa_or_bin_sample_has_no_table():
    """An all-ESC plan, and an auto plan sampled only in its ESC buckets:
    no bitmask table, and the binned counts still equal JAX's."""
    jm = _MINI["mini_rmat"]
    _, _, _, table = _assert_one_launch_matches_jax(jm, "esc")
    assert table is None
    _, _, _, tplan, _ = _case(jm, "auto")
    esc_rows = np.concatenate([b.rows for b in tplan.buckets
                               if b.route == "esc"])
    assert esc_rows.size
    _, _, _, table = _assert_one_launch_matches_jax(jm, "auto",
                                                    rows=esc_rows[:9])
    assert table is None


# --------------------------------------------------------------------------- #
# Host-side tables and sizing
# --------------------------------------------------------------------------- #
def test_bitmask_table_orders_long_rows_first_and_keeps_each_slot():
    """Rows whose products (FLOP capped by the bucket's DA·DB) pass a
    warp's BMS_WARP_MAX go first, each to a block; the rest keep their
    order; each sample keeps its mask words, and its slot puts it back in
    the caller's order."""
    rows = np.array([5, 9, 2, 9, 7])
    deg_a = np.array([4, 40, 2, 40, 30])
    deg_b = np.array([4, 30, 3, 30, 30])
    n_words = np.array([1, 7, 2, 7, 3])
    flop = np.array([10, 900, 500, 900, 257])
    t = tacc_k.bitmask_table(rows, deg_a, deg_b, n_words, flop, "cpu")
    assert _build.BMS_WARP_MAX == 256
    # row 2's 500 FLOP is capped at its bucket's 2·3 products
    assert (t.n_long, t.words, t.max_deg_a) == (3, 7, 40)
    s, da, db, nw, out = t.samples.tolist()
    assert s == [9, 9, 7, 5, 2] and out == [1, 3, 4, 0, 2]
    assert da == [40, 40, 30, 4, 2] and db == [30, 30, 30, 4, 3]
    assert nw == [7, 7, 3, 1, 2]
    assert t.samples.dtype == torch.int32 and t.samples.is_contiguous()
    empty = tacc_k.bitmask_table([], [], [], [], [], "cpu")
    assert empty.samples.shape == (5, 0) and empty.n_long == 0


@pytest.mark.parametrize("family", FAMILIES)
def test_bitmask_sample_table_takes_each_buckets_bounds_and_words(family):
    """The prediction's table holds exactly its SPA and BIN samples, each
    at its bucket's deg_a, deg_b and ceil(min(span, ncols)/32) words, the
    long ones those past BMS_WARP_MAX products."""
    jm = _MINI[family]
    _, td, _, tplan, rows = _case(jm, "bin", samples=60, seed=4)
    tabs = tpred.plan_tables(tplan, "cpu")
    assert tabs.span.tolist() == [b.span for b in tplan.buckets]
    floprc = tpred._binned_floprc(td, td, tplan).numpy()
    table = tpred.bitmask_sample_table(tplan, tabs, rows, floprc[rows],
                                       jm.ncols, "cpu")
    s, da, db, nw, out = table.samples.numpy()
    np.testing.assert_array_equal(s, rows[out])
    for i, r in enumerate(s):
        bk = tplan.buckets[tplan.row_bucket[r]]
        lanes = min(bk.span, jm.ncols) if bk.span else jm.ncols
        assert (da[i], db[i], nw[i]) == (bk.deg_a, bk.deg_b, -(-lanes // 32))
    bound = np.minimum(floprc[s], da.astype(np.int64) * db)
    long = bound > _build.BMS_WARP_MAX
    assert table.n_long == int(long.sum()) and long[:table.n_long].all()


@pytest.mark.parametrize("source, macro, value", [
    ("bitmask_symbolic", "BMS_WARPS", _build.BMS_WARPS),
    ("bitmask_symbolic", "BMS_WARP_MAX", _build.BMS_WARP_MAX),
    ("bitmask_symbolic", "BMS_WARP_WORDS", _build.BMS_WARP_WORDS)])
def test_launch_constants_are_read_from_the_kernel_source(source, macro,
                                                          value):
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert f"#define {macro} {value} " in text


@pytest.mark.parametrize("limit", SMEM_LIMITS)
def test_bitmask_shape_puts_each_workspace_where_it_fits(limit):
    warp = _build.BMS_WARPS * (256 + 4 * _build.BMS_WARP_WORDS)
    # groups of rows only: the warps' shared memory, or a handed-back row's
    # table and mask where those take more
    table = 2 * _build.align16(4 * 17)
    s = _build.bitmask_shape(limit, 0, 19, 3, 16)
    assert s == (3, max(warp, table + 12), 0, 0, 19)
    # long rows whose words fit beside their table
    s = _build.bitmask_shape(limit, 7, 0, 4096, 916)
    table = 2 * _build.align16(4 * 917)
    assert (s.smem_words, s.slice_bytes, s.long_blocks, s.group_blocks) \
        == (4096, 0, 7, 0)
    assert s.smem_bytes == table + 4 * 4096
    assert s.smem_bytes + _build.STATIC_SMEM_RESERVE <= limit
    # 4 M columns: the words pass shared memory, each block gets a slice
    s = _build.bitmask_shape(limit, 6, 100, 125_000, 300)
    assert 0 < s.smem_words < 125_000
    assert s.slice_bytes == _build.align16(4 * 125_000)
    assert (s.long_blocks, s.group_blocks) == (6, 100)
    assert max(warp, s.smem_bytes) + _build.STATIC_SMEM_RESERVE <= limit
    # a table too big for shared memory: table and mask in the slice, and
    # the blocks cut so that scratch stays within SCRATCH_BYTES
    s = _build.bitmask_shape(limit, 5000, 300, 1 << 20, 60_000)
    assert s.smem_words == -1 and s.smem_bytes == warp
    assert s.slice_bytes == 2 * _build.align16(4 * 60_001) + 4 * (1 << 20)
    cap = _build.SCRATCH_BYTES // s.slice_bytes
    assert s.group_blocks == cap // 2 and s.long_blocks == cap - cap // 2
