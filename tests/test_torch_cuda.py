"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode).  The module imports no JAX, so it also runs where
only the port is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import binning, csr, oracle, plan, predictor, spgemm
from repro_torch.core import flop as flop_mod
from repro_torch.kernels import _build
from repro_torch.kernels import accumulator as acc_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import flop_per_row as flop_k
from repro_torch.kernels import spgemm_numeric as num_k
from repro_torch.kernels import spgemm_symbolic as sym_k
from repro_torch.sparse import random as sprand
from repro_torch.sparse import suite
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

VAL_RTOL = 1e-5      # run sums are taken in another order
VAL_ATOL_REL = 1e-6  # × the row's largest |value|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _valued(m, seed):
    m.val[:] = np.random.default_rng(seed).standard_normal(m.nnz).astype(
        np.float32)
    return m


def _assert_numeric_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert int(got[3]) == int(want[3])
    vmax = want[1].abs().amax(dim=1, keepdim=True)
    assert bool(((got[1] - want[1]).abs()
                 <= VAL_RTOL * want[1].abs() + VAL_ATOL_REL * vmax).all())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
@pytest.mark.parametrize("alpha", [1.2, 1.6])
def test_kernels_match_plain_versions_on_every_bucket(card, alpha, route):
    """Hub buckets reach 2^21 product lanes, past shared memory: both the
    shared-memory and the global-scratch workspace paths of the ESC kernels
    run.  On SPA and BIN buckets the bitmask kernel also equals the ESC
    symbolic kernel on the same rows, and the numeric kernels' col, row_nnz
    and overflow equal ESC's."""
    m = _valued(sprand.power_law(3000, 3000, 40, alpha, seed=5), 6)
    bp = binning.build_plan(m, m, route=route)
    ad = csr.to_device(m, device=card)
    rnb = torch.diff(ad.rpt)
    sample = np.random.default_rng(0).integers(0, m.nrows, 300)
    for bk, sub in zip(bp.buckets, bp.subset(sample)):
        rows = torch.from_numpy(bk.rows).to(card)
        kw = dict(a=ad, rownnz_b=rnb, rows=rows, max_deg_a=bk.deg_a)
        assert torch.equal(flop_k.flop_rows(**kw),
                           flop_k.flop_rows_plain(**kw))
        if sub.size:
            kw = dict(a=ad, b=ad, rows=torch.from_numpy(sub).to(card),
                      max_deg_a=bk.deg_a, max_deg_b=bk.deg_b)
            got = sym_k.fused_flop_symbolic(**kw)
            want = sym_k.fused_flop_symbolic_plain(**kw)
            assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
            assert torch.equal(got[2], want[2])
            if route != "esc":
                kw["span"] = bk.span
                bits = acc_k.fused_flop_symbolic_bitmask(**kw)
                plain = acc_k.fused_flop_symbolic_bitmask_plain(**kw)
                for x in (got, plain):
                    assert (int(bits[0]), int(bits[1])) == (int(x[0]),
                                                            int(x[1]))
                    assert torch.equal(bits[2], x[2])
        kw = dict(a=ad, b=ad, rows=rows, max_deg_a=bk.deg_a,
                  max_deg_b=bk.deg_b, row_capacity=64)
        esc = num_k.spgemm_numeric(**kw)
        _assert_numeric_equal(esc, num_k.spgemm_numeric_plain(**kw))
        if route != "esc":
            kernel, plain = ((acc_k.spa_numeric, acc_k.spa_numeric_plain)
                             if route == "spa" else
                             (acc_k.bin_numeric, acc_k.bin_numeric_plain))
            kw.update(tile_n=bk.tile_n, n_tiles=bk.n_tiles)
            got = kernel(**kw)
            _assert_numeric_equal(got, plain(**kw))
            _assert_numeric_equal(got, esc)


def _one_launch_checks(ad, bd, bp, sample, card):
    """Kernels 1 and 2's one-launch entries against their plain versions
    and against the per-bucket kernels on every bucket of ``bp``; kernel
    2's table takes every sampled row, whatever its bucket's route."""
    rnb = torch.diff(bd.rpt)
    tabs = predictor.plan_tables(bp, card)
    floprc = flop_k.flop_rows_buckets(ad, rnb, tabs.flop)
    assert torch.equal(floprc, flop_k.flop_rows_buckets_plain(ad, rnb,
                                                              tabs.flop))
    per_bucket = torch.zeros_like(floprc)
    z_b = f_b = 0
    for bk, sub in zip(bp.buckets, bp.subset(sample)):
        rows = torch.from_numpy(bk.rows).to(card)
        per_bucket[rows.long()] = flop_k.flop_rows(ad, rnb, rows,
                                                   max_deg_a=bk.deg_a)
        if sub.size:
            got = sym_k.fused_flop_symbolic(
                ad, bd, torch.from_numpy(sub).to(card), max_deg_a=bk.deg_a,
                max_deg_b=bk.deg_b, rownnz_b=rnb)
            z_b, f_b = z_b + int(got[0]), f_b + int(got[1])
    assert torch.equal(floprc, per_bucket)
    bk = bp.row_bucket[sample]
    deg_a = np.array([b.deg_a for b in bp.buckets])[bk]
    deg_b = np.array([b.deg_b for b in bp.buckets])[bk]
    table = sym_k.sample_table(sample, deg_a, deg_b,
                               floprc.cpu().numpy()[sample], card)
    got = sym_k.fused_flop_symbolic_buckets(ad, bd, table, rownnz_b=rnb)
    want = sym_k.fused_flop_symbolic_buckets_plain(ad, bd, table,
                                                   rownnz_b=rnb)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1])) \
        == (z_b, f_b)
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[2], floprc[torch.from_numpy(sample).to(card)
                                      .long()])
    return table


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
@pytest.mark.parametrize("alpha", [1.2, 1.6])
def test_one_launch_entries_match_plain_and_per_bucket(card, alpha, route):
    """The one-launch FLOP and fused ESC symbolic entries equal their plain
    versions and the per-bucket kernels, bucket by bucket, on the matrices
    of the per-bucket check above; hub rows make long rows (a block each,
    counted by bitmask), beside short ones (a warp each) at alpha 1.2."""
    m = _valued(sprand.power_law(3000, 3000, 40, alpha, seed=5), 6)
    bp = binning.build_plan(m, m, route=route)
    sample = np.random.default_rng(0).integers(0, m.nrows, 300)
    ad = csr.to_device(m, device=card)
    table = _one_launch_checks(ad, ad, bp, sample, card)
    assert table.n_long > 0 and (alpha > 1.5 or table.n_long < 300)


def _long_row_operands():
    """A (600 × 900) and B (900 × 4,000,000) whose first three A rows are
    long: row 0 reads 300 B rows of 300 columns spread over B's 4 M columns
    (90,000 products: too many keys and too wide an extent for shared
    memory), row 1 reads 300 B rows whose columns all lie in the first
    20,000 (90,000 products in a narrow extent), row 2 reads 40 B rows, 30
    of them wide (12,000 products, a wide extent); the other A rows read 1
    to 4 B rows of 1 to 40 columns."""
    rng = np.random.default_rng(84)
    ncols = 4_000_000
    b_rows = ([np.sort(rng.choice(ncols, 300, replace=False))
               for _ in range(300)]
              + [np.sort(rng.choice(20_000, 300, replace=False))
                 for _ in range(300)]
              + [np.sort(rng.choice(ncols, rng.integers(1, 41),
                                    replace=False)) for _ in range(300)])
    a_rows = [np.arange(300), np.arange(300, 600), np.arange(0, 400, 10)]
    a_rows += [np.sort(rng.choice(np.arange(600, 900), rng.integers(1, 5),
                                  replace=False)) for _ in range(597)]

    def host(rows, shape):
        rpt = np.concatenate([[0], np.cumsum([r.size for r in rows])])
        col = np.concatenate(rows).astype(np.int32)
        return CSR(rpt=rpt.astype(np.int64), col=col,
                   val=np.ones(col.size, dtype=np.float32), shape=shape)
    return host(a_rows, (600, 900)), host(b_rows, (900, ncols))


@pytest.mark.cuda
def test_fused_symbolic_long_rows_by_bitmask_smem_and_scratch(card):
    """Each way a long row counts: by bitmask (a narrow extent), by a sort
    in shared memory (its keys fit) and by a sort in a scratch slice (they
    do not), beside short rows and with duplicates, against the plain
    version, the per-bucket kernels and the host oracle."""
    a, b = _long_row_operands()
    bp = binning.build_plan(a, b, route="esc")
    sample = np.concatenate([[0, 1, 2, 0], np.random.default_rng(85).integers(
        0, a.nrows, 200), [1]])
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    table = _one_launch_checks(ad, bd, bp, sample, card)
    shape = _build.symbolic_shape(
        _build.max_smem("esc_symbolic", card), table.short_bound,
        table.long_bound, table.max_deg_a_long, table.n_long, b.ncols)
    assert table.n_long == 6 and table.long_bound == 90_000
    assert 12_000 <= shape.smem_keys < 90_000 and shape.slice_bytes
    got = sym_k.fused_flop_symbolic_buckets(ad, bd, table)
    assert int(got[0]) == oracle.exact_sampled_nnz(a, b, sample)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 300])
def test_fused_symbolic_rows_past_their_flop_bound(card, cap):
    """A FLOP below a row's products sizes its workspace too small: the
    row still counts exactly, in the spill bitmask.  With a FLOP of 1 every
    row is short and each warp that overflows spills; capped at 300, the
    hub rows are long, and row 0 (90,000 products over 4 M columns) fits
    neither the block's bitmask, its keys nor its slice."""
    a, b = _long_row_operands()
    bp = binning.build_plan(a, b, route="esc")
    sample = np.concatenate([[0, 1, 2, 0], np.random.default_rng(85).integers(
        0, a.nrows, 200), [1]])
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    rnb = torch.diff(bd.rpt)
    flop = flop_k.flop_rows_buckets(
        ad, rnb, predictor.plan_tables(bp, card).flop).cpu().numpy()[sample]
    bk = bp.row_bucket[sample]
    table = sym_k.sample_table(
        sample, np.array([x.deg_a for x in bp.buckets])[bk],
        np.array([x.deg_b for x in bp.buckets])[bk],
        np.minimum(flop, cap), card)
    shape = _build.symbolic_shape(
        _build.max_smem("esc_symbolic", card), table.short_bound,
        table.long_bound, table.max_deg_a_long, table.n_long, b.ncols)
    if cap == 1:
        assert table.n_long == 0 and shape.warp_keys == 1
    else:
        # row 0's 90,000 keys and 125,000-word extent pass every workspace
        assert table.n_long == 6 and table.long_bound == 300
        assert shape.smem_keys < 90_000 and shape.slice_bytes < 4 * 90_000
    got = sym_k.fused_flop_symbolic_buckets(ad, bd, table, rownnz_b=rnb)
    want = sym_k.fused_flop_symbolic_buckets_plain(ad, bd, table,
                                                   rownnz_b=rnb)
    assert int(got[0]) == int(want[0]) == oracle.exact_sampled_nnz(a, b,
                                                                   sample)
    assert int(got[1]) == int(want[1]) and torch.equal(got[2], want[2])
    assert np.array_equal(got[2].cpu().numpy(), flop)
    # the spill is left zeroed: a second launch counts the same
    assert int(sym_k.fused_flop_symbolic_buckets(ad, bd, table)[0]) \
        == int(want[0])


@pytest.mark.cuda
def test_accumulator_kernels_on_a_wide_column_space(card):
    """Two million columns: the bitmask (62,500 words) outgrows shared
    memory and runs in global scratch, SPA walks up to 128 tiles of 16,384
    lanes a row, BIN scatters into 8,192 bins."""
    a = _valued(sprand.erdos_renyi(400, 500, 6, seed=21), 22)
    b = _valued(sprand.erdos_renyi(500, 2_000_000, 6, seed=23), 24)
    ad = csr.to_device(a, device=card)
    bd = csr.to_device(b, device=card)
    rows = torch.arange(a.nrows, dtype=torch.int32, device=card)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    kw = dict(a=ad, b=bd, rows=rows, max_deg_a=da, max_deg_b=db)
    bits = acc_k.fused_flop_symbolic_bitmask(**kw)
    for want in (acc_k.fused_flop_symbolic_bitmask_plain(**kw),
                 sym_k.fused_flop_symbolic(**kw)):
        assert (int(bits[0]), int(bits[1])) == (int(want[0]), int(want[1]))
        assert torch.equal(bits[2], want[2])
    kw["row_capacity"] = 24
    esc = num_k.spgemm_numeric(**kw)
    for kernel, plain, tiling in (
            (acc_k.spa_numeric, acc_k.spa_numeric_plain, binning.spa_tile),
            (acc_k.bin_numeric, acc_k.bin_numeric_plain, binning.bin_tile)):
        tile_n, n_tiles = tiling(b.ncols, binning.DEFAULT_LANE_BUDGET)
        got = kernel(**kw, tile_n=tile_n, n_tiles=n_tiles)
        _assert_numeric_equal(got, plain(**kw, tile_n=tile_n,
                                         n_tiles=n_tiles))
        _assert_numeric_equal(got, esc)


@pytest.mark.cuda
def test_auto_route_plan_has_the_esc_plan_structure(card):
    """Routes change no bucket, prediction or capacity, so an auto-routed
    plan's output has the ESC plan's col, row_nnz and overflow exactly."""
    m = _valued(sprand.banded(4000, 4000, 24, 12, seed=31), 32)
    rows = np.random.default_rng(3).integers(0, m.nrows, 80)
    outs = []
    for route in ("auto", "esc"):
        p = plan.plan_spgemm(m, m, route=route, use_kernel=True,
                             sample_rows=rows, device=card)
        assert (route == "esc") == (p.binning.route_rows()["spa"] == 0)
        outs.append(plan.execute(p, m, m))
    _assert_numeric_equal(outs[0], outs[1])


@pytest.mark.cuda
def test_plan_on_the_card_matches_the_plan_on_the_host(card):
    m = _valued(sprand.rmat(2000, 2000, 16000, seed=13), 7)
    rows = np.random.default_rng(1).integers(0, m.nrows, 60)
    outs = []
    for dev, use_kernel in ((card, True), ("cpu", False)):
        p = plan.plan_spgemm(m, m, route="esc", use_kernel=use_kernel,
                             sample_rows=rows, device=dev)
        outs.append(plan.execute(p, m, m))
    got, want = outs
    assert torch.equal(got.col.cpu(), want.col)
    assert torch.equal(got.row_nnz.cpu(), want.row_nnz)
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_allclose(got.val.cpu().numpy(), want.val.numpy(),
                               rtol=VAL_RTOL, atol=1e-5)


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches_only(card):
    m = sprand.erdos_renyi(500, 500, 4, seed=3)
    ad = csr.to_device(m, device=card)
    rows = torch.arange(100, dtype=torch.int32, device=card)
    before = num_k.spgemm_numeric.launches
    num_k.spgemm_numeric_plain(ad, ad, rows, max_deg_a=16, max_deg_b=16,
                               row_capacity=32)
    assert num_k.spgemm_numeric.launches == before
    num_k.spgemm_numeric(ad, ad, rows, max_deg_a=16, max_deg_b=16,
                         row_capacity=32)
    assert num_k.spgemm_numeric.launches == before + 1


def _global_pad_checks(ad, bd, rows, da, db):
    """Kernels 7 and 8 against their plain versions on ``rows``, with and
    without the workspace hint, and kernel 7's z* against the fused ESC
    kernel's on the same rows (f* too when B's rows are read whole).  A
    hint of 1 a row sends every row to a warp that it outgrows (each
    counts in the spill bitmask); a huge one sends every row to a block."""
    rnb = torch.diff(bd.rpt)
    kw = dict(a=ad, b=bd, rows=rows, max_deg_a=da, max_deg_b=db)
    want = sym_k.sampled_symbolic_plain(**kw)
    hint = flop_k.flop_rows(ad, rnb, rows, max_deg_a=da)
    for row_flop in (None, hint, torch.ones_like(hint),
                     torch.full_like(hint, 1 << 30)):
        got = sym_k.sampled_symbolic(**kw, row_flop=row_flop)
        assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    esc = sym_k.fused_flop_symbolic(**kw)
    assert int(esc[0]) == int(want[0])
    if db >= int(rnb.max()):
        assert int(esc[1]) == int(want[1])
    bits = acc_k.bitmask_symbolic(**kw)
    plain = acc_k.bitmask_symbolic_plain(**kw)
    assert (int(bits[0]), int(bits[1])) == (int(plain[0]), int(plain[1]))
    assert int(bits[0]) == int(want[0]) and int(bits[1]) == int(hint.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("trunc", [False, True])
def test_global_pad_kernels_match_plain_versions(card, trunc):
    """Kernels 7 and 8 at global bounds over 300 sampled rows and the
    eight widest rows of a power-law square: the hub rows (over 32,768
    products) sort in global scratch while the rest sort in shared memory;
    with ``trunc`` B's rows are read to fewer entries than its widest
    has."""
    m = sprand.power_law(3000, 3000, 40, 1.2, seed=5)
    ad = csr.to_device(m, device=card)
    da = int(m.row_nnz.max())
    sample = np.concatenate([
        np.random.default_rng(4).integers(0, m.nrows, 300),
        np.argsort(m.row_nnz)[-8:]]).astype(np.int32)
    rows = torch.from_numpy(sample).to(card)
    _global_pad_checks(ad, ad, rows, da, da // 2 if trunc else da)


@pytest.mark.cuda
def test_sampled_symbolic_long_rows_count_in_their_scratch_slices(card):
    """Kernel 7 at global bounds over B's 4 M columns: a long row's bitmask
    of B's columns (125,000 words) does not fit shared memory, so each long
    row's block counts it by presence bits in its own scratch slice — row
    0's 90,000 products over the whole extent too — beside short rows and
    duplicates."""
    a, b = _long_row_operands()
    sample = np.concatenate([[0, 1, 2, 0], np.random.default_rng(85).integers(
        0, a.nrows, 200), [1]]).astype(np.int32)
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    words = -(-b.ncols // 32)
    shape = _build.symbolic_shape(
        _build.max_smem("esc_symbolic", card), _build.SYM_WARP_MAX, words,
        da, sample.size, b.ncols)
    assert 0 <= shape.smem_keys < words
    assert shape.slice_bytes == _build.align16(4 * words)
    rows = torch.from_numpy(sample).to(card)
    kw = dict(a=ad, b=bd, rows=rows, max_deg_a=da, max_deg_b=db)
    want = sym_k.sampled_symbolic_plain(**kw)
    assert int(want[0]) == oracle.exact_sampled_nnz(a, b, sample)
    hint = flop_k.flop_rows(ad, torch.diff(bd.rpt), rows, max_deg_a=da)
    for row_flop in (None, hint, torch.full_like(hint, 1 << 30)):
        got = sym_k.sampled_symbolic(**kw, row_flop=row_flop)
        assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))


@pytest.mark.cuda
def test_sampled_symbolic_with_its_prefix_in_scratch(card):
    """A row of 60,000 entries: its product prefix alone outgrows shared
    memory, so prefix and keys both live in the block's scratch slice."""
    a = sprand.erdos_renyi(8, 100_000, 3, seed=41)
    dense = np.sort(np.random.default_rng(42).choice(100_000, 60_000,
                                                     replace=False))
    rpt = np.concatenate([[0, dense.size], dense.size + a.rpt[1:]])
    a = type(a)(rpt=rpt.astype(a.rpt.dtype),
                col=np.concatenate([dense, a.col]).astype(a.col.dtype),
                val=np.ones(dense.size + a.nnz, dtype=np.float32),
                shape=(9, 100_000))
    b = sprand.erdos_renyi(100_000, 5_000, 2, seed=43)
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    rows = torch.arange(9, dtype=torch.int32, device=card)
    _global_pad_checks(ad, bd, rows, int(a.row_nnz.max()),
                       int(b.row_nnz.max()))


@pytest.mark.cuda
def test_flop_per_row_kernel_matches_plain_version(card):
    """Thread-per-row (max_deg_a ≤ 16) and warp-per-row variants, and the
    JAX entry point's default of 128 on rows wider than that."""
    m = sprand.power_law(20_000, 20_000, 8, 1.3, seed=7)
    ad = csr.to_device(m, device=card)
    rnb = torch.diff(ad.rpt)
    for max_deg_a in (8, 16, 128, int(m.row_nnz.max())):
        got = flop_k.flop_per_row(ad, rnb, max_deg_a=max_deg_a)
        assert torch.equal(got, flop_k.flop_per_row_plain(
            ad, rnb, max_deg_a=max_deg_a))
    floprc, _ = flop_mod.flop_per_row(ad, ad)
    assert torch.equal(got, floprc)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["power_law", "banded"])
def test_global_pad_predictor_equals_the_binned_one(card, family):
    m = (sprand.power_law(5000, 5000, 6, 1.5, seed=9) if family == "power_law"
         else sprand.banded(5000, 5000, 24, 30, seed=9))
    ad = csr.to_device(m, device=card)
    da = int(m.row_nnz.max())
    rows = torch.from_numpy(np.random.default_rng(2).integers(
        0, m.nrows, 300).astype(np.int32)).to(card)
    before = (sym_k.sampled_symbolic.launches, flop_k.flop_per_row.launches)
    g = predictor.proposed_predict(ad, ad, rows, da, da, use_kernel=True)
    assert (sym_k.sampled_symbolic.launches, flop_k.flop_per_row.launches) \
        == (before[0] + 1, before[1] + 1)
    b = predictor.proposed_predict_binned(
        ad, ad, rows, binning.build_plan(m, m), use_kernel=True)
    for what in g._fields:
        assert torch.equal(getattr(g, what), getattr(b, what)), what


@pytest.mark.cuda
def test_global_spgemm_kernel_matches_plain_version(card):
    m = _valued(sprand.rmat(3000, 3000, 24_000, seed=17), 18)
    ad = csr.to_device(m, device=card)
    da = int(m.row_nnz.max())
    for cap in (16, 256):
        kw = dict(row_capacity=cap, max_deg_a=da, max_deg_b=da)
        _assert_numeric_equal(spgemm.spgemm(ad, ad, use_kernel=True, **kw),
                              spgemm.spgemm(ad, ad, **kw))


# B row lengths of the class-edge operands: each A row's product count is a
# sum of distinct B rows' lengths, at most 60 A entries a row
_EDGE_LENGTHS = (4096,) * 16 + (1024,) * 8 + (256,) * 8 + (32,) * 8 + (1,) * 64
_EDGE_DEG_A = 64


def _class_edge_operands(smem_pairs):
    """A and B whose A rows have 0, 1, 31, 32, 33, 1023, 1024, 1025, 8191,
    8192 and 8193 products, and just as many and one more than each of
    ``smem_pairs`` (the pairs a block's shared memory holds), plus a row
    that lists one A entry twice.  B's rows have random sorted columns of
    50,000, so output rows repeat columns across A entries."""
    rng = np.random.default_rng(61)
    ncols = 50_000
    b_rows = [np.sort(rng.choice(ncols, n, replace=False))
              for n in _EDGE_LENGTHS]
    targets = [0, 1, 31, 32, 33, 1023, 1024, 1025, 8191, 8192, 8193]
    targets += [n + d for n in smem_pairs for d in (0, 1)]
    a_rows = []
    for n in targets:
        picked, used = [], set()
        for k, length in enumerate(_EDGE_LENGTHS):
            if length <= n and k not in used:
                picked.append(k)
                used.add(k)
                n -= length
        assert n == 0
        a_rows.append(sorted(picked))
    a_rows.append(sorted([0, 0, 20, 30, 41]))     # entry 0 twice
    def csr(rows, shape):
        rpt = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        col = (np.concatenate(rows) if rows else np.zeros(0)).astype(np.int32)
        return CSR(rpt=rpt.astype(np.int64), col=col,
                   val=rng.standard_normal(col.size).astype(np.float32),
                   shape=shape)
    a = csr(a_rows, (len(a_rows), len(_EDGE_LENGTHS)))
    b = csr(b_rows, (len(_EDGE_LENGTHS), ncols))
    return a, b, targets


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [16, 1 << 16])
def test_numeric_kernels_at_their_class_edges(card, cap):
    """Rows on both sides of every class edge of kernels 3 and 6 (a warp's
    and a block's products, and each kernel's shared-memory limit), with room for
    every column and with capacity overflow inside most rows, against the
    plain versions: with the rows' true FLOP bound, without a bound, and
    with a bound far too small (rows past it run in the spill slice)."""
    limit = _build.max_smem("esc_numeric", card)
    tile_n, n_tiles = binning.bin_tile(50_000, binning.DEFAULT_LANE_BUDGET)
    big = 1 << 16
    a, b, targets = _class_edge_operands((
        _build.esc_numeric_shape(limit, _EDGE_DEG_A, big).launches[-1]
        .smem_pairs,
        _build.bin_numeric_shape(limit, _EDGE_DEG_A, big, tile_n, n_tiles)
        .launches[0].smem_pairs))
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    rows = torch.arange(a.nrows, dtype=torch.int32, device=card)
    kw = dict(a=ad, b=bd, rows=rows, max_deg_a=_EDGE_DEG_A,
              max_deg_b=max(_EDGE_LENGTHS), row_capacity=cap)
    want = num_k.spgemm_numeric_plain(**kw)
    assert all(z <= n for z, n in zip(want[2].tolist(), targets))
    want_bin = acc_k.bin_numeric_plain(**kw, tile_n=tile_n, n_tiles=n_tiles)
    for bound in (max(targets), None, 200):
        _assert_numeric_equal(num_k.spgemm_numeric(**kw, max_row_flop=bound),
                              want)
        _assert_numeric_equal(acc_k.bin_numeric(
            **kw, tile_n=tile_n, n_tiles=n_tiles, max_row_flop=bound),
            want_bin)


@pytest.mark.cuda
def test_same_keyed_plans_with_other_flop_share_one_executor(card):
    """A second plan with the first's key but rows of less FLOP runs through
    the first's cached executor: its kernels size by its own, too small,
    bounds, and rows past them still come out right."""
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=71), 72)
    sample = np.random.default_rng(7).integers(0, m.nrows, 200)
    p1 = plan.plan_spgemm(m, m, route="auto", use_kernel=True,
                          sample_rows=sample, device=card)
    p2 = dataclasses.replace(p1, flopr=p1.flopr // 4, _device_args=None,
                             _flop_bounds=None, _planned_pair=None)
    assert p2.key == p1.key and p2.flop_bounds() != p1.flop_bounds()
    want = plan.execute(plan.plan_spgemm(m, m, route="auto",
                                         sample_rows=sample, device=card),
                        m, m, cache=plan.PlanCache())
    cache = plan.PlanCache()
    for p in (p1, p2):
        _assert_numeric_equal(plan.execute(p, m, m, cache=cache), want)
    assert cache.stats()["traces"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "bin"])
def test_numeric_val_is_bitwise_equal_across_launches(card, route):
    """Kernels 3 and 6 add each row's products in a fixed order: two
    launches on the same rows give the same val, bit for bit."""
    m = _valued(sprand.power_law(3000, 3000, 40, 1.2, seed=5), 6)
    bp = binning.build_plan(m, m, route=route)
    ad = csr.to_device(m, device=card)
    floprc = oracle.flop_per_row(m, m)[0]
    for bk in bp.buckets:
        kw = dict(a=ad, b=ad, rows=torch.from_numpy(bk.rows).to(card),
                  max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, row_capacity=4096,
                  max_row_flop=int(floprc[bk.rows].max()))
        if route == "bin":
            kernel = acc_k.bin_numeric
            kw.update(tile_n=bk.tile_n, n_tiles=bk.n_tiles)
        else:
            kernel = num_k.spgemm_numeric
        first, second = kernel(**kw), kernel(**kw)
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])


def _assert_bitwise(got, again):
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])
    assert torch.equal(got[1].view(torch.int32), again[1].view(torch.int32))


def _spa_checks(a, b, rows, max_deg_a, max_deg_b, row_capacity, tile_n,
                n_tiles):
    """Kernel 5 twice, bit for bit, against its plain version; col, row_nnz
    and overflow also against the ESC kernel when the window covers every
    row's extent."""
    kw = dict(a=a, b=b, rows=rows, max_deg_a=max_deg_a, max_deg_b=max_deg_b,
              row_capacity=row_capacity)
    got = acc_k.spa_numeric(**kw, tile_n=tile_n, n_tiles=n_tiles)
    _assert_bitwise(got, acc_k.spa_numeric(**kw, tile_n=tile_n,
                                           n_tiles=n_tiles))
    _assert_numeric_equal(got, acc_k.spa_numeric_plain(
        **kw, tile_n=tile_n, n_tiles=n_tiles))
    return got, kw


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["spa", "auto"])
def test_spa_val_is_bitwise_equal_across_launches(card, route):
    """Kernel 5 adds each column's products in A-entry order: on every SPA
    bucket of the five mini families' forced and auto-routed plans, two
    launches give the same val bit for bit, equal to the plain version,
    and col, row_nnz and overflow equal the ESC kernel's."""
    buckets = 0
    for i, (name, m) in enumerate(suite.mini_suite(scale=200)):
        m = _valued(m, 80 + i)
        sample = np.random.default_rng(8).integers(0, m.nrows, 60)
        p = plan.plan_spgemm(m, m, route=route, use_kernel=True,
                             sample_rows=sample, device=card)
        ad = p.to_device(m, "a")
        for bk, cap in zip(p.binning.buckets, p.alloc.bucket_capacities):
            if bk.route != binning.ROUTE_SPA:
                continue
            got, kw = _spa_checks(ad, ad, torch.from_numpy(bk.rows).to(card),
                                  bk.deg_a, bk.deg_b, cap, bk.tile_n,
                                  bk.n_tiles)
            esc = num_k.spgemm_numeric(**kw)
            assert torch.equal(got[0], esc[0]) and torch.equal(got[2], esc[2])
            assert int(got[3]) == int(esc[3])
            buckets += 1
    assert buckets >= (5 if route == "spa" else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [24, 512])
def test_spa_wide_tiles_multi_tile_rows_and_scratch(card, cap):
    """The forced wide-span cases: 16,384-lane tiles over two million
    columns (up to 128 tiles a row, only those holding products visited);
    128-lane tiles whose window ends inside the rows' extent (products past
    it dropped); and rows of about 15,000 A entries, whose tables put every
    unit in a scratch slice.  Bit for bit across launches and equal to the
    plain version."""
    a = _valued(sprand.erdos_renyi(400, 500, 6, seed=21), 22)
    b = _valued(sprand.erdos_renyi(500, 2_000_000, 6, seed=23), 24)
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    rows = torch.arange(a.nrows, dtype=torch.int32, device=card)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    tile_n, n_tiles = binning.spa_tile(b.ncols, binning.DEFAULT_LANE_BUDGET)
    assert (tile_n, n_tiles) == (16_384, 128)
    got, kw = _spa_checks(ad, bd, rows, da, db, cap, tile_n, n_tiles)
    esc = num_k.spgemm_numeric(**kw)
    assert torch.equal(got[0], esc[0]) and torch.equal(got[2], esc[2])
    # banded rows of about 60 columns' extent: 128-lane tiles, 4 of them
    # (multi-tile rows) and 1 of them (the window cuts the extent)
    m = _valued(sprand.banded(3000, 3000, 40, 250, seed=25), 26)
    md = csr.to_device(m, device=card)
    rows = torch.arange(m.nrows, dtype=torch.int32, device=card)
    dm = int(m.row_nnz.max())
    for n in (4, 1):
        _spa_checks(md, md, rows, dm, dm, cap, 128, n)
    # tables of ~15,000 A entries a row: no unit fits shared memory
    a = _valued(sprand.erdos_renyi(64, 100_000, 15_000, seed=27), 28)
    b = _valued(sprand.erdos_renyi(100_000, 5_000, 2, seed=29), 30)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    tile_n, n_tiles = binning.spa_tile(b.ncols, binning.DEFAULT_LANE_BUDGET)
    shape = _build.spa_numeric_shape(_build.max_smem("spa_numeric", card),
                                     da, db, tile_n, a.nrows,
                                     _build.sm_count(card))
    assert shape.slice_bytes > 0
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    rows = torch.arange(a.nrows, dtype=torch.int32, device=card)
    _spa_checks(ad, bd, rows, da, db, cap, tile_n, n_tiles)


@pytest.mark.cuda
def test_spa_sums_a_repeated_b_column(card):
    """B built by ``from_coo(dedup=False)``, its rows repeating columns two
    and three times (as validate_csr(allow_duplicates=True) admits): each
    column's repeats are summed, bit for bit across launches, equal to the
    plain version and, in col and row_nnz, to the ESC kernel."""
    rng = np.random.default_rng(91)
    n = 400
    rows_b, cols_b = [], []
    for r in range(n):
        c = np.sort(rng.choice(600, 40, replace=False))
        c = np.repeat(c, rng.integers(1, 4, c.size))   # runs of 1 to 3
        rows_b.append(np.full(c.size, r))
        cols_b.append(c)
    rows_b, cols_b = np.concatenate(rows_b), np.concatenate(cols_b)
    b = CSR.from_coo(rows_b, cols_b,
                     rng.standard_normal(cols_b.size).astype(np.float32),
                     (n, 600), dedup=False)
    assert (np.diff(b.col)[np.diff(np.repeat(np.arange(n),
                                             b.row_nnz)) == 0] == 0).any()
    a = _valued(sprand.erdos_renyi(300, n, 8, seed=92), 93)
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    tile_n, n_tiles = binning.spa_tile(b.ncols, binning.DEFAULT_LANE_BUDGET)
    outs = []
    # 300 rows take a block each; the same rows listed 8 times fill the
    # card with warp groups: each column is summed in A-entry order either
    # way, so val is the same bit for bit
    for reps in (1, 8):
        rows = torch.arange(a.nrows, dtype=torch.int32,
                            device=card).repeat(reps)
        shape = _build.spa_numeric_shape(
            _build.max_smem("spa_numeric", card), da, db, tile_n,
            rows.shape[0], _build.sm_count(card))
        assert (shape.group == 0) == (reps == 1)
        got, kw = _spa_checks(ad, bd, rows, da, db, 700, tile_n, n_tiles)
        esc = num_k.spgemm_numeric(**kw)
        assert torch.equal(got[0], esc[0]) and torch.equal(got[2], esc[2])
        outs.append(got)
    _assert_bitwise([x[:a.nrows] for x in outs[1][:3]], outs[0])


@pytest.mark.cuda
def test_flop_per_row_kernel_on_a_skewed_matrix(card):
    """Kernel 9 against its plain version and the host oracle on a
    power-law A with one row of 12,000 entries (its warp streams it across
    many loads), every seventh row empty, and bounds below and above the
    rows' degrees."""
    base = sprand.power_law(20_000, 20_000, 6, 1.4, seed=95)
    rows = np.repeat(np.arange(base.nrows), base.row_nnz)
    keep = rows % 7 != 0
    rng = np.random.default_rng(96)
    hub = np.sort(rng.choice(base.ncols, 12_000, replace=False))
    r_all = np.concatenate([rows[keep], np.full(hub.size, 4321)])
    c_all = np.concatenate([base.col[keep], hub])
    m = CSR.from_coo(r_all, c_all, np.ones(r_all.size, np.float32),
                     base.shape)
    assert int(m.row_nnz.max()) >= 12_000 and (m.row_nnz == 0).sum() > 2000
    md = csr.to_device(m, device=card)
    rnb = torch.diff(md.rpt)
    for max_deg_a in (1, 5, 40, 3000, int(m.row_nnz.max())):
        got = flop_k.flop_per_row(md, rnb, max_deg_a=max_deg_a)
        assert torch.equal(got, flop_k.flop_per_row_plain(
            md, rnb, max_deg_a=max_deg_a))
    floprc, _ = oracle.flop_per_row(m, m)
    assert np.array_equal(got.cpu().numpy(), floprc)


# (sq, sk, D, causal, Hq, Hkv): the CPU tests' cases
# (tests/test_torch_attention.py), a 1024-token case at qwen2.5-32b's
# attention width (40 heads, 8 kv heads, D 128), phi3-mini's (32 heads,
# D 96), and ragged tiles (Sq, Sk off the kernels' 64- and 128-row tiles,
# D 48); for the tensor-core kernel, D 128 causal with Sq < Sk and Sq > Sk
# over groups of five, and ragged tiles at D 128 and 96
ATTN_CASES = [(128, 128, 64, True, 4, 2), (128, 256, 64, False, 4, 2),
              (256, 256, 32, True, 4, 2),
              (64, 128, 32, True, 4, 2), (128, 64, 32, True, 4, 2),
              (128, 128, 96, True, 4, 4), (128, 128, 16, True, 4, 2),
              (128, 128, 64, False, 6, 2),
              (1024, 1024, 128, True, 40, 8), (1024, 1024, 96, True, 32, 32),
              (96, 160, 48, True, 4, 2),
              (128, 384, 128, True, 10, 2), (384, 128, 128, True, 10, 2),
              (96, 160, 128, True, 4, 2), (96, 160, 96, False, 4, 4)]
# fp32: the same sums in another order; bf16/f16: one rounding of the output
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}


def _attn_inputs(card, shape_q, shape_kv, dtype, seed):
    rng = np.random.default_rng(seed)
    return [convert.dense_from_numpy(
        rng.standard_normal(s).astype(np.float32), dtype, card)
        for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sq,sk,d,causal,hq,hkv", ATTN_CASES)
def test_flash_attention_kernel_matches_plain_version(card, sq, sk, d, causal,
                                                      hq, hkv, dtype):
    q, k, v = _attn_inputs(card, (2, hq, sq, d), (2, hkv, sk, d), dtype,
                           sq + sk + d)
    kernel = getattr(fa_k, f"flash_attention_{fa_k.variant(dtype, d)}")
    before = (fa_k.flash_attention.launches, kernel.launches)
    got = fa_k.flash_attention(q, k, v, causal=causal, block_q=32,
                               block_k=32)
    assert (fa_k.flash_attention.launches, kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    want = fa_k.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_kernel_takes_strided_inputs_and_refuses_wide_heads(
        card):
    q, k, v = _attn_inputs(card, (1, 4, 64, 128), (1, 2, 64, 128),
                           torch.bfloat16, 1)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)   # not contiguous
    # contiguous, but starting 2 bytes into its storage: no tensor map
    # takes that start, so the sm90 kernel reads an aligned copy
    qm = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)[1:].view(
        q.shape).copy_(q)
    want = fa_k.flash_attention(q, k, v, block_q=64, block_k=64)
    for other in (qs, qm):
        torch.testing.assert_close(fa_k.flash_attention(other, k, v,
                                                        block_q=64,
                                                        block_k=64),
                                   want, rtol=0, atol=0)
    wide = torch.zeros(1, 2, 64, 320, device=card)
    with pytest.raises(ValueError, match="head dim 320"):
        fa_k.flash_attention(wide, wide, wide, block_q=64, block_k=64)
