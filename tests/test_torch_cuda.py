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


def _row_units(a, b, rows, da, db, n_words):
    """Per sampled row of host operands: its products at the bounds and the
    mask words its column extent takes (at most ``n_words``)."""
    n, used = [], []
    for r in rows:
        ks = a.col[a.rpt[r]:a.rpt[r] + min(a.rpt[r + 1] - a.rpt[r], da)]
        cols = [b.col[b.rpt[k]:b.rpt[k] + min(b.rpt[k + 1] - b.rpt[k], db)]
                for k in ks]
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
        n.append(cols.size)
        used.append(min(n_words, (int(cols.max()) - int(cols.min())) // 32
                        + 1) if cols.size else 0)
    return np.array(n), np.array(used)


def _bitmask_unit(n, used):
    """The unit the bitmask kernel counts a row with, once a warp has
    counted its products ``n`` and the words ``used`` of its extent."""
    define = lambda name: _build.source_define("bitmask_symbolic", name)
    keys, regs = define("BMS_WARP_KEYS"), define("BMS_REG_WORDS")
    if n > _build.BMS_WARP_MAX or (n > keys and used > _build.BMS_WARP_WORDS):
        return "block"
    if n <= keys:
        return "match"
    return "regs" if used <= regs else "mask"


def _bitmask_case(case):
    """Host operands, sampled rows, bounds and span of one unit of the
    bitmask symbolic kernel."""
    rng = np.random.default_rng(60)
    wide = lambda deg, seed: (sprand.erdos_renyi(2000, 2000, deg, seed=seed),
                              sprand.erdos_renyi(2000, 1_000_000, deg,
                                                 seed=seed + 1))
    if case == "warp_match":      # few products spread over 10^6 columns
        a, b = wide(4, 62)
    elif case == "warp_match2":   # 33 to 64 products: two rounds of keys
        a, b = wide(7, 66)
    elif case == "warp_regs":     # 65 to 256 products in a few words
        a = b = sprand.banded(3000, 3000, 12, 20, seed=61)
    elif case == "warp_mask":     # 65 to 256 products in up to 512 words
        a = b = sprand.banded(3000, 3000, 12, 1000, seed=67)
    elif case == "handed_to_block":   # 65 to 256 products, too wide
        a, b = wide(12, 68)
    elif case == "block_smem":    # thousands of products, narrow extent
        a = b = sprand.banded(2000, 2000, 60, 100, seed=64)
    elif case == "block_slice":   # B's 4 M columns pass shared memory
        a, b = _long_row_operands()
    elif case == "duplicates":    # hub and short rows, each drawn 3 times
        a = b = sprand.power_law(3000, 3000, 6, 1.2, seed=5)
    else:                         # 2 words of a ~1,200-column extent
        a = b = sprand.banded(2000, 2000, 20 if case == "narrow_span_block"
                              else 8, 300, seed=65)
    rows = rng.integers(0, a.nrows, 200)
    if case == "block_slice":
        rows = np.concatenate([[0, 1, 2, 0], rows, [1]])
    if case == "duplicates":
        hubs = np.argsort(a.row_nnz)[-4:]
        rows = np.concatenate([hubs, rows[:40], hubs, rows[:40], hubs,
                               rows[:40]])
    span = 64 if case.startswith("narrow_span") else 0
    return (a, b, rows.astype(np.int32), int(a.row_nnz.max()),
            int(b.row_nnz.max()), span)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "warp_match", "warp_match2", "warp_regs", "warp_mask", "handed_to_block",
    "block_smem", "block_slice", "duplicates", "narrow_span_warp",
    "narrow_span_block"])
def test_bitmask_kernel_units_match_plain_versions(card, case):
    """Each unit of the bitmask symbolic kernel, through its three entries
    (kernel 4 at one bucket's bounds, kernel 4's one launch over a table,
    kernel 8), against the plain versions: a row on a warp by a match of
    its keys (one or two rounds), by presence bits in registers and in the
    warp's shared memory, a row its warp hands to the block, a long row
    with its mask in shared memory and in its block's scratch slice,
    duplicated rows, and a span narrower than the rows' extent (columns
    past it are not counted).  Where the span covers the extent, z* equals
    the host oracle and the ESC kernel's."""
    a, b, rows, da, db, span = _bitmask_case(case)
    nw = acc_k._n_words(b.ncols, span)
    n, used = _row_units(a, b, rows, da, db, nw)
    units = np.array([_bitmask_unit(x, y) for x, y in zip(n, used)])
    share = lambda unit: (units == unit).mean()
    if case in ("warp_match", "warp_regs", "warp_mask"):
        assert share(case[5:]) > 0.7
    elif case == "warp_match2":
        assert share("match") > 0.7 and (n > 32).mean() > 0.5
    elif case == "handed_to_block":
        assert share("block") > 0.7 and (n <= _build.BMS_WARP_MAX).all()
    elif case == "block_smem":
        assert (n > _build.BMS_WARP_MAX).all()
    elif case == "block_slice":
        shape = _build.bitmask_shape(_build.max_smem("bitmask_symbolic", card),
                                     0, rows.size, nw, da)
        assert 0 <= shape.smem_words < nw and shape.slice_bytes
        assert (used[units == "block"] > shape.smem_words).sum() >= 3
    elif case == "duplicates":
        assert share("block") * rows.size >= 12 and share("match") > 0.3
    else:
        assert (used == nw).all() and nw == 2
        assert share("match" if case == "narrow_span_warp" else "block") > 0.7
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    rows_d = torch.from_numpy(rows).to(card)
    kw = dict(a=ad, b=bd, rows=rows_d, max_deg_a=da, max_deg_b=db,
              span=span)
    want = acc_k.fused_flop_symbolic_bitmask_plain(**kw)
    flop = want[2].cpu().numpy()
    table = acc_k.bitmask_table(rows, np.full(rows.size, da),
                                np.full(rows.size, db),
                                np.full(rows.size, nw), flop, card)
    assert table.n_long == int((np.minimum(flop, da * db)
                                > _build.BMS_WARP_MAX).sum())
    before = (acc_k.fused_flop_symbolic_bitmask.launches,
              acc_k.fused_flop_symbolic_bitmask_buckets.launches,
              acc_k.bitmask_symbolic.launches)
    for got in (acc_k.fused_flop_symbolic_bitmask(**kw),
                acc_k.fused_flop_symbolic_bitmask_buckets(ad, bd, table)):
        assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
        assert torch.equal(got[2], want[2])
    got = acc_k.bitmask_symbolic(**kw)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    assert (acc_k.fused_flop_symbolic_bitmask.launches,
            acc_k.fused_flop_symbolic_bitmask_buckets.launches,
            acc_k.bitmask_symbolic.launches) == tuple(x + 1 for x in before)
    if span == 0:
        assert int(want[0]) == oracle.exact_sampled_nnz(a, b, rows)
        esc = sym_k.fused_flop_symbolic(ad, bd, rows_d, max_deg_a=da,
                                        max_deg_b=db)
        assert int(esc[0]) == int(want[0])
    else:
        assert int(want[0]) < oracle.exact_sampled_nnz(a, b, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 300])
def test_bitmask_rows_past_their_flop_bound(card, cap):
    """A FLOP below a row's products puts it on a warp it outgrows: with a
    FLOP of 1 every row goes to a warp, and the warps of the hub rows (past
    BMS_WARP_MAX products, extents past the warp's words) hand them to
    their blocks; capped at 300, the hub rows are long, each on a block.
    Either way z* and the FLOP are exact."""
    a, b = _long_row_operands()
    rows = np.concatenate([[0, 1, 2, 0], np.random.default_rng(85).integers(
        0, a.nrows, 200), [1]]).astype(np.int32)
    ad, bd = csr.to_device(a, device=card), csr.to_device(b, device=card)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    nw = acc_k._n_words(b.ncols, 0)
    flop = oracle.flop_per_row(a, b)[0][rows]
    table = acc_k.bitmask_table(rows, np.full(rows.size, da),
                                np.full(rows.size, db),
                                np.full(rows.size, nw),
                                np.minimum(flop, cap), card)
    assert table.n_long == (0 if cap == 1 else 6)
    got = acc_k.fused_flop_symbolic_bitmask_buckets(ad, bd, table)
    want = acc_k.fused_flop_symbolic_bitmask_buckets_plain(ad, bd, table)
    assert int(got[0]) == int(want[0]) == oracle.exact_sampled_nnz(a, b,
                                                                   rows)
    assert int(got[1]) == int(want[1]) == int(flop.sum())
    assert np.array_equal(got[2].cpu().numpy(), flop)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["spa", "bin", "auto"])
@pytest.mark.parametrize("alpha", [1.2, 1.6])
def test_bitmask_one_launch_matches_plain_and_per_bucket(card, alpha, route):
    """Kernel 4's one launch over every SPA and BIN sample of a plan, each
    at its own bucket's bounds and words, against its plain version, the
    per-bucket kernel on every bucket and the host oracle; and the binned
    prediction launches it once, with no per-bucket launch."""
    m = sprand.power_law(3000, 3000, 40, alpha, seed=5)
    bp = binning.build_plan(m, m, route=route)
    sample = np.random.default_rng(0).integers(0, m.nrows, 300)
    ad = csr.to_device(m, device=card)
    rnb = torch.diff(ad.rpt)
    tabs = predictor.plan_tables(bp, card)
    floprc = oracle.flop_per_row(m, m)[0]
    table = predictor.bitmask_sample_table(bp, tabs, sample, floprc[sample],
                                           m.ncols, card)
    bitmask_rows = np.concatenate([sub for bk, sub in zip(
        bp.buckets, bp.subset(sample)) if bk.route != "esc"])
    if route == "auto" and not bitmask_rows.size:
        assert table is None
        return
    got = acc_k.fused_flop_symbolic_bitmask_buckets(ad, ad, table,
                                                    rownnz_b=rnb)
    want = acc_k.fused_flop_symbolic_bitmask_buckets_plain(ad, ad, table,
                                                           rownnz_b=rnb)
    z_b = f_b = 0
    for bk, sub in zip(bp.buckets, bp.subset(sample)):
        if sub.size and bk.route != "esc":
            zs, fs, _ = acc_k.fused_flop_symbolic_bitmask(
                ad, ad, torch.from_numpy(sub).to(card), max_deg_a=bk.deg_a,
                max_deg_b=bk.deg_b, span=bk.span, rownnz_b=rnb)
            z_b, f_b = z_b + int(zs), f_b + int(fs)
    host = (oracle.exact_sampled_nnz(m, m, bitmask_rows),
            int(floprc[bitmask_rows].sum()))
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1])) \
        == (z_b, f_b) == host
    assert torch.equal(got[2], want[2])
    # the FLOP per sample in the caller's order
    on_bitmask = ~tabs.esc[bp.row_bucket[sample]]
    assert np.array_equal(got[2].cpu().numpy(), floprc[sample[on_bitmask]])
    before = (acc_k.fused_flop_symbolic_bitmask.launches,
              acc_k.fused_flop_symbolic_bitmask_buckets.launches)
    pred = predictor.proposed_predict_binned(
        ad, ad, torch.from_numpy(sample.astype(np.int32)).to(card), bp,
        use_kernel=True)
    assert (acc_k.fused_flop_symbolic_bitmask.launches,
            acc_k.fused_flop_symbolic_bitmask_buckets.launches) == \
        (before[0], before[1] + 1)
    assert int(pred.sampled_nnz) == oracle.exact_sampled_nnz(m, m, sample)


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
# D 48); for the wgmma kernel, D 128 causal with Sq < Sk and Sq > Sk over
# groups of five, and ragged tiles at D 128 and 96; for the mma kernel, a
# head dim off a multiple of 8 (D 20, padded), zamba2-7b's D 112 and the
# wide buckets (D 192 and 256, 4 warps and narrower key tiles)
ATTN_CASES = [(128, 128, 64, True, 4, 2), (128, 256, 64, False, 4, 2),
              (256, 256, 32, True, 4, 2),
              (64, 128, 32, True, 4, 2), (128, 64, 32, True, 4, 2),
              (128, 128, 96, True, 4, 4), (128, 128, 16, True, 4, 2),
              (128, 128, 64, False, 6, 2),
              (1024, 1024, 128, True, 40, 8), (1024, 1024, 96, True, 32, 32),
              (96, 160, 48, True, 4, 2),
              (128, 384, 128, True, 10, 2), (384, 128, 128, True, 10, 2),
              (96, 160, 128, True, 4, 2), (96, 160, 96, False, 4, 4),
              (96, 160, 20, True, 4, 2), (128, 128, 112, True, 4, 4),
              (128, 256, 192, False, 4, 2), (128, 128, 256, True, 4, 2)]
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_kernel_is_bitwise_across_launches(card, dtype):
    """No atomics: two launches on the same inputs give the same bits, on
    the mma kernel (D 112, ragged tiles; float32 also at D 128) and, for
    the 16-bit types, the sm90 one (D 128)."""
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for sq, sk, d in ((96, 160, 112), (96, 160, 128)):
        q, k, v = _attn_inputs(card, (2, 4, sq, d), (2, 2, sk, d), dtype,
                               sq + d)
        first = fa_k.flash_attention(q, k, v, causal=True, block_q=32,
                                     block_k=32)
        again = fa_k.flash_attention(q, k, v, causal=True, block_q=32,
                                     block_k=32)
        assert bool(first.isfinite().all())
        assert torch.equal(first.view(bits), again.view(bits))


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


# --------------------------------------------------------------------------- #
# Re-planning on overflow and plan templates: kernels 2 and 4 in their
# per-row count mode over whole buckets, the numeric kernels over padded
# tables, and retried and template-planned plans against the plain path
# --------------------------------------------------------------------------- #
def _count_tables(m, bk, flop, card):
    """The whole bucket's kernel-2 or kernel-4 table at its bounds, with
    the count entry and its plain version."""
    da = np.full(bk.n_rows, bk.deg_a, np.int32)
    db = np.full(bk.n_rows, bk.deg_b, np.int32)
    if bk.route == binning.ROUTE_ESC:
        return (sym_k.sample_table(bk.rows, da, db, flop, card),
                sym_k.exact_row_counts_esc, sym_k.exact_row_counts_esc_plain)
    lanes = min(bk.span, m.ncols) if bk.span else m.ncols
    return (acc_k.bitmask_table(bk.rows, da, db,
                                np.full(bk.n_rows, -(-lanes // 32)), flop,
                                card),
            acc_k.exact_row_counts_bitmask,
            acc_k.exact_row_counts_bitmask_plain)


_COUNT_CASES = [(name, route) for name in ("mini_er", "mini_pl", "mini_rmat",
                                           "mini_band", "mini_fem")
                for route in ("esc", "spa", "auto")] + [
    ("power_law_1.2", "esc"), ("power_law_1.2", "bin")]


def _count_matrix(name):
    if name == "power_law_1.2":
        return sprand.power_law(3000, 3000, 40, 1.2, seed=5)
    return dict(suite.mini_suite(scale=200))[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name,route", _COUNT_CASES)
def test_exact_row_counts_kernels_over_whole_buckets(card, name, route):
    """Every row of every bucket, in one launch of kernel 2 (ESC buckets)
    or kernel 4 (SPA and BIN) in per-row count mode: equal to the plain
    versions, to the host's exact structure and to predictor.
    exact_row_counts on the card with and without the kernels; with a FLOP
    of 1 a row (every workspace too small) the counts stay exact."""
    m = _count_matrix(name)
    bp = binning.build_plan(m, m, route=route)
    ad = csr.to_device(m, device=card)
    rnb = torch.diff(ad.rpt)
    floprc, _ = oracle.flop_per_row(m, m)
    exact, _ = oracle.exact_structure(m, m)
    for bk in bp.buckets:
        for flop in (floprc[bk.rows], np.ones(bk.n_rows, np.int64)):
            table, fn, plain = _count_tables(m, bk, flop, card)
            kw = dict(a=ad, b=ad, table=table, rownnz_b=rnb)
            before = fn.launches
            got = fn(**kw)
            assert fn.launches == before + 1
            assert torch.equal(got, plain(**kw))
            np.testing.assert_array_equal(got.cpu().numpy(), exact[bk.rows])
        kw = dict(max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, route=bk.route,
                  span=bk.span)
        for use_kernel in (False, True):
            got = predictor.exact_row_counts(ad, ad, bk.rows,
                                             use_kernel=use_kernel,
                                             row_flop=floprc[bk.rows], **kw)
            np.testing.assert_array_equal(got, exact[bk.rows])


@pytest.mark.cuda
def test_count_mode_leaves_the_prediction_launches_alone(card):
    """The sampled launches of kernels 2 and 4 (z_out null) give the same
    z*, f* and FLOP as before the count mode, and a count-mode launch over
    the same table sums to z*."""
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=8), 9)
    ad = csr.to_device(m, device=card)
    rnb = torch.diff(ad.rpt)
    floprc, _ = oracle.flop_per_row(m, m)
    rows = np.random.default_rng(4).integers(0, m.nrows, 300)
    for route in ("esc", "bin"):
        bp = binning.build_plan(m, m, route=route)
        tabs = predictor.plan_tables(bp, card)
        if route == "esc":
            table = predictor.esc_sample_table(bp, tabs, rows, floprc[rows],
                                               card)
            fn, count = (sym_k.fused_flop_symbolic_buckets,
                         sym_k.exact_row_counts_esc)
        else:
            table = predictor.bitmask_sample_table(bp, tabs, rows,
                                                   floprc[rows], m.ncols,
                                                   card)
            fn, count = (acc_k.fused_flop_symbolic_bitmask_buckets,
                         acc_k.exact_row_counts_bitmask)
        z, f, fl = fn(ad, ad, table, rownnz_b=rnb)
        assert int(z) == oracle.exact_sampled_nnz(m, m, rows)
        assert int(f) == int(floprc[rows].sum())
        np.testing.assert_array_equal(fl.cpu().numpy(), floprc[rows])
        assert int(count(ad, ad, table, rownnz_b=rnb).sum()) == int(z)


def _pad_row_plan(card):
    """A banded member, its row 0 made a hub of 300 entries, planned
    against a power-law template: some template buckets are empty and
    launch row 0 under their narrow bounds."""
    pl = _valued(sprand.power_law(500, 500, 5, 1.5, seed=21), 22)
    band = sprand.banded(500, 500, 6, 8, seed=3)
    hub = np.random.default_rng(1).choice(np.arange(1, 500), 300,
                                          replace=False)
    rows = np.concatenate([np.zeros(hub.size, np.int64),
                           np.repeat(np.arange(500), np.diff(band.rpt))])
    cols = np.concatenate([hub, band.col.astype(np.int64)])
    m = _valued(CSR.from_coo(rows, cols, np.ones(rows.size, np.float32),
                             (500, 500)), 23)
    sample = np.random.default_rng(2).integers(0, 500, 40)
    tpl = plan.PlanTemplate.from_plan(plan.plan_spgemm(
        pl, pl, pop_quant=True, sample_rows=sample, use_kernel=True,
        device=card))
    return m, plan.plan_spgemm(m, m, template=tpl, sample_rows=sample,
                               use_kernel=True, device=card)


@pytest.mark.cuda
def test_numeric_kernels_over_padded_tables_and_the_empty_bucket_row(card):
    """Kernels 3, 5 and 6 over every padded table of a template member
    (pad rows and the row 0 of empty buckets included), each at the bound
    the plan passes, against the plain numeric phase on the same table."""
    m, p = _pad_row_plan(card)
    empty = [i for i, bk in enumerate(p.binning.buckets) if not bk.n_rows]
    assert empty and all(p.flop_bounds()[i] == int(p.flopr[0]) > 1000
                         for i in empty)
    ad = p.to_device(m, "a")
    rnb = torch.diff(ad.rpt)
    for route in ("esc", "spa", "bin"):
        for bk, cap, table, bound in zip(p.binning.buckets,
                                         p.alloc.bucket_capacities,
                                         p.device_args(), p.flop_bounds()):
            # the bucket's own layout on its route; on another, tiles
            # derived from B's columns (outputs do not depend on routes)
            own = route == bk.route
            kw = dict(row_capacity=cap, deg_a=bk.deg_a, deg_b=bk.deg_b,
                      route=route, tile_n=bk.tile_n if own else 0,
                      n_tiles=bk.n_tiles if own else 0,
                      span=bk.span if own else 0)
            got = spgemm.routed_spgemm_rows(ad, ad, table, use_kernel=True,
                                            max_row_flop=bound, rownnz_b=rnb,
                                            **kw)
            want = spgemm.routed_spgemm_rows(ad, ad, table, **kw)
            _assert_numeric_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
@pytest.mark.parametrize("policy", ["ladder", "fallback"])
def test_retried_plan_matches_the_plain_path(card, route, policy):
    """A plan at the 8-slot floor re-planned on the card (numeric kernels,
    and for the fallback kernels 2 and 4's per-row counts) against the
    same plan run plain on the host: events, capacities and output."""
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=61), 62)
    sample = np.random.default_rng(6).integers(0, m.nrows, 200)
    outs, plans = [], []
    for dev, use_kernel in ((card, True), ("cpu", False)):
        p = plan.plan_spgemm(
            m, m, route=route, safety=0.0, sample_rows=sample,
            use_kernel=use_kernel, device=dev,
            retry_policy=plan.RetryPolicy(rounds=int(policy == "ladder")))
        outs.append(plan.execute(p, m, m, cache=plan.PlanCache()))
        plans.append(p)
    assert plans[0].retry_events == plans[1].retry_events
    assert plans[0].degradations == plans[1].degradations
    assert (plans[0].retry_events if policy == "ladder"
            else plans[0].degradations)
    assert plans[0].alloc.bucket_capacities == plans[1].alloc.bucket_capacities
    got, want = outs
    assert torch.equal(got.col.cpu(), want.col)
    assert torch.equal(got.row_nnz.cpu(), want.row_nnz)
    assert int(got.overflow) == int(want.overflow) == 0
    np.testing.assert_allclose(got.val.cpu().numpy(), want.val.numpy(),
                               rtol=VAL_RTOL, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
def test_template_member_matches_the_plain_path(card, route):
    """A template member, its tables padded, run through the kernels and
    re-planned on the card against the same member run plain on the
    host; a second member of the same key reuses the executor."""
    gen = lambda s: _valued(sprand.power_law(2000, 2000, 8, 1.5, seed=s),
                            s + 1)
    sample = np.random.default_rng(3).integers(0, 2000, 60)
    outs = []
    for dev, use_kernel in ((card, True), ("cpu", False)):
        tpl = plan.PlanTemplate.from_plan(plan.plan_spgemm(
            gen(10), gen(10), route=route, pop_quant=True,
            sample_rows=sample, use_kernel=use_kernel, device=dev))
        cache = plan.PlanCache()
        for s in (20, 30, 20):
            m = gen(s)
            p = plan.plan_spgemm(m, m, template=tpl, sample_rows=sample,
                                 use_kernel=use_kernel, device=dev,
                                 retry_policy=plan.RetryPolicy())
            outs.append(plan.execute(p, m, m, cache=cache))
    for got, want in zip(outs[:3], outs[3:]):
        assert torch.equal(got.col.cpu(), want.col)
        assert torch.equal(got.row_nnz.cpu(), want.row_nnz)
        assert int(got.overflow) == int(want.overflow) == 0
        np.testing.assert_allclose(got.val.cpu().numpy(), want.val.numpy(),
                                   rtol=VAL_RTOL, atol=1e-5)


@pytest.mark.cuda
def test_retry_splices_on_the_card_and_widens_once_a_round(card):
    """The re-planned output stays on the card, one buffer a round: its
    width is the round's widest new capacity."""
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=63), 64)
    p = plan.plan_spgemm(m, m, safety=0.0, use_kernel=True, device=card,
                         retry_policy=plan.RetryPolicy())
    out = plan.execute(p, m, m, cache=plan.PlanCache())
    assert out.col.is_cuda and out.val.is_cuda
    assert out.col.shape[1] == max(e["new_cap"] for e in p.retry_events) \
        == p.alloc.row_capacity


def _panel_plan(card, route, n_panels, **kw):
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=71), 72)
    sample = np.random.default_rng(7).integers(0, m.nrows, 200)
    p = plan.plan_spgemm(m, m, route=route, n_panels=n_panels,
                         sample_rows=sample, use_kernel=True, device=card,
                         **kw)
    return m, sample, p


def _numeric_launches():
    return (num_k.spgemm_numeric.launches + acc_k.spa_numeric.launches
            + acc_k.bin_numeric.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin", "auto"])
@pytest.mark.parametrize("n_panels", [2, 4])
def test_numeric_kernels_on_panel_operands(card, route, n_panels):
    """Kernels 3, 5 and 6 on every (bucket × panel) unit, against that
    panel's operand (its own row lengths), at the panel deg_b bound, the
    unit's own FLOP bound and the bucket's planned SPA/BIN window: equal to
    the plain numeric phase on the same operand.  A unit with no products
    (FLOP bound 0) launches cleanly too."""
    m, _, p = _panel_plan(card, route, n_panels)
    ad = p.to_device(m, "a")
    bps = plan._panel_operands_local(p, m)
    bounds = p.panel_flop_bounds()
    for i, (bk, table) in enumerate(zip(p.binning.buckets,
                                        p.device_args())):
        for q, bp in enumerate(bps):
            assert bounds[i][q] <= p.flop_bounds()[i]
            meta = plan._panel_meta(bk, p.panel_deg_b[i],
                                    int(p.panel_caps[i, q]))
            kw = dict(row_capacity=meta[-1], deg_a=meta[0], deg_b=meta[1],
                      route=bk.route, tile_n=bk.tile_n, n_tiles=bk.n_tiles,
                      span=bk.span)
            got = spgemm.routed_spgemm_rows(
                ad, bp, table, use_kernel=True, max_row_flop=bounds[i][q],
                rownnz_b=torch.diff(bp.rpt), **kw)
            want = spgemm.routed_spgemm_rows(ad, bp, table, **kw)
            _assert_numeric_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
def test_count_modes_on_panel_operands(card, route):
    """Kernels 2 and 4 in per-row count mode over every (bucket × panel)
    unit, at the panel's deg_b bound and each row's FLOP in that panel:
    one launch each, equal to the plain counts and to the host's exact
    structure of A times the panel."""
    m, _, p = _panel_plan(card, route, 3)
    ad = p.to_device(m, "a")
    bps = plan._panel_operands_local(p, m)
    for q, ((prpt, pcol, _), bp) in enumerate(zip(p._panel_host, bps)):
        panel = CSR(rpt=prpt, col=pcol,
                    val=np.ones(pcol.size, dtype=np.float32), shape=m.shape)
        exact, _ = oracle.exact_structure(m, panel)
        for i, bk in enumerate(p.binning.buckets):
            kw = dict(max_deg_a=bk.deg_a, max_deg_b=p.panel_deg_b[i],
                      route=bk.route, span=bk.span)
            fn = (sym_k.exact_row_counts_esc if bk.route == "esc"
                  else acc_k.exact_row_counts_bitmask)
            before = fn.launches
            got = predictor.exact_row_counts(
                ad, bp, bk.rows, use_kernel=True,
                row_flop=p._panel_flopr[q][bk.rows], **kw)
            assert fn.launches == before + 1
            np.testing.assert_array_equal(
                got, predictor.exact_row_counts(ad, bp, bk.rows, **kw))
            np.testing.assert_array_equal(got, exact[bk.rows])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin", "auto"])
def test_panel_plan_matches_the_unpanelled_plan_on_the_card(card, route):
    """plan → execute → reassemble with 2 and 4 panels on the card: one
    numeric launch a unit with products, the blocks on the card, and the
    same CSR as the unpanelled plan's (rows and columns exactly)."""
    m, sample, whole = _panel_plan(card, route, 0, safety=4.0)
    want = plan.reassemble(whole, plan.execute(whole, m, m,
                                               cache=plan.PlanCache()))
    for n_panels in (2, 4):
        p = plan.plan_spgemm(m, m, route=route, n_panels=n_panels,
                             sample_rows=sample, use_kernel=True, device=card,
                             safety=4.0)
        units = sum(1 for i, bk in enumerate(p.binning.buckets)
                    for q in range(n_panels)
                    if bk.n_rows and p.panel_flop_bounds()[i][q])
        before = _numeric_launches()
        out = plan.execute(p, m, m, cache=plan.PlanCache())
        assert _numeric_launches() - before == units
        assert out.cols[0][0].is_cuda and int(out.overflow) == 0
        c = plan.reassemble(p, out)
        np.testing.assert_array_equal(c.rpt, want.rpt)
        np.testing.assert_array_equal(c.col, want.col)
        np.testing.assert_allclose(c.val, want.val, rtol=VAL_RTOL, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
@pytest.mark.parametrize("policy", ["ladder", "fallback"])
def test_retried_panel_plan_matches_the_plain_path(card, route, policy):
    """A panel plan at the 8-slot floor re-planned per (bucket × panel) on
    the card against the same plan run plain on the host: events,
    degradations, capacities and every block."""
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=61), 62)
    sample = np.random.default_rng(6).integers(0, m.nrows, 200)
    outs, plans = [], []
    for dev, use_kernel in ((card, True), ("cpu", False)):
        p = plan.plan_spgemm(
            m, m, route=route, safety=0.0, sample_rows=sample, n_panels=3,
            use_kernel=use_kernel, device=dev,
            retry_policy=plan.RetryPolicy(rounds=int(policy == "ladder")))
        outs.append(plan.execute(p, m, m, cache=plan.PlanCache()))
        plans.append(p)
    assert plans[0].retry_events == plans[1].retry_events
    assert plans[0].degradations == plans[1].degradations
    assert (plans[0].retry_events if policy == "ladder"
            else plans[0].degradations)
    np.testing.assert_array_equal(plans[0].panel_caps, plans[1].panel_caps)
    got, want = outs
    assert int(got.overflow) == int(want.overflow) == 0
    for i in range(len(plans[0].binning.buckets)):
        for q in range(3):
            _assert_numeric_equal(
                (got.cols[i][q].cpu(), got.vals[i][q].cpu(),
                 got.row_nnz[i][q].cpu(), 0),
                (want.cols[i][q], want.vals[i][q], want.row_nnz[i][q], 0))


# --------------------------------------------------------------------------- #
# the straggler watchdog, single-device recovery, route profiles and the
# service on the card
# --------------------------------------------------------------------------- #
def _units_with_products(p):
    """(bucket[, panel]) units of a plan whose rows have products."""
    if p.n_panels:
        b = p.panel_flop_bounds()
        return [(i, q) for i in range(len(p.binning.buckets))
                for q in range(p.n_panels) if b[i][q]]
    return [i for i, b in enumerate(p.flop_bounds()) if b]


@pytest.mark.cuda
def test_clean_budget_armed_waves_do_not_trip_after_a_fresh_build(
        card, tmp_path, monkeypatch):
    """With a fresh build directory the kernels are built and loaded inside
    the first plan and dispatches: neither counts against the default
    budget, and no clean wave after them trips it."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})
    loads = _build.loads
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=71), 72)
    for n_panels in (0, 4):
        p = plan.plan_spgemm(m, m, use_kernel=True, device=card,
                             safety=4.0, n_panels=n_panels,
                             dispatch_budget=plan.DispatchBudget())
        cache = plan.PlanCache()
        for _ in range(3):
            out = plan.execute(p, m, m, cache=cache)
            assert p.recoveries == [] and int(out.overflow) == 0
    assert _build.loads > loads
    assert any(tmp_path.iterdir())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
@pytest.mark.parametrize("n_panels", [0, 4])
def test_straggler_recovery_is_bitwise_on_the_card(card, route, n_panels):
    """A delayed wave trips the watchdog; the replay launches one numeric
    kernel a unit with products and equals the clean run bit for bit."""
    from repro_torch.core import faults
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=73), 74)
    p = plan.plan_spgemm(m, m, route=route, use_kernel=True, device=card,
                         safety=4.0, n_panels=n_panels,
                         dispatch_budget=plan.DispatchBudget())
    cache = plan.PlanCache()
    clean = plan.reassemble(p, plan.execute(p, m, m, cache=cache))
    assert p.recoveries == []
    unit = "local-panels" if n_panels else "local"
    wave = (len(_units_with_products(p)) if n_panels
            else len(p.binning.buckets))
    before = _numeric_launches()
    with faults.inject(delay_executor={"unit": unit}, delay_s=60.0):
        out = plan.execute(p, m, m, cache=cache)
    assert _numeric_launches() - before == wave + len(
        _units_with_products(p))
    units = len(p.binning.buckets) * (n_panels or 1)
    assert p.recoveries[0] == dict(kind="wave_failed", unit=unit,
                                   error="StragglerError")
    assert len(p.recoveries) == 1 + units
    assert all(e["attempts"] == 1 for e in p.recoveries[1:])
    c = plan.reassemble(p, out)
    np.testing.assert_array_equal(c.rpt, clean.rpt)
    np.testing.assert_array_equal(c.col, clean.col)
    np.testing.assert_array_equal(c.val.view(np.int32),
                                  clean.val.view(np.int32))


@pytest.mark.cuda
def test_quick_microbenchmark_times_the_card_kernels(card, tmp_path):
    from repro_torch.core import profiles
    kernels = (num_k.spgemm_numeric, acc_k.spa_numeric, acc_k.bin_numeric,
               sym_k.exact_row_counts_esc, acc_k.exact_row_counts_bitmask)
    before = [k.launches for k in kernels]
    try:
        prof = profiles.microbenchmark(quick=True)
        assert all(k.launches > n for k, n in zip(kernels, before))
        assert prof.device_kind == torch.cuda.get_device_name(card)
        assert {c["route"] for c in prof.cells} == set(binning.ROUTES)
        assert all(c["numeric_s"] > 0 and c["symbolic_s"] > 0
                   for c in prof.cells)
        path = tmp_path / "card.json"
        profiles.save(prof, path)
        assert profiles.load(path).to_json() == prof.to_json()
        assert profiles.status()["source"] == "measured"
        host = tmp_path / "host.json"
        profiles.save(dataclasses.replace(prof, device_kind="cpu"), host)
        with pytest.warns(profiles.ProfileLoadWarning, match="device kind"):
            assert profiles.load(host) is None
        assert profiles.status()["source"] == "analytic"
    finally:
        profiles.clear()


@pytest.mark.cuda
def test_service_results_equal_direct_runs_on_the_card(card):
    """Served requests (two template families, two members, two copies)
    equal direct plan → execute → reassemble runs with the service's
    settings bit for bit, and a second pass builds no executor."""
    from repro_torch.serve.spgemm_service import (RequestState,
                                                  ServiceConfig,
                                                  SpgemmService)
    members = [_valued(sprand.power_law(3000, 3000, 8, 1.6, seed=s), s)
               for s in (81, 82)]
    members += [_valued(sprand.banded(3000, 3000, 16, 24, seed=s), s)
                for s in (83, 84)]
    cfg = ServiceConfig(use_kernel=True, device=card)
    svc = SpgemmService(cfg)
    reg, cache = plan.TemplateRegistry(), plan.PlanCache()
    for pass_ in range(2):
        reqs = [(svc.submit(m, m), m) for m in members for _ in range(2)]
        svc.drain()
        if pass_ == 0:
            traces = svc.stats()["plan_cache"]["traces"]
        for r, m in reqs:
            assert r.state == RequestState.DONE, (r.state, r.error)
            pd = plan.plan_spgemm(
                m, m, safety=cfg.safety, seed=cfg.seed, pop_quant=True,
                template="auto", registry=reg, use_kernel=True, device=card,
                retry_policy=cfg.retry_policy)
            want = plan.reassemble(pd, plan.execute(pd, m, m, cache=cache))
            np.testing.assert_array_equal(r.result.rpt, want.rpt)
            np.testing.assert_array_equal(r.result.col, want.col)
            np.testing.assert_array_equal(r.result.val.view(np.int32),
                                          want.val.view(np.int32))
    assert svc.stats()["plan_cache"]["traces"] == traces


def _mesh_units(p):
    bounds = p.shard_flop_bounds()
    return sum(1 for i, t in enumerate(p.shard_tables)
               for s in range(p.num_shards)
               if t.valid[s].any() and bounds[i][s])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin", "auto"])
@pytest.mark.parametrize("n_panels", [0, 2])
def test_mesh_plan_equals_the_single_device_plan_on_the_card(card, route,
                                                             n_panels):
    """A 4-shard mesh of the one card: one numeric launch a (bucket ×
    shard) unit with rows and products, the blocks on the card, and the
    single-device plan's CSR of the same mode (whole-B, or the same
    panels) bit for bit.  A row's panel parts may take another kernel
    unit than the whole row and add in another order, so panel runs equal
    the whole-B run within tolerance only."""
    from repro_torch.core.mesh import make_mesh
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=91), 92)

    def single(n):
        sp = plan.plan_spgemm(m, m, route=route, use_kernel=True,
                              device=card, safety=4.0, n_panels=n)
        return plan.reassemble(sp, plan.execute(sp, m, m,
                                                cache=plan.PlanCache()))

    whole = single(0)
    want = single(n_panels) if n_panels else whole
    mesh = make_mesh((4,), ("data",), devices=[card] * 4)
    p = plan.plan_spgemm(m, m, route=route, use_kernel=True, mesh=mesh,
                         safety=4.0, n_panels=n_panels)
    before = _numeric_launches()
    out = plan.execute(p, m, m, cache=plan.PlanCache())
    assert _numeric_launches() - before == _mesh_units(p)
    assert out.cols[0].is_cuda and int(out.shard_overflow.sum()) == 0
    c = plan.reassemble(p, out)
    np.testing.assert_array_equal(c.rpt, want.rpt)
    np.testing.assert_array_equal(c.col, want.col)
    np.testing.assert_array_equal(c.val.view(np.int32),
                                  want.val.view(np.int32))
    np.testing.assert_array_equal(c.col, whole.col)
    np.testing.assert_allclose(c.val, whole.val, rtol=VAL_RTOL, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
@pytest.mark.parametrize("n_panels", [0, 2])
def test_lost_shard_rehomes_bitwise_on_the_card(card, route, n_panels):
    """Shard 1 of a 4-shard mesh of the card is lost: its rows (its whole
    units, with panels) re-run on the survivors and the product equals the
    clean run bit for bit."""
    from repro_torch.core import faults
    from repro_torch.core.mesh import make_mesh
    m = _valued(sprand.power_law(3000, 3000, 40, 1.4, seed=93), 94)
    mesh = make_mesh((4,), ("data",), devices=[card] * 4)
    p = plan.plan_spgemm(m, m, route=route, use_kernel=True, mesh=mesh,
                         safety=4.0, n_panels=n_panels,
                         retry_policy=plan.RetryPolicy())
    cache = plan.PlanCache()
    clean = plan.reassemble(p, plan.execute(p, m, m, cache=cache))
    with faults.inject(lose_shard=1):
        c = plan.reassemble(p, plan.execute(p, m, m, cache=cache))
    kinds = [e["kind"] for e in p.recoveries]
    assert kinds[0] == "wave_failed" and "rehome" in kinds
    assert {e["shard"] for e in p.recoveries if e["kind"] == "rehome"} == {1}
    np.testing.assert_array_equal(c.rpt, clean.rpt)
    np.testing.assert_array_equal(c.col, clean.col)
    np.testing.assert_array_equal(c.val.view(np.int32),
                                  clean.val.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["whole", "panels", "mesh",
                                     "mesh_panels"])
@pytest.mark.parametrize("family", ["power_law", "banded"])
def test_reservation_covers_the_peak_on_the_card(card, family, variant):
    """What admission reserves for a CUDA plan covers the device bytes its
    plan → execute → reassemble peak at, above what was allocated before
    planning."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.serve import admission
    m = _valued(sprand.power_law(20_000, 20_000, 6, 1.6, seed=95)
                if family == "power_law"
                else sprand.banded(20_000, 20_000, 16, 24, seed=96), 97)
    kw = dict(n_panels=2 if variant.endswith("panels") else 0)
    if variant.startswith("mesh"):
        kw["mesh"] = make_mesh((4,), ("data",), devices=[card] * 4)
    else:
        kw["device"] = card
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p = plan.plan_spgemm(m, m, use_kernel=True, **kw)
    est = admission.estimate_cost(p)
    plan.reassemble(p, plan.execute(p, m, m, cache=plan.PlanCache()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert isinstance(est, admission.DeviceCostEstimate)
    assert est.reserve_bytes >= peak


# --------------------------------------------------------------------------- #
# The LM serving and training paths (no kernel of the port: the model's
# products are plain tensor products): the smoke configs in float32 on the
# card against the host, the recurrent blocks, one train step, the MoE
# dispatch and the sampled dispatch capacity's torch twin.
# --------------------------------------------------------------------------- #
LM_TOL = 1e-4        # relative, plus LM_TOL × the largest |logit|


def _lm_close(got, want, tol=LM_TOL):
    got, want = got.cpu().float(), want.cpu().float()
    scale = max(float(want.abs().max()), 1.0)
    assert bool(((got - want).abs()
                 <= tol * want.abs() + tol * scale).all())


def _lm_names():
    from repro_torch.configs.base import smoke_registry
    return sorted(smoke_registry())


@pytest.mark.cuda
@pytest.mark.parametrize("name", _lm_names())
def test_lm_smoke_config_on_the_card_matches_the_host(card, name):
    """Forward (and MTP) logits, every decode step's logits and greedy
    tokens on the card equal the host's on the same weights (float32, no
    TF32), and decode reproduces the forward on the card."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import schema
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_smoke_config(name)
    host = schema.init_params(T.build_schema(cfg),
                              torch.Generator().manual_seed(3),
                              torch.float32, "cpu")
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10)).astype(
        np.int32))
    fe = None
    if cfg.frontend == "audio_stub":
        fe = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in ("cpu", card):
        p = schema.tree_map(lambda a: a.to(dev), host)
        t = tok.to(dev)
        f = None if fe is None else fe.to(dev)
        batch = {"tokens": t, **({} if f is None else {"frame_embeds": f})}
        with torch.no_grad():
            full, _, mtp = T.forward(p, cfg, batch, capacity=64)
        steps = engine.prefill(engine.start_session(
            cfg, p, 2, 10, frame_embeds=f, device=dev), t, all_logits=True)
        greedy = engine.generate(engine.start_session(
            cfg, p, 2, 11, frame_embeds=f, device=dev), t[:, :5], 5)
        out[str(dev)] = (full, mtp, steps, greedy)
    (hf, hm, hs, hg), (cf, cm, cs, cg) = out["cpu"], out[str(card)]
    assert cf.is_cuda and cs.is_cuda and cg.is_cuda
    _lm_close(cs, cf)
    _lm_close(cf, hf)
    _lm_close(cs, hs)
    if hm is not None:
        _lm_close(cm, hm)
    assert torch.equal(cg.cpu(), hg)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name", [("mamba", "zamba2-7b"),
                                       ("mlstm", "xlstm-125m"),
                                       ("slstm", "xlstm-125m")])
def test_ssm_block_on_the_card_matches_the_host(card, kind, name):
    """A recurrent block's forward over two SSD chunks (the last padded)
    and its decode step by step, with the cache it carries, on the card
    equal the host's (float32)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import schema, ssm
    cfg = get_smoke_config(name)
    host = schema.init_params(getattr(ssm, f"{kind}_schema")(cfg),
                              torch.Generator().manual_seed(7),
                              torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 2 * cfg.ssm_chunk - 3, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in ("cpu", card):
        p = schema.tree_map(lambda a: a.to(dev), host)
        xd = x.to(dev)
        with torch.no_grad():
            full = getattr(ssm, f"{kind}_forward")(p, cfg, xd)
            cache = getattr(ssm, f"init_{kind}_cache")(cfg, 2, torch.float32,
                                                       dev)
            steps = []
            for i in range(x.shape[1]):
                y, cache = getattr(ssm, f"{kind}_decode")(
                    p, cfg, xd[:, i:i + 1], cache)
                steps.append(y)
        out[str(dev)] = (full, torch.cat(steps, 1), cache)
    (hf, hs, hc), (cf, cs, cc) = out["cpu"], out[str(card)]
    assert cf.is_cuda and cs.is_cuda
    _lm_close(cf, hf)
    _lm_close(cs, hs)
    _lm_close(cs, cf)
    for c, h in zip(cc, hc):
        _lm_close(c, h)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v3-671b", "xlstm-125m",
                                  "zamba2-7b"])
def test_train_step_on_the_card_matches_the_host(card, name):
    """One AdamW train step (remat as configured) on the card: loss,
    metrics and grad norm within LM_TOL of the host's, the new parameters
    too (float32)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import schema
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import make_train_step
    cfg = get_smoke_config(name)
    host = schema.init_params(T.build_schema(cfg),
                              torch.Generator().manual_seed(9),
                              torch.float32, "cpu")
    b = SyntheticLM(DataConfig(cfg.vocab_size, 24, 2, seed=1)).batch(0)
    # eps above the gradients' rounding noise (Adam's first step is their
    # sign)
    opt_cfg = opt_mod.AdamWConfig(warmup_steps=1, total_steps=2, eps=1e-3)
    step = make_train_step(cfg, opt_cfg)
    out = {}
    for dev in ("cpu", card):
        p = schema.tree_map(lambda a: a.to(dev), host)
        batch = {k: torch.from_numpy(b[k]).to(dev)
                 for k in ("tokens", "labels")}
        out[str(dev)] = step(p, opt_mod.init_state(opt_cfg, p), batch)
    (hp, _, hm), (cp, cs, cm) = out["cpu"], out[str(card)]
    assert int(cs.step) == 1 and sorted(cm) == sorted(hm)
    for k in hm:
        _lm_close(cm[k], hm[k])
    for c, h in zip(schema.tree_leaves(cp), schema.tree_leaves(hp)):
        assert c.is_cuda
        _lm_close(c, h)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [64, 4])
def test_moe_dispatch_on_the_card_matches_the_host(card, capacity):
    """apply_moe's output, aux losses and dropped fraction on the card
    equal the host's (float32), starved or not."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import schema
    cfg = get_smoke_config("deepseek-v3-671b")
    host = schema.init_params(moe_mod.moe_schema(cfg),
                              torch.Generator().manual_seed(5),
                              torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32))
    hy, haux = moe_mod.apply_moe(host, cfg, x, capacity=capacity)
    dev_p = schema.tree_map(lambda a: a.to(card), host)
    cy, caux = moe_mod.apply_moe(dev_p, cfg, x.to(card), capacity=capacity)
    assert cy.is_cuda
    _lm_close(cy, hy)
    for f in moe_mod.MoEAux._fields:
        _lm_close(getattr(caux, f), getattr(haux, f))
    assert (float(caux.dropped_fraction) > 1e-6) == (capacity == 4)


@pytest.mark.cuda
@pytest.mark.parametrize("group,frac", [(512, 0.003), (64, 0.05)])
def test_dispatch_capacity_twin_on_the_card(card, group, frac):
    """predict_dispatch_capacity_torch on CUDA tensors equals the host
    twin bit for bit, and the numpy plan's z*, f* and flopr_e exactly."""
    from repro_torch.core import moe_capacity as mc
    rng = np.random.default_rng(0)
    e, k, tokens = 64, 8, 200_000
    p = np.arange(1, e + 1) ** -0.8
    ids = rng.choice(e, size=(tokens, k), p=p / p.sum())
    plan_np = mc.predict_dispatch_capacity(ids, e, group, seed=1,
                                           sample_fraction=frac)
    gids = torch.from_numpy(mc.dispatch_sample_groups(tokens, group, 1, frac))
    tids = torch.from_numpy(ids.astype(np.int32))
    host = mc.predict_dispatch_capacity_torch(tids, e, group, gids)
    got = mc.predict_dispatch_capacity_torch(tids.to(card), e, group,
                                             gids.to(card))
    assert all(g.is_cuda for g in got)
    for g, h in zip(got, host):
        assert torch.equal(g.cpu(), h)
    z, f = mc.sampled_dispatch_counts_torch(tids.to(card), group,
                                            gids.to(card))
    assert (int(z), f) == (plan_np.exact_sample_blocks,
                           plan_np.sampled_assignments)
    np.testing.assert_array_equal(got[2].cpu().numpy(),
                                  np.bincount(ids.reshape(-1), minlength=e))
    assert float(got[0]) == pytest.approx(plan_np.predicted_blocks, rel=1e-6)


@pytest.fixture
def card_mesh(card):
    """A (1, 1) ("data", "model") mesh of the card over a one-rank NCCL
    group, destroyed after the test."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "deepseek-v3-671b"])
def test_sharded_train_step_on_the_card(card_mesh, name):
    """A train step sharded on the card's (1, 1) NCCL mesh against the
    unsharded step on the card (float32): loss, grad norm and the new
    parameters within LM_TOL."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import schema, sharding
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import make_train_step
    cfg = get_smoke_config(name)
    sch = T.build_schema(cfg)
    p = schema.init_params(sch, torch.Generator().manual_seed(9),
                           torch.float32, "cpu")
    p = schema.tree_map(lambda a: a.to("cuda"), p)
    b = SyntheticLM(DataConfig(cfg.vocab_size, 24, 2, seed=1)).batch(0)
    batch = {k: torch.from_numpy(b[k]).cuda() for k in ("tokens", "labels")}
    opt_cfg = opt_mod.AdamWConfig(warmup_steps=1, total_steps=2, eps=1e-3)
    step = make_train_step(cfg, opt_cfg)
    want_p, _, want_m = step(p, opt_mod.init_state(opt_cfg, p), batch)
    specs = sharding.specs_from_schema(sch, sharding.make_rules(
        cfg, mesh_model=1, multi_pod=False))
    dp = sharding.distribute_tree(p, specs, card_mesh)
    db = {k: sharding.distribute(v, sharding.P("data", None), card_mesh)
          for k, v in batch.items()}
    with sharding.use_mesh(card_mesh):
        got_p, _, got_m = step(dp, opt_mod.init_state(opt_cfg, dp), db)
    for k in ("loss", "grad_norm"):
        _lm_close(got_m[k].full_tensor(), want_m[k])
    for g, w in zip(schema.tree_leaves(got_p), schema.tree_leaves(want_p)):
        assert g.to_local().is_cuda
        _lm_close(g.full_tensor(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v3-671b", "qwen2.5-32b",
                                  "zamba2-7b"])
def test_sharded_decode_on_the_card(card_mesh, name):
    """Decode steps with parameters and caches laid out by the decode
    specs (the caches' sequence axis on `model`) on the card's (1, 1) mesh
    against unsharded decode on the card (float32): every step's logits and
    the caches within LM_TOL."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import schema, sharding
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_smoke_config(name), dtype="float32")
    sch = T.build_schema(cfg)
    p = schema.init_params(sch, torch.Generator().manual_seed(9),
                           torch.float32, "cpu")
    p = schema.tree_map(lambda a: a.to("cuda"), p)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)).cuda()
    cache = T.init_cache(cfg, 2, 8, device="cuda")
    dp = sharding.distribute_tree(p, sharding.specs_from_schema(
        sch, sharding.make_rules(cfg, mesh_model=1, multi_pod=False)),
        card_mesh)
    dcache = sharding.distribute_tree(
        T.init_cache(cfg, 2, 8, device="cuda"),
        sharding.cache_spec_tree(cfg, 1, False), card_mesh)
    with torch.no_grad():
        for t in range(toks.shape[1]):
            cur = torch.tensor(t, dtype=torch.int32, device="cuda")
            want, _ = T.decode_step(p, cfg, toks[:, t:t + 1], cache, cur)
            with sharding.use_mesh(card_mesh):
                got, _ = T.decode_step(
                    dp, cfg, sharding.distribute(toks[:, t:t + 1],
                                                 sharding.P("data", None),
                                                 card_mesh),
                    dcache, cur)
            _lm_close(got.full_tensor(), want)
    flat = lambda c: [x for v in (c.values() if isinstance(c, dict) else c)
                      for x in flat(v)] if isinstance(c, (dict, tuple)) \
        else [c]
    for g, w in zip(flat(dcache), flat(cache)):
        _lm_close(g.full_tensor(), w)
