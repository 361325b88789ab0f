"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode).  The module imports no JAX, so it also runs where
only the port is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import binning, csr, plan, predictor, spgemm
from repro_torch.core import flop as flop_mod
from repro_torch.kernels import accumulator as acc_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import flop_per_row as flop_k
from repro_torch.kernels import spgemm_numeric as num_k
from repro_torch.kernels import spgemm_symbolic as sym_k
from repro_torch.sparse import random as sprand

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
    kernel's on the same rows (f* too when B's rows are read whole)."""
    rnb = torch.diff(bd.rpt)
    kw = dict(a=ad, b=bd, rows=rows, max_deg_a=da, max_deg_b=db)
    want = sym_k.sampled_symbolic_plain(**kw)
    hint = flop_k.flop_rows(ad, rnb, rows, max_deg_a=da)
    for row_flop in (None, hint):
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


# (sq, sk, D, causal, Hq, Hkv): the CPU tests' cases
# (tests/test_torch_attention.py), a 1024-token case at qwen2.5-32b's
# attention width (40 heads, 8 kv heads, D 128), phi3-mini's (32 heads,
# D 96), and ragged tiles (Sq, Sk off the kernel's 64-row tiles, D 48)
ATTN_CASES = [(128, 128, 64, True, 4, 2), (128, 256, 64, False, 4, 2),
              (256, 256, 32, True, 4, 2),
              (64, 128, 32, True, 4, 2), (128, 64, 32, True, 4, 2),
              (128, 128, 96, True, 4, 4), (128, 128, 16, True, 4, 2),
              (128, 128, 64, False, 6, 2),
              (1024, 1024, 128, True, 40, 8), (1024, 1024, 96, True, 32, 32),
              (96, 160, 48, True, 4, 2)]
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
    before = fa_k.flash_attention.launches
    got = fa_k.flash_attention(q, k, v, causal=causal, block_q=32,
                               block_k=32)
    assert fa_k.flash_attention.launches == before + 1
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
    torch.testing.assert_close(fa_k.flash_attention(qs, k, v, block_q=64,
                                                    block_k=64),
                               fa_k.flash_attention(q, k, v, block_q=64,
                                                    block_k=64),
                               rtol=0, atol=0)
    wide = torch.zeros(1, 2, 64, 320, device=card)
    with pytest.raises(ValueError, match="head dim 320"):
        fa_k.flash_attention(wide, wide, wide, block_q=64, block_k=64)
