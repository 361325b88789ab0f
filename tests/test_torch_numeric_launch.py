"""The host side of the numeric kernels' launches, on the CPU: how a launch
is sized from the card's shared-memory limit and a bound on the rows'
products, that the bound travels with each call rather than with the cached
executor, that CPU tensors still take the plain versions (equal to the JAX
package on the five mini families), and that ``reassemble`` builds the same
CSR without sorting.  The kernels themselves run only on a card
(tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import plan as jplan_mod
from repro.sparse import suite as jsuite
from repro_torch.core import plan as tplan_mod
from repro_torch.core.csr import COL_SENTINEL
from repro_torch.kernels import _build
from repro_torch.kernels import accumulator as tacc_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spgemm_numeric as tnum_k
from repro_torch.sparse.formats import CSR

torch.set_num_threads(1)

FAMILIES = ("mini_er", "mini_pl", "mini_rmat", "mini_band", "mini_fem")
# opt-in shared memory a block: H100 (227 KB), A100 (163 KB), and the 48 KB
# every card gives without opting in
SMEM_LIMITS = (232_448, 166_912, 49_152)
VAL_RTOL = 1e-5
VAL_ATOL_REL = 1e-6


def _valued(jm, seed):
    jm.val[:] = np.random.default_rng(seed).standard_normal(jm.nnz).astype(
        np.float32)
    return jm


_MINI = {n: _valued(m, 30 + i) for i, (n, m) in
         enumerate(jsuite.mini_suite(scale=200))}


def _host(jm):
    return CSR(rpt=jm.rpt, col=jm.col, val=jm.val, shape=jm.shape)


def _rows(jm, n=40):
    return np.random.default_rng(5).integers(0, jm.nrows, n)


def _fits(limit, fixed, pairs):
    """A row's workspace fits a block's shared memory beside the kernels'
    own static shared memory."""
    return fixed + 8 * pairs + _build.STATIC_SMEM_RESERVE <= limit


# --------------------------------------------------------------------------- #
# Sizing: a row goes to scratch only when its own products do not fit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("limit", SMEM_LIMITS)
@pytest.mark.parametrize("max_deg_a", [4, 916, 30_000])
def test_esc_row_goes_to_scratch_only_past_the_shared_memory_limit(
        limit, max_deg_a):
    for bound in (0, 1, 32, 33, 256, 257, 8192, 8193, 20_000, 28_000,
                  28_500, 39_194, 1 << 20):
        shape = _build.esc_numeric_shape(limit, max_deg_a, bound)
        assert shape.warp_pairs == max(1, min(_build.ESC_WARP_MAX, bound))
        # two products a lane, four lanes at least, a warp at most
        assert shape.group in (4, 8, 16, 32)
        assert 2 * shape.group >= min(shape.warp_pairs, 64)
        assert shape.group == 4 or shape.group < shape.warp_pairs
        assert [lc[:3] for lc in shape.launches] == list(
            _build.ESC_LAUNCHES[:1 + (bound > _build.MID_PAIRS)])
        fixed = []
        for launch, rows_up_to in zip(
                shape.launches, (min(bound, _build.MID_PAIRS), bound)):
            warps = launch.threads // 32
            # the warps' dense tiles stay in shared memory; the tables: the
            # prefix, the entries' B-row starts and values, the column
            # ranges' starts and each warp's counts
            tiles = 4 * warps * (launch.tile_n + launch.tile_n // 32)
            f = (3 * _build.align16(4 * (max_deg_a + 1))
                 + _build.align16(4 * (launch.bins + 1))
                 + _build.align16(4 * warps * launch.bins))
            fixed.append(f)
            assert launch.smem_bytes + _build.STATIC_SMEM_RESERVE <= limit
            if launch.smem_pairs < 0:
                # not even the tables and 32 pairs fit: all in scratch
                assert not _fits(limit - tiles, f, 32)
                assert launch.smem_bytes == tiles
                continue
            # every row whose own pairs fit stays in shared memory ...
            fit = min(rows_up_to, (limit - _build.STATIC_SMEM_RESERVE
                                   - tiles - f) // 8)
            assert launch.smem_pairs == fit
            # ... and one more product would not have fit
            if fit < rows_up_to:
                assert not _fits(limit - tiles, f, fit + 1)
        needs_slice = any(lc.smem_pairs < min(bound, up_to) for lc, up_to in
                          zip(shape.launches, (_build.MID_PAIRS, bound)))
        assert bool(shape.slice_bytes) == needs_slice
        if needs_slice:
            assert shape.slice_pairs == bound
            assert shape.slice_bytes >= max(fixed) + 8 * bound


@pytest.mark.parametrize("limit", SMEM_LIMITS)
@pytest.mark.parametrize("tile_n,n_bins", [(128, 1), (256, 512),
                                           (256, 8192)])
def test_bin_row_goes_to_scratch_only_past_the_shared_memory_limit(
        limit, tile_n, n_bins):
    max_deg_a = 916
    for bound in (0, 1, 1022, 8192, 8193, 20_000, 39_194):
        shape = _build.bin_numeric_shape(limit, max_deg_a, bound, tile_n,
                                         n_bins)
        (launch,) = shape.launches
        warps = launch.threads // 32
        assert launch.threads == (256 if bound <= _build.MID_PAIRS else 1024)
        tiles = 4 * warps * (tile_n + tile_n // 32)
        tables = (3 * _build.align16(4 * (max_deg_a + 1))
                  + _build.align16(4 * (n_bins + 1))
                  + _build.align16(4 * warps * n_bins))
        assert launch.smem_bytes + _build.STATIC_SMEM_RESERVE <= limit
        if launch.smem_pairs < 0:
            # the tables go to the slice, with every row's pairs
            assert not _fits(limit - tiles, tables, 32)
            assert launch.smem_bytes == tiles
            assert shape.slice_bytes >= tables + 8 * bound
            continue
        fit = (limit - _build.STATIC_SMEM_RESERVE - tiles - tables) // 8
        assert launch.smem_pairs == min(bound, fit)
        assert bool(shape.slice_bytes) == (bound > fit)
        if bound > fit:
            assert shape.slice_pairs == bound


@pytest.mark.parametrize("limit", SMEM_LIMITS)
def test_sort_workspace_keeps_its_sizing_on_split_workspace(limit):
    """split_workspace over a grid of product prefixes (the fixed part of
    a row's workspace) and keys of 4 bytes, each result one of its three
    cases: every key fits beside the prefix in shared memory; the most
    keys that fit there (at least 32), with a slice holding all of them;
    or not even the prefix and 32 keys, which then share the slice."""
    seen = set()
    for max_deg_a in (1, 200, 916, 60_000):
        pre = _build.align16(4 * (max_deg_a + 1))
        for lanes in (1, 32, 1000, 1 << 10, 1 << 15, 1 << 16, 1 << 20):
            items, smem, slice_bytes = _build.split_workspace(limit, pre, 4,
                                                              lanes)
            if not slice_bytes:
                seen.add("fit")
                assert (items, smem) == (lanes, pre + 4 * lanes)
                assert smem + _build.STATIC_SMEM_RESERVE <= limit
            elif items >= 0:
                seen.add("part")
                assert 32 <= items < lanes and smem == pre + 4 * items
                assert smem + _build.STATIC_SMEM_RESERVE <= limit
                # one key more would not fit
                assert smem + 4 + _build.STATIC_SMEM_RESERVE > limit
                assert slice_bytes == 4 * lanes
            else:
                seen.add("none")
                assert (items, smem) == (-1, 0)
                assert pre + 4 * 32 + _build.STATIC_SMEM_RESERVE > limit
                assert slice_bytes == pre + 4 * lanes
    assert seen == {"fit", "part", "none"}


# --------------------------------------------------------------------------- #
# The bound comes from the call
# --------------------------------------------------------------------------- #
def test_flop_bound_comes_from_each_call_not_from_the_cached_executor(
        monkeypatch):
    """Two plans with one key but rows of different FLOP run through one
    cached executor, and each call's kernels see that plan's bounds."""
    tm = _host(_MINI["mini_rmat"])
    p1 = tplan_mod.plan_spgemm(tm, tm, route="auto", use_kernel=True,
                               sample_rows=_rows(tm), device="cpu")
    p2 = dataclasses.replace(p1, flopr=p1.flopr * 3 + 1, _device_args=None,
                             _flop_bounds=None, _planned_pair=None)
    assert p2.key == p1.key
    seen = []
    routed = tops.spgemm_numeric_routed

    def recording(*args, max_row_flop=None, **kw):
        seen.append(max_row_flop)
        return routed(*args, max_row_flop=max_row_flop, **kw)

    monkeypatch.setattr(tops, "spgemm_numeric_routed", recording)
    cache = tplan_mod.PlanCache()
    outs = []
    for p in (p1, p2):
        seen.clear()
        outs.append(tplan_mod.execute(p, tm, tm, cache=cache))
        want = [int(p.flopr[bk.rows].max()) for bk in p.binning.buckets]
        assert seen == want == list(p.flop_bounds())
    assert cache.stats()["traces"] == 1 and cache.stats()["hits"] == 1
    assert p1.flop_bounds() != p2.flop_bounds()
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)


def test_plan_flop_bounds_are_each_buckets_largest_row_flop():
    for family in FAMILIES:
        tm = _host(_MINI[family])
        p = tplan_mod.plan_spgemm(tm, tm, sample_rows=_rows(tm),
                                  device="cpu")
        for bk, bound in zip(p.binning.buckets, p.flop_bounds()):
            assert bound == int(p.flopr[bk.rows].max())
            assert bound <= bk.deg_a * bk.deg_b


# --------------------------------------------------------------------------- #
# CPU tensors run the plain versions, whatever the bound
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", FAMILIES)
def test_cpu_wrappers_run_the_plain_versions_and_match_jax(family):
    """Per bucket, the ESC and BIN wrappers on CPU tensors give their plain
    versions' result with any bound — the plan's, a wrong one, none — and
    launch nothing; the slice through them equals the JAX package's."""
    jm = _MINI[family]
    tm = _host(jm)
    rows = _rows(jm)
    jp = jplan_mod.plan_spgemm(jm, jm, route="auto", sample_rows=rows,
                               safety=4.0)
    tp = tplan_mod.plan_spgemm(tm, tm, route="auto", use_kernel=True,
                               sample_rows=rows, safety=4.0, device="cpu")
    ad = tp.to_device(tm, "a")
    before = (tnum_k.spgemm_numeric.launches, tacc_k.bin_numeric.launches)
    for bk, cap, bound in zip(tp.binning.buckets,
                              tp.alloc.bucket_capacities, tp.flop_bounds()):
        kw = dict(a=ad, b=ad, rows=torch.from_numpy(bk.rows),
                  max_deg_a=bk.deg_a, max_deg_b=bk.deg_b, row_capacity=cap)
        want = tnum_k.spgemm_numeric_plain(**kw)
        kernels = [(tnum_k.spgemm_numeric, {})]
        if bk.tile_n:
            kernels.append((tacc_k.bin_numeric,
                            dict(tile_n=bk.tile_n, n_tiles=bk.n_tiles)))
        for kernel, extra in kernels:
            for flop in (bound, 1, None):
                got = kernel(**kw, **extra, max_row_flop=flop)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[2], want[2])
                assert int(got[3]) == int(want[3])
    assert (tnum_k.spgemm_numeric.launches,
            tacc_k.bin_numeric.launches) == before
    tout = tplan_mod.execute(tp, tm, tm)
    jout = jplan_mod.execute(jp, jm, jm)
    np.testing.assert_array_equal(tout.col.numpy(), np.asarray(jout.col))
    np.testing.assert_array_equal(tout.row_nnz.numpy(),
                                  np.asarray(jout.row_nnz))
    w = np.asarray(jout.val)
    vmax = np.abs(w).max(axis=1, keepdims=True)
    assert (np.abs(tout.val.numpy() - w)
            <= VAL_RTOL * np.abs(w) + VAL_ATOL_REL * vmax).all()


# --------------------------------------------------------------------------- #
# reassemble: the CSR without a sort
# --------------------------------------------------------------------------- #
def _reassemble_by_sort(plan, out, ncols):
    """What reassemble built before: the kept entries as COO triplets
    through CSR.from_coo, which sorts them."""
    nrows = plan.shape_a[0]
    keep = out.col != COL_SENTINEL
    counts = keep.sum(dim=1).cpu().numpy()
    return CSR.from_coo(np.repeat(np.arange(nrows, dtype=np.int64), counts),
                        out.col[keep].cpu().numpy().astype(np.int64),
                        out.val[keep].cpu().numpy().astype(np.float32),
                        (nrows, ncols), dedup=False, validate=False)


@pytest.mark.parametrize("route", ["esc", "spa", "bin", "auto"])
def test_reassemble_equals_the_sorted_coo_path_bit_for_bit(route):
    """On every route and family, with room for every row and with too
    little (``on_overflow="ignore"``), the CSR equals the one the sorting
    path builds: the same arrays, dtypes and values, bit for bit."""
    overflowed = 0
    for family in FAMILIES:
        tm = _host(_MINI[family])
        for safety in (4.0, 0.3):
            p = tplan_mod.plan_spgemm(tm, tm, route=route,
                                      sample_rows=_rows(tm), safety=safety,
                                      device="cpu")
            out = tplan_mod.execute(p, tm, tm)
            got = tplan_mod.reassemble(p, out, on_overflow="ignore")
            want = _reassemble_by_sort(p, out, tm.ncols)
            assert got.shape == want.shape
            for name in ("rpt", "col", "val"):
                g, w = getattr(got, name), getattr(want, name)
                assert g.dtype == w.dtype, (family, name)
                assert g.tobytes() == w.tobytes(), (family, safety, name)
            overflowed += int(out.overflow)
    assert overflowed > 0
