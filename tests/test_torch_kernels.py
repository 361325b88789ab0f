"""The port's nine kernels against the JAX package's Pallas kernels (run in
interpret mode, as tests/test_kernels.py runs them) and against its jnp
twins, on tiny inputs.  On the CPU each wrapper runs its plain version;
the CUDA kernels themselves are held against those plain versions on a card
by tests/test_torch_cuda.py and by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import flop as jflop
from repro.core import spgemm as jspgemm
from repro.kernels import accumulator as jacc_k
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import random as jrand
from repro_torch import convert
from repro_torch.core.csr import COL_SENTINEL
from repro_torch.core.errors import PlanMismatchError
from repro_torch.kernels import accumulator as tacc_k
from repro_torch.kernels import flop_per_row as tflop_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spgemm_numeric as tnum_k
from repro_torch.kernels import spgemm_symbolic as tsym_k

torch.set_num_threads(1)

VAL_RTOL = 1e-5      # run sums are taken in another order
VAL_ATOL_REL = 1e-6  # × the row's largest |value|


def _pair(a, b, extra=3):
    """The same operands on both sides: JAX device CSRs (capacity-padded)
    and the port's CSRDevice built from their numpy arrays."""
    ja = jcsr.to_device(a, capacity=a.nnz + extra)
    jb = jcsr.to_device(b, capacity=b.nnz + extra)
    conv = lambda d: convert.csr_device_from_numpy(
        np.asarray(d.rpt), np.asarray(d.col), np.asarray(d.val), d.shape,
        device="cpu")
    return ja, jb, conv(ja), conv(jb)


def _operands(seed):
    a = jrand.power_law(120, 100, 3, 1.6, seed=seed)
    b = jrand.erdos_renyi(100, 90, 3, seed=seed + 1)
    return a, b


def _assert_vals_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    vmax = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want)
            <= VAL_RTOL * np.abs(want) + VAL_ATOL_REL * vmax).all()


@pytest.mark.parametrize("seed,narrow", [(41, False), (43, True)])
def test_flop_rows_matches_pallas_and_jnp(seed, narrow):
    a, b = _operands(seed)
    ja, jb, ta, tb = _pair(a, b)
    deg = np.diff(a.rpt)
    rows = np.flatnonzero(deg <= 2) if narrow else np.arange(a.nrows)
    rows = rows.astype(np.int32)[:256]
    da = int(deg[rows].max())
    want_pallas = jops.flop_rows(ja, jb, jnp.asarray(rows), max_deg_a=da,
                                 block_rows=32)
    want_jnp = jref.flop_rows_ref(ja, jb, jnp.asarray(rows))
    got = tflop_k.flop_rows(ta, torch.diff(tb.rpt), torch.from_numpy(rows),
                            max_deg_a=da)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jnp))
    np.testing.assert_array_equal(
        tref.flop_rows_ref(ta, tb, torch.from_numpy(rows)).numpy(),
        got.numpy())


def test_fused_flop_symbolic_matches_pallas_and_jnp():
    samples = 37            # not a multiple of the Pallas block: padded rows
    a, b = _operands(51)
    ja, jb, ta, tb = _pair(a, b)
    rows = np.random.default_rng(samples).integers(
        0, a.nrows, samples).astype(np.int32)
    da = int(np.diff(a.rpt)[rows].max())
    db = int(b.row_nnz.max())
    zp, fp, flp = jops.fused_flop_symbolic(ja, jb, jnp.asarray(rows), da, db,
                                           block_samples=8)
    zr, fr, flr = jref.fused_flop_symbolic_ref(ja, jb, jnp.asarray(rows), da,
                                               db)
    z, f, fl = tsym_k.fused_flop_symbolic(ta, tb, torch.from_numpy(rows),
                                          max_deg_a=da, max_deg_b=db)
    assert (int(z), int(f)) == (int(zp), int(fp)) == (int(zr), int(fr))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(flp))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(flr))
    zt, ft, flt = tref.fused_flop_symbolic_ref(ta, tb, torch.from_numpy(rows),
                                               da, db)
    assert (int(zt), int(ft)) == (int(z), int(f))
    np.testing.assert_array_equal(flt.numpy(), fl.numpy())


@pytest.mark.parametrize("row_capacity", [4, 16])
def test_spgemm_numeric_matches_pallas_and_jnp(row_capacity):
    a = jrand.erdos_renyi(100, 100, 3, seed=61)
    b = jrand.erdos_renyi(100, 90, 3, seed=62)
    a.val[:] = np.random.default_rng(1).standard_normal(a.nnz)
    b.val[:] = np.random.default_rng(2).standard_normal(b.nnz)
    ja, jb, ta, tb = _pair(a, b)
    rows = np.arange(0, 64, dtype=np.int32)
    da = int(np.diff(a.rpt)[rows].max())
    db = int(b.row_nnz.max())
    want = jops.spgemm_numeric(ja, jb, jnp.asarray(rows), max_deg_a=da,
                               max_deg_b=db, row_capacity=row_capacity,
                               block_rows=8)
    twin = jspgemm.spgemm_rows(ja, jb, jnp.asarray(rows),
                               row_capacity=row_capacity, max_deg_a=da,
                               max_deg_b=db, block_rows=16)
    got = tnum_k.spgemm_numeric(ta, tb, torch.from_numpy(rows), max_deg_a=da,
                                max_deg_b=db, row_capacity=row_capacity)
    for ref in (want, twin):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        assert int(got[3]) == int(ref[3])
        _assert_vals_close(got[1].numpy(), ref[1])
    if row_capacity == 4:
        assert int(got[3]) > 0      # the small capacity truly truncates
    oracle = tref.spgemm_numeric_ref(ta, tb, torch.from_numpy(rows), da, db,
                                     row_capacity)
    np.testing.assert_array_equal(oracle[0].numpy(), got[0].numpy())


def _banded(m, n, deg, band, seed):
    """A banded operand with standard-normal values (narrow extents: the
    SPA route's regime)."""
    x = jrand.banded(m, n, deg, band, seed=seed)
    x.val[:] = np.random.default_rng(seed).standard_normal(x.nnz).astype(
        np.float32)
    return x


def test_extent_relative_and_bitmask_distinct_match_jax():
    rng = np.random.default_rng(7)
    cols = (rng.integers(0, 40, size=(6, 32)) + 100 * np.arange(6)[:, None]
            ).astype(np.int32)
    cols[rng.random(cols.shape) < 0.3] = COL_SENTINEL
    cols[2] = COL_SENTINEL                       # a row without products
    rel, lo = tacc_k.extent_relative(torch.from_numpy(cols))
    jrel, jlo = jacc_k.extent_relative(jnp.asarray(cols))
    np.testing.assert_array_equal(rel.numpy(), np.asarray(jrel))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    assert int(lo[2]) == 0 and bool((rel[2] == COL_SENTINEL).all())
    for n_words in (1, 2):          # one word drops columns past lane 31
        np.testing.assert_array_equal(
            tacc_k.bitmask_distinct(torch.from_numpy(cols), n_words).numpy(),
            np.asarray(jacc_k.bitmask_distinct(jnp.asarray(cols), n_words)))


@pytest.mark.parametrize("span", [0, 64])
def test_fused_flop_symbolic_bitmask_matches_pallas_and_esc(span):
    samples = 13            # not a multiple of the Pallas block: padded rows
    a = _banded(80, 80, 4, 6, seed=91)
    ja, jb, ta, tb = _pair(a, a)
    rows = np.random.default_rng(samples).integers(
        0, a.nrows, samples).astype(np.int32)
    da = db = int(a.row_nnz.max())
    zp, fp, flp = jops.fused_flop_symbolic_routed(
        ja, jb, jnp.asarray(rows), max_deg_a=da, max_deg_b=db, route="spa",
        span=span, block_samples=8)
    z, f, fl = tacc_k.fused_flop_symbolic_bitmask(
        ta, tb, torch.from_numpy(rows), max_deg_a=da, max_deg_b=db,
        span=span)
    assert (int(z), int(f)) == (int(zp), int(fp))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(flp))
    # bit for bit the ESC counts, and the unfused oracles'
    ze, fe, fle = tsym_k.fused_flop_symbolic(ta, tb, torch.from_numpy(rows),
                                             max_deg_a=da, max_deg_b=db)
    assert (int(z), int(f)) == (int(ze), int(fe))
    np.testing.assert_array_equal(fl.numpy(), fle.numpy())
    zr, fr = tref.bitmask_symbolic_ref(ta, tb, torch.from_numpy(rows), da,
                                       db)
    zj, fj = jref.bitmask_symbolic_ref(ja, jb, jnp.asarray(rows), da, db)
    assert (int(zr), int(fr)) == (int(zj), int(fj)) == (int(z), int(f))


@pytest.mark.parametrize("row_capacity", [4, 32])
@pytest.mark.parametrize("route", ["spa", "bin"])
def test_accumulator_numeric_matches_pallas_and_jnp(route, row_capacity):
    """SPA and BIN through the JAX package's Pallas kernels + compact_dense,
    against the port's wrappers (plain on the CPU), two tiles / bins wide;
    the small capacity truncates and must drop the same entries as ESC."""
    a = _banded(64, 300, 5, 150, seed=101)
    b = _banded(300, 300, 4, 40, seed=103)
    ja, jb, ta, tb = _pair(a, b)
    rows = np.arange(0, 24, dtype=np.int32)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    tile_n, n_tiles = 128, 4
    jfn = jops.spgemm_numeric_spa if route == "spa" else jops.spgemm_numeric_bin
    want = jfn(ja, jb, jnp.asarray(rows), max_deg_a=da, max_deg_b=db,
               row_capacity=row_capacity, tile_n=tile_n, n_tiles=n_tiles,
               block_rows=8)
    tfn = tacc_k.spa_numeric if route == "spa" else tacc_k.bin_numeric
    got = tfn(ta, tb, torch.from_numpy(rows), max_deg_a=da, max_deg_b=db,
              row_capacity=row_capacity, tile_n=tile_n, n_tiles=n_tiles)
    esc = tnum_k.spgemm_numeric(ta, tb, torch.from_numpy(rows), max_deg_a=da,
                                max_deg_b=db, row_capacity=row_capacity)
    for ref in (want, esc):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        assert int(got[3]) == int(ref[3])
        _assert_vals_close(got[1].numpy(), ref[1])
    if row_capacity == 4:
        assert int(got[3]) > 0      # the small capacity truly truncates
    oracle = (tref.spa_numeric_ref(ta, tb, torch.from_numpy(rows), da, db,
                                   row_capacity) if route == "spa" else
              tref.bin_numeric_ref(ta, tb, torch.from_numpy(rows), da, db,
                                   row_capacity, tile_n, n_tiles))
    np.testing.assert_array_equal(oracle[0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(oracle[2].numpy(), got[2].numpy())


@pytest.mark.parametrize("route", ["spa", "bin", "nope"])
def test_ops_run_every_route_and_refuse_unknown_ones(route):
    """Every planned route now runs through ``ops`` and gives what the JAX
    package's routed ops give (their tiling derived from the span when the
    caller passes none); only an unknown route is refused."""
    a = _banded(60, 60, 4, 8, seed=71)
    ja, jb, ta, tb = _pair(a, a)
    rows = np.arange(16, dtype=np.int32)
    kw = dict(max_deg_a=4, max_deg_b=4, route=route)
    if route == "nope":
        with pytest.raises(PlanMismatchError):
            tops.fused_flop_symbolic_routed(ta, tb, torch.from_numpy(rows),
                                            **kw)
        with pytest.raises(PlanMismatchError):
            tops.spgemm_numeric_routed(ta, tb, torch.from_numpy(rows),
                                       row_capacity=8, **kw)
        return
    span = 32
    got = tops.fused_flop_symbolic_routed(ta, tb, torch.from_numpy(rows),
                                          span=span, **kw)
    want = jops.fused_flop_symbolic_routed(ja, jb, jnp.asarray(rows),
                                           span=span, **kw)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    got = tops.spgemm_numeric_routed(ta, tb, torch.from_numpy(rows),
                                     row_capacity=8, span=span, **kw)
    want = jops.spgemm_numeric_routed(ja, jb, jnp.asarray(rows),
                                      row_capacity=8, span=span, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])
    _assert_vals_close(got[1].numpy(), want[1])


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor that lies neither on the CPU nor on a CUDA card gets no
    plain fallback: the wrappers raise."""
    a, b = _operands(81)
    _, _, ta, tb = _pair(a, b)
    meta = lambda d: type(d)(rpt=d.rpt.to("meta"), col=d.col.to("meta"),
                             val=d.val.to("meta"), shape=d.shape)
    ma, mb = meta(ta), meta(tb)
    rows = torch.arange(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        tflop_k.flop_rows(ma, torch.diff(mb.rpt), rows, max_deg_a=4)
    with pytest.raises(RuntimeError):
        tsym_k.fused_flop_symbolic(ma, mb, rows, max_deg_a=4, max_deg_b=4)
    with pytest.raises(RuntimeError):
        tnum_k.spgemm_numeric(ma, mb, rows, max_deg_a=4, max_deg_b=4,
                              row_capacity=8)
    with pytest.raises(RuntimeError):
        tacc_k.fused_flop_symbolic_bitmask(ma, mb, rows, max_deg_a=4,
                                           max_deg_b=4)
    for numeric in (tacc_k.spa_numeric, tacc_k.bin_numeric):
        with pytest.raises(RuntimeError):
            numeric(ma, mb, rows, max_deg_a=4, max_deg_b=4, row_capacity=8,
                    tile_n=128, n_tiles=1)


# --------------------------------------------------------------------------- #
# Kernels 7-9: the global-pad symbolic pair and Algorithm 1 over all rows
# --------------------------------------------------------------------------- #
def _symbolic_operands():
    """The shapes of tests/test_kernels.py's and tests/test_accumulator.py's
    symbolic sweeps: a banded A, an Erdős–Rényi B."""
    a = jrand.banded(200, 200, 8, 12, seed=3)
    b = jrand.erdos_renyi(200, 160, 5, seed=4)
    return _pair(a, b)


# (samples, Pallas block) as in those sweeps; "trunc" reads B's rows to
# fewer entries than its widest has, so the two f* conventions part
_SYMBOLIC_CASES = [(8, 8, False), (37, 8, False), (5, 16, False),
                   (37, 8, True)]


@pytest.mark.parametrize("samples,block,trunc", _SYMBOLIC_CASES)
def test_sampled_symbolic_matches_pallas_and_jnp(samples, block, trunc):
    ja, jb, ta, tb = _symbolic_operands()
    rows = np.random.default_rng(samples).integers(
        0, ja.nrows, samples).astype(np.int32)
    da = int(np.diff(np.asarray(ja.rpt)).max())
    db = int(np.diff(np.asarray(jb.rpt)).max()) - (3 if trunc else 0)
    zp, fp = jops.sampled_symbolic(ja, jb, jnp.asarray(rows), da, db,
                                   block_samples=block)
    zr, fr = jref.sampled_symbolic_ref(ja, jb, jnp.asarray(rows), da, db)
    trows = torch.from_numpy(rows)
    z, f = tops.sampled_symbolic(ta, tb, trows, da, db)
    assert z.dtype == torch.int32 and f.dtype == torch.int32
    assert (int(z), int(f)) == (int(zp), int(fp)) == (int(zr), int(fr))
    zt, ft = tref.sampled_symbolic_ref(ta, tb, trows, da, db)
    assert (int(zt), int(ft)) == (int(z), int(f))
    # the workspace hint changes nothing on the plain path
    flop = tflop_k.flop_rows(ta, torch.diff(tb.rpt), trows, max_deg_a=da)
    zh, fh = tops.sampled_symbolic(ta, tb, trows, da, db, row_flop=flop)
    assert (int(zh), int(fh)) == (int(z), int(f))
    if trunc:       # f* counts the gathered products, below the FLOP
        assert int(f) < int(flop.sum())


@pytest.mark.parametrize("span", [0, 64])
@pytest.mark.parametrize("samples,block,trunc", _SYMBOLIC_CASES)
def test_bitmask_symbolic_matches_pallas(samples, block, trunc, span):
    ja, jb, ta, tb = _symbolic_operands()
    rows = np.random.default_rng(samples).integers(
        0, ja.nrows, samples).astype(np.int32)
    da = int(np.diff(np.asarray(ja.rpt)).max())
    db = int(np.diff(np.asarray(jb.rpt)).max()) - (3 if trunc else 0)
    zp, fp = jops.bitmask_symbolic(ja, jb, jnp.asarray(rows), da, db,
                                   block_samples=block, span=span)
    trows = torch.from_numpy(rows)
    z, f = tops.bitmask_symbolic(ta, tb, trows, da, db, span=span)
    assert z.dtype == torch.int32 and f.dtype == torch.int32
    assert (int(z), int(f)) == (int(zp), int(fp))
    # f* is Algorithm 1 over the rows; z* is the ESC count while the span
    # covers the rows' extent
    flop = tflop_k.flop_rows(ta, torch.diff(tb.rpt), trows, max_deg_a=da)
    assert int(f) == int(flop.sum())
    if span == 0:
        ze, _ = tops.sampled_symbolic(ta, tb, trows, da, db)
        assert int(z) == int(ze)


def test_sampled_and_bitmask_f_star_conventions_differ():
    """Below B's widest row the unfused ESC kernel's f* counts gathered
    products and the bitmask kernel's sums untruncated B-row lengths —
    each as its own Pallas kernel does."""
    ja, jb, ta, tb = _symbolic_operands()
    rows = np.arange(0, 200, 5, dtype=np.int32)
    da = int(np.diff(np.asarray(ja.rpt)).max())
    db = int(np.diff(np.asarray(jb.rpt)).max()) - 3
    j7 = jops.sampled_symbolic(ja, jb, jnp.asarray(rows), da, db)
    j8 = jops.bitmask_symbolic(ja, jb, jnp.asarray(rows), da, db)
    t7 = tops.sampled_symbolic(ta, tb, torch.from_numpy(rows), da, db)
    t8 = tops.bitmask_symbolic(ta, tb, torch.from_numpy(rows), da, db)
    assert int(t7[0]) == int(t8[0]) == int(j7[0]) == int(j8[0])
    assert int(t7[1]) == int(j7[1]) < int(t8[1]) == int(j8[1])
    p7 = tsym_k.sampled_symbolic_plain(ta, tb, torch.from_numpy(rows),
                                       max_deg_a=da, max_deg_b=db)
    p8 = tacc_k.bitmask_symbolic_plain(ta, tb, torch.from_numpy(rows),
                                       max_deg_a=da, max_deg_b=db)
    assert [int(x) for x in p7] == [int(x) for x in t7]
    assert [int(x) for x in p8] == [int(x) for x in t8]


@pytest.mark.parametrize("m,n,da,db", [
    (100, 100, 4, 4), (257, 180, 7, 3), (64, 512, 12, 9)])
def test_flop_per_row_matches_ref_and_jnp(m, n, da, db):
    """The shapes of tests/test_kernels.py::test_flop_kernel_sweep.  The
    Pallas kernel itself fails on the installed JAX (pl.load is gone), so
    the port is held to its oracles: kernels/ref.py and core/flop.py."""
    a = jrand.erdos_renyi(m, n, da, seed=m)
    b = jrand.erdos_renyi(n, m, db, seed=n)
    ja, jb, ta, tb = _pair(a, b)
    mda = int(a.row_nnz.max())
    got = tops.flop_per_row(ta, tb, max_deg_a=mda)
    assert got.dtype == torch.int32 and got.shape == (m,)
    want = jref.flop_per_row_ref(ja.rpt, ja.col, jnp.diff(jb.rpt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jflop.flop_per_row(ja, jb)[0]))
    np.testing.assert_array_equal(
        tref.flop_per_row_ref(ta.rpt, ta.col, torch.diff(tb.rpt)).numpy(),
        got.numpy())


@pytest.mark.parametrize("max_deg_a", [2, 128])
def test_flop_per_row_truncates_as_jax_does(max_deg_a):
    """Rows wider than ``max_deg_a`` are read to ``max_deg_a`` entries (the
    JAX entry point's default of 128 included): an undercount, equal to a
    numpy sum over each row's first entries."""
    a = jrand.power_law(150, 120, 6, 1.4, seed=111)
    b = jrand.erdos_renyi(120, 90, 4, seed=112)
    _, _, ta, tb = _pair(a, b)
    deg = np.diff(a.rpt)
    assert deg.max() > 2
    got = (tops.flop_per_row(ta, tb) if max_deg_a == 128 else
           tops.flop_per_row(ta, tb, max_deg_a=max_deg_a))
    want = np.array([b.row_nnz[a.col[a.rpt[i]:a.rpt[i] + min(d, max_deg_a)]]
                     .sum() for i, d in enumerate(deg)])
    np.testing.assert_array_equal(got.numpy(), want)
    if deg.max() > max_deg_a:
        full = tops.flop_per_row(ta, tb, max_deg_a=int(deg.max()))
        assert int(got.sum()) < int(full.sum())


@pytest.mark.parametrize("route", ["esc", "spa", "bin"])
def test_unrouted_numeric_ops_match_jax(route):
    """``ops.spgemm_numeric``, ``spgemm_numeric_spa`` and
    ``spgemm_numeric_bin`` (the tiling derived from the span, as JAX
    derives it) against the JAX package's entry points."""
    a = _banded(60, 60, 4, 8, seed=121)
    ja, jb, ta, tb = _pair(a, a)
    rows = np.arange(20, dtype=np.int32)
    kw = dict(max_deg_a=4, max_deg_b=4, row_capacity=8)
    if route == "esc":
        got = tops.spgemm_numeric(ta, tb, torch.from_numpy(rows), **kw)
        want = jops.spgemm_numeric(ja, jb, jnp.asarray(rows), **kw)
    else:
        tfn, jfn = ((tops.spgemm_numeric_spa, jops.spgemm_numeric_spa)
                    if route == "spa" else
                    (tops.spgemm_numeric_bin, jops.spgemm_numeric_bin))
        got = tfn(ta, tb, torch.from_numpy(rows), tile_n=0, span=32, **kw)
        want = jfn(ja, jb, jnp.asarray(rows), tile_n=0, span=32, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])
    _assert_vals_close(got[1].numpy(), want[1])


def test_unrouted_fused_symbolic_op_matches_jax():
    a, b = _operands(131)
    ja, jb, ta, tb = _pair(a, b)
    rows = np.random.default_rng(5).integers(0, a.nrows, 21).astype(np.int32)
    da, db = int(a.row_nnz.max()), int(b.row_nnz.max())
    z, f, fl = tops.fused_flop_symbolic(ta, tb, torch.from_numpy(rows), da,
                                        db)
    zj, fj, flj = jops.fused_flop_symbolic(ja, jb, jnp.asarray(rows), da, db)
    assert (int(z), int(f)) == (int(zj), int(fj))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(flj))


def test_global_pad_wrappers_raise_off_the_cpu_without_a_kernel():
    """Kernels 7-9 get no plain fallback either: a tensor neither on the
    CPU nor on a CUDA card makes them raise."""
    a, b = _operands(141)
    _, _, ta, tb = _pair(a, b)
    meta = lambda d: type(d)(rpt=d.rpt.to("meta"), col=d.col.to("meta"),
                             val=d.val.to("meta"), shape=d.shape)
    ma, mb = meta(ta), meta(tb)
    rows = torch.arange(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        tflop_k.flop_per_row(ma, torch.diff(mb.rpt), max_deg_a=4)
    with pytest.raises(RuntimeError):
        tsym_k.sampled_symbolic(ma, mb, rows, max_deg_a=4, max_deg_b=4)
    with pytest.raises(RuntimeError):
        tacc_k.bitmask_symbolic(ma, mb, rows, max_deg_a=4, max_deg_b=4)
